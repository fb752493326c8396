"""Optimizers, learning-rate schedules and int8-compressed gradient
reduction of the port (the counterpart of ``src/repro/optim``)."""

from .grad_compress import (compress_tree_psum, compressed_psum,  # noqa: F401
                            dequantize_int8, quantize_int8)
from .optimizers import OPTIMIZERS, adafactor, adamw, sgd_momentum  # noqa: F401
from .schedules import cosine_schedule, wsd_schedule  # noqa: F401
