"""Optimizers and learning-rate schedules of the port (the counterpart of
``src/repro/optim``).  ``grad_compress`` waits with the mesh (ROADMAP.md,
queue 1)."""

from .optimizers import OPTIMIZERS, adafactor, adamw, sgd_momentum  # noqa: F401
from .schedules import cosine_schedule, wsd_schedule  # noqa: F401
