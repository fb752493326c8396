"""Weights carried over from the reference package.

The reference's ``pretrain`` functions return numpy parameter dicts (flat
for 2fcNet, nested for MobileNet's batch-norm entries, with the int
``heads`` for tinyformer); the port's builders (``init_*``, ``*_to_ir``,
``build_twofc_step``'s inputs) take the same layout.  ``from_reference``
checks and copies one, so both packages build one program from one set of
JAX-pretrained weights and only the executor differs.
"""

from __future__ import annotations

import numpy as np


def from_reference(params: dict) -> dict:
    """The port's parameter dict from the reference's: every array (numpy,
    or any array ``np.asarray`` takes) becomes a contiguous float32 numpy
    copy, nested dicts recurse, ints stay."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = from_reference(v)
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            out[k] = int(v)
        else:
            arr = np.asarray(v)
            if arr.dtype != np.float32:
                raise TypeError(f"parameter {k!r}: float32 weights expected, "
                                f"got {arr.dtype}")
            out[k] = np.array(arr, order="C", copy=True)
    return out
