"""A thin torch namespace with numpy's semantics, for the array code that
the tensorized engine shares with its numpy twin path.

The cost model (``kernels/costs.py``) and the NSGA-II kernel (:mod:`.nsga2`)
are written once against an ``xp`` module.  With ``xp=numpy`` they are the
bit-exact parity path; with ``xp=TorchXP(device)`` the same source runs on
torch tensors on the device.  Torch differs from numpy where that source
relies on numpy, and this namespace closes each gap:

* **Promotion.**  Torch divides an integer tensor by a Python float in
  float32; numpy in float64.  Every array this namespace makes from Python
  or numpy values is float64 (booleans stay boolean; ``arange`` makes int64
  indices), and ``where``/``maximum``/``minimum`` promote their operands as
  numpy does, a Python float turning an integer operand into float64.  The
  cost model's integer-valued tables and terms therefore stay exact in
  float64, and each term is the same IEEE operation numpy does.
* ``maximum``/``minimum`` take Python scalars; ``flip`` needs no axes;
  ``cummax`` returns the values alone.
* ``lexsort`` — torch has none: chained stable ``argsort``s from the least
  significant key to the most.  A float key sorts in two passes, its value
  (NaN as 0, -0.0 as +0.0) then its NaN flag, so NaN sorts last and the
  two zeros tie, as in numpy, whichever sort the device runs.
* ``while_loop`` — a host loop whose condition is read back each pass.
* **Division.**  Torch divides a tensor by a host scalar on the GPU, and a
  host scalar by a tensor everywhere, as a multiplication by a rounded
  reciprocal, one rounding away from the IEEE division numpy does.  The
  cost model divides by its device record's rates, so on this path each
  rate is a :class:`DeviceRate`: a tensor divided by it is divided by a
  float64 tensor on the device, and a Python number by its float value.
"""

from __future__ import annotations

import numpy as np
import torch



class DeviceRate:
    """A constant the shared array code divides or multiplies by: to a
    Python number it is its float ``value`` (Python's own arithmetic, as in
    numpy's scalar path); to a tensor it is a float64 0-d tensor on the
    device (``__torch_function__`` swaps it in), so ``tensor / rate`` is a
    true division there."""

    def __init__(self, value, device):
        self.value = float(value)
        self.tensor = torch.tensor(self.value, dtype=torch.float64,
                                   device=device)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        def swap(a):
            return a.tensor if isinstance(a, DeviceRate) else a
        return func(*map(swap, args),
                    **{k: swap(v) for k, v in (kwargs or {}).items()})

    def __rtruediv__(self, other):
        return other / self.value

    def __rmul__(self, other):
        return other * self.value


class TorchXP:
    """The subset of the numpy namespace the shared array code calls, on
    torch tensors on one device."""

    float64 = torch.float64
    inf = float("inf")

    def __init__(self, device):
        self.device = torch.device(device)

    # -- making arrays --------------------------------------------------------
    @staticmethod
    def _dtype(dtype):
        """A torch dtype, or numpy's spelling of the boolean one."""
        return torch.bool if dtype is bool else dtype

    def asarray(self, x, dtype=None):
        dtype = self._dtype(dtype)
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype or x.dtype)
        arr = np.asarray(x)
        if dtype is None:
            dtype = torch.bool if arr.dtype == np.bool_ else torch.float64
        if arr.ndim == 0:
            return torch.full((), arr.item(), dtype=dtype,
                              device=self.device)
        return torch.as_tensor(arr, device=self.device).to(dtype)

    def full(self, shape, value, dtype=None):
        return torch.full(shape, value, device=self.device,
                          dtype=self._dtype(dtype) or torch.float64)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, device=self.device,
                          dtype=self._dtype(dtype) or torch.float64)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, device=self.device,
                           dtype=self._dtype(dtype) or torch.float64)

    def arange(self, n):
        return torch.arange(n, device=self.device)

    # -- elementwise with numpy's promotion ----------------------------------
    def _promote(self, *args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors:
            dtype = (torch.bool
                     if all(isinstance(a, (bool, np.bool_)) for a in args)
                     else torch.float64)
        else:
            dtype = tensors[0].dtype
            for t in tensors[1:]:
                dtype = torch.promote_types(dtype, t.dtype)
            if not dtype.is_floating_point and any(
                    isinstance(a, (float, np.floating)) for a in args):
                dtype = torch.float64
        return [a.to(dtype) if isinstance(a, torch.Tensor)
                else torch.full((), a, dtype=dtype, device=self.device)
                for a in args]

    def where(self, cond, a, b):
        a, b = self._promote(a, b)
        return torch.where(self.asarray(cond, dtype=bool), a, b)

    def maximum(self, a, b):
        return torch.maximum(*self._promote(a, b))

    def minimum(self, a, b):
        return torch.minimum(*self._promote(a, b))

    # -- reductions and reshaping ---------------------------------------------
    def all(self, x, axis=None):
        return torch.all(x) if axis is None else torch.all(x, dim=axis)

    def any(self, x, axis=None):
        return torch.any(x) if axis is None else torch.any(x, dim=axis)

    def concatenate(self, parts, axis=0):
        return torch.cat(list(parts), dim=axis)

    def flip(self, x, axis=0):
        return torch.flip(x, dims=(axis,))

    def cummax(self, x):
        return torch.cummax(x, dim=0).values

    def put(self, arr, idx, vals):
        out = arr.clone()
        out[idx] = vals
        return out

    # -- sorting ---------------------------------------------------------------
    def _stable_pass(self, order, key):
        return order[torch.sort(key[order], stable=True).indices]

    def lexsort(self, keys):
        """numpy's ``lexsort``: the last key is the primary one; ties keep
        index order."""
        keys = list(keys)
        order = torch.arange(keys[0].shape[0], device=self.device)
        for key in keys:
            key = self.asarray(key)
            if key.dtype.is_floating_point:
                nan = torch.isnan(key)
                clean = torch.where(nan, torch.zeros_like(key), key) + 0.0
                order = self._stable_pass(order, clean)
                order = self._stable_pass(order, nan.to(torch.uint8))
            else:
                order = self._stable_pass(order, key)
        return order

    # -- control flow ----------------------------------------------------------
    @staticmethod
    def while_loop(cond, body, state):
        while bool(cond(state)):
            state = body(state)
        return state
