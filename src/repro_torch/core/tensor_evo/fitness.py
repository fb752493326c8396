"""Batched schedule fitness: the roofline + launchability gates over a whole
population in one call, errors via equivalence-class execution.

A workload opts into the tensorized path by carrying a
:class:`TensorFitnessSpec` (attribute ``tensor_spec``) describing how its
``(time, error)`` fitness decomposes over one or more *kernel blocks*:

* **time** — each block's schedule-aware roofline + gates
  (``kernels.costs.schedule_terms``) evaluated on gathered per-lane cost
  columns; block times sum, block validity ANDs.  With ``xp=numpy`` this is
  bit-exact with the per-genome scalar path; the same source on torch
  tensors (:class:`~.xp.TorchXP`, gathering from float64 device tables) is
  the engine's device fitness, bit-exact with the numpy path too.
* **error** — real kernel execution, but batched by *error equivalence
  class*: a block declares the knobs its numerics actually depend on
  (e.g. flash attention's error is invariant to ``block_q`` — query blocks
  partition rows without changing per-row arithmetic), so one execution per
  distinct class serves every lane in it.  The parity tests assert batched
  == serial per-genome results, which turns the class-invariance assumption
  into a tested invariant.  Class errors are memoized across generations,
  and ``fill_error_tables`` pre-executes every class (one kernel launch
  each) so the engine can gather errors on the device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..fitness import InvalidVariant
from .encoding import GenomeEncoding
from .xp import DeviceRate, TorchXP


# The cost model's rates: the divisors of its terms.
RATE_FIELDS = ("peak_flops", "hbm_bw", "vector_flops", "grid_step_s",
               "seq_step_s")


def device_model(device):
    """The cost model's device record (``kernels.costs.H100``) with its
    rates as :class:`~.xp.DeviceRate` on ``device``, so that every division
    by a rate is the IEEE division numpy does."""
    from ...kernels.costs import H100
    return dataclasses.replace(H100, **{
        f: DeviceRate(getattr(H100, f), device) for f in RATE_FIELDS})


@dataclass(frozen=True)
class KernelBlock:
    """One kernel's contribution to a (possibly joint) schedule fitness.

    ``knob_map`` renames the kernel's own knobs to the workload space's
    (identity for single-kernel workloads; prefixed for joint spaces).
    ``error_knobs`` are the *kernel-side* knob names the block's numerical
    error depends on; ``error_fn`` executes the kernel for one kernel-side
    genome and returns its max-abs error vs the reference."""

    kernel: str
    shape: tuple[tuple[str, int], ...]
    knob_map: tuple[tuple[str, str], ...]     # kernel knob -> space knob
    error_knobs: tuple[str, ...]
    error_fn: Callable[[dict], float]

    @staticmethod
    def make(kernel: str, shape: dict, error_knobs, error_fn,
             knob_map: dict | None = None) -> "KernelBlock":
        from ...kernels.costs import COL_SPECS
        kmap = knob_map or {c[1]: c[1] for c in COL_SPECS[kernel]}
        return KernelBlock(kernel=kernel, shape=tuple(sorted(shape.items())),
                           knob_map=tuple(sorted(kmap.items())),
                           error_knobs=tuple(error_knobs), error_fn=error_fn)

    def space_knob(self, kernel_knob: str) -> str:
        for k, s in self.knob_map:
            if k == kernel_knob:
                return s
        raise KeyError(kernel_knob)


@dataclass(frozen=True)
class TensorFitnessSpec:
    """Batched-fitness recipe attached to a workload (``tensor_spec``):
    fitness = (sum of block times, max of block errors), invalid when any
    block's gates fail.  Serial runners must combine identically (same
    order) for parity."""

    blocks: tuple[KernelBlock, ...]


class BatchedFitness:
    """The executable form of a spec against one encoding: gather tables,
    vectorized terms, the error-class memo, and the device-side builders."""

    def __init__(self, spec: TensorFitnessSpec, encoding: GenomeEncoding):
        self.spec = spec
        self.encoding = encoding
        self._plans = [self._plan(b) for b in spec.blocks]
        self._err_memo: list[dict[tuple, float]] = [{} for _ in spec.blocks]

    def _plan(self, block: KernelBlock) -> dict:
        from ...kernels.costs import COL_SPECS
        cols = []
        for col, kknob, flag in COL_SPECS[block.kernel]:
            sknob = block.space_knob(kknob)
            cols.append((col, self.encoding.knob_pos(sknob),
                         self.encoding.value_table(sknob, flag)))
        err_pos = tuple(self.encoding.knob_pos(block.space_knob(k))
                        for k in block.error_knobs)
        return {"cols": cols, "shape": dict(block.shape),
                "err_pos": err_pos}

    # -- time + gates ---------------------------------------------------------
    def block_terms(self, xp, b: int, idx, tables=None, model=None):
        """(time, valid, gates) of block ``b`` over an (n, n_knobs) index
        matrix.  ``tables`` (one ``(column, knob position, table)`` list a
        block) replaces the numpy tables, e.g. by device copies; ``model``
        the cost model's device record."""
        from ...kernels.costs import schedule_terms
        plan = self._plans[b]
        cols = {col: xp.asarray(tab)[idx[:, j]]
                for col, j, tab in (plan["cols"] if tables is None
                                    else tables[b])}
        return schedule_terms(xp, self.spec.blocks[b].kernel, cols,
                              device=model, **plan["shape"])

    def terms(self, xp, idx, tables=None, model=None):
        """Combined (time, valid, per_block) — time sums and validity ANDs
        across blocks in declaration order (the serial combine order)."""
        per_block = [self.block_terms(xp, b, idx, tables, model)
                     for b in range(len(self.spec.blocks))]
        time, valid = per_block[0][0], per_block[0][1]
        for t, v, _ in per_block[1:]:
            time = time + t
            valid = valid & v
        return time, valid, per_block

    # -- errors by equivalence class -----------------------------------------
    def _block_genome(self, b: int, row) -> dict:
        """The kernel-side genome of one lane for block ``b``."""
        block = self.spec.blocks[b]
        g = self.encoding.genome_of(row)
        return {kknob: g[sknob] for kknob, sknob in block.knob_map}

    def _class_error(self, b: int, row) -> float:
        """Error of the lane's class for block ``b``; executes the kernel
        once per fresh class (any launchable representative serves — the
        class knobs fully determine the value)."""
        key = tuple(int(row[p]) for p in self._plans[b]["err_pos"])
        memo = self._err_memo[b]
        if key not in memo:
            memo[key] = float(self.spec.blocks[b].error_fn(
                self._block_genome(b, row)))
        return memo[key]

    def errors_np(self, idx, valid) -> np.ndarray:
        """Per-lane error (max across blocks) for valid lanes; invalid
        lanes return inf (they never reach the objectives)."""
        n = idx.shape[0]
        err = np.full(n, np.inf)
        for i in np.flatnonzero(valid):
            e = self._class_error(0, idx[i])
            for b in range(1, len(self.spec.blocks)):
                e = max(e, self._class_error(b, idx[i]))
            err[i] = e
        return err

    # -- the numpy parity entry ----------------------------------------------
    def evaluate_np(self, idx):
        """(time, valid, error, reasons): bit-exact with the serial scalar
        path.  ``reasons[i]`` is the exact InvalidVariant message the serial
        evaluator would raise for lane ``i`` (None when valid)."""
        from ...kernels.costs import gate_message
        idx = np.asarray(idx)
        time, valid, per_block = self.terms(np, idx)
        time = np.asarray(time, np.float64).reshape(len(idx))
        valid = np.asarray(valid, bool).reshape(len(idx))
        err = self.errors_np(idx, valid)
        reasons: list[str | None] = [None] * len(idx)
        for i in np.flatnonzero(~valid):
            for t, v, gates in per_block:
                if not bool(np.asarray(v).reshape(-1)[i]):
                    reasons[i] = gate_message(gates, i)
                    break
        return time, valid, err, reasons

    # -- device-side builders -------------------------------------------------
    def torch_terms_fn(self, device):
        """An ``idx -> (time, valid)`` closure over a device tensor of index
        rows: the cost model's terms as torch ops on ``device``, gathering
        from value tables made once as float64 device tensors (booleans
        stay boolean) and dividing by rates on the device
        (:func:`device_model`), so every term is the float64 operation the
        numpy path does."""
        xp = TorchXP(device)
        tables = [[(col, j, xp.asarray(tab)) for col, j, tab in plan["cols"]]
                  for plan in self._plans]
        model = device_model(device)

        def fn(idx):
            time, valid, _ = self.terms(xp, idx, tables, model)
            return time, valid

        return fn

    def class_sizes(self) -> list[int]:
        return [math.prod(len(self.encoding.space.params[p][1])
                          for p in plan["err_pos"])
                for plan in self._plans]

    def fill_error_tables(self) -> list[np.ndarray]:
        """Pre-execute every error class of every block so the engine can
        gather errors on the device.  A class with no launchable
        completion gets inf (its lanes are invalid anyway).  Classes are
        enumerated in mixed-radix order over ``err_pos`` (row-major), the
        same order ``class_ids`` uses."""
        tables = []
        for b, (block, plan) in enumerate(zip(self.spec.blocks,
                                              self._plans)):
            err_pos = plan["err_pos"]
            choice_idx = [range(len(self.encoding.space.params[p][1]))
                          for p in err_pos]
            other = [j for j in range(self.encoding.n_knobs)
                     if j not in err_pos]
            table = []
            for combo in itertools.product(*choice_idx):
                key = tuple(combo)
                if key in self._err_memo[b]:
                    table.append(self._err_memo[b][key])
                    continue
                row = self._launchable_rep(b, err_pos, combo, other)
                if row is None:
                    self._err_memo[b][key] = np.inf
                else:
                    self._class_error(b, row)
                table.append(self._err_memo[b][key])
            tables.append(np.asarray(table, np.float64))
        return tables

    def _launchable_rep(self, b: int, err_pos, combo, other):
        """First (index-order) completion of a class whose *block* gates
        pass, or None.  Only this block's launchability matters — its
        error_fn executes this kernel alone."""
        from ...kernels.costs import schedule_time
        space = self.encoding.space
        base = np.array(self.encoding.base_idx, np.int64)
        for fill in itertools.product(*(range(len(space.params[j][1]))
                                        for j in other)):
            row = base.copy()
            row[list(err_pos)] = combo
            row[other] = fill
            try:
                schedule_time(self.spec.blocks[b].kernel,
                              self._block_genome(b, row),
                              **self._plans[b]["shape"])
                return row
            except InvalidVariant:
                continue
        return None

    def torch_error_fn(self, device):
        """``idx -> error`` over a device tensor of index rows: a gather
        from the pre-filled class tables, made once as float64 device
        tensors (max across blocks)."""
        tables = self.fill_error_tables()
        parts = []
        for plan, table in zip(self._plans, tables):
            err_pos = plan["err_pos"]
            radix = []
            mult = 1
            for p in reversed(err_pos):
                radix.append(mult)
                mult *= len(self.encoding.space.params[p][1])
            radix = list(reversed(radix))
            parts.append((tuple(err_pos), tuple(radix),
                          torch.as_tensor(table, dtype=torch.float64,
                                          device=device)))

        def fn(idx):
            err = None
            for err_pos, radix, table in parts:
                cid = 0
                for p, r in zip(err_pos, radix):
                    cid = cid + idx[:, p] * r
                e = table[cid]
                err = e if err is None else torch.maximum(err, e)
            return err

        return fn
