"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes, record its memory and cost count and the three-term
roofline on the H100, and fail loudly on any sharding or trace error (the
counterpart of ``src/repro/launch/dryrun.py``).

There is no compile to read costs from.  Instead one process stands in for
the whole mesh: rank 0 of a fake process group of 256 (or 512) ranks
(``launch/mesh.py`` :func:`fake_process_group`), its ``DeviceMesh``, and
the cell's real sharded step (``launch/specs.py``) run once under a
``FakeTensorMode`` and the cost counter (``launch/hlo_analysis.py``).  So
the collectives counted are the ones the port's step makes: in a train
cell each parameter's gather over the data axes (and over ``model`` for a
leaf gathered whole) and each gradient's mean, and in every cell the
tensor-parallel layers' sums, gathers and all-to-alls over ``model``.
Nothing is allocated on any device.

The record keeps the reference's keys (``status``, ``memory``,
``roofline``, ``hlo``, ``error``, ``traceback``, ``wall_s``); building the
cell's state stands where the reference has ``lower_s``, and the trace
where it has ``compile_s``.  The memory record estimates the port's step as
it is: ``argument_size_in_bytes`` is a rank's local shards of the
parameters and the optimizer state and its batch (the arguments the step
is given), ``temp_size_in_bytes`` the peak of the storage the step makes
above them.  In every cell each rank of the ``model`` axis computes on its
block of the weights (heads, FFN units, experts, channels, vocabulary), as
the reference's GSPMD partitions its step; a leaf whose dimension does not
divide the axis (one ``_fit`` relocated) is gathered whole and its layer
computes whole on every rank.  A prefill or decode cell is a meshed
server's step: its arguments are the rank's local weights (its blocks over
``model``, whole over the data axes, as the server holds them from build)
and its blocks of the caches under ``cache_specs``; the flash-decode sums
over a split sequence and the head's gather over the vocabulary are
counted among its collectives.  A cell that needs more than a card holds
says so (``fits_80gb``).  A cell that cannot be traced is a ``FAIL`` record
naming the op, and the CLI exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs import runnable_cells
from .hlo_analysis import analyze, storage_bytes
from .mesh import fake_process_group, production_mesh_shape
from .roofline import roofline
from .specs import make_cell

CARD_BYTES = 80e9


def _arg_tensors(args) -> list:
    """Every tensor of a cell's arguments (a DTensor's local block; a
    model's parameters)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    out = []
    for a in tree_flatten(args)[0]:
        items = a.parameters() if isinstance(a, torch.nn.Module) else [a]
        for t in items:
            if isinstance(t, torch.Tensor):
                out.append(t._local_tensor if isinstance(t, DTensor)
                           else t)
    return out


def argument_bytes(args) -> int:
    """Device bytes of a cell's arguments: each storage once, rounded as
    the caching allocator rounds; host state (real tensors beside the fake
    ones: the step count) is not device memory."""
    from torch._subclasses.fake_tensor import FakeTensor
    seen, total = set(), 0
    for t in _arg_tensors(args):
        key = id(t.untyped_storage())
        if isinstance(t, FakeTensor) and key not in seen:
            seen.add(key)
            total += storage_bytes(t)
    return total


def trace_cell(arch: str, shape, mesh_shape: tuple, axes: tuple, *,
               cfg_override=None, microbatches: int = 1,
               keep_text: bool = False) -> dict:
    """One cell's record on a mesh of ``mesh_shape`` x ``axes`` (rank 0 of
    a fake group of its size); raises what the trace raises."""
    from torch.distributed.device_mesh import init_device_mesh
    n_dev = math.prod(mesh_shape)
    rec = {}
    t0 = time.perf_counter()
    with fake_process_group(n_dev):
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=tuple(axes))
        cell = make_cell(arch, shape, mesh, cfg_override=cfg_override,
                         microbatches=microbatches)
        t1 = time.perf_counter()
        with cell.mode:
            costs = analyze(cell.fn, cell.args,
                            known=_arg_tensors(cell.args),
                            keep_text=keep_text)
        t2 = time.perf_counter()
    rec["lower_s"] = round(t1 - t0, 2)
    rec["compile_s"] = round(t2 - t1, 2)
    arg = argument_bytes(cell.args)
    rec["memory"] = {"argument_size_in_bytes": arg, **costs.memory}
    rec["memory"]["fits_80gb"] = \
        arg + costs.memory["temp_size_in_bytes"] <= CARD_BYTES
    rec["hlo"] = {
        "flops_bf16": costs.flops_bf16, "flops_f32": costs.flops_f32,
        "vector_ops": costs.vector_ops, "hbm_bytes": costs.hbm_bytes,
        "collective_bytes": dict(costs.collective_bytes),
        "n_collective_ops": costs.n_collective_ops,
        "aten_flops": dict(costs.aten_flops), "kernels": costs.kernels,
    }
    rec["roofline"] = roofline(costs, cell.cfg, shape, n_dev).to_dict()
    if keep_text:
        rec["hlo_text"] = costs.text
    return rec


def run_cell(arch: str, shape, multi_pod: bool, cfg_override=None,
             microbatches: int = 1, keep_text: bool = False,
             mesh: tuple | None = None) -> dict:
    """The record of one cell on the production mesh (2x16x16 with
    ``multi_pod``, else 16x16), or on ``mesh``, a (shape, axis names)
    pair; a cell that cannot be traced is a ``FAIL`` record."""
    mesh_shape, axes = mesh or production_mesh_shape(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(map(str, mesh_shape)),
           "devices": math.prod(mesh_shape)}
    t0 = time.perf_counter()
    try:
        rec.update(trace_cell(arch, shape, mesh_shape, axes,
                              cfg_override=cfg_override,
                              microbatches=microbatches,
                              keep_text=keep_text))
        rec["status"] = "ok"
    except Exception as e:  # the record names the op that failed
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    cells = runnable_cells()
    if args.arch != "all":
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape != "all":
        cells = [c for c in cells if c[1] == args.shape]
    if args.list:
        for a, s in cells:
            print(a, s)
        return 0

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for multi in meshes:
            tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("status") == "ok":
                    print(f"[skip] {tag} (cached ok)")
                    continue
            rec = run_cell(arch, shape, multi,
                           microbatches=args.microbatches)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                rl, mem = rec["roofline"], rec["memory"]
                total = (mem["argument_size_in_bytes"]
                         + mem["temp_size_in_bytes"]) / 1e9
                print(f"[ok]   {tag:60s} trace={rec['compile_s']:7.1f}s "
                      f"dom={rl['dominant']:10s} step={rl['step_s']:.4g}s "
                      f"mem={total:.1f}GB fits={mem['fits_80gb']}",
                      flush=True)
            else:
                failures += 1
                print(f"[FAIL] {tag}: {rec['error'][:200]}", flush=True)
    print(f"done: {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
