"""Meshes (the counterpart of ``src/repro/launch/mesh.py``).

The reference builds a ``jax`` mesh over the devices one controller
drives.  Here one process drives each device, so a mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of a process group,
with the reference's axis names as ``mesh_dim_names``.  Meshes are built
by FUNCTIONS, never at import, so importing this module touches no
process group.

* :func:`init_process_group` starts the group: gloo for CPU tensors,
  NCCL for CUDA tensors (never gloo on the card), through a ``file://``
  rendezvous, so no TCP port is chosen and two groups on one host cannot
  clash.
* :func:`make_smoke_mesh` is the reference's 2 x 2 on the CPU (four gloo
  ranks) and the card's ``(1, 1)``; NCCL takes one GPU a rank, so a mesh
  of more ranks than GPUs raises.
* :func:`launch_ranks` starts one process a rank and waits for them all
  under a deadline, killing every one when one fails or the deadline
  passes.
* :func:`on_mesh` runs a command's body on the rank this process is
  (:func:`rank_mesh`: its group started and destroyed around the body,
  only rank 0's standard output kept), or, on the CPU, starts the
  command's ranks and relays rank 0's output: ``launch.train --mesh
  smoke`` and the serving CLIs' ``--mesh DATAxMODEL``.
* :func:`fake_process_group` stands a group of any size up in this one
  process, whose collectives do nothing: the production mesh of the dry
  run (``launch/dryrun.py``), traced on tensors without data.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXES = ("data", "model")
# seconds the ranks a command starts (on_mesh) may take together (a smoke
# run takes about ten)
MESH_TIMEOUT = 300.0


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The reference's production mesh: 16x16 = 256 chips a pod, 2 pods =
    512 chips multi-pod, as (shape, axis names)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), AXES


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production mesh over a started process group of 256 (or 512)
    ranks."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return _mesh(shape, axes, device_type)


def make_smoke_mesh(n_data: int = 2, n_model: int = 2, device_type=None):
    """A small ``("data", "model")`` mesh over a started process group of
    ``n_data * n_model`` ranks (CPU tests: four gloo ranks; the card:
    ``(1, 1)``)."""
    return _mesh((n_data, n_model), AXES, device_type)


def _mesh(shape, axes, device_type=None):
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    device_type = device_type or _backend_device()
    if device_type == "cuda" and torch.cuda.device_count() < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh over NCCL "
                         f"needs {need} CUDA devices, one a rank; this host "
                         f"has {torch.cuda.device_count()}")
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a "
                         f"process group of {need} ranks, started by "
                         f"init_process_group; it has {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def _backend_device() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_axes(mesh) -> tuple[tuple[str, ...], str]:
    """(batch/data axes, model axis) for a mesh from make_production_mesh."""
    names = mesh.mesh_dim_names
    model = "model" if "model" in names else names[-1]
    batch = tuple(n for n in names if n != model)
    return batch, model


@dataclass(frozen=True)
class MeshShape:
    """A mesh's geometry without its processes (``mesh_dim_names`` and
    ``shape``, as a ``DeviceMesh`` gives them): what the sharding rules
    read, so they can be evaluated for any mesh on one host."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...] = AXES


def init_process_group(device_type: str, rank: int, world_size: int,
                       init_file: str) -> torch.device:
    """Start this process's rank of a group: NCCL for ``"cuda"`` (rank r
    on GPU r), gloo for ``"cpu"``, meeting through ``init_file`` (a path
    no other group uses, which need not exist yet).  Returns the rank's
    device."""
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group for device type "
                         f"{device_type!r}")
    _forget_meshes()
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)
    return device


def _forget_meshes() -> None:
    """Drop DTensor's cached sharding propagation before a group starts:
    it keys its results by meshes compared by value, so an op on a mesh
    made again in a later group of the process (a CLI's group after a
    test's) would be handed the earlier group's mesh, whose process
    groups are gone (torch's debug helper; a version without it has
    nothing to drop)."""
    from torch.distributed.tensor import debug
    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """Rank ``rank`` of a process group of ``world_size`` ranks held by
    this process alone: torch's ``fake`` backend, whose collectives return
    at once, over its in-process store (a private module of torch's test
    utilities, imported here only).  A group of the same size and backend
    that is already started is used as it is; any other group is refused,
    never replaced.  A group this started is destroyed when the block
    ends, however it ends."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size \
                or dist.get_backend() != "fake":
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks "
                f"({dist.get_backend()}) is running; a fake group of "
                f"{world_size} cannot start beside it")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_env() -> tuple[int, int, str]:
    """(rank, world size, rendezvous file) of a process that
    :func:`launch_ranks` started."""
    return (int(os.environ["MESH_RANK"]), int(os.environ["MESH_WORLD"]),
            os.environ["MESH_INIT_FILE"])


class RankFailure(RuntimeError):
    """A rank that :func:`launch_ranks` started exited nonzero, or the
    ranks outlived their deadline."""


def launch_ranks(argv: list[str], world_size: int, init_file: str, *,
                 timeout: float, threads: int = 1, env=None) -> list[str]:
    """Run ``python argv...`` once a rank, each with ``MESH_RANK``,
    ``MESH_WORLD`` and ``MESH_INIT_FILE`` set (:func:`rank_env`) and
    ``threads`` intra-op threads, and wait for all of them.  Returns each
    rank's standard output.  A rank that fails, or the ``timeout`` (in
    seconds, for all of them) passing, kills every rank still running and
    raises :class:`RankFailure` with the failed rank's error output."""
    procs, logs = [], []
    try:
        for rank in range(world_size):
            e = dict(os.environ if env is None else env)
            e.update(MESH_RANK=str(rank), MESH_WORLD=str(world_size),
                     MESH_INIT_FILE=init_file, OMP_NUM_THREADS=str(threads))
            out, err = (tempfile.TemporaryFile("w+") for _ in range(2))
            logs.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e,
                                          stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise RankFailure(f"ranks still running after {timeout} s")
            time.sleep(0.05)
        for rank, p in enumerate(procs):
            if p.returncode not in (None, 0):
                err = logs[rank][1]
                err.seek(0)
                raise RankFailure(f"rank {rank} exited {p.returncode}:\n"
                                   f"{err.read()[-4000:]}")
        texts = []
        for out, _ in logs:
            out.seek(0)
            texts.append(out.read())
        return texts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DATAxMODEL"`` (a ``--mesh`` argument, e.g. ``2x2``) as
    ``(DATA, MODEL)``."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"a mesh is DATAxMODEL, e.g. 2x2; got "
                         f"{text!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"a mesh has at least one rank a dim; got {text!r}")
    return d, m


@contextlib.contextmanager
def rank_mesh(device: torch.device, n_data: int, n_model: int):
    """The ``(n_data, n_model)`` smoke mesh of this process's rank in a
    group started here and destroyed after, however the block ends: the
    rank :func:`launch_ranks` made it (:func:`rank_env`), or else a group
    of one rank (the card's ``(1, 1)`` over NCCL).  A mesh of more ranks
    than the group has, or of more GPUs than the host has, raises
    :func:`make_smoke_mesh`'s ``ValueError``."""
    d = None
    try:
        if "MESH_RANK" in os.environ:
            init_process_group(device.type, *rank_env())
        else:
            d = tempfile.mkdtemp(prefix="mesh_")
            init_process_group(device.type, 0, 1, os.path.join(d, "init"))
        yield make_smoke_mesh(n_data, n_model, device_type=device.type)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)


def on_mesh(module: str, argv: list[str], device: torch.device,
            shape: tuple[int, int], body):
    """A command's ``body(mesh)`` on this process's rank of the ``shape``
    smoke mesh (:func:`rank_mesh`), with only rank 0's standard output
    kept; returns what ``body`` returns.  On the CPU, a process that is no
    rank yet, for a mesh of more than one rank, starts the ranks instead:
    ``python -m module argv...`` once a rank (:func:`launch_ranks`,
    meeting in a temporary directory removed after, killed after
    ``MESH_TIMEOUT`` seconds), prints rank 0's output and returns every
    rank's; it raises as :func:`launch_ranks` does."""
    world = math.prod(shape)
    if device.type == "cpu" and world > 1 and "MESH_RANK" not in os.environ:
        d = tempfile.mkdtemp(prefix="mesh_")
        try:
            outs = launch_ranks(["-m", module, *argv], world,
                                os.path.join(d, "init"),
                                timeout=MESH_TIMEOUT)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        print(outs[0], end="", flush=True)
        return outs
    with rank_mesh(device, *shape) as mesh:
        quiet = dist.get_rank() != 0
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            return body(mesh)
