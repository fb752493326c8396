"""Build and load the hand-written CUDA kernels.

Each source ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
go to ``build/repro_torch_kernels/`` at the repository root, named by a hash
of the sources and flags, so a changed source is rebuilt and an unchanged
one is loaded as it is.  Building happens at first use, or ahead of it with
:func:`build` — which starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..core.fitness import DeviceFault

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("rmsnorm", "flash_attention", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# element-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(DeviceFault):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(DeviceFault):
    """The CUDA runtime refused a kernel launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the file name
    carries a hash of the source, every header under ``csrc/`` and the
    flags, so a changed header rebuilds every library."""
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns seconds of
    wall time per compiled source (0.0 for one already built); the ``ptxas``
    report of each build is kept beside its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    out: dict[str, float] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT),
                         tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builders agree
    if failed:
        raise KernelBuildError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, its argument types
    declared (every pointer and the stream as ``c_void_p``); it returns a
    ``cudaError_t``."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` for a nonzero ``cudaError_t``
    returned by a launcher of ``csrc/<name>.cu``."""
    if err != 0:
        msg = library(name).repro_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as the C launchers take
    it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
