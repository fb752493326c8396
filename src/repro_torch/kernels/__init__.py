"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port of the
reference package's Pallas TPU kernels: flash attention, the mamba
selective scan, and fused RMSNorm.

Each kernel directory holds:
  <name>.py -- the ctypes launcher of ``csrc/<name>.cu``, the kernel's
               ``smem_bytes`` and its plain PyTorch version
  ops.py    -- the public wrapper: the CUDA kernel on CUDA tensors, the
               plain version on CPU tensors; counts launches
  ref.py    -- the plain-PyTorch oracle the tests and the search's error
               objective compare against

``build.py`` compiles the sources with ``nvcc`` at first use; ``cpu.py``
prepares PyTorch's CPU vector math for the host paths; ``costs.py`` is the
static cost model and ``workloads.py`` makes each kernel a GEVO workload.
"""
