"""GEVO-ML on PyTorch and CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100.

The layout follows ``src/repro/`` file for file, so each module can be
checked against the reference module of the same path.  This package
imports ``torch`` and numpy and never JAX or anything of ``repro``; only the
parity tests import both.  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""
