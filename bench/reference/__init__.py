"""Plain PyTorch references of the benchmark's configurations.

Each module follows its configuration's published equations in float32
(TF32 off), with no kernel, cache or batching, and imports nothing of the
port or of the JAX package: ``harness/imports.py`` checks every run.  A
module gives ``param_specs(config)`` (the parameters both sides are handed)
and the computation its cells compare; ``precision="fp8"`` computes every
matrix product from float8 (e4m3) operands, the control a cell's limits
must fail.
"""
