"""The benchmark harness of the PyTorch/CUDA port (``src/repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, one traffic mix or one per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``bench/configs/<config>.json``: the published configuration as it is
  run, the port's ``ModelConfig`` fields (``port``) and the plain
  reference that follows it (``reference``: a module of
  ``bench/reference/``);
* ``bench/traffic/<traffic>.json``: the parameters of one mix, read by the
  generator and the runner it names (``harness/<runner>.py``);
* ``bench/metrics/<metric>.json``: the reader (``bench/metrics/<reader>.py``)
  of one per-layer metric and its parameters;
* ``bench/limits/<workload>.json``: the limits ``correct`` holds each
  compared number to in that cell, with the readings they were set from.

Nothing here imports ``jax`` or the JAX package ``repro``; the plain
references import nothing of the port either (``harness/imports.py``).
"""
