"""Launchers of the port: ``python -m repro_torch.launch.serve``, the
continuous-batching server, and ``python -m repro_torch.launch.train``, the
trainer (``--mesh smoke`` for the reference's smoke mesh), and ``python -m
repro_torch.launch.dryrun``, the multi-pod dry run, as CLIs; ``mesh``
(process groups and ``DeviceMesh``es, and the fake group of the
production mesh), ``shardings`` (the reference's sharding rules as
DTensor placements), ``specs`` (a cell's step, abstract arguments and
shardings), ``hlo_analysis`` (the cost count of a traced step) and
``roofline`` (its three terms on the H100)."""
