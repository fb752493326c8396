"""Launchers of the port: ``python -m repro_torch.launch.serve``, the
continuous-batching server, and ``python -m repro_torch.launch.train``, the
trainer (``--mesh smoke`` for the reference's smoke mesh), as CLIs;
``mesh`` (process groups and ``DeviceMesh``es) and ``shardings`` (the
reference's sharding rules as DTensor placements).  The reference's
``specs``, ``dryrun``, ``roofline`` and ``hlo_analysis`` are later work
(ROADMAP.md, queue 1)."""
