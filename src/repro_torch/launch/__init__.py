"""Launchers of the port: ``python -m repro_torch.launch.serve``, the
continuous-batching server, and ``python -m repro_torch.launch.train``, the
trainer, as CLIs.  The reference's mesh, sharding and dry-run launchers
are later work (ROADMAP.md, queue 1)."""
