"""Launchers of the port: ``python -m repro_torch.launch.serve``, the
continuous-batching server as a CLI.  The reference's mesh, sharding,
dry-run and training launchers are later work (ROADMAP.md, queue 1)."""
