"""repro_torch.train — so far only :mod:`~repro_torch.train.fault`, the
fleet's pure-Python fault-tolerance logic (the router's
``HeartbeatMonitor``).  The reference's train step and checkpointing are
later work (ROADMAP.md, queue 1)."""

from . import fault  # noqa: F401
