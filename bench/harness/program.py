"""The system under test, built from a configuration file: the port's
``ModelConfig`` from its ``port`` block, and the port's model with the
weights the harness draws (``harness/weights.py``)."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

from . import weights


def reference(config: dict):
    """The plain reference module the configuration names."""
    return importlib.import_module(f"reference.{config['reference']}")


def port_config(config: dict):
    from repro_torch.models.common import ModelConfig
    return ModelConfig(**config["port"])


def model(config: dict, seed: int, device):
    """The port's model of ``config`` on ``device``, holding the weights
    of ``seed``: its parameters' skeleton (names, shapes, dtypes) must be
    the reference's list."""
    from repro_torch.models.transformer import init_params
    specs = reference(config).param_specs(config)
    m = init_params(port_config(config), device="meta")
    weights.check_skeleton(m, specs)
    m = m.to_empty(device=device)
    weights.load_into(m, weights.make(specs, seed, device))
    return m


@dataclass
class Run:
    """What a runner hands the per-layer readers and the result line."""
    config: dict                   # the configuration file
    e2e: dict = field(default_factory=dict)        # end-to-end values
    attempted: int = 0
    failed: int = 0
    checks: list = field(default_factory=list)     # (name, value, limit)
    memory_peak: int = 0
    notes: list = field(default_factory=list)      # lines for stderr
    trace: object = None           # harness.trace.Trace of the window
    units: int = 0                 # train steps / prefills in the window
    model_flops: float = 0.0       # in the traced window's work
    work_s: float = 0.0            # the time that work took
    step_ms: dict = field(default_factory=dict)    # kind -> [ms]
    queue_wait_s: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)       # control readings

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for _, v, lim in
                                        self.checks)
