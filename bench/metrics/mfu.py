"""The whole step's share of the card's bf16 peak, in %: the model FLOPs
of the work (``harness/flops.py``) over the time it took times 989e12.
Training: the traced window's steps over the window.  Serving: every
prompt and generated token of the requests the engine answered over the
summed host time of the engine steps that did work (each ends on the
device's result)."""

from harness.costs import PEAK_BF16_FLOPS


def read(run, **_):
    if run.trace is None or run.work_s <= 0 or run.model_flops <= 0:
        return None
    return 100.0 * run.model_flops / (run.work_s * PEAK_BF16_FLOPS)
