"""The device's idle share of the traced window, in %: the time in which
no device span ran, over the window (the union of the profiler's device
spans, ``harness/trace.py``)."""


def read(run, **_):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1 - t.busy_ns() / (t.t1_ns - t.t0_ns))
