"""The median host time, in ms, of the engine steps that only decoded
(no admission), each ending on the device's result."""

import statistics


def read(run, **_):
    ticks = run.step_ms.get("decode", [])
    return statistics.median(ticks) if ticks else None
