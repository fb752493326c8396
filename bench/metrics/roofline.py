"""A kernel's share of its roofline, in %: the sum over its calls in the
traced window of each call's least time (``harness/costs.py``, at the
call's own shapes) over the device time of its kernels, found by name.
The calls of each direction must number what the configuration implies
(``kernel_calls`` of its file, a ``per`` unit: a train step or a
prefill); otherwise the reader says so and returns nothing."""

import re
import sys

from harness.costs import cost


def read(run, *, kernel, directions, device_pattern, per, **_):
    t = run.trace
    if t is None:
        return None
    mine = [(d, s) for k, d, s in t.calls if k == kernel and d in directions]
    want = run.units * run.config["kernel_calls"][per].get(kernel, 0)
    for d in directions:
        n = sum(1 for dd, _ in mine if dd == d)
        if n != want:
            print(f"roofline {kernel} {d}: {n} calls in the window, the "
                  f"configuration implies {want}", file=sys.stderr)
            return None
    seconds, spans = t.device_s(re.compile(device_pattern))
    if not mine or seconds <= 0 or spans < len(mine):
        return None
    least = sum(cost(kernel, d, s).least_s() for d, s in mine)
    return 100.0 * least / seconds
