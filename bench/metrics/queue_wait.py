"""A percentile, in s, of each answered request's wait from when it was
due to its admission (``ServeResult.t_admit``)."""

from harness.traffic import nearest_rank


def read(run, *, percentile, **_):
    return nearest_rank(run.queue_wait_s, percentile) \
        if run.queue_wait_s else None
