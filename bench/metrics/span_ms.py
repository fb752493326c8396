"""Device time of one of the port's spans (``repro_torch.spans``; its
``device_ms``: from the stream reaching the span's start to it reaching its
end, stalls included), over the traced window.  With ``per``: the median,
over the spans named ``per``, of the summed times of the spans named
``span`` inside each, in ms.  With ``over``: the summed times over the
summed counter ``over`` of those spans, in us.  Nothing where the port
recorded no such span or did not time it on the device."""

import statistics

from harness.program_spans import by_parent, records


def read(run, *, span, per=None, over=None, **_):
    recs = records(run)
    if not recs:
        return None
    mine = [s for s in recs if s.name == span and s.device_ms is not None]
    if not mine:
        return None
    if per is not None:
        groups = by_parent(mine, span, per)
        return statistics.median(sum(s.device_ms for s in g)
                                 for g in groups.values()) if groups else None
    n = sum(s.attrs[over] for s in mine)
    return 1e3 * sum(s.device_ms for s in mine) / n if n else None
