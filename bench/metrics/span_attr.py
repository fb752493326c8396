"""A counter of one of the port's spans (``repro_torch.spans``) over the
traced window: the mean of ``attr`` over the spans named ``span``; or,
with ``over``, ``scale`` times the summed ``attr`` over the summed
``over``.  Nothing where the port recorded no such span."""

from harness.program_spans import records


def read(run, *, span, attr, over=None, scale=1.0, **_):
    recs = records(run)
    mine = [s.attrs for s in recs or () if s.name == span]
    if not mine:
        return None
    if over is None:
        return sum(a[attr] for a in mine) / len(mine)
    n = sum(a[over] for a in mine)
    return scale * sum(a[attr] for a in mine) / n if n else None
