"""The program's own span and counter totals of the traced stretch, for the
readers that read them: ``gs_deformable_tpu_torch.tracing`` keeps them for
each ``torch.profiler`` session, and the traced stretch is one.  A program
without that module, or a trace in which the card ran nothing, gives None."""


def of(rec: dict, kind: str):
    """The program's ``tracing`` module when ``rec`` is a traced run of a
    cell of ``kind`` on a card, else None."""
    if rec["kind"] != kind or rec["busy_s"] <= 0:
        return None
    try:
        from gs_deformable_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def share(rec: dict, kind: str, part: str, whole: str):
    """100 x counter ``part`` over counter ``whole``; None where either is missing."""
    tracing = of(rec, kind)
    if tracing is None:
        return None
    c = tracing.counters()
    return 100.0 * c[part] / c[whole] if c.get(whole) and part in c else None


def host_ms(rec: dict, kind: str, names, field: str):
    """Host ms a unit in the spans ``names`` (``field``: "host_s" or
    "self_s"); None where none of them was opened."""
    tracing = of(rec, kind)
    if tracing is None:
        return None
    s = tracing.spans()
    if not any(n in s for n in names):
        return None
    return 1e3 * sum(s[n][field] for n in names if n in s) / rec["units"]
