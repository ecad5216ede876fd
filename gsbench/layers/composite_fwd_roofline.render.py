"""Share (%) of the composite forward's device time (the kernels inside
``Composite``) that the least time at the card's peaks would take for the
traced frames, counted by ``counts.composite_fwd`` from the reference's
pair counts."""
from gsbench import counts, ranges

RANGES = ranges.COMPOSITE
UNIT = "%"


def read(rec):
    if rec["kind"] != "render":
        return None
    ms = rec["layers"]["gsbench.composite"]["forward"]
    least, _ = counts.least_s(*counts.composite_fwd(rec["work"], rec["work"]["pixels"]))
    return 100.0 * least / (ms / 1e3) if ms > 0 else None
