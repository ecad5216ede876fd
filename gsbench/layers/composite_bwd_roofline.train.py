"""Share (%) of the composite backward's device time (the kernels that the
backward of ``Composite`` runs) that the least time at the card's peaks
would take for the traced steps' frames, counted by ``counts.composite_bwd``
from the reference's pair counts."""
from gsbench import counts, ranges

RANGES = ranges.COMPOSITE
UNIT = "%"


def read(rec):
    if rec["kind"] != "train":
        return None
    ms = rec["layers"]["gsbench.composite"]["backward"]
    least, _ = counts.least_s(*counts.composite_bwd(rec["work"], rec["work"]["pixels"]))
    return 100.0 * least / (ms / 1e3) if ms > 0 else None
