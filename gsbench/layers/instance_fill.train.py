"""Share (%) of the binning's aligned instance rows (Kp a step) that the
traced training steps' frames needed: the program's counters
``binning.needed_rows`` over ``binning.kp_rows``.  Every Kp-sized buffer of
screen space, binning and the composite is sized by the rest too."""
from gsbench import program_totals

UNIT = "%"


def read(rec):
    return program_totals.share(rec, "train", "binning.needed_rows", "binning.kp_rows")
