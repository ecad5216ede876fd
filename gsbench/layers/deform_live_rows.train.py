"""Share (%) of the rows that the deformation's nets ran over in the traced
training steps that were alive: the program's counters ``deform.live_rows``
over ``deform.rows``.  The nets run over every capacity row, dead ones too."""
from gsbench import program_totals

UNIT = "%"


def read(rec):
    return program_totals.share(rec, "train", "deform.live_rows", "deform.rows")
