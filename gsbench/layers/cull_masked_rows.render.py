"""Share (%) of the rows touching a tile in the traced frames that the
exact per-tile ellipse cull applied to (rects of 16 tiles or fewer): the
program's counters ``cull.masked_rows`` over ``cull.rows``.  The other rows
bin every tile of their rect."""
from gsbench import program_totals

UNIT = "%"


def read(rec):
    return program_totals.share(rec, "render", "cull.masked_rows", "cull.rows")
