"""Host ms a traced frame spends in the program's ``gs.screen_space`` and
``gs.binning`` spans, each less the spans opened inside it: the Python and
launches of covariances, projection, SH colour, tile cull, binning and the
sorted gather."""
from gsbench import program_totals

UNIT = "ms/frame"


def read(rec):
    return program_totals.host_ms(rec, "render", ("gs.screen_space", "gs.binning"), "self_s")
