"""Device ms a frame spends in the deformation (the offset or SE(3) net and
the opacity-mask gate, as the renderer calls them)."""
from gsbench import ranges

RANGES = ranges.DEFORMATION
UNIT = "ms/frame"


def read(rec):
    return ranges.device_ms(rec, RANGES) if rec["kind"] == "render" else None
