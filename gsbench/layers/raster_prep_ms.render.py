"""Device ms a frame spends in screen space (``ops.rasterize.screen_space``)
and in binning and the sorted gather (``ops.rasterize.prepare_tiles``)."""
from gsbench import ranges

RANGES = {**ranges.SCREEN_SPACE, **ranges.BINNING}
UNIT = "ms/frame"


def read(rec):
    return ranges.device_ms(rec, RANGES) if rec["kind"] == "render" else None
