"""Device ms a training step spends in screen space (``ops.rasterize.
screen_space``: covariances, EWA projection, SH colour) and in binning and
the sorted gather (``ops.rasterize.prepare_tiles``), forward and backward."""
from gsbench import ranges

RANGES = {**ranges.SCREEN_SPACE, **ranges.BINNING}
UNIT = "ms/step"


def read(rec):
    return ranges.device_ms(rec, RANGES) if rec["kind"] == "train" else None
