"""Device ms a training step spends in the deformation (the offset or SE(3)
net and the opacity-mask gate, as the renderer calls them), forward and
backward."""
from gsbench import ranges

RANGES = ranges.DEFORMATION
UNIT = "ms/step"


def read(rec):
    return ranges.device_ms(rec, RANGES) if rec["kind"] == "train" else None
