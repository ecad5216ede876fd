"""Device ms a training step spends in the loss (L1, SSIM) and the
optimizer (Adam over every group and the net, densification statistics),
forward and backward."""
from gsbench import ranges

RANGES = ranges.LOSS_OPTIMIZER
UNIT = "ms/step"


def read(rec):
    return ranges.device_ms(rec, RANGES) if rec["kind"] == "train" else None
