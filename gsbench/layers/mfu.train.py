"""Share (%) of the card's peak that a training step's counted work takes in
the window's time a step: the nets' FLOPs over the alive gaussians, each at
the peak of its stated precision, and the composite's operations (forward
and backward) at the fp32 peak (``counts``)."""
from gsbench import counts

UNIT = "%"


def read(rec):
    if rec["kind"] != "train":
        return None
    w, units = rec["work"], rec["units"]
    flops = counts.net_flops(rec["config"], w["rows"], train=True)
    ops = counts.composite_fwd(w, w["pixels"])[1] + counts.composite_bwd(w, w["pixels"])[1]
    flops["float32"] = flops.get("float32", 0.0) + ops / units
    return counts.step_share(flops, rec["unit_s"])

