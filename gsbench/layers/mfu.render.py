"""Share (%) of the card's peak that a frame's counted work takes in the
window's time a frame: the nets' FLOPs over the alive gaussians at the peak
of their stated precision, and the composite forward's operations at the
fp32 peak (``counts``)."""
from gsbench import counts

UNIT = "%"


def read(rec):
    if rec["kind"] != "render":
        return None
    w, units = rec["work"], rec["units"]
    flops = counts.net_flops(rec["config"], w["rows"], train=False)
    flops["float32"] = flops.get("float32", 0.0) + counts.composite_fwd(w, w["pixels"])[1] / units
    return counts.step_share(flops, rec["unit_s"])

