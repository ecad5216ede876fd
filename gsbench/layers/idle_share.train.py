"""Share (%) of the traced training steps' wall time in which no kernel,
copy or set ran on the card."""
UNIT = "%"


def read(rec):
    if rec["kind"] != "train" or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
