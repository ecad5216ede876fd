"""Device operations (kernels, copies, sets) a training step launches: those
of the traced steps' calls into the program and of their backward."""
UNIT = "launches/step"


def read(rec):
    return rec["launches"] / rec["units"] if rec["kind"] == "train" and rec["launches"] else None
