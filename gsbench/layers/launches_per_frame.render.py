"""Device operations (kernels, copies, sets) a frame launches: those of the
traced frames' calls into the program."""
UNIT = "launches/frame"


def read(rec):
    return rec["launches"] / rec["units"] if rec["kind"] == "render" and rec["launches"] else None
