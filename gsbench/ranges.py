"""The layers' ranges in a traced run: each range's name and the (module,
attribute) pairs it wraps where the program's callers look them up
(``harness.ranged``).  Readers name the ranges they read."""

PORT = "gs_deformable_tpu_torch"

DEFORMATION = {"gsbench.deformation": [(f"{PORT}.models.deform", "deform_offsets"),
                                       (f"{PORT}.models.deform", "deform_se3"),
                                       (f"{PORT}.models.deform", "opacity_mask_gate")]}
SCREEN_SPACE = {"gsbench.screen_space": [(f"{PORT}.ops.rasterize", "screen_space")]}
BINNING = {"gsbench.binning": [(f"{PORT}.ops.rasterize", "prepare_tiles")]}
COMPOSITE = {"gsbench.composite": [(f"{PORT}.ops.rasterize", "Composite")]}
LOSS_OPTIMIZER = {"gsbench.loss_optimizer": [(f"{PORT}.training", "l1_loss"),
                                             (f"{PORT}.training", "ssim"),
                                             (f"{PORT}.training", "adam_step"),
                                             (f"{PORT}.training", "add_densification_stats")]}


def device_ms(rec: dict, rngs: dict):
    """Device ms a unit (step or frame) of the ranges, forward and backward;
    None when the trace holds none."""
    ms = sum(rec["layers"][name]["forward"] + rec["layers"][name]["backward"] for name in rngs)
    return ms / rec["units"] if ms > 0 else None
