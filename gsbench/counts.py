"""Work a cell's inputs need, counted from the inputs and never from how the
program does it, and the card's published peaks.

- The deformation nets: 2 x sum(in x out) FLOPs a row forward, over the
  alive gaussians; a training step takes three times that for a net it
  trains (forward, input and weight gradients) and twice that for the
  opacity-mask gate, whose weights take no gradient.
- The composite: each (gaussian, tile) pair whose gaussian reaches
  alpha >= 1/255 at a pixel of the tile reads its screen-space record (mean
  2, conic 3, opacity 1, colour 3: 9 floats) once; each pixel writes its
  colour and final transmittance once.  The backward also reads each
  pixel's upstream gradient (colour and transmittance) and its final
  transmittance, and writes 9 gradient floats per gaussian touched.
  Operations: 16 per (pixel, pair) walked up to the pair that stops the
  pixel (offset 2, quadratic form 9, exp, opacity product, clamp, two
  tests) and 10 more per contributing pair (1 - alpha, the transmittance
  product and test, alpha T, three colour multiply-adds); the backward
  walks up to the pixel's last contributing pair, 16 per pair, and spends
  37 per contributing pair on the gradients.
- Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
F32 = 4
RECORD_FLOATS = 9
OPS_WALKED = 16
OPS_CONTRIB = 10
OPS_WALKED_BWD = 16
OPS_CONTRIB_BWD = 37


def mlp_macs(in_dim: int, skip_dim: int, head_dims: Sequence[int], depth: int, width: int,
             skips: Sequence[int]) -> int:
    """Multiply-adds of one row through a trunk and its heads."""
    macs, fan_in = 0, in_dim
    for i in range(depth):
        macs += fan_in * width
        fan_in = width + (skip_dim if i in skips else 0)
    return macs + width * sum(head_dims)


def nets(config: dict) -> List[Tuple[str, int, str, int]]:
    """(name, multiply-adds a row, precision, passes in a training step) of
    each net the configuration runs."""
    d, w, sk = config["depth"], config["width"], config["skips"]
    sh = (config["sh_degree"] + 1) ** 2
    if config["deform_mode"] == "offset":
        xe = 3 * (1 + 2 * config["multires_xyz"])
        te = 1 + 2 * config["multires_time"]
        out = [("net", mlp_macs(xe + te, xe, (3, 3, 4, 3 * sh), d, w, sk),
                config["compute_dtype"], 3)]
    else:
        out = [("net", mlp_macs(4, 3, (3, 3), d, w, sk), config["compute_dtype"], 3)]
    if config["use_opacity_mask"]:
        out.append(("gate", mlp_macs(4, 3, (1,), d, w, sk), "float32", 2))
    return out


def net_flops(config: dict, rows: int, train: bool) -> Dict[str, float]:
    """FLOPs of the nets over ``rows`` gaussians by precision."""
    out: Dict[str, float] = {}
    for _, macs, prec, passes in nets(config):
        out[prec] = out.get(prec, 0.0) + 2.0 * macs * rows * (passes if train else 1)
    return out


def composite_fwd(work: dict, pixels: int) -> Tuple[float, float]:
    """(bytes, operations) of the composite forward."""
    nbytes = F32 * (RECORD_FLOATS * work["needed_pairs"] + 4 * pixels)
    return nbytes, OPS_WALKED * work["walked"] + OPS_CONTRIB * work["contributing"]


def composite_bwd(work: dict, pixels: int) -> Tuple[float, float]:
    """(bytes, operations) of the composite backward."""
    nbytes = F32 * (RECORD_FLOATS * work["needed_pairs"] + 5 * pixels
                    + RECORD_FLOATS * work["touched"])
    return nbytes, OPS_WALKED_BWD * work["walked_bwd"] + OPS_CONTRIB_BWD * work["contributing"]


def least_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """Least time at the peaks, and which bound sets it."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS["float32"]
    return (tb, "bytes") if tb >= to else (to, "operations")


def step_share(flops: Dict[str, float], seconds: float) -> float:
    """Share (%) of the card's peak that ``flops`` (by precision) take in ``seconds``."""
    return 100.0 * sum(f / PEAK_FLOPS[p] for p, f in flops.items()) / seconds
