"""The numbers that decide ``correct``: the program's outputs against the
reference's, each as one number that a limit of the cell holds.

Training (the first three steps of the run, which set-up drives through the
window's own call): the worst relative gap of the three losses; the worst
leaf's gap between the norms of the program's and the reference's first
gradient (the program's as Adam's first moment holds it after one step);
the worst leaf's gap between the norms of the change of the parameters
after three steps.  A leaf's gap is measured against the reference's norm
of that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change: Adam moves them by round-off alone.

Rendering: the worst relative L2 gap between the program's and the
reference's image over frames sampled from the window.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

ROUND_OFF_SHARE = 1e-3


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def _worst(got: Dict[str, float], ref: Dict[str, float], keys) -> tuple:
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict, initial: Dict[str, torch.Tensor]) -> dict:
    """``prog`` and ``ref``: ``losses`` (3 floats), ``grads`` and ``params``
    (dicts of tensors by leaf name, alive rows only); ``initial``, the
    leaves before the first step."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gp = {k: _norm(v) for k, v in prog["grads"].items()}
    gr = {k: _norm(v) for k, v in ref["grads"].items()}
    grad_gap, grad_leaf = _worst(gp, gr, list(gr))
    med = statistics.median(gr.values())
    moved = [k for k in gr if gr[k] >= ROUND_OFF_SHARE * med]
    cp = {k: _norm(prog["params"][k] - initial[k]) for k in moved}
    cr = {k: _norm(ref["params"][k] - initial[k]) for k in moved}
    change_gap, change_leaf = _worst(cp, cr, moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_left_out": sorted(set(gr) - set(moved))}


def image_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    return max(_norm(a - b) / max(_norm(b), 1e-30) for a, b in zip(prog, ref))


def verdict(numbers: dict, limits: Dict[str, float]) -> tuple:
    """(correct, [(name, number, limit)]): correct when every number the cell
    limits is finite and at most its limit."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
