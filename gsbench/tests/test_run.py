"""Whole runs of each cell on the CPU at a size a test run holds: the
program's sound runs are correct, the control (the reference one precision
lower in the program's place) is not, and neither is a run whose timed path
is broken underneath.  The run's look for a card is skipped (the harness is
driven with ``device="cpu"``, where the program runs its plain versions)."""

import pytest
import torch

from gsbench import check, harness
from gsbench.reference import render as R

TINY = {"gaussians": 300, "capacity": 1024, "instance_capacity": 1 << 15, "width": 48,
        "height": 32, "views": 4, "traced_frames": 2, "checked_frames": 2,
        "warmup_frames": 1}
TRAIN = ["offset-train-dnerf", "se3-train-dnerf", "offset-train-large"]
RENDER = ["offset-render-1080p"]


def run(cell, seed=7, trace=False, **kw):
    return harness.run(cell, seed, 0.2, trace, "cpu", overrides=TINY, log=lambda *a: None, **kw)


@pytest.mark.parametrize("cell", TRAIN + RENDER)
def test_sound_run_is_correct(cell):
    out = run(cell, seed=2 ** 31 + 11)
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert not out["forbidden"]
    assert list(out)[-1] == "checked"
    assert set(out["checked"]) == set(harness.load("cells", cell)["limits"])


@pytest.mark.parametrize("cell", TRAIN + RENDER)
def test_control_is_not_correct(cell):
    c = harness.load("cells", cell)
    config = harness.load("configs", c["config"])
    mix = {**harness.load("traffic", c["traffic"]), **TINY}
    for seed in (1, 2, 3):
        sess = harness.traffic(mix["kind"]).Session(config, mix, seed, "cpu")
        sess.setup()
        sess.window(0.1)
        sess.release()
        ok, rows = check.verdict(sess.numbers(R.control(config)), c["limits"])
        assert not ok, rows


def _unchanged_state(monkeypatch):
    from gs_deformable_tpu_torch import training

    monkeypatch.setattr(training, "adam_step", lambda params, grads, opt, lrs, **kw:
                        (params, opt))


def _half_batch(monkeypatch):
    from gs_deformable_tpu_torch import training

    l1, ssim = training.l1_loss, training.ssim
    monkeypatch.setattr(training, "l1_loss", lambda a, b: l1(a[:, ::2], b[:, ::2]))
    monkeypatch.setattr(training, "ssim", lambda a, b: ssim(a[:, ::2], b[:, ::2]))


def _answer_altered(monkeypatch):
    from gs_deformable_tpu_torch.ops import rasterize

    fn = rasterize.rasterize_arrays

    def altered(*a, **k):
        image, *rest = fn(*a, **k)
        image = image.clone()
        image[:, :16, :16] += 0.5  # one tile's colour
        return (image, *rest)

    monkeypatch.setattr(rasterize, "rasterize_arrays", altered)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in
                                        (_unchanged_state, _half_batch, _answer_altered)]
                         + [(c, _answer_altered) for c in RENDER])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checked"]


def test_traced_run_reads_its_metrics_or_leaves_them_out():
    out = run("offset-train-dnerf", trace=True)
    assert out["correct"]
    assert "train_ms_per_step" not in out["metrics"]
    # no device on the CPU: only what needs none is read
    assert set(out["metrics"]) == {"mfu.train"}
    assert out["metrics"]["mfu.train"]["value"] > 0
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    torch.manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN + RENDER)
def test_control_at_the_cell_s_own_size(cell):
    """On the card: at the cell's own sizes the program passes its limits
    and the control does not (``calibrate.py`` reads a dozen seeds so)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load("cells", cell)
    config = harness.load("configs", c["config"])
    mix = harness.load("traffic", c["traffic"])
    harness.build_kernels("cuda")
    sess = harness.traffic(mix["kind"]).Session(config, mix, 2 ** 31 + 5, "cuda")
    sess.setup()
    sess.window(2.0)
    sess.release()
    assert check.verdict(sess.numbers(R.stated(config)), c["limits"])[0]
    assert not check.verdict(sess.numbers(R.control(config)), c["limits"])[0]
