"""The port's spans and counters (``gs_deformable_tpu_torch.tracing``) on the CPU.

A tiny scene (``N`` alive gaussians in capacity ``CAP``, a 48 x 32 view)
runs one chunk of two training steps and one eval frame:

- off (no profiler): no ``record_function`` is entered and no total moves,
  and every output is bitwise that of the same run under the profiler;
- on (a CPU ``torch.profiler``): the spans nest as the layers do, and the
  counters equal what the scene's shapes and alive mask give (the tile
  cull's, what the cull received and returned); a second
  session starts from zero, and two with no call between them merge;
- mirror: under the benchmark's outside ranges (``gsbench.harness.ranged``)
  and the program's spans at once, each span encloses the same host ops and
  autograd sequence numbers as the range it mirrors, so the device time the
  trace attributes to both is the same.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gs_deformable_tpu_torch import config, renderer, tracing, training
from gs_deformable_tpu_torch.models.gaussians import init_from_points
from gs_deformable_tpu_torch.ops.binning import aligned_capacity
from gsbench import harness, ranges, scene
from gsbench.trace import Trace

N, CAP, W, H = 150, 256, 48, 32
IT0 = 20  # past the nets' warm-up: they run
STEPS = 2
MODES = {"offset": ("offset", False, 1), "se3_gate": ("se3", True, 2)}  # mode, gate, nets


def make(mode: str, gate: bool, warmup: int = 10):
    cfg = config.Config(
        model=config.ModelConfig(sh_degree=1, deform_mode=mode, use_opacity_mask=gate),
        deform=config.DeformConfig(depth=2, width=32, skips=(0,), multires_xyz=2,
                                   multires_time=2, warmup_iters=warmup, sh_coeffs=4),
        raster=config.RasterizeConfig(instance_capacity=1 << 12, sort_mode="exact"))
    rng = np.random.default_rng(3)
    state = init_from_points(rng.uniform(-1.3, 1.3, (N, 3)), rng.uniform(0, 1, (N, 3)), CAP,
                             1, device="cpu")
    net, latent = training.init_nets(cfg, seed=5, device="cpu")
    ts = training.init_train_state(state, net, 0, latent if gate else None)
    views = [scene.view_arrays(scene.arc_c2w(a, 0.0), a + 0.5, W, H) for a in (-0.2, 0.1)]
    cams = [renderer.CameraArrays.from_numpy(v.world_view, v.full_proj, v.center, v.time,
                                             device="cpu") for v in views]
    gts = torch.rand((STEPS, 3, H, W), generator=torch.Generator().manual_seed(1))
    v = views[0]
    kw = dict(width=W, height=H, tan_fovx=v.tan_fovx, tan_fovy=v.tan_fovy,
              active_sh_degree=1, device="cpu")
    return cfg, ts, cams, gts, kw


def run(mode: str, gate: bool):
    """One chunk of ``STEPS`` steps and one eval frame: (image, losses,
    the state's leaves, the eval frame's camera, the steps' aligned rows)."""
    cfg, ts, cams, gts, kw = make(mode, gate)
    step = training.make_train_step(cfg, spatial_lr_scale=1.0, **kw)
    needed = []

    def recorded(*a):
        ts, m = step(*a)
        needed.append(int(m["required_aligned"]))
        return ts, m

    kp = aligned_capacity(cfg.raster.instance_capacity, grid(), cfg.raster.chunk)
    chunk = training.chunk_loop(recorded, kp=kp, instance_capacity=cfg.raster.instance_capacity,
                                chunk_max=STEPS, device="cpu")
    stacked = renderer.CameraArrays(*(torch.stack(xs) for xs in zip(*cams)))
    bg = torch.zeros(3)
    losses = []
    ts, _ = chunk(ts, stacked, gts, bg, IT0, STEPS, losses)
    frame = training.make_eval_render(cfg, **kw)
    img = frame(ts.gaussians, ts.net, cams[1], bg, IT0 + STEPS, ts.latent)
    leaves = {k: v.detach().clone() for k, v in ts.gaussians.params().items()}
    if ts.net is not None:
        leaves.update({f"net.{i}": p.detach().clone() for i, p in enumerate(ts.net.parameters())})
    return img, [float(x) for x in losses], leaves, (cfg, ts, cams[1], kw), needed


def grid() -> int:
    return -(-W // 16) * -(-H // 16)


def frame_needed(cfg, ts, cam, kw) -> int:
    """The eval frame's aligned rows, read with tracing off."""
    kw = {k: v for k, v in kw.items() if k != "device"}
    with torch.no_grad():
        out, _ = renderer.render(ts.gaussians, ts.net, cam, iteration=IT0 + STEPS,
                                 bg=torch.zeros(3), cfg=cfg, latent=ts.latent, device="cpu",
                                 **kw)
    return int(out.required_aligned)


def traced(fn, path=None, fresh=True):
    """``fn()`` under a CPU profiler in a session of its own (unless not
    ``fresh``); its chrome trace's events when ``path`` is given."""
    if fresh:
        assert not tracing.enabled()  # a call with tracing off ends the last session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    if path is None:
        return out, None
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, Trace(json.load(f)["traceEvents"])


@pytest.mark.parametrize("case", sorted(MODES))
def test_off_records_nothing_and_computes_what_on_does(case, monkeypatch):
    mode, gate, _ = MODES[case]
    on = traced(lambda: run(mode, gate))[0]
    before = (tracing.counters(), tracing.spans())
    entered = []

    class Counting(contextlib.nullcontext):
        def __init__(self, name, *a):
            entered.append(name)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    off = run(mode, gate)
    assert not entered
    assert (tracing.counters(), tracing.spans()) == before
    assert torch.equal(on[0], off[0])
    assert on[1] == off[1] and len(on[1]) == STEPS
    assert on[2].keys() == off[2].keys()
    for k in on[2]:
        assert torch.equal(on[2][k], off[2][k]), k


# The innermost enclosing span of each span, in a chunk of steps then a frame.
PARENT = {"gs.chunk": None, "gs.step": "gs.chunk", "gs.backward": "gs.step",
          "gs.loss": "gs.step", "gs.optimizer": "gs.step", "gs.frame": None}
IN_RENDER = ("gs.deform", "gs.screen_space", "gs.binning", "gs.composite")


@pytest.mark.parametrize("case", sorted(MODES))
def test_on_spans_nest_and_counters_count(case, tmp_path):
    mode, gate, nets = MODES[case]
    (img, _, _, frame_args, needed), tr = traced(lambda: run(mode, gate),
                                                 str(tmp_path / "t.json"))
    seen = {}
    for i, e in enumerate(tr.cpu):
        if e["name"].startswith("gs."):
            up = next((tr.cpu[j]["name"] for j in list(tr._chain(i))[1:]
                       if tr.cpu[j]["name"].startswith("gs.")), None)
            seen.setdefault(e["name"], set()).add(up)
    for name, parent in PARENT.items():
        assert seen[name] == {parent}, (name, seen[name])
    for name in IN_RENDER:
        assert seen[name] == {"gs.step", "gs.frame"}, (name, seen[name])

    sp = tracing.spans()
    calls = {k: v["calls"] for k, v in sp.items()}
    assert calls == {"gs.chunk": 1, "gs.step": STEPS, "gs.backward": STEPS,
                     "gs.loss": 2 * STEPS, "gs.optimizer": 2 * STEPS, "gs.frame": 1,
                     "gs.deform": nets * (STEPS + 1), "gs.screen_space": STEPS + 1,
                     "gs.binning": STEPS + 1, "gs.composite": STEPS + 1}
    for v in sp.values():
        assert 0 < v["self_s"] <= v["host_s"]
    # the chunk's one child span is the step: its self time is the rest
    chunk, steps = sp["gs.chunk"], sp["gs.step"]
    assert abs(chunk["self_s"] - (chunk["host_s"] - steps["host_s"])) < 1e-9

    kp = aligned_capacity(1 << 12, grid(), 128)
    needed.append(frame_needed(*frame_args))
    c = tracing.counters()
    cull = {k: c.pop(k) for k in ("cull.rows", "cull.masked_rows")}
    assert c == {
        "deform.rows": nets * CAP * (STEPS + 1), "deform.live_rows": nets * N * (STEPS + 1),
        "binning.kp_rows": kp * (STEPS + 1), "binning.needed_rows": sum(needed)}
    assert 0 < sum(needed) < kp * (STEPS + 1)
    # rows touching a tile are alive rows; the exact cull's are some of them
    assert 0 < cull["cull.masked_rows"] <= cull["cull.rows"] <= N * (STEPS + 1)


def test_cull_counters_on_a_traced_frame(monkeypatch):
    """``cull.rows`` and ``cull.masked_rows`` of one traced frame: the rows
    that touched a tile on the cull's entry and the rows whose mask code
    has bit 16, read from what the plain loop received and returned."""
    from gs_deformable_tpu_torch.ops import projection

    cfg, ts, cams, _, kw = make("offset", False)
    frame = training.make_eval_render(cfg, **kw)
    seen = []
    loop = projection.tile_ellipse_mask_plain

    def recorded(*a, **k):
        out = loop(*a, **k)
        seen.append((a[4].clone(), out[0].clone()))
        return out

    monkeypatch.setattr(projection, "tile_ellipse_mask_plain", recorded)
    frame(ts.gaussians, ts.net, cams[0], torch.zeros(3), IT0, None)  # off: ends a session
    traced(lambda: frame(ts.gaussians, ts.net, cams[0], torch.zeros(3), IT0, None))
    (tt, code), = seen[1:]
    rows, masked = int((tt > 0).sum()), int(((code >> 16) & 1).sum())
    assert 0 < masked <= rows <= N
    c = tracing.counters()
    assert (c["cull.rows"], c["cull.masked_rows"]) == (rows, masked)


def test_sessions_start_from_zero_unless_nothing_ran_between():
    cfg, ts, cams, _, kw = make("offset", False)
    frame = training.make_eval_render(cfg, **kw)

    def one():
        return frame(ts.gaussians, ts.net, cams[0], torch.zeros(3), IT0, None)

    traced(lambda: (one(), one()))
    assert tracing.spans()["gs.frame"]["calls"] == 2
    one()  # a call with tracing off ends the session
    traced(one, fresh=False)
    assert tracing.spans()["gs.frame"]["calls"] == 1
    assert tracing.counters()["deform.rows"] == CAP
    traced(one, fresh=False)  # no call between the two sessions: they merge
    assert tracing.spans()["gs.frame"]["calls"] == 2
    assert tracing.counters()["deform.rows"] == 2 * CAP


def test_the_nets_warm_up_counts_no_rows():
    cfg, ts, cams, _, kw = make("se3", True, warmup=IT0 + 1)
    frame = training.make_eval_render(cfg, **kw)
    traced(lambda: frame(ts.gaussians, ts.net, cams[0], torch.zeros(3), IT0, ts.latent))
    assert tracing.spans()["gs.deform"]["calls"] == 2
    assert "deform.rows" not in tracing.counters()
    assert tracing.counters()["binning.kp_rows"] == aligned_capacity(1 << 12, grid(), 128)


def test_counts_add_on_the_tensor_s_device_and_keep_no_reference():
    def counted():
        x = torch.tensor(7, dtype=torch.int32)
        tracing.count("a", x)
        tracing.count("a", torch.tensor(5))
        tracing.count("b", 3)
        tracing.count("b", 4)
        for i in range(20):  # more names than the accumulator's first size
            tracing.count(f"c{i}", torch.tensor(i))
        return x

    tracing.count("a", 1)  # off: nothing
    x = traced(counted)[0]
    x += 100  # the total holds the value added, not the tensor
    c = tracing.counters()
    assert c["a"] == 12 and c["b"] == 7
    assert [c[f"c{i}"] for i in range(20)] == list(range(20))


def test_a_mask_is_summed_once_until_it_changes(monkeypatch):
    mask = torch.zeros(10, dtype=torch.bool)
    mask[:3] = True
    sums = []
    real_sum = torch.Tensor.sum

    def counted_sum(t, *a, **k):
        sums.append(t.shape)
        return real_sum(t, *a, **k)

    def masks():
        monkeypatch.setattr(torch.Tensor, "sum", counted_sum)
        tracing.count_set("m", mask, 2)
        tracing.count_set("m", mask)  # the same mask: no new sum
        mask[3] = True  # changed in place: summed again
        tracing.count_set("m", mask)
        other = mask.clone()
        tracing.count_set("m", other, 3)
        monkeypatch.undo()

    traced(masks)
    assert tracing.counters()["m"] == 2 * 3 + 3 + 4 + 3 * 4
    assert len(sums) == 3


# The program's spans and the benchmark's ranges they mirror.
MIRRORS = {"gs.deform": ranges.DEFORMATION, "gs.screen_space": ranges.SCREEN_SPACE,
           "gs.binning": ranges.BINNING, "gs.composite": ranges.COMPOSITE,
           ("gs.loss", "gs.optimizer"): ranges.LOSS_OPTIMIZER}


def _inside(tr, names):
    """The host ops (by index) inside any range of ``names``, the ranges
    themselves left out, and the autograd sequence numbers they took."""
    ops, seqs = set(), set()
    for i, e in enumerate(tr.cpu):
        if e["name"].startswith(("gs.", "gsbench.")):
            continue
        if any(tr.cpu[j]["name"] in names for j in tr._chain(i)):
            ops.add(i)
            n = e.get("args", {}).get("Sequence number")
            if n is not None:
                seqs.add(n)
    return ops, seqs


@pytest.mark.parametrize("case", sorted(MODES))
def test_spans_mirror_the_benchmark_s_ranges(case, tmp_path):
    mode, gate, _ = MODES[case]
    wrapped = {}
    for rng in MIRRORS.values():
        wrapped.update(rng)
    with harness.ranged(wrapped):
        _, tr = traced(lambda: run(mode, gate), str(tmp_path / "t.json"))
    for span, rng in MIRRORS.items():
        ops, seqs = _inside(tr, set(span) if isinstance(span, tuple) else {span})
        theirs = _inside(tr, set(rng))
        assert ops and ops == theirs[0], span
        assert seqs == theirs[1], span
    os.remove(tmp_path / "t.json")

