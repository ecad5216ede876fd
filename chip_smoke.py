#!/usr/bin/env python3
"""Drive the PyTorch port (gs_deformable_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
3. the render path at full width: the bench.py scene recipe (seed 0, 100k
   gaussians in capacity 131,072, SH degree 3, the 8x256 offset net from a
   seeded numpy init, bf16 tier) rendered at 1920x1080 for 6 frames at
   different times, past the warmup.  Launch counters are zeroed just before
   and read just after; each frame must launch the composite once, the
   prefix fill twice and the place once;
4. each kernel against its plain PyTorch version on the card at the shapes
   of that path (ordered fill: bitwise; composite, on the real binning of
   the phase-3 scene: rgb rtol 1e-4 / atol 2e-5, final_T atol 2e-6,
   n_contrib exact), with median times from CUDA events (L2 flushed before
   each launch), the plain version's time, the library time where one
   PyTorch call computes the same function, and the least time the card
   could take (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s);
5. a reduced scene (640x360, 5k gaussians, fp32 MLP tier) rendered on the
   card through the kernels and on the CPU through the plain versions:
   image rtol 1e-4 / atol 2e-5, final_T rtol 1e-4 / atol 2e-6, except at
   knife-edge pixels.  The card's expf/sinf and matmul sums round an ulp or
   two apart from the CPU's, so a splat whose alpha sits on the 1/255
   threshold can blend on one device and not the other: at most 0.1% of
   pixels may differ, each by at most what one such splat moves it (2/255
   in rgb, 1/255 in T).  Then the card's own screen-space arrays go through
   binning and composite on the card (kernels) and on the CPU (plain
   versions), held to the phase-4 bars with no allowance: n_contrib and the
   binning's counts exact.

With ``--profile`` it also traces two frames with torch.profiler and prints
the device time by kernel name (the breakdown of PERF.md section 5).

Prints a JSON line of kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The full record goes to chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
OPS_PER_EVALUATED_PAIR = 16  # dx, dy, power (9), exp, op*g, min, 2 tests
OPS_PER_CONTRIBUTING_PAIR = 10  # 1-alpha, T*(1-alpha), test, alpha*T, 3 colour fmas

W, H = 1920, 1080
N_GAUSS, CAPACITY = 100_000, 131_072
INSTANCE_CAPACITY, ALIGNED_SLACK = 576 * 1024, 640 * 1024  # bench.py:64
FRAMES = 6
ITERATION = 10_000
PROFILE = "--profile" in sys.argv[1:]


def log(*a):
    print(*a, flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def scene(torch, n, cap, seed=0, device="cuda"):
    """bench.py:90-106: uniform cloud in front of the camera, ~few-px splats."""
    from gs_deformable_tpu_torch.models.gaussians import GaussianState
    from gs_deformable_tpu_torch.ops.sh import C0

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(2.5, 12, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    scal = np.log(0.01 * rng.uniform(0.5, 2.0, (n, 3))).astype(np.float32)

    def pad(a):
        return np.pad(a, [(0, cap - n)] + [(0, 0)] * (a.ndim - 1))

    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    arrays = {
        "xyz": pad(pts), "f_dc": pad(((cols - 0.5) / C0)[:, None, :]),
        "f_rest": np.zeros((cap, 15, 3), np.float32),
        "opacity": pad(np.full((n, 1), np.log(0.1 / 0.9), np.float32)),
        "scaling": pad(scal), "rotation": rot, "alive": pad(np.ones(n, bool)),
    }
    return GaussianState.from_numpy(arrays, device=device)


def camera(width, height, time_, device, fov=1.0):
    from gs_deformable_tpu_torch.ops import transforms as tf
    from gs_deformable_tpu_torch.renderer import CameraArrays

    fovy = 2 * np.arctan(np.tan(fov / 2) * height / width)
    view = np.eye(4, dtype=np.float32)
    cam = CameraArrays.from_numpy(view, view @ tf.projection_matrix(0.01, 100.0, fov, fovy),
                                  np.zeros(3, np.float32), time_, device=device)
    return cam, float(np.tan(fov / 2)), float(np.tan(fovy / 2))


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB

    def ms(self, fn, reps, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in times]))


def bytes_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def fill_inputs(torch, rng, n, K, C, active, mean_len):
    """Sorted unique positions as binning makes them: segment starts of an
    active front prefix, clamped into (and followed by) ascending K + row
    sentinels, which drop."""
    seg = rng.integers(1, 2 * mean_len, active)
    rows = np.arange(n)
    starts = np.zeros(n, np.int64)
    starts[:active] = np.cumsum(seg) - seg
    pos = np.where(rows < active, np.minimum(starts, K + rows), K + rows).astype(np.int32)
    delta = rng.integers(-(1 << 20), 1 << 20, (n, C)).astype(np.int32)
    return torch.from_numpy(pos).cuda(), torch.from_numpy(delta).cuda()


def check_fill_prefix(torch, timer, rng, label, n, K, C, active, mean_len):
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    pos, delta = fill_inputs(torch, rng, n, K, C, active, mean_len)
    got = of.ordered_prefix_fill(pos, delta, K)
    ref = of.prefix_fill_plain(pos, delta, K)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"ordered_prefix_fill ({label}) differs from its plain version")
    ok = pos < K
    idx = pos[ok].long()[None, :].expand(C, -1).contiguous()
    src = delta[ok].t().contiguous()
    seg = torch.zeros((C, K), dtype=torch.int32, device="cuda")

    def library():
        seg.zero_()
        seg.scatter_(1, idx, src)
        return torch.cumsum(seg, dim=1)

    if not torch.equal(library().to(torch.int32), ref):
        raise AssertionError("scatter_+cumsum yardstick disagrees")
    rec = {
        "shape": label, "n": n, "K": K, "C": C,
        "ms": timer.ms(lambda: of.ordered_prefix_fill(pos, delta, K), 50),
        "plain_ms": timer.ms(lambda: of.prefix_fill_plain(pos, delta, K), 10),
        "library_ms": timer.ms(library, 50),
        "bound_ms": bytes_ms(n * 4 + n * C * 4 + C * K * 4),
        "max_abs_err": 0.0,
    }
    log(f"  ordered_prefix_fill {label}: n={n} K={K} C={C}  kernel {rec['ms']:.4f} ms  "
        f"plain {rec['plain_ms']:.4f}  scatter_+cumsum (two calls) {rec['library_ms']:.4f}  "
        f"bound {rec['bound_ms']:.4f}  bitwise equal")
    return rec


def check_place(torch, timer, rng, n, Kp, tiles, mean_count):
    """Chunk-aligned per-tile runs of positions, then Kp + row sentinels."""
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    counts = rng.integers(0, 2 * mean_count + 1, tiles)
    chunks = (counts + 127) // 128
    base = (np.cumsum(chunks) - chunks) * 128
    pos = np.concatenate([b + np.arange(c) for b, c in zip(base, counts)])[:n]
    rows = np.arange(n)
    pos = np.where(rows < pos.shape[0], np.minimum(np.pad(pos, (0, n - pos.shape[0])),
                                                   Kp + rows), Kp + rows).astype(np.int32)
    vals = rng.integers(0, CAPACITY, n).astype(np.int32)
    pos, vals = torch.from_numpy(pos).cuda(), torch.from_numpy(vals).cuda()
    got = of.ordered_place_i32(pos, vals, Kp)
    ref = of.place_plain(pos, vals, Kp)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("ordered_place_i32 differs from its plain version")
    ok = pos < Kp
    idx, src = pos[ok].long(), vals[ok]
    out = torch.zeros(Kp, dtype=torch.int32, device="cuda")

    def library():
        return out.zero_().scatter_(0, idx, src)

    rec = {
        "shape": "relayout place", "n": n, "K": Kp, "valid": int(ok.sum()),
        "ms": timer.ms(lambda: of.ordered_place_i32(pos, vals, Kp), 50),
        "plain_ms": timer.ms(lambda: of.place_plain(pos, vals, Kp), 10),
        "library_ms": timer.ms(library, 50),
        "bound_ms": bytes_ms(n * 8 + Kp * 4),
        "max_abs_err": 0.0,
    }
    log(f"  ordered_place_i32: n={n} Kp={Kp}  kernel {rec['ms']:.4f} ms  plain "
        f"{rec['plain_ms']:.4f}  scatter_ {rec['library_ms']:.4f}  bound "
        f"{rec['bound_ms']:.4f}  bitwise equal")
    return rec


def screen_arrays(torch, state, net, cam, tanx, tany, cfg, width, height):
    """The render path's screen-space arrays, the rasterizer's positional inputs:
    (means2d_pix, depths, conics, opacities, colors, rect, tiles_touched)."""
    from gs_deformable_tpu_torch import renderer
    from gs_deformable_tpu_torch.ops import rasterize

    with torch.no_grad():
        m, s, r, o, shs, _ = renderer.deformed_attributes(state, net, cam.time, ITERATION, cfg)
        ss = rasterize.screen_space(m, s, r, o, shs, viewmatrix=cam.world_view,
                                    projmatrix=cam.full_proj, campos=cam.camera_center,
                                    width=width, height=height, tan_fovx=tanx, tan_fovy=tany,
                                    sh_degree=3, alive=state.alive, cfg=cfg.raster)
    return (ss.means2d_pix, ss.pre.depths, ss.pre.conics, ss.opacities, ss.colors,
            ss.pre.rect, ss.pre.tiles_touched)


def frame_tiles(torch, state, net, cam, tanx, tany, cfg):
    """The composite's inputs on the render path: (splats_t, binning, grid_x)."""
    from gs_deformable_tpu_torch.ops import rasterize

    gx, gy = (W + 15) // 16, (H + 15) // 16
    splats_t, binning = rasterize.prepare_tiles(
        *screen_arrays(torch, state, net, cam, tanx, tany, cfg, W, H),
        grid_x=gx, grid_y=gy, cfg=cfg.raster)
    return splats_t, binning, gx


def check_composite(torch, timer, splats_t, binning, grid_x, cfg):
    from gs_deformable_tpu_torch.ops.kernels import composite as comp

    kw = dict(grid_x=grid_x, chunk=cfg.raster.chunk, alpha_max=cfg.raster.alpha_max,
              alpha_min=cfg.raster.alpha_min, eps=cfg.raster.transmittance_eps)
    args = (splats_t, binning.tile_chunk_start, binning.tile_count)
    got = comp.composite_forward(*args, **kw)
    ref, work = comp.composite_forward_plain(*args, count_work=True, **kw)
    torch.cuda.synchronize()
    rgb_err = float((got[:, 0:3] - ref[:, 0:3]).abs().max())
    t_err = float((got[:, 3] - ref[:, 3]).abs().max())
    n_bad = int((got[:, 4] != ref[:, 4]).sum())
    torch.testing.assert_close(got[:, 0:3], ref[:, 0:3], rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(got[:, 3], ref[:, 3], rtol=0, atol=2e-6)
    if n_bad:
        raise AssertionError(f"composite n_contrib differs at {n_bad} pixels")
    if not torch.equal(got[:, 5:], torch.zeros_like(got[:, 5:])):
        raise AssertionError("composite rows 5..7 must be zero")
    T = binning.tile_count.shape[0]
    inst = int(binning.tile_count.sum())
    nbytes = inst * 9 * 4 + 2 * T * 4 + T * 8 * 256 * 4
    ops = work.evaluated * OPS_PER_EVALUATED_PAIR + work.contributing * OPS_PER_CONTRIBUTING_PAIR
    b_bytes, b_ops = bytes_ms(nbytes), ops / FP32_OPS_PER_S * 1e3
    rec = {
        "shape": "1080p frame", "tiles": T, "instances": inst,
        "evaluated_pairs": work.evaluated, "contributing_pairs": work.contributing,
        "ms": timer.ms(lambda: comp.composite_forward(*args, **kw), 30),
        "plain_ms": timer.ms(lambda: comp.composite_forward_plain(*args, **kw), 2, warmup=1),
        "library_ms": None,
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "max_abs_err": max(rgb_err, t_err), "rgb_max_abs_err": rgb_err,
        "final_t_max_abs_err": t_err,
    }
    log(f"  composite_forward: T={T} instances={inst} pairs evaluated={work.evaluated} "
        f"contributing={work.contributing}  kernel {rec['ms']:.4f} ms  plain "
        f"{rec['plain_ms']:.2f} ms  bound {rec['bound_ms']:.4f} ({rec['bound_by']})  "
        f"rgb err {rgb_err:.3g}  T err {t_err:.3g}  n_contrib exact")
    return rec


def reduced_scene_check(torch):
    """Card (kernels) vs CPU (plain versions) on a 640x360, 5k-gaussian scene."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from gs_deformable_tpu_torch.renderer import render

    w, h = 640, 360
    cfg = config.Config(deform=config.DeformConfig(compute_dtype="float32"),
                        raster=config.RasterizeConfig(instance_capacity=1 << 16))
    params = init_offset_params(1, cfg.deform)
    outs = {}
    for dev in ("cuda", "cpu"):
        state = scene(torch, 5000, 8192, seed=1, device=dev)
        net = OffsetNet(params, cfg.deform, device=dev)
        cam, tanx, tany = camera(w, h, 0.25, dev)
        reset_launch_counts()
        out, _ = render(state, net, cam, iteration=ITERATION, bg=torch.zeros(3, device=dev),
                        width=w, height=h, tan_fovx=tanx, tan_fovy=tany,
                        active_sh_degree=3, cfg=cfg, device=dev)
        counts = launch_counts()
        if dev == "cpu" and any(counts.values()):
            raise AssertionError(f"CPU render launched kernels: {counts}")
        if dev == "cuda" and counts != {"composite_forward": 1, "ordered_prefix_fill": 2,
                                        "ordered_place_i32": 1}:
            raise AssertionError(f"reduced render launch counts {counts}")
        if int(out.required_instances) > cfg.raster.instance_capacity:
            raise AssertionError("reduced scene overflowed its instance capacity")
        outs[dev] = out
        if dev == "cuda":
            screen = screen_arrays(torch, state, net, cam, tanx, tany, cfg, w, h)
    g, c = outs["cuda"], outs["cpu"]
    img_err, img_off = knife_edge_close(g.image.cpu(), c.image, atol=2e-5, knife=2 / 255)
    t_err, t_off = knife_edge_close(g.final_t.cpu(), c.final_t, atol=2e-6, knife=1 / 255)
    same = same_input_raster_check(torch, screen, w, h, cfg)
    rec = {"width": w, "height": h, "gaussians": 5000,
           "image_max_abs_err": img_err, "image_elements_off_bar": img_off,
           "final_t_max_abs_err": t_err, "final_t_pixels_off_bar": t_off,
           "n_contrib_mismatch_pixels": int((g.n_contrib.cpu() != c.n_contrib).sum()),
           "required_instances": int(g.required_instances), "same_input": same}
    log(f"  reduced scene card vs CPU: image err {img_err:.3g} ({img_off} of {g.image.numel()} "
        f"off the bar)  final_T err {t_err:.3g} ({t_off} off)  n_contrib mismatches "
        f"{rec['n_contrib_mismatch_pixels']}")
    log(f"  same screen-space inputs, card kernels vs CPU plain versions: image err "
        f"{same['image_max_abs_err']:.3g}  final_T err {same['final_t_max_abs_err']:.3g}  "
        f"n_contrib and binning counts exact")
    return rec


def same_input_raster_check(torch, screen, w, h, cfg):
    """The card's screen-space arrays rasterized on the card (fill and composite
    kernels) and on the CPU (plain versions), held to the phase-4 bars with no
    knife-edge allowance: rgb rtol 1e-4 / atol 2e-5, final_T atol 2e-6,
    n_contrib and the binning's required / aligned counts exact."""
    from gs_deformable_tpu_torch.ops.rasterize import rasterize_arrays

    kw = dict(width=w, height=h, cfg=cfg.raster)
    g = rasterize_arrays(*screen, torch.zeros(3, device="cuda"), **kw)
    c = rasterize_arrays(*(a.cpu() for a in screen), torch.zeros(3), **kw)
    torch.testing.assert_close(g[0].cpu(), c[0], rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(g[1].cpu(), c[1], rtol=0, atol=2e-6)
    for i, name in ((2, "n_contrib"), (3, "required"), (4, "total_aligned")):
        if not torch.equal(g[i].cpu(), c[i]):
            raise AssertionError(f"same-input raster: {name} differs card vs CPU")
    return {"image_max_abs_err": float((g[0].cpu() - c[0]).abs().max()),
            "final_t_max_abs_err": float((g[1].cpu() - c[1]).abs().max())}


def knife_edge_close(got, ref, *, atol, knife, rtol=1e-4, max_frac=1e-3):
    """The bar everywhere but at <= max_frac of elements, each within ``knife``."""
    err = (got - ref).abs()
    off = int((err > atol + rtol * ref.abs()).sum())
    if off > max_frac * err.numel() or float(err.max()) > knife:
        raise AssertionError(f"card vs CPU: {off} elements off the bar, max error "
                             f"{float(err.max())}")
    return float(err.max()), off


def profile_frames(torch, run, state, net, cams, bg, frame_ms):
    """Device time by kernel over ``len(cams)`` frames, from torch.profiler.

    Only device-side kernel events are summed (an aten op's device time is
    its kernels'), so the busy share is kernel time over the frame's host time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in cams:
            run(state, net, c, bg, ITERATION)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append({"name": ev.key[:100], "launches_per_frame": ev.count / len(cams),
                     "device_ms_per_frame": dev_us / 1e3 / len(cams)})
    rows.sort(key=lambda r: -r["device_ms_per_frame"])
    busy = sum(r["device_ms_per_frame"] for r in rows)
    launches = sum(r["launches_per_frame"] for r in rows)
    log(f"  profile: kernels busy {busy:.3f} ms/frame ({launches:.0f} launches/frame), "
        f"{busy / frame_ms:.1%} of the {frame_ms:.3f} ms frame")
    for r in rows[:20]:
        log(f"    {r['device_ms_per_frame']:8.4f} ms  x{r['launches_per_frame']:<5.0f} "
            f"{r['name']}")
    return {"kernel_ms_per_frame": busy, "launches_per_frame": launches,
            "busy_share": busy / frame_ms, "kernels": rows}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    from gs_deformable_tpu_torch import _build, config
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.ops.binning import aligned_capacity
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from gs_deformable_tpu_torch.training import make_eval_render

    t_start = time.time()
    card = card_line()
    log("phase 1: device")
    log(card)
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")

    log("phase 2: build kernels")
    t0 = time.time()
    _build.build_all()
    build_s = time.time() - t0
    log(f"  built {list(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")

    log("phase 3: render path at 1920x1080, 100k gaussians, 8x256 bf16 offset net")
    cfg = config.Config(raster=config.RasterizeConfig(
        instance_capacity=INSTANCE_CAPACITY, chunk=128, aligned_slack=ALIGNED_SLACK))
    state = scene(torch, N_GAUSS, CAPACITY)
    net = OffsetNet(init_offset_params(0, cfg.deform), cfg.deform, device="cuda")
    Kp = aligned_capacity(INSTANCE_CAPACITY, ((W + 15) // 16) * ((H + 15) // 16), 128,
                          ALIGNED_SLACK)
    cam, tanx, tany = camera(W, H, 0.5, "cuda")
    run = make_eval_render(cfg, width=W, height=H, tan_fovx=tanx, tan_fovy=tany,
                           active_sh_degree=3)
    bg = torch.zeros(3, device="cuda")
    run(state, net, cam, bg, ITERATION)  # warm-up frame
    torch.cuda.synchronize()
    times = [0.1 + 0.15 * i for i in range(FRAMES)]
    cams = [camera(W, H, t, "cuda")[0] for t in times]
    images, frame_ms = [], []
    reset_launch_counts()
    for c in cams:
        t0 = time.perf_counter()
        images.append(run(state, net, c, bg, ITERATION))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    want = {"composite_forward": FRAMES, "ordered_prefix_fill": 2 * FRAMES,
            "ordered_place_i32": FRAMES}
    log(f"  launches over {FRAMES} frames: {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    from gs_deformable_tpu_torch.renderer import render

    reqs = []
    for c in cams[:2]:
        out, _ = render(state, net, c, iteration=ITERATION, bg=bg, width=W, height=H,
                        tan_fovx=tanx, tan_fovy=tany, active_sh_degree=3, cfg=cfg)
        reqs.append((int(out.required_instances), int(out.required_aligned)))
    for img in images:
        if img.shape != (3, H, W) or not bool(torch.isfinite(img).all()):
            raise AssertionError("frame not finite or wrong shape")
        if float(img.std()) < 1e-3:
            raise AssertionError("frame is constant")
    if all(torch.equal(images[0], im) for im in images[1:]):
        raise AssertionError("frames at different times are identical")
    for req, req_al in reqs:
        if req > INSTANCE_CAPACITY or req_al > Kp:
            raise AssertionError(f"capacity overflow: {req}/{INSTANCE_CAPACITY}, {req_al}/{Kp}")
    frame_med = float(np.median(frame_ms))
    breakdown = (profile_frames(torch, run, state, net, cams[:2], bg, frame_med)
                 if PROFILE else None)
    log(f"  frames: {[round(x, 3) for x in frame_ms]} ms; median {frame_med:.3f} ms/frame; "
        f"required instances {reqs[0][0]} / {INSTANCE_CAPACITY}, aligned {reqs[0][1]} / {Kp}")

    log("phase 4: kernels vs plain versions at the render-path shapes")
    timer = Timer(torch)
    rng = np.random.default_rng(0)
    ntiles = ((W + 15) // 16) * ((H + 15) // 16)
    per_gauss = max(1, round(reqs[0][0] / N_GAUSS))
    per_tile = max(1, round(reqs[0][0] / ntiles))
    front = check_fill_prefix(torch, timer, rng, "front fills", CAPACITY, INSTANCE_CAPACITY,
                              4, N_GAUSS, per_gauss)
    relay = check_fill_prefix(torch, timer, rng, "relayout fills", ntiles, INSTANCE_CAPACITY,
                              2, int(ntiles * 0.97), per_tile)
    place = check_place(torch, timer, rng, INSTANCE_CAPACITY, Kp, ntiles, per_tile)
    splats_t, binning, gx = frame_tiles(torch, state, net, cams[0], tanx, tany, cfg)
    comp = check_composite(torch, timer, splats_t, binning, gx, cfg)

    log("phase 5: reduced scene, card vs CPU")
    reduced = reduced_scene_check(torch)

    def total(key, recs):
        return sum(r[key] for r in recs)

    kernels = [
        {"name": "composite_forward", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/composite.py:272",
         "launches": counts["composite_forward"], "max_abs_err": comp["max_abs_err"],
         "ms": comp["ms"], "plain_ms": comp["plain_ms"], "bound_ms": comp["bound_ms"],
         "bound_by": comp["bound_by"], "library_ms": None, "calls": [comp]},
        {"name": "ordered_prefix_fill", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/ordered_fill.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/ordered_fill.py:58",
         "launches": counts["ordered_prefix_fill"], "max_abs_err": 0.0,
         "ms": total("ms", [front, relay]), "plain_ms": total("plain_ms", [front, relay]),
         "bound_ms": total("bound_ms", [front, relay]), "bound_by": "bytes",
         "library_ms": total("library_ms", [front, relay]),
         "library_call": "scatter_+cumsum (two calls)",
         "per_frame": "sum of its two calls per frame", "calls": [front, relay]},
        {"name": "ordered_place_i32", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/ordered_fill.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/ordered_fill.py:58",
         "launches": counts["ordered_place_i32"], "max_abs_err": 0.0,
         "ms": place["ms"], "plain_ms": place["plain_ms"], "bound_ms": place["bound_ms"],
         "bound_by": "bytes", "library_ms": place["library_ms"],
         "library_call": "scatter_", "calls": [place]},
    ]
    record = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "frames": FRAMES, "frame_ms": frame_ms,
        "frame_ms_median": frame_med, "required_instances": reqs[0][0],
        "required_aligned": reqs[0][1], "instance_capacity": INSTANCE_CAPACITY, "Kp": Kp,
        "reduced": reduced, "kernels": kernels, "breakdown": breakdown,
        "seconds": time.time() - t_start,
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"done in {record['seconds']:.1f} s on {card}")
    print(json.dumps({"kernels": [{k: v for k, v in kr.items() if k != "calls"}
                                  for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
