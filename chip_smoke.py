#!/usr/bin/env python3
"""Drive the PyTorch port (gs_deformable_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
   print ptxas's register and spill report and the blocks each composite
   kernel keeps resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
3. the render path at full width: the bench.py scene recipe (seed 0, 100k
   gaussians in capacity 131,072, SH degree 3, the 8x256 offset net from a
   seeded numpy init, bf16 tier) rendered at 1920x1080 for 6 frames at
   different times, past the warmup.  Launch counters are zeroed just before
   and read just after; each frame must launch the composite once, the
   prefix fill twice and the place once;
4. each kernel against its plain PyTorch version on the card at the shapes
   of that path (ordered fill: bitwise; composite, on the real binning of
   the phase-3 scene: bitwise, and the plain version bitwise the same with
   and without the warp cull), with median times from CUDA
   events (L2 flushed before each launch), the plain version's time, the
   library time where one PyTorch call computes the same function, and the
   least time the card could take (bytes over 3.35 TB/s or fp32 operations
   over 67 TFLOP/s; the composite's operations counted on the pairs its
   warp cull keeps), the frame's tile-length distribution and the plain
   version's Work (pixel and (instance, warp) pairs walked, kept by the
   cull, contributing).  For the ordered fills also: the host time to
   enqueue one wrapper call, the device kernels one call launches by name
   (torch.profiler), the PyTorch forms of the prefix fill (the fastest is
   its library time) and, as a floor, a one-element add_ timed the same way;
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

6. the train path at full width: the bench.py train workload (bench.py:63,
   229-266, 90-106; 100k gaussians in capacity 131,072, SH degree 3, the
   8x256 offset net in the bf16 tier at iteration 5000, 800x800,
   composite_mode "mixed", grad_reduce "sort", instance capacity 262,144,
   aligned slack 180,224 so Kp 442,368) through training.make_train_step:
   (a) with bench.py's zeroed learning rates (the full forward, backward and
   Adam still run) a warm-up step, then timed steps; counters zeroed just
   before and read just after; each step must launch the composite forward
   and backward once, the prefix fill twice and the place once, fit its
   capacities, and give a finite loss and finite gradients; (b) 10 steps
   with the default learning rates at a fixed camera, time and target
   (instance capacity 524,288, worst-case slack) must not overflow and must
   end with a lower loss than they start;
7. the ordered fills at the 800x800 train shapes (bitwise, time, bound,
   host time; the place at phase 6's and phase 9's Kp); the composite
   forward (bitwise) and backward kernels against their
   plain versions on the phase-6 frame's binning and a seeded upstream
   gradient: gradient rows rtol 5e-4 / atol 2e-5 x the row's max |g|
   (tests/test_rasterize.py:98), bitwise equal over two launches, the
   plain rows bitwise the same with and without the warp cull, with the
   backward's median time, the plain version's time, its Work and its
   bound (no one PyTorch call
   computes it: library "none");
8. one train step of a reduced scene (640x360, 5k gaussians, fp32 MLP tier)
   on the card and on the CPU from the same state: loss rtol 1e-4, and the
   per-group gradients (read from adam.mu) at rtol 1e-3 / atol 5e-5 x scale
   except at knife-edge elements (a pair that blends on one device and not
   the other changes its gaussian's gradient row): in each group at most
   0.1% of elements, each within GRAD_KNIFE of its leaf's scale.  Then the card's
   screen-space arrays and one seeded image-space gradient go through
   binning, composite forward/backward and the segment sum on both devices,
   held to rtol 5e-4 / atol 2e-5 x scale with no allowance;
9. the bench's train workload as bench.py:246-255 and 321-344 run it: the
   phase-6 scene with composite_mode "packed" (sub_chunk 32, aligned slack
   -1, so Kp 342,144 = 262,144 + 2,500 x 32), zeroed learning rates,
   through training.make_chunk_step with chunk_max 10: one warm-up chunk,
   then 4 timed chunks of 10 steps.  Counters zeroed just before and read
   just after: each chunk must launch the composite forward and backward
   10 times, the prefix fill 20 times and the place 10 times, count no
   overflow frame and give a finite loss and finite gradients.  Then
   chained packed steps and chained mixed steps (phase 6's configuration)
   timed in turns, packed first and mixed first alternately;
10. packed against mixed and the packed kernels against their plain
   versions: (a) the 800x800 train frame rendered packed and mixed: rgb,
   final_T and n_contrib bitwise equal (one kernel, the same instances in
   the same order; only row offsets differ); (b) one packed and one mixed
   step from the same state: loss and per-group gradients (adam.mu) at
   rtol 1e-3 / atol 5e-5 x scale with no allowance, and whether they are
   bitwise equal; (c) one 1080p frame of the phase-3 scene packed (aligned
   slack -1, Kp 850,944 = 589,824 + 8,160 x 32) bitwise equal to its mixed
   frame; (d) the composite forward and backward at the packed train
   frame's binning, where tiles open in the middle of a 128-row chunk
   (rows 5 and 6 of PERF.md's kernel table): the phase-4 and phase-7 bars,
   two launches bitwise equal, median times, plain times and bounds;
   (e) sort_mode "packed": the card's 1080p screen-space arrays binned on
   the card (kernels) and the CPU (plain versions), every Binning field
   bitwise equal, the instances whose in-tile order differs from "exact"
   counted, and one frame rendered through it (finite, not constant);
11. scene to model, at a D-NeRF scene's real size: a temporary directory
   gets 50 train and 20 test 800x800 RGBA frames with times in [0, 1] and
   transforms_{train,test}.json, the ground truths rendered by the port
   from phase 3's scene and net; ``data.scene.Scene(eval=True)`` loads it
   with the readers' default 100k random points; ``init_from_points`` at
   capacity 262,144 (train.py:413-417's rule); 20 train steps at the
   default learning rates at iterations 581-600 over 10 views twice
   (the second pass's mean loss must be lower), then at iteration 600,
   the trainer's first densification, ``make_densify_step`` and
   ``make_opacity_reset``; ``grow_capacity`` to 524,288, the step
   rebuilt, 5 more steps; ``eval_sweep`` over the 20 test views in batches
   of 10; ``save_ply`` (with the net) and ``save_checkpoint``, then
   ``load_checkpoint`` into a fresh state.  Checks: the k-NN of the cloud
   on the card, 4,096 random rows against a float64 brute force on the CPU
   (rtol 1e-4, atol 1e-6 x max|x|^2); the kernels on the inputs their
   wrappers received inside the run (``recorded_frames``), the first
   step's and the first eval view's: each ordered fill bitwise, the
   composite forward bitwise, the backward at the phase-7 bars on the
   step's own forward output and upstream gradient; ``densify_and_prune`` on the card against its CPU
   run on the same state and normals (alive, counts and moments equal,
   floats at rtol 1e-6 / atol 1e-6); the render after growth against the
   render before it (rtol 1e-4 / atol 2e-5); the reloaded state's render
   bitwise equal to the saved state's, past the warmup so the net runs;
   counters zeroed before the steps and read after the eval sweep, each
   kernel launched once per step, eval view and growth-check render (the
   backward once per step).
   Prints each stage's time, the DensifyInfo counts, alive before and
   after, and each test view's PSNR.
12. the command-line entry points on phase 11's scene: ``train.main`` in
   ``--deform_mode se3`` with ``--use_opacity_mask`` and ``--eval``, the
   default 8x256 nets, 620 iterations with warmup 300 (the SE(3) net and
   the opacity gate run from 300 on), the default densification (at 600),
   checkpoints at 610 and 620, a test report and a save at 620, the viewer
   listening on a free local port; then ``render_cli.main`` over the 70
   views and ``video.frames_to_video`` on the test renders.  Checks: (a)
   the mean loss of the last 20 iterations under that of the first 20
   after warmup, and the JAX CLI's output layout (cfg_args, cameras.json,
   input.ply, the two checkpoints, the PLY and five .npz nets); (b) the
   render CLI's own image of the first test view (its PLY at
   ``_next_pow2_from_ply``'s capacity and its five nets, recorded as it ran)
   bitwise equal to the checkpoint at 620 rendered through the same eval
   path, both past warmup, and a perturbed opacity_mask net on the render
   CLI's state changes that image; (c) the kernels on the inputs their
   wrappers received inside the runs (``recorded_frames``): the trainer's
   step at 620, the backward on its own forward output and upstream
   gradient, and the render CLI's first test view, held as phase 11 holds
   them, and the launches counted around each CLI run: forward 1, backward
   1, prefix 2 and place 1 a step, and per view; (d) a reduced se3 + gate
   step card vs CPU at phase 8's bars and allowance; (e) each
   instance-capacity growth the trainer made (from 2^19 on overflow),
   printed.  Prints each stage's time: scene load, init, ms/step in warmup
   and after, densify, test report, save, checkpoint, the render CLI's time
   per view (scene load and PNG encodes included) and the video; and the
   SE(3) net's and gate's share of a step's device time, from the
   torch.profiler trace that the trainer's ``--profile_dir`` writes of one
   step past warmup (``se3_share_of_step``).

13. the native COLMAP reader: a binary COLMAP model at a Mip-NeRF 360
   scene's size (200 images of 5,000 observations, 180,000 points3D with
   2-9-entry tracks, ~41 MB) written to a temporary directory; the port's
   library built (host compiler) and asserted available; the three binary
   readers of ``data.colmap`` must call it (no Python fallback accepted),
   and their results must equal the Python parser's bit for bit in every
   field both return (the native images reader returns no 2D tracks).
   Prints both parsers' read times.
14. the mesh on phase 11's scene (its 100k-point cloud at capacity 262,144,
   10 of its train views; the fp32 MLP tier, instance capacity 2^22,
   iterations 3001-3010, past the warmup so the net trains): (a) a 1x1
   mesh with a world of one NCCL rank (an all_reduce checks NCCL; a group
   of one rank makes no collective call), 10 sharded steps against 10
   ``training.make_train_step`` steps: step 1 at the train-step bars (loss
   rtol 1e-5, every gradient rtol 1e-3 / atol 5e-5 x scale), the 10
   losses within 1e-3; (b) two processes on the one card over gloo
   (``chip_smoke.py --mesh-child``; NCCL refuses two ranks on one card):
   the 2x1 decomposition's first step (saved for (c)), then a 1x2 mesh for
   10 steps, a sharded densify and an opacity reset, its first step held
   against the single-device step on the same interleaved state; (c) four
   processes, a 2x2 mesh, the same, its first step held against (b)'s 2x1
   step (run on the interleaved rows, so that only the bands differ). Both
   at the train-step bars, no element off. In every rank:
   the launches of its 10 steps (each kernel as a step launches it), its
   band frame of step 1 recorded inside the run (``recorded_frames``) held
   against the plain versions (fills and forward bitwise, backward at the
   phase-7 bars), the nets bitwise equal on every rank, the metrics equal,
   the data replicas' slices equal; ms/step of the 10 steps; the
   collectives' share of a step from 3 further steps in which each
   collective is timed alone, the card synchronised around it
   (``timed_collectives``); which collectives gloo takes with CUDA tensors
   as they are. (d) ``train.main --n_model 2`` under ``python -m
   torch.distributed.run --standalone --nproc_per_node 2`` (``--cli-child``)
   on the scene directory, 60 iterations, warmup 30, a densify at 50, a
   checkpoint and a save at 60: one output directory (rank 0 alone
   writes), the layout of the same run on one rank (run after it), the
   mean loss of iterations 16-30 under that of 1-15; ms/step of both.

15. the dense oracle and the quality path: (a) a seeded frame of 2,000
   gaussians at 256x256 (through the port's preprocess, 3-sigma rects,
   exact depth ties) rendered by the tile path (``ops.rasterize.
   rasterize_arrays``: binning with the ordered fills, the composite
   forward, and under autograd the backward) with the tile cull off and on,
   and by the dense oracle (``ops.rasterize_dense``, a loop over the
   gaussians with no code shared with the tile path): image rtol 1e-4 /
   atol 2e-5, final_T atol 2e-6, n_contrib exact with the cull off, the
   gradients of a seeded cotangent at rtol 5e-4 / atol 2e-5 x scale (the
   JAX bars of tests/test_rasterize.py:64-98); the oracle's time and peak
   memory; (b) the quality scene of tools/quality_r04.py:55-58 built on the
   card by ``blender_scene`` (the dense oracle draws its ground truths):
   40 train and 4 test views of 400x400, 24 animated blobs, seed 3, timed;
   (c) ``train.main`` on it with quality_r04.py's flags (``--eval
   --random_init_points 20000 --instance_capacity 1048576 --warmup_iters
   800``) to 3,100 iterations with test reports at 1,000, 2,000 and 3,100
   (26 densifies, the opacity reset at 3,000 and 100 iterations of
   recovery; the learning-rate schedules do not depend on --iterations),
   then ``render_cli.main`` on the saved model; the PSNR parser reads what
   both print.  Gate: the held-out test PSNR the trainer reports at 3,100
   at least 33.0 dB (the TPU run of QUALITY_r04.json read 34.58 there).
   The launches of the run (one forward, backward, place and two prefix
   fills a step, one forward, place and two prefix fills a report view),
   and the kernels held against their plain versions on the step after
   the reset (iteration 3,001), recorded as it ran.  Prints the PSNR
   trajectory, the final PSNR/SSIM, the gaussians after each densify,
   the instance-capacity growths, ms/step between counter drains, the
   train and eval wall times and the card's name and power limit.

16. CUDA-graph replay: each kernel captured alone into a
   ``torch.cuda.CUDAGraph`` on static input buffers, after one eager call:
   the prefix fill at phase 4's two render shapes (C = 4 over the
   capacity, C = 2 over the tiles; two graphs of each, captured one after
   the other on torch's default capture stream and replayed in turns) and
   the place at the render Kp, fed 21 seeded position sets of one length
   whose drops (negative rows and rows past K) move from set to set; the
   composite forward and backward at phase 7's 800x800 train shapes, fed
   the train frames at three times.  20 replays of each graph, new inputs
   copied in before each, and after each one eager call of the same
   kernel on the same stream: every replay and call of the fills and the
   forward bitwise its plain version, of the backward bitwise the eager
   kernel's first result and within phase 7's bar of the plain version.
   Prints the replays and eager calls checked, whether any element
   differed, and ms per replay (the captured zeroing of the prefix fill's
   status buffer included) against ms per eager call of each fill, with
   the card's name and power limit.  Then ``ops.projection.mark_visible``
   on phase 3's scene under three cameras (phase 3's, one inside the cloud,
   one turned in it): bitwise the near cull of the render path's
   preprocess (its depths > 0.2), and every gaussian it keeps visible.

17. the deformation trunk's epilogues (``ops/kernels/trunk.py``,
   ``csrc/trunk.cu``) at the main path's shapes: 1,048,576 and 262,144 rows
   (the train cells' capacities) of the 8 x 256 nets' 256 columns, written
   into a whole operand and into the last 256 columns of the skip layer's
   320-wide ``[x | 0 | h]`` operand (the backward reads its cotangent and
   mask from such slices).  ``trunk_bias_relu`` bitwise
   ``relu(y + b).to(bfloat16)``; ``trunk_relu_mask`` bitwise its plain
   version in both bf16 tiers, its column sums (the bias's cotangent)
   within fp32 summation of the float64 sums (n x 2^-24 of the sum of the
   magnitudes); median times, the plain versions' times and the least time
   at 3.35 TB/s (no one PyTorch call computes either: library "none").
   The heads' three-way bf16 split of their fp32 cotangent
   (``models.deform._split3``, plain PyTorch) at 1,048,576 x 58 into its
   64-column parts: exact, and timed.  Their launches in phases 3, 6, 9, 12
   and 15 go into the kernel record: a bf16-tier net past its warmup
   launches the forward epilogue once a hidden layer a frame or step, the
   backward one once a hidden layer a step (checked exactly in phases 3,
   5, 6, 8, 9 and 14).

With ``--profile`` it also traces two frames and two train steps with
torch.profiler and prints the device time by kernel name (the breakdowns of
PERF.md section 5).

``python3 chip_smoke.py --quality_full`` runs phases 1-2 and phase 15 (b)
and then the reference regime of tools/quality_r05.py instead of (c):
40,000 iterations, warmup 3,000, test reports at its milestones, the
render CLI, no gate (about 35 minutes on an NVIDIA H100 80GB HBM3 at
700 W); the record goes to chiprun_out/quality_full.json.

Each phase's first line shows the seconds since the start.  Prints a JSON
line of kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The full record goes to chiprun_out/chip_smoke.json.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

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
NTILES = ((W + 15) // 16) * ((H + 15) // 16)

RENDER_LAUNCHES = {"composite_forward": 1, "ordered_prefix_fill": 2, "ordered_place_i32": 1}
STEP_LAUNCHES = dict(RENDER_LAUNCHES, composite_backward=1)
PACKED_SUB = 32  # bench.py:251 takes RasterizeConfig's default sub_chunk
CHUNK_MAX, CHUNKS = 10, 4  # bench.py:321, 338
TURNS, TURN_STEPS = 4, 5  # chained packed / mixed steps, in turns
TRAIN_W = TRAIN_H = 800
# Phase 17: the trunk's rows in the train cells (capacities of 400k and 100k
# gaussians), the 8 x 256 nets' width and the skip layer's operand [x | 0 | h]
# (the encoded xyz's 63 columns padded to 64).
TRUNK_ROWS, TRUNK_WIDTH, TRUNK_SKIP = (1 << 20, 1 << 18), 256, 64
TRUNK_HEADS, TRUNK_HEAD_COLS = 58, 64
TRAIN_TILES = (TRAIN_W // 16) * (TRAIN_H // 16)
TRAIN_ICAP, TRAIN_SLACK = 256 * 1024, 176 * 1024  # bench.py:63
LEARN_ICAP = 512 * 1024
TRAIN_ITERATION = 5000  # past the 3000-iteration warmup
TRAIN_STEPS = 6  # timed, after one warm-up step
LEARN_STEPS = 10
# Backward, per contributing pair beyond the forward's 16 per evaluated
# pair: T update 2, weight 1, colour dot 5, prefix 2, dalpha 5, gg 2, the
# nine gradient terms 20.
OPS_PER_CONTRIBUTING_PAIR_BWD = 37
GRAD_FIELDS = 9  # gradient rows the backward writes: x, y, conic a/b/c, opacity, rgb
# Reduced step card vs CPU: a pair that blends on one device and not the
# other has alpha within an ulp of 1/255, and every term of its gradient
# but d_opacity carries that alpha, so one flip moves an element by a few
# 1/255 of its leaf's max |g| (up to 0.0128 seen on an H100).
GRAD_KNIFE = 0.025
# Phase 11: a D-NeRF scene at its real size (800x800 RGBA, 50 train and 20
# test frames), the readers' default 100k random points, the trainer's
# capacity rule (train.py:413-417), the steps up to the trainer's first
# densification (iteration 600: past densify_from_iter 500, a multiple of
# the interval 100, inside the 3000-iteration deformation warmup, as a run
# from scratch is there), then densify, reset, growth, eval and save.
SCENE_SIZE, SCENE_TRAIN, SCENE_TEST = 800, 50, 20
SCENE_ITER0 = 581
SCENE_STEPS, SCENE_GROWN_STEPS, SCENE_VIEWS = 20, 5, 10
EVAL_BATCH = 10
KNN_ROWS = 4096  # k-NN rows checked against the CPU
# Phase 12: the trainer CLI on phase 11's scene in se3 mode with the opacity
# gate, past a warmup short enough that the nets run in most steps and up
# to the first densification (600) and 20 steps beyond.
CLI_ITERS, CLI_WARMUP = 620, 300
# Phase 13: a binary COLMAP model at a Mip-NeRF 360 scene's size (~200
# images of ~5,000 observations, 150k-200k points3D).
COLMAP_IMAGES, COLMAP_OBS, COLMAP_POINTS = 200, 5000, 180_000
# Phase 14: the mesh on phase 11's scene, past the deformation warmup so the
# net trains (its gradients are summed over the model group); the CLI run
# cut to 60 iterations with warmup 30, a densify at 50 and a checkpoint.
MESH_VIEWS, MESH_STEPS, MESH_ITER0, MESH_ICAP = 10, 10, 3001, 1 << 22
MESH_CLOCK_STEPS = 3  # further steps of (b)/(c) with the collectives timed alone
CLI_MESH_ITERS, CLI_MESH_WARMUP = 60, 30
# Phase 15: (a) a frame for the tile path against the dense oracle, sized so
# that the oracle's forward and autograd backward take seconds and a few GiB;
# the quality drive of tools/quality_r04.py: its scene (:55-58), drawn by the
# dense oracle, and the trainer's flags (:67-78) to 3,100 iterations, past
# the opacity reset at 3,000 (the TPU run of QUALITY_r04.json read 34.58 dB
# held-out there); with --quality_full the reference regime of
# tools/quality_r05.py (40,000 iterations, warmup 3,000, milestones :44-47).
DENSE_N, DENSE_SIZE, DENSE_SEED = 2000, 256, 15
QUALITY_SIZE, QUALITY_TRAIN, QUALITY_TEST, QUALITY_BLOBS, QUALITY_SEED = 400, 40, 4, 24, 3
QUALITY_FLAGS = ("--eval", "--random_init_points", "20000", "--instance_capacity", str(1 << 20))
QUALITY_ITERS, QUALITY_WARMUP, QUALITY_TESTS = 3100, 800, (1000, 2000, 3100)
QUALITY_RESET = 3000  # OptimizationConfig.opacity_reset_interval
QUALITY_GATE = 33.0  # held-out test PSNR at QUALITY_ITERS, dB
QUALITY_FULL_ITERS, QUALITY_FULL_WARMUP = 40_000, 3000
QUALITY_FULL_TESTS = (1000, 2000, 3100, 5000, 7100, 9100, 12100, 15100, 18100, 20000, 24100,
                      27100, 30100, 33100, 36100, QUALITY_FULL_ITERS)


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


def launches_want(per_unit, units, trunk_layers=0, backward=True):
    """Each kernel's launches over ``units`` frames or steps: the
    rasterizer's ``per_unit`` (RENDER_LAUNCHES or STEP_LAUNCHES) a unit,
    and the deformation trunk's epilogues once a unit for each of the
    ``trunk_layers`` hidden layers of the nets that run in a bf16 tier,
    forward and, with ``backward``, backward."""
    want = dict.fromkeys(STEP_LAUNCHES, 0) | {k: v * units for k, v in per_unit.items()}
    want["trunk_bias_relu"] = trunk_layers * units
    want["trunk_relu_mask"] = trunk_layers * units if backward else 0
    return want


def raster_launches(counts):
    """The rasterizer's kernels' entries of ``launch_counts()``."""
    return {k: counts[k] for k in STEP_LAUNCHES}


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


def host_us(torch, fn, calls=200, batches=5):
    """Host microseconds to enqueue one call: ``calls`` calls after a warm-up,
    timed on the host clock before the one synchronise that follows them;
    the median over ``batches`` such runs (the host clock is shared)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def kernel_split(torch, fn, label, reps=50):
    """Device kernels (and memsets) of one wrapper call by name, from
    torch.profiler over ``reps`` warm calls (no L2 flush): launches per call
    and device ms per call.  None when the profiler recorded no device event."""
    for _ in range(3):
        rows = profile_calls(torch, fn, reps, host_us(torch, fn, 20) / 1e3, label)["kernels"]
        if rows:
            return rows
    log(f"  profile ({label}): the profiler recorded no device event")
    return None


def prefix_library_forms(torch, pos, delta, K):
    """PyTorch forms of zero + scatter + scan computing the prefix fill's
    (C, K) int32 result: name -> function."""
    C = delta.shape[1]
    ok = (pos >= 0) & (pos < K)
    idx = pos[ok].long()
    idx_rows = idx[None, :].expand(C, -1).contiguous()
    src_rows = delta[ok].t().contiguous()
    seg = torch.zeros((C, K), dtype=torch.int32, device="cuda")
    out = torch.empty((C, K), dtype=torch.int32, device="cuda")

    def rows_dim1():  # the first yardstick kept in the records: an int64 result
        seg.zero_()
        seg.scatter_(1, idx_rows, src_rows)
        return torch.cumsum(seg, dim=1)

    def per_channel():
        for c in range(C):
            row = seg[c]
            row.zero_()
            row.scatter_(0, idx, src_rows[c])
            torch.cumsum(row, 0, dtype=torch.int32, out=out[c])
        return out

    return {"scatter_+cumsum(dim=1) of (C, K), int64 out": rows_dim1,
            "per channel: scatter_ + cumsum(dim=0, dtype=int32, out=row)": per_channel}


def prefix_record(torch, timer, label, pos, delta, K):
    """The prefix fill vs its plain version on (pos, delta), bitwise; its
    time, bound and host cost."""
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    got = of.ordered_prefix_fill(pos, delta, K)
    ref = of.prefix_fill_plain(pos, delta, K)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"ordered_prefix_fill ({label}) differs from its plain version")

    def call():
        return of.ordered_prefix_fill(pos, delta, K)

    n, C = delta.shape
    rec = {
        "shape": label, "n": n, "K": K, "C": C,
        "ms": timer.ms(call, 50),
        "bound_ms": bytes_ms(n * 4 + n * C * 4 + C * K * 4),
        "host_us": host_us(torch, call), "max_abs_err": 0.0,
    }
    log(f"  ordered_prefix_fill {label}: n={n} K={K} C={C}  kernel {rec['ms']:.4f} ms  "
        f"bound {rec['bound_ms']:.4f}  host {rec['host_us']:.2f} us/call  bitwise equal")
    return rec, ref, call


def check_fill_prefix(torch, timer, seed, label, n, K, C, active, mean_len):
    """``prefix_record`` on seeded positions as binning makes them.  Returns
    that record and a function that adds to it the plain version's time,
    the PyTorch forms of the same function and the device kernels one call
    launches."""
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    pos, delta = fill_inputs(torch, np.random.default_rng(seed), n, K, C, active, mean_len)
    rec, ref, call = prefix_record(torch, timer, label, pos, delta, K)

    def more():
        forms = prefix_library_forms(torch, pos, delta, K)
        for name, fn in forms.items():
            if not torch.equal(fn().to(torch.int32), ref):
                raise AssertionError(f"library form {name} disagrees")
        rec["plain_ms"] = timer.ms(lambda: of.prefix_fill_plain(pos, delta, K), 10)
        rec["library_forms_ms"] = {name: timer.ms(fn, 50) for name, fn in forms.items()}
        rec["split"] = kernel_split(torch, call, f"ordered_prefix_fill {label}")
        log(f"  ordered_prefix_fill {label}: plain {rec['plain_ms']:.4f}  library "
            + "; ".join(f"{k} {v:.4f}" for k, v in rec["library_forms_ms"].items()))

    return rec, more


def place_record(torch, timer, label, pos, vals, Kp):
    """The place vs its plain version on (pos, vals), bitwise; its time,
    bound and host cost."""
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    got = of.ordered_place_i32(pos, vals, Kp)
    ref = of.place_plain(pos, vals, Kp)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"ordered_place_i32 ({label}) differs from its plain version")

    def call():
        return of.ordered_place_i32(pos, vals, Kp)

    n = pos.shape[0]
    rec = {
        "shape": label, "n": n, "K": Kp, "valid": int((pos < Kp).sum()),
        "ms": timer.ms(call, 50), "bound_ms": bytes_ms(n * 8 + Kp * 4),
        "host_us": host_us(torch, call), "max_abs_err": 0.0,
    }
    log(f"  ordered_place_i32 {label}: n={n} Kp={Kp}  kernel {rec['ms']:.4f} ms  bound "
        f"{rec['bound_ms']:.4f}  host {rec['host_us']:.2f} us/call  bitwise equal")
    return rec, call


def check_place(torch, timer, seed, n, Kp, tiles, mean_count, unit=128,
                label="relayout place"):
    """Unit-aligned per-tile runs of positions, then Kp + row sentinels; the
    same records as check_fill_prefix, the library call being scatter_."""
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2 * mean_count + 1, tiles)
    chunks = (counts + unit - 1) // unit
    base = (np.cumsum(chunks) - chunks) * unit
    pos = np.concatenate([b + np.arange(c) for b, c in zip(base, counts)])[:n]
    rows = np.arange(n)
    pos = np.where(rows < pos.shape[0], np.minimum(np.pad(pos, (0, n - pos.shape[0])),
                                                   Kp + rows), Kp + rows).astype(np.int32)
    vals = rng.integers(0, CAPACITY, n).astype(np.int32)
    pos, vals = torch.from_numpy(pos).cuda(), torch.from_numpy(vals).cuda()
    rec, call = place_record(torch, timer, label, pos, vals, Kp)

    def more():
        ok = pos < Kp
        idx, src = pos[ok].long(), vals[ok]
        out = torch.zeros(Kp, dtype=torch.int32, device="cuda")
        rec["plain_ms"] = timer.ms(lambda: of.place_plain(pos, vals, Kp), 10)
        rec["library_ms"] = timer.ms(lambda: out.zero_().scatter_(0, idx, src), 50)
        rec["split"] = kernel_split(torch, call, f"ordered_place_i32 {label}")
        log(f"  ordered_place_i32 {label}: plain {rec['plain_ms']:.4f}  "
            f"scatter_ {rec['library_ms']:.4f}")

    return rec, more


def render_fills(torch, timer, per_gauss, per_tile, Kp):
    """Phase 4's ordered-fill calls at the render-path shapes: the front fills
    (C = 4 over the gaussians), the relayout fills (C = 2 over the tiles) and
    the place, each gaussian and tile covering its mean length of positions.
    The kernels are checked and timed first, then the plain versions, the
    library forms and the profiler, so that no kernel timing follows the
    library forms' long runs."""
    (front, more_front), (relay, more_relay), (place, more_place) = (
        check_fill_prefix(torch, timer, 0, "front fills", CAPACITY, INSTANCE_CAPACITY, 4,
                          N_GAUSS, per_gauss),
        check_fill_prefix(torch, timer, 1, "relayout fills", NTILES, INSTANCE_CAPACITY, 2,
                          int(NTILES * 0.97), per_tile),
        check_place(torch, timer, 2, INSTANCE_CAPACITY, Kp, NTILES, per_tile))
    tiny = torch.zeros(1, device="cuda")
    front["launch_floor_ms"] = timer.ms(lambda: tiny.add_(1), 50)
    log(f"  launch floor (a one-element add_, timed the same way): "
        f"{front['launch_floor_ms']:.4f} ms")
    for more in (more_front, more_relay, more_place):
        more()
    return front, relay, place


def train_fills(torch, timer, per_gauss, per_tile):
    """Phase 7's ordered-fill calls at the 800x800 train shapes: the two
    prefix fills, the place at phase 6's Kp ("mixed") and at phase 9's
    ("packed", sub_chunk-aligned runs)."""
    from gs_deformable_tpu_torch import config

    kps = {p: kp_of(train_cfg(config, p), TRAIN_W, TRAIN_H) for p in (False, True)}
    return {
        "front": check_fill_prefix(torch, timer, 3, "train front fills", CAPACITY, TRAIN_ICAP,
                                   4, N_GAUSS, per_gauss)[0],
        "relay": check_fill_prefix(torch, timer, 4, "train relayout fills", TRAIN_TILES,
                                   TRAIN_ICAP, 2, int(TRAIN_TILES * 0.97), per_tile)[0],
        "place_mixed": check_place(torch, timer, 5, TRAIN_ICAP, kps[False], TRAIN_TILES,
                                   per_tile, 128, "train place, mixed")[0],
        "place_packed": check_place(torch, timer, 6, TRAIN_ICAP, kps[True], TRAIN_TILES,
                                    per_tile, PACKED_SUB, "train place, packed")[0],
    }


def fill_entries(front, relay, place, train, launches):
    """The two ordered-fill entries of the kernels line.  The prefix fill's
    library time is the fastest PyTorch form over both calls, named."""
    forms = {k: front["library_forms_ms"][k] + relay["library_forms_ms"][k]
             for k in front["library_forms_ms"]}
    best = min(forms, key=forms.get)
    src = "gs_deformable_tpu_torch/csrc/ordered_fill.cu"
    rep = "gs_deformable_tpu/ops/pallas/ordered_fill.py:58"
    prefix = {
        "name": "ordered_prefix_fill", "route": "cuda", "source": src, "replaces": rep,
        **launches["ordered_prefix_fill"], "max_abs_err": 0.0,
        "ms": front["ms"] + relay["ms"], "plain_ms": front["plain_ms"] + relay["plain_ms"],
        "bound_ms": front["bound_ms"] + relay["bound_ms"], "bound_by": "bytes",
        "library_ms": forms[best], "library_call": f"{best} (two calls)",
        "library_forms_ms": forms, "host_us": front["host_us"] + relay["host_us"],
        "launch_floor_ms": front["launch_floor_ms"],
        "train_ms": train["front"]["ms"] + train["relay"]["ms"],
        "train_bound_ms": train["front"]["bound_ms"] + train["relay"]["bound_ms"],
        "per_frame": "sum of its two calls per frame", "calls": [front, relay],
        "train_calls": [train["front"], train["relay"]]}
    placed = {
        "name": "ordered_place_i32", "route": "cuda", "source": src, "replaces": rep,
        **launches["ordered_place_i32"], "max_abs_err": 0.0,
        "ms": place["ms"], "plain_ms": place["plain_ms"], "bound_ms": place["bound_ms"],
        "bound_by": "bytes", "library_ms": place["library_ms"], "library_call": "scatter_",
        "host_us": place["host_us"],
        "train_ms": {k: train[f"place_{k}"]["ms"] for k in ("mixed", "packed")},
        "train_bound_ms": {k: train[f"place_{k}"]["bound_ms"] for k in ("mixed", "packed")},
        "calls": [place], "train_calls": [train["place_mixed"], train["place_packed"]]}
    return prefix, placed


def screen_arrays(torch, state, net, cam, tanx, tany, cfg, width, height,
                  iteration=ITERATION, latent=None):
    """The render path's screen-space arrays, the rasterizer's positional inputs:
    (means2d_pix, depths, conics, opacities, colors, rect, tiles_touched)."""
    from gs_deformable_tpu_torch import renderer
    from gs_deformable_tpu_torch.ops import rasterize

    with torch.no_grad():
        m, s, r, o, shs, _ = renderer.deformed_attributes(state, net, cam.time, iteration, cfg,
                                                          latent)
        ss = rasterize.screen_space(m, s, r, o, shs, viewmatrix=cam.world_view,
                                    projmatrix=cam.full_proj, campos=cam.camera_center,
                                    width=width, height=height, tan_fovx=tanx, tan_fovy=tany,
                                    sh_degree=3, alive=state.alive, cfg=cfg.raster)
    return (ss.means2d_pix, ss.pre.depths, ss.pre.conics, ss.opacities, ss.colors,
            ss.pre.rect, ss.pre.tiles_touched)


def frame_tiles(torch, state, net, cam, tanx, tany, cfg, width=W, height=H,
                iteration=ITERATION):
    """The composite's inputs on a frame of the main path: (splats_t, binning, grid_x)."""
    from gs_deformable_tpu_torch.ops import rasterize

    gx, gy = (width + 15) // 16, (height + 15) // 16
    with torch.no_grad():
        splats_t, binning = rasterize.prepare_tiles(
            *screen_arrays(torch, state, net, cam, tanx, tany, cfg, width, height, iteration),
            grid_x=gx, grid_y=gy, cfg=cfg.raster)
    return splats_t, binning, gx


def composite_kw(cfg):
    from gs_deformable_tpu_torch.config import layout_unit

    r = cfg.raster
    return dict(chunk=layout_unit(r), alpha_max=r.alpha_max, alpha_min=r.alpha_min,
                eps=r.transmittance_eps)


def tile_profile(torch, splats_t, binning, kw, fwd_out):
    """Tile-length distribution of one frame and the walk of its longest tile
    (pairs before each pixel stopped in the forward, before its n_contrib in
    the backward)."""
    from gs_deformable_tpu_torch.ops.kernels import composite as comp

    counts = binning.tile_count
    c = counts.double()
    t = int(torch.argmax(counts))
    only = torch.zeros_like(counts)
    only[t] = counts[t]
    _, w = comp.composite_forward_plain(splats_t, binning.tile_chunk_start, only,
                                        count_work=True, **kw)
    p50, p99 = (float(v) for v in torch.quantile(c, torch.tensor([0.5, 0.99], dtype=c.dtype,
                                                                 device=c.device)))
    walked = fwd_out[:, 4].long().sum(1)
    return {"tiles": counts.shape[0], "count_max": int(counts[t]), "count_p50": p50,
            "count_p99": p99, "count_mean": float(c.mean()), "longest_tile": t,
            "longest_forward_walked_pairs": w.evaluated,
            "longest_backward_walked_pairs": int(walked[t]),
            "backward_walked_pairs_max_tile": int(walked.max()),
            "backward_walked_pairs_mean_tile": float(walked.double().mean())}


def log_tiles(prof):
    log(f"  tile lengths over {prof['tiles']} tiles: max {prof['count_max']}  p99 "
        f"{prof['count_p99']:.1f}  p50 {prof['count_p50']:.1f}  mean {prof['count_mean']:.2f};  "
        f"longest tile walks {prof['longest_forward_walked_pairs']} pairs forward, "
        f"{prof['longest_backward_walked_pairs']} backward (backward per tile: max "
        f"{prof['backward_walked_pairs_max_tile']}, mean "
        f"{prof['backward_walked_pairs_mean_tile']:.1f})")


def log_work(what, work):
    log(f"  {what} work: pixel pairs walked {work.evaluated}, of them in warps the cull keeps "
        f"{work.evaluated_kept}, contributing {work.contributing};  (instance, warp) pairs "
        f"walked {work.warps_walked}, kept {work.warps_kept}, with a contributing lane "
        f"{work.warps_contributing}")


def check_composite(torch, timer, splats_t, binning, grid_x, cfg, label="1080p frame"):
    from gs_deformable_tpu_torch.ops.kernels import composite as comp

    kw = dict(grid_x=grid_x, **composite_kw(cfg))
    args = (splats_t, binning.tile_chunk_start, binning.tile_count)
    got = comp.composite_forward(*args, **kw)
    again = comp.composite_forward(*args, **kw)
    ref, work = comp.composite_forward_plain(*args, count_work=True, **kw)
    culled = comp.composite_forward_plain(*args, warp_cull=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("composite_forward is not bitwise repeatable")
    if not torch.equal(culled, ref):
        raise AssertionError("plain composite forward: the warp cull changed the output")
    rgb_err = float((got[:, 0:3] - ref[:, 0:3]).abs().max())
    t_err = float((got[:, 3] - ref[:, 3]).abs().max())
    n_bad = int((got[:, 4] != ref[:, 4]).sum())
    if not torch.equal(got, ref):
        raise AssertionError(f"composite_forward differs from its plain version: rgb err "
                             f"{rgb_err}, T err {t_err}, n_contrib at {n_bad} pixels")
    T = binning.tile_count.shape[0]
    inst = int(binning.tile_count.sum())
    nbytes = inst * 9 * 4 + 2 * T * 4 + T * 8 * 256 * 4
    # The redesign evaluates only the pairs of warps the cull keeps.
    ops = (work.evaluated_kept * OPS_PER_EVALUATED_PAIR
           + work.contributing * OPS_PER_CONTRIBUTING_PAIR)
    ops_all = work.evaluated * OPS_PER_EVALUATED_PAIR + work.contributing * OPS_PER_CONTRIBUTING_PAIR
    b_bytes, b_ops = bytes_ms(nbytes), ops / FP32_OPS_PER_S * 1e3
    prof = tile_profile(torch, splats_t, binning, kw, ref)
    blocks = comp.occupancy()["composite_forward"]
    rec = {
        "shape": label, "tiles": T, "Kp": splats_t.shape[1], "layout_unit": kw["chunk"],
        "instances": inst, "work": work._asdict(), "tile_profile": prof,
        "blocks_per_sm": blocks,
        "evaluated_pairs": work.evaluated, "contributing_pairs": work.contributing,
        "ms": timer.ms(lambda: comp.composite_forward(*args, **kw), 30),
        # One timed call: the plain loop is slow, and it has just run (warm).
        "plain_ms": timer.ms(lambda: comp.composite_forward_plain(*args, **kw), 1, warmup=0),
        "library_ms": None,
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "bound_ms_all_pairs": max(b_bytes, ops_all / FP32_OPS_PER_S * 1e3),
        "max_abs_err": max(rgb_err, t_err), "rgb_max_abs_err": rgb_err,
        "final_t_max_abs_err": t_err, "bitwise_equal_plain": True,
    }
    log(f"  composite_forward ({label}, layout unit {kw['chunk']}): T={T} "
        f"Kp={splats_t.shape[1]} instances={inst}  kernel {rec['ms']:.4f} ms  plain "
        f"{rec['plain_ms']:.2f} ms  bound "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}, kept pairs; all pairs "
        f"{rec['bound_ms_all_pairs']:.4f})  bitwise equal to plain (with and without the "
        f"cull), repeatable;  {blocks} blocks resident per SM")
    log_work("forward", work)
    log_tiles(prof)
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
        with torch.no_grad():
            out, _ = render(state, net, cam, iteration=ITERATION,
                            bg=torch.zeros(3, device=dev), width=w, height=h, tan_fovx=tanx,
                            tan_fovy=tany, active_sh_degree=3, cfg=cfg, device=dev)
        counts = launch_counts()
        if dev == "cpu" and any(counts.values()):
            raise AssertionError(f"CPU render launched kernels: {counts}")
        if dev == "cuda" and counts != launches_want(RENDER_LAUNCHES, 1):
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


def profile_calls(torch, fn, reps, host_ms, label):
    """Device time by kernel over ``reps`` calls of ``fn``, from torch.profiler.

    Only device-side kernel events are summed (an aten op's device time is
    its kernels'), so the busy share is kernel time over the call's host time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append({"name": ev.key[:100], "launches_per_call": ev.count / reps,
                     "device_ms_per_call": dev_us / 1e3 / reps})
    rows.sort(key=lambda r: -r["device_ms_per_call"])
    busy = sum(r["device_ms_per_call"] for r in rows)
    launches = sum(r["launches_per_call"] for r in rows)
    log(f"  profile ({label}): kernels busy {busy:.3f} ms/{label} ({launches:.0f} launches/"
        f"{label}), {busy / host_ms:.1%} of the {host_ms:.3f} ms {label}")
    for r in rows[:25]:
        log(f"    {r['device_ms_per_call']:8.4f} ms  x{r['launches_per_call']:<5.0f} "
            f"{r['name']}")
    return {"kernel_ms_per_call": busy, "launches_per_call": launches,
            "busy_share": busy / host_ms, "kernels": rows}


def zero_lr_opt(config):
    """bench.py:238-245: every learning rate 0, so the measured steps run the
    full forward, backward and Adam on a scene that does not change."""
    return config.OptimizationConfig(
        position_lr_init=0.0, position_lr_final=0.0, offset_lr_init=0.0,
        offset_lr_final=0.0, feature_lr=0.0, opacity_lr=0.0, scaling_lr=0.0,
        rotation_lr=0.0)


def kp_of(cfg, width, height):
    """Static aligned capacity of ``cfg`` at one frame size, from its layout unit."""
    from gs_deformable_tpu_torch.config import layout_unit
    from gs_deformable_tpu_torch.ops.binning import aligned_capacity

    r = cfg.raster
    tiles = ((width + r.tile_x - 1) // r.tile_x) * ((height + r.tile_y - 1) // r.tile_y)
    return aligned_capacity(r.instance_capacity, tiles, layout_unit(r), r.aligned_slack)


def train_cfg(config, packed):
    """The train workload: bench.py:246-255 trains "packed" with slack -1;
    phase 6 runs the default "mixed" schedule with bench.py's chunk-128 slack."""
    extra = (dict(composite_mode="packed", sub_chunk=PACKED_SUB, aligned_slack=-1) if packed
             else dict(aligned_slack=TRAIN_SLACK))
    return config.Config(raster=config.RasterizeConfig(instance_capacity=TRAIN_ICAP, chunk=128,
                                                       **extra), opt=zero_lr_opt(config))


def train_setup(torch, cfg, n, cap, width, height, device, seed=0):
    """(TrainState, camera, ground truth, step) for the bench scene at one size,
    the nets of ``cfg.model.deform_mode`` and the latent heads seeded by ``seed``."""
    from gs_deformable_tpu_torch.training import init_nets, init_train_state, make_train_step

    state = scene(torch, n, cap, seed=seed, device=device)
    net, latent = init_nets(cfg, seed, device)
    cam, tanx, tany = camera(width, height, 0.5, device)
    gt = np.random.default_rng(seed + 100).uniform(0, 1, (3, height, width))
    gt = torch.from_numpy(gt.astype(np.float32)).to(device)
    step = make_train_step(cfg, width=width, height=height, tan_fovx=tanx, tan_fovy=tany,
                           active_sh_degree=3, spatial_lr_scale=1.0, device=device)
    return init_train_state(state, net, latent=latent), cam, gt, step, (tanx, tany)


def mu_leaves(ts):
    """(group, tensor) pairs of the Adam first moments (0.1 g after one step)."""
    from gs_deformable_tpu_torch.models.gaussians import tree_leaves

    return [(k, t) for k, v in ts.adam.mu.items() for t in tree_leaves(v)]


def check_train_outputs(torch, ts, losses, what):
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what}: loss not finite: {losses}")
    for name, t in mu_leaves(ts):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: non-finite gradient in group {name}")
    if not any(bool(t.any()) for _, t in mu_leaves(ts)):
        raise AssertionError(f"{what}: every gradient is zero")


def train_phase(torch):
    """Phase 6 (a): timed steps of the 800x800 train workload, zeroed learning rates."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = train_cfg(config, packed=False)
    Kp = kp_of(cfg, TRAIN_W, TRAIN_H)
    ts, cam, gt, step, tans = train_setup(torch, cfg, N_GAUSS, CAPACITY, TRAIN_W, TRAIN_H,
                                          "cuda")
    bg = torch.zeros(3, device="cuda")
    ts, _ = step(ts, cam, gt, bg, TRAIN_ITERATION)  # warm-up step
    torch.cuda.synchronize()
    reset_launch_counts()
    step_ms, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        ts, m = step(ts, cam, gt, bg, TRAIN_ITERATION)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    counts = launch_counts()
    want = launches_want(STEP_LAUNCHES, TRAIN_STEPS, cfg.deform.depth)
    log(f"  launches over {TRAIN_STEPS} steps: {counts}")
    if counts != want:
        raise AssertionError(f"train launch counts {counts}, expected {want}")
    losses = [float(m["loss"]) for m in metrics]
    reqs = [(int(m["required_instances"]), int(m["required_aligned"])) for m in metrics]
    for req, req_al in reqs:
        if req > TRAIN_ICAP or req_al > Kp:
            raise AssertionError(f"train capacity overflow: {req}/{TRAIN_ICAP}, {req_al}/{Kp}")
    check_train_outputs(torch, ts, losses, "train")
    med = float(np.median(step_ms))
    log(f"  steps: {[round(x, 3) for x in step_ms]} ms; median {med:.3f} ms/step; loss "
        f"{losses[-1]:.6f}; required instances {reqs[-1][0]} / {TRAIN_ICAP}, aligned "
        f"{reqs[-1][1]} / {Kp}")
    breakdown = None
    if PROFILE:
        holder = [ts]

        def one():
            holder[0], _ = step(holder[0], cam, gt, bg, TRAIN_ITERATION)

        breakdown = profile_calls(torch, one, 2, med, "step")
    rec = {"width": TRAIN_W, "height": TRAIN_H, "steps": TRAIN_STEPS, "step_ms": step_ms,
           "step_ms_median": med, "loss": losses, "required_instances": reqs[-1][0],
           "required_aligned": reqs[-1][1], "instance_capacity": TRAIN_ICAP, "Kp": Kp,
           "launches": counts, "breakdown": breakdown}
    return rec, ts, cam, cfg, tans


def learning_phase(torch):
    """Phase 6 (b): default learning rates, fixed camera, time and target."""
    from gs_deformable_tpu_torch import config

    cfg = config.Config(raster=config.RasterizeConfig(instance_capacity=LEARN_ICAP, chunk=128))
    Kp = kp_of(cfg, TRAIN_W, TRAIN_H)
    ts, cam, gt, step, _ = train_setup(torch, cfg, N_GAUSS, CAPACITY, TRAIN_W, TRAIN_H,
                                       "cuda")
    bg = torch.zeros(3, device="cuda")
    losses, reqs = [], []
    for i in range(LEARN_STEPS):
        ts, m = step(ts, cam, gt, bg, TRAIN_ITERATION + i)
        losses.append(float(m["loss"]))
        reqs.append((int(m["required_instances"]), int(m["required_aligned"])))
    if max(r for r, _ in reqs) > LEARN_ICAP or max(r for _, r in reqs) > Kp:
        raise AssertionError(f"learning run overflowed: {reqs}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {LEARN_STEPS} steps: {losses}")
    log(f"  {LEARN_STEPS} steps at live learning rates: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; required instances {reqs[0][0]} -> {reqs[-1][0]} / {LEARN_ICAP}")
    return {"steps": LEARN_STEPS, "loss": losses, "required_instances": [r for r, _ in reqs],
            "required_aligned": [r for _, r in reqs], "instance_capacity": LEARN_ICAP, "Kp": Kp}


def assert_rows_close(torch, got, ref, what):
    """Per field (row): rtol 5e-4 / atol 2e-5 x max |ref| (tests/test_rasterize.py:98)."""
    for r in range(ref.shape[0]):
        scale = float(ref[r].abs().max()) + 1e-30
        torch.testing.assert_close(got[r], ref[r], rtol=5e-4, atol=2e-5 * scale,
                                   msg=lambda m: f"{what} field {r}: {m}")


def check_backward(torch, timer, splats_t, binning, grid_x, cfg, label="800x800 train frame",
                   upstream=None):
    """Phases 7, 10 (d), 11 and 12: the backward kernel vs its plain version
    at the train-path shapes.  ``upstream``: the (forward output, upstream
    gradient) that the wrapper received in a run; by default the forward's
    output here and a seeded normal gradient."""
    from gs_deformable_tpu_torch.ops.kernels import composite as comp

    kw = dict(grid_x=grid_x, **composite_kw(cfg))
    tables = (splats_t, binning.tile_chunk_start, binning.tile_count)
    fwd_out, work = comp.composite_forward_plain(*tables, count_work=True, **kw)
    out = comp.composite_forward(*tables, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, fwd_out):
        raise AssertionError("train frame: composite forward differs from its plain version")
    fwd_rgb_err = float((out[:, 0:3] - fwd_out[:, 0:3]).abs().max())
    fwd_t_err = float((out[:, 3] - fwd_out[:, 3]).abs().max())
    if upstream is None:
        rng = np.random.default_rng(7)
        grad = torch.zeros_like(out)
        grad[:, 0:4] = torch.from_numpy(
            rng.normal(size=(out.shape[0], 4, 256)).astype(np.float32)).cuda()
    else:
        run_out, grad = upstream
        if not torch.equal(out, run_out):
            raise AssertionError(f"{label}: the forward output the backward received differs "
                                 f"from the forward's on the same inputs")
    args = (*tables, out, grad)
    got = comp.composite_backward(*args, **kw)
    again = comp.composite_backward(*args, **kw)
    ref, bwork = comp.composite_backward_plain(*args, count_work=True, **kw)
    culled = comp.composite_backward_plain(*args, warp_cull=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("composite_backward is not bitwise repeatable")
    if not torch.equal(culled, ref):
        raise AssertionError("plain composite backward: the warp cull changed the rows")
    assert_rows_close(torch, got[:9], ref[:9], "composite_backward")
    if bool(got[9:].any()):
        raise AssertionError("composite_backward rows 9..15 must be zero")
    err = float((got - ref).abs().max())
    rel = max(float((got[r] - ref[r]).abs().max() / (ref[r].abs().max() + 1e-30))
              for r in range(9))
    T, Kp = out.shape[0], splats_t.shape[1]
    inst = int(binning.tile_count.sum())
    walked = int(out[:, 4].long().sum())  # pairs before each pixel's n_contrib
    if bwork.evaluated != walked or bwork.contributing != work.contributing:
        raise AssertionError(f"backward work {bwork} disagrees with the forward's n_contrib")
    reduced = int(ref[:GRAD_FIELDS].ne(0).any(0).sum())  # instances with a nonzero row
    # Each nonzero row sums its instance's contributing pixels (one tile's):
    # GRAD_FIELDS adds per contributing pair beyond the first.  The redesign
    # walks only the pairs of warps the cull keeps.
    tail = (work.contributing * OPS_PER_CONTRIBUTING_PAIR_BWD
            + GRAD_FIELDS * (work.contributing - reduced))
    ops = bwork.evaluated_kept * OPS_PER_EVALUATED_PAIR + tail
    ops_all = walked * OPS_PER_EVALUATED_PAIR + tail
    # The used fields of each instance read, the (16, Kp) rows written, and
    # 9 meta rows per pixel read: forward rows 0-4, upstream rows 0-3.
    nbytes = inst * GRAD_FIELDS * 4 + 16 * Kp * 4 + T * 9 * 256 * 4
    b_bytes, b_ops = bytes_ms(nbytes), ops / FP32_OPS_PER_S * 1e3
    prof = tile_profile(torch, splats_t, binning, kw, out)
    blocks = comp.occupancy()["composite_backward"]
    rec = {
        "shape": label, "tiles": T, "Kp": Kp, "blocks_per_sm": blocks, "layout_unit": kw["chunk"],
        "instances": inst, "walked_pairs": walked,
        "contributing_pairs": work.contributing, "reduced_instances": reduced,
        "bound_bytes": nbytes, "bound_ops": ops, "bound_bytes_ms": b_bytes,
        "bound_ops_ms": b_ops, "bound_ms_all_pairs": max(b_bytes, ops_all / FP32_OPS_PER_S * 1e3),
        "work": bwork._asdict(), "tile_profile": prof, "forward_rgb_max_abs_err": fwd_rgb_err,
        "forward_final_t_max_abs_err": fwd_t_err,
        "forward_ms": timer.ms(lambda: comp.composite_forward(*tables, **kw), 30),
        "ms": timer.ms(lambda: comp.composite_backward(*args, **kw), 30),
        "plain_ms": timer.ms(lambda: comp.composite_backward_plain(*args, **kw), 1, warmup=0),
        "library_ms": None,
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "max_abs_err": err, "max_err_over_row_scale": rel, "bitwise_repeatable": True,
    }
    log(f"  composite_forward at these shapes: {rec['forward_ms']:.4f} ms  bitwise equal to "
        f"its plain version")
    log(f"  composite_backward ({label}, layout unit {kw['chunk']}): T={T} Kp={Kp} "
        f"instances={inst} walked pairs="
        f"{walked} contributing={work.contributing} nonzero rows={reduced}  kernel "
        f"{rec['ms']:.4f} ms  plain "
        f"{rec['plain_ms']:.2f} ms  bound {rec['bound_ms']:.4f} ({rec['bound_by']}; bytes "
        f"{nbytes} -> {b_bytes:.4f}, ops of kept pairs {ops} -> {b_ops:.4f}; all pairs "
        f"{rec['bound_ms_all_pairs']:.4f})  max err {err:.3g} ({rel:.3g} of the row's scale)  "
        f"bitwise repeatable; plain rows bitwise equal with the cull;  "
        f"{blocks} blocks resident per SM")
    log_work("backward", bwork)
    log_tiles(prof)
    return rec


def reduced_step_check(torch, **model):
    """Phase 8 (and 12 (d) with ``model`` the se3 and gate settings): one
    reduced train step on the card (kernels) and the CPU (plain)."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    w, h = 640, 360
    cfg = config.Config(model=config.ModelConfig(**model),
                        deform=config.DeformConfig(compute_dtype="float32"),
                        raster=config.RasterizeConfig(instance_capacity=1 << 16))
    res = {}
    for dev in ("cuda", "cpu"):
        ts, cam, gt, step, (tanx, tany) = train_setup(torch, cfg, 5000, 8192, w, h, dev,
                                                      seed=1)
        if dev == "cuda":
            screen = screen_arrays(torch, ts.gaussians, ts.net, cam, tanx, tany, cfg, w, h,
                                   latent=ts.latent)
        reset_launch_counts()
        ts, m = step(ts, cam, gt, torch.zeros(3, device=dev), ITERATION)
        counts = launch_counts()
        want = launches_want(STEP_LAUNCHES, 1 if dev == "cuda" else 0)
        if counts != want:
            raise AssertionError(f"reduced step on {dev} launched {counts}, expected {want}")
        res[dev] = (float(m["loss"]), [(k, t.cpu()) for k, t in mu_leaves(ts)])
    (lg, mg), (lc, mc) = res["cuda"], res["cpu"]
    if not abs(lg - lc) <= 1e-4 * abs(lc):
        raise AssertionError(f"reduced step loss card {lg} vs CPU {lc}")
    # A knife-edge pair changes its gaussian's gradient row and, through the
    # MLP backward, moves the net's gradients a little: in each group at most
    # 0.1% of elements may leave the bar, each within GRAD_KNIFE of its
    # leaf's scale.
    groups = {}
    for (k, g), (_, c) in zip(mg, mc):
        err = (g - c).abs()
        scale = float(c.abs().max()) + 1e-30
        off, n, worst = groups.get(k, (0, 0, 0.0))
        groups[k] = (off + int((err > 1e-3 * c.abs() + 5e-5 * scale).sum()), n + err.numel(),
                     max(worst, float(err.max()) / scale))
    log(f"  reduced step card vs CPU: loss {lg:.7f} vs {lc:.7f}; gradients off the bar, by "
        "group (off / elements, max error over the leaf's scale): " + ", ".join(
            f"{k} {off}/{n} {worst:.3g}" for k, (off, n, worst) in groups.items()))
    for k, (off, n, worst) in groups.items():
        if off > 1e-3 * n or worst > GRAD_KNIFE:
            raise AssertionError(f"reduced step: group {k} has {off} of {n} gradients off the "
                                 f"bar, max error {worst:.3g} of its leaf's scale")
    off_total = sum(off for off, _, _ in groups.values())
    n_total = sum(n for _, n, _ in groups.values())
    worst = max(w for _, _, w in groups.values())
    same = same_input_grad_check(torch, screen, w, h, cfg)
    log(f"  same screen-space inputs, card vs CPU gradients: max error "
        f"{same['max_err_over_scale']:.3g} of the field's scale, no element off the bar")
    return {"width": w, "height": h, "gaussians": 5000, "loss_card": lg, "loss_cpu": lc,
            "grad_elements_off_bar": off_total, "grad_elements": n_total,
            "grad_max_err_over_scale": worst,
            "by_group": {k: {"off_bar": off, "elements": n, "max_err_over_scale": w}
                         for k, (off, n, w) in groups.items()},
            "same_input": same}


def same_input_grad_check(torch, screen, w, h, cfg):
    """The card's screen-space arrays and one seeded image-space gradient
    through binning, composite forward/backward and the segment sum, on the
    card (kernels) and the CPU (plain versions): rtol 5e-4 / atol 2e-5 x scale
    per field, with no allowance."""
    from gs_deformable_tpu_torch.ops.rasterize import rasterize_arrays

    rng = np.random.default_rng(9)
    wimg = rng.normal(size=(3, h, w)).astype(np.float32)
    wt = rng.normal(size=(h, w)).astype(np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        xs = [screen[i].detach().to(dev).requires_grad_(True) for i in (0, 2, 3, 4)]
        img, final_t, *_ = rasterize_arrays(
            xs[0], screen[1].to(dev), xs[1], xs[2], xs[3], screen[5].to(dev),
            screen[6].to(dev), torch.zeros(3, device=dev), width=w, height=h, cfg=cfg.raster)
        loss = (img * torch.from_numpy(wimg).to(dev)).sum() + (
            final_t * torch.from_numpy(wt).to(dev)).sum()
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, xs)]
    worst = 0.0
    for name, g, c in zip(("means2d", "conics", "opacities", "colors"), grads["cuda"],
                          grads["cpu"]):
        scale = float(c.abs().max()) + 1e-30
        torch.testing.assert_close(g, c, rtol=5e-4, atol=2e-5 * scale,
                                   msg=lambda m: f"same-input {name} gradient: {m}")
        worst = max(worst, float((g - c).abs().max()) / scale)
    return {"max_err_over_scale": worst}


def render_cfg(config, **raster):
    """Phase 3's render workload (bench.py:64, 150-161)."""
    kw = dict(instance_capacity=INSTANCE_CAPACITY, chunk=128, aligned_slack=ALIGNED_SLACK)
    return config.Config(raster=config.RasterizeConfig(**{**kw, **raster}))


def stacked_cameras(torch, cam):
    """bench.py:326-331: the camera repeated on a leading CHUNK_MAX axis, the
    time stepped by 1e-9 so every step's input differs."""
    from gs_deformable_tpu_torch.renderer import CameraArrays

    return CameraArrays(*(torch.stack([x] * CHUNK_MAX) for x in cam[:3]),
                        cam.time + torch.arange(CHUNK_MAX, device=cam.time.device,
                                                dtype=torch.float32) * 1e-9)


def chunk_phase(torch):
    """Phase 9: the packed train workload through make_chunk_step, then chained
    packed and mixed steps in turns."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from gs_deformable_tpu_torch.training import make_chunk_step

    cfg = train_cfg(config, packed=True)
    Kp = kp_of(cfg, TRAIN_W, TRAIN_H)
    if Kp != TRAIN_ICAP + (TRAIN_W // 16) * (TRAIN_H // 16) * PACKED_SUB:
        raise AssertionError(f"packed train Kp {Kp}")
    ts, cam, gt, pstep, (tanx, tany) = train_setup(torch, cfg, N_GAUSS, CAPACITY, TRAIN_W,
                                                   TRAIN_H, "cuda")
    run = make_chunk_step(cfg, width=TRAIN_W, height=TRAIN_H, tan_fovx=tanx, tan_fovy=tany,
                          active_sh_degree=3, spatial_lr_scale=1.0, chunk_max=CHUNK_MAX)
    cams = stacked_cameras(torch, cam)
    gts = torch.stack([gt] * CHUNK_MAX)
    bg = torch.zeros(3, device="cuda")
    ts, _ = run(ts, cams, gts, bg, 6001, CHUNK_MAX)  # warm-up chunk (bench.py:334)
    torch.cuda.synchronize()
    reset_launch_counts()
    chunk_ms, metrics = [], []
    t_all = time.perf_counter()
    for k in range(CHUNKS):
        t0 = time.perf_counter()
        ts, m = run(ts, cams, gts, bg, 6011 + CHUNK_MAX * k, CHUNK_MAX)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    total_ms = (time.perf_counter() - t_all) * 1e3
    counts = launch_counts()
    want = launches_want(STEP_LAUNCHES, CHUNK_MAX * CHUNKS, cfg.deform.depth)
    log(f"  launches over {CHUNKS} chunks of {CHUNK_MAX} steps: {counts}")
    if counts != want:
        raise AssertionError(f"chunked train launch counts {counts}, expected {want}")
    losses = [float(m["loss"]) for m in metrics]
    req, req_al = (max(int(m[k]) for m in metrics)
                   for k in ("required_instances", "required_aligned"))
    overflow = sum(int(m["overflow_frames"]) for m in metrics)
    if overflow or req > TRAIN_ICAP or req_al > Kp:
        raise AssertionError(f"chunked train overflow: {overflow} frames; {req}/{TRAIN_ICAP}, "
                             f"{req_al}/{Kp}")
    check_train_outputs(torch, ts, losses, "chunked train")
    step_ms = total_ms / (CHUNKS * CHUNK_MAX)
    log(f"  chunks: {[round(x, 3) for x in chunk_ms]} ms; {step_ms:.3f} ms/step over "
        f"{CHUNKS * CHUNK_MAX} steps; loss {losses[-1]:.6f}; required instances {req} / "
        f"{TRAIN_ICAP}, aligned {req_al} / {Kp}")

    # Chained packed and mixed steps in turns (host clock varies from call to
    # call and within one: compare the two only here, alternating).
    mcfg = train_cfg(config, packed=False)
    mts, _, _, mstep, _ = train_setup(torch, mcfg, N_GAUSS, CAPACITY, TRAIN_W, TRAIN_H, "cuda")
    mts, _ = mstep(mts, cam, gt, bg, TRAIN_ITERATION)  # warm-up step
    sides = {"packed": [pstep, ts, []], "mixed": [mstep, mts, []]}
    for turn in range(TURNS):
        for name in (("packed", "mixed") if turn % 2 == 0 else ("mixed", "packed")):
            side = sides[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TURN_STEPS):
                side[1], _ = side[0](side[1], cam, gt, bg, TRAIN_ITERATION + i)
            torch.cuda.synchronize()
            side[2].append((time.perf_counter() - t0) * 1e3 / TURN_STEPS)
    turns = {k: v[2] for k, v in sides.items()}
    log(f"  chained steps in turns ({TURN_STEPS} steps a turn, ms/step): "
        + "; ".join(f"{k} {[round(x, 3) for x in v]} median {np.median(v):.3f}"
                    for k, v in turns.items()))
    breakdown = None
    if PROFILE:
        holder = [ts]

        def one():
            holder[0], _ = pstep(holder[0], cam, gt, bg, TRAIN_ITERATION)

        breakdown = profile_calls(torch, one, 2, float(np.median(turns["packed"])),
                                  "packed step")
    rec = {"chunk_max": CHUNK_MAX, "chunks": CHUNKS, "chunk_ms": chunk_ms,
           "chunked_ms_per_step": step_ms, "loss": losses, "required_instances": req,
           "required_aligned": req_al, "overflow_frames": overflow, "Kp": Kp,
           "instance_capacity": TRAIN_ICAP, "launches": counts,
           "turns_ms_per_step": turns,
           "turns_median": {k: float(np.median(v)) for k, v in turns.items()},
           "breakdown": breakdown}
    return rec


def grads_vs(torch, got, ref):
    """Per-group max error over the leaf's scale and elements off rtol 1e-3 /
    atol 5e-5 x scale, of two mu_leaves lists."""
    groups, bitwise = {}, True
    for (k, g), (_, c) in zip(got, ref):
        g, c = g.cpu(), c.cpu()
        bitwise = bitwise and torch.equal(g, c)
        err = (g - c).abs()
        scale = float(c.abs().max()) + 1e-30
        off, worst = groups.get(k, (0, 0.0))
        groups[k] = (off + int((err > 1e-3 * c.abs() + 5e-5 * scale).sum()),
                     max(worst, float(err.max()) / scale))
    return groups, bitwise


def packed_checks(torch, timer):
    """Phase 10: packed against mixed, the packed kernels against their plain
    versions, and sort_mode "packed" card vs CPU."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.ops.binning import Binning, bin_gaussians
    from gs_deformable_tpu_torch.ops.projection import tile_ellipse_mask
    from gs_deformable_tpu_torch.renderer import render
    from gs_deformable_tpu_torch.training import make_eval_render

    rec = {}

    def frame(state, net, cam, cfg, width, height, tanx, tany, iteration):
        with torch.no_grad():
            out, _ = render(state, net, cam, iteration=iteration,
                            bg=torch.zeros(3, device="cuda"), width=width, height=height,
                            tan_fovx=tanx, tan_fovy=tany, active_sh_degree=3, cfg=cfg)
        return out

    def same_frame(a, b, what):
        for name in ("image", "final_t", "n_contrib"):
            if not torch.equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{what}: packed and mixed {name} differ")

    # (a) + (b): the 800x800 train frame and one step, packed vs mixed.
    pcfg, mcfg = train_cfg(config, packed=True), train_cfg(config, packed=False)
    steps = {}
    for name, cfg in (("packed", pcfg), ("mixed", mcfg)):
        ts, cam, gt, step, tans = train_setup(torch, cfg, N_GAUSS, CAPACITY, TRAIN_W, TRAIN_H,
                                              "cuda")
        out = frame(ts.gaussians, ts.net, cam, cfg, TRAIN_W, TRAIN_H, *tans, TRAIN_ITERATION)
        ts, m = step(ts, cam, gt, torch.zeros(3, device="cuda"), TRAIN_ITERATION)
        steps[name] = (out, float(m["loss"]), mu_leaves(ts))
        if name == "packed":
            pstate, pcam, ptans = ts, cam, tans
    (po, pl, pg), (mo, ml, mg) = steps["packed"], steps["mixed"]
    same_frame(po, mo, "800x800 train frame")
    groups, bitwise = grads_vs(torch, pg, mg)
    if not abs(pl - ml) <= 1e-3 * abs(ml) or any(off for off, _ in groups.values()):
        raise AssertionError(f"packed step vs mixed: loss {pl} vs {ml}; gradients off the bar "
                             f"by group {groups}")
    log(f"  800x800 frame packed vs mixed: rgb, final_T, n_contrib bitwise equal; one step: "
        f"loss {pl:.7f} vs {ml:.7f}, gradients within the bar in every group (max error over "
        f"scale {max(w for _, w in groups.values()):.3g}), bitwise equal: {bitwise and pl == ml}")
    rec["train_frame_bitwise"] = True
    rec["step"] = {"loss_packed": pl, "loss_mixed": ml, "bitwise": bitwise and pl == ml,
                   "max_err_over_scale": {k: w for k, (_, w) in groups.items()}}

    # (d) rows 5 and 6: the kernels at the packed train frame's binning.
    splats_t, binning, gx = frame_tiles(torch, pstate.gaussians, pstate.net, pcam, *ptans, pcfg,
                                        TRAIN_W, TRAIN_H, TRAIN_ITERATION)
    starts = binning.tile_chunk_start.long() * PACKED_SUB
    mid = int(((starts % 128 != 0) & (binning.tile_count > 0)).sum())
    if not mid:
        raise AssertionError("no tile of the packed frame opens mid-chunk")
    log(f"  packed train frame: {mid} of {binning.tile_count.shape[0]} tiles open in the "
        f"middle of a 128-row chunk; total aligned rows {int(binning.total_aligned)} of "
        f"Kp {splats_t.shape[1]}")
    rec["tiles_mid_chunk"] = mid
    rec["total_aligned"] = int(binning.total_aligned)
    fwd = check_composite(torch, timer, splats_t, binning, gx, pcfg, "800x800 packed train frame")
    bwd = check_backward(torch, timer, splats_t, binning, gx, pcfg, "800x800 packed train frame")
    del pstate, splats_t, binning

    # (c) + (e): 1080p, phase 3's scene.
    rcfg = render_cfg(config)
    state = scene(torch, N_GAUSS, CAPACITY)
    net = OffsetNet(init_offset_params(0, rcfg.deform), rcfg.deform, device="cuda")
    cam, tanx, tany = camera(W, H, 0.1, "cuda")
    kcfg = render_cfg(config, composite_mode="packed", sub_chunk=PACKED_SUB, aligned_slack=-1)
    kp = kp_of(kcfg, W, H)
    if kp != INSTANCE_CAPACITY + ((W + 15) // 16) * ((H + 15) // 16) * PACKED_SUB:
        raise AssertionError(f"packed 1080p Kp {kp}")
    mixed = frame(state, net, cam, rcfg, W, H, tanx, tany, ITERATION)
    packed = frame(state, net, cam, kcfg, W, H, tanx, tany, ITERATION)
    same_frame(packed, mixed, "1080p frame")
    if int(packed.required_instances) > INSTANCE_CAPACITY or int(packed.required_aligned) > kp:
        raise AssertionError("packed 1080p frame overflowed")
    log(f"  1080p frame packed (Kp {kp}, aligned rows {int(packed.required_aligned)}) vs mixed "
        f"(aligned rows {int(mixed.required_aligned)}): bitwise equal")
    rec["frame_1080p"] = {"Kp_packed": kp, "aligned_packed": int(packed.required_aligned),
                          "aligned_mixed": int(mixed.required_aligned), "bitwise": True}

    screen = screen_arrays(torch, state, net, cam, tanx, tany, rcfg, W, H)
    means, depths, conics, opac, _, rect, tt = screen
    gxy = dict(grid_x=(W + 15) // 16, grid_y=(H + 15) // 16)
    bins = {}
    for dev in ("cuda", "cpu"):
        a = [x.to(dev) for x in (means, conics, opac, rect, tt, depths)]
        mask, tt_c = tile_ellipse_mask(*a[:5], tile_x=16, tile_y=16)
        kw = dict(capacity=INSTANCE_CAPACITY, chunk=128, aligned_slack=ALIGNED_SLACK,
                  tile_mask=mask, **gxy)
        bins[dev] = bin_gaussians(tt_c, a[3], a[5], sort_mode="packed", **kw)
        if dev == "cuda":
            exact = bin_gaussians(tt_c, a[3], a[5], sort_mode="exact", **kw)
    for name in Binning._fields:
        if not torch.equal(getattr(bins["cuda"], name).cpu(), getattr(bins["cpu"], name)):
            raise AssertionError(f"sort_mode='packed' binning: {name} differs card vs CPU")
    pb = bins["cuda"]
    if not (torch.equal(pb.tile_count, exact.tile_count)
            and torch.equal(pb.tile_chunk_start, exact.tile_chunk_start)):
        raise AssertionError("packed and exact sorts put different instances in a tile")
    reordered = int((pb.gid != exact.gid).sum())
    img = make_eval_render(render_cfg(config, sort_mode="packed"), width=W, height=H,
                           tan_fovx=tanx, tan_fovy=tany, active_sh_degree=3)(
        state, net, cam, torch.zeros(3, device="cuda"), ITERATION)
    if img.shape != (3, H, W) or not bool(torch.isfinite(img).all()) or float(img.std()) < 1e-3:
        raise AssertionError("sort_mode='packed' frame not finite, wrong shape or constant")
    log(f"  sort_mode='packed' at 1080p: every Binning field bitwise equal card vs CPU; "
        f"{reordered} of {int(pb.num_instances)} instances in another in-tile order than "
        f"'exact' (truncated-depth ties); its frame is finite and not constant, max abs "
        f"difference to the exact-sort frame {float((img - mixed.image).abs().max()):.3g}")
    rec["packed_sort"] = {"bitwise_card_vs_cpu": True, "instances": int(pb.num_instances),
                          "reordered_vs_exact": reordered,
                          "frame_max_abs_diff_vs_exact": float((img - mixed.image).abs().max())}
    return rec, fwd, bwd


def scene_cameras(n, seed):
    """OpenGL camera-to-world matrices on an arc 10 from (0, 0, 6), looking
    at it: the phase-3 scene and the readers' [-1.3, 1.3]^3 cloud in view,
    the cloud's centre 4 away as a D-NeRF orbit's."""
    rng = np.random.default_rng(seed)
    target = np.array([0.0, 0.0, 6.0])
    out = []
    for a, h in zip(np.linspace(-0.25, 0.25, n), rng.uniform(-0.3, 0.3, n)):
        eye = target + 10.0 * np.array([np.sin(a), h / 10.0, -np.cos(a)])
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)  # x right, y down, z fwd
        c2w[:3, 3] = eye
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL, undone by the reader
        out.append(c2w)
    return out


def write_scene(torch, root):
    """Phase 11 (1): the D-NeRF layout with ground truths rendered by the port
    from phase 3's scene and net at each frame's camera and time."""
    from PIL import Image

    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.data.cameras import CameraInfo, camera_arrays, load_camera
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.training import make_eval_render

    cfg = render_cfg(config)
    state = scene(torch, N_GAUSS, CAPACITY)
    net = OffsetNet(init_offset_params(0, cfg.deform), cfg.deform, device="cuda")
    fov = 1.0
    tan = float(np.tan(fov / 2))
    run = make_eval_render(cfg, width=SCENE_SIZE, height=SCENE_SIZE, tan_fovx=tan,
                           tan_fovy=tan, active_sh_degree=3)
    bg = torch.zeros(3, device="cuda")
    for split, n, seed in (("train", SCENE_TRAIN, 1), ("test", SCENE_TEST, 2)):
        os.makedirs(os.path.join(root, split))
        frames = []
        for i, c2w in enumerate(scene_cameras(n, seed)):
            t = i / (n - 1)
            w2c = np.linalg.inv(c2w * np.array([1, -1, -1, 1]))
            info = CameraInfo(uid=i, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fov, fovy=fov,
                              image=None, image_path="", image_name="", width=SCENE_SIZE,
                              height=SCENE_SIZE, time=t)
            cam = camera_arrays(load_camera(info, i, 1), device="cuda")
            img = torch.clamp(run(state, net, cam, bg, ITERATION), 0.0, 1.0)
            rgb = (img.permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)
            rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
            Image.fromarray(rgba, "RGBA").save(os.path.join(root, split, f"r_{i:03d}.png"))
            frames.append({"file_path": f"./{split}/r_{i:03d}", "time": t,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f)


def check_densify_card_vs_cpu(torch, ts, normals, kw):
    """densify_and_prune on the card and on the CPU from the same state and
    normals: alive and the counts equal, every float at rtol 1e-6 / atol 1e-6
    (the split children's products; copies agree to the bit)."""
    from gs_deformable_tpu_torch.models.gaussians import PARAM_GROUPS, densify_and_prune

    def run(dev):
        g = ts.gaussians
        g = type(g)(**{f: getattr(g, f).to(dev) for f in g.__dataclass_fields__})
        mu = {k: ts.adam.mu[k].to(dev) for k in PARAM_GROUPS}
        nu = {k: ts.adam.nu[k].to(dev) for k in PARAM_GROUPS}
        return densify_and_prune(g, mu, nu, normals.to(dev), **kw)

    card, cpu = run("cuda"), run("cpu")
    if [int(x) for x in card[3]] != [int(x) for x in cpu[3]]:
        raise AssertionError(f"densify counts card {card[3]} vs CPU {cpu[3]}")
    worst = 0.0
    for (name, a), b in zip([(f, getattr(card[0], f)) for f in card[0].__dataclass_fields__],
                            [getattr(cpu[0], f) for f in cpu[0].__dataclass_fields__]):
        a = a.cpu()
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                raise AssertionError(f"densify {name} differs card vs CPU")
            continue
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"densify {name}: card vs CPU max diff "
                                 f"{float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    for side in (1, 2):
        for k in PARAM_GROUPS:
            if not torch.equal(card[side][k].cpu(), cpu[side][k]):
                raise AssertionError(f"densify moments of {k} differ card vs CPU")
    return {k: int(v) for k, v in cpu[3]._asdict().items()}, worst


def scene_kernel_checks(torch, timer, frame, cfg, label, backward, upstream=None):
    """Phase 11's and 12's kernels against their plain versions on one
    frame's own inputs: each recorded ordered fill bitwise, the composite
    forward bitwise and, for a train frame, the backward at the phase-7 bars
    (on the recorded ``upstream`` where given, see ``check_backward``)."""
    splats_t, binning, gx, fills = frame
    recs = []
    for i, (name, pos, x, K) in enumerate(fills):
        what = f"{label} call {i}"
        recs.append({"name": name, **(prefix_record(torch, timer, what, pos, x, K)[0]
                                      if name == "ordered_prefix_fill" else
                                      place_record(torch, timer, what, pos, x, K)[0])})
    if backward:
        comp = check_backward(torch, timer, splats_t, binning, gx, cfg, label, upstream)
    else:
        comp = check_composite(torch, timer, splats_t, binning, gx, cfg, label)
    return {"fills": recs, "composite": comp}


def knn_rows_cpu(torch, pts, rows, chunk=64):
    """Brute force in float64 on the CPU: the mean squared distance from
    each point of ``rows`` to its 3 nearest other points of ``pts``."""
    p = pts.double()
    out = []
    for s in range(0, len(rows), chunk):
        r = rows[s:s + chunk]
        d2 = ((p[r, None, :] - p[None, :, :]) ** 2).sum(-1)
        d2[torch.arange(len(r)), r] = float("inf")
        out.append(torch.topk(d2, 3, dim=1, largest=False).values.mean(-1))
    return torch.cat(out)


def scene_phase(torch, timer, root):
    """Phase 11: scene directory (written under ``root``) -> Scene ->
    init_from_points -> train steps with densify, opacity reset and growth
    -> eval sweep -> PLY, nets and checkpoint -> reload and render."""
    import random

    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.data.cameras import camera_arrays
    from gs_deformable_tpu_torch.data.scene import Scene
    from gs_deformable_tpu_torch.io import checkpoint, model_ply
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.models.gaussians import init_from_points
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from gs_deformable_tpu_torch.ops.knn import mean_sq_dist_knn3
    from gs_deformable_tpu_torch import training

    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    cfg = config.Config()
    o = cfg.opt
    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    timed("scene_write_ms", lambda: write_scene(torch, src))
    sc = timed("scene_load_ms", lambda: Scene(
        src, model, eval=True, rng=np.random.RandomState(0), shuffle_rng=random.Random(0)))
    train_cams, test_cams = sc.get_train_cameras(), sc.get_test_cameras()
    if (len(train_cams), len(test_cams)) != (SCENE_TRAIN, SCENE_TEST):
        raise AssertionError(f"scene has {len(train_cams)} / {len(test_cams)} cameras")
    pcd = sc.scene_info.point_cloud
    n = len(pcd.points)
    cap = 1 << (2 * n - 1).bit_length()  # train.py:413-417: 2n rounded up to a power of 2
    log(f"  wrote and loaded {SCENE_TRAIN} + {SCENE_TEST} frames of {SCENE_SIZE}x"
        f"{SCENE_SIZE} RGBA; {n} random initial points, capacity {cap}, extent "
        f"{sc.cameras_extent:.4f}")

    pts = torch.from_numpy(pcd.points)
    dist = timed("knn_ms", lambda: mean_sq_dist_knn3(pts.cuda()))
    rows = torch.from_numpy(np.random.default_rng(3).choice(n, KNN_ROWS, replace=False))
    t0 = time.perf_counter()
    dist_cpu = knn_rows_cpu(torch, pts, rows)
    knn_cpu_s = time.perf_counter() - t0
    atol = 1e-6 * float(pts.abs().max()) ** 2
    got = dist.cpu()[rows].double()
    knn_err = float((got - dist_cpu).abs().max())
    if not torch.allclose(got, dist_cpu, rtol=1e-4, atol=atol):
        raise AssertionError(f"k-NN card vs CPU: max diff {knn_err}")
    state = timed("init_ms", lambda: init_from_points(pcd.points, pcd.colors, cap,
                                                      cfg.model.sh_degree))
    net = OffsetNet(init_offset_params(0, cfg.deform), cfg.deform, device="cuda")
    ts = training.init_train_state(state, net, seed=0)
    log(f"  k-NN of the {n}-point cloud: card {times['knn_ms']:.1f} ms; {KNN_ROWS} random "
        f"rows against a float64 brute force on the CPU ({knn_cpu_s:.1f} s): max abs diff "
        f"{knn_err:.3g} (bar rtol 1e-4, atol {atol:.3g})")

    cam0 = train_cams[0]
    kw = dict(width=cam0.width, height=cam0.height, tan_fovx=cam0.tan_fovx,
              tan_fovy=cam0.tan_fovy, active_sh_degree=cfg.model.sh_degree)
    bg = torch.zeros(3, device="cuda")
    gts = {id(c): torch.from_numpy(c.image).cuda() for c in train_cams + test_cams}
    # The kernel inputs of the first step and of the first eval view (after
    # the steps, the two growth-check renders and the grown steps) are
    # recorded as the path runs.
    first_eval = SCENE_STEPS + 2 + SCENE_GROWN_STEPS
    reset_launch_counts()
    with recorded_frames(torch, (0, first_eval)) as rec:

        def steps(step, ts, it0, count):
            losses, ms, req = [], [], []
            for i in range(count):
                c = train_cams[i % SCENE_VIEWS]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ts, m = step(ts, camera_arrays(c), gts[id(c)], bg, it0 + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
                req.append(int(m["required_instances"]))
                if req[-1] > cfg.raster.instance_capacity:
                    raise AssertionError(f"step {it0 + i} overflowed: {req}")
            return ts, losses, ms, req

        step = training.make_train_step(cfg, spatial_lr_scale=sc.cameras_extent, **kw)
        ts, losses, step_ms, reqs = steps(step, ts, SCENE_ITER0, SCENE_STEPS)
        first, last = np.mean(losses[:SCENE_VIEWS]), np.mean(losses[SCENE_VIEWS:])
        if not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"loss did not fall: {losses}")
        it = SCENE_ITER0 + SCENE_STEPS - 1  # the last step's iteration, 600
        alive_before = int(ts.gaussians.num_alive)

        # densify as train.py:900-912 at this iteration
        dkw = dict(grad_threshold=o.densify_grad_threshold, min_opacity=o.min_opacity,
                   extent=sc.cameras_extent, percent_dense=o.percent_dense,
                   use_screen_prune=it > o.opacity_reset_interval)
        normals = torch.randn((cap, 2, 3), generator=ts.generator, device="cuda")
        cpu_info, dens_err = check_densify_card_vs_cpu(torch, ts, normals, dkw)
        densify = training.make_densify_step(cfg, extent=sc.cameras_extent,
                                             use_screen_prune=dkw["use_screen_prune"])
        ts, info = timed("densify_ms", lambda: densify(ts, o.densify_grad_threshold,
                                                       o.min_opacity, normals=normals))
        info = {k: int(v) for k, v in info.items()}
        if info != cpu_info:
            raise AssertionError(f"densify step {info} vs its CPU run {cpu_info}")
        ts = timed("reset_ms", lambda: training.make_opacity_reset(cfg)(ts))
        alive_after = int(ts.gaussians.num_alive)
        log(f"  DensifyInfo {info}; alive {alive_before} -> {alive_after}; card vs CPU "
            f"densify: alive and counts equal, floats max abs diff {dens_err:.3g}")

        view = camera_arrays(test_cams[0])
        before = training.make_eval_render(cfg, **kw)(ts.gaussians, ts.net, view, bg, it)
        ts = timed("grow_ms", lambda: training.grow_capacity(ts, 2 * cap))
        step = training.make_train_step(cfg, spatial_lr_scale=sc.cameras_extent, **kw)
        after = training.make_eval_render(cfg, **kw)(ts.gaussians, ts.net, view, bg, it)
        grow_err = float((after - before).abs().max())
        if not torch.allclose(after, before, rtol=1e-4, atol=2e-5):
            raise AssertionError(f"render after growth differs: max diff {grow_err}")
        ts, grown_losses, grown_ms, grown_reqs = steps(step, ts, it + 1, SCENE_GROWN_STEPS)
        if not np.isfinite(grown_losses).all():
            raise AssertionError(f"grown steps: loss not finite {grown_losses}")
        it += SCENE_GROWN_STEPS

        def make_batch(c):
            return training.make_eval_render_batch(
                cfg, width=c.width, height=c.height, tan_fovx=c.tan_fovx, tan_fovy=c.tan_fovy,
                active_sh_degree=cfg.model.sh_degree)

        res = timed("eval_ms", lambda: training.eval_sweep(
            make_batch, ts, test_cams, camera_arrays, lambda c: gts[id(c)], bg, it,
            batch=EVAL_BATCH))
        psnrs = [r[2] for r in res]
        if not all(np.isfinite(r[0]).all() and np.isfinite(r[1:]).all() for r in res):
            raise AssertionError("eval sweep gave non-finite images or metrics")
    counts = launch_counts()
    train_check = recorded_checks(torch, timer, rec, 0, counts, cfg, "scene train step",
                                  backward=True)
    eval_check = recorded_checks(torch, timer, rec, first_eval, counts, cfg, "scene eval view",
                                 backward=False)

    pc_dir = sc.point_cloud_dir(it)
    ck_path = os.path.join(model, "ckpt_save", f"chkpnt_{it}.npz")

    def save():
        model_ply.save_ply(pc_dir, ts.gaussians, nets={"offset_model": ts.net.param_tree()})
        checkpoint.save_checkpoint(ck_path, ts, it)

    timed("save_ms", save)
    fresh = training.grow_capacity(training.init_train_state(
        init_from_points(pcd.points, pcd.colors, cap, cfg.model.sh_degree),
        OffsetNet(init_offset_params(1, cfg.deform), cfg.deform, device="cuda"), seed=1),
        2 * cap)
    loaded, loaded_it = timed("load_ms", lambda: checkpoint.load_checkpoint(ck_path, fresh))
    render = training.make_eval_render(cfg, **kw)
    past_warmup = cfg.deform.warmup_iters  # so the reloaded net runs too
    saved_img = render(ts.gaussians, ts.net, view, bg, past_warmup)
    loaded_img = render(loaded.gaussians, loaded.net, view, bg, past_warmup)
    if loaded_it != it or not torch.equal(saved_img, loaded_img):
        raise AssertionError("the reloaded checkpoint renders another image")
    files = sorted(os.listdir(pc_dir))

    want = {"composite_forward": SCENE_STEPS + SCENE_GROWN_STEPS + SCENE_TEST + 2,
            "composite_backward": SCENE_STEPS + SCENE_GROWN_STEPS}
    want["ordered_prefix_fill"] = 2 * want["composite_forward"]
    want["ordered_place_i32"] = want["composite_forward"]
    if raster_launches(counts) != want:
        raise AssertionError(f"scene path launches {counts}, expected {want}")
    times["ms_per_step"] = float(np.median(step_ms))
    times["ms_per_step_grown"] = float(np.median(grown_ms))
    times["eval_ms_per_view"] = times["eval_ms"] / SCENE_TEST
    log(f"  losses {[round(x, 5) for x in losses]} (first {SCENE_VIEWS} views, then again: "
        f"mean {first:.5f} -> {last:.5f}); grown steps {[round(x, 5) for x in grown_losses]}")
    log(f"  required instances {reqs} then {grown_reqs} / {cfg.raster.instance_capacity}")
    log(f"  render after growth to {2 * cap} vs before: max abs diff {grow_err:.3g}")
    log(f"  eval PSNR per test view: {[round(p, 3) for p in psnrs]}")
    log(f"  saved {files} and {os.path.basename(ck_path)}; the reloaded checkpoint renders "
        f"bitwise the same image at iteration {past_warmup} (the net runs)")
    log(f"  launches over the path (steps, eval and the growth check): {counts}")
    log("  stage times (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return {"frames": [SCENE_TRAIN, SCENE_TEST], "size": SCENE_SIZE, "points": n,
            "capacity": cap, "grown_capacity": 2 * cap, "extent": sc.cameras_extent,
            "knn_cpu_s": knn_cpu_s, "knn_max_abs_err": knn_err, "times_ms": times,
            "step_ms": step_ms, "grown_step_ms": grown_ms, "losses": losses,
            "required_instances": reqs + grown_reqs,
            "grown_losses": grown_losses, "densify": info, "densify_card_vs_cpu_err": dens_err,
            "alive_before": alive_before, "alive_after": alive_after,
            "growth_render_err": grow_err, "psnr": psnrs, "launches": counts,
            "kernel_checks": {"train_step": train_check, "eval_view": eval_check}}



@contextlib.contextmanager
def recorded_frames(torch, frames):
    """Around a run of the main path: the kernel inputs of the given frames
    (0-based, in the order of the composite forward calls; a frame's
    binning makes two prefix fills and one place before it), cloned as
    each wrapper received them, and the backward of each such forward (the
    call that receives the forward's own splats).  The wrappers are swapped
    where the path looks them up, and put back after.  Yields {"calls":
    {wrapper: calls seen}, "frames": {frame: {"fills": [(name, pos, second
    argument, K)], "composite_forward": (args, kwargs) or None,
    "composite_backward": likewise}}}."""
    from gs_deformable_tpu_torch.ops import binning as binning_mod
    from gs_deformable_tpu_torch.ops.kernels import composite as comp_mod

    fills_per_frame = {"ordered_prefix_fill": 2, "ordered_place_i32": 1}
    home = {"ordered_prefix_fill": binning_mod, "ordered_place_i32": binning_mod,
            "composite_forward": comp_mod, "composite_backward": comp_mod}
    rec = {"calls": dict.fromkeys(home, 0),
           "frames": {f: {"fills": [], "composite_forward": None, "composite_backward": None,
                          "splats": None} for f in frames}}
    saved = {name: getattr(mod, name) for name, mod in home.items()}

    class Kept:
        def __init__(self, name):
            self.name = name

        # A wrapper counts its launches on its module-level name, which is
        # this object while it is swapped in: the count stays the wrapper's.
        @property
        def launches(self):
            return saved[self.name].launches

        @launches.setter
        def launches(self, n):
            saved[self.name].launches = n

        def __call__(self, *args, **kw):
            name = self.name
            k = rec["calls"][name]
            rec["calls"][name] = k + 1

            def clone():
                return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

            if name in fills_per_frame:
                f = rec["frames"].get(k // fills_per_frame[name])
                if f is not None:
                    f["fills"].append((name, *clone()))
            elif name == "composite_forward":
                f = rec["frames"].get(k)
                if f is not None:
                    f[name], f["splats"] = (clone(), dict(kw)), args[0]
            else:
                for f in rec["frames"].values():
                    if f["splats"] is not None and args[0].data_ptr() == f["splats"].data_ptr():
                        f[name], f["splats"] = (clone(), dict(kw)), None
            return saved[name](*args, **kw)

    for name, mod in home.items():
        setattr(mod, name, Kept(name))
    try:
        yield rec
    finally:
        for name, mod in home.items():
            setattr(mod, name, saved[name])


def recorded_checks(torch, timer, rec, frame, counts, cfg, label, backward):
    """``scene_kernel_checks`` on a frame that ``recorded_frames`` kept: the
    fills and the forward on their recorded inputs and, for a train frame,
    the backward on its recorded forward output and upstream gradient.
    ``counts``: the launch counts of the run, which the recorder must have
    seen all of."""
    if rec["calls"] != raster_launches(counts):
        raise AssertionError(f"{label}: the recorder saw {rec['calls']}, the counters {counts}")
    f = rec["frames"][frame]
    names = [x[0] for x in f["fills"]]
    if f["composite_forward"] is None or sorted(names) != (
            ["ordered_place_i32"] + ["ordered_prefix_fill"] * 2):
        raise AssertionError(f"{label}: recorded fills {names} and forward "
                             f"{f['composite_forward'] is not None}")
    (splats_t, start, count), kw = f["composite_forward"]
    if kw != dict(grid_x=kw["grid_x"], **composite_kw(cfg)):
        raise AssertionError(f"{label}: the composite ran with {kw}, the config gives "
                             f"{composite_kw(cfg)}")
    upstream = None
    if backward:
        if f["composite_backward"] is None:
            raise AssertionError(f"{label}: no backward received the frame's splats")
        (*tables, fwd_out, grad), bkw = f["composite_backward"]
        if bkw != kw or not all(torch.equal(a, b) for a, b in zip(tables, (splats_t, start,
                                                                           count))):
            raise AssertionError(f"{label}: the backward's tables are not the forward's")
        upstream = (fwd_out, grad)
    binning = types.SimpleNamespace(tile_chunk_start=start, tile_count=count)
    return scene_kernel_checks(torch, timer, (splats_t, binning, kw["grid_x"], f["fills"]),
                               cfg, label, backward, upstream)


def loss_by_iteration(timeline):
    """{iteration: loss} from the trainer's "steps" records."""
    out = {}
    for rec in timeline:
        if rec["stage"] == "steps":
            its = range(rec["from"], rec["to"] + 1)
            if len(its) != len(rec["losses"]):
                raise AssertionError(f"steps record {rec['from']}-{rec['to']} holds "
                                     f"{len(rec['losses'])} losses")
            out.update(zip(its, rec["losses"]))
    return out


def trace_share(path, ranges):
    """Device time of a torch.profiler chrome trace in ms: {"all", "forward"
    (of the ``ranges``), "backward" (of their backward)} and, under
    "kernels", the ranges' forward and backward time by kernel name.  A kernel (or copy,
    or set) belongs to the op whose "External id" it carries; the op is in
    the forward when a range encloses it on its thread, in the backward when
    an autograd node encloses it (an event named "...Backward..." or
    "autograd::engine::evaluate_function: ...") whose "Sequence number" one
    of the ranges' ops took: the sequence numbers that a range's ops take
    are those of the nodes that the range makes."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    cpu = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    parent = {}
    threads = {}
    for i, e in enumerate(cpu):
        threads.setdefault((e["pid"], e["tid"]), []).append(i)
    for idxs in threads.values():
        idxs.sort(key=lambda i: (cpu[i]["ts"], -cpu[i]["dur"]))
        stack = []
        for i in idxs:
            end = cpu[i]["ts"] + cpu[i]["dur"]
            while stack and cpu[stack[-1]]["ts"] + cpu[stack[-1]]["dur"] < end - 1e-3:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)

    def chain(i):
        while i is not None:
            yield i
            i = parent[i]

    in_range = [any(cpu[j]["name"] in ranges for j in chain(i)) for i in range(len(cpu))]
    seqs = {}  # range event -> sequence numbers its ops took
    for i in range(len(cpu)):
        n = cpu[i].get("args", {}).get("Sequence number")
        if in_range[i] and n is not None:
            top = next(j for j in chain(i) if cpu[j]["name"] in ranges)
            seqs.setdefault(top, []).append(n)
    spans = [(min(v), max(v)) for v in seqs.values()]

    def node(e):
        n = e.get("args", {}).get("Sequence number")
        return (n is not None and ("Backward" in e["name"]
                                   or e["name"].startswith("autograd::engine::evaluate_function"))
                and any(lo <= n <= hi for lo, hi in spans))

    side = {}
    for i, e in enumerate(cpu):
        ext = e.get("args", {}).get("External id")
        if ext is not None:
            side[ext] = ("forward" if in_range[i] else
                         "backward" if any(node(cpu[j]) for j in chain(i)) else None)
    total = {"all": 0.0, "forward": 0.0, "backward": 0.0}
    kernels = {}
    for e in device:
        total["all"] += e["dur"] / 1e3
        where = side.get(e.get("args", {}).get("External id"))
        if where:
            total[where] += e["dur"] / 1e3
            key = f"{where}: {e['name'][:90]}"
            kernels[key] = kernels.get(key, 0.0) + e["dur"] / 1e3
    total["kernels"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1]))
    return total


def se3_share_of_step(torch, root, src, model, growths):
    """The SE(3) net's and the gate's share of one train step's device time,
    from the torch.profiler trace that the trainer's ``--profile_dir``
    writes: ``train.main`` resumed from the checkpoint at CLI_ITERS - 10
    (into another output directory) at the run's last instance capacity and
    slack, 10 steps to the counter drain at CLI_ITERS, then the step at
    CLI_ITERS + 1 traced.  ``deform_se3`` and ``opacity_mask_gate`` run
    inside record_function ranges for this run (``trace_share``)."""
    from gs_deformable_tpu_torch import train as train_cli
    from gs_deformable_tpu_torch.models import deform as deform_mod

    cap, slack = ((growths[-1]["capacity"], growths[-1]["aligned_slack"]) if growths
                  else (None, None))
    traced = CLI_ITERS + 1
    prof_dir = os.path.join(root, "profile")
    argv = ["-s", src, "-m", os.path.join(root, "cli_resumed"), "--deform_mode", "se3",
            "--use_opacity_mask", "--eval", "--iterations", str(traced + 1),
            "--warmup_iters", str(CLI_WARMUP), "--start_checkpoint",
            os.path.join(model, "ckpt_save", f"chkpnt_{CLI_ITERS - 10}.npz"),
            "--profile_dir", prof_dir, "--profile_start", str(traced), "--profile_steps", "1",
            "--test_iterations", "-1", "--save_iterations", "-1", "--disable_viewer",
            "--seed", "0", "--quiet"]
    if cap is not None:
        argv += ["--instance_capacity", str(cap), "--aligned_slack", str(slack)]
    saved = deform_mod.deform_se3, deform_mod.opacity_mask_gate
    ranges = ("se3_net", "opacity_gate")

    def ranged(name, fn):
        def call(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return call

    deform_mod.deform_se3 = ranged(ranges[0], saved[0])
    deform_mod.opacity_mask_gate = ranged(ranges[1], saved[1])
    try:
        train_cli.main(argv)
    finally:
        deform_mod.deform_se3, deform_mod.opacity_mask_gate = saved
    t = trace_share(os.path.join(prof_dir, f"trace_{traced}.json"), ranges)
    step_ms, fwd_ms, bwd_ms = t["all"], t["forward"], t["backward"]
    for name, ms in list(t["kernels"].items())[:8]:
        log(f"    {ms:8.4f} ms  {name}")
    if not (fwd_ms > 0 and bwd_ms > 0 and fwd_ms + bwd_ms < step_ms):
        raise AssertionError(f"the trace gives the se3 net and gate forward {fwd_ms} ms, "
                             f"backward {bwd_ms} ms of a {step_ms} ms step")
    return {"step_device_ms": step_ms, "se3_net_and_gate_forward_device_ms": fwd_ms,
            "se3_net_and_gate_backward_device_ms": bwd_ms,
            "se3_share_of_step": (fwd_ms + bwd_ms) / step_ms, "traced_iteration": traced,
            "instance_capacity": cap, "aligned_slack": slack, "kernels_ms": t["kernels"]}


def cli_phase(torch, timer, root):
    """Phase 12: the port's trainer and render CLIs on phase 11's scene
    (under ``root``), se3 deformation with the opacity gate."""
    from gs_deformable_tpu_torch import render_cli, training, video, viewer
    from gs_deformable_tpu_torch import train as train_cli
    from gs_deformable_tpu_torch.io import checkpoint, model_ply
    from gs_deformable_tpu_torch.models.deform import SE3Net
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    src, model = os.path.join(root, "scene"), os.path.join(root, "cli_model")
    last, ckpt_its = CLI_ITERS, (CLI_ITERS - 10, CLI_ITERS)
    argv = ["-s", src, "-m", model, "--deform_mode", "se3", "--use_opacity_mask", "--eval",
            "--iterations", str(last), "--warmup_iters", str(CLI_WARMUP),
            "--checkpoint_iterations", *map(str, ckpt_its), "--save_iterations", str(last),
            "--test_iterations", str(last), "--ip", "127.0.0.1", "--port", "0",
            "--seed", "0", "--quiet"]
    log(f"  train.main({' '.join(argv)})")
    timeline = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_frames(torch, (last - 1,)) as step_rec:  # frame i - 1: iteration i's step
        train_cli.main(argv, timeline)
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = launch_counts()
    viewer_bound = viewer._listener is not None
    viewer.close()
    report_views = min(SCENE_TEST, 20) + min(SCENE_TRAIN, 5)
    want = {"composite_forward": last + report_views, "composite_backward": last}
    want["ordered_prefix_fill"] = 2 * want["composite_forward"]
    want["ordered_place_i32"] = want["composite_forward"]
    log(f"  trained {last} iterations in {train_s:.1f} s; the viewer's socket "
        f"{'bound' if viewer_bound else 'did not bind'}; launches {counts}")
    if raster_launches(counts) != want:
        raise AssertionError(f"trainer launches {counts}, expected {want} ({last} steps and "
                             f"{report_views} report views)")

    # (a) the run learns and writes the JAX CLI's layout.
    loss = loss_by_iteration(timeline)
    if sorted(loss) != list(range(1, last + 1)):
        raise AssertionError("the trainer's records miss some iterations' losses")
    first = [loss[i] for i in range(CLI_WARMUP, CLI_WARMUP + 20)]
    final = [loss[i] for i in range(last - 19, last + 1)]
    if not np.isfinite(list(loss.values())).all() or not np.mean(final) < np.mean(first):
        raise AssertionError(f"loss did not fall: first 20 after warmup {first}, last 20 {final}")
    layout = ["cfg_args", "cameras.json", "input.ply",
              *(f"ckpt_save/chkpnt_{i}.npz" for i in ckpt_its),
              f"point_cloud/iteration_{last}/point_cloud.ply",
              *(f"point_cloud/iteration_{last}/{n}.npz" for n in model_ply.NET_FILES)]
    missing = [f for f in layout if not os.path.exists(os.path.join(model, f))]
    if missing:
        raise AssertionError(f"output layout misses {missing}")

    # (e) instance overflow grows the capacity and carries the run through.
    growths = [r for r in timeline if r["stage"] == "instance_growth"]
    for r in growths:
        log(f"  instance growth at iteration {r['iteration']}: required {r['required']} "
            f"(aligned {r['required_aligned']}) -> capacity {r['capacity']}, slack "
            f"{r['aligned_slack']}")
    overflowed = sum(r.get("overflow", 0) for r in timeline if r["stage"] == "steps")
    log(f"  {len(growths)} instance growth(s); {overflowed} frame(s) truncated before a growth")

    # The render CLI over both sets, its state, its image of the first test
    # view and that view's kernel inputs recorded as it ran.
    cli = {}
    real_render_set, real_png = render_cli.render_set, render_cli._png
    first_png = os.path.join(model, "test", f"ours_{last}", "renders", "00000.png")

    def render_set(model_path, name, iteration, cams, ts, cfg, active_sh, bg, **kw):
        cli[name] = {"cams": cams, "ts": ts, "cfg": cfg, "active_sh": active_sh, "bg": bg}
        return real_render_set(model_path, name, iteration, cams, ts, cfg, active_sh, bg, **kw)

    def png(img, path):
        if path == first_png:
            cli["image"] = img.copy()
        real_png(img, path)

    render_cli.render_set, render_cli._png = render_set, png
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with recorded_frames(torch, (SCENE_TRAIN,)) as view_rec:  # train views render first
            psnrs = render_cli.main(["-m", model, "--quiet"])
            torch.cuda.synchronize()
    finally:
        render_cli.render_set, render_cli._png = real_render_set, real_png
    render_s = time.perf_counter() - t0
    rcounts = launch_counts()
    views = SCENE_TRAIN + SCENE_TEST
    rwant = {"composite_forward": views, "composite_backward": 0,
             "ordered_prefix_fill": 2 * views, "ordered_place_i32": views}
    if raster_launches(rcounts) != rwant:
        raise AssertionError(f"render CLI launches {rcounts}, expected {rwant}")
    test_dir = os.path.join(model, "test", f"ours_{last}")
    for sub in ("renders", "gt"):
        if len(os.listdir(os.path.join(test_dir, sub))) != SCENE_TEST:
            raise AssertionError(f"render CLI wrote {os.listdir(os.path.join(test_dir, sub))}")
    if not np.isfinite(psnrs["test"]).all():
        raise AssertionError(f"render CLI PSNRs {psnrs}")

    # (b) the render CLI's own image of the first test view (its PLY and five
    # nets) against the checkpoint at `last` through the same eval path.
    test = cli["test"]
    cfg, ts_cli, view = test["cfg"], test["ts"], test["cams"][0]
    if not isinstance(ts_cli.net, SE3Net) or sorted(ts_cli.latent) != sorted(
            model_ply.LATENT_FILES):
        raise AssertionError(f"the render CLI restored {type(ts_cli.net)}, "
                             f"{sorted(ts_cli.latent)}")
    ck, ck_it = checkpoint.load_checkpoint(os.path.join(model, "ckpt_save", f"chkpnt_{last}.npz"),
                                           _cli_template(torch, training, cfg, src, model, last))
    batch = training.make_eval_render_batch(
        cfg, width=view.width, height=view.height, tan_fovx=view.tan_fovx,
        tan_fovy=view.tan_fovy, active_sh_degree=test["active_sh"], device="cuda")

    def first_view(ts):
        return training.eval_sweep(lambda c: batch, ts, [view],
                                   lambda c: train_cli.cam_arrays(c, "cuda"),
                                   lambda c: c.image, test["bg"], render_cli.FINAL,
                                   batch=1)[0][0]

    img_ck = first_view(ck)
    if (ck_it != last or not np.isfinite(img_ck).all()
            or not np.array_equal(cli["image"], img_ck)):
        raise AssertionError(f"the render CLI's image differs from the checkpoint's at {ck_it}: "
                             f"max diff {float(np.abs(cli['image'] - img_ck).max())}")
    pert = dict(ts_cli.latent)
    pert["opacity_mask"] = type(pert["opacity_mask"])(
        {g: [{k: a + 0.5 for k, a in layer.items()} for layer in layers]
         for g, layers in pert["opacity_mask"].numpy_params().items()},
        cfg.deform, device="cuda")
    pert_diff = float(np.abs(first_view(dataclasses.replace(ts_cli, latent=pert))
                             - cli["image"]).max())
    if not pert_diff > 1e-6:
        raise AssertionError("a perturbed opacity_mask net leaves the image unchanged")
    log(f"  reload: the render CLI's image of the first test view (PLY at capacity "
        f"{ts_cli.gaussians.capacity}, five nets) is bitwise the checkpoint's at {last} "
        f"(capacity {ck.gaussians.capacity}); a perturbed opacity_mask net moves it by "
        f"{pert_diff:.3g}")

    # (c) the kernels on the inputs their wrappers received in the runs: the
    # step at `last` and the render CLI's first test view.
    step_check = recorded_checks(torch, timer, step_rec, last - 1, counts, cfg,
                                 "se3 train step", backward=True)
    view_check = recorded_checks(torch, timer, view_rec, SCENE_TRAIN, rcounts, cfg,
                                 "render-CLI view", backward=False)

    t0 = time.perf_counter()
    vid = video.frames_to_video(os.path.join(test_dir, "renders"),
                                os.path.join(root, "test.mp4"), fps=10)
    video_s = time.perf_counter() - t0
    if os.path.getsize(vid) == 0:
        raise AssertionError("empty video")

    share = se3_share_of_step(torch, root, src, model, growths)

    def stage_ms(name):
        return float(sum(r["ms"] for r in timeline if r["stage"] == name))

    def step_ms(lo, hi):
        recs = [r for r in timeline if r["stage"] == "steps" and lo <= r["from"]
                and r["to"] <= hi and r["to"] > r["from"]]
        return float(np.median([r["ms"] / (r["to"] - r["from"] + 1) for r in recs]))

    times = {"scene_load_ms": stage_ms("scene_load"), "init_ms": stage_ms("init"),
             "ms_per_step_warmup": step_ms(11, CLI_WARMUP - 1),
             "ms_per_step_se3": step_ms(CLI_WARMUP + 10, last),
             "step_device_ms": share["step_device_ms"],
             "se3_net_and_gate_device_ms": (share["se3_net_and_gate_forward_device_ms"]
                                            + share["se3_net_and_gate_backward_device_ms"]),
             "se3_share_of_step": share["se3_share_of_step"],
             "densify_ms": stage_ms("densify"), "test_report_ms": stage_ms("test_report"),
             "save_ms": stage_ms("save"), "checkpoint_ms": stage_ms("checkpoint"),
             "render_cli_ms_per_view": render_s * 1e3 / views, "video_ms": video_s * 1e3,
             "train_s": train_s}
    dens = [r for r in timeline if r["stage"] == "densify"]
    log(f"  loss, mean of iterations {CLI_WARMUP}-{CLI_WARMUP + 19} {np.mean(first):.5f} -> "
        f"{last - 19}-{last} {np.mean(final):.5f}; densify {dens}")
    log(f"  render CLI: {views} views, test PSNR mean {np.mean(psnrs['test']):.3f}; "
        f"video {os.path.basename(vid)} {os.path.getsize(vid)} bytes")
    log(f"  profiled step {share['traced_iteration']} (resumed from {last - 10}, instance "
        f"capacity {share['instance_capacity']}): device "
        f"{share['step_device_ms']:.4g} ms, the se3 net and gate forward "
        f"{share['se3_net_and_gate_forward_device_ms']:.4g} ms and backward "
        f"{share['se3_net_and_gate_backward_device_ms']:.4g} ms of it")
    for k, v in times.items():
        log(f"  stage {k}: {v:.4g}")
    return {"iterations": last, "warmup": CLI_WARMUP, "argv": argv, "launches": counts,
            "render_launches": rcounts, "viewer_bound": viewer_bound, "times": times,
            "se3_profile": share,
            "loss_first_20": first, "loss_last_20": final, "growths": growths,
            "overflowed_frames": overflowed, "densify": dens,
            "reload_capacity": ts_cli.gaussians.capacity, "checkpoint_capacity":
            ck.gaussians.capacity, "perturbed_gate_diff": pert_diff, "psnr": psnrs,
            "video": os.path.basename(vid),
            "kernel_checks": {"train_step": step_check, "render_view": view_check}}


# -- phase 13: the native COLMAP reader ---------------------------------------


def write_colmap_model(root, rng):
    """A binary COLMAP model at a Mip-NeRF 360 scene's size: COLMAP_IMAGES
    images of COLMAP_OBS 2D points each, COLMAP_POINTS points3D with tracks
    of 2-9 entries (about as many as the observations), one PINHOLE and one
    OPENCV camera (tests/test_colmap.py's wire format)."""
    import struct

    lens = rng.integers(2, 10, COLMAP_POINTS)  # ~5.5 a point: ~1M, the observations' count
    with open(os.path.join(root, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 4946, 3286) + struct.pack("<4d", 3500.0, 3500.0,
                                                                       2473.0, 1643.0))
        f.write(struct.pack("<iiQQ", 2, 4, 1237, 822)
                + struct.pack("<8d", *rng.uniform(-1, 1, 8)))
    obs = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
    with open(os.path.join(root, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", COLMAP_IMAGES))
        for i in range(COLMAP_IMAGES):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<idddddddi", i + 1, *q, *rng.normal(size=3), 1 + i % 2))
            f.write(f"DSCF{5000 + i:04d}.JPG".encode() + b"\x00")
            rec = np.empty(COLMAP_OBS, obs)
            rec["x"] = rng.uniform(0, 4946, COLMAP_OBS)
            rec["y"] = rng.uniform(0, 3286, COLMAP_OBS)
            rec["id"] = np.where(rng.random(COLMAP_OBS) < 0.8,
                                 rng.integers(1, COLMAP_POINTS + 1, COLMAP_OBS), -1)
            f.write(struct.pack("<Q", COLMAP_OBS) + rec.tobytes())
    xyz = rng.normal(size=(COLMAP_POINTS, 3)) * 3.0
    rgb = rng.integers(0, 256, (COLMAP_POINTS, 3))
    err = rng.uniform(0, 2, COLMAP_POINTS)
    track = rng.integers(0, 2**31 - 1, (int(lens.sum()), 2), dtype=np.int64).astype("<i4")
    parts, at = [struct.pack("<Q", COLMAP_POINTS)], 0
    head = struct.Struct("<QdddBBBdQ")
    for i in range(COLMAP_POINTS):
        n = int(lens[i])
        parts.append(head.pack(i + 1, *xyz[i], *rgb[i], err[i], n))
        parts.append(track[at:at + n].tobytes())
        at += n
    with open(os.path.join(root, "points3D.bin"), "wb") as f:
        f.write(b"".join(parts))
    return int(lens.sum())


def colmap_phase(torch, root):
    """Phase 13: the port's native reader built here and read through
    ``data.colmap`` (no Python fallback accepted), against the Python
    parser on the same files: equal bit for bit in every field both return."""
    from gs_deformable_tpu_torch import _build
    from gs_deformable_tpu_torch.data import colmap
    from gs_deformable_tpu_torch.io import native

    t0 = time.perf_counter()
    track_len = write_colmap_model(root, np.random.default_rng(13))
    write_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(root, f))
             for f in ("cameras.bin", "images.bin", "points3D.bin")}
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native COLMAP reader did not build")
    build_s = time.perf_counter() - t0
    paths = {k: os.path.join(root, f) for k, f in (("points", "points3D.bin"),
                                                    ("cameras", "cameras.bin"),
                                                    ("images", "images.bin"))}
    for fn, path in ((native.read_points3d_bin, paths["points"]),
                     (native.read_cameras_bin, paths["cameras"]),
                     (native.read_images_bin, paths["images"])):
        if fn(path) is None:
            raise AssertionError(f"the native reader refused {path}")

    def read_all():
        out, ms = {}, {}
        for key, fn in (("points", colmap.read_points3d_binary),
                        ("cameras", colmap.read_intrinsics_binary),
                        ("images", colmap.read_extrinsics_binary)):
            t = time.perf_counter()
            out[key] = fn(paths[key])
            ms[key] = (time.perf_counter() - t) * 1e3
        return out, ms

    calls = []
    saved = {n: getattr(native, n) for n in ("read_points3d_bin", "read_cameras_bin",
                                             "read_images_bin")}
    for n, fn in saved.items():
        setattr(native, n, lambda p, fn=fn, n=n: calls.append(n) or fn(p))
    try:
        nat, nat_ms = read_all()
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)
    if sorted(calls) != sorted(saved):
        raise AssertionError(f"the binary readers called the native reader for {calls}")
    available = native.available
    native.available = lambda: False
    try:
        py, py_ms = read_all()
    finally:
        native.available = available
    for a, b in zip(nat["points"], py["points"], strict=True):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("points3D: native and Python readers differ")
    if list(nat["cameras"]) != list(py["cameras"]) or any(
            (a.model, a.width, a.height) != (b.model, b.width, b.height)
            or not np.array_equal(a.params, b.params)
            for a, b in zip(nat["cameras"].values(), py["cameras"].values())):
        raise AssertionError("cameras: native and Python readers differ")
    if list(nat["images"]) != list(py["images"]):
        raise AssertionError("images: native and Python readers list other ids")
    for a, b in zip(nat["images"].values(), py["images"].values()):
        if ((a.camera_id, a.name) != (b.camera_id, b.name) or not np.array_equal(a.qvec, b.qvec)
                or not np.array_equal(a.tvec, b.tvec) or a.xys.shape != (0, 2)
                or b.xys.shape != (COLMAP_OBS, 2)):
            raise AssertionError(f"image {a.id}: native and Python readers differ")
    rec = {"images": COLMAP_IMAGES, "observations_per_image": COLMAP_OBS,
           "points3d": COLMAP_POINTS, "track_entries": track_len, "bytes": sizes,
           "write_s": write_s, "build_or_load_s": build_s,
           "library": os.path.basename(_build._target("colmap_io")),
           "native_ms": nat_ms, "python_ms": py_ms, "bitwise_equal": True}
    log(f"  wrote {COLMAP_IMAGES} images x {COLMAP_OBS} observations, {COLMAP_POINTS} points3D "
        f"({track_len} track entries; {sum(sizes.values()) / 1e6:.1f} MB) in {write_s:.1f} s; "
        f"native library ready in {build_s:.2f} s ({rec['library']})")
    log("  read ms, native / Python: " + "; ".join(
        f"{k} {nat_ms[k]:.1f} / {py_ms[k]:.1f}" for k in nat_ms)
        + "  (equal bit for bit; the native images reader skips the 2D tracks)")
    return rec


# -- phase 14: the mesh ---------------------------------------------------------


def mesh_cfg(config):
    """Phase 11's configuration with the fp32 MLP tier (the bf16 tier trips
    the train-step bars through Adam's first rsqrt, tests/test_sharding.py:
    25-33) and instance capacity 2^22: past the warmup the untrained net
    needs ~2.3M instances a frame (PERF.md §6)."""
    return config.Config(deform=config.DeformConfig(compute_dtype="float32"),
                         raster=config.RasterizeConfig(instance_capacity=MESH_ICAP))


def mesh_inputs(torch, src, work):
    """Phase 11's scene for the mesh runs: the initial state (its cloud at
    capacity 262,144) and MESH_VIEWS train views, saved once under ``work``."""
    import random

    from gs_deformable_tpu_torch.data.scene import Scene
    from gs_deformable_tpu_torch.models.gaussians import init_from_points

    sc = Scene(src, "", eval=True, rng=np.random.RandomState(0), shuffle_rng=random.Random(0))
    pcd = sc.scene_info.point_cloud
    cap = 1 << (2 * len(pcd.points) - 1).bit_length()
    state = init_from_points(pcd.points, pcd.colors, cap, 3)
    cams = sc.get_train_cameras()[:MESH_VIEWS]
    arrays = {f"g_{f.name}": getattr(state, f.name).cpu().numpy()
              for f in dataclasses.fields(state)}
    for name in ("world_view", "full_proj", "camera_center", "time"):
        arrays[f"cam_{name}"] = np.stack([np.asarray(getattr(c, name), np.float32)
                                          for c in cams])
    arrays["gts"] = np.stack([c.image for c in cams]).astype(np.float32)
    c0 = cams[0]
    arrays["frame"] = np.asarray([c0.width, c0.height, c0.tan_fovx, c0.tan_fovy], np.float64)
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    return cap


def mesh_load(torch, work, cfg, device="cuda"):
    """(TrainState, cameras, gts, step keywords) from ``mesh_inputs``."""
    from gs_deformable_tpu_torch import training
    from gs_deformable_tpu_torch.models.gaussians import GaussianState
    from gs_deformable_tpu_torch.renderer import CameraArrays

    with np.load(os.path.join(work, "inputs.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    state = GaussianState(**{k[2:]: torch.from_numpy(v).to(device)
                             for k, v in arrays.items() if k.startswith("g_")})
    net, latent = training.init_nets(cfg, 0, device)
    ts = training.init_train_state(state, net, 0, latent)
    cams = [CameraArrays(*(torch.as_tensor(np.asarray(arrays[f"cam_{n}"][i]), device=device)
                           for n in ("world_view", "full_proj", "camera_center", "time")))
            for i in range(MESH_VIEWS)]
    gts = torch.from_numpy(arrays["gts"]).to(device)
    w, h, tx, ty = arrays["frame"]
    kw = dict(width=int(w), height=int(h), tan_fovx=float(tx), tan_fovy=float(ty),
              active_sh_degree=3, spatial_lr_scale=1.0)
    return ts, cams, gts, kw


def mu_cpu(ts):
    return [(k, t.detach().cpu()) for k, t in mu_leaves(ts)]


def hold_step(torch, got_loss, got_mu, ref_loss, ref_mu, what):
    """One step against a reference in the same row order at the train-step
    bars: loss rtol 1e-5, every gradient (Adam's first moment) rtol 1e-3 /
    atol 5e-5 x its leaf's scale, no element off the bar."""
    groups, bitwise = grads_vs(torch, got_mu, ref_mu)
    sizes = {}
    for k, t in ref_mu:
        sizes[k] = sizes.get(k, 0) + t.numel()
    loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
    log(f"  {what}: loss {got_loss:.8f} vs {ref_loss:.8f} (rel {loss_rel:.3g}); gradients "
        "off the bar / elements / max error over the leaf's scale: " + ", ".join(
            f"{k} {off} / {sizes[k]} / {w:.3g}" for k, (off, w) in groups.items())
        + f"; bitwise equal: {bitwise}")
    for k, (off, w) in groups.items():
        if off:
            raise AssertionError(f"{what}: group {k} has {off} of {sizes[k]} gradients off "
                                 f"the bar, max error {w:.3g} of its leaf's scale")
    if loss_rel > 1e-5:
        raise AssertionError(f"{what}: loss off by {loss_rel:.3g}")
    return {"loss": got_loss, "ref_loss": ref_loss, "loss_rel": loss_rel, "bitwise": bitwise,
            "groups": {k: {"off_bar": off, "elements": sizes[k], "max_err_over_scale": w}
                       for k, (off, w) in groups.items()}}


def band_frame_check(torch, rec, frame, counts, cfg, label):
    """A band frame that ``recorded_frames`` kept inside a sharded run: each
    ordered fill and the composite forward bitwise against their plain
    versions, the backward on its recorded forward output and upstream
    gradient at the phase-7 bars (rtol 5e-4 / atol 2e-5 x the row's scale)."""
    from gs_deformable_tpu_torch.ops.kernels import composite as comp
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    if rec["calls"] != raster_launches(counts):
        raise AssertionError(f"{label}: the recorder saw {rec['calls']}, the counters {counts}")
    f = rec["frames"][frame]
    if f["composite_forward"] is None or f["composite_backward"] is None or len(f["fills"]) != 3:
        raise AssertionError(f"{label}: the frame was not recorded whole")
    for name, pos, x, k in f["fills"]:
        got = (of.ordered_prefix_fill(pos, x, k) if name == "ordered_prefix_fill"
               else of.ordered_place_i32(pos, x, k))
        ref = (of.prefix_fill_plain(pos, x, k) if name == "ordered_prefix_fill"
               else of.place_plain(pos, x, k))
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: {name} differs from its plain version")
    (splats_t, start, count), kw = f["composite_forward"]
    if kw != dict(grid_x=kw["grid_x"], **composite_kw(cfg)):
        raise AssertionError(f"{label}: the composite ran with {kw}")
    out = comp.composite_forward(splats_t, start, count, **kw)
    if not torch.equal(out, comp.composite_forward_plain(splats_t, start, count, **kw)):
        raise AssertionError(f"{label}: composite_forward differs from its plain version")
    (*tables, fwd_out, grad), bkw = f["composite_backward"]
    if not torch.equal(fwd_out, out) or bkw != kw:
        raise AssertionError(f"{label}: the backward's inputs are not the forward's")
    got = comp.composite_backward(*tables, fwd_out, grad, **bkw)
    ref = comp.composite_backward_plain(*tables, fwd_out, grad, **bkw)
    assert_rows_close(torch, got[:GRAD_FIELDS], ref[:GRAD_FIELDS], f"{label} backward")
    err = float((got - ref).abs().max())
    rel = max(float((got[r] - ref[r]).abs().max() / (ref[r].abs().max() + 1e-30))
              for r in range(GRAD_FIELDS))
    return {"label": label, "tiles": int(count.shape[0]), "Kp": int(splats_t.shape[1]),
            "instances": int(count.sum()), "fills": [(n, int(p.shape[0]), int(k))
                                                     for n, p, _, k in f["fills"]],
            "forward_bitwise": True, "backward_max_abs_err": err,
            "backward_max_err_over_row_scale": rel}


def digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def sharded_run(torch, mesh, cfg, ts, cams, gts, kw, label, views_of):
    """MESH_STEPS sharded steps (step k: data row d takes view ``views_of(k, d)``),
    a sharded densify and an opacity reset, on the recorder (frame 0 kept).
    Returns (record, the step-1 gathered state's loss and mu)."""
    from gs_deformable_tpu_torch.models.gaussians import tree_leaves
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from gs_deformable_tpu_torch.parallel import sharding

    ts = sharding.shard_train_state(ts, mesh)
    step = sharding.make_sharded_train_step(cfg, mesh, **kw)
    bg = torch.zeros(3, device="cuda")
    losses, ms, first = [], [], None
    reset_launch_counts()
    with recorded_frames(torch, (0,)) as rec:
        for k in range(MESH_STEPS):
            v = views_of(k, mesh.data_index)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = step(ts, cams[v], gts[v], bg, MESH_ITER0 + k)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if k == 0:
                full = sharding.gather_train_state(ts, mesh)
                first = (losses[0], mu_cpu(full))
                del full
                if int(m["required_instances"]) > cfg.raster.instance_capacity:
                    raise AssertionError(f"{label}: instance overflow")
    counts = launch_counts()
    want = launches_want(STEP_LAUNCHES, MESH_STEPS)  # the fp32 tier: no trunk epilogue
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    # The collectives' share, from further steps whose collectives are timed
    # alone (the card synchronised around each), so that ms/step above is
    # the trainer's own.
    clock_ms, coll_ms = [], []
    for k in range(MESH_STEPS, MESH_STEPS + MESH_CLOCK_STEPS):
        v = views_of(k, mesh.data_index)
        with timed_collectives(torch) as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = step(ts, cams[v], gts[v], bg, MESH_ITER0 + k)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            clock_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(clock["s"] * 1e3)
    band = band_frame_check(torch, rec, 0, counts, cfg,
                            f"{label} band {mesh.model_index} of row {mesh.data_index}")
    dens = sharding.make_sharded_densify_step(cfg, mesh, extent=4.0, use_screen_prune=False)
    ts, info = dens(ts, cfg.opt.densify_grad_threshold, cfg.opt.min_opacity)
    ts = sharding.make_sharded_opacity_reset(cfg, mesh)(ts)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: loss not finite: {losses}")
    net = digest(tree_leaves(ts.net.param_tree()))
    local = digest([getattr(ts.gaussians, f.name) for f in dataclasses.fields(ts.gaussians)]
                   + [t for _, t in mu_leaves(ts)])
    rec_out = {"label": label, "rank": mesh.rank, "losses": losses, "ms": ms,
               "ms_per_step": float(np.median(ms[1:])), "clocked_ms": clock_ms,
               "collective_ms": coll_ms, "collective_calls": clock["calls"],
               "collective_share": float(np.sum(coll_ms) / np.sum(clock_ms)),
               "launches": counts, "band_frame": band,
               "densify": {kk: int(v) for kk, v in info.items()},
               "net_digest": net, "slice_digest": local,
               "required_instances": int(m["required_instances"]),
               "required_aligned": int(m["required_aligned"])}
    return rec_out, first


@contextlib.contextmanager
def timed_collectives(torch):
    """Within it, ``torch.distributed``'s ``all_reduce`` and ``all_gather``
    (all the sharded step calls) synchronise the card before and after each
    call and add its host seconds to ``clock["s"]`` and one to
    ``clock["calls"]``: the collective's own time, gloo's host copies
    included."""
    import torch.distributed as dist

    clock = {"s": 0.0, "calls": 0}
    saved = dist.all_reduce, dist.all_gather

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            clock["s"] += time.perf_counter() - t0
            clock["calls"] += 1
            return out
        return call

    dist.all_reduce, dist.all_gather = timed(saved[0]), timed(saved[1])
    try:
        yield clock
    finally:
        dist.all_reduce, dist.all_gather = saved


def gloo_cuda_probe(torch, dist):
    """Which collectives gloo takes with CUDA tensors as they are (the port's
    collectives hand it CUDA tensors as they are)."""
    import datetime

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=60))
    n = dist.get_world_size()
    x = torch.ones(8, device="cuda")
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x,
                                              group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * n, device="cuda"), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8, device="cuda"), torch.ones(8 * n, device="cuda"), group=group),
    }
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "taken"
        except Exception as e:  # a refusal is what the probe records
            out[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return out


def mesh_child(argv):
    """One rank of phase 14 (b) or (c): ``chip_smoke.py --mesh-child <work>
    <rank> <world>``.  World 2: the 2x1 decomposition's first step (saved
    for (c)), then the 1x2 run held against the single-device step; world
    4: the 2x2 run held against the saved 2x1 step."""
    import datetime

    import torch
    import torch.distributed as dist

    from gs_deformable_tpu_torch import config, device, training
    from gs_deformable_tpu_torch.parallel import sharding

    work, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.cuda.set_device(0)
    device.pin_fp32()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, f'store{world}')}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    cfg = mesh_cfg(config)
    out = {}
    if world == 2:
        m21 = sharding.make_mesh(2, 1)
        ts, cams, gts, kw = mesh_load(torch, work, cfg)
        # In (c)'s row order, so that only the bands differ.
        ts = sharding.permute_gaussian_rows(ts, sharding.interleave_perm(
            ts.gaussians.capacity, 2))
        step = sharding.make_sharded_train_step(cfg, m21, **kw)
        d = m21.data_index
        ts, m = step(ts, cams[d], gts[d], torch.zeros(3, device="cuda"), MESH_ITER0)
        if rank == 0:
            torch.save({"loss": float(m["loss"]), "mu": mu_cpu(ts)},
                       os.path.join(work, "step_2x1.pt"))
        del ts, step
        ts, cams, gts, kw = mesh_load(torch, work, cfg)
        if rank == 0:  # the single-device step on the same interleaved state
            ref = sharding.permute_gaussian_rows(ts, sharding.interleave_perm(
                ts.gaussians.capacity, 2))
            single = training.make_train_step(cfg, **kw)
            ref, m = single(ref, cams[0], gts[0], torch.zeros(3, device="cuda"), MESH_ITER0)
            ref_first = (float(m["loss"]), mu_cpu(ref))
            del ref, single
            ts, *_ = mesh_load(torch, work, cfg)
        mesh = sharding.make_mesh(1, 2)
        rec, first = sharded_run(torch, mesh, cfg, ts, cams, gts, kw, "1x2",
                                 lambda k, d: k % MESH_VIEWS)
        if rank == 0:
            rec["vs_single_device"] = hold_step(torch, *first, *ref_first,
                                                "(b) 1x2 step 1 vs the single-device step")
        out["probe"] = gloo_cuda_probe(torch, dist)
    else:
        mesh = sharding.make_mesh(2, 2)
        ts, cams, gts, kw = mesh_load(torch, work, cfg)
        rec, first = sharded_run(torch, mesh, cfg, ts, cams, gts, kw, "2x2",
                                 lambda k, d: (2 * k + d) % MESH_VIEWS)
        if rank == 0:
            ref = torch.load(os.path.join(work, "step_2x1.pt"))
            rec["vs_2x1"] = hold_step(torch, *first, ref["loss"], ref["mu"],
                                      "(c) 2x2 step 1 vs the 2x1 decomposition's step 1")
    digests = [None] * world
    dist.all_gather_object(digests, (rec["net_digest"], rec["slice_digest"],
                                     rec["losses"], mesh.model_index))
    if len({d[0] for d in digests}) != 1:
        raise AssertionError("the net's parameters differ between ranks")
    if len({tuple(d[2]) for d in digests}) != 1:
        raise AssertionError("the metrics differ between ranks")
    for mi in range(mesh.n_model):
        if len({d[1] for d in digests if d[3] == mi}) != 1:
            raise AssertionError(f"data replicas of slice {mi} differ")
    out.update(rec)
    with open(os.path.join(work, f"rank{world}_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def cli_child(argv):
    """Phase 14 (d)'s rank under torch.distributed.run: ``train.main(argv)``
    with a timeline, which rank 0 writes to ``argv[0]``."""
    from gs_deformable_tpu_torch import train as train_cli

    timeline = []
    train_cli.main(argv[1:], timeline)
    if os.environ.get("RANK", "0") == "0":
        with open(argv[0], "w") as f:
            json.dump(timeline, f)
    return 0


def spawn_ranks(args_of, n, logs, env=None, timeout=600):
    """Start ``n`` processes (output to ``logs/rank<r>.log``) and wait for all;
    the first that fails stops the others and raises with its output."""
    files = [open(os.path.join(logs, f"rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(r)],
                              env=dict(os.environ, **(env or {})), stdout=f,
                              stderr=subprocess.STDOUT) for r, f in enumerate(files)]
    failed, start = None, time.time()
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.time() - start > timeout:
                failed = "timeout"
            time.sleep(0.2)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    if failed is not None:
        r = 0 if failed == "timeout" else failed
        with open(os.path.join(logs, f"rank{r}.log")) as f:
            raise AssertionError(f"rank {r} failed ({failed}):\n{f.read()[-6000:]}")


def file_layout(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files
                if not f.startswith("events.out.tfevents")]
    return sorted(out)


def mesh_phase(torch, root):
    """Phase 14: the mesh on phase 11's scene (under ``root``)."""
    import torch.distributed as dist

    from gs_deformable_tpu_torch import config, training
    from gs_deformable_tpu_torch.parallel import sharding

    src = os.path.join(root, "scene")
    work = os.path.join(root, "mesh")
    os.makedirs(work)
    cfg = mesh_cfg(config)
    t0 = time.perf_counter()
    cap = mesh_inputs(torch, src, work)
    log(f"  inputs: phase 11's cloud at capacity {cap}, {MESH_VIEWS} train views "
        f"({time.perf_counter() - t0:.1f} s)")
    rec = {"capacity": cap, "iterations": [MESH_ITER0, MESH_ITER0 + MESH_STEPS - 1],
           "instance_capacity": MESH_ICAP}

    # (a) world size 1 over NCCL.
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(work, 'store1')}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        backend = dist.get_backend()
        mesh = sharding.make_mesh(1, 1)
        runs = {}
        for name in ("sharded", "single"):
            ts, cams, gts, kw = mesh_load(torch, work, cfg)
            step = (sharding.make_sharded_train_step(cfg, mesh, **kw) if name == "sharded"
                    else training.make_train_step(cfg, **kw))
            losses, ms = [], []
            for k in range(MESH_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ts, m = step(ts, cams[k % MESH_VIEWS], gts[k % MESH_VIEWS],
                             torch.zeros(3, device="cuda"), MESH_ITER0 + k)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                if k == 0:
                    first = (losses[0], mu_cpu(ts))
            runs[name] = (losses, ms, first)
            del ts, step
    finally:
        dist.destroy_process_group()
    (l_s, ms_s, f_s), (l_1, ms_1, f_1) = runs["sharded"], runs["single"]
    held = hold_step(torch, *f_s, *f_1, "(a) 1x1 mesh step 1 vs make_train_step")
    drift = max(abs(a - b) / abs(b) for a, b in zip(l_s, l_1))
    if drift > 1e-3:
        raise AssertionError(f"(a) the 10 losses drift apart by {drift:.3g}")
    rec["a"] = {"backend": backend, "all_reduce": float(x.sum()), "losses": l_s,
                "single_losses": l_1, "ms": ms_s, "single_ms": ms_1,
                "ms_per_step": float(np.median(ms_s[1:])),
                "single_ms_per_step": float(np.median(ms_1[1:])),
                "loss_drift": drift, "step1": held, "collective_share": 0.0,
                "seconds": time.perf_counter() - t0}
    log(f"  (a) 1x1 over {backend}: {rec['a']['ms_per_step']:.2f} ms/step (make_train_step "
        f"{rec['a']['single_ms_per_step']:.2f}); 10 losses within {drift:.3g}; no collective "
        "(a group of one rank makes no call)")

    # (b) 1x2 and the 2x1 decomposition, (c) 2x2: ranks on the one card over gloo.
    for world, name in ((2, "b"), (4, "c")):
        t0 = time.perf_counter()
        logs = os.path.join(work, f"logs{world}")
        os.makedirs(logs)
        spawn_ranks(lambda r: ["--mesh-child", work, str(r), str(world)], world, logs)
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{world}_{r}.json")) as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        rec[name] = {"ranks": ranks, "seconds": time.perf_counter() - t0,
                     "ms_per_step": r0["ms_per_step"],
                     "collective_share": r0["collective_share"],
                     "collective_ms_per_step": float(np.mean(r0["collective_ms"]))}
        log(f"  ({name}) {r0['label']} over gloo, {world} ranks on one card: "
            f"{r0['ms_per_step']:.2f} ms/step; with each collective timed alone "
            f"({MESH_CLOCK_STEPS} further steps, {r0['collective_calls']} calls a step), "
            f"{rec[name]['collective_ms_per_step']:.2f} ms/step in the collectives, "
            f"{100 * r0['collective_share']:.1f}% of those steps' "
            f"{float(np.mean(r0['clocked_ms'])):.2f} ms; losses {r0['losses'][0]:.5f} -> "
            f"{r0['losses'][-1]:.5f}; densify "
            f"{r0['densify']}; nets bitwise equal on every rank, data replicas equal; "
            f"band frames held: " + "; ".join(
                f"rank {x['rank']} {x['band_frame']['instances']} instances, backward "
                f"{x['band_frame']['backward_max_err_over_row_scale']:.3g} of the row's scale"
                for x in ranks) + f"  ({rec[name]['seconds']:.1f} s)")
        held = r0["vs_single_device" if world == 2 else "vs_2x1"]
        log(f"  ({name}) step 1 against the " + ("single-device step" if world == 2 else
                                                 "2x1 decomposition (b) ran") +
            f": loss rel {held['loss_rel']:.3g}; off the bar / max error over the leaf's "
            "scale: " + ", ".join(f"{k} {g['off_bar']} / {g['max_err_over_scale']:.3g}"
                                  for k, g in held["groups"].items()))
        if world == 2:
            log(f"  gloo with CUDA tensors as they are: {r0['probe']}")

    # (d) the trainer CLI under torch.distributed.run, against a 1-rank run.
    t0 = time.perf_counter()
    argv = ["-s", src, "--iterations", str(CLI_MESH_ITERS), "--warmup_iters",
            str(CLI_MESH_WARMUP), "--densify_from_iter", "40", "--densification_interval", "50",
            "--checkpoint_iterations", str(CLI_MESH_ITERS), "--save_iterations",
            str(CLI_MESH_ITERS), "--test_iterations", "-1", "--disable_viewer", "--quiet"]
    cwd = os.path.join(work, "cli")
    os.makedirs(cwd)
    tl_path = os.path.join(work, "cli_timeline.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", os.path.abspath(__file__), "--cli-child", tl_path, *argv, "--n_model", "2"]
    res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(
                             os.path.abspath(__file__))))
    if res.returncode != 0:
        raise AssertionError(f"(d) torch.distributed.run exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    outs = os.listdir(os.path.join(cwd, "output"))
    if len(outs) != 1:
        raise AssertionError(f"(d) the ranks made {outs}: rank 0 alone must write")
    with open(tl_path) as f:
        timeline = json.load(f)
    mesh_s = time.perf_counter() - t0
    from gs_deformable_tpu_torch import train as train_cli

    single = os.path.join(work, "cli_single")
    t1 = time.perf_counter()
    single_tl = []
    train_cli.main([*argv, "-m", single], single_tl)
    single_s = time.perf_counter() - t1
    if file_layout(os.path.join(cwd, "output", outs[0])) != file_layout(single):
        raise AssertionError(f"(d) layout {file_layout(os.path.join(cwd, 'output', outs[0]))} "
                             f"differs from the 1-rank run's {file_layout(single)}")
    losses = loss_by_iteration(timeline)
    early = float(np.mean([losses[i] for i in range(1, 16)]))
    late = float(np.mean([losses[i] for i in range(16, CLI_MESH_WARMUP + 1)]))
    if not late < early:
        raise AssertionError(f"(d) the loss did not fall: {early} -> {late}")
    steps = [x for x in timeline if x["stage"] == "steps"]
    dens = [x for x in timeline if x["stage"] == "densify"]
    if len(dens) != 1 or not any(x["stage"] == "checkpoint" for x in timeline):
        raise AssertionError("(d) no densify or no checkpoint")
    step_ms = sum(x["ms"] for x in steps) / sum(x["to"] - x["from"] + 1 for x in steps)
    single_steps = [x for x in single_tl if x["stage"] == "steps"]
    single_ms = (sum(x["ms"] for x in single_steps)
                 / sum(x["to"] - x["from"] + 1 for x in single_steps))
    rec["d"] = {"argv": argv, "seconds": mesh_s, "single_seconds": single_s,
                "loss_first_15": early, "loss_16_30": late, "ms_per_step": step_ms,
                "single_ms_per_step": single_ms, "densify": dens[0],
                "growths": [x for x in timeline if x["stage"] == "instance_growth"],
                "layout": file_layout(single)}
    log(f"  (d) train.main --n_model 2 under torch.distributed.run: {CLI_MESH_ITERS} "
        f"iterations in {mesh_s:.1f} s ({step_ms:.1f} ms/step between drains; the 1-rank run "
        f"{single_ms:.1f}); loss {early:.5f} (1-15) -> {late:.5f} (16-30); densify at "
        f"{dens[0]['iteration']}: {dens[0]['n_alive']} alive; one output directory, the "
        "1-rank run's layout")
    return rec


# -- phase 15: the dense oracle and the quality path ---------------------------


def look_at_c2w(angle, radius=4.0):
    """OpenGL camera-to-world of a camera on a circle in the x-z plane looking
    at the origin (-z forward, y up), as a Blender scene's cameras."""
    eye = np.array([radius * np.sin(angle), 0.0, radius * np.cos(angle)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(right, forward)
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w


def blender_scene(torch, root, n_views=6, n_test=2, size=64, n_blobs=12, animate=True, seed=0,
                  device="cuda"):
    """An animated D-NeRF / Blender scene of ``n_blobs`` coloured gaussian blobs
    under ``root``: RGBA ``{split}/r_{i}.png`` and ``transforms_{split}.json``
    (``camera_angle_x`` 0.8, a ``time`` per frame), cameras on a quarter orbit,
    the blobs moving by (0.3 t, -0.2 t, 0), each view's ground truth drawn by
    the dense oracle on ``device``.  The same draws, cameras and files as the
    JAX package's test scene builder (tests/synthetic_scene.py)."""
    from PIL import Image

    from gs_deformable_tpu_torch.ops import projection
    from gs_deformable_tpu_torch.ops import transforms as tf
    from gs_deformable_tpu_torch.ops.rasterize_dense import rasterize_dense

    rng = np.random.default_rng(seed)
    fovx = 0.8
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    centers = rng.uniform(-0.8, 0.8, (n_blobs, 3)).astype(np.float32)
    colors = torch.tensor(rng.uniform(0.2, 1.0, (n_blobs, 3)), dtype=torch.float32,
                          device=device)
    opac = torch.tensor(rng.uniform(0.6, 0.95, n_blobs), dtype=torch.float32, device=device)
    var = 0.12 ** 2
    cov6 = torch.tensor([[var, 0, 0, var, 0, var]] * n_blobs, dtype=torch.float32, device=device)
    projm = tf.projection_matrix(0.01, 100.0, fovx, fovx)
    tan = float(np.tan(fovx / 2))
    bg = torch.zeros(3, device=device)

    def render_view(c2w_gl, t):
        c2w = c2w_gl.copy()
        c2w[:3, 1:3] *= -1  # to COLMAP's axes, as the reader does
        w2c = np.linalg.inv(c2w)
        view = tf.world_to_view(np.transpose(w2c[:3, :3]), w2c[:3, 3])
        offs = np.array([0.3 * t, -0.2 * t, 0.0], np.float32) if animate else 0.0
        pre = projection.preprocess(
            torch.from_numpy(centers + offs).to(device), cov6, torch.from_numpy(view).to(device),
            torch.from_numpy(view @ projm).to(device), width=size, height=size, tan_fovx=tan,
            tan_fovy=tan)
        out = rasterize_dense(pre.means2d_pix, pre.depths, pre.conics, opac, colors, pre.rect,
                              pre.mask, bg, width=size, height=size)
        return np.clip(out.color.cpu().numpy(), 0, 1)

    for split, count in (("train", n_views), ("test", n_test)):
        frames = []
        for i in range(count):
            t = i / max(count - 1, 1)
            c2w = look_at_c2w(2 * np.pi * i / max(count, 1) * 0.25)
            rgba = np.concatenate([render_view(c2w, t).transpose(1, 2, 0),
                                   np.ones((size, size, 1))], -1)
            Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
                os.path.join(root, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}", "time": t,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    return root


def dense_frame(torch):
    """Screen-space arrays of a seeded frame of DENSE_N gaussians at
    DENSE_SIZE x DENSE_SIZE on the card, through the port's preprocess
    (3-sigma rects, as tests/test_rasterize.py's scenes): (means2d_pix,
    depths, conics, opacities, colors, rect, mask, tiles_touched)."""
    from gs_deformable_tpu_torch.ops import projection
    from gs_deformable_tpu_torch.ops import transforms as tf

    n, size = DENSE_N, DENSE_SIZE
    rng = np.random.default_rng(DENSE_SEED)
    fov = 0.9
    view = np.eye(4, dtype=np.float32)
    full = view @ tf.projection_matrix(0.01, 100.0, fov, fov)
    means = np.stack([rng.uniform(-1.8, 1.8, n), rng.uniform(-1.8, 1.8, n),
                      rng.uniform(2.5, 9.0, n)], -1).astype(np.float32)
    means[: n // 8, 2] = 4.0  # exact depth ties: emission order decides
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.normal(size=(n, 3)) * 0.5 - 2.4).astype(np.float32)
    opac = rng.uniform(0.2, 0.98, n).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).cuda()

    pre = projection.preprocess(dev(means), tf.build_cov3d(dev(s), dev(q)), dev(view),
                                dev(full), width=size, height=size,
                                tan_fovx=float(np.tan(fov / 2)), tan_fovy=float(np.tan(fov / 2)))
    return (pre.means2d_pix, pre.depths, pre.conics, dev(opac), dev(colors), pre.rect, pre.mask,
            pre.tiles_touched)


def dense_check(torch):
    """Phase 15 (a): the tile path (``ops.rasterize.rasterize_arrays``: binning
    with its ordered fills, the composite forward and, under autograd, the
    backward) against the dense oracle on the same screen-space arrays, with
    the tile cull off (n_contrib indexes the uncut tile lists) and on (the
    trainer's default): image rtol 1e-4 / atol 2e-5, final_T rtol 1e-4 / atol
    2e-6, n_contrib exact (cull off), and the gradients of a seeded
    cotangent to means2d, conics, opacities and colours at rtol 5e-4 /
    atol 2e-5 x the leaf's max |g| (tests/test_rasterize.py:64-98)."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.ops.rasterize import rasterize_arrays
    from gs_deformable_tpu_torch.ops.rasterize_dense import rasterize_dense

    n, size = DENSE_N, DENSE_SIZE
    m2d, depths, con, op, col, rect, mask, touched = dense_frame(torch)
    rng = np.random.default_rng(DENSE_SEED + 1)
    gc = torch.from_numpy(rng.normal(size=(3, size, size)).astype(np.float32)).cuda()
    gt = torch.from_numpy(rng.normal(size=(size, size)).astype(np.float32)).cuda()
    bg = torch.tensor([0.15, 0.3, 0.45], device="cuda")
    names = ("means2d", "conics", "opacities", "colors")

    def run(render):
        leaves = [x.clone().requires_grad_(True) for x in (m2d, con, op, col)]
        color, final_t, n_contrib = render(*leaves)
        loss = (color * gc).sum() + (final_t * gt).sum()
        grads = torch.autograd.grad(loss, leaves)
        return color.detach(), final_t.detach(), n_contrib, grads

    def dense(m, c, o, k):
        return rasterize_dense(m, depths, c, o, k, rect, mask, bg, width=size, height=size)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = run(dense)
    torch.cuda.synchronize()
    rec = {"gaussians": n, "size": size, "visible": int(mask.sum()),
           "dense_s": time.perf_counter() - t0,
           "dense_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "pixels_below_t_3e-4": int((ref[1] < 3e-4).sum())}
    for cull in (False, True):
        cfg = config.RasterizeConfig(instance_capacity=1 << 18, tile_cull=cull)
        required = []

        def tiled(m, c, o, k):
            img, t, nc, req, _ = rasterize_arrays(m, depths, c, o, k, rect, touched, bg,
                                                  width=size, height=size, cfg=cfg)
            required.append(int(req))
            return img, t, nc

        got = run(tiled)
        if required[0] > cfg.instance_capacity:
            raise AssertionError(f"dense check: {required[0]} instances overflow the capacity")
        torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=2e-5,
                                   msg=lambda m: f"tile vs dense image (cull {cull}): {m}")
        torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=2e-6,
                                   msg=lambda m: f"tile vs dense final_T (cull {cull}): {m}")
        nc_bad = int((got[2] != ref[2]).sum())
        if not cull and nc_bad:
            raise AssertionError(f"tile vs dense n_contrib differs at {nc_bad} pixels")
        grad_err = {}
        for name, a, b in zip(names, got[3], ref[3]):
            scale = float(b.abs().max()) + 1e-8
            torch.testing.assert_close(a, b, rtol=5e-4, atol=2e-5 * scale,
                                       msg=lambda m: f"tile vs dense d{name} (cull {cull}): {m}")
            grad_err[name] = float((a - b).abs().max()) / scale
        key = "cull" if cull else "no_cull"
        rec[key] = {"instances": required[0],
                    "rgb_max_abs_err": float((got[0] - ref[0]).abs().max()),
                    "final_t_max_abs_err": float((got[1] - ref[1]).abs().max()),
                    "n_contrib_pixels_differing": nc_bad,
                    "grad_max_err_over_scale": grad_err}
        log(f"  tile path (cull {'on' if cull else 'off'}, {required[0]} instances) vs dense: "
            f"rgb {rec[key]['rgb_max_abs_err']:.3g}, final_T "
            f"{rec[key]['final_t_max_abs_err']:.3g}, n_contrib differs at {nc_bad} pixels; "
            f"gradients / scale " + ", ".join(f"{k} {v:.3g}" for k, v in grad_err.items()))
    log(f"  dense oracle: {n} gaussians ({rec['visible']} visible) at {size}x{size}, forward "
        f"and backward {rec['dense_s']:.2f} s, peak {rec['dense_peak_gib']:.2f} GiB; "
        f"{rec['pixels_below_t_3e-4']} pixels end below T 3e-4, where first-hit termination "
        f"decides")
    return rec


class Tee(io.TextIOBase):
    """A text stream that writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        return self.buf.write(s)

    def flush(self):
        self.out.flush()


TRAIN_REPORT = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): L1 [\d.]+ PSNR ([\d.]+)")
RENDER_REPORT = re.compile(r"\[(\w+)\] PSNR: ([\d.]+) SSIM: ([\d.]+)")


def parse_reports(train_text, render_text):
    """The PSNR the trainer prints at each test iteration, ``{set: [[iteration,
    PSNR], ...]}``, and the render CLI's held-out metrics, ``{"psnr_<set>",
    "ssim_<set>"}`` (the lines tools/quality_r04.py reads)."""
    trajectory = {}
    for it, name, psnr in TRAIN_REPORT.findall(train_text):
        trajectory.setdefault(name, []).append([int(it), float(psnr)])
    final = {}
    for name, psnr, ssim in RENDER_REPORT.findall(render_text):
        final[f"psnr_{name}"], final[f"ssim_{name}"] = float(psnr), float(ssim)
    return trajectory, final


def quality_drive(torch, src, model, iterations, warmup, tests, flags=QUALITY_FLAGS,
                  device="cuda", frames=()):
    """``train.main`` on the scene at ``src`` with ``flags``, ``--iterations``,
    ``--warmup_iters`` and ``--test_iterations``, a save at the end, then
    ``render_cli.main`` on the saved model; the PSNR parser on what both
    print.  ``frames``: the step frames whose kernel inputs
    ``recorded_frames`` keeps.  Returns the record (with the kernel launches
    of each CLI run) and the recorder."""
    from gs_deformable_tpu_torch import render_cli
    from gs_deformable_tpu_torch import train as train_cli
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    argv = ["-s", src, "-m", model, "--iterations", str(iterations), "--warmup_iters",
            str(warmup), "--test_iterations", *map(str, tests), "--save_iterations",
            str(iterations), "--device", device, "--disable_viewer", "--quiet", *flags]
    log(f"  train.main({' '.join(argv)})")
    timeline = []
    train_out, render_out = Tee(sys.stdout), Tee(sys.stdout)
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(train_out), recorded_frames(torch, frames) as rec:
        train_cli.main(argv, timeline)
    if device == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = launch_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(render_out):
        psnrs = render_cli.main(["-m", model, "--device", device, "--quiet"])
    eval_s = time.perf_counter() - t0
    render_launches = launch_counts()
    trajectory, final = parse_reports(train_out.buf.getvalue(), render_out.buf.getvalue())
    for name in ("test", "train"):
        if [it for it, _ in trajectory.get(name, [])] != sorted(tests):
            raise AssertionError(f"the trainer's {name} reports {trajectory.get(name)}, "
                                 f"expected one at each of {sorted(tests)}")
        if not {f"psnr_{name}", f"ssim_{name}"} <= set(final):
            raise AssertionError(f"the render CLI printed no {name} PSNR/SSIM: {final}")
        if abs(final[f"psnr_{name}"] - float(np.mean(psnrs[name]))) > 6e-4:
            raise AssertionError(f"parsed {name} PSNR {final[f'psnr_{name}']}, the render CLI "
                                 f"computed {np.mean(psnrs[name])}")
    steps = [r for r in timeline if r["stage"] == "steps"]
    loss = loss_by_iteration(timeline)  # every iteration's loss, finite
    if sorted(loss) != list(range(1, iterations + 1)) or not np.isfinite(
            list(loss.values())).all():
        raise AssertionError("the trainer's losses miss iterations or are not finite")
    windows = [[r["from"], r["to"], r["ms"] / (r["to"] - r["from"] + 1)] for r in steps]

    def ms_per_step(lo, hi):
        inside = [ms for a, b, ms in windows if lo <= a and b <= hi]
        return float(np.median(inside)) if inside else None

    def stage(name, *keys):
        return [[r["iteration"], *(r[k] for k in keys)] for r in timeline if r["stage"] == name]

    densify = stage("densify", "n_alive", "n_cloned", "n_split", "n_pruned", "n_dropped")
    out = {"iterations": iterations, "warmup": warmup, "argv": argv,
           "train_wall_s": train_s, "eval_wall_s": eval_s, "launches": train_launches,
           "render_launches": render_launches,
           "psnr_trajectory_test": trajectory["test"],
           "psnr_trajectory_train": trajectory["train"], **final,
           "densify": densify, "peak_alive": max([d[1] for d in densify], default=None),
           "resets": [r["iteration"] for r in timeline if r["stage"] == "reset"],
           "instance_growths": stage("instance_growth", "required", "capacity",
                                     "aligned_slack"),
           "capacity_growths": stage("capacity_growth", "capacity"),
           "test_report_ms": stage("test_report", "ms"),
           "ms_per_step": ms_per_step(1, iterations),
           "ms_per_step_warmup": ms_per_step(11, warmup),
           "ms_per_step_past_warmup": ms_per_step(warmup + 1, iterations),
           "step_windows": windows}
    log(f"  trained {iterations} iterations in {train_s:.1f} s, ms/step between drains: median "
        f"{out['ms_per_step']}, in warmup {out['ms_per_step_warmup']}, past it "
        f"{out['ms_per_step_past_warmup']}; render CLI {eval_s:.1f} s")
    log(f"  PSNR trajectory test {trajectory['test']}  train {trajectory['train']}")
    log("  render CLI: " + ", ".join(f"{k} {v}" for k, v in final.items()))
    log(f"  gaussians after each densify [iteration, alive, cloned, split, pruned, dropped]: "
        f"{densify}; peak {out['peak_alive']}; resets at {out['resets']}")
    log(f"  instance-capacity growths [iteration, required, capacity, slack]: "
        f"{out['instance_growths']}; capacity growths {out['capacity_growths']}")
    return out, rec


def quality_phase(torch, timer, root, iters=QUALITY_ITERS, warmup=QUALITY_WARMUP,
                  tests=QUALITY_TESTS, checks=True):
    """Phase 15: (a) the tile path against the dense oracle, (b) the quality
    scene built on the card with the dense oracle, (c) the trainer and render
    CLIs at the recorded TPU run's regime to 3,100 iterations, gated on the
    held-out PSNR there, and rows 1, 4, 7 and 8 held against their plain
    versions on the step after the opacity reset.  With ``checks`` off
    (``--quality_full``) only (b) and the run, with no gate."""
    from gs_deformable_tpu_torch import config

    rec = {"card": card_line()}
    log(f"  {rec['card']}")
    if checks:
        log("  (a) the tile path against the dense oracle")
        rec["dense"] = dense_check(torch)
    src, model = os.path.join(root, "quality_scene"), os.path.join(root, "quality_model")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blender_scene(torch, src, n_views=QUALITY_TRAIN, n_test=QUALITY_TEST, size=QUALITY_SIZE,
                  n_blobs=QUALITY_BLOBS, animate=True, seed=QUALITY_SEED)
    rec["scene_build_s"] = time.perf_counter() - t0
    log(f"  (b) the scene ({QUALITY_TRAIN} + {QUALITY_TEST} views of {QUALITY_SIZE}x"
        f"{QUALITY_SIZE}, {QUALITY_BLOBS} blobs, seed {QUALITY_SEED}) drawn by the dense oracle "
        f"in {rec['scene_build_s']:.2f} s")
    # Iteration i's step is composite-forward call i - 1, after the report
    # views of each test iteration before it (20 test and 5 train at most).
    report_views = min(QUALITY_TEST, 20) + min(QUALITY_TRAIN, 5)
    after_reset = QUALITY_RESET + 1
    frame = after_reset - 1 + report_views * sum(t < after_reset for t in tests)
    run, kept = quality_drive(torch, src, model, iters, warmup, tests,
                              frames=(frame,) if checks else ())
    rec["run"], counts = run, run["launches"]
    for what, got, forward, backward in (
            ("trainer", counts, iters + report_views * len(tests), iters),
            ("render CLI", run["render_launches"], QUALITY_TRAIN + QUALITY_TEST, 0)):
        want = {"composite_forward": forward, "composite_backward": backward,
                "ordered_prefix_fill": 2 * forward, "ordered_place_i32": forward}
        if raster_launches(got) != want:
            raise AssertionError(f"{what} launches {got}, expected {want}")
    if not checks:
        return rec
    if QUALITY_RESET not in run["resets"]:
        raise AssertionError(f"no opacity reset at {QUALITY_RESET}: {run['resets']}")
    rec["kernel_checks"] = recorded_checks(torch, timer, kept, frame, counts, config.Config(),
                                           f"quality step {after_reset}", backward=True)
    at = dict(run["psnr_trajectory_test"])[iters]
    rec["gate"] = {"test_psnr": at, "at": iters, "min": QUALITY_GATE}
    if not at >= QUALITY_GATE:
        raise AssertionError(f"held-out test PSNR {at} at {iters} under the gate {QUALITY_GATE}")
    log(f"  (c) held-out test PSNR at {iters}: {at} >= {QUALITY_GATE}")
    return rec


def _cli_template(torch, training, cfg, src, model, it):
    """A train state shaped as the trainer's checkpoint at ``it``: its
    capacity read from the file."""
    from gs_deformable_tpu_torch.models.gaussians import init_from_points

    with np.load(os.path.join(model, "ckpt_save", f"chkpnt_{it}.npz")) as f:
        cap = f[".gaussians/.xyz"].shape[0]
    pts = np.random.default_rng(0).uniform(0, 1, (8, 3)).astype(np.float32)
    state = init_from_points(pts, pts, cap, cfg.model.sh_degree)
    net, latent = training.init_nets(cfg, 3, "cuda")
    return training.init_train_state(state, net, 0, latent)


# -- phase 16: CUDA-graph replay -----------------------------------------------

GRAPH_REPLAYS = 20  # replays of each graph
GRAPH_FILL_SETS = 21  # input sets of each fill: odd, so two graphs in turns meet them all
GRAPH_TIMES = (0.5, 0.2, 0.8)  # the train frames fed to the composite graphs (phase 7's first)


def moved_drops(K, n, seed):
    """n sorted unique int32 positions for an output of K, seeded as
    tests/fill_cases.py's ``moved_drops``: a seeded number of negative rows,
    random positions in [0, K), then rows >= K, so the drops at both ends
    move from set to set while n stays."""
    rng = np.random.default_rng(seed)
    lead, tail = (int(x) for x in rng.integers(0, n // 8 + 1, 2))
    mid = min(n - lead - tail, K)
    tail = n - lead - mid
    p = np.sort(rng.choice(K, mid, replace=False))
    return np.concatenate([np.arange(-lead, 0), p, K + np.arange(tail)]).astype(np.int32)


def fill_values(n, C, seed):
    """(n, C) int32 in [-2^20, 2^20), seeded as tests/fill_cases.py's ``values``."""
    return np.random.default_rng(seed + 1).integers(-(1 << 20), 1 << 20, (n, C)).astype(np.int32)


def capture(torch, fn):
    """One eager call of ``fn`` (it warms the kernel), then one call captured
    into a CUDA graph on torch's default capture stream: (graph, the output
    tensor that every replay rewrites)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def replay_check(torch, graphs, buffers, sets, eager, off):
    """Replay ``graphs`` in turns, GRAPH_REPLAYS times each.  Before each
    replay the next input set (cyclically) is copied into that graph's
    static buffers; after it, one eager call of the same kernel on the same
    inputs and stream.  ``off(got, i)`` counts the elements of a result on
    set i that break its bar.  Returns (replays, elements off); there are as
    many eager calls as replays."""
    n = GRAPH_REPLAYS * len(graphs)
    bad = 0
    for r in range(n):
        (graph, out), bufs, i = graphs[r % len(graphs)], buffers[r % len(graphs)], r % len(sets)
        for buf, x in zip(bufs, sets[i]):
            buf.copy_(x)
        graph.replay()
        now = eager(*bufs)
        torch.cuda.synchronize()
        bad += off(out, i) + off(now, i)
    return n, bad


def graph_fill(torch, timer, call, plain, sets, K, n_graphs):
    """``call(pos, values, K)`` captured into ``n_graphs`` graphs and replayed
    on ``sets``: every replay and eager call bitwise ``plain``; ms per replay
    (for the prefix fill, the captured zeroing of its status buffer
    included) against ms per eager call."""
    refs = {}

    def off(got, i):
        if i not in refs:
            refs[i] = plain(*sets[i], K)
        return int((got != refs[i]).sum())

    buffers = [tuple(x.clone() for x in sets[k]) for k in range(n_graphs)]
    graphs = [capture(torch, lambda b=b: call(*b, K)) for b in buffers]
    replays, bad = replay_check(torch, graphs, buffers, sets, lambda *b: call(*b, K), off)
    return {"name": call.__name__, "K": K, "graphs": n_graphs, "replays": replays,
            "eager_calls": replays, "elements_off": bad,
            "replay_ms": timer.ms(graphs[0][0].replay, 50),
            "eager_ms": timer.ms(lambda: call(*buffers[0], K), 50)}


def graph_fills(torch, timer, Kp):
    """The prefix fill at phase 4's two render shapes, two graphs each
    captured one after the other, and the place, one graph, each fed
    GRAPH_FILL_SETS position sets whose drops move."""
    from gs_deformable_tpu_torch.ops.kernels import ordered_fill as of

    recs = []
    for label, n, K, C in (("front fills", CAPACITY, INSTANCE_CAPACITY, 4),
                           ("relayout fills", NTILES, INSTANCE_CAPACITY, 2),
                           ("relayout place", INSTANCE_CAPACITY, Kp, 0)):
        sets = [(torch.from_numpy(moved_drops(K, n, s)).cuda(),
                 torch.from_numpy(fill_values(n, C, s) if C else fill_values(n, 1, s)[:, 0]).cuda())
                for s in range(GRAPH_FILL_SETS)]
        if C:
            rec = graph_fill(torch, timer, of.ordered_prefix_fill, of.prefix_fill_plain, sets,
                             K, 2)
        else:
            rec = graph_fill(torch, timer, of.ordered_place_i32, of.place_plain, sets, K, 1)
        rec.update(shape=label, n=n, C=C or None)
        log(f"  {rec['name']} {label} (n={n} K={K}{f' C={C}' if C else ''}): {rec['graphs']} "
            f"graph(s), {rec['replays']} replays and {rec['eager_calls']} eager calls checked "
            f"bitwise, {rec['elements_off']} elements off; {rec['replay_ms']:.4f} ms a replay, "
            f"{rec['eager_ms']:.4f} ms an eager call")
        recs.append(rec)
    return recs


def rows_off(torch, got, ref):
    """Elements of (16, Kp) gradient rows outside phase 7's bar: rows 0-8 at
    rtol 5e-4 / atol 2e-5 x the row's max |ref|, rows 9-15 exactly 0."""
    g, r = got[:GRAD_FIELDS], ref[:GRAD_FIELDS]
    tol = 2e-5 * (r.abs().amax(dim=1, keepdim=True) + 1e-30) + 5e-4 * r.abs()
    return int((~((g - r).abs() <= tol)).sum()) + int(got[GRAD_FIELDS:].ne(0).sum())


def graph_composite(torch, device="cuda"):
    """The composite forward and backward at phase 7's 800x800 train shapes,
    fed the train frames at GRAPH_TIMES in turns: each forward replay and
    eager call bitwise its plain version, each backward bitwise the eager
    kernel's first result on that frame and within phase 7's bar of the
    plain version."""
    from gs_deformable_tpu_torch import config
    from gs_deformable_tpu_torch.ops.kernels import composite as comp

    cfg = train_cfg(config, packed=False)
    ts, _, _, _, (tanx, tany) = train_setup(torch, cfg, N_GAUSS, CAPACITY, TRAIN_W, TRAIN_H,
                                            device)
    fwd_sets, bwd_sets = [], []
    for t in GRAPH_TIMES:
        cam = camera(TRAIN_W, TRAIN_H, t, device)[0]
        splats_t, binning, gx = frame_tiles(torch, ts.gaussians, ts.net, cam, tanx, tany, cfg,
                                            TRAIN_W, TRAIN_H, TRAIN_ITERATION)
        if int(binning.required) > TRAIN_ICAP:
            raise AssertionError(f"graph frame at time {t} overflows: {int(binning.required)}")
        fwd_sets.append((splats_t, binning.tile_chunk_start, binning.tile_count))
    del ts
    kw = dict(grid_x=gx, **composite_kw(cfg))
    fwd_ref = [comp.composite_forward_plain(*x, **kw) for x in fwd_sets]
    for i, (x, out) in enumerate(zip(fwd_sets, fwd_ref)):
        grad = torch.zeros_like(out)
        grad[:, 0:4] = torch.from_numpy(np.random.default_rng(7 + i).normal(
            size=(out.shape[0], 4, 256)).astype(np.float32)).to(device)
        bwd_sets.append((*x, out, grad))
    bwd_ref = [comp.composite_backward_plain(*x, **kw) for x in bwd_sets]
    bwd_first = [comp.composite_backward(*x, **kw) for x in bwd_sets]
    torch.cuda.synchronize()
    recs = []
    for name, sets, call, off in (
            ("composite_forward", fwd_sets, comp.composite_forward,
             lambda got, i: int((got.view(torch.int32) != fwd_ref[i].view(torch.int32)).sum())),
            ("composite_backward", bwd_sets, comp.composite_backward,
             lambda got, i: (int((got.view(torch.int32) != bwd_first[i].view(torch.int32)).sum())
                             + rows_off(torch, got, bwd_ref[i])))):
        buffers = [tuple(x.clone() for x in sets[0])]
        graphs = [capture(torch, lambda b=buffers[0], call=call: call(*b, **kw))]
        replays, bad = replay_check(torch, graphs, buffers, sets,
                                    lambda *b, call=call: call(*b, **kw), off)
        recs.append({"name": name, "shape": "800x800 train frames", "frames": len(sets),
                     "Kp": sets[0][0].shape[1], "replays": replays, "eager_calls": replays,
                     "elements_off": bad})
        log(f"  {name} (800x800 train frames at times {GRAPH_TIMES}, Kp "
            f"{sets[0][0].shape[1]}): {replays} replays and {replays} eager calls checked "
            f"({'bitwise' if name == 'composite_forward' else 'bitwise the eager kernel, phase 7 bar'}"
            f"), {bad} elements off")
        del graphs
    return recs


def mark_visible_check(torch, device="cuda"):
    """``ops.projection.mark_visible`` on phase 3's 100k-gaussian scene, its
    deformed means at phase 3's first frame time, under three cameras: phase
    3's, one moved 6 units into the cloud and one turned 0.7 rad at its
    middle: bitwise the near cull of the preprocess that the render path
    runs (its depths > 0.2), and every gaussian preprocess keeps visible."""
    from gs_deformable_tpu_torch import config, renderer
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.ops import projection, rasterize
    from gs_deformable_tpu_torch.ops import transforms as tf
    from gs_deformable_tpu_torch.renderer import CameraArrays

    cfg = render_cfg(config)
    state = scene(torch, N_GAUSS, CAPACITY, device=device)
    net = OffsetNet(init_offset_params(0, cfg.deform), cfg.deform, device=device)
    _, tanx, tany = camera(W, H, 0.1, device)
    proj = tf.projection_matrix(0.01, 100.0, 2 * np.arctan(tanx), 2 * np.arctan(tany))
    c, s = np.cos(0.7), np.sin(0.7)
    views = {"phase 3's": np.eye(4, dtype=np.float32),
             "moved into the cloud": np.eye(4, dtype=np.float32),
             "turned in the cloud": np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                                              [0, 0, 0, 1]], np.float32)}
    views["moved into the cloud"][3, 2] = -6.0
    views["turned in the cloud"][3] = [-7.0 * s, 0.0, -7.0 * c, 1.0]  # centre (0, 0, 7)
    recs = []
    for label, view in views.items():
        centre = np.linalg.inv(view.astype(np.float64))[3, :3].astype(np.float32)
        cam = CameraArrays.from_numpy(view, view @ proj, centre, 0.1, device=device)
        with torch.no_grad():
            m, sc, r, o, shs, _ = renderer.deformed_attributes(state, net, cam.time, ITERATION,
                                                               cfg)
            ss = rasterize.screen_space(m, sc, r, o, shs, viewmatrix=cam.world_view,
                                        projmatrix=cam.full_proj, campos=cam.camera_center,
                                        width=W, height=H, tan_fovx=tanx, tan_fovy=tany,
                                        sh_degree=3, alive=state.alive, cfg=cfg.raster)
        vis = projection.mark_visible(m, cam.world_view, cam.full_proj)
        near = ss.pre.depths > projection.NEAR_Z
        alive = state.alive
        rec = {"camera": label, "visible": int((vis & alive).sum()), "alive": int(alive.sum()),
               "kept_by_preprocess": int(ss.pre.mask.sum()),
               "differ_from_near_cull": int((vis != near).sum()),
               "kept_but_not_visible": int((ss.pre.mask & ~vis).sum())}
        log(f"  mark_visible, camera {label}: {rec['visible']} of {rec['alive']} gaussians "
            f"visible, preprocess keeps {rec['kept_by_preprocess']}; "
            f"{rec['differ_from_near_cull']} differ from its near cull")
        if rec["differ_from_near_cull"] or rec["kept_but_not_visible"]:
            raise AssertionError(f"mark_visible disagrees with preprocess: {rec}")
        recs.append(rec)
    if not 0 < min(r["visible"] for r in recs[1:]) < N_GAUSS:
        raise AssertionError(f"the cameras in the cloud should see part of it: {recs}")
    return recs


def graph_phase(torch, timer, card, Kp):
    """Phase 16: each of the four kernels captured into CUDA graphs and
    replayed on new inputs, with eager calls between the replays; then
    mark_visible against the render path's near cull."""
    fills = graph_fills(torch, timer, Kp)
    comp = graph_composite(torch)
    visible = mark_visible_check(torch)
    recs = fills + comp
    bad = sum(r["elements_off"] for r in recs)
    times = "; ".join(f"{r['name']} {r['shape']} {r['replay_ms']:.4f} ms a replay vs "
                      f"{r['eager_ms']:.4f} eager" for r in fills)
    log(f"  graph replay: {sum(r['replays'] for r in recs)} replays and "
        f"{sum(r['eager_calls'] for r in recs)} eager calls checked; any element differed: "
        f"{bad > 0}; {times} ({card})")
    if bad:
        raise AssertionError(f"CUDA-graph replays or eager calls broke their bars: {recs}")
    return {"kernels": recs, "mark_visible": visible}


def sums_within_fp32(sums, values):
    """Largest |column sum - float64 sum| over 2^-24 x the column's sum of
    magnitudes; raises past n (recursive fp32 summation's bound)."""
    v = values.double()
    ratio = float(((sums.double() - v.sum(0)).abs() / (2.0 ** -24 * v.abs().sum(0))).max())
    if not ratio <= v.shape[0]:
        raise AssertionError(f"column sums off by {ratio} x 2^-24 of their magnitude")
    return ratio


def trunk_phase(torch, timer):
    """Phase 17: the trunk's epilogues bitwise their plain versions at the
    main path's shapes, timed, and the heads' split."""
    from gs_deformable_tpu_torch.models import deform as tdeform
    from gs_deformable_tpu_torch.ops.kernels import trunk as tk

    calls = {"trunk_bias_relu": [], "trunk_relu_mask": []}
    for n in TRUNK_ROWS:
        g = torch.Generator(device="cuda").manual_seed(n)
        for off in (0, TRUNK_SKIP):
            ld = off + TRUNK_WIDTH
            label = f"{n} x {TRUNK_WIDTH}" + (f" in a {ld}-wide operand" if off else "")
            y = torch.randn((n, TRUNK_WIDTH), device="cuda", generator=g)
            b = torch.randn((TRUNK_WIDTH,), device="cuda", generator=g) * 0.1
            act = torch.zeros((n, ld), device="cuda", dtype=torch.bfloat16)
            a = act[:, off:]
            tk.bias_relu_bf16(y, b, a)
            torch.cuda.synchronize()
            if not torch.equal(a, tk.bias_relu_plain(y, b)):
                raise AssertionError(f"trunk_bias_relu ({label}) differs from its plain version")
            rec = {"shape": label, "n": n, "C": TRUNK_WIDTH, "ld": ld, "max_abs_err": 0.0,
                   "ms": timer.ms(lambda: tk.bias_relu_bf16(y, b, a), 20),
                   "plain_ms": timer.ms(lambda: tk.bias_relu_plain(y, b), 20),
                   "bound_ms": bytes_ms(n * TRUNK_WIDTH * (4 + 2)), "bound_by": "bytes"}
            calls["trunk_bias_relu"].append(rec)
            log(f"  trunk_bias_relu {label}: kernel {rec['ms']:.4f} ms  plain "
                f"{rec['plain_ms']:.4f}  bound {rec['bound_ms']:.4f}  bitwise equal")
            del y
            cot = torch.randn((n, ld), device="cuda", generator=g)[:, off:]
            out = torch.empty((n, TRUNK_WIDTH), device="cuda", dtype=torch.bfloat16)
            for rounded in (True, False):
                sums = tk.relu_mask_bf16(cot, a, out, rounded)
                ref, _ = tk.relu_mask_plain(cot, a, rounded)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"trunk_relu_mask ({label}, rounded {rounded}) "
                                         f"differs from its plain version")
                ratio = sums_within_fp32(sums, ref.float() if rounded
                                         else torch.where(a > 0, cot, 0))
                rec = {"shape": label, "n": n, "C": TRUNK_WIDTH, "ld": ld, "rounded": rounded,
                       "max_abs_err": 0.0, "sum_err_over_2^-24_magnitude": ratio,
                       "ms": timer.ms(lambda: tk.relu_mask_bf16(cot, a, out, rounded), 20),
                       "plain_ms": timer.ms(lambda: tk.relu_mask_plain(cot, a, rounded), 20),
                       "bound_ms": bytes_ms(n * TRUNK_WIDTH * (4 + 2 + 2)), "bound_by": "bytes"}
                calls["trunk_relu_mask"].append(rec)
                log(f"  trunk_relu_mask {label} rounded {rounded}: kernel {rec['ms']:.4f} ms  "
                    f"plain {rec['plain_ms']:.4f}  bound {rec['bound_ms']:.4f}  bitwise equal, "
                    f"sums within {ratio:.1f} x 2^-24 of their magnitude")
            del cot, out, act, a
    n = TRUNK_ROWS[0]
    cot = torch.randn((n, TRUNK_HEADS), device="cuda") * 1e-3
    parts = tdeform._split3(cot, TRUNK_HEAD_COLS).double()
    c = TRUNK_HEAD_COLS
    exact = torch.equal((parts[:, :TRUNK_HEADS] + parts[:, c:c + TRUNK_HEADS])
                        + parts[:, 2 * c:2 * c + TRUNK_HEADS], cot.double())
    if not exact or bool(parts[:, TRUNK_HEADS:c].any()):
        raise AssertionError("the heads' three-way split is not exact")
    split = {"shape": f"{n} x {TRUNK_HEADS} -> 3 x {c}", "exact": True,
             "ms": timer.ms(lambda: tdeform._split3(cot, TRUNK_HEAD_COLS), 20),
             "bound_ms": bytes_ms(n * (TRUNK_HEADS * 4 + 3 * c * 2)), "bound_by": "bytes"}
    log(f"  heads' split {split['shape']}: {split['ms']:.4f} ms  bound {split['bound_ms']:.4f}  "
        f"exact")
    return {"calls": calls, "heads_split": split}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    from gs_deformable_tpu_torch import _build, config
    from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
    from gs_deformable_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from gs_deformable_tpu_torch.training import make_eval_render

    t_start = time.time()
    phase_s = {}  # seconds from the start to each phase's start

    def phase(text):
        at = phase_s[text.split(":")[0]] = time.time() - t_start
        log(f"{text}  [{at:.1f} s]")

    card = card_line()
    phase("phase 1: device")
    log(card)
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")

    phase("phase 2: build kernels")
    t0 = time.time()
    _build.build_all()
    build_s = time.time() - t0
    log(f"  built {list(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")
    from gs_deformable_tpu_torch.ops.kernels import composite as comp_kernels

    occupancy = comp_kernels.occupancy()
    log(f"  blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, 256 "
        f"threads a block): {occupancy}")

    phase("phase 3: render path at 1920x1080, 100k gaussians, 8x256 bf16 offset net")
    cfg = render_cfg(config)
    state = scene(torch, N_GAUSS, CAPACITY)
    net = OffsetNet(init_offset_params(0, cfg.deform), cfg.deform, device="cuda")
    Kp = kp_of(cfg, W, H)
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
    want = launches_want(RENDER_LAUNCHES, FRAMES, cfg.deform.depth, backward=False)
    log(f"  launches over {FRAMES} frames: {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    from gs_deformable_tpu_torch.renderer import render

    reqs = []
    for c in cams[:2]:
        with torch.no_grad():
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
    frames = iter(cams[:2] * 2)
    breakdown = (profile_calls(torch, lambda: run(state, net, next(frames), bg, ITERATION), 2,
                               frame_med, "frame") if PROFILE else None)
    log(f"  frames: {[round(x, 3) for x in frame_ms]} ms; median {frame_med:.3f} ms/frame; "
        f"required instances {reqs[0][0]} / {INSTANCE_CAPACITY}, aligned {reqs[0][1]} / {Kp}")

    phase("phase 4: kernels vs plain versions at the render-path shapes")
    timer = Timer(torch)
    front, relay, place = render_fills(torch, timer, max(1, round(reqs[0][0] / N_GAUSS)),
                                       max(1, round(reqs[0][0] / NTILES)), Kp)
    splats_t, binning, gx = frame_tiles(torch, state, net, cams[0], tanx, tany, cfg)
    comp = check_composite(torch, timer, splats_t, binning, gx, cfg)

    phase("phase 5: reduced scene, card vs CPU")
    reduced = reduced_scene_check(torch)
    del state, net, splats_t, binning

    phase(f"phase 6: train path at {TRAIN_W}x{TRAIN_H}, 100k gaussians, 8x256 bf16 offset net, "
        f"iteration {TRAIN_ITERATION}")
    train, ts, tcam, tcfg, (ttanx, ttany) = train_phase(torch)
    train_counts = train["launches"]
    learning = learning_phase(torch)

    phase("phase 7: ordered fills and the composite backward at the train-path shapes")
    splats_t, binning, gx = frame_tiles(torch, ts.gaussians, ts.net, tcam, ttanx, ttany, tcfg,
                                        TRAIN_W, TRAIN_H, TRAIN_ITERATION)
    bwd = check_backward(torch, timer, splats_t, binning, gx, tcfg)
    treq = int(binning.num_instances)
    del ts, splats_t, binning
    train_fill = train_fills(torch, timer, max(1, round(treq / N_GAUSS)),
                             max(1, round(treq / TRAIN_TILES)))

    phase("phase 8: reduced train step, card vs CPU")
    reduced_step = reduced_step_check(torch)

    phase(f"phase 9: the bench's train workload: packed (sub_chunk {PACKED_SUB}, slack -1), "
        f"make_chunk_step, {CHUNKS} chunks of {CHUNK_MAX} steps")
    chunked = chunk_phase(torch)
    chunk_counts = chunked["launches"]

    phase("phase 10: packed vs mixed, rows 5 and 6 vs their plain versions, packed sort")
    packed, pfwd, pbwd = packed_checks(torch, timer)

    with tempfile.TemporaryDirectory() as root:
        phase(f"phase 11: scene to model: a {SCENE_SIZE}x{SCENE_SIZE} D-NeRF scene on disk, "
              f"Scene, init_from_points, train with densify, reset and growth, eval, save, "
              f"reload")
        scene_rec = scene_phase(torch, timer, root)
        phase(f"phase 12: the trainer and render CLIs on phase 11's scene: se3 with the "
              f"opacity gate, {CLI_ITERS} iterations, warmup {CLI_WARMUP}")
        cli_rec = cli_phase(torch, timer, root)
        phase(f"phase 13: the native COLMAP reader on a model of {COLMAP_IMAGES} images x "
              f"{COLMAP_OBS} observations and {COLMAP_POINTS} points3D")
        os.makedirs(os.path.join(root, "colmap"))
        colmap_rec = colmap_phase(torch, os.path.join(root, "colmap"))
        phase(f"phase 14: the mesh on phase 11's scene: (a) 1x1 over NCCL, (b) 1x2 and (c) 2x2 "
              f"ranks on the one card over gloo, (d) the trainer with --n_model 2 under "
              f"torch.distributed.run")
        log(f"  {card}")
        mesh_rec = mesh_phase(torch, root)
        phase(f"phase 15: the dense oracle and the quality path: (a) the tile path vs the dense "
              f"oracle, (b) a {QUALITY_SIZE}x{QUALITY_SIZE} scene drawn by it, (c) the trainer "
              f"and render CLIs to {QUALITY_ITERS} iterations, warmup {QUALITY_WARMUP}")
        quality_rec = quality_phase(torch, timer, root)
    log("  phase 12 (d): a reduced se3 + gate step, card vs CPU:")
    cli_rec["reduced_step"] = reduced_step_check(torch, deform_mode="se3", use_opacity_mask=True)

    phase("phase 16: the four kernels captured into CUDA graphs and replayed on new inputs, "
          "eager calls between; mark_visible against the render path's near cull")
    graph_rec = graph_phase(torch, timer, card, Kp)
    graph_rec["seconds"] = time.time() - t_start - phase_s["phase 16"]
    log(f"  phase 16 took {graph_rec['seconds']:.1f} s")

    phase("phase 17: the deformation trunk's epilogues at the main path's shapes, the heads' "
          "split")
    log(f"  {card}")
    trunk_rec = trunk_phase(torch, timer)

    # "launches": the path each kernel entry belongs to: the train steps of
    # phase 6 (a) for the chunk-aligned layout, the chunked packed train loop
    # of phase 9 for the packed entries; "launches_chunked": phase 9;
    # "launches_render": the render path of phase 3; "launches_cli": the
    # trainer CLI's run of phase 12; "launches_quality": phase 15's trainer run.
    kernels = [
        {"name": "composite_forward", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/composite.py:272",
         "launches": train_counts["composite_forward"],
         "launches_render": counts["composite_forward"],
         "launches_chunked": chunk_counts["composite_forward"],
         "launches_cli": cli_rec["launches"]["composite_forward"],
         "max_abs_err": max(comp["max_abs_err"], bwd["forward_rgb_max_abs_err"],
                            bwd["forward_final_t_max_abs_err"]),
         "ms": comp["ms"], "plain_ms": comp["plain_ms"], "bound_ms": comp["bound_ms"],
         "bound_by": comp["bound_by"], "library_ms": None,
         "blocks_per_sm": occupancy["composite_forward"], "calls": [comp]},
        *fill_entries(front, relay, place, train_fill, {
            k: {"launches": train_counts[k], "launches_render": counts[k],
                "launches_chunked": chunk_counts[k], "launches_cli": cli_rec["launches"][k]}
            for k in ("ordered_prefix_fill", "ordered_place_i32")}),
        {"name": "composite_backward", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/composite_bwd.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/stream_composite.py:168",
         "launches": train_counts["composite_backward"],
         "launches_render": counts["composite_backward"],
         "launches_chunked": chunk_counts["composite_backward"],
         "launches_cli": cli_rec["launches"]["composite_backward"],
         "max_abs_err": bwd["max_abs_err"],
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": None,
         "blocks_per_sm": occupancy["composite_backward"], "calls": [bwd]},
        {"name": "composite_forward_packed", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/packed_composite.py:108",
         "launches": chunk_counts["composite_forward"], "max_abs_err": pfwd["max_abs_err"],
         "ms": pfwd["ms"], "plain_ms": pfwd["plain_ms"], "bound_ms": pfwd["bound_ms"],
         "bound_by": pfwd["bound_by"], "library_ms": None,
         "blocks_per_sm": occupancy["composite_forward"], "calls": [pfwd]},
        {"name": "composite_backward_packed", "route": "cuda",
         "source": "gs_deformable_tpu_torch/csrc/composite_bwd.cu",
         "replaces": "gs_deformable_tpu/ops/pallas/packed_composite.py:269",
         "launches": chunk_counts["composite_backward"], "max_abs_err": pbwd["max_abs_err"],
         "ms": pbwd["ms"], "plain_ms": pbwd["plain_ms"], "bound_ms": pbwd["bound_ms"],
         "bound_by": pbwd["bound_by"], "library_ms": None,
         "blocks_per_sm": occupancy["composite_backward"], "calls": [pbwd]},
    ]
    # Phase 17: the trunk's epilogues (no TPU counterpart: XLA fuses the bias,
    # ReLU and casts into its dot); the first call of each is the cell-4
    # shape, 1,048,576 x 256, the "bfloat16" tier's for the mask.
    for name, calls in trunk_rec["calls"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": "gs_deformable_tpu_torch/csrc/trunk.cu",
            "replaces": None, "launches": train_counts[name], "launches_render": counts[name],
            "launches_chunked": chunk_counts[name], "launches_cli": cli_rec["launches"][name],
            "launches_quality": quality_rec["run"]["launches"][name], "max_abs_err": 0.0,
            **{k: calls[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "calls": calls})
    # The band frames that phase 14's ranks recorded inside their sharded
    # runs, each rank's one frame held against the plain versions, and the
    # launches of each rank's 10 steps.
    mesh_ranks = mesh_rec["b"]["ranks"] + mesh_rec["c"]["ranks"]
    for entry in kernels:
        if entry["name"] in STEP_LAUNCHES:
            entry["launches_mesh_rank"] = mesh_ranks[0]["launches"][entry["name"]]
            entry["band_frames"] = [
                {k: x["band_frame"][k] for k in ("label", "tiles", "Kp", "instances")}
                | ({"max_err_over_row_scale": x["band_frame"]["backward_max_err_over_row_scale"]}
                   if entry["name"] == "composite_backward" else {"bitwise_equal_plain": True})
                for x in mesh_ranks]
    # Phase 15: each kernel of the step on the recorded step after the
    # opacity reset, its launches in the quality run, and the tile path
    # (these four kernels) against the dense oracle.
    qc, dense = quality_rec["kernel_checks"], quality_rec["dense"]
    comp = qc["composite"]
    quality_step = {
        "composite_forward": {"shape": comp["shape"], "instances": comp["instances"],
                              "ms": comp["forward_ms"], "bitwise_equal_plain": True},
        "composite_backward": {k: comp[k] for k in (
            "shape", "instances", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_err_over_row_scale")},
        **{name: [{k: r[k] for k in ("n", "K", "ms", "bound_ms", "max_abs_err")}
                  for r in qc["fills"] if r["name"] == name]
           for name in ("ordered_prefix_fill", "ordered_place_i32")}}
    sides = [dense["no_cull"], dense["cull"]]
    vs_dense = {"gaussians": dense["gaussians"], "size": dense["size"],
                "instances": dense["no_cull"]["instances"],
                "rgb_max_abs_err": max(x["rgb_max_abs_err"] for x in sides),
                "final_t_max_abs_err": max(x["final_t_max_abs_err"] for x in sides),
                "n_contrib_pixels_differing": dense["no_cull"]["n_contrib_pixels_differing"],
                "grad_max_err_over_scale": max(max(x["grad_max_err_over_scale"].values())
                                               for x in sides)}
    for entry in kernels:
        if entry["name"] in STEP_LAUNCHES:
            entry["launches_quality"] = quality_rec["run"]["launches"][entry["name"]]
            entry["quality_step"] = quality_step[entry["name"]]
            entry["vs_dense_oracle"] = vs_dense
    # Phase 16: each kernel's CUDA-graph replays (a prefix-fill row per shape).
    for entry in kernels:
        replays = [r for r in graph_rec["kernels"] if r["name"] == entry["name"]]
        if replays:
            entry["graph_replay"] = replays
    record = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "blocks_per_sm": occupancy, "frames": FRAMES, "frame_ms": frame_ms,
        "frame_ms_median": frame_med, "required_instances": reqs[0][0],
        "required_aligned": reqs[0][1], "instance_capacity": INSTANCE_CAPACITY, "Kp": Kp,
        "reduced": reduced, "train": train, "learning": learning,
        "reduced_step": reduced_step, "chunked": chunked, "packed": packed,
        "scene": scene_rec, "cli": cli_rec, "colmap": colmap_rec, "mesh": mesh_rec,
        "quality": quality_rec, "graph": graph_rec, "trunk": trunk_rec,
        "kernels": kernels, "breakdown": breakdown,
        "phase_start_s": phase_s, "seconds": time.time() - t_start,
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


def quality_full():
    """``--quality_full``: phases 1, 2 and 15 (b) and the reference regime of
    tools/quality_r05.py through the trainer and render CLIs (40,000
    iterations, warmup 3,000, its test milestones).  The record goes to
    chiprun_out/quality_full.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    from gs_deformable_tpu_torch import _build

    t_start = time.time()
    log(card_line())
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    _build.build_all()
    log(f"phase 15, the reference regime: {QUALITY_FULL_ITERS} iterations, warmup "
        f"{QUALITY_FULL_WARMUP}, test iterations {QUALITY_FULL_TESTS}  "
        f"[{time.time() - t_start:.1f} s]")
    with tempfile.TemporaryDirectory() as root:
        rec = quality_phase(torch, None, root, QUALITY_FULL_ITERS, QUALITY_FULL_WARMUP,
                            QUALITY_FULL_TESTS, checks=False)
    rec["seconds"] = time.time() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "quality_full.json"), "w") as f:
        json.dump(rec, f, indent=1)
    run = rec["run"]
    print(json.dumps({k: run[k] for k in (
        "iterations", "warmup", "train_wall_s", "eval_wall_s", "psnr_trajectory_test",
        "psnr_trajectory_train", "psnr_test", "ssim_test", "psnr_train", "ssim_train",
        "peak_alive", "ms_per_step_past_warmup")} | {"card": rec["card"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--quality_full"]:
        sys.exit(quality_full())
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--cli-child"]:
        sys.exit(cli_child(sys.argv[2:]))
    sys.exit(main())
