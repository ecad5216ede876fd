"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Bars: ordered fill and binning bitwise (both sort modes); composite rgb
rtol 1e-4 / atol 2e-5, final_T atol 2e-6, n_contrib exact (same inputs on
both sides), at chunk-aligned layouts and at the packed schedule's
sub_chunk-aligned one, where tiles open in the middle of a 128-row chunk;
composite backward rows rtol 5e-4 / atol 2e-5 x the row's max |g| (the
reference's gradient bar, tests/test_rasterize.py:98), exactly 0 outside
every tile's range, and bitwise equal from launch to launch.  A
whole render, card vs CPU: image rtol 1e-4 / atol 2e-5 and final_T rtol
1e-4 / atol 2e-6 (the reference's bars), except at knife-edge pixels.  The
card's expf/sinf and matmul sums round apart from the CPU's by an ulp or
two, so a splat whose alpha sits on the 1/255 threshold can blend on one
device and not the other: at most 0.1% of pixels may then differ, each by
at most what one such splat moves it (2/255 in rgb, 1/255 in T).  Each
kernel captured into a CUDA graph and replayed on new inputs, with eager
calls between the replays: every result of the fills and the forward
bitwise its plain version, of the backward bitwise the eager kernel's and
at the gradient bar.

The deformation trunk in the bf16 tiers (``models.deform._Bf16Trunk``,
``ops/kernels/trunk.py``): its two epilogue kernels bitwise their plain
versions; bf16 x bf16 products on the tensor cores with an fp32 result
equal to the fp32 product of the upcast operands where every partial sum is
exact (elsewhere the tensor cores sum in another order); the heads' exact
split products within fp32 summation; and the whole trunk, forward and
every gradient, against the same tier written layer by layer with fp32
products of the rounded operands (``trunk_cases.layerwise``).  The two
routes sum each product in another order (the tensor cores' fp32 sums
differ from the CUDA cores' in the last bit of most elements), so some
bf16 roundings of activations and cotangents flip by one step (2^-8
relative).  In the forward a flip moves its row's later activations a
little: the outputs within 2^-8 in L2 norm.  In the backward a flipped
cotangent moves every element of its row's next cotangent by about 2^-12
of a step's size, which flips more of them, so in a row that met one flip
the two routes' cotangents soon differ by bf16 steps throughout; weight,
bias and input gradients sum such rows with cancelling signs, and their
own rounding to bf16 flips too: each gradient within 2^-5 in L2 norm.  The
CPU tests hold the same function bitwise to the layer-by-layer graph.  The
8 x 256 offset and SE(3) trunks through the tensor-core route are also held
to the JAX package's "bfloat16" tier, forward and every gradient, at the
CPU route's bars (``test_tensor_core_trunk_matches_jax``), against its
result stored by ``tests/trunk_jax_reference.py``.
"""

import numpy as np
import pytest
import torch

from gs_deformable_tpu_torch import config
from gs_deformable_tpu_torch.models import deform as tdeform
from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
from gs_deformable_tpu_torch.models.gaussians import GaussianState
from gs_deformable_tpu_torch.ops import binning as tbin
from gs_deformable_tpu_torch.ops import projection, transforms
from gs_deformable_tpu_torch.ops.kernels import composite as comp
from gs_deformable_tpu_torch.ops.kernels import launch_counts, ordered_fill as of
from gs_deformable_tpu_torch.ops.kernels import trunk as tk
from gs_deformable_tpu_torch.ops.rasterize import prepare_tiles
from gs_deformable_tpu_torch.renderer import CameraArrays, render

import fill_cases
import trunk_cases

pytestmark = pytest.mark.cuda

PREFIX_CASES = [(0, 500, 4096, 0.5), (1, 2000, 2000, 1.0), (2, 64, 8192, 0.0),
                (3, 3000, 1000, 0.3), (4, 1, 1, 1.0), (6, 40000, 300_000, 0.9)]
PLACE_CASES = [(0, 500, 4096, 0.5), (1, 2000, 2000, 1.0), (2, 64, 8192, 0.0),
               (5, 2048, 600_000, 1.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _positions(seed, n, K, frac_valid):
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(max(K, 1), min(int(n * frac_valid), K), replace=False))
    tail = K + 7 + np.arange(n - pos.shape[0])  # ascending out-of-range rows
    return np.concatenate([pos, tail]).astype(np.int32), rng


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("seed,n,K,frac", PREFIX_CASES)
def test_prefix_fill_kernel_bitwise(cuda, seed, n, K, frac, C):
    pos, rng = _positions(seed, n, K, frac)
    delta = rng.integers(-(1 << 20), 1 << 20, (n, C)).astype(np.int32)
    p, d = torch.from_numpy(pos).to(cuda), torch.from_numpy(delta).to(cuda)
    before = launch_counts()["ordered_prefix_fill"]
    got = of.ordered_prefix_fill(p, d, K)
    torch.cuda.synchronize()
    assert launch_counts()["ordered_prefix_fill"] == before + 1
    assert torch.equal(got.cpu(), of.prefix_fill_plain(p.cpu(), d.cpu(), K))


@pytest.mark.parametrize("seed,n,K,frac", PLACE_CASES)
def test_place_kernel_bitwise(cuda, seed, n, K, frac):
    pos, rng = _positions(seed, n, K, frac)
    vals = rng.integers(0, 1 << 20, n).astype(np.int32)
    p, v = torch.from_numpy(pos).to(cuda), torch.from_numpy(vals).to(cuda)
    got = of.ordered_place_i32(p, v, K)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), of.place_plain(p.cpu(), v.cpu(), K))


CARD_PREFIX_CASES = [*fill_cases.PREFIX_CASES, ("random", (1 << 21) + 12_347, 4),
                     ("dense", (1 << 21) + 2, 2), ("random", (1 << 21) + 5, 8)]
CARD_PLACE_CASES = [*fill_cases.PLACE_CASES, ("dense", (1 << 21) + 3)]


@pytest.mark.parametrize("kind,K,C", CARD_PREFIX_CASES)
def test_prefix_fill_kernel_adversarial(cuda, kind, K, C):
    """The single-pass prefix fill on the position sets of tests/fill_cases.py
    (block edges, a segment over many blocks, K not a multiple of 4, nothing
    in range, n = 0, every channel count) and at K >= 2^21, where the
    look-back chain runs over 512 blocks: bitwise, one launch a call."""
    pos = fill_cases.positions(kind, K)
    delta = fill_cases.values(pos.shape[0], C, 1 << 20)
    p, d = torch.from_numpy(pos).to(cuda), torch.from_numpy(delta).to(cuda)
    before = launch_counts()["ordered_prefix_fill"]
    got = of.ordered_prefix_fill(p, d, K)
    torch.cuda.synchronize()
    assert launch_counts()["ordered_prefix_fill"] == before + 1
    assert torch.equal(got.cpu(), of.prefix_fill_plain(p.cpu(), d.cpu(), K))


@pytest.mark.parametrize("kind,K", CARD_PLACE_CASES)
def test_place_kernel_adversarial(cuda, kind, K):
    pos = fill_cases.positions(kind, K)
    vals = fill_cases.values(pos.shape[0], 1, 1 << 20)[:, 0]
    p, v = torch.from_numpy(pos).to(cuda), torch.from_numpy(vals).to(cuda)
    before = launch_counts()["ordered_place_i32"]
    got = of.ordered_place_i32(p, v, K)
    torch.cuda.synchronize()
    assert launch_counts()["ordered_place_i32"] == before + 1
    assert torch.equal(got.cpu(), of.place_plain(p.cpu(), v.cpu(), K))


def test_fill_launches_back_to_back(cuda):
    """Three prefix fills and three places at different K on one stream with
    no synchronise between them: each launch must find the status words and
    the ticket ready for it (a new epoch; the counter reset by the last
    block of the launch before)."""
    calls = []
    for i, (kind, K) in enumerate([("random", 3 * fill_cases.BLOCK + 5),
                                   ("block_edges", 600_001), ("random", (1 << 21) + 7)]):
        pos = torch.from_numpy(fill_cases.positions(kind, K, seed=i)).to(cuda)
        calls.append((pos, torch.from_numpy(fill_cases.values(pos.shape[0], 3, 1 << 20, i)).to(cuda),
                      K))
    torch.cuda.synchronize()
    counts = launch_counts()
    outs = []
    for i, (p, d, K) in enumerate(calls):
        outs.append((of.ordered_prefix_fill(p, d, K), of.ordered_place_i32(p, d[:, 0], K)))
        assert launch_counts()["ordered_prefix_fill"] == counts["ordered_prefix_fill"] + i + 1
        assert launch_counts()["ordered_place_i32"] == counts["ordered_place_i32"] + i + 1
    torch.cuda.synchronize()
    for (p, d, K), (fill, placed) in zip(calls, outs):
        assert torch.equal(fill.cpu(), of.prefix_fill_plain(p.cpu(), d.cpu(), K))
        assert torch.equal(placed.cpu(), of.place_plain(p.cpu(), d[:, 0].cpu(), K))


def _capture(fn):
    """One eager call of ``fn`` (it builds and warms the kernel), then one call
    captured into a CUDA graph on torch's default capture stream: (graph,
    the captured call's output tensor, which every replay rewrites)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _replay_in_turns(graphs, buffers, input_sets, eager, check):
    """Feed the input sets to the graphs in turns: copy set i into graph
    i % len(graphs)'s static buffers, replay it, make one eager call on the
    same inputs on the same stream, and hold both results with
    ``check(got, inputs)``.  Returns the number of replays."""
    for i, inputs in enumerate(input_sets):
        (graph, out), bufs = graphs[i % len(graphs)], buffers[i % len(graphs)]
        for buf, x in zip(bufs, inputs):
            buf.copy_(x)
        graph.replay()
        now = eager(*bufs)
        torch.cuda.synchronize()
        check(out, inputs, f"replay {i}")
        check(now, inputs, f"eager call after replay {i}")
    return len(input_sets)


GRAPH_K, GRAPH_N, GRAPH_SETS = 600_001, 150_000, 8


@pytest.mark.parametrize("C", [2, 4, 8])
def test_prefix_fill_replays_in_cuda_graph(cuda, C):
    """A captured prefix fill is a pure function of its inputs: two graphs,
    captured one after the other on static buffers, replayed in turns on
    position sets of one length whose drops move from set to set, with an
    eager call on the same stream after each replay; every result bitwise
    its plain version.  A capture counts one launch; replays count none."""
    sets = [(torch.from_numpy(fill_cases.moved_drops(GRAPH_K, GRAPH_N, s)).to(cuda),
             torch.from_numpy(fill_cases.values(GRAPH_N, C, 1 << 20, s)).to(cuda))
            for s in range(GRAPH_SETS)]
    buffers = [tuple(x.clone() for x in sets[i]) for i in (0, 1)]
    graphs = [_capture(lambda b=b: of.ordered_prefix_fill(*b, GRAPH_K)) for b in buffers]
    before = launch_counts()["ordered_prefix_fill"]

    def check(got, inputs, what):
        ref = of.prefix_fill_plain(*(x.cpu() for x in inputs), GRAPH_K)
        assert torch.equal(got.cpu(), ref), what

    n = _replay_in_turns(graphs, buffers, sets,
                         lambda p, d: of.ordered_prefix_fill(p, d, GRAPH_K), check)
    assert launch_counts()["ordered_prefix_fill"] == before + n  # the eager calls alone


def test_place_replays_in_cuda_graph(cuda):
    sets = [(torch.from_numpy(fill_cases.moved_drops(GRAPH_K, GRAPH_N, s)).to(cuda),
             torch.from_numpy(fill_cases.values(GRAPH_N, 1, 1 << 20, s)[:, 0]).to(cuda))
            for s in range(GRAPH_SETS)]
    buffers = [tuple(x.clone() for x in sets[0])]
    graphs = [_capture(lambda: of.ordered_place_i32(*buffers[0], GRAPH_K))]

    def check(got, inputs, what):
        ref = of.place_plain(*(x.cpu() for x in inputs), GRAPH_K)
        assert torch.equal(got.cpu(), ref), what

    _replay_in_turns(graphs, buffers, sets, lambda p, v: of.ordered_place_i32(p, v, GRAPH_K),
                     check)


def _screen(seed, n, W, H, opaque, device):
    rng = np.random.default_rng(seed)
    fovx, fovy = 0.9, 0.7
    view = np.eye(4, dtype=np.float32)
    full = view @ transforms.projection_matrix(0.01, 100.0, fovx, fovy)
    means = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(2.5, 9.0, n)], -1).astype(np.float32)
    means[: n // 4, 2] = 4.0  # exact depth ties
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.normal(size=(n, 3)) * 0.5 - (1.6 if opaque else 2.4)).astype(np.float32)
    opac = rng.uniform(*((0.9, 0.999) if opaque else (0.2, 0.98)), n).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in
         dict(means=means, q=q, s=s, opac=opac, colors=colors, view=view, full=full).items()}
    pre = projection.preprocess(t["means"], transforms.build_cov3d(t["s"], t["q"]), t["view"],
                                t["full"], width=W, height=H, tan_fovx=float(np.tan(fovx / 2)),
                                tan_fovy=float(np.tan(fovy / 2)), opacities=t["opac"])
    return (pre.means2d_pix, pre.depths, pre.conics, t["opac"], t["colors"], pre.rect,
            pre.tiles_touched)


# (chunk, sub_chunk): sub_chunk > 0 selects the packed schedule's layout.
LAYOUTS = pytest.mark.parametrize("chunk,sub", [(8, 0), (128, 0), (128, 32)],
                                  ids=["chunk8", "chunk128", "packed128-32"])


def _layout_cfg(chunk, sub, **kw):
    packed = dict(composite_mode="packed", sub_chunk=sub) if sub else {}
    return config.RasterizeConfig(instance_capacity=1 << 15, chunk=chunk, **packed, **kw)


def _assert_opens_mid_chunk(binning, chunk, sub):
    if sub:
        start = binning.tile_chunk_start.long() * sub
        assert bool(((start % chunk != 0) & (binning.tile_count > 0)).any())


@pytest.mark.parametrize("opaque", [False, True])
@LAYOUTS
def test_binning_and_composite_kernels(cuda, opaque, chunk, sub):
    W, H = 160, 96
    gx, gy = W // 16, H // 16
    args = _screen(3 + opaque, 1500, W, H, opaque, cuda)
    cfg = _layout_cfg(chunk, sub)
    splats_t, binning = prepare_tiles(*args, grid_x=gx, grid_y=gy, cfg=cfg)
    ref_splats, ref_bin = prepare_tiles(*(a.cpu() for a in args), grid_x=gx, grid_y=gy, cfg=cfg)
    for name in tbin.Binning._fields:
        assert torch.equal(getattr(binning, name).cpu(), getattr(ref_bin, name)), name
    _assert_opens_mid_chunk(binning, chunk, sub)
    kw = dict(grid_x=gx, chunk=config.layout_unit(cfg))
    tables = (binning.tile_chunk_start, binning.tile_count)
    got = comp.composite_forward(splats_t, *tables, **kw)
    ref = comp.composite_forward_plain(splats_t, *tables, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:, 0:3], ref[:, 0:3], rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(got[:, 3], ref[:, 3], rtol=0, atol=2e-6)
    assert torch.equal(got[:, 4], ref[:, 4])
    if opaque:
        assert float(got[:, 3].min()) < 1e-3  # pixels terminated early


@pytest.mark.parametrize("cull", [False, True])
def test_packed_sort_binning_kernels(cuda, cull):
    W, H = 160, 96
    gx, gy = W // 16, H // 16
    args = _screen(9, 1500, W, H, False, cuda)
    cfg = _layout_cfg(128, 32, sort_mode="packed", tile_cull=cull)
    before = launch_counts()["ordered_prefix_fill"]
    _, binning = prepare_tiles(*args, grid_x=gx, grid_y=gy, cfg=cfg)
    torch.cuda.synchronize()
    assert launch_counts()["ordered_prefix_fill"] == before + 2
    _, ref_bin = prepare_tiles(*(a.cpu() for a in args), grid_x=gx, grid_y=gy, cfg=cfg)
    for name in tbin.Binning._fields:
        assert torch.equal(getattr(binning, name).cpu(), getattr(ref_bin, name)), name
    assert int(binning.required) > 0


def assert_rows_close(got, ref):
    """(16, Kp) gradient rows: per row, rtol 5e-4 / atol 2e-5 x max |ref|."""
    for r in range(got.shape[0]):
        scale = float(ref[r].abs().max()) + 1e-30
        torch.testing.assert_close(got[r], ref[r], rtol=5e-4, atol=2e-5 * scale,
                                   msg=lambda m: f"row {r}: {m}")


def in_range_rows(binning, chunk, Kp):
    """(Kp,) bool: rows inside some tile's [start, start + count)."""
    start = torch.clamp(binning.tile_chunk_start.long() * chunk, max=Kp)
    end = torch.clamp(start + binning.tile_count.long(), max=Kp)
    edge = torch.zeros(Kp + 1, dtype=torch.int64, device=start.device)
    edge.index_add_(0, start, torch.ones_like(start))
    edge.index_add_(0, end, -torch.ones_like(end))
    return torch.cumsum(edge, 0)[:Kp] > 0


@pytest.mark.parametrize("opaque", [False, True])
@LAYOUTS
def test_composite_backward_kernel(cuda, opaque, chunk, sub):
    W, H = 160, 96
    gx, gy = W // 16, H // 16
    args = _screen(5 + opaque, 1500, W, H, opaque, cuda)
    cfg = _layout_cfg(chunk, sub)
    splats_t, binning = prepare_tiles(*args, grid_x=gx, grid_y=gy, cfg=cfg)
    _assert_opens_mid_chunk(binning, chunk, sub)
    unit = config.layout_unit(cfg)
    kw = dict(grid_x=gx, chunk=unit)
    tables = (binning.tile_chunk_start, binning.tile_count)
    out = comp.composite_forward(splats_t, *tables, **kw)
    rng = np.random.default_rng(11 + opaque)
    grad = torch.zeros_like(out)
    upstream = rng.normal(size=(out.shape[0], 4, 256)).astype(np.float32)
    grad[:, 0:4] = torch.from_numpy(upstream).to(cuda)
    before = launch_counts()["composite_backward"]
    got = comp.composite_backward(splats_t, *tables, out, grad, **kw)
    again = comp.composite_backward(splats_t, *tables, out, grad, **kw)
    ref = comp.composite_backward_plain(splats_t, *tables, out, grad, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["composite_backward"] == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits every launch
    assert_rows_close(got, ref)
    assert float(got[:9].abs().max()) > 0
    inside = in_range_rows(binning, unit, splats_t.shape[1])
    assert not bool(got[:, ~inside].any()) and not bool(got[9:].any())
    if opaque:
        assert float(out[:, 3].min()) < 1e-3  # pixels terminated early


def _composite_sets(cuda, seeds, W=160, H=96):
    """Inputs of one shape from different seeded scenes: (splats_t,
    tile_chunk_start, tile_count, forward output, upstream gradient)."""
    gx, gy = W // 16, H // 16
    cfg = _layout_cfg(128, 0)
    sets = []
    for seed in seeds:
        splats_t, binning = prepare_tiles(*_screen(seed, 1500, W, H, seed % 2 == 1, cuda),
                                          grid_x=gx, grid_y=gy, cfg=cfg)
        tables = (splats_t, binning.tile_chunk_start, binning.tile_count)
        out = comp.composite_forward_plain(*tables, grid_x=gx, chunk=128)
        grad = torch.zeros_like(out)
        grad[:, 0:4] = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(out.shape[0], 4, 256)).astype(np.float32)).to(cuda)
        sets.append((*tables, out, grad))
    return sets, dict(grid_x=gx, chunk=128)


def test_composite_forward_replays_in_cuda_graph(cuda):
    """Replays on other scenes' binnings of one shape, eager calls between
    them: every result bitwise the plain version."""
    sets, kw = _composite_sets(cuda, range(20, 26))
    fwd_sets = [x[:3] for x in sets]
    buffers = [tuple(x.clone() for x in fwd_sets[0])]
    graphs = [_capture(lambda: comp.composite_forward(*buffers[0], **kw))]

    def check(got, inputs, what):
        assert torch.equal(got, comp.composite_forward_plain(*inputs, **kw)), what

    _replay_in_turns(graphs, buffers, fwd_sets, lambda *t: comp.composite_forward(*t, **kw),
                     check)


def test_composite_backward_replays_in_cuda_graph(cuda):
    """The same for the backward: each result bitwise the eager kernel's on
    the same inputs (it has no atomics) and at this file's gradient bar
    against the plain version."""
    sets, kw = _composite_sets(cuda, range(20, 26))
    buffers = [tuple(x.clone() for x in sets[0])]
    graphs = [_capture(lambda: comp.composite_backward(*buffers[0], **kw))]

    def check(got, inputs, what):
        assert same_bits(got, comp.composite_backward(*inputs, **kw)), what
        assert_rows_close(got, comp.composite_backward_plain(*inputs, **kw))

    _replay_in_turns(graphs, buffers, sets, lambda *t: comp.composite_backward(*t, **kw), check)


def test_render_card_matches_cpu(cuda):
    W, H, n, cap = 320, 176, 3000, 4096
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(2.5, 12, n)], -1).astype(np.float32)

    def pad(a):
        return np.pad(a, [(0, cap - n)] + [(0, 0)] * (a.ndim - 1))

    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    arrays = {"xyz": pad(pts), "f_dc": pad(rng.normal(size=(n, 1, 3)).astype(np.float32)),
              "f_rest": pad(0.1 * rng.normal(size=(n, 15, 3)).astype(np.float32)),
              "opacity": pad(rng.normal(size=(n, 1)).astype(np.float32)),
              "scaling": pad(np.log(0.02 * rng.uniform(0.5, 2, (n, 3))).astype(np.float32)),
              "rotation": rot, "alive": pad(np.ones(n, bool))}
    cfg = config.Config(deform=config.DeformConfig(compute_dtype="float32"),
                        raster=config.RasterizeConfig(instance_capacity=1 << 16))
    fov = 1.0
    fovy = 2 * np.arctan(np.tan(fov / 2) * H / W)
    view = np.eye(4, dtype=np.float32)
    full = view @ transforms.projection_matrix(0.01, 100.0, fov, fovy)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        state = GaussianState.from_numpy(arrays, device=dev)
        net = OffsetNet(init_offset_params(0, cfg.deform), cfg.deform, device=dev)
        cam = CameraArrays.from_numpy(view, full, np.zeros(3), 0.4, device=dev)
        before = launch_counts()
        with torch.no_grad():
            out, _ = render(state, net, cam, iteration=5000, bg=torch.zeros(3, device=dev),
                            width=W, height=H, tan_fovx=float(np.tan(fov / 2)),
                            tan_fovy=float(np.tan(fovy / 2)), active_sh_degree=3, cfg=cfg,
                            device=dev)
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        want = {"composite_forward": 1, "composite_backward": 0, "ordered_prefix_fill": 2,
                "ordered_place_i32": 1, "trunk_bias_relu": 0,  # the fp32 tier: no trunk
                "trunk_relu_mask": 0}
        assert launched == (want if dev.type == "cuda" else dict.fromkeys(want, 0))
        outs.append(out)
    g, c = outs
    assert float(g.image.std()) > 1e-3
    assert_close_but_knife_edges(g.image.cpu(), c.image, atol=2e-5, knife=2 / 255)
    assert_close_but_knife_edges(g.final_t.cpu(), c.final_t, atol=2e-6, knife=1 / 255)


def assert_close_but_knife_edges(got, ref, *, atol, knife, rtol=1e-4, max_frac=1e-3):
    """The bar everywhere but at <= max_frac of elements, each within ``knife``."""
    err = (got - ref).abs()
    off = err > atol + rtol * ref.abs()
    assert int(off.sum()) <= max_frac * off.numel(), f"{int(off.sum())} elements off the bar"
    assert float(err.max()) <= knife, f"max error {float(err.max())} beyond one knife-edge splat"


# --- adversarial scenes for the redesigned composite kernels ----------------
# Built directly as sorted splats (no projection), on a grid of tiles.  Also
# the CPU scenes of tests/test_torch_composite_cull.py (the warp cull).

CULL_AMIN = 1.0 / 255.0


def _conic(rng, n, kind):
    """(n, 3) conics [a, b, c]: inverses of R diag(s1^2, s2^2) R^T."""
    if kind == "elongated":
        s1, s2 = rng.uniform(4.0, 12.0, n), rng.uniform(0.3, 0.8, n)
    elif kind == "degenerate":
        s1, s2 = rng.uniform(2.0, 10.0, n), rng.uniform(0.02, 0.1, n)
    elif kind == "opaque":
        s1, s2 = rng.uniform(2.0, 6.0, n), rng.uniform(2.0, 6.0, n)
    else:
        s1, s2 = rng.uniform(0.5, 4.0, n), rng.uniform(0.5, 4.0, n)
    th = rng.uniform(0.0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    i1, i2 = 1.0 / s1**2, 1.0 / s2**2
    conic = np.stack([cs * cs * i1 + sn * sn * i2, cs * sn * (i1 - i2),
                      sn * sn * i1 + cs * cs * i2], -1)
    if kind == "degenerate":
        # b^2 within an ulp or so of ac, a few indefinite and flat conics
        k = n // 4
        root = np.sqrt(conic[:, 0] * conic[:, 2])
        conic[:k, 1] = root[:k] * (1 - 1e-7) * np.sign(conic[:k, 1])
        conic[k:k + 3, 1] = root[k:k + 3] * 1.01
        conic[k + 3, 0] = 0.0
        conic[k + 4, 2] = -1e-3
    return conic


def cull_scene(seed, kind, n_max=48, chunk=4, grid=(3, 2), counts=None):
    """(splats_t, tile_chunk_start, tile_count, grid_x) of one seeded scene.

    ``kind``: "knife_opacity" (opacity within 1e-6 relative of 1/255),
    "elongated" (long thin rotated conics crossing warp rows), "degenerate",
    "off_tile" (centres up to 12 px outside the tile), "row_boundary"
    (centres on pixel rows and half-way between), "clamped" (opacity >= 1,
    so alpha sits at alpha_max), "opaque" (pixels terminate early),
    "long_tile" (faint small splats, so pixels walk thousands), "mixed",
    "non_finite" (the degenerate conics, indefinite and zero-a ones
    included, and a NaN as the last instance of each tile, in field
    t % 6 of tile t: x, y, a, b, c or opacity).
    The layout unit is ``chunk``; Kp is 3 rows past the last tile's chunk,
    so never a multiple of 4.
    """
    rng = np.random.default_rng(seed)
    gx, gy = grid
    T = gx * gy
    counts = rng.integers(n_max // 2, n_max + 1, T) if counts is None else np.asarray(counts)
    chunks = (counts + chunk - 1) // chunk
    starts = np.cumsum(chunks) - chunks
    Kp = int(chunks.sum()) * chunk + 3
    splats = np.zeros((16, Kp), np.float32)
    for t in range(T):
        n = int(counts[t])
        x0, y0 = (t % gx) * 16, (t // gx) * 16
        lo, hi = (-12.0, 28.0) if kind in ("off_tile", "mixed", "elongated") else (-2.0, 18.0)
        x = x0 + rng.uniform(lo, hi, n)
        y = y0 + rng.uniform(lo, hi, n)
        if kind in ("row_boundary", "mixed"):
            y = y0 + rng.integers(-1, 17, n) + rng.choice([0.0, 0.5, -0.5], n)
            x = np.where(rng.random(n) < 0.5, np.round(x), x)
        op = rng.uniform(0.05, 0.99, n)
        if kind in ("knife_opacity", "mixed"):
            rel = rng.choice([-1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-5], n)
            op = np.where(rng.random(n) < 0.6, CULL_AMIN * (1.0 + rel), op)
        if kind in ("clamped", "mixed"):
            op = np.where(rng.random(n) < 0.5, rng.uniform(1.0, 3.0, n), op)
        if kind == "opaque":
            op = rng.uniform(0.9, 1.5, n)
        if kind == "long_tile":
            op = rng.uniform(0.01, 0.1, n)
        conic_kind = {"mixed": "elongated" if t % 2 else kind, "non_finite": "degenerate"}
        conic = _conic(rng, n, conic_kind.get(kind, kind))
        rows = np.stack([x, y, conic[:, 0], conic[:, 1], conic[:, 2], op,
                         *rng.uniform(0, 1, (3, n))])
        if kind == "non_finite":
            # alpha = min(alpha_max, NaN) is alpha_max (fminf), so the NaN
            # instance blends into every live pixel of its tile.
            rows[t % 6, n - 1] = np.nan
        s = starts[t] * chunk
        splats[:9, s:s + n] = rows.astype(np.float32)
    return (torch.from_numpy(splats), torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)), gx)


# (kind, counts): "long_tile" is one tile of 5,000 instances, so the kernels
# walk many batches (32 instances a batch in the backward, 256 in the forward).
# The other kinds sit on the edges of the warp cull (composite_common.cuh:
# warp_keeps): a pair it dropped wrongly would change the forward's bits.
REDESIGN_CASES = [("long_tile", [5000]), ("knife_opacity", None), ("opaque", None),
                  ("mixed", None), ("degenerate", None), ("elongated", None),
                  ("off_tile", None), ("row_boundary", None), ("clamped", None),
                  ("non_finite", None)]


def same_bits(a, b):
    """Bitwise equal, NaNs included: the float32 bit patterns."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("unit", [1, 2, 4])
@pytest.mark.parametrize("kind,counts", REDESIGN_CASES, ids=[k for k, _ in REDESIGN_CASES])
def test_redesigned_composite_kernels(cuda, kind, counts, unit):
    grid = (1, 1) if counts else (3, 2)
    splats_t, starts, cnt, gx = cull_scene(31, kind, chunk=unit, grid=grid, counts=counts)
    assert splats_t.shape[1] % 4 != 0
    kw = dict(grid_x=gx, chunk=unit)
    tables = [t.to(cuda) for t in (splats_t, starts, cnt)]
    out = comp.composite_forward(*tables, **kw)
    ref, work = comp.composite_forward_plain(*tables, count_work=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)  # bitwise: same per-pixel operations in the same order
    assert work.contributing > 0
    if kind == "opaque":
        assert float(out[:, 3].min()) < 1e-3  # pixels terminated early
    if counts:
        assert int(out[:, 4].max()) > 20 * 64  # the walk spans many batches
    rng = np.random.default_rng(4)
    grad = torch.zeros_like(out)
    grad[:, 0:4] = torch.from_numpy(rng.normal(size=(out.shape[0], 4, 256)).astype(np.float32))
    got = comp.composite_backward(*tables, out, grad, **kw)
    again = comp.composite_backward(*tables, out, grad, **kw)
    rows = comp.composite_backward_plain(*tables, out, grad, **kw)
    torch.cuda.synchronize()
    assert same_bits(got, again)
    nan = rows.isnan()  # "non_finite": rows of the NaN instances
    assert torch.equal(got.isnan(), nan)
    assert bool(nan.any()) == (kind == "non_finite")
    assert_rows_close(got.masked_fill(nan, 0.0), rows.masked_fill(nan, 0.0))
    # The same instances at a 128-row layout (the "mixed" schedule's):
    # bitwise the same forward, and the same rows at the moved positions.
    msplats, mstarts, mcnt, _ = cull_scene(31, kind, chunk=128, grid=grid, counts=counts)
    mtables = [t.to(cuda) for t in (msplats, mstarts, mcnt)]
    mout = comp.composite_forward(*mtables, grid_x=gx, chunk=128)
    mgot = comp.composite_backward(*mtables, mout, grad, grid_x=gx, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(mout, out)
    for t in range(cnt.shape[0]):
        a, b, n = int(starts[t]) * unit, int(mstarts[t]) * 128, int(cnt[t])
        assert same_bits(got[:, a:a + n], mgot[:, b:b + n])


def test_composite_occupancy(cuda):
    occ = comp.occupancy()
    assert set(occ) == {"composite_forward", "composite_backward"}
    assert min(occ.values()) >= 1


def _sums_close(sums, values):
    """Column sums within fp32 summation (n x 2^-24 of the sum of the
    magnitudes) of the float64 sums of ``values``."""
    v = values.to(torch.float64)
    bound = max(v.shape[0], 1) * 2.0 ** -24 * v.abs().sum(0)
    assert sums.shape == (v.shape[1],)
    assert bool(((sums.to(torch.float64) - v.sum(0)).abs() <= bound).all())


@pytest.mark.parametrize("rows,cols,ld,off", [(4096, 256, 256, 0), (3001, 256, 320, 64),
                                               (1, 8, 8, 0), (0, 256, 256, 0)])
def test_trunk_epilogues_bitwise(cuda, rows, cols, ld, off):
    """Both epilogues bitwise their plain versions, into a slice of a wider
    buffer too (the skip layer's operand); values straddling 0 and bf16
    rounding ties included."""
    g = torch.Generator(device=cuda).manual_seed(rows + ld)
    y = torch.randn((rows, ld), device=cuda, generator=g)[:, off:off + cols]
    y[::7] = torch.round(y[::7] * 256) / 256 + 2.0 ** -9  # ties to even
    b = torch.randn((cols,), device=cuda, generator=g)
    out = torch.full((rows, ld), 7.0, device=cuda, dtype=torch.bfloat16)
    before = tk.bias_relu_bf16.launches
    tk.bias_relu_bf16(y, b, out[:, off:off + cols])
    torch.cuda.synchronize()
    assert tk.bias_relu_bf16.launches == before + 1
    assert torch.equal(out[:, off:off + cols], tk.bias_relu_plain(y, b))
    assert bool((out[:, :off] == 7.0).all())  # nothing written outside the slice
    a = out[:, off:off + cols]
    dy = torch.randn((rows, ld), device=cuda, generator=g)[:, off:off + cols]
    for rounded in (True, False):
        got = torch.empty((rows, cols), device=cuda, dtype=torch.bfloat16)
        before = tk.relu_mask_bf16.launches
        sums = tk.relu_mask_bf16(dy, a, got, rounded)
        torch.cuda.synchronize()
        assert tk.relu_mask_bf16.launches == before + 1
        ref, _ = tk.relu_mask_plain(dy, a, rounded)
        assert torch.equal(got, ref)
        _sums_close(sums, ref if rounded else torch.where(a > 0, dy, 0))
    if rows > 1:
        assert 0.2 < float((a > 0).float().mean()) < 0.8


def test_tensor_core_product_sums_in_fp32(cuda):
    """A K = 16 product of bf16 operands (``_mm``) equals the fp32 product of
    the upcast operands.  Operands are small multiples of powers of two, so
    every partial sum is exact in fp32 and the order of the sums cannot
    matter; the results need more than bf16's 8 significant bits, so an
    output rounded to bf16 would show."""
    rng = np.random.default_rng(16)
    a = torch.from_numpy(rng.integers(-127, 128, (4096, 16)) * 2.0 ** -6).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (16, 256)) * 2.0 ** -3).to(cuda)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got = tdeform._mm(a, b)
    ref = a.to(torch.float32) @ b.to(torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert not torch.equal(ref, ref.to(torch.bfloat16).to(torch.float32))


def test_exact_split_products(cuda):
    """The heads' backward products of bf16 operands and an fp32 cotangent,
    from its three-way bf16 split: the split is exact, and each product lies
    within fp32 summation of the float64 product (2^-14 of the sum of the
    terms' magnitudes; a product of the rounded cotangent alone is off by
    2^-9)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((4096, 256), device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn((256, 58), device=cuda, generator=g).to(torch.bfloat16)
    cot = torch.randn((4096, 58), device=cuda, generator=g) * 1e-3
    split = tdeform._split3(cot, 64)
    dw, da = tdeform._exact_heads(a, w, cot)
    torch.cuda.synchronize()
    assert split.dtype == torch.bfloat16 and split.shape == (4096, 192)
    parts = split.to(torch.float64)
    assert torch.equal((parts[:, :58] + parts[:, 64:122]) + parts[:, 128:186],
                       cot.to(torch.float64))
    assert not bool(parts[:, 58:64].any())  # padding columns are zeros
    a64, w64, c64 = (t.to(torch.float64) for t in (a, w, cot))
    for got, ref, mag in ((dw, a64.t() @ c64, a64.abs().t() @ c64.abs()),
                          (da, c64 @ w64.t(), c64.abs() @ w64.abs().t())):
        assert got.dtype == torch.float32
        assert bool(((got.to(torch.float64) - ref).abs() <= 2.0 ** -14 * mag).all())


def _trunk_close(got, ref, bar):
    ref = ref.detach().to(torch.float64)
    gap = float((got.detach().to(torch.float64) - ref).norm()) / float(ref.norm())
    assert gap <= bar, (gap, bar)


@pytest.mark.parametrize("kind,tier,rows", [("offset", "bfloat16", 4096),
                                            ("offset", "bfloat16_bwd", 4096),
                                            ("se3", "bfloat16", 4096),
                                            ("offset", "bfloat16", 262144)])
def test_bf16_trunk_against_layerwise(cuda, kind, tier, rows):
    """The tensor-core trunk of the 8 x 256 nets against the same tier
    written layer by layer on the card: heads and every gradient (weights,
    biases, the trunk's inputs) at the bars of the module's docstring.  The
    offset net's inputs are taken after the positional encoding: its 2^9
    frequency multiplies one bf16 step of a feature's cotangent by up to
    512, and the encoding is plain autograd outside the trunk."""
    cfg = config.DeformConfig()
    init = tdeform.init_offset_params if kind == "offset" else tdeform.init_se3_params
    net = (tdeform.OffsetNet if kind == "offset" else tdeform.SE3Net)(init(3, cfg), cfg,
                                                                      device=cuda)
    g = torch.Generator(device=cuda).manual_seed(rows)
    xyz = torch.rand((rows, 3), device=cuda, generator=g) * 2.6 - 1.3
    tcol = torch.full((rows, 1), 0.4, device=cuda)
    if kind == "offset":
        xyz, tcol = tdeform.posenc(xyz, cfg.multires_xyz), tdeform.posenc(tcol, cfg.multires_time)
    xyz.requires_grad_(True)
    tcol.requires_grad_(True)
    params = list(net.parameters())
    cots = None
    res = []
    for fn in (lambda: tdeform.DeformMLP.forward(net, xyz, tcol, tier),
               lambda: trunk_cases.layerwise(net, xyz, tcol, tier)):
        out = fn()
        if cots is None:
            cots = [torch.randn(o.shape, device=cuda, generator=g) for o in out]
        loss = sum((o * c).sum() for o, c in zip(out, cots))
        res.append((out, torch.autograd.grad(loss, [xyz, tcol, *params])))
    torch.cuda.synchronize()
    (got, got_g), (ref, ref_g) = res
    for a, b in zip(got, ref):
        _trunk_close(a, b, 2.0 ** -8)
    for a, b in zip(got_g, ref_g):
        assert a.shape == b.shape
        _trunk_close(a, b, 2.0 ** -5)


def trunk_gaps_to_jax(kind, device):
    """L2 gaps of the tensor-core trunk's outputs and of the gradients of
    ``[x, t, *weights]`` to the JAX package's "bfloat16" tier
    (``trunk_cases.load_jax_reference``) on ``trunk_cases.full_width_case``."""
    params, x, t, cot = trunk_cases.full_width_case(kind)
    cls = tdeform.OffsetNet if kind == "offset" else tdeform.SE3Net
    net = cls(params, config.DeformConfig(), device=device)
    x, t = (torch.from_numpy(a).to(device).requires_grad_(True) for a in (x, t))
    out = torch.cat(tdeform.DeformMLP.forward(net, x, t, "bfloat16"), dim=1)
    weights = [p for m in (*net.layers, *net.heads) for p in (m.w, m.b)]
    grads = torch.autograd.grad((out * torch.from_numpy(cot).to(device)).sum(),
                                [x, t, *weights])
    ref_out, ref_grads = trunk_cases.load_jax_reference(kind)
    assert len(grads) == len(ref_grads)

    def gap(got, ref):
        ref = torch.from_numpy(ref).to(torch.float64)
        assert got.shape == ref.shape
        return float((got.detach().cpu().to(torch.float64) - ref).norm() / ref.norm())

    return gap(out, ref_out), [gap(g, r) for g, r in zip(grads, ref_grads)]


@pytest.mark.parametrize("kind", trunk_cases.KINDS)
def test_tensor_core_trunk_matches_jax(cuda, kind):
    """The 8 x 256 offset and SE(3) trunks at 4,096 rows through the
    tensor-core route against the JAX package's "bfloat16" tier, computed on
    the CPU from the same weights, inputs and cotangents and stored
    (``tests/trunk_jax_reference.py``): the outputs, and the gradients of
    every weight, bias and trunk input, within the bars of the CPU route
    (``test_torch_deform.py``): 2^-10 and 2^-5 in L2 norm.  Readings on an
    H100: outputs 3.63e-4 (offset) and 4.06e-4 (SE(3)), gradients up to
    6.52e-3 and 1.00e-2 (the CPU route reads 2.2e-4 and up to 7.0e-3)."""
    out_gap, grad_gaps = trunk_gaps_to_jax(kind, cuda)
    assert out_gap <= 2.0 ** -10, out_gap
    assert max(grad_gaps) <= 2.0 ** -5, grad_gaps


def test_trunk_epilogues_replay_in_a_cuda_graph(cuda):
    """The epilogues captured into one CUDA graph and replayed on new inputs,
    each replay bitwise their plain versions (the backward's column sums
    within fp32 summation)."""
    rows, cols = 5000, 256
    g = torch.Generator(device=cuda).manual_seed(11)
    y, dy = (torch.empty((rows, cols), device=cuda) for _ in range(2))
    b = torch.empty((cols,), device=cuda)
    a = torch.empty((rows, cols), device=cuda, dtype=torch.bfloat16)
    gb = torch.empty_like(a)
    for t in (y, dy, b):  # a first call outside the capture builds and loads the library
        t.normal_(generator=g)
    tk.bias_relu_bf16(y, b, a)
    tk.relu_mask_bf16(dy, a, gb, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tk.bias_relu_bf16(y, b, a)
        sums = tk.relu_mask_bf16(dy, a, gb, True)
    for _ in range(3):
        for t in (y, dy, b):
            t.normal_(generator=g)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, tk.bias_relu_plain(y, b))
        ref, _ = tk.relu_mask_plain(dy, a, True)
        assert torch.equal(gb, ref)
        _sums_close(sums, ref)
