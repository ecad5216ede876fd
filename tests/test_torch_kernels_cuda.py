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
"""

import numpy as np
import pytest
import torch

from gs_deformable_tpu_torch import config
from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
from gs_deformable_tpu_torch.models.gaussians import GaussianState
from gs_deformable_tpu_torch.ops import binning as tbin
from gs_deformable_tpu_torch.ops import projection, transforms
from gs_deformable_tpu_torch.ops.kernels import composite as comp
from gs_deformable_tpu_torch.ops.kernels import launch_counts, ordered_fill as of
from gs_deformable_tpu_torch.ops.rasterize import prepare_tiles
from gs_deformable_tpu_torch.renderer import CameraArrays, render

import fill_cases

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
                "ordered_place_i32": 1}
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
