"""Screen space as one launch each way (CUDA source ``csrc/screen_space.cu``).

``ops.rasterize.screen_space`` sends CUDA tensors here: ``ScreenSpaceFn``
runs ``screen_space_forward`` (cov3D, the EWA projection, the radius, tile
rect and mask, the NDC tap and the SH colour, one thread a gaussian) and
takes ``screen_space_backward`` (the chain rule of the same expressions,
recomputed from the inputs) as its gradient.  ``forward_plain`` is the
chain of plain PyTorch ops they replace (``transforms.build_cov3d``,
``projection.preprocess``, ``sh.eval_sh_color``) and ``backward_plain``
autograd through it; each wrapper takes its plain version for CPU tensors.
On the card the forward's integers equal ``forward_plain``'s run on the
same CUDA tensors and its floats are within 2 ulps (bitwise up to 699,050
rows; see the source for how), and the backward holds autograd's
gradients at the train step's bars.  It replaces no TPU kernel: XLA fuses
the JAX package's chain.

The outputs, in order (``OUTPUTS``): NDC and pixel centres before the tap,
view depth, conic, colour, radius, tile rect, tiles touched, mask, and,
when a tap is given, the tapped NDC and pixel centres.  The kernel reads
the SH degree, the scale modifier, ``alive``, the opacities (the
opacity-aware radius when given) and the tap from its arguments.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from .tile_cull import _rows

OUTPUTS = ("ndc", "pix", "depths", "conics", "colors", "radii", "rect", "tiles_touched",
           "mask", "ndc_tap", "pix_tap")
# The differentiable outputs, in the order their cotangents reach the backward.
GRAD_OUTPUTS = ("ndc", "pix", "depths", "conics", "colors", "ndc_tap", "pix_tap")
INPUTS = ("means3d", "scales", "rotations", "shs", "tap")

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "screen_space_forward": (_P, _LL, _P, _LL, _P, _LL, _P, _I, _P, _LL, _P, _LL, _P, _LL,
                             _P, _P, _P, _LL, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "screen_space_backward": (_P, _LL, _P, _LL, _P, _LL, _P, _I, _P, _P, _P, _LL, _I, _I,
                              _I, _F, _F, _F, _F, _F, _P, _LL, _P, _LL, _P, _LL, _P, _LL,
                              _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P),
}


def _lib():
    return _build.load("screen_space", _SIGNATURES)


def forward_plain(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos, *,
                  width: int, height: int, tan_fovx: float, tan_fovy: float, sh_degree: int,
                  scale_modifier: float = 1.0, tile_x: int = 16, tile_y: int = 16,
                  opacities: Optional[torch.Tensor] = None,
                  alive: Optional[torch.Tensor] = None,
                  tap: Optional[torch.Tensor] = None,
                  cov3d_precomp: Optional[torch.Tensor] = None,
                  colors_precomp: Optional[torch.Tensor] = None) -> tuple:
    """The plain PyTorch chain on any device: ``OUTPUTS``, the last two None
    without a tap.  ``cov3d_precomp`` / ``colors_precomp`` stand in for
    ``build_cov3d`` / ``eval_sh_color`` where given."""
    from ..projection import ndc2pix, preprocess
    from ..sh import eval_sh_color
    from ..transforms import build_cov3d

    cov3d = cov3d_precomp if cov3d_precomp is not None else build_cov3d(
        scales, rotations, scale_modifier)
    pre = preprocess(means3d, cov3d, viewmatrix, projmatrix, width=width, height=height,
                     tan_fovx=tan_fovx, tan_fovy=tan_fovy, tile_x=tile_x, tile_y=tile_y,
                     alive=alive, opacities=opacities)
    ndc_tap = pix_tap = None
    if tap is not None:
        ndc_tap = pre.means2d_ndc + tap
        pix_tap = torch.stack([ndc2pix(ndc_tap[:, 0], width), ndc2pix(ndc_tap[:, 1], height)],
                              dim=-1)
    colors = colors_precomp if colors_precomp is not None else eval_sh_color(
        sh_degree, shs, means3d, campos)
    return (pre.means2d_ndc, pre.means2d_pix, pre.depths, pre.conics, colors, pre.radii,
            pre.rect, pre.tiles_touched, pre.mask, ndc_tap, pix_tap)


def backward_plain(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos, grads, *,
                   tap_given: bool, **kw) -> tuple:
    """Autograd through ``forward_plain``: the gradients of ``INPUTS`` (None
    where no cotangent reaches one) for the cotangents ``grads`` of
    ``GRAD_OUTPUTS`` (None where absent)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (means3d, scales, rotations, shs)]
        if tap_given:
            leaves.append(torch.zeros((means3d.shape[0], 2), dtype=torch.float32,
                                      device=means3d.device, requires_grad=True))
        outs = forward_plain(*leaves[:4], viewmatrix, projmatrix, campos,
                             tap=leaves[4] if tap_given else None, **kw)
        outs = dict(zip(OUTPUTS, outs))
        pairs = [(outs[k], g) for k, g in zip(GRAD_OUTPUTS, grads) if g is not None]
        if not pairs:
            return (None,) * len(INPUTS)
        got = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                  allow_unused=True)
    return tuple(got) + (None,) * (len(INPUTS) - len(got))


def _scalars(width, height, tan_fovx, tan_fovy):
    """focal and clamp limits as the plain chain forms them (Python doubles)."""
    return (width / (2.0 * tan_fovx), height / (2.0 * tan_fovy), 1.3 * tan_fovx,
            1.3 * tan_fovy)


def _camera(device, viewmatrix, projmatrix, campos):
    out = []
    for name, t, shape in (("viewmatrix", viewmatrix, (4, 4)), ("projmatrix", projmatrix, (4, 4)),
                           ("campos", campos, (3,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{name} must be float32 {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    return out


def _shs(shs, n, deg):
    """shs, checked, as the kernels read it: (n, K, 3) contiguous."""
    if shs.dtype != torch.float32 or shs.dim() != 3 or shs.shape[0] != n or shs.shape[2] != 3:
        raise ValueError(f"shs must be float32 (n, K, 3), got {shs.dtype} {tuple(shs.shape)}")
    if not 0 <= deg <= 4 or shs.shape[1] < (deg + 1) ** 2:
        raise ValueError(f"SH degree {deg} with {shs.shape[1]} coefficients")
    return shs.contiguous()


def _check_devices(device, tensors):
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}: all on one CUDA device")


def screen_space_forward(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos, *,
                         width: int, height: int, tan_fovx: float, tan_fovy: float,
                         sh_degree: int, scale_modifier: float = 1.0, tile_x: int = 16,
                         tile_y: int = 16, opacities: Optional[torch.Tensor] = None,
                         alive: Optional[torch.Tensor] = None,
                         tap: Optional[torch.Tensor] = None) -> tuple:
    """``OUTPUTS`` of one launch (``forward_plain`` for CPU tensors)."""
    kw = dict(width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
              sh_degree=sh_degree, scale_modifier=scale_modifier, tile_x=tile_x, tile_y=tile_y)
    device = means3d.device
    if device.type == "cpu":
        return forward_plain(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos,
                             opacities=opacities, alive=alive, tap=tap, **kw)
    n = means3d.shape[0]
    rows = [_rows("means3d", means3d, torch.float32, 3, n),
            _rows("scales", scales, torch.float32, 3, n),
            _rows("rotations", rotations, torch.float32, 4, n)]
    opt = [None if t is None else _rows(name, t, dtype, cols, n) for name, t, dtype, cols in
           (("opacities", opacities, torch.float32, 1), ("alive", alive, torch.bool, 1),
            ("tap", tap, torch.float32, 2))]
    shs = _shs(shs, n, sh_degree)
    cam = _camera(device, viewmatrix, projmatrix, campos)
    _check_devices(device, [t for t, _ in rows] + [t for t, _ in filter(None, opt)] + [shs])

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = [new(n, 2), new(n, 2), new(n), new(n, 3), new(n, 3), new(n, dtype=torch.int32),
           new(n, 4, dtype=torch.int32), new(n, dtype=torch.int32), new(n, dtype=torch.bool)]
    out += [new(n, 2), new(n, 2)] if tap is not None else [None, None]
    args = [x for t, ld in rows for x in (t.data_ptr(), ld)]
    args += [shs.data_ptr(), shs.shape[1]]
    for o in opt:
        args += [None, 0] if o is None else [o[0].data_ptr(), o[1]]
    args += [t.data_ptr() for t in cam]
    args += [n, width, height, tile_x, tile_y, sh_degree, scale_modifier, *_scalars(width, height, tan_fovx, tan_fovy)]
    args += [None if t is None else t.data_ptr() for t in out]
    err = _lib().screen_space_forward(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "screen_space_forward")
    screen_space_forward.launches += 1
    return tuple(out)


def screen_space_backward(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos,
                          grads, *, width: int, height: int, tan_fovx: float, tan_fovy: float,
                          sh_degree: int, scale_modifier: float = 1.0, tap_given: bool,
                          want=(True,) * len(INPUTS)) -> tuple:
    """The gradients of ``INPUTS`` for the cotangents ``grads`` of
    ``GRAD_OUTPUTS`` (None where absent), one launch (``backward_plain``
    for CPU tensors).  A gradient is None where ``want`` says so (and the
    tap's without ``tap_given``); the others are tensors, zeros where no
    cotangent reaches them (where autograd gives None)."""
    kw = dict(width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
              sh_degree=sh_degree, scale_modifier=scale_modifier)
    device = means3d.device
    n = means3d.shape[0]
    shapes = ((n, 3), (n, 3), (n, 4), tuple(shs.shape), (n, 2))
    want = tuple(want[:4]) + (want[4] and tap_given,)
    if device.type == "cpu":
        got = backward_plain(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos,
                             grads, tap_given=tap_given, **kw)
        return tuple(None if not w else torch.zeros(s) if g is None else g
                     for g, w, s in zip(got, want, shapes))
    out = [torch.empty(s, dtype=torch.float32, device=device) if w else None
           for s, w in zip(shapes, want)]
    if not any(want):
        return tuple(out)
    g = dict(zip(GRAD_OUTPUTS, grads))
    rows = [_rows("means3d", means3d, torch.float32, 3, n),
            _rows("scales", scales, torch.float32, 3, n),
            _rows("rotations", rotations, torch.float32, 4, n)]
    cols = dict(ndc=2, pix=2, depths=1, conics=3, colors=3, ndc_tap=2, pix_tap=2)
    cot = [None if t is None else _rows(f"grad of {k}", t, torch.float32, cols[k], n)
           for k, t in g.items()]
    shs = _shs(shs, n, sh_degree)
    cam = _camera(device, viewmatrix, projmatrix, campos)
    _check_devices(device, [t for t, _ in rows] + [t for t, _ in filter(None, cot)] + [shs])
    args = [x for t, ld in rows for x in (t.data_ptr(), ld)]
    args += [shs.data_ptr(), shs.shape[1]]
    args += [t.data_ptr() for t in cam]
    args += [n, width, height, sh_degree, scale_modifier,
             *_scalars(width, height, tan_fovx, tan_fovy)]
    for c in cot:
        args += [None, 0] if c is None else [c[0].data_ptr(), c[1]]
    args += [None if t is None else t.data_ptr() for t in out]
    err = _lib().screen_space_backward(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "screen_space_backward")
    screen_space_backward.launches += 1
    return tuple(out)


screen_space_forward.launches = 0
screen_space_backward.launches = 0


class ScreenSpaceFn(torch.autograd.Function):
    """``screen_space_forward`` with ``screen_space_backward`` as its gradient.

    ``apply(means3d, scales, rotations, shs, tap, viewmatrix, projmatrix,
    campos, opacities, alive, kw)``: the outputs of ``OUTPUTS`` (the tapped
    pair only with a tap); gradients reach ``INPUTS``.  ``opacities`` and
    ``alive`` shape the radius and mask only and get none.  The kernels
    give the camera no gradient, so a camera that wants one is refused.
    """

    @staticmethod
    def forward(ctx, means3d, scales, rotations, shs, tap, viewmatrix, projmatrix, campos,
                opacities, alive, kw):
        if any(ctx.needs_input_grad[5:8]):
            raise ValueError("screen space's kernels give the camera no gradient: "
                             "viewmatrix, projmatrix and campos must not require grad")
        out = screen_space_forward(means3d, scales, rotations, shs, viewmatrix, projmatrix,
                                   campos, opacities=opacities, alive=alive, tap=tap, **kw)
        ctx.save_for_backward(means3d, scales, rotations, shs, viewmatrix, projmatrix, campos)
        ctx.kw = {k: v for k, v in kw.items() if k not in ("tile_x", "tile_y")}
        ctx.tap_given = tap is not None
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*out[5:9])
        return tuple(o for o in out if o is not None)

    @staticmethod
    def backward(ctx, *grads):
        cot = grads[:5] + (grads[9:11] if ctx.tap_given else (None, None))
        got = screen_space_backward(*ctx.saved_tensors, cot, tap_given=ctx.tap_given,
                                    want=ctx.needs_input_grad[:5], **ctx.kw)
        return got + (None,) * 6
