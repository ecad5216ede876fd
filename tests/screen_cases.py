"""Screen-space inputs and comparisons for the kernel tests of
``ops/kernels/screen_space.py``.

``inputs`` draws the benchmark's cloud (``gsbench/scene.py``) with
view-dependent colour added, opacities down to 1/255 and the capacity's
dead rows routed as ``renderer.deformed_attributes`` routes them (means
1e6, scales 1e-6, the identity rotation, opacity 0, zero SH); ``camera``
is its arc camera.  ``edge_rows`` overwrites rows with the chain's edges:
behind or on the near plane, past the ``1.3 tan_fov`` clamp, a
determinant that rounds to 0, huge and zero scales, all-zero SH.
"""

import numpy as np
import torch

from gsbench import scene as bscene

DEAD = dict(means3d=1e6, scales=1e-6, opacities=0.0, shs=0.0)


def camera(width, height, device, angle=0.1, height_=0.2):
    """(the camera tensors, the scalar keywords) of the arc camera."""
    v = bscene.view_arrays(bscene.arc_c2w(angle, height_), 0.0, width, height)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    cam = dict(viewmatrix=f32(v.world_view), projmatrix=f32(v.full_proj), campos=f32(v.center))
    return cam, dict(width=width, height=height, tan_fovx=v.tan_fovx, tan_fovy=v.tan_fovy)


def inputs(seed, n, alive, device, coeffs=16, rest=0.3):
    """The per-gaussian inputs of ``n`` capacity rows, the first ``alive`` live."""
    gen = bscene.generator(seed, device)
    c = bscene.cloud(alive, 3, gen, device)["state"]
    f_rest = rest * torch.randn((alive, coeffs - 1, 3), generator=gen, device=device)
    live = dict(means3d=c.xyz, scales=torch.exp(c.scaling), rotations=c.rotation,
                opacities=1 / 255 + (1 - 1 / 255) * torch.rand((alive,), generator=gen,
                                                                device=device),
                shs=torch.cat([c.f_dc, f_rest], 1))
    out = {}
    for k, v in live.items():
        pad = torch.empty((n - alive,) + tuple(v.shape[1:]), dtype=v.dtype, device=device)
        if k == "rotations":
            pad.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).expand_as(pad))
        else:
            pad.fill_(DEAD[k])
        out[k] = torch.cat([v, pad]).contiguous()
    out["alive"] = torch.arange(n, device=device) < alive
    return out


# The kinds of ``edge_rows``.  Kind 2's rows (rank-1 covariances of huge
# extent) cancel in cov2d's determinant, so their gradients are ill-posed in
# fp32: autograd of the plain chain is off its own float64 values there by up
# to the gradient's scale, and no bar can hold a second fp32 route to it.
EDGE_KINDS = tuple(range(8))
WELL_POSED_KINDS = (0, 1, 3, 4, 5, 6, 7)


def edge_rows(x, cam, seed, kinds=EDGE_KINDS):
    """Overwrite a spread of the live rows of ``inputs`` with the chain's
    edges (in place), of the given ``kinds``: 0 the near plane at view z
    0.2 and just past it, and the camera's own plane; 1 points far outside
    the frustum (the Jacobian clamp); 2 rank-1 covariances of huge extent
    (determinants that cancel, to 0 in some rows); 3 zero scales; 4 zero SH;
    5 points behind the camera; 6 large scales; 7 opacities at the radius's
    knife edges."""
    n = int(x["alive"].sum())
    rng = np.random.default_rng(seed)
    view = cam["viewmatrix"].double().cpu().numpy()
    inv = np.linalg.inv(view)  # row-vector view: p_world = p_view @ inv
    draw = rng.integers(0, 8, n)
    rows = np.flatnonzero(rng.random(n) < 0.25)

    def world(p_view):
        return (np.concatenate([p_view, np.ones((len(p_view), 1))], 1) @ inv)[:, :3]

    dev = x["means3d"].device
    for kind in kinds:
        r = rows[draw[rows] == kind]
        if not len(r):
            continue
        rt = torch.from_numpy(r).to(dev)
        if kind == 0:  # on and around the near plane
            z = rng.choice([0.2, np.nextafter(np.float32(0.2), np.float32(1)), 0.19, 0.0], len(r))
            p = np.stack([rng.uniform(-0.05, 0.05, len(r)), rng.uniform(-0.05, 0.05, len(r)), z], 1)
            x["means3d"][rt] = torch.from_numpy(world(p)).float().to(dev)
        elif kind == 1:  # far outside the frustum: |x / z| past 1.3 tan_fov
            z = rng.uniform(1.0, 5.0, len(r))
            p = np.stack([rng.choice([-1, 1], len(r)) * z * rng.uniform(0.5, 4.0, len(r)),
                          rng.choice([-1, 1], len(r)) * z * rng.uniform(0.5, 4.0, len(r)), z], 1)
            x["means3d"][rt] = torch.from_numpy(world(p)).float().to(dev)
        elif kind == 2:  # rank-1 and huge: the determinant cancels
            s = torch.full((len(r), 3), 1e-7, device=dev)
            s[:, 0] = torch.from_numpy(rng.choice([1e3, 1e4, 1e5], len(r))).float().to(dev)
            x["scales"][rt] = s
        elif kind == 3:  # zero scales
            x["scales"][rt] = 0.0
        elif kind == 4:  # all-zero SH
            x["shs"][rt] = 0.0
        elif kind == 5:  # behind the camera
            p = np.stack([rng.uniform(-1, 1, len(r)), rng.uniform(-1, 1, len(r)),
                          -rng.uniform(0.1, 5.0, len(r))], 1)
            x["means3d"][rt] = torch.from_numpy(world(p)).float().to(dev)
        elif kind == 6:  # large scales: rects past the grid
            x["scales"][rt] = torch.from_numpy(rng.uniform(0.5, 3.0, (len(r), 3))).float().to(dev)
        else:  # opacities at the radius's knife edges
            knife = np.float32(1 / 255)
            o = rng.choice(np.array([knife, np.nextafter(knife, np.float32(1)), 1.0, 0.5],
                                    np.float32), len(r))
            x["opacities"][rt] = torch.from_numpy(o).to(dev)
    return x


def ulps(a, b):
    """Elementwise distance in float32 ulps (NaN = NaN, -0 = +0; inf against a
    finite number is far)."""
    a, b = a.float().contiguous(), b.float().contiguous()

    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(a) - ordered(b)).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, torch.zeros_like(d), d)
