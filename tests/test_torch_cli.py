"""The port's command-line entry points on the CPU (``--device cpu``).

Modelled on tests/test_cli_e2e.py, at its sizes (32x32 views, 3 train and
1 test, 100-120 points, 8-14 iterations):

- ``train`` then ``render_cli`` in each ``--deform_mode``, the loss falling
  and the JAX CLI's output layout;
- resume from a checkpoint; a COLMAP scene with densification;
- se3 with ``--use_opacity_mask``: the render CLI's loading path (PLY and
  five nets) renders bitwise as the checkpoint state, and the gate is used;
- the eval-time overlay of training flags; ``--device cuda`` raising
  without a GPU, and a mesh bigger than the world;
- ``--n_model 2`` over 2 gloo ranks under torch.distributed.run;
- a model and a checkpoint written by the JAX train CLI (se3 with the gate,
  fp32 MLP tier): the port's render CLI writes PNGs at most one code value
  from the JAX render CLI's (the image bar, rtol 1e-4 / atol 2e-5 before
  8-bit quantisation) and the same PSNRs; the port's trainer resumes from
  the JAX checkpoint.  The JAX CLIs run once for the module.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from synthetic_scene import build_blender_scene
from test_readers import build_colmap_scene

from gs_deformable_tpu_torch import render_cli, train, training
from gs_deformable_tpu_torch.data.cameras import camera_arrays
from gs_deformable_tpu_torch.data.scene import Scene
from gs_deformable_tpu_torch.io import checkpoint, model_ply
from gs_deformable_tpu_torch.models import deform as tdeform

SMALL = dict(random_init_points=100, instance_capacity=2048, chunk=8, sh_degree=0,
             warmup_iters=3, densify_from_iter=100000, opacity_reset_interval=100000,
             test_iterations=-1, device="cpu")


def flags(**over):
    """tests/test_cli_e2e.py's small run as flags, ``over`` replacing any."""
    out = []
    for k, v in {**SMALL, **over}.items():
        out += [f"--{k}", str(v)]
    return out + ["--quiet", "--disable_viewer"]


BASE = flags()
NETS = [f"{n}.npz" for n in model_ply.NET_FILES]


def small_scene(tmp_path):
    root = str(tmp_path / "scene")
    build_blender_scene(root, n_views=3, n_test=1, size=32, n_blobs=6)
    return root


def run(argv):
    timeline = []
    train.main(argv, timeline)
    return timeline


def losses(timeline):
    return [x for r in timeline if r["stage"] == "steps" for x in r["losses"]]


def png(path):
    return np.asarray(Image.open(path)).astype(np.int32)


@pytest.mark.parametrize("mode", ["offset", "none"])
def test_train_and_render(tmp_path, mode):
    scene, out = small_scene(tmp_path), str(tmp_path / "out")
    tl = run(["-s", scene, "-m", out, "--iterations", "14", "--deform_mode", mode,
              "--save_iterations", "14", "--eval", *BASE])
    loss = losses(tl)
    assert len(loss) == 14 and np.isfinite(loss).all()
    assert np.mean(loss[-4:]) < np.mean(loss[:4])
    for f in ("cfg_args", "cameras.json", "input.ply", "point_cloud/iteration_14/point_cloud.ply"):
        assert os.path.exists(os.path.join(out, f)), f
    nets = sorted(f for f in os.listdir(os.path.join(out, "point_cloud", "iteration_14"))
                  if f.endswith(".npz"))
    # A static scene holds no deformation net, so it writes no offset_model.
    assert nets == sorted(NETS if mode == "offset" else NETS[1:])
    psnrs = render_cli.main(["-m", out, "--skip_train", "--device", "cpu"])
    renders = os.path.join(out, "test", "ours_14", "renders")
    assert os.listdir(renders) == ["00000.png"]
    assert os.listdir(os.path.join(out, "test", "ours_14", "gt")) == ["00000.png"]
    assert png(os.path.join(renders, "00000.png")).shape == (32, 32, 3)
    assert list(psnrs) == ["test"] and np.isfinite(psnrs["test"]).all()


def test_checkpoint_resume(tmp_path):
    scene = small_scene(tmp_path)
    m1, m2 = str(tmp_path / "m1"), str(tmp_path / "m2")
    run(["-s", scene, "-m", m1, "--iterations", "10", "--checkpoint_iterations", "8",
         "--save_iterations", "-1", *BASE])
    ckpt = os.path.join(m1, "ckpt_save", "chkpnt_8.npz")
    tl = run(["-s", scene, "-m", m2, "--iterations", "12", "--start_checkpoint", ckpt,
              "--save_iterations", "-1", *BASE])
    steps = [r for r in tl if r["stage"] == "steps"]
    assert steps[0]["from"] == 9 and steps[-1]["to"] == 12
    assert os.path.exists(os.path.join(m2, "point_cloud", "iteration_12", "point_cloud.ply"))


def test_colmap_scene_densifies(tmp_path):
    root = build_colmap_scene(str(tmp_path / "colmap"), n_frames=4, size=32)
    out = str(tmp_path / "m")
    tl = run(["-s", root, "-m", out, "--iterations", "14", "--save_iterations", "14",
              *flags(random_init_points=120, densify_from_iter=4, densification_interval=4,
                     densify_until_iter=12)])
    dens = [r for r in tl if r["stage"] == "densify"]
    assert [r["iteration"] for r in dens] == [8]
    assert dens[0]["n_alive"] > 0
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_14", "point_cloud.ply"))


def test_opacity_mask_reload_bitwise(tmp_path):
    """se3 with the gate: the render CLI's loading path (PLY and all five
    nets) renders as the checkpoint state, past the warmup, and a perturbed
    opacity_mask net changes the image."""
    scene, out = small_scene(tmp_path), str(tmp_path / "out")
    run(["-s", scene, "-m", out, "--iterations", "10", "--deform_mode", "se3",
         "--use_opacity_mask", "--capacity", "256", "--save_iterations", "10",
         "--checkpoint_iterations", "10", "--eval", *BASE])
    pc_dir = os.path.join(out, "point_cloud", "iteration_10")
    targs = render_cli.combined_args(out, [])
    assert targs.use_opacity_mask and targs.deform_mode == "se3"
    cfg = train.config_from_args(targs)
    state, active_sh = model_ply.load_ply(os.path.join(pc_dir, "point_cloud.ply"), 256, 0,
                                          device="cpu")

    def fresh(seed):
        net, latent = training.init_nets(cfg, seed, "cpu")
        return training.init_train_state(state, net, seed, latent)

    ck, it = checkpoint.load_checkpoint(os.path.join(out, "ckpt_save", "chkpnt_10.npz"),
                                        fresh(5))
    ply, n = render_cli.restore_nets(fresh(6), pc_dir)
    assert it == 10 and n == 5 and isinstance(ply.net, tdeform.SE3Net)
    cam = Scene(scene, "", eval=True, shuffle=False).get_test_cameras()[0]
    ev = training.make_eval_render(cfg, width=cam.width, height=cam.height,
                                   tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
                                   active_sh_degree=active_sh, device="cpu")
    arrs, bg = camera_arrays(cam, device="cpu"), torch.zeros(3)
    img_ck = ev(ck.gaussians, ck.net, arrs, bg, render_cli.FINAL, ck.latent)
    img_ply = ev(ply.gaussians, ply.net, arrs, bg, render_cli.FINAL, ply.latent)
    assert bool(torch.isfinite(img_ck).all()) and float(img_ck.std()) > 1e-3
    assert torch.equal(img_ck, img_ply)
    params = ply.latent["opacity_mask"].numpy_params()
    params["heads"][0]["b"] = params["heads"][0]["b"] + 0.5
    pert = dict(ply.latent, opacity_mask=tdeform.DeformMLP(params, cfg.deform, device="cpu"))
    img_pert = ev(ply.gaussians, ply.net, arrs, bg, render_cli.FINAL, pert)
    assert float((img_pert - img_ply).abs().max()) > 1e-6


def test_render_cli_arg_overlay(tmp_path):
    scene, out = small_scene(tmp_path), str(tmp_path / "out")
    run(["-s", scene, "-m", out, "--iterations", "8", "--save_iterations", "8", "--eval",
         *BASE])
    assert render_cli.combined_args(out, ["--white_background"]).white_background
    targs = render_cli.combined_args(out, [])
    assert not targs.white_background and targs.source_path == scene
    assert render_cli.combined_args(out, ["--resolution", "2"]).resolution == 2
    with pytest.raises(SystemExit):
        render_cli.combined_args(out, ["--no_such_flag"])
    render_cli.main(["-m", out, "--skip_train", "--white_background", "--device", "cpu"])
    assert len(os.listdir(os.path.join(out, "test", "ours_8", "renders"))) == 1


def test_device_cuda_raises_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, out = small_scene(tmp_path), str(tmp_path / "out")
    argv = ["-s", scene, "-m", out, "--iterations", "2", "--disable_viewer", "--quiet"]
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(argv + ["--device", "cuda"])
    assert not os.path.exists(os.path.join(out, "point_cloud"))
    with pytest.raises(RuntimeError, match="cuda"):
        render_cli.main(["-m", out])
    # A mesh whose size is not the world size (one process here) raises.
    with pytest.raises(ValueError, match="world size is 1"):
        train.main(argv + ["--device", "cpu", "--n_data", "2"])


def layout(root):
    """Files under ``root`` (tensorboard event files by count)."""
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.append("events.out.tfevents" if f.startswith("events.out.tfevents") else rel)
    return sorted(out)


@pytest.mark.parametrize("axis", ["--n_model", "--n_data"])
def test_mesh_two_ranks(tmp_path, axis):
    """``--n_model 2`` (or ``--n_data 2``) with ``--device cpu`` over 2 gloo
    ranks under torch.distributed.run, 12 iterations with a densify at 8: one
    output directory (rank 0 makes it; no ``-m``, so another writer would
    make its own), the 1-rank run's layout, and the saved PLY equal to the
    gathered state in the checkpoint."""
    scene = small_scene(tmp_path)
    run_flags = ["--iterations", "12", "--save_iterations", "12", "--checkpoint_iterations",
                 "12", *flags(densify_from_iter=4, densification_interval=4,
                              densify_until_iter=12)]
    cwd = tmp_path / "mesh"
    cwd.mkdir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", "-m", "gs_deformable_tpu_torch.train",
                          "-s", scene, axis, "2", *run_flags],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    outs = os.listdir(cwd / "output")
    assert len(outs) == 1, outs
    mesh_out = str(cwd / "output" / outs[0])
    single = str(tmp_path / "single")
    run(["-s", scene, "-m", single, *run_flags])
    assert layout(mesh_out) == layout(single)
    ck = np.load(os.path.join(mesh_out, "ckpt_save", "chkpnt_12.npz"))
    alive = ck[".gaussians/.alive"]
    assert alive.shape == (256,) and 0 < alive.sum() < 256
    state, _ = model_ply.load_ply(os.path.join(mesh_out, "point_cloud", "iteration_12",
                                               "point_cloud.ply"), 256, 0, device="cpu")
    n = int(alive.sum())
    assert int(state.alive.sum()) == n
    for name in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        np.testing.assert_array_equal(getattr(state, name).numpy()[:n],
                                      ck[f".gaussians/.{name}"][alive], err_msg=name)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A se3 + gate model and checkpoint written by the JAX train CLI (fp32
    MLP tier), and the JAX render CLI's PNGs and printed PSNRs of it."""
    from gs_deformable_tpu import render_cli as jrender_cli
    from gs_deformable_tpu import train as jtrain

    root = tmp_path_factory.mktemp("jax_cli")
    scene, model = small_scene(root), str(root / "model")
    jtrain.main(["-s", scene, "-m", model, "--iterations", "8", "--deform_mode", "se3",
                 "--use_opacity_mask", "--mlp_dtype", "float32", "--random_init_points", "100",
                 "--instance_capacity", "2048", "--chunk", "8", "--sh_degree", "1",
                 "--warmup_iters", "3", "--densify_from_iter", "100000",
                 "--opacity_reset_interval", "100000", "--test_iterations", "-1",
                 "--save_iterations", "8", "--checkpoint_iterations", "8", "--eval",
                 "--quiet", "--disable_viewer"])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        jrender_cli.main(["-m", model])
    psnr = {k: float(v) for k, v in re.findall(r"\[(\w+)\] PSNR: ([0-9.]+)", text.getvalue())}
    ref = str(root / "jax_renders")
    os.makedirs(ref)
    for name in ("train", "test"):
        shutil.move(os.path.join(model, name), os.path.join(ref, name))
    return scene, model, ref, psnr


def test_jax_model_renders_in_port(jax_model):
    scene, model, ref, jpsnr = jax_model
    assert sorted(jpsnr) == ["test", "train"]
    psnrs = render_cli.main(["-m", model, "--device", "cpu"])
    for name in ("train", "test"):
        for sub in ("renders", "gt"):
            d = os.path.join(model, name, "ours_8", sub)
            files = sorted(os.listdir(d))
            assert files == sorted(os.listdir(os.path.join(ref, name, "ours_8", sub)))
            for f in files:
                got, want = png(os.path.join(d, f)), png(os.path.join(ref, name, "ours_8", sub, f))
                assert got.shape == want.shape == (32, 32, 3)
                assert np.abs(got - want).max() <= 1, f"{name}/{sub}/{f}"
                if sub == "renders":
                    assert want.std() > 1
        # The JAX CLI prints the mean to 3 decimals.
        assert abs(np.mean(psnrs[name]) - jpsnr[name]) <= 6e-4, name


def test_port_resumes_jax_checkpoint(jax_model, tmp_path):
    scene, model, _, _ = jax_model
    ckpt = os.path.join(model, "ckpt_save", "chkpnt_8.npz")
    out = str(tmp_path / "resumed")
    tl = run(["-s", scene, "-m", out, "--iterations", "10", "--start_checkpoint", ckpt,
              "--deform_mode", "se3", "--use_opacity_mask", "--save_iterations", "10",
              "--checkpoint_iterations", "10", *flags(mlp_dtype="float32", sh_degree=1)])
    assert [r["to"] for r in tl if r["stage"] == "steps"] == [10]
    assert np.isfinite(losses(tl)).all()
    ours = np.load(os.path.join(out, "ckpt_save", "chkpnt_10.npz"))
    theirs = np.load(ckpt)
    # The latent heads carry over from the JAX run unchanged.
    latent = [k for k in theirs.files if k.startswith(".latent/")]
    assert len(latent) == 2 * ((3 + 1) + 3 * (8 + 1))  # rot is 3 layers deep
    for k in latent:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert int(ours[".adam/.step"]) == 10
