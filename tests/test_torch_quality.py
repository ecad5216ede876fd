"""The quality path of chip_smoke.py phase 15 on the CPU, at a tiny size.

- ``chip_smoke.blender_scene`` (the port's scene builder: the port's
  transforms, preprocess and dense oracle) against the JAX package's
  ``tests/synthetic_scene.build_blender_scene`` with the same arguments:
  both transforms files equal, every PNG within one code value.
- ``chip_smoke.quality_drive`` for 40 iterations with ``--device cpu``: the
  port's trainer, then its render CLI on the saved model, then the PSNR
  parser, which must read the test and train PSNR the trainer prints at
  each test iteration and the PSNR/SSIM the render CLI prints.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from synthetic_scene import build_blender_scene

SCENE = dict(n_views=6, n_test=2, size=64, n_blobs=12, animate=True, seed=0)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality")
    port, ref = str(root / "port"), str(root / "jax")
    chip_smoke.blender_scene(torch, port, device="cpu", **SCENE)
    build_blender_scene(ref, **SCENE)
    return port, ref


def test_blender_scene_matches_jax(scenes):
    port, ref = scenes
    for split, n in (("train", SCENE["n_views"]), ("test", SCENE["n_test"])):
        name = f"transforms_{split}.json"
        with open(os.path.join(port, name)) as a, open(os.path.join(ref, name)) as b:
            assert a.read() == b.read(), name
        assert sorted(os.listdir(os.path.join(port, split))) == sorted(
            os.listdir(os.path.join(ref, split))) == sorted(f"r_{i}.png" for i in range(n))
        for i in range(n):
            got, want = (np.asarray(Image.open(os.path.join(d, split, f"r_{i}.png")))
                         for d in (port, ref))
            assert got.shape == want.shape == (SCENE["size"], SCENE["size"], 4)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1, (split, i, int(diff.max()))
            assert got[..., :3].std() > 5  # blobs on black, not a blank frame


def test_quality_drive_parses_the_clis(scenes, tmp_path):
    port, _ = scenes
    flags = ("--eval", "--random_init_points", "300", "--instance_capacity", "8192",
             "--sh_degree", "0")
    # One intra-op thread: the drive's ops are small, and under the parallel
    # test workers more threads only contend (140 s against 13 s for this
    # run on 8 busy cores).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run, rec = chip_smoke.quality_drive(torch, port, str(tmp_path / "model"), 40, 20,
                                            (20, 40), flags=flags, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert rec["calls"]["composite_forward"] == 40 + 2 * (2 + 5)
    assert rec["calls"]["composite_backward"] == 40
    assert [it for it, _ in run["psnr_trajectory_test"]] == [20, 40]
    assert [it for it, _ in run["psnr_trajectory_train"]] == [20, 40]
    # No densify before 500: the trainer's report at 40 and the render CLI
    # see the same model and the same two test views.
    assert abs(run["psnr_trajectory_test"][-1][1] - run["psnr_test"]) <= 0.0051
    for key in ("psnr_test", "psnr_train"):
        assert 5.0 < run[key] < 60.0, run
    for key in ("ssim_test", "ssim_train"):
        assert 0.0 < run[key] <= 1.0, run
    assert run["densify"] == [] and run["resets"] == []


def test_parse_reports_reads_the_printed_lines():
    train = ("\n[ITER 1000] Evaluating test: L1 0.01234 PSNR 30.80\n"
             "\n[ITER 1000] Evaluating train: L1 0.00100 PSNR 39.37\n"
             "iter 1200: loss 0.01\n"
             "\n[ITER 3100] Evaluating test: L1 0.00900 PSNR 34.58\n")
    render = ("Loading trained model at iteration 3100\n"
              "[train] PSNR: 45.060 SSIM: 0.9981 over 40 views\n"
              "[test] PSNR: 34.512 SSIM: 0.9655 over 4 views\n")
    trajectory, final = chip_smoke.parse_reports(train, render)
    assert trajectory == {"test": [[1000, 30.8], [3100, 34.58]], "train": [[1000, 39.37]]}
    assert final == {"psnr_train": 45.06, "ssim_train": 0.9981, "psnr_test": 34.512,
                     "ssim_test": 0.9655}
