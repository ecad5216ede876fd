"""The check for JAX and the JAX package compares whole top-level names."""

import os
import subprocess
import sys
import types

import pytest

from gsbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("gs_deformable_tpu", True), ("gs_deformable_tpu.ops.rasterize", True),
    ("gs_deformable_tpu_torch", False), ("gs_deformable_tpu_torch.training", False),
    ("jaxtyping", False), ("gs_deformable_tpux", False),
])
def test_forbidden_by_whole_top_level_name(name, found, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) is found


def test_the_port_and_the_harness_load_no_jax():
    code = ("import gs_deformable_tpu_torch.train, gs_deformable_tpu_torch.render_cli\n"
            "from gsbench import harness, calibrate\n"
            "harness.readers(); harness.traffic('train_stream'); harness.traffic('viewer_orbit')\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
