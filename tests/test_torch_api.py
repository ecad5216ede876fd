"""Every public name of the JAX package has its counterpart in the port.

One case for each ``.py`` module of ``gs_deformable_tpu/``.  The module's
public top-level ``def`` and ``class`` names are read with ``ast`` (nothing
of the JAX package is imported), and each must

- resolve as an attribute of the port's module at the same relative path;
- or be named in ``COUNTERPARTS``, whose dotted paths (relative to
  ``gs_deformable_tpu_torch``) must each resolve;
- or stand in ``NOT_PORTED`` with its reason.

A name in none of the three fails, with the JAX file and line.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "gs_deformable_tpu")
PORT = "gs_deformable_tpu_torch"

# "<module path>:<name>" -> the port's counterparts, dotted from the port's root.
COUNTERPARTS = {
    # The Pallas builders return jitted calls of the TPU kernels (and their
    # custom_vjp around them); the port has one wrapper per kernel and one
    # autograd Function for every schedule.
    "ops/pallas/composite.py:make_batch_calls": (
        "ops.kernels.composite.composite_forward", "ops.kernels.composite.composite_backward"),
    "ops/pallas/composite.py:make_tile_composite": ("ops.kernels.composite.Composite",),
    "ops/pallas/stream_composite.py:make_stream_calls": (
        "ops.kernels.composite.composite_forward", "ops.kernels.composite.composite_backward"),
    "ops/pallas/stream_composite.py:make_stream_composite": ("ops.kernels.composite.Composite",),
    "ops/pallas/stream_composite.py:make_mixed_composite": ("ops.kernels.composite.Composite",),
    "ops/pallas/packed_composite.py:make_packed_calls": (
        "ops.kernels.composite.composite_forward", "ops.kernels.composite.composite_backward"),
    "ops/pallas/packed_composite.py:make_packed_composite": ("ops.kernels.composite.Composite",),
    "ops/pallas/ordered_fill.py:ordered_prefix_fill": (
        "ops.kernels.ordered_fill.ordered_prefix_fill",),
    "ops/pallas/ordered_fill.py:ordered_place_i32": ("ops.kernels.ordered_fill.ordered_place_i32",),
    "ops/rasterize_types.py:CompositeParams": ("ops.rasterize_dense.CompositeParams",),
    "ops/binning.py:tile_bounds_via_sort": ("ops.binning.tile_bounds",),
    "models/deform.py:init_mlp": ("models.deform.init_mlp_params",),
    "models/deform.py:apply_mlp": ("models.deform.DeformMLP",),
    "models/deform.py:init_offset_net": ("models.deform.init_offset_params",
                                         "models.deform.OffsetNet"),
    "models/deform.py:init_se3_net": ("models.deform.init_se3_params", "models.deform.SE3Net"),
}

# "<module path>:<name>" (or "<module path>:*" for every name of a module) -> why
# the port has none.
NOT_PORTED = {
    "ops/scan_utils.py:*": "TPU workaround: scans and sorts as MXU matmuls and lane shifts, "
                           "faster than XLA's TPU lowering; the port calls torch.cumsum, "
                           "torch.cummax and torch.sort",
    "ops/binning.py:take_searchsorted": "TPU workaround: bisect_left in rounds of jnp.take, "
                                        "faster than jnp.searchsorted on a TPU; the port calls "
                                        "torch.searchsorted",
    "ops/binning.py:tile_bounds_from_sorted": "TPU workaround: tile bounds by one scatter and "
                                              "a reverse cummax, to dodge the TPU's binary "
                                              "search; the port's tile_bounds searchsorts",
    "parallel/sharding.py:train_state_specs": "TPU workaround: PartitionSpecs of the train "
                                              "state for JAX's SPMD mesh; the port runs one "
                                              "process a device and shards by hand",
    "training.py:stack_camera_arrays": "JAX's batch eval maps over one stacked camera batch "
                                       "inside a jit; the port's make_eval_render_batch takes "
                                       "a list of CameraArrays",
    "viewer.py:MiniCamView": "an empty class that nothing in the JAX package uses",
}


def _modules():
    out = []
    for dirpath, dirnames, filenames in os.walk(JAX_PKG):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.relpath(os.path.join(dirpath, f), JAX_PKG).replace(os.sep, "/")
                for f in sorted(filenames) if f.endswith(".py")]
    return out


MODULES = _modules()


def _public_names(rel):
    with open(os.path.join(JAX_PKG, rel)) as f:
        tree = ast.parse(f.read(), rel)
    return [(node.name, node.lineno) for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


def _resolve(dotted):
    """Import the longest module prefix of ``PORT.dotted`` and walk the rest
    as attributes."""
    parts = f"{PORT}.{dotted}".split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def _port_module(rel):
    dotted = rel[:-3].replace("/", ".")
    if dotted == "__init__":
        return importlib.import_module(PORT)
    if dotted.endswith(".__init__"):
        dotted = dotted[: -len(".__init__")]
    try:
        return importlib.import_module(f"{PORT}.{dotted}")
    except ModuleNotFoundError:
        return None


def test_module_list():
    assert len(MODULES) >= 40 and "ops/projection.py" in MODULES


def test_maps_name_real_jax_names():
    """Every key of both maps names a JAX module and, but for ``*``, one of its
    public names: an entry cannot outlive what it maps."""
    for key in (*COUNTERPARTS, *NOT_PORTED):
        rel, name = key.split(":")
        assert rel in MODULES, key
        assert name == "*" or name in dict(_public_names(rel)), key


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_have_counterparts(rel):
    port = _port_module(rel)
    missing = []
    for name, line in _public_names(rel):
        key = f"{rel}:{name}"
        if key in COUNTERPARTS:
            for dotted in COUNTERPARTS[key]:
                _resolve(dotted)  # raises if the counterpart is gone
        elif key in NOT_PORTED or f"{rel}:*" in NOT_PORTED:
            continue
        elif port is None or not hasattr(port, name):
            missing.append(f"gs_deformable_tpu/{rel}:{line} {name}")
    assert not missing, ("public names of the JAX package with no counterpart in the port "
                         "(port them, or map them in COUNTERPARTS or NOT_PORTED): "
                         + ", ".join(missing))
