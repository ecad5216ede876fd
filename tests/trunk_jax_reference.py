"""The JAX package's "bfloat16" tier of the 8 x 256 deformation trunks on
the CPU, forward and gradients, for ``trunk_cases.full_width_case``.

The card tests hold the port's tensor-core trunk to it where JAX is not
installed, so it is stored in ``golden/trunk_jax_bf16.npz``;
``test_torch_deform.py`` holds the stored file to a fresh computation.
Rewrite the file with

    JAX_PLATFORMS=cpu python tests/trunk_jax_reference.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trunk_cases  # noqa: E402


def compute(kind: str):
    """(heads' outputs side by side, gradients of ``[x, t, *param_list]``)
    of ``gs_deformable_tpu.models.deform.apply_mlp`` in the bf16 tier, as
    fp32 numpy; the gradients by ``jax.grad`` of the outputs' dot product
    with the case's cotangent."""
    import jax
    import jax.numpy as jnp

    from gs_deformable_tpu.config import DeformConfig
    from gs_deformable_tpu.models import deform as jdeform

    params, x, t, cot = trunk_cases.full_width_case(kind)
    skips = DeformConfig().skips

    def heads(p, x, t):
        return jnp.concatenate(jdeform.apply_mlp(p, x, t, skips, jnp.bfloat16), axis=1)

    def loss(p, x, t):
        return jnp.sum(heads(p, x, t) * cot)

    p = jax.tree_util.tree_map(jnp.asarray, params)
    out = jax.jit(heads)(p, x, t)
    gp, gx, gt = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(p, x, t)
    grads = [gx, gt, *trunk_cases.param_list(gp)]
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """The top 16 bits of each fp32, rounded to nearest even."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def main():
    arrays = {}
    for kind in trunk_cases.KINDS:
        out, grads = compute(kind)
        arrays[f"{kind}.out"] = out
        arrays[f"{kind}.grads"] = np.asarray(len(grads))
        for i, g in enumerate(grads):
            if i < 2 or g.ndim == 2:  # the inputs' (rounded) and the weights' (bf16 already)
                arrays[f"{kind}.g{i}.bf16"] = _bf16_bits(g)
                exact = (arrays[f"{kind}.g{i}.bf16"].astype(np.uint32) << 16).view(np.float32)
                assert i < 2 or np.array_equal(exact, g), f"{kind} gradient {i} is not bf16"
            else:  # the biases'
                arrays[f"{kind}.g{i}"] = g
    np.savez_compressed(trunk_cases.JAX_REFERENCE, **arrays)
    print(f"wrote {trunk_cases.JAX_REFERENCE}: {os.path.getsize(trunk_cases.JAX_REFERENCE)} bytes")


if __name__ == "__main__":
    main()
