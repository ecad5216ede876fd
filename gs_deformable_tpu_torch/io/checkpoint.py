"""Training checkpoints: a ``TrainState`` as one path-keyed compressed .npz.

Port of ``gs_deformable_tpu/io/checkpoint.py``.  Keys are the JAX
package's tree paths wherever the two states share a field:
``.gaussians/.xyz``, ``.deform/['layers']/[0]/['w']`` (the offset or
SE(3) net), ``.latent/['opacity_mask']/['heads']/[0]/['w']`` (the latent
heads), ``.adam/.mu/['offset_model']/['heads']/[0]/['b']``, ``.adam/.step``,
and ``__iteration__``.  The port writes its generator's state under
``.generator/<device type>`` and has no ``.key`` leaf; loading keeps the
template's value for every key the file lacks and ignores keys the
template lacks, as the JAX loader does, so a file written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.deform import rebuild
from ..models.gaussians import AdamState, GaussianState
from ..training import TrainState
from .model_ply import map_tree, to_numpy


def _generator_key(ts: TrainState) -> str:
    return f".generator/{ts.generator.device.type}"


def _items(ts: TrainState) -> Dict[str, torch.Tensor]:
    flat = {f".gaussians/.{f.name}": getattr(ts.gaussians, f.name)
            for f in dataclasses.fields(ts.gaussians)}

    def put(k, v):
        flat[k] = v

    if ts.net is not None:
        map_tree(ts.net.param_tree(), put, ".deform")
    if ts.latent is not None:
        map_tree({k: m.param_tree() for k, m in ts.latent.items()}, put, ".latent")
    map_tree(ts.adam.mu, put, ".adam/.mu")
    map_tree(ts.adam.nu, put, ".adam/.nu")
    flat[".adam/.step"] = ts.adam.step
    return flat


def save_checkpoint(path: str, ts: TrainState, iteration: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: to_numpy(v) for k, v in _items(ts).items()}
    payload[_generator_key(ts)] = ts.generator.get_state().numpy()
    payload["__iteration__"] = np.asarray(iteration)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str, template: TrainState) -> Tuple[TrainState, int]:
    """(state, iteration) restored into the structure of ``template``, on its
    devices.  Shapes and dtypes must match: the capacity is part of the
    config.  The template's tensors are not modified."""
    with np.load(path, allow_pickle=False) as data:
        def restore(k, leaf):
            if k not in data:
                return leaf.detach().clone()
            arr = data[k]
            t = torch.as_tensor(arr, device=leaf.device)
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(f"{path}: {k} is {t.dtype}{tuple(t.shape)}, the template "
                                 f"needs {leaf.dtype}{tuple(leaf.shape)}")
            return t

        g = template.gaussians
        gaussians = GaussianState(**{f.name: restore(f".gaussians/.{f.name}", getattr(g, f.name))
                                     for f in dataclasses.fields(g)})

        def restore_net(net, prefix):
            params = map_tree(net.param_tree(), lambda k, t: restore(k, t).cpu().numpy(),
                              prefix)
            return rebuild(net, params, g.xyz.device)

        net = None if template.net is None else restore_net(template.net, ".deform")
        latent = None if template.latent is None else {
            k: restore_net(m, f".latent/['{k}']") for k, m in template.latent.items()}
        adam = AdamState(mu=map_tree(template.adam.mu, restore, ".adam/.mu"),
                         nu=map_tree(template.adam.nu, restore, ".adam/.nu"),
                         step=restore(".adam/.step", template.adam.step))
        generator = torch.Generator(device=template.generator.device)
        gen_key = _generator_key(template)
        generator.set_state(torch.from_numpy(data[gen_key]) if gen_key in data
                            else template.generator.get_state())
        iteration = int(data["__iteration__"])
    return TrainState(gaussians, net, adam, generator, latent), iteration
