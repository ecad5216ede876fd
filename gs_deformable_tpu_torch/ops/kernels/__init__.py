"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper takes its plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor.  Each keeps a launch counter, a plain
integer that rises by one per kernel launch and nowhere else, so a run can
show that its main path went through the kernels.  A call captured into a
CUDA graph counts once, when it is captured; the graph's replays launch the
kernel without Python and are not counted.

``WRAPPERS`` and ``launch_counts`` cover every kernel: the rasterizer's
(screen space, the tile cull, the fills, the composite), whose launches
a frame and a step do not depend on the net, and the deformation trunk's
epilogues, which launch once a hidden layer a net in the bf16 tiers
(``trunk_bias_relu`` forward, ``trunk_relu_mask`` backward) and never in
"float32" or before the nets' warmup ends.
"""

from __future__ import annotations

from . import composite, ordered_fill, screen_space, tile_cull, trunk

WRAPPERS = {
    "composite_forward": composite.composite_forward,
    "composite_backward": composite.composite_backward,
    "ordered_prefix_fill": ordered_fill.ordered_prefix_fill,
    "ordered_place_i32": ordered_fill.ordered_place_i32,
    "trunk_bias_relu": trunk.bias_relu_bf16,
    "trunk_relu_mask": trunk.relu_mask_bf16,
    "tile_cull": tile_cull.tile_cull,
    "screen_space_forward": screen_space.screen_space_forward,
    "screen_space_backward": screen_space.screen_space_backward,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
