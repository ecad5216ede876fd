"""Adversarial position sets for the ordered-fill kernels.

Shared by the CPU parity tests against JAX (tests/test_torch_ordered_fill.py)
and the card tests against the plain versions (tests/test_torch_kernels_cuda.py),
so the kernel is held to the same contract the reference is.  Each set is
sorted and unique, led by negative rows and followed by rows >= K, which
must drop.  BLOCK is the number of output positions one CUDA block of
gs_deformable_tpu_torch/csrc/ordered_fill.cu owns.
"""

import numpy as np

BLOCK = 4096

# (kind, K, C): block edges with K not a multiple of 4 (so rows 1 and 2 of
# the (C, K) output start off 16-byte alignment); one segment spanning more
# than 64 blocks; every position filled; no row in range; no row at all;
# random positions at every channel count.
PREFIX_CASES = [
    ("block_edges", 5 * BLOCK + 3, 3),
    ("block_edges", 4 * BLOCK, 1),
    ("long_segment", 72 * BLOCK + 2, 2),
    ("dense", 2 * BLOCK + 2, 4),
    ("out_of_range", BLOCK + 3, 2),
    ("empty", 100, 2),
    *[("random", 3 * BLOCK + 1 + C % 4, C) for C in range(1, 9)],
]
PLACE_CASES = [
    ("block_edges", 5 * BLOCK + 3),
    ("long_segment", 72 * BLOCK + 2),
    ("dense", 2 * BLOCK + 1),
    ("out_of_range", BLOCK + 3),
    ("empty", 100),
    ("random", 3 * BLOCK + 2),
]


def positions(kind: str, K: int, seed: int = 0) -> np.ndarray:
    """Sorted unique int32 positions of one kind for an output of K."""
    if kind == "empty":
        return np.zeros(0, np.int32)
    rng = np.random.default_rng(seed)
    if kind == "block_edges":  # on every multiple of BLOCK and one off each way
        edges = np.arange(0, K + BLOCK, BLOCK)
        p = np.unique(np.concatenate([edges - 1, edges, edges + 1]))
    elif kind == "long_segment":
        p = np.array([0, 3, 17, 70 * BLOCK + 5, K - 1])
    elif kind == "dense":
        p = np.arange(K)
    elif kind == "random":
        p = np.sort(rng.choice(K, K // 3, replace=False))
    elif kind == "out_of_range":
        p = np.zeros(0, np.int64)
    else:
        raise ValueError(kind)
    p = p[(p >= 0) & (p < K)]
    return np.concatenate([np.arange(-3, 0), p, K + np.arange(4)]).astype(np.int32)


def values(n: int, C: int, high: int, seed: int = 0) -> np.ndarray:
    """(n, C) int32 values in [-high, high).  The JAX kernels carry integers in
    fp32 lanes, so against them every running sum must stay below 2^24."""
    return np.random.default_rng(seed + 1).integers(-high, high, (n, C)).astype(np.int32)


def moved_drops(K: int, n: int, seed: int) -> np.ndarray:
    """n sorted unique int32 positions for an output of K: a seeded number of
    negative rows, random positions in [0, K), then rows >= K.  The drops at
    both ends move from seed to seed while n stays, as the sets a replayed
    CUDA graph is fed must keep their length."""
    rng = np.random.default_rng(seed)
    lead, tail = (int(x) for x in rng.integers(0, n // 8 + 1, 2))
    mid = min(n - lead - tail, K)
    tail = n - lead - mid
    p = np.sort(rng.choice(K, mid, replace=False))
    return np.concatenate([np.arange(-lead, 0), p, K + np.arange(tail)]).astype(np.int32)
