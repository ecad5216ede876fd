#!/usr/bin/env python3
"""Run one cell of the benchmark once on one card and print its result line.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
JSON result; the numbers the check compared, each beside its limit, are the
last lines of standard error.  Exits 2 without a result when there is no
CUDA card, and 3 when JAX, Flax or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(ROOT, "gsbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: torch.cuda.is_available() is False or no device", file=sys.stderr)
        return 2
    from gsbench import harness

    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      start_wall=START, log=lambda *a: print(*a, file=sys.stderr, flush=True))
    if out.pop("forbidden"):
        print(f"loaded JAX or the JAX package: {harness.forbidden_modules()}", file=sys.stderr)
        return 3
    for name, row in out["checked"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
