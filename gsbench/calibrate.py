#!/usr/bin/env python3
"""Readings from which a cell's limits are set, for many seeds in one process.

    python3 gsbench/calibrate.py --workload <cell> --seeds 1 2 3 [--seconds 2]

For each seed: the cell's set-up, a window of ``--seconds`` (render cells
sample their checked frames from it), then each number of the check for the
program against the reference at the configuration's precision ("program")
and for the reference computed one precision lower in the program's place
("control").  One JSON line per seed and side on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from gsbench import harness
    from gsbench.reference import render as ref_render

    cell = harness.load("cells", args.workload)
    config = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    gen = harness.traffic(mix["kind"])
    harness.build_kernels("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        sess = gen.Session(config, mix, seed, "cuda")
        sess.setup()
        res = sess.window(args.seconds)
        sess.release()
        torch.cuda.empty_cache()
        for side, prec in (("program", ref_render.stated(config)),
                           ("control", ref_render.control(config))):
            t1 = time.perf_counter()
            nums = sess.numbers(prec)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "attempted": res["attempted"], "failed": res["failed"],
                              "check_s": time.perf_counter() - t1,
                              "setup": sess.setup_times, **nums}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del sess
    return 0


if __name__ == "__main__":
    sys.exit(main())
