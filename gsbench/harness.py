"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

Everything a cell is made of is found by name under this directory:
``cells/<cell>.json`` names its configuration, its traffic mix and the
limits of its check; ``configs/<config>.json`` holds the configuration;
``traffic/<mix>.json`` holds the mix's parameters and names its generator
``traffic/<kind>.py``; every ``layers/<metric>.py`` is one per-layer
metric's reader.  Adding one of them edits no file here.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional

import torch

from . import check
from .reference import render as ref_render
from .trace import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "gs_deformable_tpu")
UNIT_RANGE = "gsbench.unit"
TRACED_RANGE = "gsbench.traced"


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return {"name": name, **json.load(f)}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module(os.path.join(HERE, "traffic", f"{kind}.py"), f"gsbench_traffic_{kind}")


def readers() -> Dict[str, types.ModuleType]:
    """Every per-layer reader by its metric's name (the file's name)."""
    folder = os.path.join(HERE, "layers")
    return {f[:-3]: _module(os.path.join(folder, f), "gsbench_layer_" + f[:-3].replace(".", "_"))
            for f in sorted(os.listdir(folder)) if f.endswith(".py")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@contextlib.contextmanager
def ranged(ranges: Dict[str, set]):
    """Each (module, attribute) of each range replaced, where callers look it
    up, by a call inside ``record_function`` of the range's name; an
    autograd Function is replaced by an object whose ``apply`` is."""
    saved = []

    def wrap(fn, name):
        def call(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return call

    try:
        for name, targets in ranges.items():
            for modname, attr in sorted(targets):
                mod = importlib.import_module(modname)
                obj = getattr(mod, attr)
                saved.append((mod, attr, obj))
                if isinstance(obj, type) and hasattr(obj, "apply"):
                    setattr(mod, attr, types.SimpleNamespace(apply=wrap(obj.apply, name)))
                else:
                    setattr(mod, attr, wrap(obj, name))
        yield
    finally:
        for mod, attr, obj in reversed(saved):
            setattr(mod, attr, obj)


def unit():
    """The range around each call into the program in the traced stretch."""
    return torch.profiler.record_function(UNIT_RANGE)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def build_kernels(device) -> float:
    """Seconds to build (first run in a checkout) or find the port's kernels."""
    if torch.device(device).type != "cuda":
        return 0.0
    from gs_deformable_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def trace_record(sess, window: dict, layer_readers: dict) -> dict:
    """The traced stretch's record for the readers; ``window`` is the
    measured window's result."""
    ranges: Dict[str, set] = {}
    for r in layer_readers.values():
        for name, targets in getattr(r, "RANGES", {}).items():
            ranges.setdefault(name, set()).update(tuple(t) for t in targets)
    sess.before_trace()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(sess.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with ranged(ranges), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(TRACED_RANGE):
            units = sess.traced()
            sync(sess.device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gsbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
    finally:
        os.remove(path)
    lo, hi = tr.span(TRACED_RANGE)
    busy_us, gaps = tr.busy(lo, hi)
    return {"units": units, "unit_s": window["unit_s"], "window": window,
            "window_s": (hi - lo) / 1e6,
            "busy_s": busy_us / 1e6,
            "layers": {name: tr.share([name]) for name in ranges},
            "launches": tr.share([UNIT_RANGE])["events"],
            "breakdown": {"device_ops": tr.top_ops(lo, hi),
                          "idle_gaps": tr.gaps_by_host(gaps, TRACED_RANGE)}}


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        start_wall: Optional[float] = None, overrides: Optional[dict] = None,
        log=print) -> dict:
    """Run ``workload`` once; returns the result line's object, with
    ``forbidden`` (modules found) and ``checked`` (name, number, limit)."""
    now = time.time()
    start_wall = now if start_wall is None else start_wall
    cell = load("cells", workload)
    config = load("configs", cell["config"])
    mix = {**load("traffic", cell["traffic"]), **(overrides or {})}
    gen = traffic(mix["kind"])
    build_s = build_kernels(device)
    log(f"kernels built or found in {build_s:.3f} s")
    sess = gen.Session(config, mix, seed, device)
    sess.setup()
    sync(device)
    setup_s = time.time() - start_wall
    res = sess.window(seconds)
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}, **res["metrics"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if torch.device(device).type == "cuda"
           else "cpu", "count": 1}
    rec = None
    if trace:
        layer_readers = readers()
        rec = trace_record(sess, res, layer_readers)
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    power = card() if torch.device(device).type == "cuda" else "cpu"
    sess.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = sess.numbers(ref_render.stated(config))
    ok, rows = check.verdict(numbers, cell["limits"])
    log(f"reference check in {time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{k}={v}" for k, v in numbers.items() if k.startswith("_")))
    out = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        rec.update(kind=gen.KIND, config=config, mix=mix, work=sess.traced_work())
        log(f"traced {rec['units']} units: work {rec['work']}, launches {rec['launches']}, "
            f"layers (device ms) {rec['layers']}")
        metrics = {}
        for name, r in layer_readers.items():
            v = r.read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": r.UNIT}
        dev["busy_s"], dev["window_s"] = rec["busy_s"], rec["window_s"]
        out["breakdown"] = rec["breakdown"]
    out["metrics"] = metrics
    out["device"] = dev
    out["card"] = power
    out["setup"] = {"start_to_harness_s": now - start_wall, "kernel_build_s": build_s,
                    **sess.setup_times}
    out["forbidden"] = forbidden_modules()
    out["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out
