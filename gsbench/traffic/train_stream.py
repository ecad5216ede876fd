"""``train_stream``: the trainer's own dispatch of training steps.

``training.make_chunk_step`` with ``chunk_max`` views a call, chunks cut
before each multiple of 1000 as the trainer cuts them, the counters and
losses drained every ``drain_chunks`` chunks.  Views are D-NeRF's: ``views``
cameras on the arc around the cloud (the same for every seed), view i at
time i / (views - 1), drawn in the trainer's order (a stack refilled when empty and popped at
``random.Random(seed)`` indices); their ground truths are the reference's
images of the truth (the trained state with other colours), made in set-up
and held on the card.  Steps run from ``first_iteration``: past the nets'
warm-up and the last densify, at the last SH degree, so the scene keeps its
size through the window.

The first three steps, driven through the same call in set-up, are what the
check compares with the reference; a chunk of ``chunk_max`` steps follows
them as the warm-up.
"""

from __future__ import annotations

import random
import time

import torch

from gsbench import check, harness, scene
from gsbench.reference import render as ref_render
from gsbench.reference import train as ref_train
from gsbench.session import Base

KIND = "train"
CHECKED_STEPS = 3


class Session(Base):
    def setup(self) -> None:
        from gs_deformable_tpu_torch import training

        m = self.mix
        with self.stage("scene"):
            self.make_scene()
            self.bg = torch.zeros(3, device=self.device)
            c2ws = scene.train_views(m["views"])
            self.views = [scene.view_arrays(c, i / (m["views"] - 1), m["width"], m["height"],
                                            m["fovx"]) for i, c in enumerate(c2ws)]
            self.extent = scene.camera_extent(c2ws)
        with self.stage("ground_truth"):
            self.gts = [self.reference_image(v, "truth") for v in self.views]
        if self.device.type == "cuda":  # the peak read after the window is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with self.stage("program"):
            self.make_program()
            self.cams = [self.camera(v) for v in self.views]
            ts = training.init_train_state(self.state, self.net, self.seed, self.latent)
            v = self.views[0]
            self.run = training.make_chunk_step(
                self.pcfg, width=m["width"], height=m["height"], tan_fovx=v.tan_fovx,
                tan_fovy=v.tan_fovy, active_sh_degree=self.config["sh_degree"],
                spatial_lr_scale=self.extent, chunk_max=m["chunk_max"], device=self.device)
        self.order = random.Random(self.seed)
        self.stack, self.pending, self.it = [], [], m["first_iteration"]
        self.n = self.clouds["state"].xyz.shape[0]
        with self.stage("checked_steps"):
            self.checked_views, self.checked_losses = [], []
            ts = self._chunk(ts, 1, self.checked_views, self.checked_losses)
            self.mu1 = ts.adam.mu
            ts = self._chunk(ts, CHECKED_STEPS - 1, self.checked_views, self.checked_losses)
            self.after = self._params(ts)
            self.checked_iterations = list(range(m["first_iteration"],
                                                 m["first_iteration"] + CHECKED_STEPS))
        with self.stage("warmup"):
            ts = self._chunk(ts, m["chunk_max"])
            self._drain()
        self.ts = ts

    def _next_view(self) -> int:
        if not self.stack:
            self.stack = list(range(len(self.views)))
        return self.stack.pop(self.order.randint(0, len(self.stack) - 1))

    def _chunk(self, ts, h: int, used=None, losses=None):
        """One call of the chunk step over the next ``h`` views (fewer where a
        multiple of 1000 comes first), padded as the trainer pads."""
        from gs_deformable_tpu_torch.renderer import CameraArrays

        h = min(h, (self.it // 1000 + 1) * 1000 - self.it)
        idx = [self._next_view() for _ in range(h)]
        pad = idx + [idx[-1]] * (self.mix["chunk_max"] - h)
        cams = CameraArrays(*(torch.stack(xs) for xs in zip(*(self.cams[i] for i in pad))))
        gts = torch.stack([self.gts[i] for i in pad])
        step_losses = [] if losses is None else losses
        ts, metrics = self.run(ts, cams, gts, self.bg, self.it, h, step_losses)
        self.pending.append((metrics["overflow_frames"], step_losses[-h:], h))
        self.it += h
        if used is not None:
            used.extend(idx)
        self.last_views = idx
        return ts

    def _drain(self) -> tuple:
        """(steps, failed) since the last drain, read in one wait for the card:
        a step fails when it overflowed the instance capacity or its loss is
        not finite (counted per chunk as the larger of the two)."""
        rows = [torch.stack([of.to(torch.float32),
                             (~torch.isfinite(torch.stack(ls))).sum().to(torch.float32)])
                for of, ls, _ in self.pending]
        vals = torch.stack(rows).tolist()
        steps = sum(h for _, _, h in self.pending)
        failed = sum(min(h, int(max(a, b))) for (a, b), (_, _, h) in zip(vals, self.pending))
        self.pending = []
        return steps, failed

    def _params(self, ts) -> dict:
        """Every leaf of ``ts`` on the alive rows, by the reference's names."""
        out = {k: v[:self.n] for k, v in ts.gaussians.params().items()}
        for part, mods in (("layers", ts.net.layers), ("heads", ts.net.heads)):
            for i, mod in enumerate(mods):
                out[f"net.{part}.{i}.w"] = mod.w.detach().clone()
                out[f"net.{part}.{i}.b"] = mod.b.detach().clone()
        return out

    def window(self, seconds: float) -> dict:
        ts = self.ts
        steps = failed = 0
        t0 = time.perf_counter()
        while True:
            for _ in range(self.mix["drain_chunks"]):
                ts = self._chunk(ts, self.mix["chunk_max"])
            s, f = self._drain()
            steps, failed = steps + s, failed + f
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.device)
        elapsed = time.perf_counter() - t0
        self.ts = ts
        return {"attempted": steps, "failed": failed, "unit_s": elapsed / steps,
                "metrics": {"train_ms_per_step": {"value": 1e3 * elapsed / steps,
                                                  "unit": "ms/step"}}}

    def before_trace(self) -> None:
        """The state the traced steps start from, for the reference's counts."""
        p = self._params(self.ts)
        self.trace_g = {k: p[k].clone() for k in ref_train.GROUPS}
        self.trace_nets = {**self.nets_ref, "net": {
            part: [{"w": p[f"net.{part}.{i}.w"], "b": p[f"net.{part}.{i}.b"]}
                   for i in range(len(self.nets_ref["net"][part]))]
            for part in ("layers", "heads")}}

    def traced(self) -> int:
        ts, views = self.ts, []
        for _ in range(self.mix["drain_chunks"]):
            with harness.unit():
                ts = self._chunk(ts, self.mix["chunk_max"])
            views += self.last_views
        steps, _ = self._drain()
        self.ts, self.trace_views = ts, views
        return steps

    def traced_work(self) -> dict:
        """Pair counts of the traced steps' frames, from the state at their start."""
        work = self.count([self.views[i] for i in self.trace_views], self.trace_g,
                          self.trace_nets)
        return {**work, "train": True, "rows": self.n}

    def release(self) -> None:
        self.checked_gts = [self.gts[i] for i in self.checked_views]
        for name in ("ts", "run", "cams", "gts", "state", "net", "latent"):
            self.__dict__.pop(name, None)

    def numbers(self, prec: ref_render.Precision) -> dict:
        beta = 1.0 - self.pcfg.opt.adam_b1
        grads = {k: self.mu1[k][:self.n] / beta for k in ref_train.GROUPS}
        for part in ("layers", "heads"):
            for i, layer in enumerate(self.mu1["offset_model"][part]):
                for k in ("w", "b"):
                    grads[f"net.{part}.{i}.{k}"] = layer[k] / beta
        prog = {"losses": [float(x) for x in self.checked_losses[:CHECKED_STEPS]],
                "grads": grads, "params": self.after}
        ref = ref_train.steps(self.config, self.nets_ref, self.gaussians("state"),
                              [ref_render.view_tensors(self.views[i], self.device)
                               for i in self.checked_views],
                              self.checked_gts, self.checked_iterations, self.extent, self.bg,
                              prec)
        initial = ref_train.leaves(self.gaussians("state"), self.nets_ref)
        return check.train_numbers(prog, ref, initial)
