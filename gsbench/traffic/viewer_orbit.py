"""``viewer_orbit``: a viewer scrubbing a dynamic scene, one closed loop.

Frame k renders through ``training.make_eval_render`` from the camera at
step k of an orbit swinging over the training arc (``orbit_frames`` frames
a period) at time (k / ``frames_per_time``) mod 1, the orbit's phase drawn
from the seed; the next frame is asked for once this one is on the host
side of a synchronise.  A frame's latency runs from its call to that
synchronise; the window keeps their 95th percentile for the traced run.
The program's own counters of each frame (instances needed against the
capacity) are copied as they come, to count overflowed frames.
``checked_frames`` frames, drawn from the seed over the whole window, are
compared with the reference's images once the window has closed.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from gsbench import check, harness, scene
from gsbench.reference import render as ref_render
from gsbench.session import Base

KIND = "render"


class Session(Base):
    def setup(self) -> None:
        from gs_deformable_tpu_torch import config as pc
        from gs_deformable_tpu_torch import training
        from gs_deformable_tpu_torch.ops.binning import aligned_capacity

        m = self.mix
        with self.stage("scene"):
            self.make_scene()
            self.bg = torch.zeros(3, device=self.device)
            period, per_time = m["orbit_frames"], m["frames_per_time"]
            self.phase = int(self.rng.integers(period * per_time))
            loop = period * per_time // math.gcd(period, per_time)
            self.views = []
            for k in range(loop):
                f = self.phase + k
                angle = scene.ARC_HALF_ANGLE * math.sin(2.0 * math.pi * f / period)
                self.views.append(scene.view_arrays(scene.arc_c2w(angle, 0.0),
                                                    (f / per_time) % 1.0, m["width"],
                                                    m["height"], m["fovx"]))
        with self.stage("program"):
            self.make_program()
            v = self.views[0]
            self.render = training.make_eval_render(
                self.pcfg, width=m["width"], height=m["height"], tan_fovx=v.tan_fovx,
                tan_fovy=v.tan_fovy, active_sh_degree=self.config["sh_degree"],
                device=self.device)
            r = self.pcfg.raster
            tiles = -(-m["width"] // r.tile_x) * -(-m["height"] // r.tile_y)
            self.kp = aligned_capacity(r.instance_capacity, tiles, pc.layout_unit(r),
                                       r.aligned_slack)
            self.counters = []
            self._training, self._render = training, training.render

            def counted(*a, **k):
                out, dx = self._render(*a, **k)
                self.last_counters = (out.required_instances, out.required_aligned)
                return out, dx

            training.render = counted
        self.k = 0
        with self.stage("warmup"):
            for _ in range(m["warmup_frames"]):
                self._frame()
            harness.sync(self.device)
        self.counters = []
        self.sample, self.sample_rng = [], np.random.default_rng(self.seed + 1)

    def _frame(self, traced: bool = False) -> torch.Tensor:
        i = self.k % len(self.views)
        self.k += 1
        self.last_view = i
        with harness.unit() if traced else contextlib.nullcontext():
            img = self.render(self.state, self.net, self.camera(self.views[i]), self.bg,
                              self.mix["iteration"], self.latent)
        # Copied: the program's counter is a view that would keep its frame's
        # buffers alive, and the window's peak memory with them.
        self.counters.append(torch.stack(self.last_counters))
        return img

    def window(self, seconds: float) -> dict:
        lat, bad, n = [], [], 0
        want = self.mix["checked_frames"]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            img = self._frame()
            harness.sync(self.device)
            lat.append(time.perf_counter() - ts)
            bad.append(~torch.isfinite(img).all())
            j = n if n < want else int(self.sample_rng.integers(n + 1))
            if j < want:  # a uniform sample of the frames, drawn from the seed
                entry = (img, self.last_view)
                if n < want:
                    self.sample.append(entry)
                else:
                    self.sample[j] = entry
            n += 1
        harness.sync(self.device)
        elapsed = time.perf_counter() - t0
        req = torch.stack(self.counters)
        over = (req[:, 0] > self.pcfg.raster.instance_capacity) | (req[:, 1] > self.kp)
        failed = int((torch.stack(bad) | over).sum())
        self.counters = []
        p95 = float(np.percentile(np.array(lat) * 1e3, 95))
        return {"attempted": n, "failed": failed, "unit_s": elapsed / n, "p95_ms": p95,
                "metrics": {"render_ms_per_frame": {"value": 1e3 * elapsed / n,
                                                    "unit": "ms/frame"}}}

    def before_trace(self) -> None:
        self.trace_views = []

    def traced(self) -> int:
        for _ in range(self.mix["traced_frames"]):
            self._frame(traced=True)
            harness.sync(self.device)
            self.trace_views.append(self.last_view)
        self.counters = []
        return self.mix["traced_frames"]

    def traced_work(self) -> dict:
        work = self.count([self.views[i] for i in self.trace_views], self.gaussians(),
                          self.nets_ref)
        return {**work, "train": False, "rows": self.clouds["state"].xyz.shape[0]}

    def release(self) -> None:
        self._training.render = self._render
        for name in ("render", "state", "net", "latent", "counters"):
            self.__dict__.pop(name, None)

    def numbers(self, prec: ref_render.Precision) -> dict:
        ref = [self.reference_image(self.views[i], "state", prec) for _, i in self.sample]
        return {"image_gap": check.image_gap([img for img, _ in self.sample], ref)}
