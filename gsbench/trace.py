"""Reading a ``torch.profiler`` chrome trace: device time by range, launches,
busy time, and where the card idles.

``Trace.share`` is ``chip_smoke.trace_share``, frozen here.  A device event
(kernel, copy or set) belongs to the op whose "External id" it carries; the
op is in the forward of a range when the range encloses it on its thread,
and in the backward when an autograd node encloses it ("...Backward..." or
"autograd::engine::evaluate_function: ...") whose "Sequence number" one of
the range's ops took: the sequence numbers that a range's ops take are
those of the nodes that the range makes.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: List[dict]):
        events = [e for e in events if e.get("ph") == "X"]
        self.cpu = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        cpu = self.cpu
        self.parent: Dict[int, Optional[int]] = {}
        threads: Dict[tuple, List[int]] = {}
        for i, e in enumerate(cpu):
            threads.setdefault((e["pid"], e["tid"]), []).append(i)
        for idxs in threads.values():
            idxs.sort(key=lambda i: (cpu[i]["ts"], -cpu[i]["dur"]))
            stack: List[int] = []
            for i in idxs:
                end = cpu[i]["ts"] + cpu[i]["dur"]
                while stack and cpu[stack[-1]]["ts"] + cpu[stack[-1]]["dur"] < end - 1e-3:
                    stack.pop()
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def _chain(self, i):
        while i is not None:
            yield i
            i = self.parent[i]

    def share(self, ranges: Iterable[str]) -> Dict[str, float]:
        """Device ms of the ``ranges``' forward and backward, and of all events."""
        ranges = set(ranges)
        cpu = self.cpu
        in_range = [any(cpu[j]["name"] in ranges for j in self._chain(i))
                    for i in range(len(cpu))]
        seqs: Dict[int, List[int]] = {}
        for i in range(len(cpu)):
            n = cpu[i].get("args", {}).get("Sequence number")
            if in_range[i] and n is not None:
                top = next(j for j in self._chain(i) if cpu[j]["name"] in ranges)
                seqs.setdefault(top, []).append(n)
        spans = sorted((min(v), max(v)) for v in seqs.values())
        los = [lo for lo, _ in spans]
        reach = []  # the highest end of the spans up to each one
        for _, hi in spans:
            reach.append(max(hi, reach[-1]) if reach else hi)

        def node(e):
            n = e.get("args", {}).get("Sequence number")
            if n is None or not ("Backward" in e["name"] or e["name"].startswith(
                    "autograd::engine::evaluate_function")):
                return False
            j = bisect.bisect_right(los, n) - 1
            return j >= 0 and reach[j] >= n

        side = {}
        for i, e in enumerate(cpu):
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                side[ext] = ("forward" if in_range[i] else
                             "backward" if any(node(cpu[j]) for j in self._chain(i)) else None)
        total = {"all": 0.0, "forward": 0.0, "backward": 0.0, "events": 0}
        for e in self.device:
            total["all"] += e["dur"] / 1e3
            where = side.get(e.get("args", {}).get("External id"))
            if where:
                total[where] += e["dur"] / 1e3
                total["events"] += 1
        return total

    def span(self, name: str) -> Tuple[float, float]:
        """(start, end) in us of the first host range called ``name``."""
        e = next(e for e in self.cpu if e["name"] == name)
        return e["ts"], e["ts"] + e["dur"]

    def busy(self, lo: float, hi: float) -> Tuple[float, List[Tuple[float, float]]]:
        """Microseconds in [lo, hi] in which a device event ran, and the idle gaps."""
        iv = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in self.device
                    if e["ts"] < hi and e["ts"] + e["dur"] > lo)
        busy, gaps, cur = 0.0, [], lo
        for a, b in iv:
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if hi > cur:
            gaps.append((cur, hi))
        return busy, gaps

    def top_ops(self, lo: float, hi: float, k: int = 10) -> List[list]:
        """The ``k`` device operations that took the most time in [lo, hi], in seconds."""
        acc: Dict[str, float] = {}
        for e in self.device:
            if lo <= e["ts"] < hi:
                acc[e["name"][:120]] = acc.get(e["name"][:120], 0.0) + e["dur"] / 1e6
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]

    def gaps_by_host(self, gaps: List[Tuple[float, float]], tid_of: str,
                     k: int = 10) -> List[list]:
        """Idle gaps summed (seconds) by the innermost host op that ran on the
        thread of the range ``tid_of`` at each gap's middle, the longest first."""
        root = next(e for e in self.cpu if e["name"] == tid_of)
        idx = sorted((i for i, e in enumerate(self.cpu)
                      if (e["pid"], e["tid"]) == (root["pid"], root["tid"])),
                     key=lambda i: self.cpu[i]["ts"])
        starts = [self.cpu[i]["ts"] for i in idx]
        acc: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            j = bisect.bisect_right(starts, mid) - 1
            name = "outside any host op"
            for i in self._chain(idx[j] if j >= 0 else None):
                if self.cpu[i]["ts"] + self.cpu[i]["dur"] >= mid:
                    name = self.cpu[i]["name"][:120]
                    break
            acc[name] = acc.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]
