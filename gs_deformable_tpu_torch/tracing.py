"""Spans and counters of the port's layers, read from ``torch.profiler`` sessions.

Tracing is on exactly while a ``torch.profiler`` session records on the
calling thread (``torch._C._autograd._profiler_enabled()``): inside a
``with torch.profiler.profile(...)`` block, or the trainer's
``--profile_dir`` window.  There is no flag of its own.  With it off, a
``span`` or ``count`` costs that one check and enters no
``record_function``.

- ``span(name)``: a context manager.  On, it enters
  ``torch.profiler.record_function(name)``, so the span lands in the
  profiler's trace on the clock of its kernel, copy and set events, and it
  keeps per name the calls, host seconds and self seconds (host seconds
  less those of the spans opened inside it on the same thread).  Spans are
  opened on the caller's thread only, never inside an autograd
  ``backward``: backward kernels reach their layer through the autograd
  nodes' sequence numbers in the trace.
- ``count(name, value)``: on, adds ``value`` to the name's total.  A Python
  number goes into a host total; a 0-d tensor is added in place into one
  small integer accumulator on its device, with no wait for the device and
  no reference kept to the tensor.  ``count_set(name, mask, times)`` adds
  the set elements of a bool mask, summed once for each mask a session
  meets: one launch a call after the first.
- ``counters()`` and ``spans()`` read the totals.

The totals cover one profiler session: the first span or count made with
tracing on after one made with it off clears them.  So a process that
profiles several stretches of work reads each apart, as long as the program
is called between them with the profiler off; two sessions with no span or
count between them merge.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Dict

import torch

_profiling = torch._C._autograd._profiler_enabled
_SLOTS = 8  # an accumulator's first size; it doubles when names outgrow it


class _Totals:
    def __init__(self):
        self.fresh = True  # the next traced call starts a new session
        self.lock = threading.Lock()
        self.spans: Dict[str, list] = {}  # name -> [calls, host ns, self ns]
        self.host: Dict[str, float] = {}
        self.slots: Dict[str, int] = {}  # counter name -> accumulator index
        self.acc: Dict[torch.device, torch.Tensor] = {}
        self.sums: Dict[int, tuple] = {}  # id(mask) -> (weak ref, version, its sum)

    def begin(self) -> None:
        """Called with tracing on: clears the totals at a session's first call."""
        if self.fresh:
            with self.lock:
                self.fresh = False
                self.spans, self.host, self.slots, self.acc, self.sums = {}, {}, {}, {}, {}


_T = _Totals()
_local = threading.local()


def enabled() -> bool:
    """Whether tracing is on (a profiler records on this thread); off marks
    the end of a session."""
    if _profiling():
        _T.begin()
        return True
    _T.fresh = True
    return False


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        stack = _local.__dict__.setdefault("stack", [])
        stack.append(self)
        self.inner = 0
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].inner += dt
        with _T.lock:
            tot = _T.spans.setdefault(self.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += dt
            tot[2] += dt - self.inner
        return self.rf.__exit__(*exc)


def span(name: str):
    """A context manager: a profiler range ``name`` and its host times while
    tracing is on, nothing otherwise."""
    if not _profiling():
        _T.fresh = True
        return _OFF
    _T.begin()
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` (a Python number, or a 0-d integer tensor, added on its
    device) to the total ``name`` while tracing is on."""
    if not _profiling():
        _T.fresh = True
        return
    _T.begin()
    if not isinstance(value, torch.Tensor):
        with _T.lock:
            _T.host[name] = _T.host.get(name, 0) + value
        return
    _add(name, value, 1)


def count_set(name: str, mask: torch.Tensor, times: int = 1) -> None:
    """Add ``times`` x the number of set elements of the bool tensor ``mask``
    to the total ``name`` while tracing is on.  The sum is taken on the
    mask's device once for each mask, and version of it, that a session
    meets; a weak reference finds it again, and keeps no mask alive."""
    if not _profiling():
        _T.fresh = True
        return
    _T.begin()
    hit = _T.sums.get(id(mask))
    if hit is None or hit[0]() is not mask or hit[1] != mask._version:
        hit = (weakref.ref(mask), mask._version, mask.sum())
        _T.sums[id(mask)] = hit
    _add(name, hit[2], times)


def _add(name: str, value: torch.Tensor, times: int) -> None:
    with _T.lock:
        slot = _T.slots.setdefault(name, len(_T.slots))
        acc = _T.acc.get(value.device)
        if acc is None or acc.numel() <= slot:
            grown = torch.zeros(max(_SLOTS, 2 * (slot + 1)), dtype=torch.int64,
                                device=value.device)
            if acc is not None:
                grown[:acc.numel()] = acc
            _T.acc[value.device] = acc = grown
    acc[slot].add_(value, alpha=times)


def counters() -> Dict[str, float]:
    """Every counter's total of the last session, as host numbers (one wait
    for each device that holds counts)."""
    with _T.lock:
        out = dict(_T.host)
        accs, slots = list(_T.acc.values()), dict(_T.slots)
    for acc in accs:
        vals = acc.tolist()
        for name, slot in slots.items():
            if slot < len(vals):
                out[name] = out.get(name, 0) + vals[slot]
    return out


def spans() -> Dict[str, Dict[str, float]]:
    """``{name: {"calls", "host_s", "self_s"}}`` of the last session."""
    with _T.lock:
        return {name: {"calls": c, "host_s": h / 1e9, "self_s": s / 1e9}
                for name, (c, h, s) in _T.spans.items()}
