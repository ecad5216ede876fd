"""The readers of the exact tile cull's counters, on hand-made records and
totals made under a CPU profiler."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsbench import harness

READERS = {"cull_masked_rows.train": "train", "cull_masked_rows.render": "render"}


def record(kind, busy_s=0.5, units=4):
    return {"kind": kind, "busy_s": busy_s, "units": units}


def session():
    """Counters of one profiler session, as the program would leave them."""
    from gs_deformable_tpu_torch import tracing

    assert not tracing.enabled()  # ends the last session
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("cull.rows", torch.tensor(4 * 400, dtype=torch.int64))
        tracing.count("cull.masked_rows", torch.tensor(4 * 300, dtype=torch.int64))
    return tracing.counters()


@pytest.mark.parametrize("name", sorted(READERS))
def test_other_kind_and_no_card_read_nothing(name):
    session()
    r = harness.readers()[name]
    other = {"train": "render", "render": "train"}[READERS[name]]
    assert r.read(record(other)) is None
    assert r.read(record(READERS[name], busy_s=0.0)) is None
    assert r.read(record(READERS[name])) is not None


@pytest.mark.parametrize("name", sorted(READERS))
def test_share_of_masked_rows(name):
    session()
    assert harness.readers()[name].read(record(READERS[name])) == 75.0


def test_a_session_without_the_counters_reads_nothing():
    from gs_deformable_tpu_torch import tracing

    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("other", 1)
    for name, kind in READERS.items():
        assert harness.readers()[name].read(record(kind)) is None


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    """A program older than its ``tracing`` module reads nothing."""
    import gs_deformable_tpu_torch

    session()
    monkeypatch.delattr(gs_deformable_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "gs_deformable_tpu_torch.tracing", None)
    for name, kind in READERS.items():
        assert harness.readers()[name].read(record(kind)) is None
