"""The readers of the program's own spans and counters, on hand-made records
and totals made under a CPU profiler."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsbench import harness

READERS = {"deform_live_rows.train": "train", "deform_live_rows.render": "render",
           "instance_fill.train": "train", "instance_fill.render": "render",
           "backward_host_ms.train": "train", "raster_prep_host_ms.render": "render"}


def record(kind, busy_s=0.5, units=4):
    return {"kind": kind, "busy_s": busy_s, "units": units}


def session():
    """Totals of one profiler session, as the program would leave them."""
    from gs_deformable_tpu_torch import tracing

    assert not tracing.enabled()  # ends the last session
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("deform.rows", 4 * 1000)
        tracing.count("deform.live_rows", torch.tensor(4 * 381))
        tracing.count("binning.kp_rows", 4 * 2048)
        tracing.count("binning.needed_rows", torch.tensor(4 * 512, dtype=torch.int32))
        for name in ("gs.backward", "gs.screen_space", "gs.binning"):
            with tracing.span(name):
                with tracing.span("gs.inner"):
                    pass
    return tracing.spans()


@pytest.mark.parametrize("name", sorted(READERS))
def test_other_kind_and_no_card_read_nothing(name):
    session()
    r = harness.readers()[name]
    other = {"train": "render", "render": "train"}[READERS[name]]
    assert r.read(record(other)) is None
    assert r.read(record(READERS[name], busy_s=0.0)) is None
    assert r.read(record(READERS[name])) is not None


def test_values_from_the_program_s_totals():
    s = session()
    r = harness.readers()
    for kind in ("train", "render"):
        assert r[f"deform_live_rows.{kind}"].read(record(kind)) == pytest.approx(38.1)
        assert r[f"instance_fill.{kind}"].read(record(kind)) == 25.0
    assert r["backward_host_ms.train"].read(record("train")) == \
        1e3 * s["gs.backward"]["host_s"] / 4
    assert r["raster_prep_host_ms.render"].read(record("render")) == \
        1e3 * (s["gs.screen_space"]["self_s"] + s["gs.binning"]["self_s"]) / 4
    assert s["gs.binning"]["self_s"] < s["gs.binning"]["host_s"]


def test_a_session_without_the_totals_reads_nothing():
    from gs_deformable_tpu_torch import tracing

    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("other", 1)
    for name, kind in READERS.items():
        assert harness.readers()[name].read(record(kind)) is None


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    """The parent commit's program has no ``tracing`` module."""
    import gs_deformable_tpu_torch

    session()
    monkeypatch.delattr(gs_deformable_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "gs_deformable_tpu_torch.tracing", None)
    for name, kind in READERS.items():
        assert harness.readers()[name].read(record(kind)) is None
