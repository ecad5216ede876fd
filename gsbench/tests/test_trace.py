"""The frozen trace attribution on a small synthetic chrome trace."""

from gsbench.trace import Trace


def op(name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": tid, "args": args}


def kernel(name, ts, dur, ext):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 7, "args": {"External id": ext}}


def synthetic():
    rng = dict(op("gsbench.deformation", 0, 100), cat="user_annotation")
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "gsbench.traced", "ts": 0, "dur": 1000,
         "pid": 0, "tid": 1, "args": {}},
        rng,
        op("aten::mm", 10, 50, **{"External id": 1, "Sequence number": 5}),
        op("aten::relu", 60, 20, **{"External id": 2, "Sequence number": 6}),
        op("aten::add", 200, 20, **{"External id": 3, "Sequence number": 9}),
        # the backward, on the autograd thread
        op("autograd::engine::evaluate_function: MmBackward0", 400, 100, tid=2,
           **{"Sequence number": 5}),
        op("aten::mm", 410, 80, tid=2, **{"External id": 4}),
        op("AddBackward0", 600, 50, tid=2, **{"Sequence number": 9, "External id": 5}),
        kernel("gemm", 20, 100, 1),
        kernel("relu", 130, 10, 2),
        kernel("add", 210, 30, 3),
        kernel("gemm_bwd", 420, 60, 4),
        kernel("add_bwd", 610, 20, 5),
    ]
    return Trace(events)


def test_share_forward_and_backward():
    t = synthetic()
    s = t.share(["gsbench.deformation"])
    assert s["forward"] == (100 + 10) / 1e3
    assert s["backward"] == 60 / 1e3
    assert s["all"] == (100 + 10 + 30 + 60 + 20) / 1e3
    assert s["events"] == 3
    assert t.share(["no such range"])["forward"] == 0.0


def test_busy_gaps_and_breakdown():
    t = synthetic()
    lo, hi = t.span("gsbench.traced")
    busy, gaps = t.busy(lo, hi)
    assert busy == 100 + 10 + 30 + 60 + 20
    assert gaps[0] == (0, 20) and gaps[-1] == (630, 1000)
    assert sum(b - a for a, b in gaps) == 1000 - busy
    assert t.top_ops(lo, hi, k=2) == [["gemm", 100e-6], ["gemm_bwd", 60e-6]]
    by_host = dict(t.gaps_by_host(gaps, "gsbench.traced"))
    # the gap at 630-1000 falls outside every op but the traced range itself
    assert by_host["gsbench.traced"] > 0
    assert abs(sum(by_host.values()) - (1000 - busy) / 1e6) < 1e-12
