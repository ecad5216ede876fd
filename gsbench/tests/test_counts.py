"""``counts`` against work worked out by hand for both configurations."""

import pytest

from gsbench import counts, harness

OFFSET_MACS = 84 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256 * 58
SE3_MACS = 4 * 256 + 4 * 256 * 256 + 259 * 256 + 2 * 256 * 256 + 256 * 6
GATE_MACS = 4 * 256 + 4 * 256 * 256 + 259 * 256 + 2 * 256 * 256 + 256 * 1


def test_offset_net_macs_and_flops():
    cfg = harness.load("configs", "offset-8x256")
    assert OFFSET_MACS == 511_232
    assert counts.nets(cfg) == [("net", OFFSET_MACS, "bfloat16", 3)]
    flops = counts.net_flops(cfg, 100_000, train=True)
    assert flops == {"bfloat16": 2 * 3 * OFFSET_MACS * 100_000}
    assert flops["bfloat16"] == pytest.approx(3.067e11, rel=1e-3)
    assert counts.net_flops(cfg, 100_000, train=False) == {"bfloat16": 2 * OFFSET_MACS * 1e5}


def test_se3_net_and_gate():
    cfg = harness.load("configs", "se3-mask-8x256")
    assert counts.nets(cfg) == [("net", SE3_MACS, "bfloat16", 3),
                                ("gate", GATE_MACS, "float32", 2)]
    assert counts.net_flops(cfg, 10, train=True) == {"bfloat16": 60.0 * SE3_MACS,
                                                     "float32": 40.0 * GATE_MACS}


def test_composite_work():
    work = {"needed_pairs": 1000, "walked": 50_000, "walked_bwd": 40_000,
            "contributing": 20_000, "touched": 300}
    pixels = 64 * 64
    assert counts.composite_fwd(work, pixels) == (4 * (9 * 1000 + 4 * pixels),
                                                  16 * 50_000 + 10 * 20_000)
    assert counts.composite_bwd(work, pixels) == (4 * (9 * 1000 + 5 * pixels + 9 * 300),
                                                  16 * 40_000 + 37 * 20_000)


def test_least_time_takes_the_larger_bound():
    assert counts.least_s(3.35e12, 0.0) == (1.0, "bytes")
    assert counts.least_s(0.0, 67e12 * 2) == (2.0, "operations")
    s, by = counts.least_s(3.35e9, 67e12)
    assert (s, by) == (1.0, "operations")


def test_step_share():
    # one second of bf16 peak work plus one of fp32 peak work in 4 s: 50%
    assert counts.step_share({"bfloat16": 989e12, "float32": 67e12}, 4.0) == pytest.approx(50.0)
