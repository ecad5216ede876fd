"""``BENCHMARK.json`` against the benchmark's rules of form, and every cell,
configuration, traffic mix, generator and reader found by its name."""

import json
import os
import re

import pytest

from gsbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gsbench"] and BENCH["command"][1].startswith("gsbench/")
    assert all(one_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_entries_keys_and_one_line_texts():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"gsbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert one_line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_every_cell_reports_what_it_promises():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    assert e2e["setup_s"] == cells
    for cell in cells:
        assert sum(cell in ws for ws in e2e.values()) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= e2e[m["moves"]]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = harness.load("cells", w["name"])
    assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"], w["why"])
    config = harness.load("configs", cell["config"])
    assert config["reduced"] == next(c["reduced"] for c in BENCH["configs"]
                                     if c["name"] == cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    gen = harness.traffic(mix["kind"])
    assert gen.KIND in ("train", "render")
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


def test_configs_and_cells_each_used():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for folder in ("cells", "configs"):
        names = {f[:-5] for f in os.listdir(os.path.join(ROOT, "gsbench", folder))}
        group = "workloads" if folder == "cells" else "configs"
        assert names == {e["name"] for e in BENCH[group]}


def test_one_reader_per_per_layer_metric():
    readers = harness.readers()
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}
    cells = {w["name"]: harness.traffic(harness.load("traffic", harness.load(
        "cells", w["name"])["traffic"])["kind"]).KIND for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        kinds = {cells[c] for c in m["workloads"]}
        assert len(kinds) == 1
        # a reader reads nothing in a cell of the other kind
        other = {"train": "render", "render": "train"}[kinds.pop()]
        assert readers[m["name"]].read({"kind": other}) is None
