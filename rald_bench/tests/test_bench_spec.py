"""The cells, configurations and metrics are found from files by name, and
``BENCHMARK.json`` keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from rald_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rald_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_from_files(cell):
    c = spec.cell(cell)
    assert c["chips"] == 1
    assert c["traffic"]["driver"] in ("eval_stream", "train_steps")
    from rald_bench.run import driver_class

    numbers = driver_class(c["traffic"]["driver"]).__module__
    assert set(c["limits"]["limits"]) <= set(__import__(numbers, fromlist=["NUMBERS"]).NUMBERS)
    assert all(0 < v < 1 for v in c["limits"]["limits"].values())
    assert "setup_s" in c["end_to_end"] and len(c["end_to_end"]) >= 2
    assert c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_found(metric):
    mod = spec.metric_reader(metric)
    assert callable(mod.read)
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    # every cell that reports the metric reports what it moves
    assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))
    if metric.startswith("roofline."):
        from rald_torch.ops import KERNELS

        assert mod.OP == metric[len("roofline."):] and mod.OP in KERNELS


def test_names_units_and_bounds():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert c["file"].startswith("rald_bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert spec.load_json(spec.ROOT / c["file"])["reduced"] == c["reduced"]
