"""The shape of a run's result: the last line's keys, the checks last, the
per-layer metrics and the breakdown of a traced run, and no result
without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rald_bench import run as bench_run
from rald_bench import spec

SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("trace", [False, True])
def test_eval_result_line(tiny_cell, trace):
    cell = tiny_cell("tiny_eval_b2")
    # long enough that the traced run times steps after its profiled one
    out = bench_run.run(cell, SEED, 4.0 if trace else 1.0, trace, device="cpu", log=lambda s: None)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["correct"] is True
    assert set(out["checks"]) == set(cell["limits"]["limits"])
    assert out["attempted"] >= 2 and out["failed"] == 0
    if trace:
        assert {"cond_ms", "sample_ms", "decode_ms", "refine_ms", "chamfer_ms"} <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p90", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    json.dumps(out)


def test_train_result_line(tiny_cell):
    out = bench_run.run(tiny_cell("tiny_train_b2"), SEED, 1.0, False, device="cpu", log=lambda s: None)
    assert out["correct"] is True and set(out["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert set(out["checks"]) == {"loss_rel", "grad_gap", "change_gap"}


def test_no_card_no_result():
    """Without the chips a cell asks for, the command exits non-zero and
    prints no result line."""
    code = "import torch, sys; torch.cuda.is_available = lambda: False; " \
           "import rald_bench.run as r; sys.exit(r.main(sys.argv[1:]))"
    out = subprocess.run([sys.executable, "-c", code, "--workload", "eval_live_b1", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card(card):
    """One short run of the cheapest cell on the card."""
    out = bench_run.run(spec.cell("train_stage2_b8"), SEED, 5.0, False, log=lambda s: None)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
