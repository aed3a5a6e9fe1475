"""The port's own spans (``rald_torch.train.profiler.span``) and each
stage's host time beside its synced time, on the CPU at the tiny config:

- with neither a profiler nor a timed stage a span is the one shared no-op
  and writes nothing;
- with ``timings`` the eval and training steps write each stage's synced
  milliseconds and its ``.host`` milliseconds, the host time no longer;
- under ``torch.profiler`` the ``rald::`` ranges nest as the steps run
  them: 2 x num_steps - 1 NFEs inside the sampler, one decode block per
  ``vae._chunk(B)`` queries of each decode, the forward before the
  backward;
- the benchmark's four ``.host`` readers report in their cells of a tiny
  traced run."""
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rald_torch.train.profiler import NO_SPAN, SPAN_PREFIX, span, synced_ms
from torch_parity import tiny_cfg

ROOT = Path(__file__).resolve().parent.parent
NUM_QUERY = 9000  # more than two of the decoder's 4096-query blocks


@pytest.fixture(scope="module")
def engine():
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    vae = dict(tiny_cfg(dict)["lidar_ae"])
    vae["overrides"] = {**vae["overrides"], "query_chunk": 4096}  # the least block
    cfg = tiny_cfg(Config, lidar_ae=vae, eval={"fscore_tau": 0.1, "inference": {
        "num_query_points": NUM_QUERY, "refine_query_aug_num": 512, "refine_query_scale": 2}})
    return GenerationEngine(cfg, device="cpu")


def _eval_step(eng, timings=None):
    rng = np.random.default_rng(0)
    bsz = 2
    return eng.fused_eval_step(
        rng.normal(size=(bsz, 32, 16, 16, 3)).astype(np.float32), [0, 1],
        rng.uniform(-1, 1, size=(bsz, 512, 3)).astype(np.float32),
        np.zeros((bsz, 512), np.float32), np.ones((bsz, 512), np.float32), None,
        torch.Generator().manual_seed(0), rng.uniform(-1, 1, size=(bsz, 256, 3)).astype(np.float32),
        np.ones((bsz, 256), bool), rng.uniform(-1, 1, size=(bsz, 512, 3)).astype(np.float32),
        np.ones((bsz, 512), bool), compute_cd=True, refine=True, helper_aug=True,
        use_device_grid=True, timings=timings)


@pytest.fixture(scope="module")
def trainer(engine):
    state = engine.init_state(4, 2)
    rng = np.random.default_rng(1)
    batch = {"lidar_points": rng.uniform(-1, 1, size=(2, 512, 3)).astype(np.float32),
             "radar_cube": rng.normal(size=(2, 32, 16, 16, 3)).astype(np.float32)}
    return engine, state, batch


def _train_step(trainer, it, timings=None):
    eng, state, batch = trainer
    latents, cube = eng.prepare_inputs(batch, eng.step_generator(0, it, 99), timings=timings)
    eng.train_step(state, latents, cube, eng.step_generator(0, it), timings=timings)


def test_span_off_is_the_shared_noop():
    timings = {}
    assert span("nfe") is NO_SPAN
    with synced_ms(None, "sample", "cpu"):
        assert span("nfe") is NO_SPAN
    with synced_ms(timings, "sample", "cpu"):
        assert span("nfe") is not NO_SPAN  # inside a timed stage
    seen = dict(timings)
    assert set(seen) == {"sample", "sample.host"}
    with span("nfe"):  # the stage is closed: nothing sees its dict
        pass
    assert span("nfe") is NO_SPAN and timings == seen


def test_stage_timings_hold_host_beside_synced(engine, trainer):
    stages = {"cond", "sample", "decode", "refine", "chamfer"}
    nested = {"nfe", "densify", "decode_block"}
    timings = {}
    _eval_step(engine, timings)
    assert set(timings) == stages | {s + ".host" for s in stages | nested}
    for s in stages:
        assert 0 < timings[s + ".host"] <= timings[s]
    # each nested span's host time lies inside its stages' host time
    assert timings["nfe.host"] <= timings["sample.host"]
    assert timings["decode_block.host"] <= timings["decode.host"] + timings["refine.host"]

    stages = {"vae_encode", "upsample", "forward_backward", "all_reduce", "optimizer"}
    nested = {"forward", "backward", "grad_norm", "clip", "adamw", "ema", "refresh"}
    timings = {}
    _train_step(trainer, 0, timings)
    assert set(timings) == stages | {s + ".host" for s in stages | nested}
    for s in stages:
        assert 0 < timings[s + ".host"] <= timings[s]
    assert timings["forward.host"] + timings["backward.host"] <= timings["forward_backward.host"]


def _spans(prof) -> list:
    """(name without the prefix, start, end) of every ``rald::`` range."""
    return sorted(((e.name[len(SPAN_PREFIX):], e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(SPAN_PREFIX)),
                  key=lambda s: s[1])


def _inside(spans, name, outer) -> list:
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


def test_profiler_sees_nested_spans(engine, trainer):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _eval_step(engine)
        _train_step(trainer, 1)
    spans = _spans(prof)
    names = {s[0] for s in spans}
    assert all("aunch" not in n and not n.startswith("bench::") for n in names)

    (step,) = [s for s in spans if s[0] == "eval_step"]
    for stage in ("cond", "sample", "decode", "refine", "chamfer"):
        assert len(_inside(spans, stage, step)) == 1
    (sample,) = _inside(spans, "sample", step)
    steps = engine.sampler_kwargs["num_steps"]
    assert len(_inside(spans, "nfe", sample)) == 2 * steps - 1
    assert len([s for s in spans if s[0] == "nfe"]) == 2 * steps - 1
    chunk = engine.vae._chunk(2)
    # decode: the eval queries, then the grid and the densified helpers
    (decode,) = _inside(spans, "decode", step)
    want = math.ceil(512 / chunk) + math.ceil((NUM_QUERY + 256) / chunk)
    assert want > 2 and len(_inside(spans, "decode_block", decode)) == want
    (refine,) = _inside(spans, "refine", step)
    assert len(_inside(spans, "decode_block", refine)) == math.ceil(512 / chunk)
    assert len(_inside(spans, "densify", decode)) == len(_inside(spans, "densify", refine)) == 1

    (step,) = [s for s in spans if s[0] == "train_step"]
    (fb,) = _inside(spans, "forward_backward", step)
    (fwd,), (bwd,) = _inside(spans, "forward", fb), _inside(spans, "backward", fb)
    assert fwd[2] <= bwd[1]
    (opt,) = _inside(spans, "optimizer", step)
    for name in ("grad_norm", "clip", "adamw", "ema", "refresh"):
        assert len(_inside(spans, name, opt)) == 1
    assert [s[0] for s in spans if s[0] in ("vae_encode", "train_step")] == ["vae_encode",
                                                                              "train_step"]


@pytest.mark.parametrize("churn", [0.0, 1.0])
def test_nfe_spans_on_the_table_and_churn_paths(engine, churn):
    from torch.profiler import ProfilerActivity, profile

    kw = engine.sampler_kwargs
    saved, kw["s_churn"] = kw["s_churn"], churn
    try:
        cond = engine.condition(np.random.default_rng(2).normal(
            size=(2, 32, 16, 16, 3)).astype(np.float32))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.sample_from_cond(cond, [0, 1])
    finally:
        kw["s_churn"] = saved
    assert [s[0] for s in _spans(prof)] == ["nfe"] * (2 * kw["num_steps"] - 1)


@pytest.mark.parametrize("fold", [False, True])
def test_decode_block_spans_in_both_tails(engine, fold):
    from torch.profiler import ProfilerActivity, profile

    vae, q = engine.vae, NUM_QUERY
    saved, vae.fold_decode_tail = vae.fold_decode_tail, fold
    try:
        h = vae.decode_latents(torch.randn(1, vae.num_latents, vae.latent_dim))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            vae.decode_queries(h, torch.rand(1, q, 3) * 2 - 1)
    finally:
        vae.fold_decode_tail = saved
    assert [s[0] for s in _spans(prof)] == ["decode_block"] * math.ceil(q / vae._chunk(1))


HOST_READERS = {"sample_host_ms": "sample_ms", "decode_host_ms": "decode_ms",
                "train_fwd_bwd_host_ms": "train_fwd_bwd_ms",
                "train_optimizer_host_ms": "train_optimizer_ms"}

_RUN = """
import json, sys
import torch
torch.set_num_threads(2)
from rald_bench import run, spec
data = spec.BENCH_DIR / "tests" / "data"
bench = spec.load_json(data / "bench.json")
bench["per_layer"] += json.loads(sys.argv[1])
out = {}
for name, seconds in (("tiny_eval_b2", 15.0), ("tiny_train_b2", 10.0)):
    res = run.run(spec.cell(name, bench, data), 2 ** 31 + 7, seconds, True, device="cpu",
                  log=lambda s: None)
    out[name] = {"correct": res["correct"], "metrics": res["metrics"]}
print(json.dumps(out))
"""


def test_host_readers_report_in_their_cells():
    """A traced run of the tiny eval and training cells (in its own
    process: the benchmark refuses to run beside JAX) with the four
    readers' ``BENCHMARK.json`` entries, their cells moved to the tiny
    ones. The windows are long enough that steps are timed after the
    profiled one on a machine the other test workers load."""
    tiny = {"eval_live_b1": "tiny_eval_b2", "eval_offline_b8": "tiny_eval_b2",
            "train_stage2_b8": "tiny_train_b2"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = [dict(m, workloads=sorted({tiny[w] for w in m["workloads"]}))
               for m in bench["per_layer"] if m["name"] in HOST_READERS]
    assert len(entries) == len(HOST_READERS)
    assert all(m["source"] == "program_span" and m["unit"] == "ms" for m in entries)
    out = subprocess.run([sys.executable, "-c", _RUN, json.dumps(entries)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for cell, names in (("tiny_eval_b2", ("sample_host_ms", "decode_host_ms")),
                        ("tiny_train_b2", ("train_fwd_bwd_host_ms", "train_optimizer_host_ms"))):
        metrics = res[cell]["metrics"]
        assert res[cell]["correct"] is True
        assert set(HOST_READERS) & set(metrics) == set(names)
        for name in names:
            assert 0 < metrics[name]["value"] <= metrics[HOST_READERS[name]]["value"]
            assert metrics[name]["unit"] == "ms"
