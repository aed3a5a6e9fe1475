"""The yardstick's operation and byte counts against hand counts at one
shape, and the whole-top-level-name check for JAX."""
from __future__ import annotations

import torch

from rald_bench import spec, work
from rald_bench.run import forbidden_modules


def test_attention_and_geglu_by_hand():
    # 4 queries, 6 keys, width 8, context width 10, inner 16, out 8
    q_proj, kv_proj = 2 * 4 * 8 * 16, 2 * 2 * 6 * 10 * 16
    scores_values = 2 * 2 * 4 * 6 * 16
    out_proj = 2 * 4 * 16 * 8
    assert work.attention(4, 6, 8, 10, 16, 8) == q_proj + kv_proj + scores_values + out_proj
    # 3 rows of width 8, inner 32 (values and gates: 8 -> 64, then 32 -> 8)
    assert work.geglu(3, 8) == 2 * 3 * (8 * 64 + 32 * 8)


def test_product_counts():
    s = spec.model_sizes(spec.load_json(spec.ROOT / "rald_bench/configs/rald_eval_indoor.json")["config"])
    assert (s["dim"], s["depth"], s["channels"], s["cond_tokens"], s["vae_depth"]) == (512, 24, 32, 64, 24)
    # one DiT block: self-attention over 512 tokens, cross-attention to 64
    # tokens, GEGLU 512 -> 4096 -> 512, three AdaLN projections 512 -> 1024
    block = (2 * 512 * 512 * 512 * 4 + 2 * 2 * 512 * 512 * 512
             + 2 * 512 * 512 * 512 * 2 + 2 * 2 * 64 * 512 * 512 + 2 * 2 * 512 * 64 * 512
             + 2 * 512 * (512 * 4096 + 2048 * 512) + 3 * 2 * 512 * 1024)
    embed = 2 * (256 * 512 + 512 * 512)
    assert work.dit_nfe(s) == 2 * 2 * 512 * 32 * 512 + 24 * block + embed
    # the decode of one query: Fourier MLP, q projection, scores, values,
    # output projection, head
    per_query = 2 * 51 * 512 + 2 * 512 * 512 + 4 * 512 * 512 + 2 * 512 * 512 + 2 * 512
    assert work.vae_decode(s, 10) - work.vae_decode(s, 0) == 10 * per_query
    nfe = 35
    assert 5e12 < work.eval_frame(s, nfe, 16384 + 500000 + 700000 + 500000) < 2e13


def test_roofline_work_by_hand():
    ff = spec.metric_reader("roofline.fused_ln_geglu_residual")
    x = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    args = (x, torch.zeros(2, 1, 8, dtype=torch.bfloat16), torch.zeros(2, 1, 8, dtype=torch.bfloat16),
            torch.zeros(64, 8, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16),
            torch.zeros(8, 32, dtype=torch.bfloat16), torch.zeros(8, dtype=torch.bfloat16))
    d = ff.describe(args, {}, x)
    n_bytes = 2 * (64 + 16 + 16 + 512 + 64 + 256 + 8) + 2 * 64
    flops = 2 * 8 * (512 + 256)
    assert d["seconds_bound"] == max(n_bytes / work.PEAK_BYTES, flops / work.PEAK_BF16)
    nn = spec.metric_reader("roofline.nn_min_sq_both")
    a = torch.full((1, 5, 3), 1e9)
    a[0, :3] = 0.0
    b = torch.zeros(1, 4, 3)
    d = nn.describe((a, b), {}, None)
    assert nn._bound(d) == max(16 * (3 + 4) / work.PEAK_BYTES, 8 * 3 * 4 / work.PEAK_F32)


def test_forbidden_by_whole_top_level_name():
    assert forbidden_modules(["rald_torch", "rald_torch.ops", "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "rald_tpu.models", "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "rald_tpu"]


def test_harness_loads_no_jax():
    import subprocess
    import sys

    code = ("import rald_bench.run, rald_bench.readings, rald_bench.drivers.eval_stream, "
            "rald_bench.drivers.train_steps, rald_bench.trace, rald_torch.train.gen_engine, sys; "
            "from rald_bench.run import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
