"""Hunyuan3D-2.1's yardstick (``rald_bench.work_hy3d21``) against hand
counts at the published widths, its readers on a program without
mixtures, and its reference's imports."""
from __future__ import annotations

import subprocess
import sys

from rald_bench import spec, work, work_hy3d21

CONF = spec.load_json(spec.ROOT / "rald_bench/configs/hunyuan3d_dit_v2_1.json")
S = work_hy3d21.sizes(CONF)


def test_published_parameters_against_the_hand_count():
    d, f = 2048, 8192
    block = 3 * 2 * d + (4 * d * d + d + 256) + (2 * d * d + d + 2 * 1024 * d + 256)
    one_ffn = 2 * d * f + f + d
    mixture = 8 * d + 9 * one_ffn
    skip = 2 * d * d + d + 2 * d
    embed = (64 * d + d) + (d * 4 * d + 4 * d + 4 * d * d + d)
    final = 2 * d + d * 64 + 64
    dit = embed + 21 * block + 15 * one_ffn + 6 * mixture + 10 * skip + final
    assert work_hy3d21.parameters(S) == {"dit": dit, "moe": 6 * mixture}
    assert CONF["parameters"]["dit"] == dit == 3050758720
    assert CONF["parameters"]["moe"] == 6 * mixture


def test_dit_row_by_hand():
    n, d, f = 4097, 2048, 8192
    attn = 2 * 4 * n * d * d + 2 * 2 * n * n * d
    cross = 2 * 2 * n * d * d + 2 * 2 * 1370 * 1024 * d + 2 * 2 * n * 1370 * d
    ffn = 2 * 2 * n * d * f
    mixture = 2 * n * d * 8 + 3 * ffn
    row = (2 * 4096 * 64 * d + 2 * 2 * d * 4 * d + 21 * (attn + cross) + 15 * ffn + 6 * mixture
           + 10 * 2 * n * 2 * d * d + 2 * 4096 * d * 64)
    assert work_hy3d21.dit_row(S) == row
    assert 18.1e12 < row < 18.3e12
    queries = 16384 + 500000 + 700000 + 500000
    assert work_hy3d21.eval_frame(S, 50, queries) == 100 * row + work_hy3d21.geo_decode(S, 1, queries)


def test_grouped_ffn_bound_by_hand():
    rows = 2 * 2 * 4097
    flops = 2 * 2 * rows * 2048 * 8192
    assert work_hy3d21.grouped_ffn_bound(S, rows, 1) == flops / work.PEAK_BF16
    weights = 8 * (2 * 2048 * 8192 + 8192 + 2048) * 2
    assert work_hy3d21.grouped_ffn_bound(S, 16, 1) == (weights + 16 * (20480 * 2 + 4)) / work.PEAK_BYTES


def test_readers_read_nothing_without_mixtures():
    """What a program without mixtures leaves in the traced context: the
    three readers give None, not an error."""
    ctx = {"kind": "eval", "stage_steps": 0, "stage_ms": {}, "flow_counts": {"rows": 0},
           "cell": {"config": CONF}, "summary": {"op_calls": {}, "window_s": 1.0}, "ops": None}
    for name in ("mfu.moe_dit_sample", "roofline.moe_grouped_ffn", "moe_load_max_over_mean"):
        assert spec.metric_reader(name).read(ctx) is None, name
    ctx.update(moe={"tokens": [[3, 1, 0, 4]]},
               moe_grouped_ffn={"rows": 16388, "calls": 1, "device_s": 2.5e-3})
    assert spec.metric_reader("moe_load_max_over_mean").read(ctx) == 2.0
    share = spec.metric_reader("roofline.moe_grouped_ffn").read(ctx)
    assert abs(share - 100 * work_hy3d21.grouped_ffn_bound(S, 16388, 1) / 2.5e-3) < 1e-9


def test_reference_imports_no_kernel_and_no_jax():
    code = ("import sys, rald_bench.reference.hunyuan3d_v2_1, rald_bench.drivers.flow_eval_stream_v2_1;"
            "print(sorted(m for m in sys.modules if m.startswith(('rald_torch', 'jax', 'rald_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
