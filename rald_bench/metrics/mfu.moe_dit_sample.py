"""``mfu.moe_dit_sample``: Hunyuan3D-2.1's flow sampler's DiT work in the
traced run's timed steps (the published model's,
``rald_bench.work_hy3d21.flow_sample``: the mixtures' routed experts at
top-2 and their shared expert, from the batch rows of the engine's
``flow_counts()`` over those steps), over the ``sample`` stage's
synchronised time in them, as a share of the card's bf16 peak (989
TFLOP/s). None where the program counts no flow DiT rows."""
from rald_bench import work_hy3d21
from rald_bench.work import PEAK_BF16


def read(ctx):
    counts = ctx.get("flow_counts")
    if ctx["kind"] != "eval" or not counts or not counts["rows"] or not ctx["stage_steps"]:
        return None
    seconds = ctx["stage_ms"].get("sample", 0.0) * ctx["stage_steps"] * 1e-3
    if not seconds:
        return None
    work = work_hy3d21.flow_sample(work_hy3d21.sizes(ctx["cell"]["config"]), counts["rows"])
    return 100.0 * work / seconds / PEAK_BF16
