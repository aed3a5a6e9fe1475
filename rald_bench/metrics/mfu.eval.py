"""``mfu.eval``: the model work of the profiled eval steps (``rald_bench.work``,
the published architecture at the configuration's shapes) over the traced
window, as a share of the card's bf16 peak (989 TFLOP/s)."""
from rald_bench.work import PEAK_BF16


def read(ctx):
    if ctx["kind"] != "eval" or not ctx["summary"]["window_s"]:
        return None
    return 100.0 * ctx["model_flops"] / ctx["summary"]["window_s"] / PEAK_BF16
