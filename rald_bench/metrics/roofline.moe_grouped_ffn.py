"""``roofline.moe_grouped_ffn``: the least time the card could take for the
routed experts' grouped feed-forward (``rald_torch.ops.moe_grouped_ffn``)
in the profiled steps, over the device time of its kernels there.

The sampler runs as a replayed CUDA graph, which calls no wrapper the
harness could open a range around; so the driver sums the device time of
the kernels whose name holds ``moe_grouped_ffn`` in the profile, and the
rows and calls from the program's mixture counters over the same steps
(``ctx["moe_grouped_ffn"]``). The least time
(``rald_bench.work_hy3d21.grouped_ffn_bound``): the routed rows' two GEMMs
at 989 TFLOP/s, or every call's expert weights and each row's bf16
traffic at 3.35 TB/s, the larger. None where the program has no such
counters or no such kernel ran."""
from rald_bench import work_hy3d21

OP = "moe_grouped_ffn"


def describe(args, kwargs, out):
    return {"rows": int(args[0].shape[0])}


def read(ctx):
    got = ctx.get("moe_grouped_ffn")
    if not got or not got["device_s"] or not got["rows"]:
        return None
    s = work_hy3d21.sizes(ctx["cell"]["config"])
    return 100.0 * work_hy3d21.grouped_ffn_bound(s, got["rows"], got["calls"]) / got["device_s"]
