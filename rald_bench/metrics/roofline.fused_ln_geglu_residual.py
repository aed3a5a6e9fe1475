"""``roofline.fused_ln_geglu_residual``: the least time the card could take
for the calls of the FF op ``fused_ln_geglu_residual`` in the profiled
steps (the larger of their bytes over the HBM rate and their products over
the peak of their type: bf16 989 TFLOP/s, float32 67 TFLOP/s), over the
device time of the kernels launched inside those calls.

Work from each call's shapes: ``2 * rows * (numel(w1) + numel(w2))``
operations (LayerNorm, modulation, GELU and the residual are not counted),
each input tensor's bytes once and the output's once."""
import torch

from rald_bench.work import PEAK_BF16, PEAK_BYTES, PEAK_F32

OP = "fused_ln_geglu_residual"


def describe(args, kwargs, out):
    x, w1, w2 = args[0], args[3], args[5]
    rows = x.numel() // x.shape[-1]
    n_bytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    n_bytes += out.numel() * out.element_size()
    peak = PEAK_F32 if x.dtype == torch.float32 else PEAK_BF16
    return {"seconds_bound": max(n_bytes / PEAK_BYTES, 2.0 * rows * (w1.numel() + w2.numel()) / peak)}


def read(ctx):
    times = ctx["summary"]["op_calls"].get(OP) or []
    descs = ctx["ops"].calls.get(OP) if ctx["ops"] is not None else None
    if not times or not descs or len(times) != len(descs) or not sum(times):
        return None
    return 100.0 * sum(d["seconds_bound"] for d in descs) / sum(times)
