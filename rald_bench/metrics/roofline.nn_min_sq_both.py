"""``roofline.nn_min_sq_both``: the least time the card could take for the
Chamfer nearest-neighbour op ``nn_min_sq_both`` in the profiled steps, over
the device time of the kernels launched inside those calls.

Work from the valid points these inputs have (rows not padded with the
1e9 sentinel), per frame: ``8 * n * m`` float32 operations (three
differences, three squares, two sums for each pair; the minima not
counted) at 67 TFLOP/s, and the valid points' bytes read once (12 bytes
each) and one 4-byte distance written for each."""
from rald_bench.work import PEAK_BYTES, PEAK_F32

OP = "nn_min_sq_both"


def describe(args, kwargs, out):
    return {"a": args[0], "b": args[1]}


def _bound(d) -> float:
    n = (d["a"][..., 0] < 1e8).sum(1).double()
    m = (d["b"][..., 0] < 1e8).sum(1).double()
    flops = float((8.0 * n * m).sum())
    n_bytes = float(16.0 * (n + m).sum())
    return max(n_bytes / PEAK_BYTES, flops / PEAK_F32)


def read(ctx):
    times = ctx["summary"]["op_calls"].get(OP) or []
    descs = ctx["ops"].calls.get(OP) if ctx["ops"] is not None else None
    if not times or not descs or len(times) != len(descs) or not sum(times):
        return None
    return 100.0 * sum(_bound(d) for d in descs) / sum(times)
