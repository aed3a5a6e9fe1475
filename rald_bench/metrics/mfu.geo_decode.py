"""``mfu.geo_decode``: the ShapeVAE decoder's work in the traced run's
profiled steps (the published model's, ``rald_bench.work_hy3d.geo_decode``:
the latent stack once a frame and every query point the engine's
``flow_counts()`` says it scored in those steps), over the device time of
the kernels launched inside the program's ``vae_stack`` and
``decode_block`` spans in them (the driver's ``decoder_s``), as a share of
the card's bf16 peak (989 TFLOP/s). The grid's construction and the
densify passes, which run in the same stages, are outside those spans.
None where the program opens no such span or counts no decoded queries."""
from rald_bench import work_hy3d
from rald_bench.work import PEAK_BF16


def read(ctx):
    counts, seconds = ctx.get("profiled_counts"), ctx.get("decoder_s")
    if ctx["kind"] != "eval" or not counts or not counts["queries_decoded"] or not seconds:
        return None
    cell = ctx["cell"]
    frames = int(cell["traffic"]["profile_steps"]) * int(cell["traffic"]["batch"])
    work = work_hy3d.geo_decode(work_hy3d.sizes(cell["config"]), frames, counts["queries_decoded"])
    return 100.0 * work / seconds / PEAK_BF16
