"""``cond_ms``: the engine's ``cond`` stage of the eval step, in synchronised
milliseconds a step (``fused_eval_step(timings=)``), over the traced run's
steps after the profiled ones."""


def read(ctx):
    if ctx["kind"] != "eval" or not ctx["stage_steps"]:
        return None
    return ctx["stage_ms"].get("cond")
