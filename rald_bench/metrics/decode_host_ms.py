"""``decode_host_ms``: the engine's ``decode`` stage of the eval step, in host
milliseconds a step: from the stage's start until its Python returns,
before the closing synchronise (``fused_eval_step(timings=)``, key
``decode.host``), over the traced run's steps after the profiled ones. Near
``decode_ms`` (the same stage synchronised) the host paces the stage."""


def read(ctx):
    if ctx["kind"] != "eval" or not ctx["stage_steps"]:
        return None
    return ctx["stage_ms"].get("decode.host")
