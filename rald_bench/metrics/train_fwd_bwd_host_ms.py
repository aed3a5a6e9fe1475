"""``train_fwd_bwd_host_ms``: the training step's ``forward_backward`` stage, in host
milliseconds a step: from the stage's start until its Python returns,
before the closing synchronise (``train_step(timings=)``, key
``forward_backward.host``), over the traced run's steps after the profiled ones. Near
``train_fwd_bwd_ms`` (the same stage synchronised) the host paces the stage."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["stage_steps"]:
        return None
    return ctx["stage_ms"].get("forward_backward.host")
