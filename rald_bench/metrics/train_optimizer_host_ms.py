"""``train_optimizer_host_ms``: the training step's ``optimizer`` stage, in host
milliseconds a step: from the stage's start until its Python returns,
before the closing synchronise (``train_step(timings=)``, key
``optimizer.host``), over the traced run's steps after the profiled ones. Near
``train_optimizer_ms`` (the same stage synchronised) the host paces the stage."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["stage_steps"]:
        return None
    return ctx["stage_ms"].get("optimizer.host")
