"""``train_optimizer_ms``: the training step's ``optimizer`` stage, in synchronised
milliseconds a step (``prepare_inputs`` / ``train_step(timings=)``), over
the traced run's steps after the profiled ones."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["stage_steps"]:
        return None
    return ctx["stage_ms"].get("optimizer")
