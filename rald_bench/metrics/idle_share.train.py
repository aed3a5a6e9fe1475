"""``idle_share.train``: the share of the traced window of the profiled train
steps in which no kernel ran on the device (one minus the union of the
kernels' intervals over the window)."""


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "train" or not s["window_s"] or not s["kernels"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
