"""``sample_graph_host_ms``: the host milliseconds a step of the sampler's
CUDA-graph replay (the program's ``sample_graph`` span inside the eval
step's ``sample`` stage, key ``sample_graph.host``: the static inputs'
copies, the replay's launch and the output's copy), over the traced run's
steps after the profiled ones. None where no timed step replayed a graph."""


def read(ctx):
    if ctx["kind"] != "eval" or not ctx["stage_steps"]:
        return None
    return ctx["stage_ms"].get("sample_graph.host")
