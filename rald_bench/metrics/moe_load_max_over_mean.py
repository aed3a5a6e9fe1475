"""``moe_load_max_over_mean``: how unevenly the routing loads the experts
over the traced run's window: in each mixture, the busiest expert's tokens
over the mean of its experts' (from the engine's ``moe_counts()``, read
after the window), the worst mixture's. 1 is an even load; the grouped
expert kernel's time follows the total, but a busier expert is a longer
run of tiles for its weights. None where the program has no mixtures."""


def read(ctx):
    got = ctx.get("moe")
    if not got or not got["tokens"]:
        return None
    worst = None
    for row in got["tokens"]:
        mean = sum(row) / len(row)
        if mean:
            worst = max(worst or 0.0, max(row) / mean)
    return worst
