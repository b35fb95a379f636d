"""ms_per_attempt.ensemble: the window's wall ms per batched attempt of
the ensemble's device loop (one host read of every member's error norm
each)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "ensemble" or not w.get("calls"):
        return None
    return w["wall_s"] * 1e3 / w["calls"]
