"""ms_per_attempt.solver: the window's wall ms per attempt of the host
Solver's device loop (``stats.chunk_attempts``, one host read each)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "solver" or not w.get("calls"):
        return None
    return w["wall_s"] * 1e3 / w["calls"]
