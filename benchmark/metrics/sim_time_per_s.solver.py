"""sim_time_per_s.solver: simulated time advanced in the window, summed
over the members, over the window's wall seconds (whole episodes)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "solver" or "sim_time" not in w:
        return None
    return w["sim_time"] / w["wall_s"]
