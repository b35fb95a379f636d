"""sim_time_per_s.ensemble: simulated time advanced in the window, summed
over the members, over the window's wall seconds (whole episodes)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "ensemble" or "sim_time" not in w:
        return None
    return w["sim_time"] / w["wall_s"]
