"""sim_time_per_accept.ensemble: simulated time advanced (the sum of the
accepted steps' h) over member accepts in the window."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "ensemble" or not w.get("accepts"):
        return None
    return w["sim_time"] / w["accepts"]
