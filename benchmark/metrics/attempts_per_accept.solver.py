"""attempts_per_accept.solver: member attempts over member accepts in the
window."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "solver" or not w.get("accepts"):
        return None
    return w["attempts"] / w["accepts"]
