"""attempts_per_accept.ensemble: member attempts over member accepts in the
window."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "ensemble" or not w.get("accepts"):
        return None
    return w["attempts"] / w["accepts"]
