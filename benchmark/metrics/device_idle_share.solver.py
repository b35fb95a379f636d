"""device_idle_share.solver: the share of the traced stretch of the
adaptive loop in which no device operation ran, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "solver" or not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
