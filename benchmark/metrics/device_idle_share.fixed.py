"""device_idle_share.fixed: the share of the traced window of the
fixed-dt chain in which no device operation ran, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "fixed" or not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
