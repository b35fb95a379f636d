"""device_ms_per_step: the union of the device operations' intervals in
the traced stretch, in ms per step."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("steps") or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] * 1e3 / tr["steps"]
