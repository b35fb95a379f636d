"""dof_updates_per_s: unknowns times steps completed in the window over
its wall seconds, the chain read back after its last call."""


def read(ctx):
    w = ctx["window"]
    if "steps" not in w:
        return None
    return w["dof"] * w["steps"] / w["wall_s"]
