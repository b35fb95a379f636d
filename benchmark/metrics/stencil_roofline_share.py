"""stencil_roofline_share: the least time of a step's stencil work (the
bytes its numerics require, yardstick.stencil_bytes_per_step, over the
card's 3.35 TB/s) over the device time of the stencil kernels per step
in the traced stretch, in percent."""

from yardstick import (HBM_BYTES_PER_S, device_groups,
                       stencil_bytes_per_step, stencil_evals)


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("steps"):
        return None
    t_kern = device_groups(tr["per_kernel"])["stencil kernels"] / tr["steps"]
    if t_kern <= 0:
        return None
    nm = ctx["numerics"]
    evals = stencil_evals(int(nm.ksp_iters),
                          fast32=nm.precision in ("float32", "f32"))
    least = stencil_bytes_per_step(evals, ctx["fields"], ctx["points"],
                                   ctx["members"]) / HBM_BYTES_PER_S
    return 100.0 * least / t_kern
