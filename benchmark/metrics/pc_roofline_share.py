"""pc_roofline_share: the least time of a step's pc transforms (their
operations, pc_ops.pc_ops_per_step, over the tensor cores'
float32-accurate 3xTF32 rate) over the device time per step of the
library GEMMs and the fused pc's kernels in the traced stretch, in
percent.  The grid's dimension is its configuration's, its n points
on every axis."""

from pc_ops import F32_ACCURATE_OPS_PER_S, grid_dim, pc_ops_per_step
from yardstick import device_groups


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("steps"):
        return None
    groups = device_groups(tr["per_kernel"])
    t_pc = (groups["gemm"] + groups["pc kernels"]) / tr["steps"]
    dim = grid_dim(ctx["wl"]["config"])
    if t_pc <= 0 or dim is None:
        return None
    n = round(ctx["points"] ** (1.0 / dim))
    ops = pc_ops_per_step(ctx["numerics"], ctx["fields"], (n,) * dim)
    if ops is None:
        return None
    return 100.0 * ctx["members"] * ops / F32_ACCURATE_OPS_PER_S / t_pc
