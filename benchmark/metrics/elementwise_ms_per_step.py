"""elementwise_ms_per_step: device ms per step of the kernels outside the
library GEMMs, the fused pc's, the stencil kernels and cuFFT
(yardstick.device_groups' ``other``: the float64 stage arithmetic, the
casts, matmul's copies and the arrow kernel) in the traced stretch;
None where the stretch traced no device operation."""

from yardstick import device_groups


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("steps") or not tr["per_kernel"]:
        return None
    return device_groups(tr["per_kernel"])["other"] * 1e3 / tr["steps"]
