"""pc_gemm_ms_per_step: device ms per step of the library GEMMs (the
block pc's basis products on cuBLAS) in the traced stretch."""

from yardstick import library_gemms


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("steps"):
        return None
    names = library_gemms(tr["per_kernel"])
    if not names:
        return None
    return sum(tr["per_kernel"][k] for k in names) * 1e3 / tr["steps"]
