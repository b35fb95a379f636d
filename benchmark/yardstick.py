"""The yardstick: the card's peaks, the kernel groups of a profile, and
the bytes the stencil work of a step needs.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
The groups (``library_gemms``, ``device_groups``) follow kernel names:
cuBLAS and CUTLASS GEMMs, the fused pc's kernels, cuFFT, the port's
stencil kernels (``ksfd_*``), the rest.  A stencil evaluation reads each
input plane once and writes its output once, in float32, whatever kernel
runs it: resid ``(u, x, b) -> r``, jvp ``(u, v) -> J v``, delta
``(u0, d, u1) -> f(u1) - f(u0)``, rhs ``u -> f(u)``, each plane
``fields x points``.
"""

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "TF32_OPS_PER_S",
           "EVAL_PLANES", "stencil_evals", "stencil_bytes_per_step",
           "kernel_bound",
           "library_gemms", "device_groups"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores, same sheet
TF32_OPS_PER_S = 495e12     # TF32 on the tensor cores, dense, same sheet

#: planes read plus written per point and field, per evaluation kind
EVAL_PLANES = dict(rhs=2, jvp=3, resid=4, delta=4)

#: kernel names of library GEMMs (cuBLAS, CUTLASS) in a profile
_LIBRARY_GEMM = ("gemm", "xmma", "cutlass", "sm90")


def stencil_evals(iters, stages=4, chained=True, fast32=False):
    """Stencil evaluations one Rosenbrock step's numerics require, by
    kind: each stage solve (Richardson or Chebyshev) of ``iters``
    preconditioner applications takes
    ``iters - 1`` residuals (float64 state: resid; float32 fast mode:
    W's jvp), stages 2.. take their right-hand side as an increment
    (delta; the fast mode: rhs), and the chain advances f0 by one more
    increment (the fast mode evaluates f0 afresh: rhs)."""
    if fast32:
        return dict(jvp=stages * (iters - 1), rhs=stages)
    return dict(resid=stages * (iters - 1),
                delta=(stages - 1) + (1 if chained else 0))


def stencil_bytes_per_step(evals, fields, points, members=1):
    """Bytes the evaluations ``evals`` move, each plane read or written
    once in float32."""
    plane = fields * points * members * 4
    return sum(EVAL_PLANES[k] * n * plane for k, n in evals.items())


def library_gemms(per_kernel):
    """The library GEMM kernels (cuBLAS, CUTLASS) of a profile."""
    return sorted(k for k in per_kernel if "pc_gemm" not in k.lower()
                  and any(w in k.lower() for w in _LIBRARY_GEMM))


def device_groups(per_kernel):
    """Device time by group (library GEMMs, the fused pc's kernels, the
    stencil kernels, cuFFT's kernels, the rest) of a profile's time by
    kernel name."""
    groups = {"gemm": 0.0, "pc kernels": 0.0, "stencil kernels": 0.0,
              "fft": 0.0, "other": 0.0}
    for key, t in per_kernel.items():
        low = key.lower()
        if "pc_gemm" in low:
            groups["pc kernels"] += t
        elif "fft" in low:
            groups["fft"] += t
        elif any(w in low for w in _LIBRARY_GEMM):
            groups["gemm"] += t
        elif "ksfd" in low or any(
                w in low for w in ("rhs_kernel", "jvp_kernel",
                                   "delta_kernel")):
            groups["stencil kernels"] += t
        else:
            groups["other"] += t
    return groups


def kernel_bound(name, fields, points, nb=1):
    """``(bound_ms, "bytes")``: the least time of one ``name`` evaluation
    of ``nb`` members, its planes each read or written once in float32
    over the card's memory rate (these kernels are bound by bytes, not
    by operations: PERF.md's kernel table)."""
    nbytes = EVAL_PLANES[name] * fields * points * nb * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
