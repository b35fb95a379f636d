"""Exact direct stage solves for 1D problems via the native solver.

Counterpart: ksfd_tpu/solvers/banded_path.py.  The W-operator
(shift*I - J) of the 1D interleaved-dof stencil system is cyclic banded
with halfwidth sw*dof + dof - 1.  Its entries are extracted exactly by
(2*sw+1)*dof coloured probes (columns at least 2*sw+1 apart never share
a row), evaluated at once by ``torch.func.vmap`` over the J-action of
``PDEOperators.linearize`` on the operators' device; the native cyclic
banded LU (native/banded.py, csrc/banded.cpp) factors once per step on
the host and back-solves the four Rosenbrock stages, the reference's
MUMPS role, selected by ``ksp_type='banded'``.
"""

import numpy as np
import torch
from torch.func import vmap

from ..native.banded import CyclicBandedSolver
from ..utils.exceptions import KSFDException
from .direct import _enorm, exact_stages, gather_global, place_like, \
    w_operator

__all__ = ["probe_stride", "extract_w_band", "make_banded_step"]


def probe_stride(n, sw):
    """Smallest divisor of n that is at least 2*sw+1 (the colour
    period).  Counterpart: ksfd_tpu/solvers/banded_path.py:
    probe_stride."""
    need = 2 * sw + 1
    for s in range(need, n + 1):
        if n % s == 0:
            return s
    raise KSFDException("no valid probe stride for n=%d" % n)


def extract_w_band(w_op, n, dof, sw, w_batch=None, device="cpu"):
    """The CyclicBandedSolver factored from the exact entries of a
    linear operator on (dof, n) tensors on ``device`` (e.g. v -> shift*v
    - J v); ``w_batch`` is its batched form (default
    ``torch.func.vmap(w_op)``).  Counterpart:
    ksfd_tpu/solvers/banded_path.py:extract_w_band."""
    stride = probe_stride(n, sw)
    ncolors = stride * dof
    # probe c = (s, g): ones at field g, points p = s (mod stride)
    P = np.zeros((ncolors, dof, n))
    for s in range(stride):
        for g in range(dof):
            P[s * dof + g, g, s::stride] = 1.0
    w_batch = w_batch if w_batch is not None else vmap(w_op)
    WP = w_batch(torch.from_numpy(P).to(device)).cpu().numpy()
    WP = WP.reshape(stride, dof, dof, n)             # [s, g, f, p]

    N = n * dof
    bw = sw * dof + dof - 1
    kl = ku = bw
    band = np.zeros((2 * kl + ku + 1, N))
    corner = kl  # kl x kl corner blocks hold every wrapped entry
    top_right = np.zeros((corner, corner))
    bottom_left = np.zeros((corner, corner))
    q = np.arange(n)
    s_of_q = q % stride
    for d in range(-sw, sw + 1):
        rows_p = (q + d) % n
        wrap_lo = (q + d) < 0        # row wrapped to the bottom
        wrap_hi = (q + d) >= n       # row wrapped to the top
        interior = ~(wrap_lo | wrap_hi)
        for g in range(dof):
            for f in range(dof):
                vals = WP[s_of_q, g, f, rows_p]   # A[(q+d,f),(q,g)]
                i = rows_p * dof + f
                j = q * dof + g
                ii, jj = i[interior], j[interior]
                band[kl + ku + ii - jj, jj] = vals[interior]
                if wrap_hi.any():
                    it, jt = i[wrap_hi], j[wrap_hi]
                    top_right[it, jt - (N - corner)] = vals[wrap_hi]
                if wrap_lo.any():
                    ib, jb = i[wrap_lo], j[wrap_lo]
                    bottom_left[ib - (N - corner), jb] = vals[wrap_lo]
    return CyclicBandedSolver(N, kl, ku, band, top_right, bottom_left)


def make_banded_step(ops, tab, atol, rtol):
    """Host step with the native banded LU, the contract of
    make_step_fn's step: ``(u, t, h) -> (u1, enorm)``, u1 a tensor like
    u and enorm a 0-d float64 tensor on its device.  Counterpart:
    ksfd_tpu/solvers/banded_path.py:make_banded_step: the RHS and the
    probes on the operators' device, extraction, factorization and the
    triangular solves on the host."""
    if ops.grid.dim != 1:
        raise KSFDException("banded solver path is 1D only")
    n = ops.grid.nx
    dof = ops.grid.dof
    sw = ops.grid.stencil_width

    def step(u, t, h):
        u_in = u
        ug = ops.groom(torch.as_tensor(u, device=ops.device))
        u = gather_global(ug)
        t, h = float(t), float(h)
        w_op, w_batch = w_operator(ops, ug, t, 1.0 / (h * tab.gamma))
        solver = extract_w_band(w_op, n, dof, sw, w_batch=w_batch,
                                device=ops.device)
        try:
            # interleaved-dof ordering: index (p, f) -> p*dof + f
            u1, enorm = exact_stages(
                ops, tab, atol, rtol, u, t, h,
                lambda b: solver.solve(b.T.reshape(-1)).reshape(
                    n, dof).T.copy())
        finally:
            solver.close()
        return place_like(u1, u_in), _enorm(enorm, u_in)

    return step
