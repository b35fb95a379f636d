"""Fixed-count preconditioned Richardson and Chebyshev stage solvers.

Counterpart: ksfd_tpu/solvers/gmres.py:richardson_solve,
:richardson_solve_resid, :_cheb_core, :chebyshev_solve and
:chebyshev_solve_resid.  The application count is static and there is
no data-dependent control flow: solve quality is judged by the caller's
embedded step-error control.  PyTorch runs eagerly, so the sweeps are a
plain Python loop (the reference's unroll and platform gating,
gmres.py:97 and :154-175, works around XLA and is not ported).  The
Krylov solvers wait for ROADMAP Queue A item 5.
"""

import torch

__all__ = ["richardson_solve", "richardson_solve_resid", "chebyshev_solve",
           "chebyshev_solve_resid"]


def richardson_solve(op, b, M, iters=12, x0=None):
    """Preconditioned Richardson: x += M^{-1}(b - W x), ``iters``
    applications of M in all."""
    x = M(b) if x0 is None else x0 + M(b - op(x0))
    for _ in range(int(iters) - 1):
        x = x + M(b - op(x))
    return x


def richardson_solve_resid(resid, b, M, iters=12):
    """richardson_solve with a fused residual callable
    resid(x, b) = b - W x (the resid kernel of ops/fused_stencil.py)."""
    x = M(b)
    for _ in range(int(iters) - 1):
        x = x + M(resid(x, b))
    return x


def _cheb_core(resid, b, M, iters, lmin, lmax):
    """Shared preconditioned-Chebyshev recurrence (Saad, Iterative
    Methods for Sparse Linear Systems, 2nd ed., Alg. 12.1):

      theta = (lmax+lmin)/2, delta = (lmax-lmin)/2, sigma = theta/delta
      d_0 = M(b)/theta, x_1 = d_0, rho_0 = 1/sigma
      rho_k = 1/(2 sigma - rho_{k-1})
      d_k = rho_k rho_{k-1} d_{k-1} + (2 rho_k / delta) M(b - W x_k)
      x_{k+1} = x_k + d_k

    resid(x) returns b - W x; lmin/lmax bound the spectrum of M^{-1} W
    and may be 0-d tensors (they stay on the device: no host read).
    ``iters`` counts preconditioner applications, as in
    richardson_solve.  The scalars take b's dtype, as the reference's do.
    """
    lmin, lmax = (torch.as_tensor(x, dtype=b.dtype, device=b.device)
                  for x in (lmin, lmax))
    theta = 0.5 * (lmax + lmin)
    delta = torch.clamp(0.5 * (lmax - lmin), min=1e-8)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = M(b) / theta
    x = d
    for _ in range(int(iters) - 1):
        z = M(resid(x))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


def chebyshev_solve(op, b, M, iters=16, lmin=0.05, lmax=1.05):
    """Preconditioned Chebyshev on W x = b (see _cheb_core): a
    fixed-count, inner-product-free iteration like richardson_solve."""
    return _cheb_core(lambda x: b - op(x), b, M, iters, lmin, lmax)


def chebyshev_solve_resid(resid, b, M, iters=16, lmin=0.05, lmax=1.05):
    """chebyshev_solve with a fused residual callable
    resid(x, b) = b - W x (the resid kernel of ops/fused_stencil.py)."""
    return _cheb_core(lambda x: resid(x, b), b, M, iters, lmin, lmax)
