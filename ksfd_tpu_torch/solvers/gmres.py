"""Stage solvers: fixed-count Richardson and Chebyshev, and restarted GMRES.

Counterpart: ksfd_tpu/solvers/gmres.py:richardson_solve,
:richardson_solve_resid, :_cheb_core, :chebyshev_solve and
:chebyshev_solve_resid, and ksfd_tpu/solvers/linalg.py:gmres_solve.
The Richardson and Chebyshev application counts are static and there
is no data-dependent control flow: solve quality is judged by the
caller's embedded step-error control.  PyTorch runs eagerly, so the
sweeps are a plain Python loop (the reference's unroll and platform
gating, gmres.py:97 and :154-175, works around XLA and is not ported).
``gmres_solve`` is the tolerance-based restarted GMRES of the robust
fallback step (``ksp_type="gmres_scipy"``); its convergence test reads
one scalar per restart on the host.  The fixed-count Krylov solvers
(``gmres_fixed``, ``gmres_rolled``, ``gmres_restarted``) wait for
ROADMAP Queue A item 9.
"""

import math

import torch

__all__ = ["richardson_solve", "richardson_solve_resid", "chebyshev_solve",
           "chebyshev_solve_resid", "gmres_solve"]


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


def _safe_normalize(x, thresh=None, raw=False):
    """(x / |x|, |x|), or (0, 0) where |x| <= thresh (the dtype's eps by
    default) or is NaN: jax.scipy.sparse.linalg's _safe_normalize, on
    the device.  ``raw`` adds |x| itself."""
    norm = torch.sqrt(torch.sum(x * x))
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    out = torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0)
    return out + (norm,) if raw else out


def _gmres_restart(op, M, b, x0, unit, rnorm, restart):
    """One restart of jax.scipy.sparse.linalg's _gmres_batched: the
    ``restart`` Arnoldi steps of the left-preconditioned operator
    ``M(op(.))`` (one classical Gram-Schmidt pass each, as its
    ``_iterative_classical_gram_schmidt`` with ``max_iterations=2``
    runs; an exact breakdown freezes the remaining rows of H at the
    identity's), then the least-squares solve by the normal equations
    (Cholesky), the update and the new preconditioned residual."""
    shape, n = b.shape, b.numel()
    eps = torch.finfo(b.dtype).eps
    V = b.new_zeros((restart + 1, n))
    V[0] = unit.reshape(n)
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    alive = torch.ones((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = M(op(V[k].reshape(shape))).reshape(n)
        _, v_norm_0 = _safe_normalize(v)
        h = V @ v
        v = v - h @ V
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        h = h.clone()
        h[k + 1] = v_norm_1
        V[k + 1] = torch.where(alive, unit_v, V[k + 1])
        H[k] = torch.where(alive, h, H[k])
        alive = alive & (v_norm_1 != 0.0)
    beta = b.new_zeros(restart + 1)
    beta[0] = rnorm
    # lstsq(H^T, beta) through (H H^T) y = H beta, H H^T positive definite
    y = torch.cholesky_solve((H @ beta)[:, None],
                             torch.linalg.cholesky_ex(H @ H.T)[0])[:, 0]
    x = x0 + (y @ V[:-1]).reshape(shape)
    return (x,) + _safe_normalize(M(b - op(x)), raw=True)


def gmres_solve(op, b, M=None, tol=1e-8, restart=20, maxiter=50, x0=None):
    """Restarted GMRES on a matrix-free operator, in b's dtype.

    Counterpart: ksfd_tpu/solvers/linalg.py:gmres_solve, which is
    ``jax.scipy.sparse.linalg.gmres(op, b, x0, tol, atol=0, restart,
    maxiter, M, solve_method="batched")``, and it keeps that function's
    stopping rule: restart while fewer than ``maxiter`` restarts ran and
    the norm of the PRECONDITIONED residual ``M(b - op(x))`` exceeds
    ``tol * |b|`` (a NaN norm stops).  Each restart builds a
    ``min(restart, b.numel())``-dimensional Krylov space of ``M(op(.))``.
    Returns the solution only: a failure shows in the caller's step
    error.  The one host read per restart is the convergence test (a
    host-level retry may pay it).  A non-finite residual returns NaN:
    the reference's normalisation maps a NaN norm to 0, so its loop
    stops as converged and returns its iterate, the zero start when the
    operator or b is non-finite from the outset, whose zero increment
    has error norm 0: a robust retry of a non-finite state would be
    accepted (ROADMAP Queue C).
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    restart = min(int(restart), b.numel())
    atol = tol * torch.sqrt(torch.sum(b * b))
    unit, rnorm, raw = _safe_normalize(M(b - op(x)), raw=True)
    for _ in range(int(maxiter)):
        norm, limit, raw = torch.stack(
            [rnorm, atol.to(rnorm.dtype), raw]).tolist()
        if not (math.isfinite(raw) and math.isfinite(limit)):
            return torch.full_like(x, math.nan)
        if not norm > limit:
            break
        x, unit, rnorm, raw = _gmres_restart(op, M, b, x, unit, rnorm,
                                             restart)
    return x
