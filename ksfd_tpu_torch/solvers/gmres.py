"""Stage solvers: fixed-count Richardson, Chebyshev and GMRES, and
restarted GMRES to a tolerance.

Counterpart: ksfd_tpu/solvers/gmres.py:richardson_solve,
:richardson_solve_resid, :_cheb_core, :chebyshev_solve,
:chebyshev_solve_resid, :gmres_fixed, :gmres_rolled and
:gmres_restarted, and ksfd_tpu/solvers/linalg.py:gmres_solve.
The Richardson, Chebyshev and fixed-count GMRES iteration counts are
static and there is no data-dependent control flow and no host read:
solve quality is judged by the caller's embedded step-error control,
and the ensemble's ``torch.func.vmap`` takes every one of them.
PyTorch runs eagerly, so the sweeps and the Arnoldi steps are plain
Python loops (the reference's unroll, rolled ``fori_loop`` and platform
gating, gmres.py:97, :154-175 and :208-316, work around XLA and are not
ported).  ``gmres_solve`` is the tolerance-based restarted GMRES of the
robust fallback step (``ksp_type="gmres_scipy"``); its convergence test
reads one scalar per restart on the host.

On a mesh (``mesh=``, parallel/mesh.py) every GMRES solver takes
this rank's block of b and of the operator's vectors, and each inner
product and norm is summed over the ranks (one ``all_reduce_sum`` per
Gram-Schmidt pass and per norm), so every rank holds the same Krylov
coefficients and takes the same breakdown and convergence decisions;
the small least-squares problems then run alike on every rank.  The
reference gets the same from XLA on its sharded arrays.  Richardson and
Chebyshev take no inner product.  Without a mesh the order of
operations is the one-card path's.
"""

import math

import torch

from ..parallel.mesh import all_reduce_sum

__all__ = ["richardson_solve", "richardson_solve_resid", "chebyshev_solve",
           "chebyshev_solve_resid", "gmres_fixed", "gmres_rolled",
           "gmres_restarted", "gmres_solve"]


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


def _identity(v):
    return v


def _safe(x):
    """x where x > 0, else 1: the fixed-count solvers' breakdown guard."""
    return torch.where(x > 0, x, torch.ones_like(x))


def _gsum(x, mesh):
    """x summed over the mesh's ranks (x itself without a mesh)."""
    return x if mesh is None else all_reduce_sum(x, mesh)


def _norm(x, mesh=None):
    return torch.sqrt(_gsum(torch.sum(x * x), mesh))


def _dots(Vs, w, mesh):
    """The inner products of w with each of Vs, over the mesh."""
    h = [torch.sum(Vi * w) for Vi in Vs]
    return h if mesh is None else list(all_reduce_sum(torch.stack(h), mesh))


def gmres_fixed(op, b, M=None, iters=8, x0=None, mesh=None):
    """GMRES(iters) from x0 (zero when None), left-preconditioned: it
    minimizes ``|M(b - op(x))|`` over the Krylov space of ``M(op(.))``.

    Counterpart: ksfd_tpu/solvers/gmres.py:gmres_fixed, step for step:
    classical Gram-Schmidt with one re-orthogonalization (CGS2), Givens
    rotations applied as each column arrives, back substitution.
    Breakdown contract: ``_safe`` division turns a breakdown (a zero new
    basis norm or a singular R) into a finite, possibly wrong answer,
    which the caller's embedded error estimate judges; a vanishing
    preconditioned initial residual gives the zero correction.  With a
    ``mesh`` b and x0 are this rank's slabs (module docstring).
    """
    M = _identity if M is None else M
    shape, m = b.shape, int(iters)

    def A(v):
        return M(op(v.reshape(shape))).reshape(-1)

    r0 = (M(b) if x0 is None else M(b - op(x0))).reshape(-1)
    beta = _norm(r0, mesh)
    Vs = [r0 / _safe(beta)]
    Rcols, cs, sn = [], [], []
    g = [beta] + [torch.zeros_like(beta) for _ in range(m)]
    for j in range(m):
        w = A(Vs[j])
        h = _dots(Vs, w, mesh)
        for hi, Vi in zip(h, Vs):
            w = w - hi * Vi
        h2 = _dots(Vs, w, mesh)
        for hi, Vi in zip(h2, Vs):
            w = w - hi * Vi
        h = [a + c for a, c in zip(h, h2)]
        hlast = _norm(w, mesh)
        Vs.append(w / _safe(hlast))
        col = h + [hlast]
        for i in range(j):
            t0 = cs[i] * col[i] + sn[i] * col[i + 1]
            t1 = -sn[i] * col[i] + cs[i] * col[i + 1]
            col[i], col[i + 1] = t0, t1
        denom = torch.sqrt(col[j] ** 2 + col[j + 1] ** 2)
        cs.append(col[j] / _safe(denom))
        sn.append(col[j + 1] / _safe(denom))
        col[j] = denom
        Rcols.append(col[:j + 1])
        gj = cs[j] * g[j] + sn[j] * g[j + 1]
        g[j + 1] = -sn[j] * g[j] + cs[j] * g[j + 1]
        g[j] = gj
    y = [None] * m
    for j in range(m - 1, -1, -1):
        acc = g[j]
        for k in range(j + 1, m):
            acc = acc - Rcols[k][j] * y[k]
        y[j] = acc / _safe(Rcols[j][j])
    x = torch.zeros_like(r0)
    for j in range(m):
        x = x + y[j] * Vs[j]
    x = torch.where(beta > 0, x, torch.zeros_like(x))
    if x0 is not None:
        x = x + x0.reshape(-1)
    return x.reshape(shape)


def gmres_rolled(op, b, M=None, iters=12, restarts=4, x0=None, mesh=None):
    """Restarted GMRES(iters), ``restarts`` cycles, left-preconditioned.

    Counterpart: ksfd_tpu/solvers/gmres.py:gmres_rolled, its arithmetic:
    per cycle the Krylov basis as the rows of one matrix (CGS2 as two
    matrix-vector products with it), the Givens rotations applied to
    each new column as one accumulated ``(m+1, m+1)`` rotation matrix,
    back substitution with a zero diagonal guarded.  The reference's
    basis matrix holds ``m+1`` rows from the start and its products read
    the rows not yet made as zeros; here the products read only the rows
    made so far, which adds the same exact zeros.  Its breakdown
    contract is gmres_fixed's; ``mesh`` as there.
    """
    M = _identity if M is None else M
    shape, m = b.shape, int(iters)
    eye = torch.eye(m + 1, dtype=b.dtype, device=b.device)
    # the rotation of rows (j, j+1) is eye + cj-1 on both diagonal places,
    # +sj above and -sj below them (a sum, so that vmap takes it)
    units = [(eye[:, j:j + 1] * eye[j:j + 1, :],
              eye[:, j + 1:j + 2] * eye[j + 1:j + 2, :],
              eye[:, j:j + 1] * eye[j + 1:j + 2, :],
              eye[:, j + 1:j + 2] * eye[j:j + 1, :]) for j in range(m)]

    def A(v):
        return M(op(v.reshape(shape))).reshape(-1)

    def cycle(x):
        r0 = M(b - op(x.reshape(shape))).reshape(-1)
        beta = _norm(r0, mesh)
        rows = [r0 / _safe(beta)]
        Rcols = []
        Om = eye
        g = [beta] + [torch.zeros_like(beta) for _ in range(m)]
        zero = torch.zeros_like(beta)
        for j in range(m):
            w = A(rows[j])
            V = torch.stack(rows)
            h1 = _gsum(V @ w, mesh)
            w = w - h1 @ V
            h2 = _gsum(V @ w, mesh)
            w = w - h2 @ V
            hlast = _norm(w, mesh)
            rows.append(w / _safe(hlast))
            h = torch.cat([h1 + h2, hlast[None]]
                          + [zero[None]] * (m - 1 - j))
            col = Om @ h
            denom = torch.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            cj = col[j] / _safe(denom)
            sj = col[j + 1] / _safe(denom)
            ejj, e11, ej1, e1j = units[j]
            Om = (eye + (cj - 1.0) * (ejj + e11) + sj * ej1
                  - sj * e1j) @ Om
            Rcols.append(torch.cat([col[:j], denom[None],
                                    zero.expand(m - 1 - j)]))
            gj = cj * g[j] + sj * g[j + 1]
            g[j + 1] = -sj * g[j] + cj * g[j + 1]
            g[j] = gj
        y = [None] * m
        for j in range(m - 1, -1, -1):
            acc = g[j]
            for k in range(j + 1, m):
                acc = acc - Rcols[k][j] * y[k]
            rjj = Rcols[j][j]
            y[j] = acc / torch.where(rjj != 0, rjj, torch.ones_like(rjj))
        dx = torch.stack(y) @ torch.stack(rows[:m])
        dx = torch.where(beta > 0, dx, torch.zeros_like(dx))
        return x + dx

    x = (torch.zeros_like(b) if x0 is None else x0).reshape(-1)
    for _ in range(int(restarts)):
        x = cycle(x)
    return x.reshape(shape)


def gmres_restarted(op, b, M=None, iters=8, restarts=3, mesh=None):
    """GMRES(iters) restarted ``restarts`` times: gmres_fixed from the
    last cycle's answer.  Counterpart:
    ksfd_tpu/solvers/gmres.py:gmres_restarted."""
    x = None
    for _ in range(int(restarts)):
        x = gmres_fixed(op, b, M=M, iters=iters, x0=x, mesh=mesh)
    return x


def _safe_normalize(x, thresh=None, raw=False, mesh=None):
    """(x / |x|, |x|), or (0, 0) where |x| <= thresh (the dtype's eps by
    default) or is NaN: jax.scipy.sparse.linalg's _safe_normalize, on
    the device.  ``raw`` adds |x| itself."""
    norm = _norm(x, mesh)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    out = torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0)
    return out + (norm,) if raw else out


def _gmres_restart(op, M, b, x0, unit, rnorm, restart, mesh=None):
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
        _, v_norm_0 = _safe_normalize(v, mesh=mesh)
        h = _gsum(V @ v, mesh)
        v = v - h @ V
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0,
                                           mesh=mesh)
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
    return (x,) + _safe_normalize(M(b - op(x)), raw=True, mesh=mesh)


def gmres_solve(op, b, M=None, tol=1e-8, restart=20, maxiter=50, x0=None,
                mesh=None):
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
    accepted (ROADMAP Queue C).  With a ``mesh`` b is this rank's slab,
    the Krylov space's dimension is bounded by the global size, and
    every rank reads the same norms (module docstring).
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    restart = min(int(restart),
                  b.numel() * (1 if mesh is None else mesh.size))
    atol = tol * _norm(b, mesh)
    unit, rnorm, raw = _safe_normalize(M(b - op(x)), raw=True, mesh=mesh)
    for _ in range(int(maxiter)):
        norm, limit, raw = torch.stack(
            [rnorm, atol.to(rnorm.dtype), raw]).tolist()
        if not (math.isfinite(raw) and math.isfinite(limit)):
            return torch.full_like(x, math.nan)
        if not norm > limit:
            break
        x, unit, rnorm, raw = _gmres_restart(op, M, b, x, unit, rnorm,
                                             restart, mesh)
    return x
