"""Fixed-count preconditioned Richardson stage solvers.

Counterpart: ksfd_tpu/solvers/gmres.py:richardson_solve and
:richardson_solve_resid.  The sweep count is static and there is no
data-dependent control flow: solve quality is judged by the caller's
embedded step-error control.  PyTorch runs eagerly, so the sweeps are a
plain Python loop (the reference's unroll threshold is an XLA concern).
The Krylov and Chebyshev solvers wait for ROADMAP Queue A item 5.
"""

__all__ = ["richardson_solve", "richardson_solve_resid"]


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
