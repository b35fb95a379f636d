"""The implicit step and the fixed-dt multistep loop.

Counterpart: ksfd_tpu/solvers/solver.py:make_step_fn and
:make_multistep_fn on a single device, on 2D and 3D periodic grids, in
its two precisions.  Both run one ROS34PW2 Rosenbrock-W step of 4
stages, each stage solve ``ksp_iters`` (3) float32 Richardson sweeps
``x = M(b)`` then ``x += M(b - W x)``, with the float32 block spectral
preconditioner in its basis-GEMM form (solvers/linalg.py) built from
the float32 state's means, ``dG/drho`` and ``rho_diff``.

- **float64 (default ``NumericsOptions()``)**: the state and the
  solution and embedded-difference sums are float64; each sweep's
  residual is the fused resid kernel (ops/fused_stencil.py,
  ops/fused_stencil3d.py); stages 2-4 get their right-hand side as
  ``f32(f0) + delta(...)``; the multistep chains f0 from step to step
  through the delta kernel, with one fresh float64 ``ops.rhs`` per
  block.  Per step: 8 resid launches (2 per stage solve) and 4 delta
  launches (3 stage right-hand sides and the f0 advance), no rhs or
  jvp.
- **float32 fast mode (``precision="float32"``)**, the reference's
  ``fast32`` branch: u, t and h are cast to float32 and everything
  after is float32.  f0 and every stage right-hand side come from the
  rhs kernel (the stage states are not groomed first: the kernel
  grooms), W is ``shift*v - jvp(u, v, t)`` with the jvp kernel, and
  the solve is the plain ``richardson_solve``; no f0 chain.  Per step:
  4 rhs launches (f0 and stages 2-4) and 8 jvp launches (2 per stage
  solve), no resid or delta.  ``stage_delta`` and ``sweep_dtype`` are
  ignored, as the reference ignores them.

Every scalar of a step (t, h, shift, the means, ``rho_diff``, ``emax``)
stays a 0-d tensor on the state's device: a step makes no host round
trip.

Everything else raises NotImplementedError naming its ROADMAP item:
the adaptive chunk and host Solver loop (Queue A items 7-8), DIRK
(item 9), other stage solvers (item 5), dense/direct tiers (item 12),
the fast mode without the fused kernels (item 6), the FFT
preconditioner (Queue A item 4), the Pallas preconditioner (Queue B
item 5) and meshes (Queue A item 14).
"""

from types import SimpleNamespace

import torch

from ..utils.cli import NumericsOptions
from ..ops.fused_stencil import make_fused_kernels
from .gmres import richardson_solve, richardson_solve_resid
from .linalg import BlockSpectralPreconditioner
from .steppers import get_tableau, wlte_norm_delta

__all__ = ["make_step_fn", "make_multistep_fn", "make_adaptive_chunk_fn",
           "Solver"]


def _fast32(numerics):
    return numerics.precision in ("float32", "f32")


def _to_f32(u, t, h):
    """The fast mode's cast of the state, t and h to float32."""
    u = u.to(torch.float32)
    return (u,) + tuple(
        torch.as_tensor(x, dtype=torch.float32, device=u.device)
        for x in (t, h)
    )


def _check_numerics(numerics, ops):
    """Raise NotImplementedError for any request off the ported paths."""
    fast32 = _fast32(numerics)
    todo = []
    if numerics.ksp_type != "richardson":
        todo.append(
            "ksp_type %r (dense/direct/banded/lu: Queue A item 12; "
            "Krylov/Chebyshev: item 5)" % numerics.ksp_type
        )
    if numerics.pc_type != "block":
        todo.append("pc_type %r (Queue A item 4)" % numerics.pc_type)
    if numerics.precision not in ("float64", "f64", "float32", "f32"):
        todo.append("precision %r (the reference has only float64 and "
                    "float32)" % numerics.precision)
    if fast32 and not numerics.use_pallas:
        todo.append(
            "the float32 fast mode without the fused kernels "
            "(use_pallas=False, the XLA-f32 RHS: Queue A item 6)"
        )
    if numerics.pc_fft != "off":
        todo.append("pc_fft %r (Queue A item 4)" % numerics.pc_fft)
    if numerics.pc_pallas:
        todo.append("pc_pallas (Queue B item 5)")
    if numerics.pc_dtype not in ("auto", "float32", "f32", "float64", "f64"):
        todo.append("pc_dtype %r (Queue A item 14)" % numerics.pc_dtype)
    if not fast32 and numerics.sweep_dtype not in ("float32", "f32"):
        todo.append("float64 sweeps (Queue A item 5)")
    if not fast32 and not (numerics.use_pallas and numerics.stage_delta):
        todo.append("stage RHS without the delta kernel (Queue A item 6)")
    if not ops.stage_delta_ok():
        todo.append("time-dependent PDE coefficients (Queue A item 6)")
    if todo:
        raise NotImplementedError(
            "not ported yet (see ROADMAP): " + "; ".join(todo)
        )


def make_step_fn(ops, numerics=None, atol=1e-5, rtol=1e-5, tableau=None,
                 mesh=None, chain_f0=False, kernels=None):
    """Build the implicit step ``(u, t, h) -> (u1, enorm)``.

    Counterpart: ksfd_tpu/solvers/solver.py:make_step_fn.  u is a
    (dof, nx, ny[, nz]) tensor; t and h are 0-d tensors on u's device,
    float64 on the default path.  In the float32 fast mode u, t and h
    are cast to float32 and u1 and enorm come back float32.  enorm <= 1
    means the step meets atol/rtol; a failed solve shows as a
    non-finite enorm.

    chain_f0: return ``SimpleNamespace(step)`` instead, where
    ``step(u, t, h, f0) -> (u1, enorm, f1)`` takes the RHS f0 at
    (groom(u), t) and returns the RHS at groom(u1), advanced by the
    delta kernel.  None when ineligible (active sources, or the fast
    mode, which has no delta kernel on its path).  The
    reference's ``advance`` (the Solver's re-base after a fallback
    step) comes with the Solver, ROADMAP Queue A item 8.

    kernels: a ``make_fused_kernels(ops)`` namespace to share between
    builds (its launch counters then count both).
    """
    if mesh is not None:
        raise NotImplementedError("meshes are ROADMAP Queue A item 14")
    numerics = numerics or NumericsOptions()
    _check_numerics(numerics, ops)
    tab = tableau or get_tableau(numerics.ts_type)
    pc_dtype = "float32" if numerics.pc_dtype == "auto" else numerics.pc_dtype
    precond = BlockSpectralPreconditioner(
        ops.grid, ops, compute_dtype=pc_dtype, device=ops.device
    )
    kern = kernels if kernels is not None else make_fused_kernels(ops)
    iters = numerics.ksp_iters
    nf = ops.nligands + 1
    fast32 = _fast32(numerics)

    def _step_core(u, t, h, f0_chained=None):
        if fast32:
            u, t, h = _to_f32(u, t, h)
        u = ops.groom(u)
        shift = 1.0 / (h * tab.gamma)
        # preconditioner statistics from the f32 view of the state
        u32 = u.to(torch.float32)
        means = [torch.mean(u32[i]) for i in range(nf)]
        # pointwise effective rho diffusivity bound (linalg docstring)
        dG0 = ops._dG_fns[0](*[u32[i] for i in range(nf)], t)
        rho_diff = torch.max(u32[0] * dG0)

        def Minv(v):
            return precond.apply_linearized(
                v, shift, t, means, rho_diff=rho_diff
            )

        if fast32:
            f0 = kern.rhs(u, t)
            # the kernel grooms the (ungroomed) stage states itself
            stage_eval = kern.rhs

            def W(v):
                return shift * v - kern.jvp(u, v, t)

            def solve(bi):
                return richardson_solve(W, bi, Minv, iters=iters)
        else:
            f0 = ops.rhs(u, t) if f0_chained is None else f0_chained
            t32 = t.to(torch.float32)
            shift32 = shift.to(torch.float32)

            def resid32(x, b):
                return kern.resid(u32, x, b, t32, shift32)

            def solve(bi):
                # f32 storage: the sweeps carry only f32 information
                return richardson_solve_resid(
                    resid32, bi.to(torch.float32), Minv, iters=iters
                )

            f032 = f0.to(torch.float32)

            def stage_eval(Ui, ti):
                """f(Ui, ti) = f32(f0) + the increment kernel, plus the
                exact change of any time-dependent source."""
                Ug = ops.groom(Ui)
                fi = f032 + kern.delta(u, Ug - u, Ug, t)
                for isrc, active in enumerate(ops._source_active):
                    if active and ops.sources[isrc].tdep:
                        src = ops.sources[isrc]
                        fi[isrc] += (src(ti) - src(t)).to(torch.float32)
                return fi

        Ys = []

        def _ysum(coeffs, scale=1.0):
            """sum_j coeffs[j]*scale * Y_j in f32 storage, or None.  A
            0-d float64 scale does not promote the f32 terms, as the
            reference's weakly typed step size does not."""
            acc = None
            for j, cj in enumerate(coeffs):
                if cj:
                    term = (cj * scale) * Ys[j]
                    acc = term if acc is None else acc + term
            return acc

        inv_h = 1.0 / h
        for i in range(tab.stages):
            asum = _ysum(tab.a[i][:i])
            Ui = u if asum is None else u + asum.to(u.dtype)
            if i == 0 and tab.alpha[0] == 0.0:
                bi = f0
            else:
                bi = stage_eval(Ui, t + tab.alpha[i] * h)
            csum = _ysum(tab.c[i][:i], scale=inv_h)
            if csum is not None:
                # bi feeds the f32 solve: one downcast, then the f32 sum
                bi = bi.to(csum.dtype) + csum
            Ys.append(solve(bi))
        # solution and embedded-difference sums in the state's dtype
        # (float64, or float32 in the fast mode) from the exact
        # (m2_j - m_j) Python-float weights
        u1 = u
        d = None
        for j in range(tab.stages):
            Yj = Ys[j].to(u.dtype)
            u1 = u1 + tab.m[j] * Yj
            dm = tab.m2[j] - tab.m[j]
            if dm:
                term = dm * Yj
                d = term if d is None else d + term
        return u, u1, wlte_norm_delta(u1, d, atol, rtol)

    if chain_f0:
        if fast32 or any(ops._source_active):
            return None, tab

        def step_chain(u, t, h, f0):
            ug, u1, enorm = _step_core(u, t, h, f0_chained=f0)
            u1g = ops.groom(u1)
            f1 = f0 + kern.delta(ug, u1g - ug, u1g, t).to(f0.dtype)
            return u1, enorm, f1

        return SimpleNamespace(step=step_chain), tab

    def step(u, t, h):
        _, u1, enorm = _step_core(u, t, h)
        return u1, enorm

    return step, tab


def make_multistep_fn(ops, numerics=None, atol=1e-5, rtol=1e-5,
                      tableau=None, mesh=None, static_steps=True,
                      kernels=None):
    """Fixed-dt multistep function ``fn(u, t, h, nsteps) -> (u, t, emax)``.

    Counterpart: ksfd_tpu/solvers/solver.py:make_multistep_fn.  The
    steps are a Python loop over device work (PyTorch runs eagerly, so
    ``static_steps`` has nothing to select and is accepted for
    signature parity).  u is float64; t and h are 0-d float64 tensors
    on u's device; emax is the largest enorm of the block, a 0-d
    tensor.  On the default path the base RHS f0 is evaluated fresh
    once per call and chained through the delta kernel.  In the
    float32 fast mode u, t and h are cast to float32 once before the
    loop, t accumulates in float32, the plain step loop runs (no f0
    chain) and u, t and emax come back float32.  Returns (fn, tableau).
    """
    kern = kernels if kernels is not None else make_fused_kernels(ops)
    step, tab = make_step_fn(
        ops, numerics, atol=atol, rtol=rtol, tableau=tableau, mesh=mesh,
        kernels=kern,
    )
    chain, _ = make_step_fn(
        ops, numerics, atol=atol, rtol=rtol, tableau=tableau, mesh=mesh,
        chain_f0=True, kernels=kern,
    )

    fast32 = _fast32(numerics or NumericsOptions())

    def multi(u, t, h, nsteps):
        if fast32:
            u, t, h = _to_f32(u, t, h)
        emax = torch.zeros_like(h)
        if chain is not None:
            u = ops.groom(u)
            f0 = ops.rhs(u, t)
            for _ in range(int(nsteps)):
                u, enorm, f0 = chain.step(u, t, h, f0)
                t = t + h
                emax = torch.maximum(emax, enorm)
            return u, t, emax
        for _ in range(int(nsteps)):
            u, enorm = step(u, t, h)
            t = t + h
            emax = torch.maximum(emax, enorm)
        return u, t, emax

    return multi, tab


def make_adaptive_chunk_fn(ops, numerics=None, **kwargs):
    """Counterpart: ksfd_tpu/solvers/solver.py:make_adaptive_chunk_fn."""
    raise NotImplementedError(
        "the adaptive chunk (tier ladder) is ROADMAP Queue A item 7"
    )


class Solver:
    """Counterpart: ksfd_tpu/solvers/solver.py:Solver."""

    def __init__(self, ops, numerics=None, **kwargs):
        raise NotImplementedError(
            "the host Solver loop (noise, monitors, I/O, fallback) is "
            "ROADMAP Queue A item 8"
        )
