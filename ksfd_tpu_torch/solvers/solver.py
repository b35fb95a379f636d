"""The implicit step, the fixed-dt multistep loop, the adaptive chunk and
the host Solver.

Counterpart: ksfd_tpu/solvers/solver.py:make_step_fn,
:make_multistep_fn, :make_adaptive_chunk_fn, :chunk_cfl_safety,
:next_noise_time, :route_petsc_direct and :Solver on a single device,
on 1D, 2D and 3D periodic grids, in its two precisions.  A step is one ROS34PW2 Rosenbrock-W step of 4
stages, each stage solve ``ksp_iters`` preconditioner applications:
Richardson sweeps ``x = M(b)`` then ``x += M(b - W x)``, or
(``ksp_type="chebyshev"``) the Chebyshev recurrence of solvers/gmres.py
on an interval estimated on the device from the pointwise diffusivity
spread.  M is the float32 block spectral preconditioner built from the
state's means, ``dG/drho`` and ``rho_diff``: in its basis-GEMM form
(solvers/linalg.py), or with ``pc_pallas=True`` as the fused apply of
ops/fused_pc.py, whose scalar pack is built once per step; where the
reference's gate falls back too (a 1D or 3D grid, float64 transforms, a
mesh, a with-G state) ``pc_pallas`` takes the basis-GEMM form, and
``build_info`` says why.

The step kind is the reference's (solver.py:296-335, :391-424).  The
fused kernels (ops/fused_stencil.py, ops/fused_stencil3d.py) run where
``use_pallas`` and the gate (``kernels_available``: 2D, or 3D with every
extent at least ``2*sw+1``, the physical fields only, no flux form)
allow; elsewhere the step is **unfused**, as the reference's XLA path.
Time-dependent PDE coefficients keep the kernels, which read t from
their scalar packs, and drop only the delta kernel (the stage
right-hand sides from ``ops.rhs`` at each stage time), as the
reference does.

- **float64 with float32 sweeps (default ``NumericsOptions()``), the
  mixed path**: the state and the solution and embedded-difference sums
  are float64, the sweeps float32.  With the kernels each sweep's
  residual is the fused resid kernel; stages 2-4 get their right-hand
  side as ``f32(f0) + delta(...)`` from the delta kernel; the multistep
  chains f0 from step to step through the delta kernel, with one fresh
  float64 ``ops.rhs`` per block.  Per step with 3 sweeps: 8 resid
  launches (2 per stage solve) and 4 delta launches (3 stage right-hand
  sides and the f0 advance), no rhs or jvp; with ``pc_pallas`` also 12
  pc_fwd and 12 pc_inv.  With ``-stage_delta 0`` or time-dependent
  coefficients the stage right-hand sides come from the float64
  ``ops.rhs`` at each stage time (8 resid launches, no delta);
  unfused, W is float32, from the float32 RHS linearized once per
  step, and the stage right-hand sides come from ``ops.rhs``.
- **float64 sweeps (``sweep_dtype="float64"``)**: f0 and the J-action
  from the float64 RHS linearized once per step, W = shift*v - J v and
  the sweeps in float64, stage right-hand sides from ``ops.rhs``; no
  kernel.
- **float32 fast mode (``precision="float32"``)**, the reference's
  ``fast32`` branch: u, t and h are cast to float32 and everything
  after is float32.  With the kernels f0 and every stage right-hand
  side come from the rhs kernel (the stage states are not groomed
  first: the kernel grooms), W is ``shift*v - jvp(u, v, t)`` with the
  jvp kernel, and the solve is the plain ``richardson_solve`` (or
  ``chebyshev_solve``); no f0 chain.  Per step with 3 sweeps: 4 rhs
  launches (f0 and stages 2-4) and 8 jvp launches (2 per stage solve),
  no resid or delta.  Unfused (``use_pallas=False``, the reference's
  XLA-f32 RHS) f0 and W come from the float32 RHS linearized once per
  step.  ``stage_delta`` and ``sweep_dtype`` are ignored, as the
  reference ignores them.
- **float64 GMRES (``ksp_type="gmres_scipy"``)**, the robust retry step
  of the ensemble (solvers/ensemble.py) and of the host Solver:
  W = shift*I - J in float64 from the RHS linearized once per step,
  the basis-GEMM (or fused) pc as M with its statistics from the
  float64 state, the restarted GMRES of solvers/gmres.py
  ``gmres_solve`` (``ksp_rtol``, ``ksp_restart``, ``ksp_max_it``),
  stage right-hand sides from the float64 ``ops.rhs`` with
  ``stage_delta=False`` (as the fallback builds it) or ``f0 + delta``
  otherwise, all combinations in float64 (solver.py:399-401, :431-435,
  :607-615).  It is never mixed32 (:529-539).  In the fast mode the same
  solve runs in float32 on the jvp kernel's W.  No f0 chain.
- **The fixed-count Krylov tiers** (solver.py:571-633, solvers/gmres.py):
  ``ksp_type`` gmres (``gmres_fixed`` of ``ksp_iters``), gmres_restarted
  (GMRES(8) restarted ``max(3, ksp_iters // 3)`` times) and
  gmres_rolled (GMRES(``ksp_restart``), ``ksp_max_it`` cycles), and
  ``pc_type`` none with Richardson or Chebyshev (``gmres_fixed`` of
  ``ksp_iters`` without a pc).  gmres_rolled with the float32 sweeps
  and a pc is mixed32: its W is ``shift*v - jvp(u32, v)``, **the jvp
  kernel** (B2) inside the float64 step (unfused: the float32 RHS
  linearized once per step), its right-hand sides ``f32(f0) + delta``
  with the delta kernel and the f0 chain, as the Richardson sweeps'; per
  step 4 ``ksp_max_it (ksp_restart + 1)`` jvp and 4 delta launches, no
  resid.  The others solve in the state's dtype on W from the RHS
  linearized once per step (the fast mode's jvp kernel), the stage
  right-hand sides ``f0 + delta`` where the delta kernel runs.

The unfused step's linearization (ops/operators.py
PDEOperators.linearize) evaluates the groomed fields, G, its stencils
and every dG/dfield once per step; each W apply is then stencils and
products, the counterpart of applying ``jax.linearize``'s tangent
function.  It runs under ``torch.func.vmap`` (the ensemble), which
``torch.func.linearize`` does not, and costs a fraction of forward-mode
AD's host time per apply (PERF.md section 6).

Every scalar of a step (t, h, shift, the means, ``rho_diff``, the
Chebyshev interval, ``emax``) stays a 0-d tensor on the state's device:
a step makes no host round trip.  The adaptive chunk's controller runs
on the host and reads one scalar per attempt (see
make_adaptive_chunk_fn).

``EnsembleSolver`` vmaps these steps unchanged (``torch.func.vmap``):
each fused kernel call launches its member-batched build once.

**On a mesh** (``mesh=``, parallel/mesh.py) the step, the multistep,
the chunk and the Solver run SPMD, one torch.distributed rank per box
of the grid, each on its local block: on an x split the halo-slab
kernels (B9), on a y or z split and on a 1D grid the unfused step (the
reference's ``pallas_mesh_ok`` sends those to XLA); the sharded
block or spectral basis-GEMM pc (one all_reduce per apply, bfloat16 by
default on more than one rank), or the FFT pc on the gathered state;
global means, pc statistics and error norms; the GMRES steps with their
inner products summed over the ranks, the unfused step on the block's
RHS linearized with its halo rows (``ops.reach`` rows: ``2*sw`` in the
flux form), and the exact tiers as the reference's replicated host
solve.  With-G states refresh their pointwise G slot on the block.

**The exact tiers** (solver.py:200-254, :1297-1328): ``ksp_type``
dense or direct LU-factors W = shift*I - J once per step, J the RHS's
linearization applied to the identity, and each stage solve is two
triangular solves (``torch.linalg.lu_factor``/``lu_solve``, a
small-problem tier); banded (1D) and lu (any dimension) are the host
steps of solvers/banded_path.py and solvers/direct.py, which make_step_fn
returns with the step's contract.  No exact tier launches a kernel.

**The Solver** runs the reference's host loop over these: the fixed-dt
blocks, the per-step adaptive loop with its GMRES fallback and exact-LU
rescue, and the device loop's chunk (class docstring).

**The DIRK path** (``ts_type`` arkimex, ark324, ark436: the ESDIRK
tableaus of solvers/steppers.py; solver.py:643-688) runs on every
route above (``_combine_dirk``): stage i solves ``U_i = u0 + h sum_{j<i}
A_ij f_j + h gamma f(U_i)`` by ``max(1, snes_iters)`` modified-Newton
iterations with the held W, ``U <- U - shift * solve(U - h gamma f(U) -
r)``, from the predictor ``U_i = r``.  Its stage right-hand sides feed
float64 combinations, so on the mixed path they are ``f0 + delta`` in
float64 (never the Rosenbrock stages' float32 ``f32(f0) + delta``).
Per step with 3 sweeps and 2 Newton iterations ARK324 launches 12
resid and 9 delta (ARK436 20 and 15; ``snes_iters`` 1 6 and 6), and the
f0 chain one delta more; in the fast mode 10 rhs and 12 jvp.  The host
exact steps (banded, lu) are Rosenbrock-only and raise ValueError.

**The preconditioner forms** (solver.py:217-263): ``pc_type`` block
(above) or spectral (each field's stiff part, ``ops.stiff_coefficients``),
each in its basis-GEMM form or, with ``pc_fft`` on (auto: without a mesh
and with one visible device), its float32 FFT form; ``pc_dtype``
bfloat16 on one card or a mesh; ``pc_type`` none with the GMRES step
and the exact tiers.  ``pc_pallas`` fuses only the block pc's basis
form, as the reference's does.

**With-G states** (ops/operators_with_g.py) take the unfused step, the
pc's shift-only inverse on the trailing G field, and ``pc_pallas``
falls back to the basis-GEMM pc there, as the reference's gate does;
the Solver refreshes the G slot after every accepted step.

What the reference refuses raises here too: a mesh that leaves ranks
idle or splits blocks thinner than the stencil's reach (ValueError),
and a halo-slab kernel under vmap (an ensemble on a mesh takes the
unfused step, solvers/ensemble.py).
"""

import dataclasses
import math
from datetime import datetime
from types import SimpleNamespace

import torch

from ..utils.cli import NumericsOptions
from ..utils.debug import logger
from ..ops.fused_pc import (
    fused_pc_refusal,
    make_fused_block_pc,
    pack_pc_scalars,
    reference_fuses,
)
from ..ops.fused_stencil import (
    check_mesh,
    kernel_refusal,
    make_fused_kernels,
    mesh_kernel_refusal,
)
from ..parallel.mesh import all_reduce_max, all_reduce_sum
from .direct import replicated_step
from .gmres import (
    chebyshev_solve,
    chebyshev_solve_resid,
    gmres_fixed,
    gmres_restarted,
    gmres_rolled,
    gmres_solve,
    richardson_solve,
    richardson_solve_resid,
)
from .linalg import (
    BlockSpectralPreconditioner,
    SpectralPreconditioner,
    make_sharded_apply,
)
from .steppers import DIRKTableau, get_tableau, wlte_norm_delta

logTS = logger("TS")

__all__ = ["make_step_fn", "make_multistep_fn", "make_adaptive_chunk_fn",
           "build_chunk_tiers", "run_attempts", "chunk_cfl_safety",
           "next_noise_time", "noise_active", "step_kernels",
           "route_petsc_direct", "Solver", "print_monitor",
           "history_monitor"]


#: the exact tiers: dense LU in the step (``use_dense``), and the host
#: steps of solvers/banded_path.py (1D) and solvers/direct.py
EXACT_KSP = ("dense", "direct", "banded", "lu")
#: the GMRES stage solvers: fixed-count (solvers/gmres.py) and, last, the
#: tolerance-based one of the robust fallback
GMRES_KSP = ("gmres", "gmres_rolled", "gmres_restarted", "gmres_scipy")


def _use_dense(numerics):
    """The reference's ``use_dense`` (solver.py:200): exact dense LU
    stage solves."""
    return numerics.ksp_type in ("dense", "direct")


def _fast32(numerics):
    """The float32 fast mode; the exact tiers ignore ``precision``, as
    the reference's ``fast32`` does (solver.py:254)."""
    return (numerics.precision in ("float32", "f32")
            and numerics.ksp_type not in EXACT_KSP)


def _to_f32(u, t, h):
    """The fast mode's cast of the state, t and h to float32."""
    u = u.to(torch.float32)
    return (u,) + tuple(
        torch.as_tensor(x, dtype=torch.float32, device=u.device)
        for x in (t, h)
    )


def _pc_dtype(numerics, mesh=None):
    """pc_dtype 'auto' resolves to bfloat16 on a mesh of more than one
    rank, the sharded apply's one bf16 all_reduce (solver.py:203-216),
    and to float32 otherwise; an explicit pc_dtype wins."""
    if numerics.pc_dtype != "auto":
        return numerics.pc_dtype
    return "bfloat16" if mesh is not None and mesh.size > 1 else "float32"


def _pc_fft(numerics, ops, mesh=None):
    """Whether the pc takes its FFT form (solver.py:217-230): ``pc_fft``
    on; off; auto only without a mesh and with one visible device of the
    state's kind (the reference's ``len(jax.devices()) == 1``: the CPU
    is one device, the card one of ``torch.cuda.device_count()``)."""
    if numerics.pc_fft == "on":
        return True
    if numerics.pc_fft == "off" or mesh is not None:
        return False
    return (torch.device(ops.device).type != "cuda"
            or torch.cuda.device_count() == 1)


def _krylov(numerics):
    """The tolerance-based GMRES stage solve of the robust fallback."""
    return numerics.ksp_type == "gmres_scipy"


def _check_numerics(numerics, ops, mesh=None):
    """Raise NotImplementedError for any request off the ported paths."""
    todo = []
    if numerics.ksp_type not in ("richardson", "chebyshev") + GMRES_KSP \
            + EXACT_KSP:
        todo.append(
            "ksp_type %r (the reference has richardson, chebyshev, %s and "
            "%s)" % (numerics.ksp_type, ", ".join(GMRES_KSP),
                     ", ".join(EXACT_KSP)))
    if numerics.pc_type not in ("block", "spectral", "none"):
        todo.append("pc_type %r (the reference has block, spectral and "
                    "none)" % numerics.pc_type)
    if numerics.precision not in ("float64", "f64", "float32", "f32"):
        todo.append("precision %r (the reference has only float64 and "
                    "float32)" % numerics.precision)
    if numerics.pc_dtype not in ("auto", "float32", "f32", "float64", "f64",
                                 "bfloat16", "bf16"):
        todo.append("pc_dtype %r (the reference has float32, float64 and "
                    "bfloat16)" % numerics.pc_dtype)
    if todo:
        raise NotImplementedError(
            "not ported yet (see ROADMAP): " + "; ".join(todo)
        )


def _step_refusal(numerics, ops, mesh=None):
    """Why steps of these numerics launch no fused kernel, or None:
    ``use_pallas=False``, or the gate's refusal (ops/fused_stencil.py
    kernel_refusal, and on a mesh mesh_kernel_refusal: a y or z split),
    as the reference asks ``pallas_available`` and ``pallas_mesh_ok``
    (solver.py:296-330)."""
    if not numerics.use_pallas:
        return "use_pallas=False"
    if numerics.ksp_type in EXACT_KSP:
        return "ksp_type=%s (an exact tier)" % numerics.ksp_type
    return kernel_refusal(ops.grid, ops) or mesh_kernel_refusal(mesh)


def step_kernels(ops, numerics=None, mesh=None, kernels=None):
    """The ``make_fused_kernels`` namespace that steps of these numerics
    launch (``kernels`` when given), or None where they take the
    unfused step (_step_refusal)."""
    if mesh is not None:
        check_mesh(ops, mesh)
    if _step_refusal(numerics or NumericsOptions(), ops, mesh) is not None:
        return None
    return kernels if kernels is not None else make_fused_kernels(
        ops, mesh=mesh)


def _reference_fuses(numerics, ops):
    """Whether the reference's gate (ksfd_tpu/solvers/solver.py:258-282)
    runs its fused pc for this single-card request: the block pc in its
    basis form, float32 transforms, the physical fields only, and
    extents its Pallas gate admits (ops/fused_pc.py reference_fuses).
    The port fuses wherever this holds, and on more extents."""
    return (numerics.pc_type == "block"
            and _pc_dtype(numerics) not in ("float64", "f64")
            and ops.grid.dof == ops.nligands + 1
            and reference_fuses(ops.grid,
                                use_fft=_pc_fft(numerics, ops)))


def _pc_pallas_fallback(numerics, ops, mesh=None):
    """Why ``pc_pallas`` takes the basis-GEMM pc here, or None (the
    fused pc runs, ``pc_pallas`` is off, or _check_numerics refuses the
    request).  Only where the reference's gate falls back to its einsums
    too: on a mesh (its fused pc is single-shard; the sharded apply
    runs), with another pc than the block pc's basis form (the spectral
    or no pc, or the FFT form: ``pc_fft``), on a 1D or 3D grid, with
    float64 transforms and on a with-G state (ops/fused_pc.py
    fused_pc_refusal)."""
    if not numerics.pc_pallas:
        return None
    if mesh is not None:
        return "on a mesh (the fused pc is single-shard)"
    if numerics.pc_type != "block":
        return "pc_type %s (the fused pc is the block pc's)" % (
            numerics.pc_type)
    if _pc_fft(numerics, ops):
        return ("the FFT pc (the reference fuses only the basis form: "
                "solver.py:258-263)")
    return fused_pc_refusal(ops.grid, ops, _pc_dtype(numerics))


def _cheb_interval(numerics, shift, rho_dmin, rho_diff, cheb_lap):
    """The Chebyshev interval (lmin, lmax) of M^{-1}W as float32 0-d
    tensors on the device (ksfd_tpu/solvers/solver.py:436-495).

    With ``cheb_lmin`` > 0 the knobs give it, and without the block pc's
    statistics (``rho_diff`` None: the spectral pc) ``cheb_lmin`` or
    0.05 does, as the reference's default.  Otherwise it is estimated
    per step: the pc bounds the rho diffusivity by its maximum
    ``rho_diff``, so per mode the preconditioned eigenvalue is about
    ``(shift + d|lam|) / (shift + rho_diff|lam|)``, smallest at the
    stiffest mode (``cheb_lap``) and the smallest pointwise d
    (``rho_dmin``, clamped at 0);
    ``cheb_safety`` widens it downward, and the clip keeps it inside
    ``[1e-4, lmax/2]``."""
    f32 = torch.float32
    dev = shift.device
    b_hi = torch.full((), numerics.cheb_lmax, dtype=f32, device=dev)
    if numerics.cheb_lmin > 0 or rho_diff is None:
        a0 = numerics.cheb_lmin if numerics.cheb_lmin > 0 else 0.05
        return torch.full((), a0, dtype=f32, device=dev), b_hi
    s32 = shift.to(f32)
    dmin = torch.clamp(rho_dmin.to(f32), min=0.0)
    a_auto = (s32 + dmin * cheb_lap) / (s32 + rho_diff.to(f32) * cheb_lap)
    lmin = torch.minimum(
        torch.clamp(a_auto * numerics.cheb_safety, min=1e-4), 0.5 * b_hi
    )
    return lmin, b_hi


def _host_exact_step(ops, numerics, tab, atol, rtol, chain_f0=False,
                     mesh=None):
    """The host exact step of ``ksp_type`` banded (1D, the native cyclic
    banded LU) or lu (sparse SuperLU, any dimension), with the step's
    contract, as the reference's Solver builds them
    (solver.py:1297-1328); no f0 chain.  On a ``mesh`` it is the
    reference's replicated host solve (solvers/direct.py
    replicated_step).  A DIRK tableau raises
    ValueError with the reference Solver's message (solver.py:1310-1315;
    the reference's make_step_fn instead runs float64 Richardson sweeps
    here, ROADMAP Queue C, which is not copied)."""
    if isinstance(tab, DIRKTableau):
        raise ValueError(
            "ksp_type=%s supports the Rosenbrock tableaus only; use "
            "-ts_type rosw (or a non-direct ksp_type with arkimex)"
            % numerics.ksp_type)
    if chain_f0:
        return None, tab
    if numerics.ksp_type == "banded":
        from .banded_path import make_banded_step as make
    else:
        from .direct import make_sparse_step as make
    step = make(ops, tab, atol=atol, rtol=rtol)
    if mesh is not None:
        step = replicated_step(step, mesh)
    step.build_info = dict(
        ksp_type=numerics.ksp_type, kernels=None,
        kernel_refusal=_step_refusal(numerics, ops), pc=None,
        mesh_shape=None if mesh is None else mesh.shape,
        host="probes and stage RHS on %s, assembly, factorization and "
        "solves on the host%s" % (
            ops.device, "" if mesh is None else
            "; replicated on every rank from the gathered state"))
    return step, tab


def make_step_fn(ops, numerics=None, atol=1e-5, rtol=1e-5, tableau=None,
                 mesh=None, chain_f0=False, kernels=None, fused_pc=None):
    """Build the implicit step ``(u, t, h) -> (u1, enorm)``.

    Counterpart: ksfd_tpu/solvers/solver.py:make_step_fn.  u is a
    (dof, nx[, ny[, nz]]) tensor; t and h are 0-d tensors on u's device,
    float64 on the default path.  In the float32 fast mode u, t and h
    are cast to float32 and u1 and enorm come back float32.  enorm <= 1
    means the step meets atol/rtol; a failed solve shows as a
    non-finite enorm.

    The step kind follows the reference's (solver.py:296-335, :391-424):
    the fused kernels run where ``use_pallas`` and the gate
    (``kernels_available``) allow; the delta kernel only on the mixed
    path with ``stage_delta`` and time-independent coefficients.  Off
    the kernels the step is unfused (module docstring), its J-action
    from ``ops.linearize`` once per step.

    chain_f0: return ``SimpleNamespace(step)`` instead, where
    ``step(u, t, h, f0) -> (u1, enorm, f1)`` takes the RHS f0 at
    (groom(u), t) and returns the RHS at groom(u1), advanced by the
    delta kernel.  None when ineligible (no delta kernel on the path:
    the fast mode, the GMRES step, the unfused step, ``-stage_delta 0``
    or time-dependent coefficients; or active sources).

    kernels: a ``make_fused_kernels(ops, mesh)`` namespace to share
    between builds (its launch counters then count both); ignored where
    the step launches no kernel.  fused_pc: likewise a
    ``make_fused_block_pc`` apply, used when ``numerics.pc_pallas`` and
    the fused pc runs here.

    mesh: a parallel/mesh.py SlabMesh.  The step then runs SPMD, one
    rank per box: u is this rank's local block on ``mesh.device`` (as
    ``ops.device``); on an x split the fused kernels are their
    halo-slab builds (B9), on a y or z split the step is unfused
    (``mesh_kernel_refusal``); the pc is ``make_sharded_apply`` (the
    block or spectral basis form, ``pc_dtype`` auto: bfloat16 on more
    than one rank; ``pc_pallas`` takes it too, the reference's fused pc
    being single-shard; the FFT form on the gathered state), and the
    means, the pc statistics, the Chebyshev interval and enorm are
    global over the ranks, so every rank returns the same enorm.  The
    GMRES steps reduce their inner products over the ranks
    (solvers/gmres.py), the unfused step and the float64 GMRES W apply
    linearize the block with its halo rows (``ops.linearize(mesh=)``),
    and the exact tiers are the reference's replicated host solve:
    every rank gathers the global state, runs the one-card exact step on
    it and keeps its block (solvers/direct.py replicated_step).

    The step (or the chain namespace) carries ``build_info``: which
    kernel build, pc and pc dtype run, the mesh shape, the path
    (``mixed32``, ``pallas_rhs``/``_jvp``/``_resid``/``_delta`` as the
    reference's BUILD_INFO, solver.py:362-379; ``kernel_refusal`` says
    why no kernel runs) and (``pc_pallas_fallback``) why ``pc_pallas``
    runs the basis-GEMM pc.
    """
    if mesh is not None:
        check_mesh(ops, mesh)
    numerics = numerics or NumericsOptions()
    _check_numerics(numerics, ops, mesh)
    tab = tableau or get_tableau(numerics.ts_type)
    is_dirk = isinstance(tab, DIRKTableau)
    if numerics.ksp_type in ("banded", "lu"):
        return _host_exact_step(ops, numerics, tab, atol, rtol, chain_f0,
                                mesh)
    use_dense = _use_dense(numerics)
    if mesh is not None and use_dense:
        # the replicated dense solve: the one-card step on the gathered
        # state (it launches no kernel and has no f0 chain)
        step, tab = make_step_fn(ops, numerics, atol=atol, rtol=rtol,
                                 tableau=tab)
        if chain_f0:
            return None, tab
        rstep = replicated_step(step, mesh)
        rstep.build_info = dict(step.build_info, mesh_shape=mesh.shape,
                                host="replicated on every rank from the "
                                "gathered state")
        return rstep, tab
    pc_dtype = _pc_dtype(numerics, mesh)
    use_fft = _pc_fft(numerics, ops, mesh)
    block_pc = numerics.pc_type == "block" and not use_dense
    precond = None
    if block_pc:
        precond = BlockSpectralPreconditioner(
            ops.grid, ops, compute_dtype=pc_dtype, device=ops.device,
            use_fft=use_fft)
    elif numerics.pc_type == "spectral" and not use_dense:
        precond = SpectralPreconditioner(
            ops.grid, compute_dtype=pc_dtype, device=ops.device,
            use_fft=use_fft)
    kern = step_kernels(ops, numerics, mesh, kernels)
    if kern is not None and kern.mesh is not mesh:
        raise ValueError("the kernels were built for mesh %r, the step for "
                         "%r" % (kern.mesh, mesh))
    pc_fused = pc_sharded = None
    pc_fallback = _pc_pallas_fallback(numerics, ops, mesh)
    if mesh is not None and precond is not None:
        pc_sharded = make_sharded_apply(precond, ops, mesh)
    elif block_pc and numerics.pc_pallas and pc_fallback is None:
        pc_fused = (fused_pc if fused_pc is not None
                    else make_fused_block_pc(ops.grid, ops))
    iters = numerics.ksp_iters
    nf = ops.nligands + 1
    fast32 = _fast32(numerics)
    krylov = _krylov(numerics)
    ksp = numerics.ksp_type
    sweep32 = numerics.sweep_dtype in ("float32", "f32")
    # the reference's static path choice (solver.py:318-335, :362-379):
    # the rhs kernel in the fast mode, the delta kernel on the f32-sweep
    # path with stage_delta and time-independent coefficients, and the
    # mixed-precision sweeps (f32 W and solve, f64 stage RHS) wherever
    # the sweeps are f32 and the state is not
    pallas_rhs = kern is not None and fast32
    pallas_delta = (kern is not None and not fast32 and numerics.stage_delta
                    and sweep32 and ops.stage_delta_ok())
    mixed32 = (not fast32 and sweep32 and precond is not None
               and ksp in ("richardson", "chebyshev", "gmres_rolled"))
    use_cheb = numerics.ksp_type == "chebyshev"

    def gmres(W, bi, Minv):
        return gmres_solve(W, bi, Minv, tol=numerics.ksp_rtol,
                           restart=numerics.ksp_restart,
                           maxiter=numerics.ksp_max_it, mesh=mesh)

    def linearize(x, tt, primal=True):
        """The RHS linearized once per step (on a mesh, the slab with
        its halo rows)."""
        if mesh is None:
            return ops.linearize(x, tt, primal=primal)
        return ops.linearize(x, tt, primal=primal, mesh=mesh)
    # the Laplacian's largest |eigenvalue|, a build-time constant that
    # turns the per-step diffusivity spread into the Chebyshev interval
    cheb_lap = (float((-precond.lam).max())
                if use_cheb and precond is not None else None)
    build_info = dict(
        kernels=None if kern is None else kern.kind,
        kernel_refusal=_step_refusal(numerics, ops, mesh), pc_dtype=pc_dtype,
        pc=(("sharded " + ("" if block_pc else "spectral ")
             + ("FFT, gathered" if use_fft
                else "basis-GEMM, one all_reduce per apply"))
            if pc_sharded else "fused (B5a, B5b)" if pc_fused
            else None if precond is None
            else ("" if block_pc else "spectral ")
            + ("FFT" if use_fft else "basis-GEMM")),
        mesh_shape=None if mesh is None else mesh.shape,
        ksp_type=numerics.ksp_type, cheb=use_cheb, fast32=fast32,
        mixed32=mixed32, pallas_rhs=pallas_rhs,
        pallas_jvp=kern is not None, pallas_resid=kern is not None,
        pallas_delta=pallas_delta, pc_pallas_fallback=pc_fallback,
    )

    def source(isrc, t):
        """Source ``isrc`` at t on this rank's rows."""
        src = ops.sources[isrc](t)
        return src if mesh is None else mesh.local(src)

    def rhs(x, t):
        """The float64 (or, on a float32 x, float32) RHS."""
        return ops.rhs(x, t, mesh=mesh)

    def global_means(x):
        """Per-field means of x (f32 on the sweep paths), over the mesh."""
        if mesh is None:
            return [torch.mean(x[i]) for i in range(nf)]
        sums = all_reduce_sum(torch.stack([torch.sum(x[i])
                                           for i in range(nf)]), mesh)
        return list(sums / mesh.n_points)

    def _step_core(u, t, h, f0_chained=None):
        if fast32:
            u, t, h = _to_f32(u, t, h)
        u = ops.groom(u)
        shift = 1.0 / (h * tab.gamma)
        if use_dense:
            # f0 and J from the RHS linearized once per step, J as a
            # matrix (its action on the identity), W = shift*I - J
            # LU-factored once; each stage solve two triangular solves
            # (linalg.py:399 dense_solve_factory)
            f0, jvp_fn = ops.linearize(u, t)
            n_dof = u.numel()
            eye = torch.eye(n_dof, dtype=u.dtype, device=u.device)
            J = torch.func.vmap(jvp_fn)(eye.reshape((n_dof,) + u.shape))
            W_mat = shift * eye - J.reshape(n_dof, n_dof).T
            lu_piv = torch.linalg.lu_factor(W_mat)

            def solve(bi):
                y = torch.linalg.lu_solve(*lu_piv, bi.reshape(-1, 1))
                return y.reshape(bi.shape)
            return combine(u, f0, t, h, rhs, solve)
        u32 = u.to(torch.float32)
        rho_diff = rho_dmin = Minv = None
        if block_pc:
            # preconditioner statistics from the f32 view of the state
            # on the mixed path, from the state itself elsewhere (the
            # reference's ``ustat``, solver.py:451-453)
            ustat = u32 if mixed32 else u
            means = global_means(ustat)
            # pointwise effective rho diffusivity bound (linalg
            # docstring)
            dG0 = ops._dG_fns[0](*[ustat[i] for i in range(nf)], t)
            rho_d = ustat[0] * dG0
            rho_diff = torch.max(rho_d)
            rho_dmin = torch.min(rho_d) if use_cheb else None
            if mesh is not None:
                # the max (and for Chebyshev the min): one reduction
                ext = all_reduce_max(torch.stack(
                    [rho_diff] + ([-rho_dmin] if use_cheb else [])), mesh)
                rho_diff = ext[0]
                rho_dmin = -ext[1] if use_cheb else None
        cheb_ab = _cheb_interval(numerics, shift, rho_dmin, rho_diff,
                                 cheb_lap) if use_cheb else None

        if pc_sharded is not None and block_pc:
            def Minv(v):
                return pc_sharded(v, shift, t, means, rho_diff)
        elif pc_fused is not None:
            # the scalar pack once per step, not per apply
            sc_pc = pack_pc_scalars(ops, shift, t, means, rho_diff)

            def Minv(v):
                return pc_fused(sc_pc, v.to(torch.float32)).to(v.dtype)
        elif block_pc:
            def Minv(v):
                return precond.apply_linearized(
                    v, shift, t, means, rho_diff=rho_diff
                )
        elif precond is not None:
            # the spectral pc: each field's stiff part (solver.py:513-515)
            diff, decay = ops.stiff_coefficients(t)
            apply = pc_sharded if pc_sharded is not None else precond.apply

            def Minv(v):
                return apply(v, shift, diff, decay)

        # f0, the J-action and the stage RHS (solver.py:391-424): the
        # fast mode's kernels; the mixed path's float64 RHS (its W
        # comes below); else the RHS linearized once per step
        if pallas_rhs:
            f0 = kern.rhs(u, t)
            # the kernel grooms the (ungroomed) stage states itself
            stage_rhs = kern.rhs

            def jvp_fn(v):
                return kern.jvp(u, v, t)
        elif mixed32:
            f0 = rhs(u, t) if f0_chained is None else f0_chained
            jvp_fn = None
            stage_rhs = rhs
        else:
            f0, jvp_fn = linearize(u, t)
            stage_rhs = rhs

        if pallas_delta:
            # f(Ui, ti) as f0 + the increment kernel, plus the exact
            # change of any time-dependent source; in f32 where its only
            # consumer is the f32 sweep chain (the Rosenbrock stages,
            # solver.py:680-713), in f0's float64 on the DIRK path,
            # whose stage values feed float64 combinations (:405-424)
            fbase = f0.to(torch.float32) if mixed32 and not is_dirk else f0

            def stage_eval(Ui, ti):
                Ug = ops.groom(Ui)
                fi = fbase + kern.delta(u, Ug - u, Ug, t).to(fbase.dtype)
                for isrc, active in enumerate(ops._source_active):
                    if active and ops.sources[isrc].tdep:
                        fi[isrc] += (source(isrc, ti)
                                     - source(isrc, t)).to(fbase.dtype)
                return fi
        else:
            stage_eval = stage_rhs

        if jvp_fn is not None:
            def W(v):
                return shift * v - jvp_fn(v)

        if mixed32:
            # the f32 sweep chain (solver.py:519-558): the resid kernel,
            # or W32 from the float32 RHS linearized once per step
            t32 = t.to(torch.float32)
            shift32 = shift.to(torch.float32)
            resid32 = W32 = None
            if kern is not None and ksp == "gmres_rolled":
                # the Krylov tier's W over the jvp kernel
                # (solver.py:541-545)
                def W32(v):
                    return shift32 * v - kern.jvp(u32, v, t32)
            elif kern is not None:
                def resid32(x, b):
                    return kern.resid(u32, x, b, t32, shift32)
            else:
                _, jvp32 = linearize(u32, t32, primal=False)

                def W32(v):
                    return shift32 * v - jvp32(v)

        def solve(bi):
            if mixed32:
                # f32 storage: the sweeps carry only f32 information
                b32 = bi.to(torch.float32)
                if ksp == "gmres_rolled":
                    return gmres_rolled(W32, b32, Minv,
                                        iters=numerics.ksp_restart,
                                        restarts=numerics.ksp_max_it,
                                        mesh=mesh)
                if resid32 is not None:
                    if use_cheb:
                        return chebyshev_solve_resid(
                            resid32, b32, Minv, iters=iters,
                            lmin=cheb_ab[0], lmax=cheb_ab[1])
                    return richardson_solve_resid(resid32, b32, Minv,
                                                  iters=iters)
                if use_cheb:
                    return chebyshev_solve(W32, b32, Minv, iters=iters,
                                           lmin=cheb_ab[0], lmax=cheb_ab[1])
                return richardson_solve(W32, b32, Minv, iters=iters)
            if krylov:
                return gmres(W, bi, Minv)
            if ksp == "gmres":
                return gmres_fixed(W, bi, Minv, iters=iters, mesh=mesh)
            if ksp == "gmres_rolled":
                return gmres_rolled(W, bi, Minv, iters=numerics.ksp_restart,
                                    restarts=numerics.ksp_max_it, mesh=mesh)
            if ksp == "gmres_restarted":
                return gmres_restarted(W, bi, Minv, iters=8,
                                       restarts=max(3, iters // 3),
                                       mesh=mesh)
            if Minv is None:
                # Richardson and Chebyshev need a pc: without one the
                # fixed-count GMRES solves (solver.py:629-633)
                return gmres_fixed(W, bi, None, iters=iters, mesh=mesh)
            if use_cheb:
                return chebyshev_solve(W, bi, Minv, iters=iters,
                                       lmin=cheb_ab[0], lmax=cheb_ab[1])
            return richardson_solve(W, bi, Minv, iters=iters)

        return combine(u, f0, t, h, stage_eval, solve)

    def _combine(u, f0, t, h, stage_eval, solve):
        """The stages and the step from f0, the stage RHS and the stage
        solve: returns (groomed u, u1, enorm)."""
        Ys = []

        def _ysum(coeffs, scale=1.0):
            """sum_j coeffs[j]*scale * Y_j (f32 storage on the mixed
            path, the state's dtype elsewhere), or None.  A 0-d float64
            scale does not promote the f32 terms, as the reference's
            weakly typed step size does not."""
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
                # on the mixed path bi feeds the f32 solve: one
                # downcast, then the f32 sum
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
        return u, u1, wlte_norm_delta(u1, d, atol, rtol, mesh=mesh)

    def _combine_dirk(u, f0, t, h, stage_eval, solve):
        """The ESDIRK stages and the step (solver.py:643-688): stage i
        solves ``U_i = r_i + h gamma f(U_i)``, ``r_i = u0 + h sum_{j<i}
        A_ij f_j``, by ``max(1, snes_iters)`` modified-Newton iterations
        with the held W from the predictor ``U_i = r_i`` (the reference
        measured its extrapolated start as worse, :656-668); the
        solution and the embedded difference ``d = h sum (bhat_j - b_j)
        f_j`` from exact Python-float weights, zero weights skipped.
        The solve's float32 result on the mixed path is cast up before
        the update.  Returns (groomed u, u1, enorm)."""
        newton_iters = max(1, int(numerics.snes_iters))
        shift = 1.0 / (h * tab.gamma)
        fs = [f0]
        for i in range(1, tab.stages):
            r = u
            for j in range(i):
                if tab.A[i][j]:
                    r = r + (h * tab.A[i][j]) * fs[j]
            ti = t + tab.c[i] * h
            Ui = r
            fUi = stage_eval(Ui, ti)
            for _ in range(newton_iters):
                res = Ui - (h * tab.gamma) * fUi - r
                Ui = Ui - shift * solve(res).to(u.dtype)
                fUi = stage_eval(Ui, ti)
            fs.append(fUi)
        u1 = u
        d = None
        for j in range(tab.stages):
            if tab.b[j]:
                u1 = u1 + (h * tab.b[j]) * fs[j]
            db = tab.bhat[j] - tab.b[j]
            if db:
                term = (h * db) * fs[j]
                d = term if d is None else d + term
        return u, u1, wlte_norm_delta(u1, d, atol, rtol, mesh=mesh)

    combine = _combine_dirk if is_dirk else _combine

    if chain_f0:
        if not (mixed32 and pallas_delta) or any(ops._source_active):
            return None, tab

        def step_chain(u, t, h, f0):
            ug, u1, enorm = _step_core(u, t, h, f0_chained=f0)
            u1g = ops.groom(u1)
            f1 = f0 + kern.delta(ug, u1g - ug, u1g, t).to(f0.dtype)
            return u1, enorm, f1

        return SimpleNamespace(step=step_chain, build_info=build_info), tab

    def step(u, t, h):
        _, u1, enorm = _step_core(u, t, h)
        return u1, enorm

    step.build_info = build_info
    return step, tab


def make_multistep_fn(ops, numerics=None, atol=1e-5, rtol=1e-5,
                      tableau=None, mesh=None, static_steps=True,
                      kernels=None, fused_pc=None):
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
    chain) and u, t and emax come back float32.  The unfused step has
    no f0 chain either.  Returns (fn, tableau);
    ``fn.kernels`` (None on the unfused step) and ``fn.fused_pc`` (None
    without ``pc_pallas``) hold
    the kernel wrappers the steps share, and their launch counters;
    ``kernels`` and ``fused_pc`` pass in ones to share.  With a
    ``mesh`` (parallel/mesh.py) every rank passes its local slab and
    gets its slab back (make_step_fn; the fresh f0 is the sharded
    ``ops.rhs``).
    """
    kern = step_kernels(ops, numerics, mesh, kernels)
    pc = (fused_pc if fused_pc is not None
          else _shared_fused_pc(ops, numerics, mesh))
    step, tab = make_step_fn(
        ops, numerics, atol=atol, rtol=rtol, tableau=tableau, mesh=mesh,
        kernels=kern, fused_pc=pc,
    )
    chain, _ = make_step_fn(
        ops, numerics, atol=atol, rtol=rtol, tableau=tableau, mesh=mesh,
        chain_f0=True, kernels=kern, fused_pc=pc,
    )

    fast32 = _fast32(numerics or NumericsOptions())

    def multi(u, t, h, nsteps):
        if fast32:
            u, t, h = _to_f32(u, t, h)
        emax = torch.zeros_like(h)
        if chain is not None:
            u = ops.groom(u)
            f0 = ops.rhs(u, t, mesh=mesh)
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

    multi.kernels, multi.fused_pc = kern, pc
    multi.build_info = step.build_info
    return multi, tab


def _shared_fused_pc(ops, numerics, mesh):
    """One fused pc shared by the steps that make_multistep_fn or
    make_adaptive_chunk_fn builds, or None.  The options are checked
    first, so a refused request raises as make_step_fn would."""
    numerics = numerics or NumericsOptions()
    if not numerics.pc_pallas or _pc_pallas_fallback(numerics, ops, mesh):
        return None
    _check_numerics(numerics, ops)
    return make_fused_block_pc(ops.grid, ops)


def chunk_cfl_safety(ps):
    """Constant CFL factor for the adaptive chunk's clamp, or None (a
    time-dependent factor needs the per-step host loop).  Counterpart:
    ksfd_tpu/solvers/solver.py:chunk_cfl_safety."""
    s = float(ps.values0.get("CFL_safety_factor", 0.0) or 0.0)
    return s if s > 0.0 else None


def next_noise_time(ps, lastvart, tmax):
    """Smallest t in (lastvart, tmax] with VTF(t) - VTF(lastvart) >= 1,
    or None when no injection is due before tmax, by bisection to about
    1e-12 relative; the variance timing function is a clock
    (nondecreasing).  Counterpart: ksfd_tpu/solvers/solver.py:117
    next_noise_time, which bounds a chunk so that noise lands on the
    same accepted step as in the per-step loop."""
    fn = ps.funcs["variance_timing_function"]
    target = float(fn(lastvart)) + 1.0
    if float(fn(tmax)) < target:
        return None
    lo, hi = float(lastvart), float(tmax)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if float(fn(mid)) >= target:
            hi = mid
        else:
            lo = mid
        if hi - lo <= 1e-12 * max(1.0, abs(hi)):
            break
    return hi


def chunk_tiers(numerics):
    """The adaptive chunk's solve tiers ``[(ksp_type, ksp_iters), ...]``:
    the primary solver, then (for richardson and chebyshev only, as the
    reference's ``esc_ok``, solver.py:995-999: GMRES ignores ksp_iters,
    so a rejection shrinks h instead) ``ksp_iters_max`` sweeps, then
    ``ksp_iters_max2`` applications as Chebyshev when ``esc_cheb`` and
    the block pc (solver.py:1010-1021)."""
    tiers = [(numerics.ksp_type, int(numerics.ksp_iters))]
    esc_iters = int(getattr(numerics, "ksp_iters_max", 0) or 0)
    if (esc_iters > int(numerics.ksp_iters)
            and numerics.ksp_type in ("richardson", "chebyshev")):
        tiers.append((numerics.ksp_type, esc_iters))
        esc2 = int(getattr(numerics, "ksp_iters_max2", 0) or 0)
        if esc2 > esc_iters:
            top_type = numerics.ksp_type
            if numerics.esc_cheb and numerics.pc_type == "block":
                top_type = "chebyshev"
            tiers.append((top_type, esc2))
    return tiers


def make_cfl_maxh(ops, cfl_safety, mesh=None):
    """``cfl_maxh(u, t)``: safety * min over axes of spacing*sw /
    max|v_axis| (inf where the velocity vanishes), a 0-d tensor, for a
    constant ``cfl_safety`` > 0; else None.  The chunk's post-accept
    clamp (solver.py:963-977); it runs under ``torch.func.vmap``."""
    if cfl_safety is None or float(cfl_safety) <= 0.0:
        return None
    safety = float(cfl_safety)
    reach = [float(s) * ops.grid.stencil_width for s in ops.grid.spacing]

    def cfl_maxh(u, t):
        vmax = torch.stack([v.abs().max()
                            for v in ops.velocity(u, t, mesh=mesh)])
        if mesh is not None:
            vmax = all_reduce_max(vmax, mesh)
        reach_t = torch.tensor(reach, dtype=vmax.dtype, device=vmax.device)
        hs = torch.where(vmax > 0.0,
                         reach_t / torch.clamp(vmax, min=1e-300), math.inf)
        return safety * hs.min()

    return cfl_maxh


#: accepts a rescued step parks on its tier before probing
ESC_PARK = 16
#: a probe's tier sticks only if its accept has enorm <= PROBE_GOOD
PROBE_GOOD = 0.5


class ChunkLadder:
    """The solve-tier ladder and step-size controller of the adaptive
    chunk, on the host: ksfd_tpu/solvers/solver.py:1113-1212 with
    Python numbers for ``lax.while_loop``'s carry.

    ``update(enorm)`` takes one attempt's error norm (a float; NaN or
    inf for a failed solve) at ``self.tier`` and step ``self.h`` and
    moves the ladder, the counters and h as the reference's loop body
    does.  Two reference defects are not copied:

    - a finite rejection of an up-probe INTO THE TOP TIER
      (solver.py:1122 counts it as a top-tier controller rejection:
      shrink h, count a failure, reset the ladder) returns to the
      resident tier at the same h, counts no failure and backs the
      next probe off like an unimproved probe (``4 * ESC_PARK``);
    - ``max_attempts`` (applied by the caller) defaults to
      ``ntiers * max_rejects``, so a stuck state reaches the rejection
      exit (solver.py:883 defaults to 64 < 3 x 24).
    """

    def __init__(self, numerics, ntiers, expo, h, max_rejects=24):
        self.n = numerics
        self.ntiers = ntiers
        self.expo = expo
        self.max_rejects = max_rejects
        self.h = float(h)
        self.tier = 0
        self.park = ESC_PARK
        self.probing = 0          # 1: down-probe, 2: up-probe
        self.fails = 0

    @property
    def rejected(self):
        return self.fails >= self.max_rejects

    def update(self, enorm, cfl_h=math.inf):
        """One attempt's outcome; returns whether it was accepted.
        ``cfl_h``: the CFL bound on the next h after an accept."""
        n, top = self.n, self.ntiers - 1
        tier, park, probing = self.tier, self.park, self.probing
        finite = math.isfinite(enorm)
        ok = finite and enorm <= 1.0
        esc = retry_top = False
        if top > 0:
            esc = finite and not ok and tier < top
            topfail = finite and not ok and tier == top
            # the repaired defect: an up-probe rejected at the top tier
            retry_top = topfail and probing == 2
            topfail = topfail and not retry_top
            marginal = ok and enorm > PROBE_GOOD
            down_bounce = probing == 1 and marginal and tier < top
            up_return = probing == 2 and marginal and tier > 0
            resolved = probing > 0 and ok
            ordinary = ok and probing == 0
            if ordinary:
                park -= 1
            expire = ordinary and park <= 0
            probe_up = expire and marginal and tier < top
            probe_down = expire and not marginal and tier > 0
            if topfail:
                tier = 0
            elif esc or down_bounce or probe_up:
                tier = min(tier + 1, top)
            elif up_return or probe_down or retry_top:
                tier -= 1
            if esc or topfail or resolved or expire:
                park = ESC_PARK
            if up_return or retry_top:
                park = 4 * ESC_PARK
            probing = int(probe_down) + 2 * int(probe_up)
        h = self.h
        hfac = n.safety * max(enorm, 1e-300) ** self.expo if finite else 0.0
        if ok:
            h_acc = min(max(h * min(max(hfac, n.clip_low), n.clip_high),
                            n.dt_min), n.dt_max)
            self.h = min(h_acc, cfl_h)
            self.fails = 0
        elif not finite:
            # non-finite: exit at once with h untouched
            self.fails = self.max_rejects
        elif not (esc or retry_top):
            # a controller rejection: shrink h, count it
            self.h = max(h * min(max(hfac, n.clip_low), 0.9), n.dt_min)
            self.fails += 1
        self.tier, self.park, self.probing = tier, park, probing
        return ok


def make_adaptive_chunk_fn(ops, numerics=None, atol=1e-5, rtol=1e-5,
                           tableau=None, max_attempts=None, mesh=None,
                           max_rejects=24, cfl_safety=None, kernels=None,
                           fused_pc=None):
    """The adaptive integrator chunk ``chunk(u, t, h, tmax, max_accepts)
    -> (u, t, h, k, attempts, rejected)``, and the tableau.

    Counterpart: ksfd_tpu/solvers/solver.py:make_adaptive_chunk_fn.  It
    runs step attempts until ``max_attempts`` attempts, ``k ==
    max_accepts`` accepts, t > tmax, or the solver is stuck
    (``max_rejects`` consecutive controller rejections or a non-finite
    error norm, which leaves h untouched); ``rejected`` says it was
    stuck.  A finite rejection below the top tier retries the same h one
    tier up; the tiers are ``(ksp_type, ksp_iters)``, then (for
    richardson and chebyshev only, as the reference's ``esc_ok``)
    ``ksp_iters_max`` sweeps, then ``ksp_iters_max2`` applications as
    Chebyshev when ``esc_cheb`` (the block pc's on-device interval), with
    bidirectional probing every ``ESC_PARK`` accepts (ChunkLadder).  The
    tiers are prebuilt steps sharing one ``make_fused_kernels`` (or
    ``kernels``) and one fused pc; the f0 chain (one fresh float64 RHS
    per call, advanced by the delta kernel on accepts) is used only when
    every tier can chain.  ``cfl_safety`` > 0 clamps the post-accept h
    by the velocity CFL bound of the groomed new state.  ``kernels`` and
    ``fused_pc`` pass in a kernel build and a fused pc to share.

    ``lax.while_loop``/``lax.switch`` become a host-side controller: the
    ladder state, the counters, t and h are Python numbers, each attempt
    gets t and h as 0-d float64 device tensors, and the one host read
    per attempt is ``float(enorm)`` (with the CFL bound read in the same
    transfer).  u keeps the caller's dtype (a fast-mode attempt's
    float32 state is cast back, as the reference's carry is).
    ``chunk.stats`` holds the last call's per-attempt records
    ``(tier, enorm, h)``, the attempts per tier and the tier at exit;
    ``chunk.steps`` the tier steps the attempts call (build_chunk_tiers;
    chain steps where ``chunk.chain``).

    With a ``mesh`` (parallel/mesh.py) every rank runs the chunk on its
    slab: each attempt's enorm and CFL bound are global over the ranks
    (make_step_fn, all_reduce), so every rank reads the same values and
    its ladder takes the same decisions.
    """
    numerics = numerics or NumericsOptions()
    _check_numerics(numerics, ops, mesh)
    kern = step_kernels(ops, numerics, mesh, kernels)
    pc = (fused_pc if fused_pc is not None
          else _shared_fused_pc(ops, numerics, mesh))
    tb = build_chunk_tiers(ops, numerics, atol=atol, rtol=rtol,
                           tableau=tableau, kernels=kern, fused_pc=pc,
                           mesh=mesh)
    ntiers = len(tb.tiers)
    if max_attempts is None:
        max_attempts = ntiers * int(max_rejects)
    cfl_maxh = make_cfl_maxh(ops, cfl_safety, mesh)

    def chunk(u, t, h, tmax, max_accepts):
        dev = u.device
        ladder = ChunkLadder(numerics, ntiers, tb.expo, h, max_rejects)
        f64 = lambda x: torch.full((), x, dtype=torch.float64, device=dev)
        cur = SimpleNamespace(u=u, f0=None)
        if tb.chain:
            cur.f0 = ops.rhs(ops.groom(u), f64(float(t)), mesh=mesh)

        def attempt(tier, idx, ts, hs):
            t_, h_ = f64(ts[0]), f64(hs[0])
            if tb.chain:
                u1, enorm, f1 = tb.steps[tier](cur.u, t_, h_, cur.f0)
            else:
                (u1, enorm), f1 = tb.steps[tier](cur.u, t_, h_), None
            e = enorm.to(torch.float64).reshape(1)
            if cfl_maxh is not None:
                cfl = cfl_maxh(ops.groom(u1), f64(ts[0] + hs[0]))
                e = torch.stack([e, cfl.to(torch.float64).reshape(1)])

            def commit(acc):
                cur.u = u1.to(u.dtype)
                if f1 is not None:
                    cur.f0 = f1
            return e, commit

        run = run_attempts([ladder], [t], [tmax], [max_accepts],
                           max_attempts, attempt)
        records = run.records[0]
        per_tier = [0] * ntiers
        for tier, _, _ in records:
            per_tier[tier] += 1
        chunk.stats = SimpleNamespace(records=records, per_tier=per_tier,
                                      tier=ladder.tier, tiers=tb.tiers)
        return (cur.u, run.t[0], ladder.h, run.k[0], run.attempts[0],
                ladder.rejected)

    chunk.stats = None
    chunk.tiers, chunk.steps, chunk.chain = tb.tiers, tb.steps, tb.chain
    chunk.kernels, chunk.fused_pc = kern, pc
    chunk.build_info = tb.build_info
    return chunk, tb.tab


def build_chunk_tiers(ops, numerics, **kw):
    """The adaptive chunk's tier steps, one per ``chunk_tiers(numerics)``
    entry, built by make_step_fn with ``kw``: each tier's step ``(u, t,
    h) -> (u1, enorm)`` or, where every tier can chain f0, its chain
    step ``(u, t, h, f0) -> (u1, enorm, f1)``.  Returns a namespace of
    ``tiers``, ``steps``, ``chain`` (which kind the steps are), the
    controller's exponent ``expo``, the tableau and the first tier's
    ``build_info``.  make_adaptive_chunk_fn and the ensemble's device
    loop (solvers/ensemble.py, which vmaps the steps) share it."""
    tiers = chunk_tiers(numerics)
    builds = []
    for kt, it in tiers:
        nm_t = dataclasses.replace(numerics, ksp_type=kt, ksp_iters=it)
        step, tab = make_step_fn(ops, nm_t, **kw)
        chain, _ = make_step_fn(ops, nm_t, chain_f0=True, **kw)
        builds.append((step, chain))
    use_chain = all(c is not None for _, c in builds)
    return SimpleNamespace(
        tiers=tiers, chain=use_chain,
        steps=[c.step if use_chain else s for s, c in builds],
        expo=-1.0 / (tab.order + 1), tab=tab,
        build_info=builds[0][0].build_info)


def run_attempts(ladders, t, tmax, max_accepts, max_attempts, attempt):
    """The adaptive chunk's attempt loop (ksfd_tpu/solvers/solver.py
    :1039-1212, ``lax.while_loop``) over members, each with its own
    ChunkLadder.  A member attempts while it has attempts left
    (``max_attempts``), accepts to take (``max_accepts[i]``), its t is at
    most ``tmax[i]`` and its ladder is not stuck.

    ``attempt(tier, idx, ts, hs) -> (e, commit)`` runs the tier's step
    on the members ``idx`` (all on that tier) at their t and h and
    returns their error norms ``e``, a float64 device tensor of shape
    (n,), or (2, n) with the CFL bounds on the next h after them;
    ``commit(acc)`` keeps the results of the members at positions
    ``acc`` of ``idx``.  Each attempt runs every occupied tier before
    its one host read of all the norms; then each member's ladder moves
    and the accepted results are kept.  The single-member chunk is the
    case of one member.  Returns per member t, accepts ``k``,
    ``attempts`` and ``records`` ``[(tier, enorm, h), ...]``, and per
    attempt the occupied tiers (``occupied``)."""
    n_mem = len(ladders)
    t = [float(x) for x in t]
    tmax = [float(x) for x in tmax]
    max_accepts = [int(x) for x in max_accepts]
    k = [0] * n_mem
    attempts = [0] * n_mem
    records = [[] for _ in range(n_mem)]
    occupied = []
    while True:
        groups = {}
        for i in range(n_mem):
            if (attempts[i] < max_attempts and k[i] < max_accepts[i]
                    and t[i] <= tmax[i] and not ladders[i].rejected):
                groups.setdefault(ladders[i].tier, []).append(i)
        if not groups:
            break
        outs = []
        for tier in sorted(groups):
            idx = groups[tier]
            e, commit = attempt(tier, idx, [t[i] for i in idx],
                                [ladders[i].h for i in idx])
            outs.append((tier, idx, e, commit))
        occupied.append(sorted(groups))
        # the one host read of the attempt
        vals = torch.cat([e.reshape(-1) for _, _, e, _ in outs]).tolist()
        pos = 0
        for tier, idx, e, commit in outs:
            n = len(idx)
            es = vals[pos:pos + n]
            cfls = (vals[pos + n:pos + 2 * n] if e.dim() == 2
                    else [math.inf] * n)
            pos += e.numel()
            acc = []
            for j, i in enumerate(idx):
                h = ladders[i].h
                records[i].append((tier, es[j], h))
                attempts[i] += 1
                if ladders[i].update(es[j], cfls[j]):
                    acc.append(j)
                    t[i] = t[i] + h
                    k[i] += 1
            if acc:
                commit(acc)
    return SimpleNamespace(t=t, k=k, attempts=attempts, records=records,
                           occupied=occupied)


def noise_active(ps):
    """Whether variance injection is configured at all (the Solver and
    the EnsembleSolver share it).  Counterpart:
    ksfd_tpu/solvers/solver.py:noise_active."""
    v0 = ps.values0
    return (
        bool(v0.get("variance_rate", 0.0))
        or "variance_rate" in ps.tdfuncs
    )


def route_petsc_direct(numerics, grid):
    """Apply a PETSc-block direct-solve request (``petsc_direct``: the
    reference options' ``-ksp_type preonly -pc_type lu``, its MUMPS
    configuration) to the grid: the native banded LU in 1D, sparse LU
    at any dimension, when the grid is under the Solver's routing cap
    and the tableau is a Rosenbrock one; else the iterative stack stays,
    with a note on stderr.  Returns (possibly replaced) numerics.
    Counterpart: ksfd_tpu/solvers/solver.py:route_petsc_direct."""
    import sys

    if not getattr(numerics, "petsc_direct", False):
        return numerics
    # the 1D banded LU is O(N*b^2), not SuperLU's ~N^1.5 fill, so it
    # affords a much larger whole-run cap
    route_cap = (Solver.BANDED_ROUTE_MAX_DOFS if grid.dim == 1
                 else Solver.PETSC_ROUTE_MAX_DOFS)
    reason = None
    if isinstance(get_tableau(numerics.ts_type), DIRKTableau):
        reason = "DIRK tableau (the direct tier is Rosenbrock-only)"
    elif grid.n_dofs > route_cap:
        reason = (
            "grid too large for per-step host factorization "
            "(%d > %d dofs); the iterative stack plays MUMPS's "
            "at-scale role" % (grid.n_dofs, route_cap)
        )
    if reason is not None:
        print("ksfd: PETSc direct-solve request kept on the iterative "
              "stack: %s" % reason, file=sys.stderr)
        return numerics
    kt = "banded" if grid.dim == 1 else "lu"
    print("ksfd: PETSc '-ksp_type preonly -pc_type lu' routed to the "
          "exact direct tier: -ksp_type %s" % kt, file=sys.stderr)
    return dataclasses.replace(numerics, ksp_type=kt)


class Solver:
    """The outer adaptive implicit solver on the host (the reference's
    KSFDTS/implicitTS analog).  Counterpart:
    ksfd_tpu/solvers/solver.py:Solver.

    Usage:
        solver = Solver(ops, numerics, t0=.., dt=.., tmax=.., maxsteps=..)
        solver.add_monitor(print_monitor)
        u_final = solver.solve(u0)

    Monitors are callables ``monitor(solver, k, t, u)`` called after
    every accepted step (after every block or chunk exit in those
    modes) and once at k=0 before stepping.  The state stays on
    ``ops.device`` (the card unless the problem was built elsewhere);
    the loop, the controller and the tiers' bookkeeping run on the host
    in Python numbers, reading one scalar per step attempt.

    Modes, as the reference's: fixed-dt blocks (``block_steps > 1`` with
    ``adapt_type="none"``: make_multistep_fn), the per-step loop
    (make_step_fn; a rejected step retries at the same h on the float64
    GMRES fallback and parks there for 64 accepts; after
    ``LU_RESCUE_AFTER`` consecutive failures the exact sparse-LU step,
    parked for 4 accepts) and, with ``device_loop`` and adaptive steps,
    the adaptive chunk (make_adaptive_chunk_fn, ``max_attempts=128``),
    bounded at the next noise time, with a stuck chunk retried on the
    host.  ``ksp_type`` banded and lu are host exact steps
    (banded_path.py, direct.py), dense and direct exact dense LU in the
    step.

    ``rng_state`` takes the place of the reference's ``rng_key``: the
    noise stream is a ``torch.Generator`` on the state's device, seeded
    0 when None, from an int seed, or resumed from a generator state (a
    uint8 tensor, ``solver.rng_state`` of an earlier run); a resumed run
    continues bit for bit.  ``kernels`` shares a ``make_fused_kernels``
    namespace (its launch counters then count the Solver's launches).
    ``stats`` counts what the loop ran (see solve).

    ``mesh`` (a parallel/mesh.py SlabMesh): the loop runs SPMD, one
    torch.distributed rank per box, each on its block (``solve`` takes
    and returns the block).  The steps, the
    multistep, the chunk, the GMRES fallback and the exact tiers are
    built on the mesh and share one kernel build (on an x split its
    halo-slab entries, B9; none elsewhere).  Every decision is taken from values that every rank holds
    equal: the error norms and the CFL bound are all-reduced, the worm
    count is summed over the ranks, and the noise is drawn from the
    Solver's generator (seeded alike on every rank) at the global shape,
    each rank keeping its rows, so the injected field is the one-rank
    run's.  Accepts, rejections, tiers, fallbacks, rescues and
    ``stats`` are then equal on every rank; monitors get the rank's
    block.
    """

    default_hmin = 1e-20
    #: consecutive failures before the exact-LU rescue
    LU_RESCUE_AFTER = 8
    #: the largest problem the rescue factors (SuperLU fill ~N^1.5)
    LU_RESCUE_MAX_DOFS = 200_000
    #: the whole-run routing cap of route_petsc_direct at >= 2D (8192 =
    #: 64^2 x 2 exactly)
    PETSC_ROUTE_MAX_DOFS = 8_192
    #: the 1D routing cap for the native banded LU
    BANDED_ROUTE_MAX_DOFS = 262_144

    def __init__(
        self,
        ops,
        numerics=None,
        t0=0.0,
        dt=0.001,
        tmax=20.0,
        maxsteps=100,
        rtol=1e-5,
        atol=1e-5,
        hmin=None,
        rng_state=None,
        lastvart=None,
        block_steps=1,
        k0=0,
        mesh=None,
        kernels=None,
    ):
        """As the reference's constructor.  block_steps > 1 (fixed-dt
        runs only): that many steps per make_multistep_fn call between
        monitor calls; noise, CFL and conservation then act at block
        boundaries.  k0: the starting step counter of a resumed run."""
        if mesh is not None:
            check_mesh(ops, mesh)
        self.mesh = mesh
        self.ops = ops
        self.ps = ops.ps
        self.numerics = numerics or NumericsOptions()
        self.t0 = float(t0)
        self.dt0 = float(dt)
        self.tmax = float(tmax)
        self.maxsteps = int(maxsteps)
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.hmin = float(hmin) if hmin else self.default_hmin
        self.rng_state = rng_state
        self.lastvart = lastvart
        self.monitors = []
        self.diverged = False
        self.snes_failures = 0  # stage-solve/step rejections, for parity
        self.block_steps = int(block_steps)
        self._multi = None
        self._chunk = None
        self._fallback_fn = None
        self._lu_step = None
        self._lu_errors = 0
        self._lu_mode = False
        self._lu_accepts = 0
        self._lu_probe = 4  # LU steps cost seconds: a short park
        self._fb_mode = False
        self._fb_accepts = 0
        self._fb_probe = 64  # accepts between fast-path re-probes
        self._chunk_rej_streak = 0
        n = self.numerics
        kw = dict(atol=self.atol, rtol=self.rtol)
        if mesh is not None:
            kw.update(mesh=mesh)
        if n.ksp_type in ("banded", "lu"):
            # host exact steps (the reference's MUMPS role): no block,
            # chunk or kernels
            self.kernels = self.fused_pc = None
            self.step_fn, self.tableau = make_step_fn(ops, n, **kw)
        else:
            self.kernels = step_kernels(ops, n, mesh, kernels=kernels)
            self.fused_pc = _shared_fused_pc(ops, n, mesh)
            kw.update(kernels=self.kernels, fused_pc=self.fused_pc)
            self.step_fn, self.tableau = make_step_fn(ops, n, **kw)
            if self.block_steps > 1 and n.adapt_type == "none":
                self._multi, _ = make_multistep_fn(ops, n, **kw)
            if (n.device_loop and n.adapt_type != "none"
                    and not self._dynamics_need_host()):
                # 128 attempts per dispatch amortize the exit's host work
                self._chunk, _ = make_adaptive_chunk_fn(
                    ops, n, max_attempts=128,
                    cfl_safety=self._chunk_cfl_safety(), **kw)
        self._kw = kw
        self.build_info = dict(self.step_fn.build_info)
        self._rng = None
        # current state (exposed for monitors)
        self.k0 = int(k0)
        self.k = self.k0
        self.t = self.t0
        self.h = self.dt0
        self.u = None
        self.CFL_maxh = None
        self.last_enorm = None
        self.stats = None

    # -- monitors -------------------------------------------------------
    def add_monitor(self, monitor):
        self.monitors.append(monitor)

    def monitor(self, k, t, u):
        for m in self.monitors:
            m(self, k, t, u)

    # -- physics helpers ------------------------------------------------
    def _dev(self, x):
        """A host number as a 0-d float64 tensor on the state's device."""
        return torch.tensor(float(x), dtype=torch.float64,
                            device=self.ops.device)

    def count_worms(self, u):
        """sum(rho), over the mesh's ranks on a mesh."""
        total = torch.sum(u[0])
        if self.mesh is not None:
            total = all_reduce_sum(total, self.mesh)
        return float(total)

    def conserve_worms(self, u, Nworms):
        """Rescale rho so sum(rho) == Nworms (KSFD/ksfdts.py:248-256)."""
        correction = Nworms / self.count_worms(u)
        return torch.cat([(u[0] * correction)[None], u[1:]], dim=0)

    def is_noise_time(self, t, lastvart):
        """VTF(t) - VTF(lastvart) >= 1 (KSFD/ksfdts.py:258-266), from
        the two parameter functions it needs."""
        vrate = self.ps.funcs["variance_rate"](t)
        if not vrate or vrate <= 0.0:
            return False
        vtf = self.ps.funcs["variance_timing_function"]
        return float(vtf(t)) - float(vtf(lastvart)) >= 1.0

    @property
    def rng_state(self):
        """The noise stream's state (a uint8 tensor once it has drawn;
        before that what the constructor was given)."""
        return self._rng.get_state() if self._rng is not None \
            else self._rng_init

    @rng_state.setter
    def rng_state(self, state):
        self._rng_init = state
        self._rng = None

    def _generator(self):
        if self._rng is None:
            gen = torch.Generator(device=self.ops.device)
            init = self._rng_init
            if isinstance(init, torch.Tensor):
                gen.set_state(init)
            else:
                gen.manual_seed(0 if init is None else int(init))
            self._rng = gen
        return self._rng

    def add_variance(self, u, dt, t):
        """Geometric Brownian noise: rho *= exp(sqrt(rate*dt) * N(0,1)),
        the normal drawn on the state's device from the Solver's
        generator (KSFD/ksfdts.py:268-284).  On a mesh the normal is
        drawn at the global shape and each rank keeps its rows, as the
        reference's draw on the global array (solver.py:1394-1409): the
        field is the one-rank run's."""
        vrate = float(self.ps.funcs["variance_rate"](t))
        if not vrate or vrate <= 0.0:
            return u
        sd = math.sqrt(vrate * dt)
        shape = u[0].shape if self.mesh is None else tuple(
            int(n) for n in self.ops.grid.nps)
        stn = torch.randn(shape, generator=self._generator(),
                          dtype=u.dtype, device=u.device)
        if self.mesh is not None:
            stn = self.mesh.local(stn)
        return torch.cat([(u[0] * torch.exp(sd * stn))[None], u[1:]], dim=0)

    def CFL_step(self, u, t):
        """The largest stable h by the worm-velocity CFL
        (KSFD/ksfdts.py:302-319): min over axes of spacing*sw/max|v|,
        the maxima over the mesh's ranks on a mesh."""
        if self.mesh is None:
            vs = self.ops.velocity(u, self._dev(t))
        else:
            vs = self.ops.velocity(u, self._dev(t), mesh=self.mesh)
        vmax = torch.stack([v.abs().max() for v in vs])
        if self.mesh is not None:
            vmax = all_reduce_max(vmax, self.mesh)
        vmaxs = vmax.tolist()
        sw = self.ops.grid.stencil_width
        return float(min(
            math.inf if v == 0.0 else s * sw / v
            for v, s in zip(vmaxs, self.ops.grid.spacing)))

    def _post_accept(self, u, k, t, h, conserve, Nworms):
        """The post-accept sequence of the step path and the chunk's
        exit, in the reference's order: noise, conserve, groom, with-G
        states' refresh_G, CFL clamp, monitor.  Returns (u, h), h possibly
        CFL-clamped."""
        if self.is_noise_time(t, self.lastvart):
            u = self.add_variance(u, t - self.lastvart, t)
            if conserve:
                u = self.conserve_worms(u, Nworms)
            self.lastvart = t
            self.stats.injections += 1
        u = self._groom(u, t)
        self.u, self.k, self.t, self.h = u, k, t, h
        self.CFL_check(u, t)
        self.monitor(k, t, u)
        return u, self.h

    def _groom(self, u, t):
        """groom, then (a with-G state's operators) refresh_G: the G
        slot from the groomed fields at t."""
        u = self.ops.groom(u)
        if hasattr(self.ops, "refresh_G"):
            u = self.ops.refresh_G(u, t)
        return u

    def CFL_check(self, u, t):
        self.CFL_maxh = self.CFL_step(u, t)
        safety = float(self.ps.funcs["CFL_safety_factor"](t))
        if safety > 0.0:
            maxh = safety * self.CFL_maxh
            if self.h > maxh:
                logTS("CFL step exceeded, truncating to", maxh)
                self.h = maxh

    def _dynamics_need_host(self):
        """Only a time-dependent CFL safety factor forces the per-step
        loop: a constant one clamps inside the chunk, and noise bounds
        each chunk at the next injection time."""
        return "CFL_safety_factor" in self.ps.tdfuncs

    def _chunk_cfl_safety(self):
        return chunk_cfl_safety(self.ps)

    def _noise_active(self):
        return noise_active(self.ps)

    def _next_noise_time(self, lastvart, tmax):
        """next_noise_time memoized on (lastvart, tmax): the chunk asks
        before every dispatch, the answer changes at injections."""
        key = (float(lastvart), float(tmax))
        cached = getattr(self, "_nnt_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        tn = next_noise_time(self.ps, lastvart, tmax)
        self._nnt_cache = (key, tn)
        return tn

    def _get_fallback(self):
        """The robust retry step: float64 GMRES stage solves
        (``gmres_scipy``, restart 12, 4 restarts, stage RHS from the
        float64 RHS), as the reference builds it (solver.py:1476-1535),
        with at least 4 modified-Newton iterations per DIRK stage (a
        retry at the one iteration of -snes_type ksponly would mostly
        re-fail; rosw ignores them); None unless the fast solver is
        Richardson."""
        if self.numerics.ksp_type not in ("richardson",):
            return None
        if self._fallback_fn is None:
            nm = dataclasses.replace(
                self.numerics, ksp_type="gmres_scipy",
                ksp_restart=12, ksp_max_it=4, stage_delta=False,
                snes_iters=max(4, self.numerics.snes_iters),
            )
            self._fallback_fn, _ = make_step_fn(self.ops, nm, **self._kw)
        return self._fallback_fn

    def _get_exact_step(self):
        """The last-resort exact sparse-LU step (the reference's MUMPS
        role) after LU_RESCUE_AFTER consecutive failures, or None:
        already an exact ksp_type, a DIRK tableau (the exact steps are
        Rosenbrock-only, solver.py:1558), over LU_RESCUE_MAX_DOFS, or
        disabled by two errors this run."""
        if self.numerics.ksp_type in EXACT_KSP:
            return None
        if isinstance(self.tableau, DIRKTableau):
            return None
        if self.ops.grid.n_dofs > self.LU_RESCUE_MAX_DOFS:
            return None
        if self._lu_errors >= 2:
            return None
        if self._lu_step is None:
            from .direct import make_sparse_step

            self._lu_step = make_sparse_step(
                self.ops, self.tableau, atol=self.atol, rtol=self.rtol)
            if self.mesh is not None:
                self._lu_step = replicated_step(self._lu_step, self.mesh)
        return self._lu_step

    def _try_exact(self, u, t, h):
        """One exact-LU step, exception-guarded: a failure degrades to
        the ordinary reject-and-shrink path; two disable the tier for
        the run.  Returns (u1, enorm) or None."""
        exact = self._get_exact_step()
        if exact is None:
            return None
        try:
            u1, enorm = exact(u, t, h)
            self.stats.exact_steps += 1
            return u1, float(enorm)
        except Exception as exc:
            self._lu_errors += 1
            logTS("exact LU step failed (%s): %s" % (
                type(exc).__name__,
                "tier disabled for this run" if self._lu_errors >= 2
                else "will retry once"))
            return None

    # -- adaptive control ------------------------------------------------
    def _new_h_accept(self, h, enorm):
        n = self.numerics
        expo = -1.0 / (self.tableau.order + 1)
        if enorm <= 0.0:
            hfac = n.clip_high
        else:
            hfac = n.safety * float(enorm) ** expo
        hfac = min(max(hfac, n.clip_low), n.clip_high)
        return min(max(h * hfac, n.dt_min), n.dt_max)

    def _new_h_reject(self, h, enorm, finite):
        n = self.numerics
        if not finite:
            hfac = n.rollback_factor
        else:
            expo = -1.0 / (self.tableau.order + 1)
            hfac = n.safety * float(enorm) ** expo
            hfac = min(max(hfac, n.clip_low), 0.9)
        return max(h * hfac, n.dt_min)

    # -- the loop ---------------------------------------------------------
    def _chunk_iteration(self, u, k, t, h, tmax_eff, conserve, Nworms,
                         failures):
        """One dispatch of the adaptive chunk and what follows its exit
        (solver.py:1734-1849).  Returns (u, k, t, h, failures, stop):
        ``stop`` when the run diverged."""
        n = self.numerics
        st = self.stats
        u1, tnew, hnew, kacc, attempts, rej = self._chunk(
            u, t, h, tmax_eff, self.maxsteps - k)
        kacc, attempts, rej = int(kacc), int(attempts), bool(rej)
        cs = self._chunk.stats
        st.dispatches += 1
        st.chunk_attempts += attempts
        st.chunk_accepts += kacc
        st.tier_calls = [a + b for a, b in zip(st.tier_calls, cs.per_tier)]
        # on-device rejections are solve failures for parity accounting
        st.chunk_rejections += max(0, attempts - kacc)
        self.snes_failures += max(0, attempts - kacc)
        if n.monitor:
            print("  TSAdapt chunk: %d accepted / %d attempts, h %.3g -> "
                  "%.3g%s" % (kacc, attempts, h, float(hnew),
                              " (rejected; host retry)" if rej else ""),
                  flush=True)
        h = float(hnew)
        if kacc > 0:
            failures = 0
            k += kacc
            t = float(tnew)
            self.last_enorm = None
            u, h = self._post_accept(u1, k, t, h, conserve, Nworms)
        if not rej:
            self._chunk_rej_streak = 0
            return u, k, t, h, failures, False
        # the chunk is stuck at this h: retry on the host through the
        # robust fallback, with a probe that doubles on every immediate
        # re-rejection, so a marginal stiff phase settles on it
        self._chunk_rej_streak = (self._chunk_rej_streak + 1 if kacc == 0
                                  else 0)
        if self._get_fallback() is None:
            # no robust fallback for this ksp_type: count the stuck chunk
            # as a failed step, then the exact-LU retry at the same h or
            # a shrunk h
            self.snes_failures += 1
            failures += 1
            if failures > n.max_snes_failures:
                self.diverged = True
                return u, k, t, h, failures, True
            if (failures >= self.LU_RESCUE_AFTER
                    and self._get_exact_step() is not None):
                self._lu_mode = True
                self._lu_accepts = 0
                self._lu_probe = 1
                print("ksfd: fused chunk rejected at t=%.6g; exact LU retry "
                      "engaged (h=%.3g)" % (t, h), flush=True)
                return u, k, t, h, failures, False
            h = self._new_h_reject(h, math.nan, False)
            logTS("chunk rejected; no fallback, h ->", h)
            return u, k, t, h, failures, False
        self._fb_mode = True
        self._fb_accepts = 0
        self._fb_probe = min(64, 1 << self._chunk_rej_streak)
        st.host_retries += 1
        print("ksfd: fused chunk rejected at t=%.6g; robust host retry "
              "engaged (h=%.3g, probe=%d)" % (t, h, self._fb_probe),
              flush=True)
        return u, k, t, h, failures, False

    def solve(self, u0, t=None):
        """Run the timestepper from u0 (an array or tensor; it moves to
        ``ops.device``).  Returns the final state tensor.  On a mesh u0
        and the result are this rank's slab.

        ``self.stats`` counts the run: ``dispatches`` of the chunk, its
        ``chunk_attempts`` (one host read each), ``chunk_accepts``,
        ``chunk_rejections`` and ``tier_calls`` per tier; the host
        loop's ``step_attempts`` (one host read each, block calls
        included), ``fallback_steps``, ``exact_steps``,
        ``host_retries`` (a stuck chunk or a rejected step handed to
        the fallback), ``exact_rescues`` (accepts of the exact tier
        after LU_RESCUE_AFTER failures) and ``injections``."""
        n = self.numerics
        adapt = n.adapt_type != "none"
        u = torch.as_tensor(u0, device=self.ops.device)
        self.t = self.t0 if t is None else float(t)
        self.h = min(max(self.dt0, n.dt_min), n.dt_max)
        self.k = self.k0
        self.diverged = False
        # the fallback and rescue state is per run; lastvart persists
        # (resume flows assign it between __init__ and solve)
        self._fb_mode = False
        self._fb_accepts = 0
        self._fb_probe = 64
        self._chunk_rej_streak = 0
        self._lu_mode = False
        self._lu_accepts = 0
        self._lu_probe = 4
        self._lu_errors = 0
        ntiers = len(self._chunk.tiers) if self._chunk is not None else 0
        self.stats = SimpleNamespace(
            dispatches=0, chunk_attempts=0, chunk_accepts=0,
            chunk_rejections=0, tier_calls=[0] * ntiers, step_attempts=0,
            fallback_steps=0, exact_steps=0, host_retries=0,
            exact_rescues=0, injections=0)
        st = self.stats
        k, t, h = self.k, self.t, self.h
        u = self._groom(u, t)
        self.u = u
        Nworms = self.count_worms(u)
        if self.lastvart is None:
            if "lastvart" in self.ps.params0:
                self.lastvart = float(self.ps.params0["lastvart"])
            else:
                self.lastvart = t
        cw = self.ps.params0["conserve_worms"]
        conserve = False if cw == "False" else bool(cw)
        self.CFL_check(u, t)
        self.monitor(k, t, u)
        failures = 0
        while (not self.diverged and k < self.maxsteps and t <= self.tmax
               and h >= self.hmin):
            self.k, self.t, self.h = k, t, h
            # noise bounds the chunk: it exits at the next injection
            # time, so the host injects at the same accepted step as
            # the per-step loop would
            tmax_eff = self.tmax
            if self._chunk is not None and self._noise_active():
                tn = self._next_noise_time(self.lastvart, self.tmax)
                if tn is not None and tn < tmax_eff:
                    tmax_eff = tn
            if (self._chunk is not None and not self._fb_mode
                    and not self._lu_mode and t <= tmax_eff):
                u, k, t, h, failures, stop = self._chunk_iteration(
                    u, k, t, h, tmax_eff, conserve, Nworms, failures)
                if stop:
                    break
                continue
            nblk = 1
            st.step_attempts += 1
            if self._multi is not None:
                nblk = max(1, min(self.block_steps, self.maxsteps - k))
                u1, _, enorm = self._multi(u, self._dev(t), self._dev(h),
                                           nblk)
            elif self._lu_mode:
                res = self._try_exact(u, t, h)
                if res is None:
                    # the tier was just disabled mid-park
                    self._lu_mode = False
                    u1, enorm = self.step_fn(u, self._dev(t), self._dev(h))
                else:
                    u1, enorm = res
            elif self._fb_mode:
                st.fallback_steps += 1
                u1, enorm = self._get_fallback()(u, self._dev(t),
                                                 self._dev(h))
            else:
                u1, enorm = self.step_fn(u, self._dev(t), self._dev(h))
            enorm = float(enorm)
            finite = math.isfinite(enorm)
            logTS("step attempt k,t,h,enorm", k, t, h, enorm)
            rejected = (adapt and (not finite or enorm > 1.0)) or (
                not adapt and not finite)
            if (rejected and not self._fb_mode and self._multi is None
                    and self._get_fallback() is not None):
                # retry the same h on the robust solver before shrinking
                st.fallback_steps += 1
                u1b, enormb = self._get_fallback()(u, self._dev(t),
                                                   self._dev(h))
                enormb = float(enormb)
                if math.isfinite(enormb) and (not adapt or enormb <= 1.0):
                    u1, enorm, finite, rejected = u1b, enormb, True, False
                    self._fb_mode = True
                    self._fb_accepts = 0
                    self._fb_probe = 64
                    st.host_retries += 1
                    logTS("fallback solver engaged at h", h)
            if (rejected and nblk == 1 and not self._lu_mode
                    and failures + 1 >= self.LU_RESCUE_AFTER):
                # the iterative tiers failed LU_RESCUE_AFTER times in a
                # row: the exact sparse-LU step at the same h
                res = self._try_exact(u, t, h)
                if res is not None:
                    u1x, enormx = res
                    if math.isfinite(enormx) and (not adapt
                                                  or enormx <= 1.0):
                        u1, enorm, finite, rejected = (u1x, enormx, True,
                                                       False)
                        # park on the exact tier briefly (it costs
                        # seconds a step)
                        self._lu_mode = True
                        self._lu_accepts = 0
                        self._lu_probe = 4
                        self._fb_mode = False
                        st.exact_rescues += 1
                        logTS("exact LU rescue accepted at h", h)
            if rejected:
                self.snes_failures += 1
                failures += 1
                if failures > n.max_snes_failures:
                    self.diverged = True
                    break
                hnew = self._new_h_reject(h, enorm, finite)
                if n.monitor:  # -ts_adapt_monitor analog
                    print("  TSAdapt %s step %d REJECTED t=%.6g enorm=%.3g "
                          "h %.3g -> %.3g" % (n.adapt_type, k, t, enorm, h,
                                              hnew), flush=True)
                h = hnew
                if self._fb_mode and self._fb_probe == 1:
                    # a one-shot chunk retry failed too: hand the shrunk
                    # h back to the chunk
                    self._fb_mode = False
                if self._lu_mode and self._lu_probe == 1:
                    self._lu_mode = False
                continue
            failures = 0
            if self._lu_mode:
                self._lu_accepts += 1
                if self._lu_accepts >= self._lu_probe:
                    self._lu_mode = False  # probe the iterative path
            elif self._fb_mode:
                self._fb_accepts += 1
                if self._fb_accepts % self._fb_probe == 0:
                    self._fb_mode = False  # probe the fast path again
            k += nblk
            t = t + nblk * h
            self.last_enorm = enorm
            u = u1
            hprev = h
            if adapt and finite:
                h = self._new_h_accept(h, enorm)
            elif not adapt:
                # fixed dt: restore the nominal dt after a retry shrank h
                h = min(max(self.dt0, n.dt_min), n.dt_max)
            if n.monitor:  # -ts_adapt_monitor analog
                print("  TSAdapt %s step %d accepted t=%.6g enorm=%.3g "
                      "h %.3g -> %.3g" % (n.adapt_type, k, t, enorm, hprev,
                                          h), flush=True)
            u, h = self._post_accept(u, k, t, h, conserve, Nworms)
        self.u, self.k, self.t, self.h = u, k, t, h
        return u


# ---------------------------------------------------------------------
# standard monitors (reference: KSFD/ksfdts.py:337-497)
# ---------------------------------------------------------------------

def print_monitor(solver, k, t, u):
    """A status line per accepted step on stdout.  Counterpart:
    ksfd_tpu/solvers/solver.py:print_monitor."""
    h = solver.h
    clock = datetime.now().strftime("%H:%M:%S")
    if getattr(solver, "_lastt", None) is not None:
        out = "clock: %s, step %3d t=%8.3g dt=%8.3g h=%8.3g" % (
            clock, k, t, t - solver._lastt, h)
    else:
        out = "clock: %s, step %3d t=%8.3g h=%8.3g" % (clock, k, t, h)
    if solver.CFL_maxh is not None:
        out += " CFL=%8.3g" % (solver.CFL_maxh,)
    print(out, flush=True)
    solver._lastt = t


def history_monitor(solver, k, t, u):
    """Append (step, h, t, a host copy of u) to ``solver.history``.
    Counterpart: ksfd_tpu/solvers/solver.py:history_monitor."""
    if not hasattr(solver, "history"):
        solver.history = []
    solver.history.append(dict(step=k, h=solver.h, t=t,
                               u=u.detach().cpu().numpy().copy()))
