"""The port's unfused step and 1D problems against ksfd_tpu on the CPU.

Where ``use_pallas`` is off or the kernel gate refuses the problem (a 1D
grid, a 3D extent under ``2*sw+1``) the port takes the unfused step, as the reference takes its XLA path
(ksfd_tpu/solvers/solver.py:296-335, :391-424): the mixed path with W
from the float32 RHS linearized once per step, float64 sweeps on the
float64 linearization, and the fast mode's XLA-f32 RHS.  On the CPU the
reference runs that XLA path for every problem (its Pallas kernels need
a TPU or interpret mode), so each case feeds the same seeded numpy
state through both packages: the 1D manufactured problem
(tests/manufactured.py) at nx=64, the 2D bench problem at 32^2 and the
3D aggregation problem at 8 x 4 x 8.  Two cases keep the kernels
(their plain versions on the CPU) and drop only the delta kernel, as the
reference does: ``-stage_delta 0`` and a time-dependent coefficient
(tests/test_torch_tdep.py holds those kernels themselves).

Tolerances, for one step and a chain of 5:

- float64 sweeps: 1e-12 of max|u|;
- float32 sweeps: 1e-5 of the increment max|u1 - u0| (the sweeps round
  apart in the last float32 bits, PyTorch against XLA);
- the fast mode: ``1e-4 * max|u1 - u0| + 4 * 2^-23 * max|u0|``, its
  state being float32 (tests/test_torch_fast32.py).  It is held on the
  rough 2D state only: on the near-uniform 1D manufactured state (9000
  +- 1) the float32 RHS is made of rounding (docs/PERF.md:36 records
  the XLA-f32 RHS as unstable), and the two packages' steps differ by
  most of their increment there.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from helpers import make_clargs
from ksfd_tpu import Grid as JGrid
from ksfd_tpu import SolutionParameters as JParams
from ksfd_tpu.ops import PDEOperators as JOps
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers.solver import BUILD_INFO
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_stencil import (
    kernel_refusal,
    kernels_available,
    make_fused_kernels,
)
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    make_adaptive_chunk_fn,
    make_multistep_fn,
    make_step_fn,
)
from ksfd_tpu_torch.ops import PDEOperators
from ksfd_tpu_torch.solvers import linalg as tlinalg
from manufactured import exact_state, make_problem, rho_source_expr
from test_torch_3d import aggregation3d_params

N2 = 32
NX1 = 64
SHAPE3 = (8, 4, 8)
EPS32 = 2.0 ** -23
F64_REL = 1e-12
F32_INC = 1e-5
ATOL = 0.01


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


def port_1d(jps, nx):
    """The port's manufactured problem (ps, grid, ops) beside the
    reference's: its operators with the rho source."""
    ps, grid, _ = problem_from_clargs(jps.clargs, nx, device="cpu")
    return ps, grid, PDEOperators(ps, grid, device="cpu",
                                  sources=[rho_source_expr(jps), 0.0, 0.0])


def rough_2d(seed=0, scale=1000.0, n=N2):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal((n, n))),
        6000 + scale * np.abs(rng.standard_normal((n, n))),
        6000 + 0.5 * scale * np.abs(rng.standard_normal((n, n))),
    ])


def wave_3d(shape=SHAPE3):
    X, Y, Z = np.meshgrid(*[np.arange(n) / n for n in shape], indexing="ij")
    w = np.sin(2 * np.pi * (X + 2 * Y + Z))
    return np.stack([9000 + 50 * w, 6162 + 30 * w, 797 + 5 * w])


def tdep_clargs(n=N2):
    """The bench problem with one time-dependent ligand decay."""
    jps, _, _ = ge._make_problem(n, n)
    clargs = jps.clargs
    clargs.params = [p for p in clargs.params
                     if not p.startswith("gamma_1_1=")] + [
        "gamma_1_1=0.01*(1 + t)"]
    return clargs


@pytest.fixture(scope="module")
def problems():
    """(reference ops, port ops, state, h) by problem name."""
    out = {}
    jps, jgrid, jops = make_problem(nx=NX1)
    _, _, tops = port_1d(jps, NX1)
    out["1d"] = (jops, tops, np.asarray(exact_state(jps, jgrid, 0.0)), 1.0)
    jps, _, jops = ge._make_problem(N2, N2)
    _, _, tops = problem_from_clargs(jps.clargs, N2, N2, device="cpu")
    u0 = np.array(jops.groom(jnp.asarray(rough_2d())))
    out["2d"] = (jops, tops, u0, 1e-3)
    clargs = tdep_clargs()
    jps = JParams(clargs)
    jgrid = JGrid(dim=2, width=1.0, height=1.0, nx=N2, ny=N2,
                  dof=jps.nligands + 1, order=jps.degree)
    jops = JOps(jps, jgrid)
    _, _, tops = problem_from_clargs(clargs, N2, N2, device="cpu")
    out["2d-tdep"] = (jops, tops, u0, 1e-3)
    clargs = make_clargs(params=aggregation3d_params(8))
    jps = JParams(clargs)
    jgrid = JGrid(dim=3, width=jps.width, height=jps.height,
                  depth=jps.depth, nx=SHAPE3[0], ny=SHAPE3[1],
                  nz=SHAPE3[2], dof=jps.nligands + 1, order=jps.degree)
    jops = JOps(jps, jgrid)
    _, _, tops = problem_from_clargs(clargs, *SHAPE3, device="cpu")
    out["3d-small"] = (jops, tops, wave_3d(), 1.0)
    return out


#: (problem, numerics changes, tolerance kind)
CASES = {
    "1d-f64-sweeps": ("1d", dict(sweep_dtype="float64"), "f64"),
    "1d-f32-sweeps": ("1d", dict(), "f32"),
    "2d-nopallas-f64-sweeps": ("2d", dict(use_pallas=False,
                                          sweep_dtype="float64"), "f64"),
    "2d-nopallas-f32-sweeps": ("2d", dict(use_pallas=False), "f32"),
    "2d-nopallas-chebyshev": ("2d", dict(use_pallas=False,
                                         ksp_type="chebyshev"), "f32"),
    "2d-stage-delta-0": ("2d", dict(stage_delta=False), "f32"),
    "2d-nopallas-fast32": ("2d", dict(use_pallas=False,
                                      precision="float32"), "fast32"),
    "2d-tdep-coefficient": ("2d-tdep", dict(), "f32"),
    "3d-small-extent": ("3d-small", dict(), "f32"),
    "3d-small-extent-f64-sweeps": ("3d-small", dict(sweep_dtype="float64"),
                                   "f64"),
}

_REF = {}


def reference_chain(problems, case, nsteps=5):
    """The reference's states after 1..nsteps steps (its jitted step
    applied in turn) and their enorms, cached per case."""
    if case not in _REF:
        name, change, _ = CASES[case]
        jops, _, u0, h = problems[name]
        numerics = dataclasses.replace(KJ.NumericsOptions(), **change)
        step, _ = jstep(jops, numerics, atol=ATOL, rtol=1e-6)
        u, t, out = jnp.asarray(u0), 0.0, []
        for _ in range(nsteps):
            u, e = step(u, t, h)
            t += h
            out.append((np.asarray(u), float(e)))
        _REF[case] = out
    return _REF[case]


def assert_close(u, ref, u0, kind):
    """u within the kind's bound of ref; returns the bound."""
    dev = float(np.abs(np.asarray(u, dtype=np.float64) - ref).max())
    inc = float(np.abs(ref - u0).max())
    if kind == "f64":
        bound = F64_REL * float(np.abs(ref).max())
    elif kind == "f32":
        bound = F32_INC * inc
    else:
        bound = 1e-4 * inc + 4 * EPS32 * float(np.abs(u0).max())
    assert dev <= bound, (dev, bound, inc)
    return bound


def assert_enorm_close(e, e_ref, bound):
    """The embedded error norms agree to 1e-6 relative plus what a
    state deviation of ``bound`` can move them: the norm weighs the
    embedded difference by at most 1/atol, and that difference is a
    cancelling sum far below the increment, so float32 sweeps move a
    small norm by a large share of itself."""
    assert abs(e - e_ref) <= 1e-6 * e_ref + bound / ATOL, (e, e_ref)


@pytest.mark.parametrize("nsteps", [1, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_unfused_step_matches_reference(problems, case, nsteps):
    """One step and a chain of 5 (the port's multistep) against the
    reference's step applied in turn, from the same numpy state."""
    name, change, kind = CASES[case]
    _, tops, u0, h = problems[name]
    ref = reference_chain(problems, case)
    numerics = dataclasses.replace(NumericsOptions(), **change)
    multi, _ = make_multistep_fn(tops, numerics, atol=ATOL, rtol=1e-6)
    u, t, emax = multi(torch.from_numpy(u0), scalar(0.0), scalar(h), nsteps)
    bound = assert_close(u, ref[nsteps - 1][0], u0, kind)
    assert abs(float(t) - nsteps * h) <= 1e-6 * nsteps * h
    assert_enorm_close(float(emax), max(e for _, e in ref[:nsteps]), bound)


@pytest.mark.parametrize("case", ["1d-f64-sweeps", "1d-f32-sweeps",
                                  "2d-nopallas-f32-sweeps",
                                  "3d-small-extent"])
def test_unfused_path_launches_nothing(problems, case):
    """The unfused step launches no kernel: its build has none, and a
    kernel namespace passed in stays untouched where one exists."""
    name, change, _ = CASES[case]
    _, tops, u0, h = problems[name]
    numerics = dataclasses.replace(NumericsOptions(), **change)
    kern = (make_fused_kernels(tops)
            if kernels_available(tops.grid, tops) else None)
    step, _ = make_step_fn(tops, numerics, atol=ATOL, rtol=1e-6,
                           kernels=kern)
    calls = []
    if kern is not None:
        for k in kern.kernels.values():
            k._body = (lambda body: lambda *a: calls.append(1) or body(*a))(
                k._body)
    u1, e = step(torch.from_numpy(u0), scalar(0.0), scalar(h))
    assert calls == [] and bool(torch.isfinite(e))
    info = step.build_info
    assert info["kernels"] is None and info["pallas_resid"] is False


BUILD_CASES = {
    "default": dict(),
    "stage-delta-0": dict(stage_delta=False),
    "f64-sweeps": dict(sweep_dtype="float64"),
    "nopallas": dict(use_pallas=False),
    "fast32": dict(precision="float32"),
    "fast32-nopallas": dict(precision="float32", use_pallas=False),
    "fallback": dict(ksp_type="gmres_scipy", stage_delta=False,
                     ksp_restart=12, ksp_max_it=4),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_info_matches_reference(problems, case, monkeypatch):
    """The step kind's flags (mixed32, pallas_rhs/_jvp/_resid/_delta)
    are the reference's BUILD_INFO where its kernels run (interpret
    mode on the 2D problem), and all off in 1D."""
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")
    keys = ("mixed32", "pallas_rhs", "pallas_jvp", "pallas_resid",
            "pallas_delta", "fast32")
    for name in ("2d", "1d"):
        jops, tops, _, _ = problems[name]
        change = BUILD_CASES[case]
        jstep(jops, dataclasses.replace(KJ.NumericsOptions(), **change))
        want = {k: bool(BUILD_INFO[k]) for k in keys}
        step, _ = make_step_fn(
            tops, dataclasses.replace(NumericsOptions(), **change))
        assert {k: step.build_info[k] for k in keys} == want, name


def test_kernel_gate(problems):
    """The gate refuses where the reference's pallas_available and
    pallas3d_available refuse for reasons other than the TPU (1D, a 3D
    extent under 2*sw+1, with-G, the flux form), and admits
    time-dependent coefficients as they do; make_fused_kernels keeps
    raising off the gate."""
    for name in ("2d", "2d-tdep"):
        _, ops2, _, _ = problems[name]
        assert kernels_available(ops2.grid, ops2)
        assert kernel_refusal(ops2.grid, ops2) is None
    for name, why in (("1d", "1D grid"), ("3d-small", "2*sw+1")):
        _, ops, _, _ = problems[name]
        assert why in kernel_refusal(ops.grid, ops)
        with pytest.raises(ValueError, match="unfused"):
            make_fused_kernels(ops)
    flux = copy.copy(ops2)
    flux.flux_form = True
    assert kernel_refusal(flux.grid, flux) == "the flux form"
    with_g = copy.copy(ops2)
    with_g.nligands = ops2.nligands + 1
    assert "with-G" in kernel_refusal(with_g.grid, with_g)


def floor_state(u0, ops):
    """u0 with a few points at, and a few below, the groom floors."""
    u = np.array(u0)
    u[0].reshape(-1)[::7] = ops.rhomin
    u[0].reshape(-1)[3::11] = ops.rhomin - 1.0
    u[1].reshape(-1)[::5] = ops.Umin
    return u


@pytest.mark.parametrize("name", ["1d", "2d", "3d-small"])
def test_linearization_matches_jax_linearize(problems, name):
    """PDEOperators.linearize's RHS and J-action against the
    reference's jax.linearize of its RHS, on a state with points at and
    below the groom floors (the clamp's slope: 1/2 at a tie, 0 below);
    and above the floors against forward-mode AD of the port's RHS
    (torch.func.jvp and torch.func.linearize)."""
    jops, tops, u0, _ = problems[name]
    u = floor_state(u0, tops)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(u.shape) * np.abs(u0).max() * 1e-3
    t = 0.5
    f_ref, jvp_ref = jax.linearize(lambda uu: jops.rhs(uu, t),
                                   jnp.asarray(u))
    jv_ref = np.asarray(jvp_ref(jnp.asarray(v)))
    f0, jvp = tops.linearize(torch.from_numpy(u), scalar(t))
    jv = jvp(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(f0.numpy(), np.asarray(f_ref),
                               rtol=0, atol=1e-12 * np.abs(f_ref).max())
    np.testing.assert_allclose(jv, jv_ref, rtol=0,
                               atol=1e-12 * np.abs(jv_ref).max())
    uu = torch.from_numpy(u0)
    vv = torch.from_numpy(v)

    def fn(x):
        return tops.rhs(x, scalar(t))

    jv = tops.linearize(uu, scalar(t))[1](vv)
    scale = float(jv.abs().max())
    for other in (torch.func.jvp(fn, (uu,), (vv,))[1],
                  torch.func.linearize(fn, uu)[1](vv)):
        assert float((other - jv).abs().max()) <= 1e-12 * scale


def test_gmres_fallback_step_matches_reference(problems):
    """The robust retry step (gmres_scipy, -stage_delta 0, the
    ensemble's fallback numerics) with its J from the once-per-step
    linearization, in 1D and 2D, against the reference's."""
    change = BUILD_CASES["fallback"]
    for name in ("1d", "2d"):
        jops, tops, u0, h = problems[name]
        jn = dataclasses.replace(KJ.NumericsOptions(), **change)
        ref_u, ref_e = jstep(jops, jn, atol=ATOL, rtol=1e-6)[0](
            jnp.asarray(u0), 0.0, h)
        step, _ = make_step_fn(
            tops, dataclasses.replace(NumericsOptions(), **change),
            atol=ATOL, rtol=1e-6)
        u1, e = step(torch.from_numpy(u0), scalar(0.0), scalar(h))
        bound = assert_close(u1, np.asarray(ref_u), u0, "f32")
        assert_enorm_close(float(e), float(ref_e), bound)


def test_1d_preconditioner_matches_reference(problems):
    """The 1D block pc's basis (v Qx, c Qx^T) and apply against the
    reference's einsums."""
    from ksfd_tpu.solvers import linalg as jlinalg

    jops, tops, u0, _ = problems["1d"]
    jpc = jlinalg.BlockSpectralPreconditioner(jops.grid, jops,
                                              compute_dtype="float64",
                                              use_fft=False)
    tpc = tlinalg.BlockSpectralPreconditioner(tops.grid, tops,
                                              compute_dtype="float64",
                                              device="cpu")
    v = np.random.default_rng(2).standard_normal(u0.shape)
    means = [float(np.mean(u0[i])) for i in range(3)]
    ref = np.asarray(jpc.apply_linearized(jnp.asarray(v), 2.0, 0.0, means))
    out = tpc.apply_linearized(torch.from_numpy(v), scalar(2.0),
                               scalar(0.0), [scalar(m) for m in means])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_1d_adaptive_chunk_and_ensemble_run(problems):
    """The adaptive chunk and the per-step ensemble run in 1D on the
    unfused step: the ensemble's members follow their own chunks'
    accepted-step counts from one start."""
    _, tops, u0, _ = problems["1d"]
    nm = NumericsOptions(sweep_dtype="float64")
    chunk, _ = make_adaptive_chunk_fn(tops, nm, atol=ATOL, rtol=1e-6)
    u, t, h, k, attempts, rejected = chunk(torch.from_numpy(u0), 0.0, 1.0,
                                           1e9, 8)
    assert k == 8 and not rejected and bool(torch.isfinite(u).all())
    es = EnsembleSolver(tops, NumericsOptions(sweep_dtype="float64",
                                              adapt_type="none"),
                        t0=0.0, dt=1.0, tmax=1e9, maxsteps=3, rtol=1e-6,
                        atol=ATOL, block_steps=3)
    out = es.solve(np.stack([u0, u0 * (1.0 + 1e-3)]))
    assert (out.k == 3).all() and not out.diverged.any()
    assert es.kernels is None and es.build_info["kernels"] is None
