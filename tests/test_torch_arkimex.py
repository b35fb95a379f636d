"""The port's DIRK path (ARK324, ARK436) against ksfd_tpu on the CPU.

``-ts_type arkimex`` (``-ts_arkimex_type 4``, ``-snes_type ksponly``)
selects the ESDIRK implicit part of PETSc's ARKIMEX schemes, which the
step runs by modified Newton with the held W (solvers/solver.py
``_combine_dirk``, the reference's solver.py:643-688).  Held here:

- the counterparts of the reference's tests/test_arkimex.py, on the
  port: the trajectory against rosw, order 3 and 4 in time, ksponly's
  one Newton iteration, decoding, an adaptive run, the order
  conditions and the banded refusal;
- one ARK324 and one ARK436 step and a 4-step chained multistep on the
  2D options84 problem at 32^2 x 3 against the reference (its Pallas
  kernels in interpret mode, the port's plain versions), states within
  1e-5 of the increment and enorm within 1e-2 relative, as
  tests/test_torch_solver.py holds the Rosenbrock step; the fast mode
  within ``1e-4 * increment + 4 * 2^-23 * max|u0|``
  (tests/test_torch_fast32.py); the dense tier on the 1D manufactured
  problem within 1e-12 relative;
- the launches per step (ARK324 12 resid and 9 delta, ARK436 20 and
  15, ksponly 6 and 6, the chain one delta more; the fast mode 10 rhs
  and 12 jvp), and that the mixed path's stage right-hand sides are
  float64;
- the Solver's adaptive runs (per step and on the device loop) against
  the reference's Solver, the GMRES fallback's ``snes_iters`` of at
  least 4, the exact-LU rescue and ``route_petsc_direct`` leaving DIRK
  alone, the ensemble's device loop against per-member chunks;
- the options92 arkimex gate through ``python -m ksfd_tpu_torch``
  (tests/test_gates.py:80's bounds), marked slow as the reference's
  is: it takes minutes on the CPU (and on the card,
  tools/arkimex_gate.py); its first 12 steps through that tool, as
  chip_smoke.py phase 32 (d) runs them on the card.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import make_multistep_fn as jmultistep
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers import route_petsc_direct as jroute
from ksfd_tpu_torch import Grid, NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    Solver,
    get_tableau,
    make_adaptive_chunk_fn,
    make_multistep_fn,
    make_step_fn,
)
from ksfd_tpu_torch.solvers import solver as tsolver
from ksfd_tpu_torch.solvers.solver import route_petsc_direct
from ksfd_tpu_torch.tools import validate
from ksfd_tpu_torch.utils.cli import decode_numerics
from manufactured import make_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
H = 1e-3
EPS32 = 2.0 ** -23
ATOL, RTOL = 0.01, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


# -- the 1D manufactured problem (tests/manufactured.py) -------------------

_1D = {}


def problem_1d(nx):
    """(port ops, exact start) of the manufactured problem, cached."""
    if nx not in _1D:
        _, grid, ops = validate.make_problem(nx=nx, device="cpu")
        _1D[nx] = (ops, validate.exact_state(grid, 0.0))
    return _1D[nx]


_FIXED = {}


def run_fixed(nx, ts_type, dt, nsteps, **kw):
    """tests/test_arkimex.py:_run_fixed on the port, cached: a fixed-dt
    Solver run with 16 sweeps per stage solve (``kw`` may replace the
    stage solver)."""
    key = (nx, ts_type, dt, nsteps, tuple(sorted(kw.items())))
    if key not in _FIXED:
        ops, u0 = problem_1d(nx)
        numerics = NumericsOptions(**dict(dict(
            ts_type=ts_type, adapt_type="none", ksp_iters=16), **kw))
        s = Solver(ops, numerics, t0=0.0, dt=dt, tmax=1e18, maxsteps=nsteps,
                   rtol=1e-6, atol=0.01)
        _FIXED[key] = (s.solve(u0).numpy(), s)
    return _FIXED[key]


def exact(nx, t):
    ops, _ = problem_1d(nx)
    return validate.exact_state(ops.grid, t)


def test_arkimex_matches_rosw_trajectory():
    """tests/test_arkimex.py:33: the two order-3 methods agree far below
    the discretization error on the same trajectory."""
    u_rosw, s1 = run_fixed(64, "rosw", 1.0, 20)
    u_ark, s2 = run_fixed(64, "arkimex", 1.0, 20)
    assert s1.t == s2.t == 20.0
    assert s1.snes_failures == 0 and s2.snes_failures == 0
    assert np.abs(u_rosw - exact(64, 20.0)).max() < 2e-5
    assert np.abs(u_ark - exact(64, 20.0)).max() < 2e-5
    assert np.abs(u_rosw - u_ark).max() < 5e-8


def self_convergence(ts_type, **kw):
    """Errors at dt 64, 32, 16 against a dt=2 run to T=128, and the
    observed orders (tests/test_arkimex.py:52).  The stage solves are
    the dense tier's exact LU, so no stage-solve error masks the
    truncation error (the reference solves them with 16 sweeps and, for
    ARK436, 3 Newton iterations)."""
    kw = dict(kw, ksp_type="dense")
    T = 128.0
    ref, _ = run_fixed(64, ts_type, 2.0, int(T / 2.0), **kw)
    errs = [np.abs(run_fixed(64, ts_type, dt, int(T / dt), **kw)[0]
                   - ref).max() for dt in (64.0, 32.0, 16.0)]
    return errs, [math.log2(errs[i] / errs[i + 1]) for i in range(2)]


def test_arkimex_third_order_in_time():
    errs, orders = self_convergence("arkimex")
    assert min(orders) > 2.7, (errs, orders)


def test_arkimex_ksponly_single_newton():
    """tests/test_arkimex.py:68: one Newton iteration per stage is still
    accurate on the manufactured problem."""
    u, s = run_fixed(32, "arkimex", 1.0, 10, snes_iters=1)
    assert s.k == 10
    assert np.abs(u - exact(32, 10.0)).max() < 2e-3


def test_decode_arkimex_and_ksponly():
    opts = decode_numerics(["-ts_type", "arkimex", "-snes_type", "ksponly"])
    assert opts.ts_type == "arkimex"
    assert opts.snes_iters == 1


@pytest.mark.parametrize("ksp", ["banded", "lu"])
def test_banded_rejects_dirk_tableau(ksp):
    """The host exact steps are Rosenbrock-only: the Solver and
    make_step_fn raise ValueError with the reference Solver's message
    (the reference's make_step_fn would run Richardson sweeps instead,
    ROADMAP Queue C)."""
    ops, _ = problem_1d(32)
    _, _, jops = make_problem(nx=32)
    with pytest.raises(ValueError) as ref:
        JSolver(jops, KJ.NumericsOptions(ts_type="arkimex", ksp_type=ksp))
    with pytest.raises(ValueError) as got:
        Solver(ops, NumericsOptions(ts_type="arkimex", ksp_type=ksp))
    assert str(got.value) == str(ref.value)
    for ts in ("ark324", "ark436"):
        with pytest.raises(ValueError, match="Rosenbrock tableaus only"):
            make_step_fn(ops, NumericsOptions(ts_type=ts, ksp_type=ksp))


def test_arkimex_adaptive():
    """tests/test_arkimex.py:90 on the port's per-step Solver: the
    embedded order-2 pair drives the controller, h accelerates well past
    tmax, and the run tracks the growing mode."""
    ops, u0 = problem_1d(32)
    s = Solver(ops, NumericsOptions(ts_type="arkimex", ksp_iters=16),
               t0=0.0, dt=1.0, tmax=50.0, maxsteps=200, rtol=1e-6,
               atol=0.01)
    u = s.solve(u0).numpy()
    assert s.t > 50.0 and s.k < 200
    assert s._chunk is None and s.stats.step_attempts >= s.k
    assert np.abs(u - exact(32, s.t)).max() < 2e-2


def test_device_loop_matches_reference_solver():
    """The same run on the device loop (the adaptive chunk on one rich3
    tier with a DIRK tableau: the reference compiles each tier, so the
    ladder's tiers are held by the ensemble's test below) with h
    starting small
    so that it climbs through the controller, against the reference's
    Solver: the same accepted steps and rejections, t and h to 1e-6
    relative, u to 1e-6 of max|u| (the float32 sweeps round apart, and
    h carries it)."""
    ops, u0 = problem_1d(32)
    _, _, jops = make_problem(nx=32)
    kw = dict(t0=0.0, dt=1e-2, tmax=50.0, maxsteps=200, rtol=1e-6,
              atol=0.01)
    nm = dict(ts_type="arkimex", device_loop=True, ksp_iters_max=0)
    ref = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    ref_u = np.asarray(ref.solve(jnp.asarray(u0)))
    s = Solver(ops, NumericsOptions(**nm), **kw)
    u = s.solve(u0).numpy()
    assert s._chunk is not None and len(s._chunk.tiers) == 1
    assert s.stats.dispatches >= 1 and s.stats.step_attempts == 0
    assert s.k > 5 and s.t > 50.0
    assert (s.k, s.snes_failures, s.diverged) == (
        ref.k, ref.snes_failures, ref.diverged)
    assert s.t == pytest.approx(ref.t, rel=1e-6)
    assert s.h == pytest.approx(ref.h, rel=1e-6)
    assert np.abs(u - ref_u).max() <= 1e-6 * np.abs(ref_u).max()


def test_ark436_order_conditions():
    """tests/test_arkimex.py:105 on the port's tableau."""
    tab = get_tableau("ark436")
    A = np.array(tab.A)
    b = np.array(tab.b)
    bh = np.array(tab.bhat)
    c = np.array(tab.c)
    assert tab.stages == 6 and tab.gamma == 0.25
    assert b.sum() == pytest.approx(1.0, abs=1e-14)
    assert b @ c == pytest.approx(0.5, abs=1e-14)
    assert b @ c**2 == pytest.approx(1.0 / 3.0, abs=1e-13)
    assert b @ c**3 == pytest.approx(0.25, abs=1e-13)
    assert b @ A @ c == pytest.approx(1.0 / 6.0, abs=1e-13)
    assert bh.sum() == pytest.approx(1.0, abs=1e-13)
    assert bh @ c == pytest.approx(0.5, abs=1e-13)
    assert abs(bh @ c**3 - 0.25) > 1e-3
    np.testing.assert_allclose(A[-1], b, atol=1e-15)


def test_ark436_matches_rosw_trajectory():
    u_rosw, _ = run_fixed(64, "rosw", 1.0, 20)
    u_ark, s2 = run_fixed(64, "ark436", 1.0, 20, snes_iters=2)
    assert s2.snes_failures == 0
    assert np.abs(u_rosw - u_ark).max() < 5e-8


def test_ark436_fourth_order_in_time():
    errs, orders = self_convergence("ark436", snes_iters=3)
    assert min(orders) > 3.5, (errs, orders)


def test_decode_arkimex_type_4():
    opts = decode_numerics(["-ts_type", "arkimex", "-ts_arkimex_type", "4",
                            "-snes_type", "ksponly"])
    assert opts.ts_type == "ark436"
    opts = decode_numerics(["-ts_type", "rosw", "-ts_arkimex_type", "4"])
    assert opts.ts_type == "rosw"


# -- the 2D options84 problem against the reference ------------------------

@pytest.fixture(scope="module")
def problems():
    jps, _, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return jops, tops


def rough_state(seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal((N, N))),
        6000 + scale * np.abs(rng.standard_normal((N, N))),
        6000 + 0.5 * scale * np.abs(rng.standard_normal((N, N))),
    ])


def test_step_matches_reference(problems, interpret):
    """One ARK436 step (the ARK324 steps are held chained below).  At
    h = 5e-2 its embedded estimate is far above the float32 sweeps'
    rounding (at 1e-3 it is 4e-9, a cancelling sum of rounding)."""
    jops, tops = problems
    u0 = rough_state()
    ts_type, h = "ark436", 5e-2
    jf, _ = jstep(jops, KJ.NumericsOptions(ts_type=ts_type), atol=ATOL,
                  rtol=RTOL)
    u_ref, e_ref = jf(jnp.asarray(u0), 0.0, h)
    step, tab = make_step_fn(tops, NumericsOptions(ts_type=ts_type),
                             atol=ATOL, rtol=RTOL)
    assert isinstance(tab, tsolver.DIRKTableau)
    assert step.build_info["mixed32"] and step.build_info["pallas_delta"]
    u1, e1 = step(torch.from_numpy(u0), scalar(0.0), scalar(h))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u1.numpy() - u_ref).max() / inc < 1e-5
    assert float(e_ref) > 1e-3
    assert abs(float(e1) - float(e_ref)) <= 1e-2 * float(e_ref)


def test_chained_multistep_matches_reference(problems, interpret):
    jops, tops = problems
    u0 = rough_state(seed=1)
    nm = dict(ts_type="arkimex")
    jmulti, _ = jmultistep(jops, KJ.NumericsOptions(**nm), atol=ATOL,
                           rtol=RTOL, static_steps=False)
    u_ref, t_ref, e_ref = jmulti(jnp.asarray(u0), jnp.asarray(0.0),
                                 jnp.asarray(10 * H), 4)
    multi, _ = make_multistep_fn(tops, NumericsOptions(**nm), atol=ATOL,
                                 rtol=RTOL)
    u4, t4, e4 = multi(torch.from_numpy(u0), scalar(0.0), scalar(10 * H),
                       4)
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u4.numpy() - u_ref).max() / inc < 1e-5
    assert float(e_ref) > 1e-4
    assert abs(float(t4) - float(t_ref)) < 1e-15
    assert abs(float(e4) - float(e_ref)) <= 1e-2 * float(e_ref)


def test_fast_mode_step_matches_reference(problems, interpret):
    """The fast mode's DIRK step: f0 and every stage right-hand side
    from the rhs kernel, W from the jvp kernel, all float32."""
    jops, tops = problems
    u0 = rough_state(seed=2)
    nm = dict(ts_type="arkimex", precision="float32")
    jf, _ = jstep(jops, KJ.NumericsOptions(**nm), atol=ATOL, rtol=RTOL)
    u_ref, _ = jf(jnp.asarray(u0), 0.0, H)
    step, _ = make_step_fn(tops, NumericsOptions(**nm), atol=ATOL,
                           rtol=RTOL)
    assert step.build_info["pallas_rhs"] and step.build_info["fast32"]
    u1, e1 = step(torch.from_numpy(u0), scalar(0.0), scalar(H))
    assert u1.dtype == torch.float32 and e1.dtype == torch.float32
    u_ref = np.asarray(u_ref, dtype=np.float64)
    inc = np.abs(u_ref - u0).max()
    bound = 1e-4 * inc + 4 * EPS32 * np.abs(u0).max()
    assert np.abs(u1.double().numpy() - u_ref).max() <= bound


def test_dense_tier_matches_reference():
    """ksp_type dense runs DIRK (the reference's dense_solve takes any
    shift): one ARK436 step on the 1D manufactured problem, within
    1e-12 of max|u|."""
    ops, u0 = problem_1d(32)
    _, _, jops = make_problem(nx=32)
    nm = dict(ts_type="ark436", ksp_type="dense")
    jf, _ = jstep(jops, KJ.NumericsOptions(**nm), atol=ATOL, rtol=RTOL)
    u_ref, e_ref = jf(jnp.asarray(u0), 0.0, 5.0)
    step, _ = make_step_fn(ops, NumericsOptions(**nm), atol=ATOL, rtol=RTOL)
    u1, e1 = step(torch.from_numpy(u0), scalar(0.0), scalar(5.0))
    u_ref = np.asarray(u_ref)
    assert np.abs(u1.numpy() - u_ref).max() <= 1e-12 * np.abs(u_ref).max()
    # the estimate, a cancelling sum at 1e-7 here, carries the two LU
    # factorizations' rounding
    assert float(e1) == pytest.approx(float(e_ref), rel=1e-3)


# -- launches, dtypes and the Solver's DIRK rules ---------------------------

def counted_kernels(tops):
    """A kernel build whose plain bodies count their calls."""
    kern = make_fused_kernels(tops)
    calls = {name: 0 for name in kern.kernels}
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    return kern, calls


@pytest.mark.parametrize("change,per_step", [
    (dict(ts_type="ark324"), dict(rhs=0, jvp=0, resid=12, delta=9 + 1)),
    (dict(ts_type="ark436"), dict(rhs=0, jvp=0, resid=20, delta=15 + 1)),
    (dict(ts_type="arkimex", snes_iters=1),
     dict(rhs=0, jvp=0, resid=6, delta=6 + 1)),
    (dict(ts_type="arkimex", precision="float32"),
     dict(rhs=10, jvp=12, resid=0, delta=0)),
], ids=["ark324", "ark436", "ksponly", "ark324-fast"])
def test_launch_counts_per_step(problems, change, per_step):
    """Per chained step at 3 sweeps: each stage's first evaluation and
    each Newton iteration's solve (2 resid) and re-evaluation (1 delta),
    the chain's f0 advance 1 delta; the fast mode f0 and every stage
    evaluation on the rhs kernel, 2 jvp per solve.  On the CPU the
    wrappers run their plain bodies, whose calls are counted."""
    _, tops = problems
    kern, calls = counted_kernels(tops)
    multi, _ = make_multistep_fn(tops, NumericsOptions(**change),
                                 atol=ATOL, rtol=RTOL, kernels=kern)
    u, t, e = multi(torch.from_numpy(rough_state(seed=3)), scalar(0.0),
                    scalar(H), 3)
    assert calls == {n: 3 * c for n, c in per_step.items()}
    assert all(k.launches == 0 for k in kern.kernels.values())
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(e))


def test_mixed_path_stage_rhs_is_float64(problems, monkeypatch):
    """On the mixed path the DIRK stage right-hand sides are ``f0 +
    delta`` in float64 (the reference's :405-424), not the Rosenbrock
    stages' float32 ``f32(f0) + delta``: the embedded difference and the
    solution, sums of them, are float64."""
    _, tops = problems
    seen = []

    def spy(u1, d, atol, rtol, mesh=None):
        seen.append((u1.dtype, d.dtype))
        return orig(u1, d, atol, rtol, mesh=mesh)

    orig = tsolver.wlte_norm_delta
    monkeypatch.setattr(tsolver, "wlte_norm_delta", spy)
    kern, calls = counted_kernels(tops)
    step, _ = make_step_fn(tops, NumericsOptions(ts_type="arkimex"),
                           atol=ATOL, rtol=RTOL, kernels=kern)
    assert step.build_info["mixed32"] and step.build_info["pallas_delta"]
    step(torch.from_numpy(rough_state(seed=4)), scalar(0.0), scalar(H))
    # a float32 stage value would make its terms of d float32 (a 0-d
    # float64 h does not promote them)
    assert seen == [(torch.float64, torch.float64)]
    assert calls["delta"] == 9


def test_fallback_escalates_snes_iters(problems, monkeypatch):
    """The GMRES fallback of the Solver and of the ensemble runs at
    least 4 modified-Newton iterations per DIRK stage
    (solver.py:1505-1511, ensemble.py:359)."""
    _, tops = problems
    built = []
    orig = tsolver.make_step_fn

    def spy(ops, numerics=None, **kw):
        built.append(numerics)
        return orig(ops, numerics, **kw)
    monkeypatch.setattr(tsolver, "make_step_fn", spy)
    from ksfd_tpu_torch.solvers import ensemble as tensemble
    monkeypatch.setattr(tensemble, "make_step_fn", spy)
    for snes, want in ((1, 4), (6, 6)):
        nm = NumericsOptions(ts_type="arkimex", snes_iters=snes)
        built.clear()
        Solver(tops, nm, dt=H)._get_fallback()
        EnsembleSolver(tops, nm, dt=H)._get_fallback()
        fb = [n for n in built if n.ksp_type == "gmres_scipy"]
        assert len(fb) == 2
        assert all(n.snes_iters == want and n.ts_type == "arkimex"
                   and n.ksp_restart == 12 and n.ksp_max_it == 4
                   and not n.stage_delta for n in fb)


def test_lu_rescue_skipped_under_dirk():
    """The exact-LU rescue is Rosenbrock-only (solver.py:1558)."""
    ops, _ = problem_1d(32)
    assert Solver(ops, NumericsOptions(ts_type="arkimex"))._get_exact_step(
    ) is None
    assert Solver(ops, NumericsOptions(ts_type="ark436"))._get_exact_step(
    ) is None
    assert Solver(ops, NumericsOptions())._get_exact_step() is not None


def test_route_petsc_direct_leaves_dirk_iterative(capsys):
    """A PETSc direct-solve request with a DIRK tableau stays on the
    iterative stack, as the reference's routing decides."""
    g = dict(dim=1, width=1, nx=128, dof=3, order=3)
    for ts in ("arkimex", "ark324", "ark436", "rosw"):
        nm = NumericsOptions(petsc_direct=True, ts_type=ts)
        got = route_petsc_direct(nm, Grid(**g)).ksp_type
        ref = jroute(KJ.NumericsOptions(petsc_direct=True, ts_type=ts),
                     KJ.Grid(**g)).ksp_type
        assert got == ref == ("banded" if ts == "rosw" else "richardson")
    assert "DIRK tableau" in capsys.readouterr().err


def test_ensemble_device_loop_members_match_chunks():
    """EnsembleSolver's device loop with ark436: each member's k, t, h
    and state equal the port's single-member chunk of that member (bit
    for bit on the CPU), and the run accepts its steps."""
    ops, base = problem_1d(32)
    rng = np.random.default_rng(42)
    U0 = np.stack([base * (1.0 + 1e-3 * rng.standard_normal(base.shape))
                   for _ in range(3)])
    kw = dict(t0=0.0, dt=1.0, tmax=30.0, maxsteps=200, rtol=1e-6, atol=0.01)
    nm = NumericsOptions(ts_type="ark436", device_loop=True,
                         sweep_dtype="float64")
    es = EnsembleSolver(ops, nm, **kw)
    out = es.solve(U0)
    assert es._chunk is not None and not out.diverged.any()
    assert (out.t >= kw["tmax"]).all()
    chunk, tab = make_adaptive_chunk_fn(ops, nm, atol=kw["atol"],
                                        rtol=kw["rtol"], max_attempts=128)
    assert tab is get_tableau("ark436") and chunk.tiers[0][0] == "richardson"
    for i in range(len(U0)):
        u0 = ops.groom(torch.from_numpy(U0[i]))
        u, t, h, k, _, _ = chunk(u0, 0.0, kw["dt"], kw["tmax"],
                                 kw["maxsteps"])
        assert (k, t, h) == (out.k[i], out.t[i], out.h[i])
        assert torch.equal(u, out.u[i])


def count_peaks(rho):
    above = rho > rho.mean()
    edges = np.diff(np.r_[above, above[0]].astype(int))
    return int((edges == 1).sum())


def test_arkimex_gate_head_through_the_tool(monkeypatch):
    """tools/arkimex_gate.py (what chip_smoke.py phase 32 (d) runs on
    the card) on the CPU: the gate's first 12 steps through
    ``ksfdsolver.main`` take the arkimex scheme at ksponly on the
    iterative stack, fail on the stiff growth and run the GMRES
    fallback, finite."""
    from ksfd_tpu_torch.tools import arkimex_gate

    monkeypatch.setenv("KSFD_PLATFORM", "cpu")
    argv = arkimex_gate.gate_argv(12)
    assert "tmax=20000" in argv and "maxsteps=12" in argv
    assert not any(a.startswith(("--save", "--check")) for a in argv)
    res = arkimex_gate.run(maxsteps=12)
    assert res["ok"], res
    assert res["device"] == "cpu" and res["steps"] == 12
    assert res["failures"] > 0 and res["fallback_steps"] > 0


@pytest.mark.slow
def test_options92_arkimex_gate_through_the_port_cli(tmp_path):
    """tests/test_gates.py:80 through ``python -m ksfd_tpu_torch``:
    examples/eigenmode1d cut to tmax=2e4 with '-ts_type arkimex' at its
    '-snes_type ksponly'; under 150 failures, at most 400 steps, t >=
    2e4, 4 peaks, 2e4 < max rho < 2.8e4."""
    src = open(os.path.join(ROOT, "examples", "eigenmode1d")).read()
    lines = []
    for ln in src.splitlines():
        if ln.startswith("tmax="):
            ln = "tmax=20000"
        elif ln == "-ts_type rosw":
            ln = "-ts_type arkimex"
        lines.append(ln)
    optfile = tmp_path / "options"
    optfile.write_text("\n".join(lines) + "\n")
    save = str(tmp_path / "gate")
    env = dict(os.environ, KSFD_PLATFORM="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "ksfd_tpu_torch", "@" + str(optfile),
         "--save=" + save], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=1800)
    assert res.returncode == 0, res.stdout + res.stderr
    nfail = int(res.stdout.split("solve failures =")[-1].split()[0])
    assert nfail < 150, nfail
    assert "kept on the iterative stack: DIRK tableau" in res.stderr
    import h5py

    with h5py.File(save + "s1r0.h5", "r") as f:
        ks = sorted(int(k[4:]) for k in f if k.startswith("data"))
        assert ks[-1] <= 400, ks[-1]
        last = f["data%d" % ks[-1]]
        assert float(last.attrs["t"]) >= 20000.0
        rho = np.asarray(last)[0]
    assert count_peaks(rho) == 4
    assert 20000.0 < rho.max() < 28000.0
