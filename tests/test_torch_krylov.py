"""The port's fixed-count Krylov tiers against ksfd_tpu on the CPU.

``solvers/gmres.py`` ``gmres_fixed``, ``gmres_rolled`` and
``gmres_restarted`` (ksfd_tpu/solvers/gmres.py:317, :208, :32) and their
dispatch in ``make_step_fn`` (ksfd_tpu/solvers/solver.py:571-633):
``ksp_type`` gmres, gmres_rolled and gmres_restarted, and ``pc_type``
none with Richardson or Chebyshev (``gmres_fixed`` without a pc).  Held
here:

- the three solvers against the reference's on a numpy-made
  nonsymmetric operator with a pc, to 1e-12 relative, and the breakdown
  contract (tests/test_solver.py:182): finite answers, the exact one
  where the space closes early, a visibly unsolved one for a singular
  operator, zero for a zero right-hand side;
- gmres_rolled under ``torch.func.vmap`` against the members one by
  one, to 1e-12 relative (a batched matrix product may sum in another
  order);
- one step with each Krylov tier on the 2D options84 problem at 32^2 x 3
  against the reference's step (its Pallas kernels in interpret mode,
  the port's plain versions): the float64 paths (a float64 pc, stage
  right-hand sides from the float64 RHS) to 1e-12 of the increment;
  gmres_rolled on the mixed path (W from the jvp kernel, B2, and the
  delta kernel's stage right-hand sides) and the default gmres (f32 pc,
  delta kernel) within 1e-5 of the increment, the mixed-precision
  envelope of tests/test_torch_solver.py;
- the launches per chained step of the mixed gmres_rolled path
  (4 ksp_max_it (ksp_restart + 1) jvp, 4 delta, no resid);
- the chunk's no-fallback exit (tests/test_solver_modes.py:330) and a
  Solver run on the device loop with gmres_rolled against the
  reference's Solver (step and rejection counts, final-state statistics
  to 1e-5 relative);
- the EnsembleSolver's fixed-dt steps with gmres_rolled against each
  member's own step.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers.gmres import gmres_fixed as j_fixed
from ksfd_tpu.solvers.gmres import gmres_restarted as j_restarted
from ksfd_tpu.solvers.gmres import gmres_rolled as j_rolled
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    Solver,
    gmres_fixed,
    gmres_restarted,
    gmres_rolled,
    make_multistep_fn,
    make_step_fn,
)
from ksfd_tpu_torch.tools import validate
from manufactured import exact_state as j_exact_state
from manufactured import make_problem as j_make_problem

N = 32
H = 1e-3
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


# -- the solvers on a numpy-made operator -----------------------------------

SOLVERS = {
    "fixed": (j_fixed, gmres_fixed, dict(iters=15)),
    "rolled": (j_rolled, gmres_rolled, dict(iters=6, restarts=3)),
    "restarted": (j_restarted, gmres_restarted, dict(iters=5, restarts=3)),
}


def system(seed=7, n=30):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 2.5 + 0.3 * rng.standard_normal((n, n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solver_matches_reference(name):
    """The same Krylov space and arithmetic: the port's answer equals the
    reference's to 1e-12 relative (an unconverged fixed count, too)."""
    jfn, tfn, kw = SOLVERS[name]
    A, b = system()
    M = lambda v: v / 2.5  # noqa: E731
    for k in (kw, dict(kw, iters=3)):
        ref = np.asarray(jfn(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             M=M, **k))
        got = tfn(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
                  M=M, **k).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    if name != "fixed":
        xref = np.linalg.solve(A, b)
        got = tfn(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
                  M=M, iters=15, restarts=2).numpy()
        assert np.abs(got - xref).max() < 1e-8


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_breakdown_finite_and_judged(name):
    """tests/test_solver.py:182 on each solver: the identity closes the
    space after one step and the guarded divisions keep the exact
    answer; a singular projection leaves a finite, visibly unsolved
    answer; a zero right-hand side gives zero.  The reference's answers
    agree."""
    jfn, tfn, kw = SOLVERS[name]
    kw = dict(kw, iters=6)
    b = np.linspace(1.0, 2.0, 8)
    x = tfn(lambda v: v, torch.from_numpy(b), **kw)
    assert np.allclose(x.numpy(), b, atol=1e-12)
    ref = np.asarray(jfn(lambda v: v, jnp.asarray(b), **kw))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-12, atol=1e-12)
    # the guarded divisions' values here are rounding amplified (the
    # reference's too): only finite and unsolved are the contract
    mask = torch.tensor([1.0] * 4 + [0.0] * 4, dtype=torch.float64)
    bb = torch.ones(8, dtype=torch.float64)
    xx = tfn(lambda v: mask * v, bb, **kw)
    assert bool(torch.isfinite(xx).all())
    assert float(torch.linalg.norm(bb - mask * xx)) > 0.5
    z = tfn(lambda v: v * 2.0, torch.zeros(8, dtype=torch.float64), **kw)
    assert bool((z == 0).all())


def test_rolled_under_vmap_matches_members():
    """gmres_rolled reads nothing on the host: ``torch.func.vmap`` takes
    it, and each member's answer equals its own call to 1e-12."""
    ops_, bs = [], []
    for seed in range(3):
        A, b = system(seed=seed)
        ops_.append(A)
        bs.append(b)
    A = torch.from_numpy(np.stack(ops_))
    B = torch.from_numpy(np.stack(bs))
    M = lambda v: v / 2.5  # noqa: E731
    X = vmap(lambda a, b: gmres_rolled(lambda v: a @ v, b, M=M, iters=6,
                                       restarts=2))(A, B)
    for i in range(3):
        xi = gmres_rolled(lambda v: A[i] @ v, B[i], M=M, iters=6,
                          restarts=2)
        assert float((X[i] - xi).abs().max()) <= 1e-12 * float(
            xi.abs().max())


# -- the step on the 2D options84 problem -----------------------------------

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


F64 = dict(stage_delta=False, pc_dtype="float64")
ROLLED = dict(ksp_type="gmres_rolled", ksp_restart=6, ksp_max_it=2)


@pytest.mark.parametrize("change,bound,mixed", [
    (dict(ksp_type="gmres", **F64), 1e-12, False),
    (dict(ksp_type="gmres_restarted", **F64), 1e-12, False),
    (dict(ROLLED, sweep_dtype="float64", **F64), 1e-12, False),
    (dict(pc_type="none", stage_delta=False), 1e-12, False),
    (dict(pc_type="none", ksp_type="chebyshev", stage_delta=False), 1e-12,
     False),
    (dict(ROLLED), 1e-5, True),
    (dict(ksp_type="gmres"), 1e-5, False),
], ids=["gmres-f64", "restarted-f64", "rolled-f64", "none-richardson",
        "none-chebyshev", "rolled-mixed", "gmres-default"])
def test_step_matches_reference(problems, interpret, change, bound, mixed):
    """One step with each Krylov tier against the reference's; the
    float64 paths at h = 1e-3 to 1e-12 of the increment and their error
    norms to 1e-8 relative (a cancelling sum), the ones with float32
    parts (W, pc or stage right-hand sides) at h = 5e-2, where the error
    norm is far above their rounding, within 1e-5 of the increment and
    1e-2."""
    jops, tops = problems
    u0 = rough_state()
    h = H if bound < 1e-6 else 5e-2
    jf, _ = jstep(jops, KJ.NumericsOptions(**change), atol=ATOL, rtol=RTOL)
    u_ref, e_ref = jf(jnp.asarray(u0), 0.0, h)
    step, _ = make_step_fn(tops, NumericsOptions(**change), atol=ATOL,
                           rtol=RTOL)
    assert step.build_info["mixed32"] is mixed
    u1, e1 = step(torch.from_numpy(u0), scalar(0.0), scalar(h))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u1.numpy() - u_ref).max() <= bound * inc
    erel = 1e-8 if bound < 1e-6 else 1e-2
    assert abs(float(e1) - float(e_ref)) <= erel * float(e_ref)


def counted_kernels(tops):
    """make_fused_kernels with each plain body counted (on the CPU the
    wrappers run their plain bodies)."""
    kern = make_fused_kernels(tops)
    calls = dict.fromkeys(kern.kernels, 0)
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    return kern, calls


def test_mixed_rolled_launches_per_chained_step(problems):
    """The mixed gmres_rolled chain: per step and stage solve
    ksp_max_it cycles of ksp_restart + 1 W applies, each one jvp (B2);
    3 stage right-hand sides and the f0 advance on delta (B3); no
    resid."""
    _, tops = problems
    kern, calls = counted_kernels(tops)
    nm = NumericsOptions(**ROLLED)
    multi, _ = make_multistep_fn(tops, nm, atol=ATOL, rtol=RTOL,
                                 kernels=kern)
    assert multi.build_info["mixed32"]
    u, t, e = multi(torch.from_numpy(rough_state(seed=3)), scalar(0.0),
                    scalar(H), 2)
    jvp = 4 * nm.ksp_max_it * (nm.ksp_restart + 1)
    assert calls == dict(rhs=0, jvp=2 * jvp, resid=0, delta=2 * 4)
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(e))


# -- the Solver, the chunk and the ensemble ---------------------------------

def test_chunk_rejection_without_fallback_continues():
    """tests/test_solver_modes.py:330 on the port: gmres_rolled has no
    robust fallback; a stuck chunk exit counts a failure, shrinks h and
    re-enters the chunk, never arms a fallback that is None."""
    _, grid, ops = validate.make_problem(nx=32, device="cpu")
    nm = NumericsOptions(device_loop=True, ksp_type="gmres_rolled",
                         sweep_dtype="float64", ksp_restart=8, ksp_max_it=2)
    s = Solver(ops, nm, t0=0.0, dt=1.0, tmax=20.0, maxsteps=60, rtol=1e-6,
               atol=0.01)
    assert s._get_fallback() is None and s._chunk is not None
    assert s._chunk.tiers == [("gmres_rolled", 3)]
    real_chunk = s._chunk
    calls = {"n": 0}

    def fake_chunk(u, t, h, tmax, maxacc):
        calls["n"] += 1
        if calls["n"] == 1:
            return u, t, h, 0, 8, True
        return real_chunk(u, t, h, tmax, maxacc)

    fake_chunk.tiers = real_chunk.tiers
    fake_chunk.stats = SimpleNamespace(per_tier=[0])
    s._chunk = fake_chunk
    u = s.solve(validate.exact_state(grid, 0.0))
    assert calls["n"] > 1 and s.snes_failures >= 1
    assert not s.diverged and not s._fb_mode
    assert bool(torch.isfinite(u).all())


def test_device_loop_solver_matches_reference():
    """An adaptive Solver run on the device loop with gmres_rolled on
    the 1D manufactured problem (the mixed path: W from the float32 RHS
    linearized once per step): the same accepts and rejections, t and
    the final state within 1e-5 relative of the reference's Solver (the
    controller's h carries the float32 sweeps' rounding)."""
    nm = dict(device_loop=True, ksp_type="gmres_rolled", ksp_restart=8,
              ksp_max_it=2)
    kw = dict(t0=0.0, dt=0.5, tmax=1e9, maxsteps=12, rtol=1e-6, atol=0.01)
    jps, jgrid, jops = j_make_problem(nx=32)
    js = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    uj = np.asarray(js.solve(jnp.asarray(j_exact_state(jps, jgrid, 0.0))))
    _, grid, ops = validate.make_problem(nx=32, device="cpu")
    s = Solver(ops, NumericsOptions(**nm), **kw)
    u = s.solve(validate.exact_state(grid, 0.0)).numpy()
    assert (s.k, s.snes_failures) == (js.k, js.snes_failures)
    assert s.build_info["mixed32"]
    assert abs(s.t - js.t) <= 1e-5 * abs(js.t)
    assert np.abs(u - uj).max() <= 1e-5 * np.abs(uj).max()


def test_ensemble_rolled_members_match_their_own_steps(problems):
    """EnsembleSolver's fixed-dt steps with gmres_rolled on the mixed
    path (the vmapped Krylov tier over the batched jvp kernel): each
    member equals two steps of its own within 1e-5 of the increment (the
    float32 sweeps summed in another order under vmap)."""
    _, tops = problems
    nm = NumericsOptions(adapt_type="none", **ROLLED)
    base = rough_state(seed=5)
    rng = np.random.default_rng(1)
    U0 = np.stack([base * (1.0 + 1e-3 * rng.standard_normal(base.shape))
                   for _ in range(3)])
    es = EnsembleSolver(tops, nm, t0=0.0, dt=H, tmax=1e9, maxsteps=2,
                        rtol=RTOL, atol=ATOL)
    out = es.solve(U0)
    assert (out.k == 2).all() and not out.diverged.any()
    step, _ = make_step_fn(tops, nm, atol=ATOL, rtol=RTOL)
    for i in range(3):
        u = tops.groom(torch.from_numpy(U0[i]))
        for k in range(2):
            u, _ = step(u, scalar(k * H), scalar(H))
            u = tops.groom(u)
        inc = float((u - torch.from_numpy(U0[i])).abs().max())
        assert float((out.u[i] - u).abs().max()) <= 1e-5 * inc


def test_krylov_tiers_build_everywhere(problems):
    """The step, the chained step, the multistep and the chunk build
    with each Krylov tier; only the mixed gmres_rolled chains f0 (it
    alone is mixed32 with the delta kernel, as the reference's
    ``chain_f0`` asks); GMRES tiers get one chunk tier (``esc_ok``)."""
    _, tops = problems
    for change, chains in ((dict(ksp_type="gmres"), False),
                           (dict(ksp_type="gmres_restarted"), False),
                           (ROLLED, True),
                           (dict(pc_type="none"), False)):
        nm = dataclasses.replace(NumericsOptions(), **change)
        chain, _ = make_step_fn(tops, nm, chain_f0=True)
        assert (chain is not None) is chains, change
        from ksfd_tpu_torch.solvers.solver import chunk_tiers

        assert len(chunk_tiers(nm)) == (3 if nm.ksp_type == "richardson"
                                        else 1)
