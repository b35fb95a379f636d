"""The port's adaptive chunk against ksfd_tpu's on the CPU.

The reference builds its chunk with the Pallas kernels in interpret
mode (KSFD_PALLAS_INTERPRET=1, as tests/test_torch_solver.py runs its
steps); the port runs the plain versions of its kernels and a
host-side controller (solvers/solver.py ChunkLadder).  Three reference
chunks are built, once each, in module-scoped fixtures: they take most
of this file's time.  Held to: the same accept and attempt counts and
rejected flag, t and h within 1e-4 relative, u within 1e-4 of the
increment max|u_ref - u0| (the envelope of the reference's own chunk
comparison, tests/test_pallas.py:361-365).  The states are chosen so
that no up-probe into the top tier is rejected, where the port
deliberately differs (ROADMAP Queue C).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke
import ksfd_tpu as KJ
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers.gmres import chebyshev_solve as jcheb
from ksfd_tpu.solvers.gmres import chebyshev_solve_resid as jcheb_resid
from ksfd_tpu.solvers.solver import chunk_cfl_safety as jchunk_cfl_safety
from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn as jchunk_fn
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.solvers import (
    chebyshev_solve,
    chebyshev_solve_resid,
    make_adaptive_chunk_fn,
    make_step_fn,
)
from ksfd_tpu_torch.solvers.solver import (
    ESC_PARK,
    ChunkLadder,
    chunk_cfl_safety,
)

N = 32
ATOL, RTOL = 0.01, 1e-6
CFL = 0.004
MAX_ATTEMPTS = 30


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def interpret_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KSFD_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def problems():
    jps, jgrid, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return jps, jgrid, jops, tops


def peaked_state(ps, grid):
    """A smooth state whose rho swings from 2000 to 26000, into the
    cap's cushion: the block pc's mean-state linearization is far from
    the local one there, so one sweep is solve-limited at h where
    sixteen are not."""
    axes = [np.arange(n) / n for n in grid.Sshape]
    X, Y = np.meshgrid(*axes, indexing="ij")
    rho = 14000.0 + 12000.0 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    return np.stack([rho] + [rho * r for r in chip_smoke.ligand_ratios(ps)])


def _jax_chunk(problems, numerics, **kw):
    _, _, jops, _ = problems
    chunk, _ = jchunk_fn(jops, numerics, atol=ATOL, rtol=RTOL,
                         max_attempts=MAX_ATTEMPTS, **kw)
    return chunk


@pytest.fixture(scope="module")
def jax_default(problems, interpret_env):
    """The default three-tier ladder (rich3, rich16, cheb48)."""
    return _jax_chunk(problems, KJ.NumericsOptions())


@pytest.fixture(scope="module")
def jax_shrink(problems, interpret_env):
    """One tier of two sweeps, with the CFL clamp."""
    return _jax_chunk(problems, KJ.NumericsOptions(ksp_iters=2,
                                                   ksp_iters_max=0),
                      cfl_safety=CFL)


@pytest.fixture(scope="module")
def jax_esc(problems, interpret_env):
    """The three-tier ladder over a one-sweep bottom tier."""
    return _jax_chunk(problems, KJ.NumericsOptions(ksp_iters=1))


def run_both(problems, jchunk, numerics, u0, h0, accepts, **kw):
    _, _, _, tops = problems
    ju, jt, jh, jk, ja, jr = jchunk(jnp.asarray(u0), 0.0, h0, 1e9, accepts)
    chunk, _ = make_adaptive_chunk_fn(tops, numerics, atol=ATOL, rtol=RTOL,
                                      max_attempts=MAX_ATTEMPTS, **kw)
    out = chunk(torch.from_numpy(u0), 0.0, h0, 1e9, accepts)
    ref = (np.asarray(ju), float(jt), float(jh), int(jk), int(ja), bool(jr))
    return out, ref, chunk.stats


def assert_parity(out, ref, u0):
    u, t, h, k, att, rej = out
    ju, jt, jh, jk, ja, jr = ref
    assert (k, att, rej) == (jk, ja, jr)
    assert abs(t - jt) <= 1e-4 * abs(jt)
    assert abs(h - jh) <= 1e-4 * abs(jh)
    inc = np.abs(ju - u0).max()
    assert inc > 0
    assert np.abs(u.numpy() - ju).max() <= 1e-4 * inc


def test_chunk_smooth_matches_reference(problems, jax_default):
    """Near-uniform state, h=1: every attempt is accepted."""
    jps, jgrid, jops, _ = problems
    u0 = np.array(jops.groom(jnp.asarray(ge._initial_state(jgrid))))
    out, ref, stats = run_both(problems, jax_default, NumericsOptions(),
                               u0, 1.0, 5)
    assert_parity(out, ref, u0)
    assert out[3] == out[4] == 5 and not out[5]
    assert stats.per_tier == [5, 0, 0] and stats.tiers == [
        ("richardson", 3), ("richardson", 16), ("chebyshev", 48)]


def test_chunk_shrinks_h_like_reference(problems, jax_shrink):
    """One weak tier at h=1 on the peaked state: on-device rejections
    shrink h (as tests/test_solver_modes.py:132), then the CFL clamp
    holds h under safety * spacing * sw / max|grad G|."""
    jps, jgrid, _, _ = problems
    u0 = peaked_state(jps, jgrid)
    nm = NumericsOptions(ksp_iters=2, ksp_iters_max=0)
    out, ref, stats = run_both(problems, jax_shrink, nm, u0, 1.0, 10,
                               cfl_safety=CFL)
    assert_parity(out, ref, u0)
    u, t, h, k, att, rej = out
    assert k == 10 and att > k and not rej and h < 1.0
    # the clamp bound: the last accepts grow h by less than the
    # controller alone would (enorm well under 1 allows x1.3 and more)
    hs = [r[2] for r in stats.records[-4:]]
    assert max(b / a for a, b in zip(hs, hs[1:])) < 1.01


def test_chunk_tier_escalation_matches_reference(problems, jax_esc):
    """One sweep at h=0.1 on the peaked state: a finite rejection at
    tier 0 retries the same h at tier 1, which accepts where tier 0
    cannot, and the chunk parks there."""
    jps, jgrid, _, _ = problems
    u0 = peaked_state(jps, jgrid)
    out, ref, stats = run_both(problems, jax_esc,
                               NumericsOptions(ksp_iters=1), u0, 0.1, 8)
    assert_parity(out, ref, u0)
    recs = stats.records
    rescued = [i for i in range(1, len(recs))
               if recs[i][0] == 1 and recs[i - 1][0] == 0
               and recs[i][2] == recs[i - 1][2] and recs[i][1] <= 1.0]
    assert rescued, recs
    assert stats.tier == 1 and out[4] > out[3]


def test_chunk_nonfinite_exit_matches_reference(problems, jax_default):
    """A non-finite error norm exits at once, rejected, with h untouched
    (as tests/test_solver_modes.py:192).  A NaN point is groomed to the
    floor, so rich3 and rich16 reject it finitely and escalate at the
    same h; the top tier's Chebyshev solve then goes non-finite."""
    jps, jgrid, jops, tops = problems
    u0 = np.array(ge._initial_state(jgrid))
    u0[0, 0, 0] = np.nan
    ju, jt, jh, jk, ja, jr = jax_default(jnp.asarray(u0), 0.0, 1.0, 1e9, 8)
    chunk, _ = make_adaptive_chunk_fn(tops, NumericsOptions(), atol=ATOL,
                                      rtol=RTOL, max_attempts=MAX_ATTEMPTS)
    u, t, h, k, att, rej = chunk(torch.from_numpy(u0), 0.0, 1.0, 1e9, 8)
    assert (k, att, rej) == (int(jk), int(ja), bool(jr)) == (0, 3, True)
    assert h == float(jh) == 1.0 and t == float(jt) == 0.0
    recs = chunk.stats.records
    assert [r[0] for r in recs] == [0, 1, 2]
    assert all(1.0 < r[1] < math.inf for r in recs[:2])
    assert not math.isfinite(recs[2][1])


def test_chunk_tiers_follow_the_escalation_gate(problems):
    """Repaired fault (ROADMAP Queue C): the chunk adds its escalation
    tiers only for the sweep solvers, as the reference's ``esc_ok``
    (ksfd_tpu/solvers/solver.py:995-999); GMRES ignores ksp_iters, so a
    gmres_scipy chunk has one tier."""
    tops = problems[3]

    def tiers(**kw):
        chunk, _ = make_adaptive_chunk_fn(tops, NumericsOptions(**kw),
                                          atol=ATOL, rtol=RTOL)
        return chunk.tiers

    assert tiers(ksp_type="gmres_scipy") == [("gmres_scipy", 3)]
    assert tiers() == [("richardson", 3), ("richardson", 16),
                       ("chebyshev", 48)]
    assert tiers(ksp_type="chebyshev") == [("chebyshev", 3),
                                           ("chebyshev", 16),
                                           ("chebyshev", 48)]


def test_chunk_gmres_scipy_matches_reference(problems, interpret_env):
    """A gmres_scipy chunk on the peaked state from h=0.1: its one tier
    rejects twice and shrinks h each time, as the reference's chunk
    does, with the reference's accepts, attempts and rejected flag."""
    jps, jgrid, _, _ = problems
    u0 = peaked_state(jps, jgrid)
    jchunk = _jax_chunk(problems, KJ.NumericsOptions(ksp_type="gmres_scipy"))
    out, ref, stats = run_both(problems, jchunk,
                               NumericsOptions(ksp_type="gmres_scipy"),
                               u0, 0.1, 2)
    assert_parity(out, ref, u0)
    assert out[3] == 2 and out[4] == 4 and not out[5]
    recs = stats.records
    assert [r[0] for r in recs] == [0] * 4
    assert recs[0][1] > 1.0 and recs[1][1] > 1.0 and recs[1][2] < recs[0][2]


def test_chunk_pc_pallas_matches_default_pc():
    """The chunk with the fused pc against the chunk with the basis-GEMM
    pc at 128^2: the same accepts and attempts, t and h within 1e-4
    relative, u within 1e-4 of the increment."""
    n = 128
    jps, jgrid, _ = ge._make_problem(n, n)
    _, _, tops = problem_from_clargs(jps.clargs, n, n, device="cpu")
    u0 = torch.from_numpy(peaked_state(jps, jgrid))
    outs = {}
    for pc_pallas in (False, True):
        chunk, _ = make_adaptive_chunk_fn(
            tops, NumericsOptions(pc_pallas=pc_pallas), atol=ATOL,
            rtol=RTOL, max_attempts=12)
        outs[pc_pallas] = chunk(u0, 0.0, 0.05, 1e9, 4)
    (u, t, h, k, att, rej), (ur, tr, hr, kr, ar, rr) = outs[True], outs[False]
    assert (k, att, rej) == (kr, ar, rr) and k == 4
    assert abs(t - tr) <= 1e-4 * tr and abs(h - hr) <= 1e-4 * hr
    inc = float((ur - u0).abs().max())
    assert float((u - ur).abs().max()) <= 1e-4 * inc


def test_chunk_3d_replays_its_steps():
    """A 3D chunk (16 x 8 x 16, aggregation3d's parameters) is the
    sequence of its recorded attempts: replaying each (tier, h) with the
    tier's f0-chained step reproduces u, t and the error norms exactly,
    and the ladder escalated on the way."""
    shape = (16, 8, 16)
    ps, grid, ops = problem_from_clargs(chip_smoke.agg3d_clargs(16), *shape,
                                        device="cpu")
    u0 = ops.groom(torch.as_tensor(chip_smoke.initial_state(grid)))
    nm = NumericsOptions(ksp_iters=1)
    chunk, _ = make_adaptive_chunk_fn(ops, nm, atol=ATOL, rtol=RTOL,
                                      max_attempts=12)
    u, t, h, k, att, rej = chunk(u0, 0.0, 50.0, 1e9, 4)
    assert k == 4 and not rej and torch.isfinite(u).all()
    assert att > k and chunk.stats.per_tier[0] < att
    chains = [make_step_fn(ops, dataclasses.replace(
        nm, ksp_type=kt, ksp_iters=it), atol=ATOL, rtol=RTOL,
        chain_f0=True)[0] for kt, it in chunk.tiers]
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    ur, tr = u0, 0.0
    f0 = ops.rhs(ops.groom(u0), f64(0.0))
    for tier, enorm, hh in chunk.stats.records:
        u1, e, f1 = chains[tier].step(ur, f64(tr), f64(hh), f0)
        assert float(e) == enorm
        if enorm <= 1.0:
            ur, tr, f0 = u1, tr + hh, f1
    assert tr == t and torch.equal(u, ur)


def test_chunk_fast_mode_replays_its_steps(problems):
    """The float32 fast mode's chunk (no f0 chain) on the peaked state
    is the sequence of its recorded attempts, replayed with each tier's
    plain fast-mode step; u keeps the caller's float64, as the
    reference's carry does."""
    jps, jgrid, _, tops = problems
    u0 = torch.from_numpy(peaked_state(jps, jgrid))
    nm = NumericsOptions(precision="float32", ksp_iters=1)
    chunk, _ = make_adaptive_chunk_fn(tops, nm, atol=ATOL, rtol=RTOL,
                                      max_attempts=12)
    u, t, h, k, att, rej = chunk(u0, 0.0, 0.1, 1e9, 4)
    assert k == 4 and not rej and u.dtype == torch.float64
    assert att > k and bool(torch.isfinite(u).all())
    steps = [make_step_fn(tops, dataclasses.replace(
        nm, ksp_type=kt, ksp_iters=it), atol=ATOL, rtol=RTOL)[0]
        for kt, it in chunk.tiers]
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    ur, tr = u0, 0.0
    for tier, enorm, hh in chunk.stats.records:
        u1, e = steps[tier](ur, f64(tr), f64(hh))
        assert float(e) == enorm
        if enorm <= 1.0:
            ur, tr = u1.to(torch.float64), tr + hh
    assert tr == t and torch.equal(u, ur)


# -- the controller on synthetic error norms ---------------------------


def ladder(h=1.0, ntiers=3):
    return ChunkLadder(NumericsOptions(), ntiers, -0.25, h)


def feed(lad, enorms):
    return [lad.update(e) for e in enorms]


def test_ladder_probes_up_and_sticks():
    lad = ladder()
    feed(lad, [0.6] * (ESC_PARK - 1))
    assert lad.tier == 0 and lad.probing == 0
    feed(lad, [0.6])          # the 16th marginal accept probes up
    assert lad.tier == 1 and lad.probing == 2
    feed(lad, [0.3])          # a comfortable probe accept: it sticks
    assert lad.tier == 1 and lad.probing == 0 and lad.park == ESC_PARK


def test_ladder_up_probe_bounce_backs_off():
    lad = ladder()
    feed(lad, [0.6] * ESC_PARK)
    feed(lad, [0.7])          # marginal probe accept: back, backed off
    assert lad.tier == 0 and lad.park == 4 * ESC_PARK and lad.probing == 0


def test_ladder_probes_down_and_bounces():
    lad = ladder()
    h = lad.h
    feed(lad, [2.0])          # finite rejection at tier 0: escalate
    assert lad.tier == 1 and lad.h == h and lad.fails == 0
    feed(lad, [0.3] * ESC_PARK)   # comfortable accepts: probe down
    assert lad.tier == 0 and lad.probing == 1
    feed(lad, [0.8])          # marginal down-probe: bounce back up
    assert lad.tier == 1 and lad.park == ESC_PARK and lad.probing == 0


def test_ladder_top_tier_rejection_resets_and_shrinks():
    lad = ladder()
    feed(lad, [2.0, 2.0])     # tier 0 -> 1 -> 2 at the same h
    assert lad.tier == 2 and lad.h == 1.0 and lad.fails == 0
    feed(lad, [2.0])          # a top-tier controller rejection
    assert lad.tier == 0 and lad.fails == 1
    assert lad.h == pytest.approx(0.9 * 2.0 ** -0.25)


def test_ladder_rejected_top_up_probe_keeps_resident_tier():
    """Repaired defect (ROADMAP Queue C, ksfd_tpu/solvers/solver.py:1122):
    an up-probe into the top tier that is rejected returns to the
    resident tier at the same h, with no failure and no ladder reset;
    the reference shrinks h, counts a failure and restarts at tier 0."""
    lad = ladder()
    feed(lad, [2.0])          # escalate: resident tier 1
    feed(lad, [0.6] * ESC_PARK)   # marginal accepts: probe up to 2
    assert lad.tier == 2 and lad.probing == 2
    h = lad.h
    assert feed(lad, [1.5]) == [False]
    assert (lad.tier, lad.h, lad.fails) == (1, h, 0)
    assert lad.park == 4 * ESC_PARK and lad.probing == 0


def test_ladder_nonfinite_exits_with_h_untouched():
    lad = ladder()
    assert feed(lad, [float("nan")]) == [False]
    assert lad.rejected and lad.h == 1.0


def test_default_max_attempts_reaches_the_rejection_exit(problems):
    """Repaired defect (ROADMAP Queue C, ksfd_tpu/solvers/solver.py:883):
    max_attempts defaults to ntiers * max_rejects, so a stuck state (h
    pinned by dt_min where no tier can accept) exits rejected after
    3 x 24 attempts; the reference's 64 ends the chunk first, not
    rejected.  An explicit max_attempts keeps its meaning."""
    jps, jgrid, _, tops = problems
    u0 = torch.from_numpy(peaked_state(jps, jgrid))
    nm = NumericsOptions(ksp_iters_max=4, ksp_iters_max2=6, dt_min=10.0)
    chunk, _ = make_adaptive_chunk_fn(tops, nm, atol=ATOL, rtol=RTOL)
    u, t, h, k, att, rej = chunk(u0, 0.0, 10.0, 1e9, 8)
    assert (k, att, rej) == (0, 3 * 24, True) and h == 10.0
    chunk, _ = make_adaptive_chunk_fn(tops, nm, atol=ATOL, rtol=RTOL,
                                      max_attempts=64)
    assert chunk(u0, 0.0, 10.0, 1e9, 8)[3:] == (0, 64, False)


# -- the CFL clamp's inputs -----------------------------------------


def test_velocity_matches_reference(problems):
    jps, jgrid, jops, tops = problems
    u = peaked_state(jps, jgrid)
    u[0, 3, 4] = 0.0          # groomed to the floor first
    ref = np.asarray(jops.velocity(jnp.asarray(u), 0.0))
    out = tops.velocity(torch.from_numpy(u), 0.0).numpy()
    assert out.shape == ref.shape == (2, N, N)
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("factor", ["0.5", "0", None])
def test_chunk_cfl_safety_matches_reference(factor):
    clargs = chip_smoke.bench_clargs(8)
    if factor is not None:
        clargs.params.append("CFL_safety_factor=" + factor)
    jps = KJ.SolutionParameters(clargs)
    tps, _, _ = problem_from_clargs(clargs, 8, 8, device="cpu")
    assert chunk_cfl_safety(tps) == jchunk_cfl_safety(jps)
    assert chunk_cfl_safety(tps) == (0.5 if factor == "0.5" else None)



# -- Chebyshev, the top tier's stage solve ----------------------------


@pytest.mark.parametrize("resid_form", [False, True])
@pytest.mark.parametrize("iters", [1, 5, 48])
def test_chebyshev_solve_matches_reference(iters, resid_form):
    """chebyshev_solve[_resid] against the reference's in float64 on a
    symmetric positive definite system with a Jacobi preconditioner,
    the interval given as 0-d tensors to the port: 1e-12 of max|x|."""
    rng = np.random.default_rng(11)
    n = 40
    B = rng.standard_normal((n, n))
    A = 3.0 * np.eye(n) + 0.1 * B @ B.T
    Minv = np.diag(1.0 / np.diag(A))
    b = rng.standard_normal(n)
    ev = np.linalg.eigvals(Minv @ A).real
    lmin, lmax = 0.9 * ev.min(), 1.05 * ev.max()
    Aj, Mj, Aq, Mq = (jnp.asarray(A), jnp.asarray(Minv),
                      torch.from_numpy(A), torch.from_numpy(Minv))
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    if resid_form:
        ref = jcheb_resid(lambda x, bb: bb - Aj @ x, jnp.asarray(b),
                          lambda r: Mj @ r, iters, lmin, lmax)
        out = chebyshev_solve_resid(lambda x, bb: bb - Aq @ x,
                                    torch.from_numpy(b), lambda r: Mq @ r,
                                    iters, f64(lmin), f64(lmax))
    else:
        ref = jcheb(lambda x: Aj @ x, jnp.asarray(b), lambda r: Mj @ r,
                    iters, lmin, lmax)
        out = chebyshev_solve(lambda x: Aq @ x, torch.from_numpy(b),
                              lambda r: Mq @ r, iters, f64(lmin), f64(lmax))
    ref = np.asarray(ref)
    assert out.dtype == torch.float64
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    if iters == 48:
        # and it solves the system
        assert np.abs(A @ ref - b).max() <= 1e-8 * np.abs(b).max()


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_chebyshev_step_matches_reference(problems, interpret_env, precision):
    """One step with eight Chebyshev applications per stage solve on the
    interval estimated on the device, against the reference's: within
    1e-5 of the increment in float64, 1e-4 of it plus 4 float32 ulps of
    the state in the fast mode (tests/test_torch_fast32.py)."""
    jps, jgrid, jops, tops = problems
    u0 = np.array(jops.groom(jnp.asarray(peaked_state(jps, jgrid))))
    kw = dict(ksp_type="chebyshev", ksp_iters=8, precision=precision)
    step_j, _ = jstep(jops, KJ.NumericsOptions(**kw), atol=ATOL, rtol=RTOL)
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0),
                          jnp.asarray(0.1))
    step_t, _ = make_step_fn(tops, NumericsOptions(**kw), atol=ATOL,
                             rtol=RTOL)
    u1, e = step_t(torch.from_numpy(u0), torch.tensor(0.0, dtype=torch.float64),
                   torch.tensor(0.1, dtype=torch.float64))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert inc > 0 and np.isfinite(float(e_ref)) and bool(torch.isfinite(e))
    if precision == "float64":
        bound = 1e-5 * inc
    else:
        bound = 1e-4 * inc + 4 * 2.0 ** -23 * np.abs(u0).max()
    assert np.abs(u1.numpy() - u_ref).max() <= bound
