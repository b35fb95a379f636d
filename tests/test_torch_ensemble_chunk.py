"""The ensemble's adaptive device loop against ksfd_tpu on the CPU.

``EnsembleSolver`` with ``device_loop=True`` and adaptive steps runs the
adaptive chunk for every member in one dispatch per outer iteration
(ksfd_tpu/solvers/ensemble.py:325-346, :473-629).  The port writes the
member axis out: one ``ChunkLadder`` per member and, per attempt, one
vmapped tier step per occupied tier.  Held here:

- per member k, ``snes_failures``, t and h, and u, against the
  reference's ``EnsembleSolver(device_loop=True)``: on its own 1D
  float64-sweep setup (tests/test_ensemble.py:344, 3 members, dt=1,
  tmax=50), u within 1e-9 and t, h to 1e-9 relative; on the 2D bench
  problem at 32^2 with float32 sweeps (2 members, one tier), u within
  1e-5 of max|u - u0| and t, h to 1e-4 relative (the sweeps round apart
  in the last float32 bits, and h compounds them over 20 accepts);
- each member against the port's single-member chunk (bit for bit on
  the CPU, where a batched call runs each member's plain version);
- ``max_accepts`` isolation, the tier-step calls per attempt, the
  GMRES retry of a stuck member with its hysteresis;
- noise: the device loop against the port's own per-step loop, and the
  injection times against the reference's (JAX keys cannot be
  reproduced, so the draws are not compared);
- the straddle case of tests/test_ensemble.py:420 under a time limit.
"""

import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ksfd_tpu import NumericsOptions as JNumerics
from ksfd_tpu.solvers import EnsembleSolver as JEnsemble
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import PDEOperators
from ksfd_tpu_torch.solvers import EnsembleSolver, make_adaptive_chunk_fn
from manufactured import exact_state, make_problem, rho_source_expr

KW1 = dict(t0=0.0, dt=1.0, tmax=50.0, maxsteps=200, rtol=1e-6, atol=0.01)
KW2 = dict(t0=0.0, dt=1e-3, tmax=1e6, maxsteps=20, rtol=1e-6, atol=0.01)
NOISE = ["variance_rate=1e-6", "variance_timing_function=t/4"]
STRADDLE = ["variance_rate=1e-7*Max(0,t-12)", "variance_timing_function=t/4"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def problem_1d(extra=()):
    """(reference ops, port ops, reference grid) of the manufactured
    problem at nx=32."""
    jps, jgrid, jops = make_problem(nx=32, extra_params=list(extra))
    ps, grid, _ = problem_from_clargs(jps.clargs, 32, device="cpu")
    tops = PDEOperators(ps, grid, device="cpu",
                        sources=[rho_source_expr(jps), 0.0, 0.0])
    return jps, jgrid, jops, tops


def members(base, n, seed=42):
    """n distinct perturbations of base (tests/test_ensemble.py)."""
    rng = np.random.default_rng(seed)
    return np.stack([base * (1.0 + 1e-3 * rng.standard_normal(base.shape))
                     for _ in range(n)])


@pytest.fixture(scope="module")
def runs():
    """The reference's and the port's device-loop runs, 1D and 2D."""
    out = {}
    jps, jgrid, jops, tops = problem_1d()
    U0 = members(np.asarray(exact_state(jps, jgrid, 0.0)), 3)
    nm = dict(device_loop=True, sweep_dtype="float64")
    ref = JEnsemble(jops, JNumerics(**nm), **KW1).solve(jnp.asarray(U0))
    es = EnsembleSolver(tops, NumericsOptions(**nm), **KW1)
    calls = []
    es.add_monitor(lambda es, ks, ts, U: calls.append(ks.copy()))
    out["1d"] = (U0, ref, es, es.solve(U0), calls, tops, nm, KW1)
    jps, jgrid, jops = ge._make_problem(32, 32)
    _, _, tops = problem_from_clargs(jps.clargs, 32, 32, device="cpu")
    U0 = members(ge._initial_state(jgrid), 2)
    nm = dict(device_loop=True, ksp_iters_max=0)
    ref = JEnsemble(jops, JNumerics(**nm), **KW2).solve(jnp.asarray(U0))
    es = EnsembleSolver(tops, NumericsOptions(**nm), **KW2)
    calls = []
    es.add_monitor(lambda es, ks, ts, U: calls.append(ks.copy()))
    out["2d"] = (U0, ref, es, es.solve(U0), calls, tops, nm, KW2)
    return out


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_device_loop_matches_reference(runs, case):
    """Per member: k and snes_failures equal, t and h close, u close
    (module docstring)."""
    U0, ref, es, out, _, _, _, _ = runs[case]
    assert es._chunk is not None
    assert not out.diverged.any() and not ref.diverged.any()
    assert (out.k == ref.k).all(), (out.k, ref.k)
    assert (out.snes_failures == ref.snes_failures).all()
    ref_u = np.asarray(ref.u)
    if case == "1d":
        assert (out.t >= KW1["tmax"]).all()
        np.testing.assert_allclose(out.t, ref.t, rtol=1e-9)
        np.testing.assert_allclose(out.h, ref.h, rtol=1e-9)
        np.testing.assert_allclose(out.u.numpy(), ref_u, rtol=1e-9,
                                   atol=1e-9)
    else:
        assert (out.k == KW2["maxsteps"]).all()
        np.testing.assert_allclose(out.t, ref.t, rtol=1e-4)
        np.testing.assert_allclose(out.h, ref.h, rtol=1e-4)
        dev = np.abs(out.u.numpy() - ref_u).max()
        assert dev <= 1e-5 * np.abs(ref_u - U0).max()


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_device_loop_dispatches_per_chunk(runs, case):
    """Far fewer outer iterations (and monitor calls) than accepted
    steps: one dispatch runs a whole chunk."""
    _, _, es, out, calls, _, _, _ = runs[case]
    assert es.iterations == es._chunk.totals.dispatches
    assert len(calls) - 1 <= es.iterations < out.k.max()


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_members_match_single_member_chunks(runs, case):
    """Each member's k, t, h and state equal the port's single-member
    make_adaptive_chunk_fn run of that member from the same start, with
    the ensemble's bounds (max_attempts 128, tmax, maxsteps)."""
    U0, _, es, out, _, tops, nm, kw = runs[case]
    assert es._chunk.totals.dispatches == 1
    chunk, _ = make_adaptive_chunk_fn(tops, NumericsOptions(**nm),
                                      atol=kw["atol"], rtol=kw["rtol"],
                                      max_attempts=128)
    for i in range(len(U0)):
        u0 = tops.groom(torch.from_numpy(U0[i]))
        u, t, h, k, attempts, rejected = chunk(u0, 0.0, kw["dt"],
                                               kw["tmax"], kw["maxsteps"])
        assert (k, t, h) == (out.k[i], out.t[i], out.h[i])
        assert int(es._chunk.last.attempts[i]) == attempts
        assert torch.equal(u, out.u[i])


def test_one_batched_step_per_occupied_tier(runs):
    """Each attempt runs one batched tier step per tier that a live
    member sits on, on exactly those members; the counts match the
    dispatch records."""
    U0, _, _, _, _, tops, nm, kw = runs["1d"]
    es = EnsembleSolver(tops, NumericsOptions(**nm), **kw)
    es._build_steps()
    seen = []
    steps = es._chunk.steps
    for tier, step in enumerate(list(steps)):
        def counted(U, t, h, *rest, _tier=tier, _step=step):
            seen.append((_tier, U.shape[0]))
            return _step(U, t, h, *rest)
        steps[tier] = counted
    out = es.solve(U0)
    last, tot = es._chunk.last, es._chunk.totals
    assert tot.dispatches == 1
    assert [tier for tier, _ in seen] == [t for occ in last.occupied
                                          for t in occ]
    assert tot.occupied == len(seen) == sum(last.calls) == sum(tot.calls)
    # every attempt of every member ran in exactly one batched call
    assert sum(n for _, n in seen) == int(last.attempts.sum()) == tot.attempts
    assert len({tier for tier, _ in seen}) > 1 and (out.t > kw["tmax"]).all()


def test_max_accepts_isolation(runs):
    """A member whose accepts run out stops while the others step: a
    chunk with max_accepts 0 leaves its member untouched, bit for bit;
    and every member stops at maxsteps (tests/test_ensemble.py:374)."""
    U0, _, _, _, _, tops, nm, kw = runs["1d"]
    es = EnsembleSolver(tops, NumericsOptions(**nm), **dict(kw, maxsteps=5,
                                                            tmax=1e9))
    out = es.solve(U0)
    assert (out.k == 5).all() and bool(torch.isfinite(out.u).all())
    U = es._vgroom(torch.from_numpy(U0))
    n = len(U0)
    U1, t, h, k, attempts, rej = es._run_chunk(
        U, np.zeros(n), np.ones(n), np.full(n, 1e9), np.array([0, 3, 1]))
    assert list(k) == [0, 3, 1] and attempts[0] == 0 and t[0] == 0.0
    assert torch.equal(U1[0], U[0]) and not torch.equal(U1[1], U[1])


def test_stuck_member_takes_the_gmres_retry(runs):
    """A member whose chunk exits stuck (a non-finite enorm, here forced
    on an attempt that would have accepted) gets the robust GMRES retry
    at its h: rescued, it parks on the fallback for a probe of min(64,
    2**streak) = 2 accepts, then returns to the chunk; the others never
    leave it."""
    U0, _, _, _, _, tops, nm, kw = runs["1d"]
    es = EnsembleSolver(tops, NumericsOptions(**nm), **dict(kw, maxsteps=6))
    es._build_steps()
    steps = es._chunk.steps
    first = {"left": True}

    def failing(U, t, h, _step=steps[0]):
        # member 0's first attempt that would accept fails instead
        u1, e = _step(U, t, h)
        if first["left"] and U.shape[0] == len(U0) and float(e[0]) <= 1.0:
            first["left"] = False
            e = e.clone()
            e[0] = float("inf")
        return u1, e

    steps[0] = failing
    fb_calls = []
    fb = es._get_fallback()
    es._fallback = lambda u, t, h: fb_calls.append(float(t)) or fb(u, t, h)
    probes = []
    es.add_monitor(lambda es, ks, ts, U: probes.append(
        (es._fbm.copy(), es._fbprobe.copy())))
    out = es.solve(U0)
    assert (out.k == 6).all() and not out.diverged.any()
    assert list(es.rescues) == [1, 0, 0]
    assert probes[1][0].tolist() == [True, False, False]
    assert probes[1][1][0] == 2
    # the rescue and one parked step, then back on the chunk
    assert len(fb_calls) == 2 and not es._fbm.any()


def noise_runs(extra, tmax):
    jps, jgrid, jops, tops = problem_1d(extra)
    base = np.asarray(exact_state(jps, jgrid, 0.0))
    U0 = np.stack([base, base * (1.0 + 1e-3)])
    kw = dict(t0=0.0, dt=1.0, tmax=tmax, maxsteps=100, rtol=1e-6, atol=0.01)
    return jops, tops, U0, kw


def recording(es):
    """Record (member, t) of every injection of es."""
    times = []
    inject = es._inject_noise

    def rec(U, ts, lastvart, accepted, conserve, Nw0):
        U, lv = inject(U, ts, lastvart, accepted, conserve, Nw0)
        times.extend((int(i), float(ts[i]))
                     for i in np.nonzero(lv != lastvart)[0])
        return U, lv

    es._inject_noise = rec
    return times


def by_member(times, n):
    return [[t for i, t in times if i == m] for m in range(n)]


def test_noise_device_loop_matches_per_step_loop():
    """Each member's chunk is bounded at its next injection time, so the
    injections land on the same accepted steps as in the per-step loop
    (same k, t and states: the two loops solve the rejected attempts
    differently, escalation against the GMRES retry, so the states agree
    to 1e-9, not bit for bit) and at the reference's times: the same
    number per member, and the first, before any draw, equal."""
    jops, tops, U0, kw = noise_runs(NOISE, 16.0)
    nm = dict(sweep_dtype="float64")
    outs, times = {}, {}
    for dl in (False, True):
        es = EnsembleSolver(tops, NumericsOptions(device_loop=dl, **nm),
                            rng_key=7, **kw)
        times[dl] = recording(es)
        outs[dl] = es.solve(U0)
    host, dev = outs[False], outs[True]
    assert not dev.diverged.any() and (dev.k == host.k).all()
    np.testing.assert_allclose(dev.t, host.t, rtol=1e-9)
    np.testing.assert_allclose(dev.u.numpy(), host.u.numpy(), rtol=1e-9,
                               atol=1e-9)
    th, td = by_member(times[False], 2), by_member(times[True], 2)
    assert [len(x) for x in td] == [len(x) for x in th]
    assert min(len(x) for x in td) >= 2
    for a, b in zip(td, th):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    import jax

    jes = JEnsemble(jops, JNumerics(**nm), rng_key=jax.random.PRNGKey(7),
                    **kw)
    ref_times = recording(jes)
    jes.solve(jnp.asarray(U0))
    tr = by_member(ref_times, 2)
    assert [len(x) for x in tr] == [len(x) for x in td]
    assert [x[0] for x in tr] == pytest.approx([x[0] for x in td],
                                               rel=1e-12)


def test_noise_straddle_terminates():
    """A member past its injection time while variance_rate is still 0
    cannot advance lastvart, so its chunk bound lies before its t: the
    loop falls through to one accept per dispatch and ends
    (tests/test_ensemble.py:420), matching the per-step loop."""
    _, tops, U0, kw = noise_runs(STRADDLE, 20.0)

    def on_alarm(signum, frame):
        raise TimeoutError("the device loop appears stuck")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(120)
    try:
        dev = EnsembleSolver(
            tops, NumericsOptions(device_loop=True, sweep_dtype="float64"),
            rng_key=7, **kw).solve(U0)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert not dev.diverged.any() and (dev.t > 20.0).all()
    host = EnsembleSolver(tops, NumericsOptions(sweep_dtype="float64"),
                          rng_key=7, **kw).solve(U0)
    assert (dev.k == host.k).all()
    np.testing.assert_allclose(dev.t, host.t, rtol=1e-9)
    np.testing.assert_allclose(dev.u.numpy(), host.u.numpy(), rtol=1e-9,
                               atol=1e-9)
