"""The port's host Solver against ksfd_tpu's on the CPU.

``ksfd_tpu_torch.solvers.Solver`` beside ``ksfd_tpu.solvers.Solver``:

- the manufactured 1D problem (tests/manufactured.py, nx=64, fixed
  dt=1, 20 steps; tests/test_solver.py:75) through the default step,
  the fixed-dt blocks (``block_steps=4``), dense LU and the banded LU:
  the default and block runs (float32 sweeps) within 1e-5 of the
  increment, the exact tiers within 1e-12 of max|u| (the banded LU held
  to the reference's dense LU, the same exact solve);
- the adaptive loop's k, t and h sequence and its monitors (:153),
  reject and rollback (:169): k and failures equal, t and h to 1e-8
  relative (an accept's h comes from an embedded error norm, a
  cancelling sum that the packages' last bits move by about 1e-6
  relative);
- the GMRES fallback engaging at the same h and its 64-accept re-probe,
  against the reference under the same forced failure;
- the device-loop Solver (the chunk) on the 2D bench problem at 32^2
  with one tier, 8 accepts: k and failures equal, t and h to 1e-4 relative, u
  within 1e-5 of max|u - u0| (tests/test_torch_ensemble_chunk.py's
  bounds for the float32 sweeps); a stuck chunk retried on the host
  with a probe of min(64, 2**streak);
- the CFL clamp, noise with conservation and the variance timing gate
  (tests/test_features.py:74-135); the noise draws (a torch generator:
  JAX's keys cannot be reproduced) held to their statistics, the
  injection times to the variance timing function's, the chunk's
  injections to the per-step loop's, and a run of N + N steps with the
  state restored between them to a run of 2N steps, bit for bit.
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.solvers import Solver
from ksfd_tpu_torch.solvers.solver import history_monitor, print_monitor
from ksfd_tpu_torch.tools import validate
from manufactured import exact_state, make_problem

F64_REL = 1e-12
F32_INC = 1e-5
ADAPT_REL = 1e-8
KW = dict(t0=0.0, dt=1.0, tmax=1e9, rtol=1e-6, atol=0.01)
NOISE = ["variance_rate=1e-4", "variance_timing_function=t"]
#: accepts of the device-loop comparison: h grows fivefold an accept
#: from 1e-3, and past about 100 the float32 sweeps of the two packages
#: part by more than 1e-5 of the increment (the reference's own Solver
#: and EnsembleSolver by 8e-6 at 12 accepts)
DL_STEPS = 8


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_PROBLEMS = {}


def problem(nx, extra=()):
    """(reference ops, port ops, exact start) of the manufactured
    problem, cached per (nx, extra)."""
    key = (nx, tuple(extra))
    if key not in _PROBLEMS:
        jps, jgrid, jops = make_problem(nx=nx, extra_params=list(extra))
        _, _, tops = validate.make_problem(nx=nx, extra_params=list(extra),
                                           device="cpu")
        _PROBLEMS[key] = (jops, tops,
                          np.asarray(exact_state(jps, jgrid, 0.0)))
    return _PROBLEMS[key]


def increment_bound(ref_u, u0):
    return F32_INC * float(np.abs(ref_u - u0).max())


def assert_adaptive_close(s, ref, got, ref_u, rel=ADAPT_REL, bound=None):
    assert (s.k, s.snes_failures, s.diverged) == (
        ref.k, ref.snes_failures, ref.diverged)
    assert s.t == pytest.approx(ref.t, rel=rel)
    assert s.h == pytest.approx(ref.h, rel=rel)
    dev = float(np.abs(got.numpy() - ref_u).max())
    bound = rel * float(np.abs(ref_u).max()) if bound is None else bound
    assert dev <= bound, (dev, bound)


MODES = {
    # name: (port numerics, reference numerics, block_steps, f64)
    "default": (dict(), dict(), 1, False),
    "block4": (dict(), dict(), 4, False),
    "dense": (dict(ksp_type="dense"), dict(ksp_type="dense"), 1, True),
    "banded": (dict(ksp_type="banded"), dict(ksp_type="dense"), 1, True),
}
_REF = {}


@pytest.mark.parametrize("mode", list(MODES))
def test_manufactured_gate_matches_reference(mode):
    """tests/test_solver.py:75 through each mode of both Solvers."""
    tnm, jnm, block, f64 = MODES[mode]
    jops, tops, u0 = problem(64)
    key = (tuple(sorted(jnm.items())), block)
    if key not in _REF:
        js = JSolver(jops, KJ.NumericsOptions(adapt_type="none", **jnm),
                     maxsteps=20, block_steps=block, **KW)
        _REF[key] = (js, np.asarray(js.solve(jnp.asarray(u0))))
    js, ref_u = _REF[key]
    s = Solver(tops, NumericsOptions(adapt_type="none", **tnm), maxsteps=20,
               block_steps=block, **KW)
    u = s.solve(u0)
    assert (s.k, s.t) == (js.k, js.t) == (20, 20.0)
    assert s.stats.step_attempts == 20 // block
    bound = (F64_REL * float(np.abs(ref_u).max()) if f64
             else increment_bound(ref_u, u0))
    assert float(np.abs(u.numpy() - ref_u).max()) <= bound
    err = float(np.abs(u.numpy() - validate.exact_state(tops.grid, 20.0))
                .max())
    assert err < 2e-3, err
    assert s.kernels is None   # 1D: the unfused step or an exact tier


def test_adaptive_sequence_and_monitors():
    """tests/test_solver.py:153: h grows at small error; the monitors
    fire at k = 0..10 with the reference's t and h."""
    jops, tops, u0 = problem(32)
    kw = dict(KW, dt=0.5, maxsteps=10)
    seen = {}
    for name, s in (("ref", JSolver(jops, KJ.NumericsOptions(
            ksp_type="dense"), **kw)),
            ("port", Solver(tops, NumericsOptions(ksp_type="dense"), **kw))):
        seen[name] = []
        s.add_monitor(lambda s_, k, t, u, _l=seen[name]: _l.append(
            (k, t, s_.h)))
        out = s.solve(jnp.asarray(u0) if name == "ref" else u0)
        seen[name + "_s"], seen[name + "_u"] = s, np.asarray(out)
    assert [k for k, _, _ in seen["port"]] == list(range(11))
    assert [k for k, _, _ in seen["ref"]] == list(range(11))
    for (_, t, h), (_, tr, hr) in zip(seen["port"], seen["ref"]):
        assert t == pytest.approx(tr, rel=ADAPT_REL)
        assert h == pytest.approx(hr, rel=ADAPT_REL)
    s = seen["port_s"]
    assert s.h > 0.5 and not s.diverged
    assert_adaptive_close(s, seen["ref_s"], torch.from_numpy(seen["port_u"]),
                          seen["ref_u"])


def test_reject_and_rollback():
    """tests/test_solver.py:169: a huge dt is rejected and cut back."""
    jops, tops, u0 = problem(32)
    kw = dict(KW, dt=5e4, maxsteps=3, rtol=1e-10, atol=1e-8)
    nm = dict(ksp_type="dense", max_snes_failures=100)
    ref = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    ref_u = np.asarray(ref.solve(jnp.asarray(u0)))
    s = Solver(tops, NumericsOptions(**nm), **kw)
    u = s.solve(u0)
    assert s.snes_failures > 0 and s.h < 5e4
    # at rtol 1e-10, atol 1e-8 the error weights are about 1e-6, so the
    # norm carries the stage solutions' last bits 1e4 times larger
    assert_adaptive_close(s, ref, u, ref_u, rel=1e-5)


def fail_first(step):
    """``step`` with its first call's error norm non-finite."""
    calls = []

    def wrapped(u, t, h):
        calls.append(float(h))
        u1, e = step(u, t, h)
        if len(calls) == 1:
            e = e * np.nan
        return u1, e
    wrapped.calls = calls
    return wrapped


def test_fallback_engages_and_reprobes():
    """A failed fast step is retried at the same h on the float64 GMRES
    fallback, which then takes 64 accepts before the fast step is tried
    again; the reference does the same under the same forced failure."""
    jops, tops, u0 = problem(16)
    kw = dict(KW, maxsteps=66)
    nm = dict(adapt_type="none", sweep_dtype="float64")
    ref = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    ref.step_fn = fail_first(ref.step_fn)
    ref_u = np.asarray(ref.solve(jnp.asarray(u0)))
    s = Solver(tops, NumericsOptions(**nm), **kw)
    s.step_fn = fail_first(s.step_fn)
    u = s.solve(u0)
    # the failed attempt, then (after 64 fallback accepts) two fast steps
    assert len(s.step_fn.calls) == len(ref.step_fn.calls) == 3
    assert s.stats.fallback_steps == 64 and s.stats.host_retries == 1
    assert s._fallback_fn is not None and not s._fb_mode
    assert (s.k, s.t, s.snes_failures) == (ref.k, ref.t, 0)
    # GMRES to ksp_rtol 1e-8 in both packages, on different iterates
    inc = float(np.abs(ref_u - u0).max())
    assert float(np.abs(u.numpy() - ref_u).max()) <= 1e-6 * inc


@pytest.fixture(scope="module")
def device_loop_runs():
    """The reference's and the port's device-loop Solver on the 2D bench
    problem at 32^2 from the near-uniform state, one tier."""
    jps, jgrid, jops = ge._make_problem(32, 32)
    _, _, tops = problem_from_clargs(jps.clargs, 32, 32, device="cpu")
    u0 = np.asarray(ge._initial_state(jgrid))
    kw = dict(t0=0.0, dt=1e-3, tmax=1e6, maxsteps=DL_STEPS, rtol=1e-6,
              atol=0.01)
    nm = dict(device_loop=True, ksp_iters_max=0)
    ref = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    ref_u = np.asarray(ref.solve(jnp.asarray(u0)))
    s = Solver(tops, NumericsOptions(**nm), **kw)
    seen = []
    s.add_monitor(lambda s_, k, t, u: seen.append(k))
    u = s.solve(u0)
    return tops, u0, ref, ref_u, s, u, seen, nm, kw


def test_device_loop_matches_reference(device_loop_runs):
    _, u0, ref, ref_u, s, u, seen, _, _ = device_loop_runs
    assert s._chunk is not None and s.k == DL_STEPS
    assert_adaptive_close(s, ref, u, ref_u, rel=1e-4,
                          bound=F32_INC * float(np.abs(ref_u - u0).max()))
    # one dispatch ran the whole run: one monitor call at its exit
    st = s.stats
    assert st.dispatches == 1 and seen == [0, DL_STEPS]
    assert st.chunk_accepts == DL_STEPS and st.step_attempts == 0
    assert st.tier_calls == [st.chunk_attempts]
    assert s.build_info["kernels"] is not None   # the fused kernels


def test_stuck_chunk_takes_the_host_retry(device_loop_runs):
    """A chunk that exits stuck with no accept hands the step to the
    GMRES fallback at its h, parked for min(64, 2**streak) = 2 accepts,
    then the chunk resumes."""
    tops, u0, _, _, _, _, _, nm, kw = device_loop_runs
    s = Solver(tops, NumericsOptions(**nm), **dict(kw, maxsteps=6))
    chunk = s._chunk
    calls = []

    def stuck_once(u, t, h, tmax, max_acc):
        calls.append((t, h, max_acc))
        if len(calls) == 1:
            return u, t, h, 0, 1, True
        return chunk(u, t, h, tmax, max_acc)
    stuck_once.tiers = chunk.tiers
    # the Solver reads the chunk's per-tier record after each dispatch
    stuck_once.stats = SimpleNamespace(per_tier=[1])
    s._chunk = stuck_once
    u = s.solve(u0)
    st = s.stats
    assert st.host_retries == 1 and st.fallback_steps == 2
    assert s.k == 6 and len(calls) == 2 and st.dispatches == 2
    # the chunk resumed after the two fallback accepts, for the rest
    t0, h0, _ = calls[0]
    assert calls[1][2] == 4 and calls[1][0] > t0 + h0
    assert bool(torch.isfinite(u).all())


def test_cfl_clamps_step():
    """tests/test_features.py:74: a tiny CFL safety factor clamps h far
    below dt; CFL_maxh as the reference's."""
    extra = ("CFL_safety_factor=1e-8",)
    jops, tops, u0 = problem(32, extra)
    kw = dict(KW, maxsteps=2)
    ref = JSolver(jops, KJ.NumericsOptions(adapt_type="none",
                                           ksp_type="dense"), **kw)
    ref_u = np.asarray(ref.solve(jnp.asarray(u0)))
    s = Solver(tops, NumericsOptions(adapt_type="none", ksp_type="dense"),
               **kw)
    u = s.solve(u0)
    assert s.CFL_maxh is not None and math.isfinite(s.CFL_maxh)
    assert s.h < 1.0
    assert s.CFL_maxh == pytest.approx(ref.CFL_maxh, rel=1e-9)
    assert_adaptive_close(s, ref, u, ref_u)


def test_noise_injection_and_conservation():
    """tests/test_features.py:93: noise fires every step (VTF = t,
    dt = 1), worms are conserved to 1e-12; without conservation they
    drift.  lastvart as the reference's."""
    jops, tops, u0 = problem(32, tuple(NOISE + ["conserve_worms=True"]))
    nm = dict(adapt_type="none", ksp_iters=16)
    kw = dict(KW, maxsteps=4)
    ref = JSolver(jops, KJ.NumericsOptions(**nm), rng_key=jax.random.PRNGKey(3),
                  **kw)
    ref.solve(jnp.asarray(u0))
    s = Solver(tops, NumericsOptions(**nm), rng_state=3, **kw)
    u = s.solve(u0)
    n0 = float(u0[0].sum())
    assert s.lastvart == ref.lastvart == 4.0
    assert s.stats.injections == 4
    assert float(u[0].sum()) == pytest.approx(n0, rel=1e-12)
    _, tops2, _ = problem(32, tuple(NOISE + ["conserve_worms=False"]))
    s2 = Solver(tops2, NumericsOptions(**nm), rng_state=3, **kw)
    u2 = s2.solve(u0)
    assert float(u2[0].sum()) != pytest.approx(n0, rel=1e-12)


def test_variance_timing_function_gate():
    """tests/test_features.py:119: VTF grows by 3/50 < 1: no injection."""
    extra = ("variance_rate=1e-4", "variance_timing_function=t/50")
    jops, tops, u0 = problem(32, extra)
    nm = dict(adapt_type="none", ksp_iters=12)
    kw = dict(KW, maxsteps=3)
    ref = JSolver(jops, KJ.NumericsOptions(**nm), rng_key=jax.random.PRNGKey(4),
                  **kw)
    ref.solve(jnp.asarray(u0))
    s = Solver(tops, NumericsOptions(**nm), rng_state=4, **kw)
    s.solve(u0)
    assert s.lastvart == ref.lastvart == 0.0 and s.stats.injections == 0


def test_noise_draws_have_the_stated_statistics():
    """add_variance multiplies rho by exp(sd * z), z standard normal
    from the Solver's generator: log(rho1 / rho0) / sd has mean 0 and
    variance 1; the ligands are untouched."""
    _, tops, _ = problem(32, tuple(NOISE))
    s = Solver(tops, NumericsOptions(adapt_type="none"), rng_state=9, **KW)
    u = torch.full((3, 200000), 9000.0, dtype=torch.float64)
    rate, dt = 1e-4, 2.5
    u1 = s.add_variance(u, dt, 1.0)
    z = (torch.log(u1[0] / u[0]) / math.sqrt(rate * dt)).numpy()
    assert abs(z.mean()) < 5 / math.sqrt(z.size)
    assert abs(z.var() - 1.0) < 0.02
    assert torch.equal(u1[1:], u[1:])
    # the stream advanced: the next draw differs, a restart repeats it
    state = s.rng_state
    u2 = s.add_variance(u, dt, 1.0)
    assert not torch.equal(u2, u1)
    s.rng_state = 9
    assert torch.equal(s.add_variance(u, dt, 1.0), u1)
    s.rng_state = state
    assert torch.equal(s.add_variance(u, dt, 1.0), u2)


def test_noisy_run_resumes_bit_for_bit():
    """A noisy run of N steps, its state (u, t, h, k, lastvart and the
    generator's state) carried into a second Solver for N more, equals
    one run of 2N steps bit for bit."""
    _, tops, u0 = problem(32, tuple(NOISE))
    nm = NumericsOptions(ksp_iters=6)
    kw = dict(KW, dt=0.7, rtol=1e-6, atol=0.01)
    whole = Solver(tops, nm, maxsteps=12, rng_state=5, **kw)
    u_whole = whole.solve(u0)
    first = Solver(tops, nm, maxsteps=6, rng_state=5, **kw)
    u_half = first.solve(u0)
    assert first.stats.injections > 0
    second = Solver(tops, nm, maxsteps=12, rng_state=first.rng_state,
                    **dict(kw, t0=first.t, dt=first.h), k0=first.k,
                    lastvart=first.lastvart)
    u_end = second.solve(u_half)
    assert (second.k, second.t, second.h) == (whole.k, whole.t, whole.h)
    assert second.lastvart == whole.lastvart
    assert torch.equal(u_end, u_whole)
    assert torch.equal(second.rng_state, whole.rng_state)


def test_chunk_injects_where_the_step_loop_does():
    """With noise, the device loop bounds each chunk at the next noise
    time: it injects at the same accepted steps as the per-step loop,
    with the same draws (float64 sweeps, one tier: the chunk's attempts
    are the step's)."""
    extra = ("variance_rate=1e-6", "variance_timing_function=t/4")
    _, tops, u0 = problem(32, extra)
    kw = dict(KW, tmax=30.0, maxsteps=200)
    out = {}
    for loop in (False, True):
        nm = NumericsOptions(device_loop=loop, sweep_dtype="float64",
                             ksp_iters_max=0)
        s = Solver(tops, nm, rng_state=2, **kw)
        marks = []
        s.add_monitor(lambda s_, k, t, u, _m=marks: _m.append(s_.lastvart))
        u = s.solve(u0)
        out[loop] = (s, u, sorted(set(marks)))
    (sh, uh, mh), (sc, uc, mc) = out[False], out[True]
    assert sc.stats.dispatches > 0 and sh.stats.dispatches == 0
    assert (sc.k, sc.stats.injections) == (sh.k, sh.stats.injections)
    assert sc.stats.injections >= 6
    assert mc == pytest.approx(mh, rel=1e-12)
    # each injection at the first accept with VTF(t) - VTF(last) >= 1
    vtf = tops.ps.funcs["variance_timing_function"]
    for a, b in zip(mh[:-1], mh[1:]):
        assert float(vtf(b)) - float(vtf(a)) >= 1.0
    assert float(torch.abs(uc - uh).max()) <= 1e-9 * float(uh.abs().max())


def test_monitors_print_and_record(capsys):
    _, tops, u0 = problem(32)
    s = Solver(tops, NumericsOptions(adapt_type="none", ksp_type="dense"),
               maxsteps=2, **KW)
    s.add_monitor(print_monitor)
    s.add_monitor(history_monitor)
    s.solve(u0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and "step   2" in lines[-1] and "CFL=" in lines[0]
    assert [e["step"] for e in s.history] == [0, 1, 2]
    assert isinstance(s.history[-1]["u"], np.ndarray)
    assert s.history[-1]["t"] == 2.0


def test_solver_refusals():
    _, tops, _ = problem(32)
    with pytest.raises(NotImplementedError, match="A14"):
        Solver(tops, NumericsOptions(), mesh=object())
    # the DIRK path runs (tests/test_torch_arkimex.py); the exact host
    # steps refuse its tableaus, as the reference's Solver does
    with pytest.raises(ValueError, match="Rosenbrock tableaus only"):
        Solver(tops, NumericsOptions(ts_type="arkimex", ksp_type="banded"))
    nm = dataclasses.replace(NumericsOptions(), ksp_type="gmres")
    with pytest.raises(NotImplementedError, match="item 9"):
        Solver(tops, nm)


def test_measurement_tools_run_small():
    """tools/validate.py's gate and tools/flagship.py's run through the
    Solver at a small size on the CPU: the gate's error at the
    truncation level, the flagship's counts consistent and its start
    from the seeded ic.start_values."""
    from ksfd_tpu_torch.tools import flagship

    r = validate.run_gate(nx=32, steps=5, device="cpu")
    assert r["steps"] == 5 and r["t"] == 5.0 and r["rel_err"] < 1e-3
    lines = []
    res = flagship.run("aggregation2d", nelements=32, maxsteps=6,
                       device="cpu", out=lines.append)
    assert res["steps"] == 6 and res["finite"] and not res["diverged"]
    assert res["shape"] == [3, 32, 32] and res["aggregates"] >= 1
    assert res["host_reads"] >= res["steps"] and sum(res["tier_calls"]) >= 6
    assert len(lines) == 1 and "6 accepted steps" in lines[0]
    again = flagship.run("aggregation2d", nelements=32, maxsteps=6,
                         device="cpu", out=lines.append)
    assert (again["t"], again["rho_max"]) == (res["t"], res["rho_max"])
    clargs = flagship.example_clargs("aggregation2d", 32)
    assert "width=%.17g" % (4.0 * 32 / 1536) in clargs.params
