"""The port's member-batched kernels, GMRES fallback and EnsembleSolver
against the reference on the CPU.

On the CPU a batched kernel call runs its plain version member by
member (ops/fused_stencil.py's vmap rule), so under ``torch.func.vmap``
it equals the per-member calls bit for bit; the member-batched CUDA
bodies (members on blockIdx.z) are compiled as host C++ and held
against single-member runs bit for bit.  ``gmres_solve`` and the
``gmres_scipy`` step are held against ksfd_tpu's (linalg.py:378 and
solver.py:607-615), and ``EnsembleSolver`` against ksfd_tpu's on the
2D bench problem at 32^2 (its Pallas kernels in interpret mode, as
tests/test_ensemble.py runs them).  The mixed-precision sweeps round
apart in the last float32 bits (PyTorch and XLA), so states agree to
1e-5 of the increment and t, h to 1e-6 relative; within the port, the
ensemble equals its members' own runs.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import __graft_entry__ as ge
from ksfd_tpu import NumericsOptions as JNumerics
from ksfd_tpu.solvers import EnsembleSolver as JEnsemble
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import fused_stencil
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    gmres_solve,
    make_multistep_fn,
    make_step_fn,
    shard_members,
)
from ksfd_tpu_torch.tools import probe_coeff_kernel as tprobe
from ksfd_tpu_torch.utils.exceptions import KSFDException
from test_torch_probe import host_kernels, host_run

N = 32
KW = dict(t0=0.0, tmax=1e6, rtol=1e-6, atol=0.01)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def prob():
    """(JAX ops, port ops) of the bench problem at N^2 x 3."""
    jps, _, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return jops, tops


def members(grid, n, scale=1e-3, seed=42):
    """n distinct perturbations of the near-uniform initial state."""
    base = ge._initial_state(grid)
    rng = np.random.default_rng(seed)
    return np.stack([base * (1.0 + scale * rng.standard_normal(base.shape))
                     for _ in range(n)])


def increment(U0, U):
    return float(np.abs(np.asarray(U) - U0).max())


# -- batched kernels ---------------------------------------------------

def batched_args(tops, name, nb, seed=3):
    """Per-member argument tuples of kernel ``name`` for nb members
    (distinct states, tangents, t and shift)."""
    rng = np.random.default_rng(seed)
    kern = make_fused_kernels(tops)
    prepare, _ = tprobe.build_coeff_resid(tops, kern)
    out = []
    for i in range(nb):
        u, v, b = tprobe.probe_state(tops.grid, "cpu", seed=seed + i)
        t = torch.tensor(0.1 * i, dtype=torch.float64)
        shift = torch.tensor(3.0 + i, dtype=torch.float64)
        u64 = tops.groom(u)
        d = torch.from_numpy(100.0 * rng.standard_normal(u.shape))
        u1 = tops.groom(u64 + d)
        out.append(dict(
            rhs=(u.float(), t.float()), jvp=(u.float(), v, t),
            resid=(u.float(), v, b, t, shift),
            delta=(u64, u1 - u64, u1, t),
            coeff_resid=(prepare(u, t), v, b, t, shift),
        )[name])
    return kern, out


@pytest.mark.parametrize("name", ["rhs", "jvp", "resid", "delta",
                                  "coeff_resid"])
def test_batched_plain_kernels_under_vmap_match_members(prob, name):
    """Under torch.func.vmap each kernel (through its custom op's vmap
    rule) equals the per-member calls bit for bit, also with an
    unbatched operand broadcast to the members; on the CPU it launches
    nothing."""
    _, tops = prob
    kern, per = batched_args(tops, name, 3)
    k = getattr(kern, name) if name == "coeff_resid" else kern.kernels[name]
    singles = torch.stack([k(*args) for args in per])
    stacked = [torch.stack(xs) for xs in zip(*per)]
    out = vmap(k)(*stacked)
    assert torch.equal(out, singles)
    # the first operand unbatched: broadcast as pallas_stencil.py:113-118
    in_dims = (None,) + (0,) * (len(stacked) - 1)
    out = vmap(k, in_dims=in_dims)(per[0][0], *stacked[1:])
    ref = torch.stack([k(per[0][0], *args[1:]) for args in per])
    assert torch.equal(out, ref)
    assert k.launches == 0


def test_host_batched_bodies_match_single_members(prob, tmp_path):
    """The member-batched CUDA bodies (members on blockIdx.z, one
    (nb, k) scalar pack row per member), compiled as host C++ with
    nb = 3, equal three single-member runs bit for bit, for each of the
    five 2D kernels."""
    _, tops = prob
    shape = (N, N)
    host = host_kernels(tops, tmp_path)
    if host is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    for name in ("rhs", "jvp", "resid", "delta", "coeff_resid"):
        kern, per = batched_args(tops, name, 3)
        k = getattr(kern, name)
        k = kern.kernels.get(name, k)
        prepared = [k.prepare(*args) for args in per]
        sc_b = torch.stack([p[0] for p in prepared])
        ops_b = [torch.stack(xs) for xs in zip(*[p[1] for p in prepared])]
        out = host_run(host, name, sc_b, ops_b, shape, 3)
        for i, (sc, operands) in enumerate(prepared):
            single = host_run(host, name, sc, operands, shape, 3)
            assert torch.equal(out[i], single), (name, i)
        ref = vmap(k.body)(sc_b, ops_b)
        assert float((out - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), name


@pytest.mark.parametrize("name", ["rhs", "jvp", "resid", "delta"])
def test_3d_batched_plain_kernels_under_vmap_match_members(name):
    """A 3D kernel under torch.func.vmap (through the custom op's vmap
    rule, as the 2D ones) equals the per-member calls bit for bit, also
    with an unbatched first operand broadcast to the members; on the CPU
    it launches nothing."""
    from helpers import make_clargs
    from test_torch_3d import aggregation3d_params, batched_args_3d

    shape = (8, 8, 10)
    _, _, ops3 = problem_from_clargs(
        make_clargs(params=aggregation3d_params(8)), *shape, device="cpu")
    k = make_fused_kernels(ops3).kernels[name]
    per = batched_args_3d(ops3, name, 3, shape)
    singles = torch.stack([k(*args) for args in per])
    stacked = [torch.stack(xs) for xs in zip(*per)]
    assert torch.equal(vmap(k)(*stacked), singles)
    in_dims = (None,) + (0,) * (len(stacked) - 1)
    out = vmap(k, in_dims=in_dims)(per[0][0], *stacked[1:])
    ref = torch.stack([k(per[0][0], *args[1:]) for args in per])
    assert torch.equal(out, ref)
    assert k.launches == 0


# -- GMRES -------------------------------------------------------------

def test_gmres_solve_matches_jax_gmres():
    """gmres_solve on a dense nonsymmetric system with a diagonal
    preconditioner equals jax.scipy's batched GMRES (linalg.py:378) to
    1e-12, in its converged and in its restart-limited regime."""
    rng = np.random.default_rng(0)
    n = 60
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    At, bt, dt_ = (torch.from_numpy(x) for x in (A, b, dinv))
    for tol, restart, maxiter in ((1e-10, 12, 10), (1e-12, 5, 2)):
        ref = np.asarray(jlinalg.gmres_solve(
            lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
            M=lambda x: jnp.asarray(dinv) * x, tol=tol, restart=restart,
            maxiter=maxiter))
        out = gmres_solve(lambda x: At @ x, bt, lambda x: dt_ * x, tol=tol,
                          restart=restart, maxiter=maxiter).numpy()
        assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max(), (
            tol, restart)
    # an exact breakdown (a 3-dimensional Krylov space) stops cleanly
    A3 = np.diag([1.0, 2.0, 3.0] * 20)
    x = gmres_solve(lambda v: torch.from_numpy(A3) @ v, bt,
                    tol=1e-14, restart=8, maxiter=2).numpy()
    assert np.abs(A3 @ x - b).max() < 1e-10


@pytest.mark.parametrize("stage_delta,h,prec", [
    (False, 1e-2, "float64"), (False, 1.0, "float64"),
    (True, 1e-2, "float64"), (False, 1e-2, "float32")])
def test_gmres_scipy_step_matches_reference(prob, interpret, stage_delta,
                                            h, prec):
    """One GMRES step (the fallback's numerics: restart 12, 4 restarts,
    with and without the delta kernel's stage RHS) against the
    reference's on a rough state.  GMRES stops where |M(b - W x)| <=
    tol |b| (the reference's rule), and M ~ W^-1 = (shift - J)^-1, so
    two correct solvers may stop at iterates tol * shift |b| / |x| ~
    tol / (h gamma) apart relative to the increment: 2.3e-6 at h=1e-2,
    and the 1e-8 of the increment at h=1.  The fast mode's step (float32
    GMRES on the jvp kernel's W) is held to the reference's float64 one
    within 1e-4 of the increment, the fast mode's step envelope
    (tests/test_torch_fast32.py): the reference's own fast32 GMRES step
    cannot be built with its Pallas kernels (custom_linear_solve
    transposes the matvec, and the kernels' custom_vmap has no
    transpose rule)."""
    jops, tops = prob
    nm = dict(ksp_type="gmres_scipy", ksp_restart=12, ksp_max_it=4,
              stage_delta=stage_delta)
    u0 = ge._initial_state(tops.grid)
    rng = np.random.default_rng(5)
    u0 = u0 * (1.0 + 0.05 * rng.standard_normal(u0.shape))
    jf, _ = jstep(jops, JNumerics(**nm), atol=0.01, rtol=1e-6)
    nm["precision"] = prec
    u1j, ej = jf(jnp.asarray(u0), 0.0, h)
    tf, tab = make_step_fn(tops, NumericsOptions(**nm), atol=0.01,
                           rtol=1e-6)
    u1, e = tf(torch.from_numpy(u0), torch.tensor(0.0, dtype=torch.float64),
               torch.tensor(h, dtype=torch.float64))
    assert u1.dtype == (torch.float32 if prec == "float32"
                        else torch.float64)
    inc = increment(u0, u1j)
    dev = float(np.abs(u1.double().numpy()
                       - np.asarray(u1j, dtype=np.float64)).max())
    bound = (1e-4 if prec == "float32"
             else 1e-8 * max(1.0, 1.0 / (h * tab.gamma)))
    assert dev <= bound * inc, (dev, inc, bound)
    if prec == "float64":
        assert float(e) == pytest.approx(float(ej), rel=1e-3)


def test_gmres_scipy_refusals(prob):
    """gmres_scipy runs, and so do the fixed-count Krylov solvers since
    they were ported (tests/test_torch_krylov.py); gmres_scipy never
    chains f0."""
    _, tops = prob
    make_step_fn(tops, NumericsOptions(ksp_type="gmres_scipy"))
    make_step_fn(tops, NumericsOptions(ksp_type="gmres_scipy",
                                       stage_delta=False, use_pallas=False))
    for kt in ("gmres", "gmres_rolled", "gmres_restarted"):
        step, _ = make_step_fn(tops, NumericsOptions(ksp_type=kt))
        assert step.build_info["ksp_type"] == kt
    chain, _ = make_step_fn(tops, NumericsOptions(ksp_type="gmres_scipy"),
                            chain_f0=True)
    assert chain is None


# -- EnsembleSolver ----------------------------------------------------

def test_fixed_dt_ensembles_match_reference_and_members(prob, interpret):
    """Fixed-dt ensembles, per step and in 2-step blocks: each member
    within 1e-5 of the increment of the reference's EnsembleSolver, and
    equal to its own single-member port run to 1e-12 (the step and the
    multistep are the same functions, vmapped or not)."""
    jops, tops = prob
    U0 = members(tops.grid, 3)
    kw = dict(KW, dt=1e-2, maxsteps=4)
    ref = JEnsemble(jops, JNumerics(adapt_type="none"), **kw).solve(
        jnp.asarray(U0))
    seen = []
    for block in (1, 2):
        es = EnsembleSolver(tops, NumericsOptions(adapt_type="none"),
                            block_steps=block, **kw)
        es.add_monitor(lambda es, ks, ts, U: seen.append(ks.copy()))
        out = es.solve(U0)
        assert (out.k == 4).all() and np.allclose(out.t, 0.04)
        assert not out.diverged.any() and (out.snes_failures == 0).all()
        inc = increment(U0, ref.u)
        assert float(np.abs(out.u.numpy() - np.asarray(ref.u)).max()) \
            <= 1e-5 * inc
        for i in range(3):
            if block == 1:
                step, _ = make_step_fn(tops, NumericsOptions(
                    adapt_type="none"), atol=0.01, rtol=1e-6)
                u, t = tops.groom(torch.from_numpy(U0[i])), 0.0
                for _ in range(4):
                    u, _ = step(u, torch.tensor(t, dtype=torch.float64),
                                torch.tensor(1e-2, dtype=torch.float64))
                    u = tops.groom(u)
                    t += 1e-2
            else:
                multi, _ = make_multistep_fn(tops, NumericsOptions(
                    adapt_type="none"), atol=0.01, rtol=1e-6)
                u = tops.groom(torch.from_numpy(U0[i]))
                for _ in range(2):
                    u, _, _ = multi(u, torch.tensor(0.0, dtype=torch.float64),
                                    torch.tensor(1e-2, dtype=torch.float64),
                                    2)
                    u = tops.groom(u)
            assert float((out.u[i] - u).abs().max()) <= 1e-12 * inc
    assert [list(k) for k in seen[5:]] == [[0] * 3, [2] * 3, [4] * 3]


#: t, h and u of adaptive runs, port against reference, relative (to
#: t, h and the increment): the embedded error norm is a cancelling sum
#: ~1e-7 of the increments, so the float32 sweeps' last-bit rounding
#: (PyTorch vs XLA) moves it by ~1e-4 relative (tests/test_torch_solver.py
#: allows 1e-2) and every unclipped accept moves h by a quarter of that;
#: 3e-5..5e-5 measured after 5-6 steps
ADAPT_RTOL = 1e-4
#: the same in the float32 fast mode, whose error norm is itself summed
#: in float32: 1.2e-3 measured
ADAPT_RTOL_F32 = 1e-2


def test_adaptive_ensemble_matches_reference(prob, interpret):
    """Adaptive per-step ensembles in both precisions: the same step
    counts and rejections as the reference's, t and h within ADAPT_RTOL
    relative (ADAPT_RTOL_F32 in the fast mode), and each member (f64)
    within ADAPT_RTOL of the increment."""
    jops, tops = prob
    U0 = members(tops.grid, 2)
    kw = dict(KW, dt=1e-3, maxsteps=6)
    for prec, rtol in (("float64", ADAPT_RTOL), ("float32", ADAPT_RTOL_F32)):
        ref = JEnsemble(jops, JNumerics(precision=prec), **kw).solve(
            jnp.asarray(U0))
        out = EnsembleSolver(tops, NumericsOptions(precision=prec),
                             **kw).solve(U0)
        np.testing.assert_array_equal(out.k, ref.k)
        np.testing.assert_array_equal(out.snes_failures, ref.snes_failures)
        np.testing.assert_allclose(out.t, ref.t, rtol=rtol)
        np.testing.assert_allclose(out.h, ref.h, rtol=rtol)
        if prec == "float64":
            assert out.u.dtype == torch.float64
            assert float(np.abs(out.u.numpy() - np.asarray(ref.u)).max()) \
                <= ADAPT_RTOL * increment(U0, ref.u)


def test_members_independent_and_divergence_isolated(prob):
    """A member driven to divergence (an infinite state: every step and
    every float64 fallback retry is non-finite; the port's GMRES returns
    NaN there where the reference's returns its zero start, whose zero
    increment the controller would accept) is flagged after
    max_snes_failures + 1 consecutive failures, its state never
    committed, while the healthy members run to maxsteps exactly as
    they run alone."""
    _, tops = prob
    U0 = members(tops.grid, 3)
    bad = U0.copy()
    bad[1] = np.inf
    nm = NumericsOptions(max_snes_failures=2)
    kw = dict(KW, dt=1e-3, maxsteps=3)
    out = EnsembleSolver(tops, nm, **kw).solve(bad)
    assert list(out.diverged) == [False, True, False]
    assert out.k[1] == 0 and out.snes_failures[1] == 3
    assert (out.k[[0, 2]] == 3).all()
    alone = EnsembleSolver(tops, nm, **kw).solve(U0[[0, 2]])
    assert torch.equal(out.u[[0, 2]], alone.u)
    assert np.array_equal(out.t[[0, 2]], alone.t)
    assert torch.equal(out.u[1], tops.groom(torch.from_numpy(bad[1])))


def _force_pair(step, fb, member=None):
    """(wrapped_step, wrapped_fb): the first step call fails (member 0
    of a vmapped step, or a scalar call), the first fallback call
    accepts with enorm 0.5 (tests/test_ensemble.py:510-539)."""
    st = {"step": True, "fb": True}

    def wstep(u, t, h):
        u1, e = step(u, t, h)
        if st["step"]:
            st["step"] = False
            if member == "jax":
                e = jnp.asarray(e).at[0].set(jnp.inf)
            else:
                e = e.clone()
                e[0] = float("inf")
        return u1, e

    def wfb(u, t, h):
        u1, e = fb(u, t, h)
        if st["fb"]:
            st["fb"] = False
            if member == "jax":
                e = jnp.asarray(e).at[0].set(0.5)
            else:
                e = torch.full_like(e, 0.5)
        return u1, e

    return wstep, wfb


def test_fallback_hysteresis_matches_reference(prob, interpret):
    """The fast step is forced to fail once for member 0 and the robust
    GMRES retry to accept it; both ensembles get the same forcing.  The
    rescued member stays parked on the fallback: the same k,
    snes_failures, _fbm and _fbacc as the reference's, t, h and u within
    ADAPT_RTOL (the fast member's error norms carry the float32 sweeps'
    rounding)."""
    jops, tops = prob
    U0 = members(tops.grid, 2)
    kw = dict(KW, dt=1e-3, maxsteps=5)
    jes = JEnsemble(jops, JNumerics(), **kw)
    jes._build_steps(None)
    jes._vstep, jes._vfallback = _force_pair(jes._vstep,
                                             jes._get_vfallback(), "jax")
    ref = jes.solve(jnp.asarray(U0))
    es = EnsembleSolver(tops, NumericsOptions(), **kw)
    es._build_steps()
    es._vstep, es._fallback = _force_pair(es._vstep, es._get_fallback())
    out = es.solve(U0)
    assert not out.diverged.any()
    np.testing.assert_array_equal(out.k, ref.k)
    np.testing.assert_array_equal(out.snes_failures, ref.snes_failures)
    np.testing.assert_array_equal(es._fbm, jes._fbm)
    np.testing.assert_array_equal(es._fbacc, jes._fbacc)
    assert es._fbm[0] and not es._fbm[1] and es._fbacc[0] == 5
    assert list(es.rescues) == [1, 0]
    np.testing.assert_allclose(out.t, ref.t, rtol=ADAPT_RTOL)
    np.testing.assert_allclose(out.h, ref.h, rtol=ADAPT_RTOL)
    assert float(np.abs(out.u.numpy() - np.asarray(ref.u)).max()) \
        <= ADAPT_RTOL * increment(U0, ref.u)


def _noise_problem(conserve):
    """The bench problem's command line with noise injection on."""
    jps, _, _ = ge._make_problem(N, N)
    ns = argparse.Namespace(**vars(jps.clargs))
    ns.params = list(ns.params) + [
        "variance_rate=1e-6", "variance_timing_function=t/4",
        "conserve_worms=%s" % conserve]
    return ns


def _recording(inject, times, extra=None):
    """Wrap an ensemble's _inject_noise: record (member, t) of each
    injection, and call ``extra(i, U, U1, ts, lastvart, Nw0)``."""
    def record(U, ts, lastvart, accepted, cons, Nw0):
        U1, lv = inject(U, ts, lastvart, accepted, cons, Nw0)
        for i in np.nonzero(np.asarray(lv) != np.asarray(lastvart))[0]:
            times.append((int(i), float(ts[i])))
            if extra is not None:
                extra(i, U, U1, ts, lastvart, Nw0)
        return U1, lv
    return record


@pytest.mark.parametrize("conserve", [False, True])
def test_noise_injection_times_and_statistics(prob, interpret, conserve):
    """With noise active: members that start from the SAME state
    receive different injections; injections land at the reference's
    EnsembleSolver's times (t = 4, 8 with dt = 1 and
    variance_timing_function = t/4); log(rho_new/rho_old) of an
    injection has mean ~0 and the standard deviation sqrt(rate *
    (t - lastvart)); with conserve_worms an injection leaves the worm
    count at its initial value to 1e-12 relative.  (PyTorch generators
    cannot draw JAX's numbers: statistics, not bits.)"""
    from ksfd_tpu import Grid as JGrid
    from ksfd_tpu import SolutionParameters as JParams
    from ksfd_tpu.ops import PDEOperators as JOps

    clargs = _noise_problem(conserve)
    _, _, tops = problem_from_clargs(clargs, N, N, device="cpu")
    base = ge._initial_state(tops.grid)
    U0 = np.stack([base, base])
    kw = dict(KW, dt=1.0, maxsteps=9)
    jops = JOps(JParams(clargs), JGrid(dim=2, width=1.0, height=1.0, nx=N,
                                       ny=N, dof=3, order=3))
    jes = JEnsemble(jops, JNumerics(adapt_type="none"),
                    rng_key=jax.random.PRNGKey(7), **kw)
    ref_times = []
    jes._inject_noise = _recording(jes._inject_noise, ref_times)
    jes.solve(jnp.asarray(U0))
    es = EnsembleSolver(tops, NumericsOptions(adapt_type="none"),
                        rng_key=7, **kw)
    times, ratios, counts = [], [], []

    def stats(i, U, U1, ts, lastvart, Nw0):
        ratios.append((torch.log(U1[i, 0] / U[i, 0]),
                       np.sqrt(1e-6 * (ts[i] - lastvart[i]))))
        counts.append(float(U1[i, 0].sum()) / float(Nw0[i]) - 1.0)

    es._inject_noise = _recording(es._inject_noise, times, stats)
    out = es.solve(U0)
    assert sorted(times) == sorted(ref_times) == [
        (0, 4.0), (0, 8.0), (1, 4.0), (1, 8.0)]
    assert float((out.u[0] - out.u[1]).abs().max()) > 1e-8
    for lr, sd in ratios:
        if conserve:
            lr = lr - lr.mean()
        assert abs(float(lr.mean())) < 4 * sd / np.sqrt(lr.numel())
        assert float(lr.std()) == pytest.approx(sd, rel=0.1)
    if conserve:
        assert max(abs(c) for c in counts) < 1e-12


def test_launch_counts_independent_of_members(prob, monkeypatch):
    """The kernel calls of an ensemble step are the same whatever the
    member count: each vmapped call is one batched call (one launch on
    a card).  Counted at the vmap rule on the CPU."""
    _, tops = prob
    calls = {}
    real = fused_stencil.FusedKernel.run_batched

    def counting(self, sc, operands):
        calls[self.name] = calls.get(self.name, 0) + 1
        return real(self, sc, operands)

    monkeypatch.setattr(fused_stencil.FusedKernel, "run_batched", counting)
    per_n = {}
    for prec in ("float64", "float32"):
        for n in (1, 3):
            calls.clear()
            es = EnsembleSolver(tops, NumericsOptions(
                adapt_type="none", precision=prec), block_steps=2,
                **dict(KW, dt=1e-3, maxsteps=2))
            es.solve(members(tops.grid, n))
            per_n[prec, n] = dict(calls)
    assert per_n["float64", 1] == per_n["float64", 3] == dict(resid=16,
                                                              delta=8)
    assert per_n["float32", 1] == per_n["float32", 3] == dict(rhs=8, jvp=16)


def test_refused_ensembles_raise(prob):
    """Every ensemble the port does not run yet raises naming its
    ROADMAP item; direct solves raise as the reference's do."""
    from helpers import make_clargs
    from test_torch_3d import aggregation3d_params

    _, tops = prob
    _, _, ops3 = problem_from_clargs(
        make_clargs(params=aggregation3d_params(8)), 8, 8, 8, device="cpu")
    # with-G states run since they were ported (their operators'
    # refresh_G after every groom: tests/test_torch_with_g.py), and so do
    # adaptive device-loop ensembles (tests/test_torch_ensemble_chunk.py)
    for ops in (tops, ops3):
        with_g = copy.copy(ops)
        with_g.refresh_G = lambda u, t: u
        assert EnsembleSolver(with_g, NumericsOptions())._vrefresh is not None
        EnsembleSolver(ops, NumericsOptions(device_loop=True))
    # 3D ensembles and pc_pallas ensembles run (in 3D on the basis-GEMM
    # pc: test_pc_pallas_3d_ensemble_takes_the_basis_gemm_pc)
    EnsembleSolver(ops3, NumericsOptions())
    EnsembleSolver(tops, NumericsOptions(pc_pallas=True))
    # device_loop with fixed dt runs no chunk in the reference either
    EnsembleSolver(tops, NumericsOptions(device_loop=True,
                                         adapt_type="none"))
    # members go on ranks (ksfdsolver.py run_ensemble over processes):
    # shard_members keeps a process's members on its one device; an
    # ensemble split over a mesh takes the unfused step
    # (tests/test_torch_mesh_forms.py)
    U = torch.zeros(2, 3, N, N)
    assert shard_members(U) is U
    with pytest.raises(ValueError, match="members on ranks"):
        shard_members(U, devices=["cpu", "cpu"])
    with pytest.raises(KSFDException, match="direct solve"):
        EnsembleSolver(tops, NumericsOptions(ksp_type="lu"))
    es = EnsembleSolver(tops, NumericsOptions(ksp_type="chebyshev"))
    assert es._get_fallback() is None
    assert jax.devices()  # the reference side stays importable


def test_pc_pallas_3d_ensemble_takes_the_basis_gemm_pc(interpret):
    """``pc_pallas`` on a 3D ensemble takes the basis-GEMM pc, as the
    reference's gate (ksfd_tpu/solvers/solver.py:258-282) does, where
    the port raised before: the ensemble builds, makes no fused pc (no
    B5 launch) and records why; a fixed-dt block (2 members, 2 steps at
    h=1e-2 on aggregation3d at 16 x 8 x 16 x 3) is within 1e-5 of the
    increment of the reference's EnsembleSolver with ``pc_pallas`` (the
    f32 sweeps round apart, as in the 3D ensemble tests) and equals the
    port's ensemble without ``pc_pallas`` bit for bit."""
    from test_torch_3d import SHAPE, _problems, wave_state

    jops, tops = _problems(SHAPE)
    base = wave_state()
    rng = np.random.default_rng(42)
    U0 = np.stack([base * (1.0 + 1e-4 * rng.standard_normal(base.shape))
                   for _ in range(2)])
    kw = dict(KW, dt=1e-2, maxsteps=2)
    nm = dict(adapt_type="none", pc_pallas=True)
    es = EnsembleSolver(tops, NumericsOptions(**nm), **kw)
    out = es.solve(U0)
    assert es.fused_pc is None and es.build_info["pc"] == "basis-GEMM"
    assert "3D grid" in es.build_info["pc_pallas_fallback"]
    ref = JEnsemble(jops, JNumerics(**nm), **kw).solve(jnp.asarray(U0))
    plain = EnsembleSolver(tops, NumericsOptions(adapt_type="none"),
                           **kw).solve(U0)
    assert (out.k == 2).all() and not out.diverged.any()
    assert torch.equal(out.u, plain.u)
    assert float(np.abs(out.u.numpy() - np.asarray(ref.u)).max()) \
        <= 1e-5 * increment(U0, ref.u)
