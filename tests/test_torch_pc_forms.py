"""The port's other preconditioner forms against ksfd_tpu on the CPU.

The reference's pc has three forms beside the block pc's basis GEMMs
(ksfd_tpu/solvers/linalg.py, solver.py:203-263): the FFT form
(``-pc_fft``: rfftn/irfftn, float32 whatever ``pc_dtype`` asks), the
spectral pc (``-pc_type spectral``: each field's stiff part) and
``-pc_dtype bfloat16`` on one card (bf16 transforms, intermediates and
coefficients, float32 mode arithmetic and inverse output), and
``-pc_type none`` with GMRES.  Held here:

- the FFT block apply in 1D, 2D and 3D and the spectral apply (basis
  and FFT) against the reference's, within 1e-5 of max (float32
  transforms rounding in another order); the single-card bfloat16
  apply within 4 x 2^-8 of max (the bound of the sharded bf16 apply in
  tests/test_torch_parallel.py);
- one step with each form against the reference's step (its Pallas
  kernels in interpret mode, the port's plain versions), within 1e-5 of
  the increment, as tests/test_torch_solver.py holds the default step
  (the bf16 form within 1e-4: its M differs by bf16 rounding, which the
  3 sweeps carry into the stage solutions); ``pc_type`` none with the
  float64 GMRES step within its GMRES envelope
  (tests/test_torch_ensemble.py);
- the gate: ``pc_fft`` auto, ``-pc_pallas 1`` with the FFT pc, the
  FFT and spectral pcs on a mesh (their sharded and gathered applies
  against the one-card step; tests/test_torch_mesh_forms.py over
  ranks), and the Solver and EnsembleSolver with these forms.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.solvers import EnsembleSolver, Solver, make_step_fn
from ksfd_tpu_torch.solvers import linalg as tlinalg
from ksfd_tpu_torch.solvers import solver as tsolver
from ksfd_tpu_torch.tools import validate
from manufactured import make_problem
from test_torch_3d import _problems as problems_3d
from test_torch_sharded import fake_mesh

N = 32
H = 1e-3
ATOL, RTOL = 0.01, 1e-6
GAMMA = 0.435866521508459
BF16_TOL = 4 * 2.0 ** -8


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


@pytest.fixture(scope="module")
def problems():
    """(reference ops, port ops) per dimension: the 1D manufactured
    problem at 32, the 2D options84 problem at 32^2, aggregation3d at
    8 x 4 x 8."""
    _, _, j1 = make_problem(nx=32)
    _, _, t1 = validate.make_problem(nx=32, device="cpu")
    jps, _, j2 = ge._make_problem(N, N)
    _, _, t2 = problem_from_clargs(jps.clargs, N, N, device="cpu")
    j3, t3 = problems_3d((8, 4, 8))
    return {1: (j1, t1), 2: (j2, t2), 3: (j3, t3)}


def rough_state(shape, seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(shape)),
        6000 + scale * np.abs(rng.standard_normal(shape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(shape)),
    ])


def apply_inputs(tops, seed=5):
    """A residual v, the state's float32 statistics, t and shift."""
    shape = tuple(int(n) for n in tops.grid.nps)
    u = rough_state(shape, seed).astype(np.float32)
    v = np.random.default_rng(seed + 1).standard_normal(u.shape)
    dG0 = tops._dG_fns[0](*[torch.from_numpy(x) for x in u],
                          torch.tensor(0.0, dtype=torch.float32))
    return dict(v=v.astype(np.float32),
                means=[float(np.mean(x)) for x in u],
                rho_diff=float(torch.max(torch.from_numpy(u[0]) * dG0)),
                shift=1.0 / (H * GAMMA))


def block_applies(problems, dim, dtype, use_fft):
    """The reference's and the port's block pc applies on one input."""
    jops, tops = problems[dim]
    a = apply_inputs(tops)
    jpc = jlinalg.BlockSpectralPreconditioner(
        jops.grid, jops, compute_dtype=dtype, use_fft=use_fft)
    tpc = tlinalg.BlockSpectralPreconditioner(
        tops.grid, tops, compute_dtype=dtype, device="cpu", use_fft=use_fft)
    ref = np.asarray(jpc.apply_linearized(
        jnp.asarray(a["v"]), a["shift"], jnp.asarray(0.0, jnp.float32),
        [jnp.asarray(m, jnp.float32) for m in a["means"]],
        rho_diff=jnp.asarray(a["rho_diff"], jnp.float32)))
    got = tpc.apply_linearized(
        torch.from_numpy(a["v"]), torch.tensor(a["shift"]),
        torch.tensor(0.0), [torch.tensor(m) for m in a["means"]],
        rho_diff=torch.tensor(a["rho_diff"])).numpy()
    return jpc, tpc, ref, got


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fft_block_apply_matches_reference(problems, dim):
    """The FFT form: lam on the rfft shape equal to the reference's bit
    for bit (float32), the apply within 1e-5 of max; float32 even when
    float64 is asked (the reference's clamp)."""
    for dtype in ("float32", "float64"):
        jpc, tpc, ref, got = block_applies(problems, dim, dtype, True)
        assert tpc.compute_dtype == torch.float32 and tpc.use_fft
        np.testing.assert_array_equal(tpc.lam.numpy(), np.asarray(jpc.lam))
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("use_fft", [False, True], ids=["basis", "fft"])
def test_spectral_apply_matches_reference(problems, use_fft):
    """pc_type spectral: each field's stiff part from
    ``ops.stiff_coefficients``, in its basis-GEMM and FFT forms."""
    jops, tops = problems[2]
    a = apply_inputs(tops, seed=7)
    jpc = jlinalg.SpectralPreconditioner(jops.grid, compute_dtype="float32",
                                         use_fft=use_fft)
    tpc = tlinalg.SpectralPreconditioner(tops.grid, compute_dtype="float32",
                                         device="cpu", use_fft=use_fft)
    jd, jg = jops.stiff_coefficients(0.0)
    td, tg = tops.stiff_coefficients(torch.tensor(0.0, dtype=torch.float64))
    ref = np.asarray(jpc.apply(jnp.asarray(a["v"]), a["shift"], jd, jg))
    got = tpc.apply(torch.from_numpy(a["v"]), a["shift"], td, tg).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_bf16_apply_on_one_card_matches_reference(problems, dim):
    """The single-card bfloat16 apply (Queue C's open item 1, now
    fixed): bf16 bases, operands, forward intermediates and
    coefficients, float32 mode arithmetic, a float32 output, within
    4 x 2^-8 of max of the reference's."""
    _, tpc, ref, got = block_applies(problems, dim, "bfloat16", False)
    assert tpc.Qx.dtype == torch.bfloat16
    assert tpc.compute_dtype == torch.float32 and got.dtype == np.float32
    assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()
    # and it is not the float32 apply: the bf16 rounding shows
    _, _, ref32, _ = block_applies(problems, dim, "float32", False)
    assert np.abs(got - ref32).max() > 1e-4 * np.abs(ref32).max()


@pytest.mark.parametrize("change,tol", [
    (dict(pc_fft="on"), 1e-5),
    (dict(pc_type="spectral"), 1e-5),
    (dict(pc_type="spectral", pc_fft="on"), 1e-5),
    (dict(pc_dtype="bfloat16"), 1e-4),
], ids=["fft", "spectral", "spectral-fft", "bf16"])
def test_step_with_each_form_matches_reference(problems, interpret, change,
                                               tol):
    jops, tops = problems[2]
    u0 = rough_state((N, N), seed=3)
    jf, _ = jstep(jops, KJ.NumericsOptions(**change), atol=ATOL, rtol=RTOL)
    u_ref, e_ref = jf(jnp.asarray(u0), 0.0, H)
    step, _ = make_step_fn(tops, NumericsOptions(**change), atol=ATOL,
                           rtol=RTOL)
    u1, e1 = step(torch.from_numpy(u0), scalar(0.0), scalar(H))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u1.numpy() - u_ref).max() <= tol * inc
    assert np.isfinite(float(e1))


def test_pc_none_gmres_step_matches_reference(problems):
    """pc_type none with the float64 GMRES step (M = None), within the
    GMRES envelope of tests/test_torch_ensemble.py: tol / (h gamma) of
    the increment."""
    jops, tops = problems[2]
    u0 = ge._initial_state(tops.grid)
    u0 = u0 * (1.0 + 0.05 * np.random.default_rng(5).standard_normal(
        u0.shape))
    nm = dict(pc_type="none", ksp_type="gmres_scipy", ksp_restart=12,
              ksp_max_it=4, stage_delta=False, ksp_rtol=1e-10)
    h = 1e-2
    jf, _ = jstep(jops, KJ.NumericsOptions(**nm), atol=ATOL, rtol=RTOL)
    u_ref, e_ref = jf(jnp.asarray(u0), 0.0, h)
    step, _ = make_step_fn(tops, NumericsOptions(**nm), atol=ATOL, rtol=RTOL)
    assert step.build_info["pc"] is None
    u1, e1 = step(torch.from_numpy(u0), scalar(0.0), scalar(h))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u1.numpy() - u_ref).max() <= 1e-10 / (h * GAMMA) * inc
    assert float(e1) == pytest.approx(float(e_ref), rel=1e-2)


def test_pc_none_exact_tier_runs(problems):
    """pc_type none with an exact tier: no pc is built, the step runs."""
    _, tops = problems[1]
    u0 = validate.exact_state(tops.grid, 0.0)
    for ksp in ("dense", "banded"):
        step, _ = make_step_fn(tops, NumericsOptions(pc_type="none",
                                                     ksp_type=ksp))
        u1, e = step(torch.from_numpy(u0), scalar(0.0), scalar(1.0))
        assert bool(torch.isfinite(u1).all()) and np.isfinite(float(e))


@pytest.mark.parametrize("change,match", [
    (dict(pc_type="ilu"), r"pc_type 'ilu'"),
], ids=["change2"])
def test_remaining_refusals(problems, change, match):
    _, tops = problems[2]
    with pytest.raises(NotImplementedError, match=match):
        make_step_fn(tops, NumericsOptions(**change))


@pytest.mark.parametrize("change", [
    dict(pc_type="none"), dict(pc_type="none", ksp_type="chebyshev"),
], ids=["change0", "change1"])
def test_pc_none_sweeps_take_gmres_fixed(problems, change):
    """pc_type none with Richardson or Chebyshev, which
    test_remaining_refusals held raising under these ids until the
    fixed-count Krylov tiers were ported: the stage solves are
    ``gmres_fixed`` of ksp_iters without a pc (solver.py:629-633), one
    finite step (tests/test_torch_krylov.py holds it against the
    reference's)."""
    _, tops = problems[1]
    step, _ = make_step_fn(tops, NumericsOptions(**change))
    assert step.build_info["pc"] is None and not step.build_info["mixed32"]
    u0 = torch.from_numpy(validate.exact_state(tops.grid, 0.0))
    u1, e = step(u0, scalar(0.0), scalar(1.0))
    assert bool(torch.isfinite(u1).all()) and np.isfinite(float(e))


@pytest.mark.parametrize("change", [
    dict(pc_fft="on"), dict(pc_type="spectral"),
    dict(pc_type="spectral", pc_fft="on")], ids=["fft", "spectral",
                                                  "spectral-fft"])
def test_forms_on_a_mesh_raise(problems, change):
    """The FFT and the spectral pcs on a mesh, once refused, build (on a
    2-rank mesh: the sharded spectral apply, one all_reduce, or the
    gathered FFT form, as XLA gathers for the reference) and step on a
    one-rank mesh within 1e-5 of the increment of the one-card step
    (tests/test_torch_mesh_forms.py runs them over 2 and 4 ranks);
    pc_fft auto on a mesh takes the basis form."""
    _, tops = problems[2]
    nm = NumericsOptions(**change)
    step, _ = make_step_fn(tops, nm, mesh=fake_mesh(tops.grid, 2))
    pc = step.build_info["pc"]
    assert pc.startswith("sharded " + (
        "spectral " if change.get("pc_type") == "spectral" else ""))
    assert ("FFT, gathered" in pc) == (change.get("pc_fft") == "on")
    u0 = tops.groom(torch.from_numpy(rough_state((N, N), seed=3)))
    args = (u0, scalar(0.0), scalar(H))
    want = make_step_fn(tops, nm, atol=ATOL, rtol=RTOL)[0](*args)[0]
    got = make_step_fn(tops, nm, atol=ATOL, rtol=RTOL,
                       mesh=fake_mesh(tops.grid, 1))[0](*args)[0]
    inc = float((want - u0).abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * inc
    step, _ = make_step_fn(tops, NumericsOptions(pc_fft="auto"),
                           mesh=fake_mesh(tops.grid, 2))
    assert step.build_info["pc"].startswith("sharded basis-GEMM")


def test_pc_fft_auto_gate(problems, monkeypatch):
    """pc_fft auto: the FFT form without a mesh and with one visible
    device of the state's kind (the reference's ``len(jax.devices()) ==
    1``); on and off as asked."""
    _, tops = problems[2]
    auto = NumericsOptions(pc_fft="auto")
    assert tsolver._pc_fft(auto, tops)
    assert not tsolver._pc_fft(auto, tops, mesh=object())
    card = SimpleNamespace(device="cuda:0")
    for count, want in ((1, True), (2, False)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert tsolver._pc_fft(auto, card) is want
    assert tsolver._pc_fft(NumericsOptions(pc_fft="on"), card)
    assert not tsolver._pc_fft(NumericsOptions(), tops)
    step, _ = make_step_fn(tops, auto)
    assert step.build_info["pc"] == "FFT"


@pytest.mark.parametrize("change,pc,why", [
    (dict(pc_fft="on"), "FFT", "the FFT pc"),
    (dict(pc_type="spectral"), "spectral basis-GEMM", "pc_type spectral"),
], ids=["fft", "spectral"])
def test_pc_pallas_takes_the_unfused_form(change, pc, why):
    """-pc_pallas 1 fuses only the block pc's basis form, as the
    reference's gate (solver.py:258-263): on a 128-aligned 2D grid that
    it would fuse, the FFT and spectral pcs take their own apply, and
    the build says why."""
    jps, _, _ = ge._make_problem(128, 128)
    _, _, tops = problem_from_clargs(jps.clargs, 128, 128, device="cpu")
    nm = NumericsOptions(pc_pallas=True, **change)
    assert not tsolver._reference_fuses(nm, tops)
    step, _ = make_step_fn(tops, nm)
    assert step.build_info["pc"] == pc
    assert why in step.build_info["pc_pallas_fallback"]
    es = EnsembleSolver(tops, dataclasses.replace(nm, adapt_type="none"),
                        dt=H)
    es._build_steps()
    assert es.fused_pc is None and es.build_info["pc"] == pc


def test_solver_and_ensemble_run_the_forms(problems):
    """The host Solver (fixed dt) and the ensemble's fixed-dt blocks with
    each form: the ensemble's members equal their own Solver runs."""
    _, tops = problems[2]
    base = rough_state((N, N), seed=9)
    U0 = np.stack([base, base * 1.001])
    for change in (dict(pc_fft="on"), dict(pc_type="spectral"),
                   dict(pc_dtype="bfloat16")):
        nm = NumericsOptions(adapt_type="none", **change)
        kw = dict(t0=0.0, dt=H, tmax=1e9, maxsteps=2)
        es = EnsembleSolver(tops, nm, block_steps=2, **kw)
        out = es.solve(U0)
        assert (out.k == 2).all() and not out.diverged.any()
        for i in range(2):
            s = Solver(tops, nm, block_steps=2, **kw)
            u = s.solve(U0[i])
            assert s.k == 2
            dev = float((u - out.u[i]).abs().max())
            assert dev <= 1e-9 * float((u - torch.from_numpy(
                U0[i])).abs().max()), (change, dev)
