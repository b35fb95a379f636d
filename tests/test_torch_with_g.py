"""The port's with-G states and flux form against ksfd_tpu on the CPU.

``ops/operators_with_g.py`` (``WithGOperators``, ``with_g_grid``: a
state of nligands+2 fields whose last one mirrors G) and
``PDEOperators(flux_form=True)`` (the conservative rho row
``sum_d D1_d(rho dG/dx_d)``, ksfd_tpu/ops/operators.py:225-230).  Held
here, float64 paths to 1e-12 relative:

- with-G: ``rhs`` (a zero G row), ``refresh_G``, ``groom``, ``velocity``,
  ``stiff_coefficients`` and the J-action against the reference's;
  the block pc's shift-only inverse on the trailing field (``nextra``)
  with a float64 pc; a Solver run (tests/test_features.py:29) whose
  physical fields equal the plain run's within 1e-8 and whose G slot
  equals ``ops.G`` of them to 1e-10, and which matches the reference's
  with-G Solver to 1e-8 of the state (float32 sweeps on both sides);
  an ensemble's fixed-dt steps refreshing every member's G slot;
  ``-pc_pallas 1`` on a with-G state taking the basis-GEMM pc (the
  reference's gate falls back there too); the driver's
  ``--with_g`` storing G with every snapshot, and ``io.Solution``
  rebuilding WithGOperators from it;
- the flux form: the RHS and its J-action against the reference's
  (``jax.jvp``), sum(rho) of the RHS zero to roundoff on noise
  (tests/test_operators.py:90), one step against the reference's step
  (the unfused path on both sides), and sum(rho) over a chain of steps
  conserved to roundoff; the driver's ``--flux_form``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
import ksfd_tpu.ops as KJops
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers.linalg import BlockSpectralPreconditioner as JBlock
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch import io as tio
from ksfd_tpu_torch import ksfdsolver as tks
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import PDEOperators, WithGOperators, with_g_grid
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    Solver,
    make_multistep_fn,
    make_step_fn,
)
from ksfd_tpu_torch.solvers.linalg import BlockSpectralPreconditioner
from ksfd_tpu_torch.tools import validate
from manufactured import exact_state as j_exact_state
from manufactured import make_problem as j_make_problem

N = 32
ATOL, RTOL = 0.01, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


def close(got, want, rel=1e-12):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


@pytest.fixture(scope="module")
def problems2d():
    """The 2D options84 problem at 32^2: the reference's and the port's
    plain and with-G operators."""
    jps, jgrid, jops = ge._make_problem(N, N)
    jw = KJops.WithGOperators(jps, KJops.with_g_grid(jgrid))
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    _, tgrid, tw = problem_from_clargs(jps.clargs, N, N, device="cpu",
                                       with_g=True)
    assert tgrid.state() == jw.grid.state() and tgrid.dof == 4
    return jops, jw, tops, tw


def rough_full(seed=0):
    """A rough (4, N, N) with-G state from a numpy seed (its G slot
    noise, as a stale slot would be)."""
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3000 * np.abs(rng.standard_normal((N, N))),
        6000 + 1000 * np.abs(rng.standard_normal((N, N))),
        6000 + 500 * np.abs(rng.standard_normal((N, N))),
        rng.standard_normal((N, N)),
    ])


# -- with-G -----------------------------------------------------------------

def test_with_g_operators_match_reference(problems2d):
    _, jw, _, tw = problems2d
    u = rough_full()
    u[0, :3, :3] = -1.0  # below the floors: groom clamps them
    t = 0.0
    close(tw.rhs(torch.from_numpy(u), t), jw.rhs(jnp.asarray(u), t))
    assert not tw.rhs(torch.from_numpy(u), t)[-1].any()
    close(tw.refresh_G(torch.from_numpy(u), t),
          jw.refresh_G(jnp.asarray(u), t))
    close(tw.groom(torch.from_numpy(u)), jw.groom(jnp.asarray(u)))
    close(tw.velocity(torch.from_numpy(u), t),
          jw.velocity(jnp.asarray(u), t))
    td, ty = tw.stiff_coefficients(t)
    jd, jy = jw.stiff_coefficients(t)
    assert [float(x) for x in td] == [float(x) for x in jd]
    assert [float(x) for x in ty] == [float(x) for x in jy]
    v = np.random.default_rng(1).standard_normal(u.shape)
    ug = np.asarray(jw.groom(jnp.asarray(u)))
    _, jv = jax.jvp(lambda x: jw.rhs(x, t), (jnp.asarray(ug),),
                    (jnp.asarray(v),))
    f0, jvp = tw.linearize(torch.from_numpy(ug), scalar(t))
    close(f0, jw.rhs(jnp.asarray(ug), t))
    close(jvp(torch.from_numpy(v)), jv)
    with pytest.raises(Exception, match="with-G grid needs dof=4"):
        WithGOperators(tw.ps, problems2d[2].grid)


def test_block_pc_shift_only_on_the_trailing_field(problems2d):
    """The block pc's arrow solve on the physical fields and ``c/shift``
    on the G field (linalg.py:269-270), float64 transforms."""
    jops, jw, tops, tw = problems2d
    u = rough_full(seed=2)[:3]
    means = [float(u[i].mean()) for i in range(3)]
    v = np.random.default_rng(3).standard_normal((4, N, N))
    jp = JBlock(jw.grid, jops, compute_dtype="float64")
    ref = jp.apply_linearized(jnp.asarray(v), 2.5, 0.0, means,
                              rho_diff=3.0)
    tp = BlockSpectralPreconditioner(tw.grid, tops, compute_dtype="float64",
                                     device="cpu")
    got = tp.apply_linearized(torch.from_numpy(v), scalar(2.5), scalar(0.0),
                              [scalar(m) for m in means],
                              rho_diff=scalar(3.0))
    close(got, ref)


def test_with_g_solver_matches_plain_and_stores_G():
    """tests/test_features.py:29 on the port, and against the
    reference's with-G Solver."""
    jps, jgrid, _ = j_make_problem(nx=32)
    jw = KJops.WithGOperators(jps, KJops.with_g_grid(jgrid))
    ps, grid, ops = validate.make_problem(nx=32, device="cpu")
    wops = WithGOperators(ps, with_g_grid(grid), sources=ops.sources,
                          device="cpu")
    u_phys = validate.exact_state(grid, 0.0)
    u_full = np.concatenate([u_phys, np.zeros((1, 32))], axis=0)
    kw = dict(t0=0.0, dt=1.0, tmax=1e9, maxsteps=3, rtol=1e-6, atol=0.01)
    nm = NumericsOptions(adapt_type="none", ksp_iters=16)
    up = Solver(ops, nm, **kw).solve(u_phys).numpy()
    s_g = Solver(wops, nm, **kw)
    ug = s_g.solve(u_full).numpy()
    np.testing.assert_allclose(ug[:3], up, rtol=1e-8)
    close(ug[3], wops.G(torch.from_numpy(ug[:3]), s_g.t), rel=1e-10)
    js = JSolver(jw, KJ.NumericsOptions(adapt_type="none", ksp_iters=16),
                 **kw)
    uj = np.asarray(js.solve(jnp.asarray(
        np.concatenate([j_exact_state(jps, jgrid, 0.0),
                        np.zeros((1, 32))]))))
    close(ug, uj, rel=1e-8)


def test_with_g_ensemble_refreshes_every_member(problems2d):
    """EnsembleSolver on with-G states: fixed-dt steps (the unfused
    step, vmapped), each member's G slot equal to ``ops.G`` of its
    fields after the run, and the members equal to the Solver's run
    of each."""
    _, _, _, tw = problems2d
    nm = NumericsOptions(adapt_type="none")
    U0 = np.stack([rough_full(seed=s) for s in (4, 5)])
    kw = dict(t0=0.0, dt=1e-3, tmax=1e9, maxsteps=2, rtol=RTOL, atol=ATOL)
    out = EnsembleSolver(tw, nm, **kw).solve(U0)
    assert (out.k == 2).all() and not out.diverged.any()
    for i in range(2):
        u = out.u[i]
        close(u[-1], tw.G(u[:-1], out.t[i]))
        s = Solver(tw, nm, **kw)
        ui = s.solve(U0[i])
        inc = float((ui - torch.from_numpy(U0[i])).abs()[:-1].max())
        assert float((ui - u).abs().max()) <= 1e-5 * inc


def test_pc_pallas_on_a_with_g_state_takes_the_basis_gemm_pc(problems2d):
    """The reference's gate refuses with-G states (pallas_pc.py:73-74)
    and takes its einsum pc; so does the port, with no raise: the step
    equals the basis-GEMM pc's bit for bit."""
    _, _, _, tw = problems2d
    step, _ = make_step_fn(tw, NumericsOptions(pc_pallas=True), atol=ATOL,
                           rtol=RTOL)
    assert "with-G" in step.build_info["pc_pallas_fallback"]
    assert step.build_info["kernels"] is None
    ref, _ = make_step_fn(tw, NumericsOptions(), atol=ATOL, rtol=RTOL)
    u0 = torch.from_numpy(rough_full(seed=6))
    a, ea = step(u0, scalar(0.0), scalar(1e-3))
    b, eb = ref(u0, scalar(0.0), scalar(1e-3))
    assert torch.equal(a, b) and torch.equal(ea, eb)
    multi, _ = make_multistep_fn(tw, NumericsOptions(pc_pallas=True))
    assert multi.fused_pc is None and multi.kernels is None


COMMON = (
    "tmax=1e6\nwidth=1\nnelements=16\ndim=1\n"
    "degree=3\natol=0.01\nrtol=1e-6\nsigma=0.02357\ns2=sigma**2/2\n"
    "Nworms=0\nsrho0=0\nrho0=9000+100*sin(2*pi*x)\n"
    "ngroups=1\nnligands_1=1\nalpha_1=1500\nbeta_1=5.56e-4\n"
    "s_1_1=0.01\ngamma_1_1=0.01\nD_1_1=1e-6\n"
)
FIXED = "--petsc\n-ts_type rosw\n-ts_adapt_type none\n--\n"


@pytest.fixture
def cpu_driver(monkeypatch):
    import signal

    monkeypatch.setenv("KSFD_PLATFORM", "cpu")
    monkeypatch.delenv("KSFD_NUM_PROCS", raising=False)
    saved = {n: signal.getsignal(getattr(signal, n))
             for n in ("SIGHUP", "SIGINT", "SIGPIPE", "SIGALRM", "SIGTERM",
                       "SIGXCPU", "SIGXFSZ", "SIGVTALRM", "SIGPROF",
                       "SIGUSR1", "SIGUSR2", "SIGQUIT")
             if hasattr(signal, n)}
    yield
    for n, h in saved.items():
        signal.signal(getattr(signal, n), h)


def test_driver_with_g_stores_G(tmp_path, cpu_driver):
    """``--with_g --save``: every snapshot carries G of its fields, and
    ``io.Solution`` rebuilds WithGOperators from the series."""
    pytest.importorskip("h5py")
    opt = tmp_path / "opts"
    opt.write_text("dt=1\nmaxsteps=3\n" + COMMON + FIXED)
    prefix = tmp_path / "G"
    assert tks.main("ksfd_tpu_torch", "@" + str(opt), "--with_g",
                    "--save=" + str(prefix)) == 0
    sol = tio.Solution(str(prefix), device="cpu")
    ops = sol.derivatives
    assert isinstance(ops, WithGOperators) and sol.grid.dof == 3
    times = list(sol.tseries.sorted_times())
    assert len(times) == 4
    for t in times:
        u = torch.from_numpy(sol.tseries.retrieve_by_time(t))
        close(u[-1], ops.G(u[:-1], t), rel=1e-12)
    sol.close()


# -- the flux form ----------------------------------------------------------

@pytest.fixture(scope="module")
def flux2d():
    jps, jgrid, _ = ge._make_problem(N, N)
    jops = KJops.PDEOperators(jps, jgrid, flux_form=True)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu",
                                     flux_form=True)
    return jops, tops


def test_flux_form_rhs_and_jvp_match_reference(flux2d):
    jops, tops = flux2d
    u = rough_full(seed=7)[:3]
    t = 0.0
    close(tops.rhs(torch.from_numpy(u), t), jops.rhs(jnp.asarray(u), t))
    close(tops.dfdt(torch.from_numpy(u)), jops.dfdt(jnp.asarray(u)))
    v = np.random.default_rng(8).standard_normal(u.shape)
    ug = np.asarray(jops.groom(jnp.asarray(u)))
    _, jv = jax.jvp(lambda x: jops.rhs(x, t), (jnp.asarray(ug),),
                    (jnp.asarray(v),))
    f0, jvp = tops.linearize(torch.from_numpy(ug), scalar(t))
    close(f0, jops.rhs(jnp.asarray(ug), t))
    close(jvp(torch.from_numpy(v)), jv)
    close(tops.laplacian_symbol(), jops.laplacian_symbol())


def test_flux_form_conserves_rho_exactly():
    """tests/test_operators.py:90 on the port: sum(rho) of the flux
    form's RHS vanishes to roundoff on a noisy state."""
    from ksfd_tpu_torch.tools.problems import OPTIONS92_PARAMS, make_clargs
    from ksfd_tpu_torch import Grid, SolutionParameters

    ps = SolutionParameters(make_clargs(params=OPTIONS92_PARAMS))
    grid = Grid(dim=1, width=1.0, nx=128, dof=3, order=3)
    ops = PDEOperators(ps, grid, flux_form=True, device="cpu")
    rng = np.random.default_rng(3)
    u = np.full(grid.Vshape, 9000.0) + 90 * rng.standard_normal(grid.Vshape)
    dudt = ops.rhs(torch.from_numpy(u), 0.0)
    total = float(torch.sum(dudt[0]))
    scale = float(torch.sum(torch.abs(dudt[0])))
    assert abs(total) < 1e-11 * max(scale, 1.0)


@pytest.mark.parametrize("change,bound", [
    (dict(sweep_dtype="float64", pc_dtype="float64"), 1e-12),
    (dict(), 1e-5),
], ids=["f64", "mixed"])
def test_flux_form_step_matches_reference(flux2d, change, bound):
    """The kernels refuse the flux form, so both packages take their
    unfused step; float64 sweeps to 1e-12 of the increment, the mixed
    path (W32 from the float32 linearization) within 1e-5."""
    jops, tops = flux2d
    u0 = rough_full(seed=9)[:3]
    h = 1e-2
    jf, _ = jstep(jops, KJ.NumericsOptions(**change), atol=ATOL, rtol=RTOL)
    u_ref, _ = jf(jnp.asarray(u0), 0.0, h)
    step, _ = make_step_fn(tops, NumericsOptions(**change), atol=ATOL,
                           rtol=RTOL)
    assert step.build_info["kernel_refusal"] == "the flux form"
    u1, _ = step(torch.from_numpy(u0), scalar(0.0), scalar(h))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u1.numpy() - u_ref).max() <= bound * inc


@pytest.mark.parametrize("sweeps", ["float64", "float32"])
def test_flux_form_chain_conserves_rho(flux2d, sweeps):
    """sum(rho) over 4 chained flux-form steps is conserved to
    roundoff: each stage's rho row is a divergence and the block pc
    keeps its zero mean.  With float64 sweeps to 1e-13 relative; with
    float32 sweeps to their roundoff, 4 * 2^-23 of sum|rho1 - rho0|."""
    _, tops = flux2d
    u0 = tops.groom(torch.from_numpy(rough_full(seed=10)[:3]))
    multi, _ = make_multistep_fn(tops, NumericsOptions(sweep_dtype=sweeps),
                                 atol=ATOL, rtol=RTOL)
    u, _, e = multi(u0, scalar(0.0), scalar(1e-2), 4)
    s0, s1 = float(u0[0].sum()), float(u[0].sum())
    moved = float((u[0] - u0[0]).abs().sum())
    assert bool(torch.isfinite(e)) and float((u - u0).abs().max()) > 1.0
    bound = 1e-13 * abs(s0) if sweeps == "float64" else 4 * 2.0 ** -23 * moved
    assert abs(s1 - s0) <= bound, (abs(s1 - s0), bound)


def test_driver_flux_form_runs(tmp_path, cpu_driver, capsys):
    opt = tmp_path / "opts"
    opt.write_text("dt=1\nmaxsteps=2\n" + COMMON + FIXED)
    assert tks.main("ksfd_tpu_torch", "@" + str(opt), "--flux_form") == 0
    out = capsys.readouterr().out
    assert "step   2" in out
