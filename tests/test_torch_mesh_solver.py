"""The port's host Solver on an x-slab mesh against one rank and the
reference.

Gloo ranks on the CPU (tests/torch_mesh_ranks.py, spawned once for the
module, 2 and 4 ranks at once) run ``Solver(ops, ..., mesh=)`` on the
bench problem at 32^2 x 3 (``solver_cases``: the fixed-dt blocks, the
per-step adaptive loop, the device loop's chunk, noise with
conservation, the CFL clamp per step and in the chunk, the forced GMRES
fallback) and single steps (``mesh_steps``: the GMRES tiers, the
unfused step, the exact tiers lu and dense); this process runs the same
through the one-rank Solver and step (no mesh), and the fixed-dt blocks
through the reference's Solver.  The bounds:

- the fixed-dt blocks (``pc_dtype`` float32 pinned, as
  tests/test_torch_sharded.py pins it): 1e-5 of the increment against
  the reference and the one-rank run, the same k and t;
- every run: k, t, h, failures, ``stats`` and the monitor records equal
  on every rank (every decision comes from all-reduced values);
- the adaptive runs: k, the attempts, the rejections and ``stats``
  equal to the one-rank run's, t to 1e-3 relative (an accept's h comes
  from an embedded error norm over float32 sweeps, whose reductions
  the ranks split);
- noise: the normal drawn at the global shape bit-equal to the one-rank
  draw, sum(rho) equal to Nworms to 1e-12 relative after every
  injection;
- the CFL clamp: h equal to the safety factor times the CFL bound where
  it clamps, the same steps clamped as on one rank;
- the GMRES steps and the forced fallback (float64 pc) within 1e-10 of
  max|u| of one rank, gmres_rolled over the float32 sweeps within 1e-5
  of the increment; the unfused step in float64 within 1e-12 of max|u|,
  over the float32 sweeps within 1e-5 of the increment;
- the exact tiers lu and dense (the replicated host solve) bit-equal to
  one rank from the same state.

What the mesh once refused (the flux form, with-G states, the spectral,
no and FFT pcs, a 1D mesh, an ensemble) runs here on a one-rank mesh
without a process group against the unsharded run; the refusal that
stays (a halo-slab kernel under vmap) is checked here too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.grid import Grid
from ksfd_tpu_torch.ops import PDEOperators, WithGOperators, with_g_grid
from ksfd_tpu_torch.parallel import distribute
from ksfd_tpu_torch.parallel.mesh import SlabMesh
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    Solver,
    make_multistep_fn,
    make_step_fn,
    shard_members,
)
from torch_mesh_ranks import (
    CFL_SAFETY_SOLVER,
    H,
    N_SOLVER,
    SOLVER_STEPS,
    mesh_step,
    mesh_steps,
    run_ranks,
    solver_cases,
    solver_problem,
    solver_run,
    solver_start,
)

CASES = {c[0]: c for c in solver_cases()}
STEPS = {s[0]: s for s in mesh_steps()}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks():
    """Each rank's runs and steps, 2 and 4 ranks spawned at once."""
    cases = ["mesh_solver", "mesh_steps"]
    return run_ranks({2: cases, 4: cases}, timeout=300)


_ONE = {}


def one_rank(label):
    """The one-rank (no mesh) Solver run or step of ``label``, with the
    torch.randn draws of a Solver run recorded."""
    if label not in _ONE:
        if label in STEPS:
            _, n, nm = STEPS[label]
            _, _, ops = solver_problem(n)
            _ONE[label] = mesh_step(ops, NumericsOptions(**nm), n)
        else:
            _, extra, nm, kw, start, fail = CASES[label]
            _, _, ops = solver_problem(N_SOLVER, extra)
            draws = []
            randn = torch.randn

            def recorded(*a, **k):
                x = randn(*a, **k)
                draws.append(x.numpy().copy())
                return x
            torch.randn = recorded
            try:
                _ONE[label] = solver_run(
                    ops, NumericsOptions(**nm),
                    solver_start(start, N_SOLVER), fail_first=fail, **kw)
            finally:
                torch.randn = randn
            _ONE[label]["draws"] = draws
    return _ONE[label]


def runs(ranks, n, case, label):
    return [ranks[n][r][case][label] for r in sorted(ranks[n])]


def increment(label, u):
    return float(np.abs(u - solver_start(CASES[label][4], N_SOLVER)).max())


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_solver_block_matches_reference_and_one_rank(ranks, n):
    """The fixed-dt blocks (block_steps=2, 4 steps of H) over n ranks:
    within 1e-5 of the increment of the reference's Solver and of the
    one-rank Solver, the same k and t, two block calls."""
    _, _, nm, kw, start, _ = CASES["block"]
    jps, jgrid, jops = ge._make_problem(N_SOLVER, N_SOLVER)
    u0 = solver_start(start, N_SOLVER)
    js = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    ref = np.asarray(js.solve(jnp.asarray(u0)))
    one = one_rank("block")
    inc = increment("block", ref)
    for got in runs(ranks, n, "mesh_solver", "block"):
        assert (got["k"], got["t"]) == (one["k"], one["t"]) == (
            js.k, js.t) == (SOLVER_STEPS, SOLVER_STEPS * H)
        assert "'step_attempts': 2" in got["stats"]
        assert np.abs(got["u"] - ref).max() <= 1e-5 * inc
        assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * inc
        assert "(%d, 1)" % n in got["info"]


@pytest.mark.parametrize("label", sorted(CASES))
def test_mesh_solver_decisions_equal_on_every_rank(ranks, label):
    """k, t, h, failures, stats and every monitor record (t, h, the CFL
    bound, sum(rho)) are the same on every rank of 2 and of 4."""
    for n in (2, 4):
        first, *rest = runs(ranks, n, "mesh_solver", label)
        for got in rest:
            for key in ("k", "t", "h", "failures", "stats", "records"):
                assert got[key] == first[key], (n, key)
            np.testing.assert_array_equal(got["u"], first["u"])


@pytest.mark.parametrize("label", ["adaptive", "device_loop"])
def test_mesh_solver_adaptive_matches_one_rank(ranks, label):
    """The per-step loop and the device loop (ADAPT_ACCEPTS accepts from
    the rough state): k, attempts, rejections and stats equal to the
    one-rank run's, t to 1e-3 relative."""
    one = one_rank(label)
    for n in (2, 4):
        got = runs(ranks, n, "mesh_solver", label)[0]
        assert (got["k"], got["failures"], got["stats"]) == (
            one["k"], one["failures"], one["stats"])
        assert got["t"] == pytest.approx(one["t"], rel=1e-3)
    if label == "device_loop":
        assert "'dispatches': 1" in one["stats"]
        assert "'chunk_attempts': %d" % one["k"] in one["stats"]
    else:
        assert "'step_attempts': %d" % one["k"] in one["stats"]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_solver_noise_is_the_one_rank_draw(ranks, n):
    """Noise every step (VTF = t, dt = 1) with conservation: each draw,
    at the global shape, bit-equal to the one-rank draw; sum(rho) equal
    to Nworms to 1e-12 relative after each injection; the state within
    1e-5 of the increment."""
    one = one_rank("noise")
    assert len(one["draws"]) == 3
    assert one["draws"][0].shape == (N_SOLVER, N_SOLVER)
    for got in runs(ranks, n, "mesh_solver", "noise"):
        assert "'injections': 3" in got["stats"]
        assert len(got["draws"]) == 3
        for a, b in zip(got["draws"], one["draws"]):
            np.testing.assert_array_equal(a, b)
        nworms = got["records"][0][4]
        for rec in got["records"][1:]:
            assert abs(rec[4] - nworms) <= 1e-12 * nworms
        assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * increment(
            "noise", one["u"])


@pytest.mark.parametrize("label", ["cfl", "cfl_loop"])
def test_mesh_solver_cfl_clamp(ranks, label):
    """CFL_safety_factor clamps h to the factor times the mesh-wide CFL
    bound: per step from the third step, and in the chunk; the same
    steps clamped as on one rank, t to 1e-6 relative."""
    one = one_rank(label)
    for n in (2, 4):
        got = runs(ranks, n, "mesh_solver", label)[0]
        assert got["k"] == one["k"] == SOLVER_STEPS
        assert got["t"] == pytest.approx(one["t"], rel=1e-6)
        clamped = [rec[0] for rec in got["records"][1:]
                   if rec[2] == pytest.approx(CFL_SAFETY_SOLVER * rec[3],
                                              rel=1e-12)]
        want = [rec[0] for rec in one["records"][1:]
                if rec[2] == pytest.approx(CFL_SAFETY_SOLVER * rec[3],
                                           rel=1e-12)]
        assert clamped == want and clamped
        for rec in got["records"][1:]:
            assert rec[2] <= CFL_SAFETY_SOLVER * rec[3] * (1 + 1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_solver_gmres_fallback(ranks, n):
    """A forced failure of the first step: the float64 GMRES fallback
    retries it at the same h and parks; the same fallback steps and
    retries as on one rank, the state within 1e-10 of max|u|."""
    one = one_rank("fallback")
    assert "'fallback_steps': 2" in one["stats"]
    assert "'host_retries': 1" in one["stats"]
    for got in runs(ranks, n, "mesh_solver", "fallback"):
        assert (got["k"], got["stats"]) == (one["k"], one["stats"])
        assert np.abs(got["u"] - one["u"]).max() <= 1e-10 * np.abs(
            one["u"]).max()


@pytest.mark.parametrize("label", ["gmres_scipy", "gmres", "gmres_restarted",
                                   "gmres_rolled", "gmres_rolled_mixed"])
def test_mesh_krylov_steps_match_one_rank(ranks, label):
    """The GMRES tiers on 2 and 4 ranks, their inner products summed
    over the ranks: float64 within 1e-10 of max|u| of one rank and the
    error norm to 1e-8 relative; gmres_rolled over the float32 sweeps
    (the jvp kernel's W, the sharded pc) within 1e-5 of the increment.
    Every rank returns the same error norm."""
    one = one_rank(label)
    u0 = solver_start("rough", N_SOLVER)
    for n in (2, 4):
        outs = runs(ranks, n, "mesh_steps", label)
        assert len({o["enorm"] for o in outs}) == 1
        got = outs[0]
        dev = np.abs(got["u"] - one["u"]).max()
        if label == "gmres_rolled_mixed":
            assert dev <= 1e-5 * np.abs(one["u"] - u0).max()
            assert "'mixed32': True" in got["info"]
        else:
            assert dev <= 1e-10 * np.abs(one["u"]).max()
            assert got["enorm"] == pytest.approx(one["enorm"], rel=1e-8)


@pytest.mark.parametrize("label", ["unfused_f64", "unfused"])
def test_mesh_unfused_step_matches_one_rank(ranks, label):
    """use_pallas=False on a mesh: no kernel, W from the slab's RHS
    linearized with its halo rows.  With float64 sweeps and pc within
    1e-12 of max|u| of one rank, with float32 sweeps within 1e-5 of the
    increment."""
    one = one_rank(label)
    u0 = solver_start("rough", N_SOLVER)
    for n in (2, 4):
        got = runs(ranks, n, "mesh_steps", label)[0]
        assert "'kernels': None" in got["info"]
        assert "'kernel_refusal': 'use_pallas=False'" in got["info"]
        dev = np.abs(got["u"] - one["u"]).max()
        if label == "unfused_f64":
            assert dev <= 1e-12 * np.abs(one["u"]).max()
        else:
            assert dev <= 1e-5 * np.abs(one["u"] - u0).max()


@pytest.mark.parametrize("label", ["lu", "dense"])
def test_mesh_exact_tiers_bit_equal(ranks, label):
    """ksp_type lu and dense on a mesh, the replicated host solve: every
    rank gathers the state, factors and solves alike and keeps its rows;
    the gathered result and the error norm equal one rank's bit for
    bit."""
    one = one_rank(label)
    for n in (2, 4):
        for got in runs(ranks, n, "mesh_steps", label):
            np.testing.assert_array_equal(got["u"], one["u"])
            assert got["enorm"] == one["enorm"]
            assert "replicated" in got["info"]
            assert "(%d, 1)" % n in got["info"]


def test_mesh_shape_refusals(ranks):
    """A y split, once refused, runs: the unfused step (float32 sweeps)
    on the (1, n) mesh within 1e-5 of the increment of one rank, no
    kernel, one error norm on every rank (tests/test_torch_mesh_splits.py
    holds the splits further)."""
    one = one_rank("unfused")
    inc = np.abs(one["u"] - solver_start("rough", N_SOLVER)).max()
    for n in (2, 4):
        outs = [res["mesh_steps"]["y_split"] for res in ranks[n].values()]
        assert len({o["enorm"] for o in outs}) == 1
        assert "'mesh_shape': (1, %d)" % n in outs[0]["info"]
        assert "'kernels': None" in outs[0]["info"]
        assert np.abs(outs[0]["u"] - one["u"]).max() <= 1e-5 * inc


# ------------------------------------------------- build-only, one process


def fake_mesh(grid, n):
    """Rank 0's mesh of an n-way x split without a process group."""
    return SlabMesh(grid, None, (n,) + (1,) * (grid.dim - 1), 0, "gloo",
                    "cpu", ["cpu"] * n)


@pytest.fixture(scope="module")
def port32():
    ps, grid, ops = solver_problem(N_SOLVER)
    return ps, grid, ops


def flux_ops(ps, grid):
    return PDEOperators(ps, grid, flux_form=True, device="cpu")


def with_g_ops(ps, grid):
    return WithGOperators(ps, with_g_grid(grid), device="cpu")


def run_on(build, mesh):
    """The gathered state of ``build(mesh)``'s run from the rough state:
    a step (``("step", ops, numerics)``), a Solver (``("solver", ops,
    numerics)``: 3 fixed steps of H) or an RHS (``("rhs", ops)``)."""
    kind, ops, *nm = build(mesh)
    u0 = solver_start("rough", N_SOLVER) if ops.grid.dim == 2 else \
        np.stack([9000.0 + np.sin(2 * np.pi * np.arange(N_SOLVER)
                                  / N_SOLVER * k) for k in (1, 2, 3)])
    if ops.grid.dof == ops.nligands + 2:
        u0 = np.concatenate([u0, np.zeros((1,) + u0.shape[1:])])
    u = torch.from_numpy(u0)
    if mesh is not None:
        u = distribute(u, ops.grid, mesh)[0]
    if kind == "rhs":
        out = ops.linearize(u, 0.0, mesh=mesh)[0]
    elif kind == "step":
        step, _ = make_step_fn(ops, nm[0], atol=0.01, rtol=1e-6, mesh=mesh)
        out = step(ops.groom(u), torch.zeros((), dtype=torch.float64),
                   torch.full((), H, dtype=torch.float64))[0]
    else:
        s = Solver(ops, nm[0], t0=0.0, dt=H, tmax=1e9, maxsteps=3,
                   rtol=1e-6, atol=0.01, mesh=mesh)
        out = s.solve(u)
    out = out if mesh is None else mesh.gather(out)
    return out.numpy(), u0


FIXED = NumericsOptions(adapt_type="none")
GRID_1D = Grid(dim=1, dof=3, width=1.0, nx=N_SOLVER, order=3)

REFUSALS = {
    "flux_form_step": lambda ps, grid, ops: lambda m: (
        "step", flux_ops(ps, grid), NumericsOptions()),
    "flux_form_solver": lambda ps, grid, ops: lambda m: (
        "solver", flux_ops(ps, grid), FIXED),
    "flux_form_rhs": lambda ps, grid, ops: lambda m: (
        "rhs", flux_ops(ps, grid)),
    "with_g_solver": lambda ps, grid, ops: lambda m: (
        "solver", with_g_ops(ps, grid), FIXED),
    "spectral_pc": lambda ps, grid, ops: lambda m: (
        "step", ops, NumericsOptions(pc_type="spectral")),
    "no_pc": lambda ps, grid, ops: lambda m: (
        "solver", ops, NumericsOptions(pc_type="none", ksp_type="gmres",
                                       adapt_type="none")),
    "fft_pc": lambda ps, grid, ops: lambda m: (
        "solver", ops, NumericsOptions(pc_fft="on", adapt_type="none")),
    "one_d_mesh": lambda ps, grid, ops: lambda m: (
        "rhs", PDEOperators(ps, GRID_1D, device="cpu")),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_mesh_refusals_name_their_item(port32, case):
    """What the mesh once refused (the flux form, with-G states, the
    spectral, no and FFT pcs, a 1D mesh) builds on a 2-rank mesh and
    runs on a one-rank mesh without a process group (its reductions over
    itself, its halo rows its own wrap rows) to the unsharded result:
    the RHS to 1e-12 of its max, a float64-sweep step or Solver to
    rtol=atol=1e-9, float32 sweeps within 1e-5 of the increment.
    tests/test_torch_mesh_forms.py runs each over 2 and 4 ranks."""
    build = REFUSALS[case](*port32)
    _, ops, *nm = build(None)
    fake_mesh(ops.grid, 2)
    if nm:
        make_step_fn(ops, nm[0], mesh=fake_mesh(ops.grid, 2))
    want, u0 = run_on(build, None)
    got, _ = run_on(build, fake_mesh(ops.grid, 1))
    if build(None)[0] == "rhs":
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    elif nm[0].pc_type == "none":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    else:
        inc = np.abs(want - u0).max()
        assert np.abs(got - want).max() <= 1e-5 * inc


def test_ensemble_on_a_slab_mesh_refused(port32):
    """A halo-slab kernel has no member axis (as the reference's): the
    mesh's kernel multistep vmapped over members raises before its halo
    exchange.  ``EnsembleSolver(mesh=)`` takes the unfused step
    instead: two fixed-dt steps of two members on a one-rank mesh
    within 1e-5 of the increment of the one-process unfused
    ensemble."""
    _, grid, ops = port32
    multi, _ = make_multistep_fn(ops, NumericsOptions(),
                                 mesh=fake_mesh(grid, 1))
    assert multi.kernels is not None
    U = torch.from_numpy(np.stack([solver_start("smooth", N_SOLVER)] * 2))
    t = torch.zeros((), dtype=torch.float64)
    h = torch.full((), H, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="no member axis"):
        torch.func.vmap(lambda u: multi(u, t, h, 1)[0])(U)
    U = torch.from_numpy(np.stack([solver_start("rough", N_SOLVER),
                                   solver_start("smooth", N_SOLVER)]))
    kw = dict(t0=0.0, dt=H, tmax=1e9, maxsteps=2, rtol=1e-6, atol=0.01)
    nm = NumericsOptions(adapt_type="none", pc_dtype="float32")
    want = EnsembleSolver(ops, dataclasses.replace(nm, use_pallas=False),
                          **kw).solve(U)
    es = EnsembleSolver(ops, nm, mesh=fake_mesh(grid, 1), **kw)
    got = es.solve(U)
    assert es.build_info["kernels"] is None
    assert list(got.k) == list(want.k) == [2, 2]
    inc = float((want.u - U).abs().max())
    assert float((got.u - want.u).abs().max()) <= 1e-5 * inc


def test_shard_members_places_members_on_one_device():
    """The port puts members on ranks: shard_members keeps a process's
    members on its one device and refuses several devices."""
    U = torch.zeros(2, 3, 8, 8, dtype=torch.float64)
    assert shard_members(U) is U
    assert shard_members(U, devices=["cpu"]).device.type == "cpu"
    with pytest.raises(ValueError, match="members on ranks"):
        shard_members(U, devices=["cpu", "cpu"])


def test_exact_tiers_keep_their_contract_on_a_one_rank_mesh(port32):
    """The replicated exact steps on a one-rank mesh without a group
    equal the one-card steps bit for bit (lu at 32^2) and say so."""
    _, grid, ops = port32
    nm = dataclasses.replace(NumericsOptions(), ksp_type="lu")
    step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6,
                           mesh=fake_mesh(grid, 1))
    assert "replicated" in step.build_info["host"]
    u0 = ops.groom(torch.from_numpy(solver_start("rough", N_SOLVER)))
    args = (torch.zeros((), dtype=torch.float64),
            torch.full((), H, dtype=torch.float64))
    u1, e = step(u0, *args)
    ref = one_rank("lu")
    np.testing.assert_array_equal(u1.numpy(), ref["u"])
    assert float(e) == ref["enorm"]
