"""The port's exact tiers against ksfd_tpu on the CPU.

- ``ksfd_tpu_torch/native/banded.py`` with ``csrc/banded.cpp`` (a byte
  for byte copy of ``ksfd_tpu/native/banded.cpp``, built by g++ into
  the git-ignored ``_build/`` through a file of its own that
  ``os.replace`` puts in place: six first builds at once all succeed);
- ``solvers/banded_path.py`` (the 1D banded step), ``solvers/direct.py``
  (coloured-probe sparse LU at any dimension, its short-axis aliasing
  and verify) and the dense tier of ``make_step_fn``;
- the Solver's exact steps, its LU rescue (engaging, its DOF cap, from
  a stuck chunk, an exception degrading) and ``route_petsc_direct``.

Float64 throughout: states within 1e-12 of max|u| of the reference's,
matrices within 1e-12 of their largest entry.  The reference's own
native library is not loaded here (its in-place build races under
xdist: ROADMAP Queue C), so the banded tier is held against the
reference's dense and sparse-LU tiers, the same exact solve.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ksfd_tpu as KJ
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers import route_petsc_direct as jroute
from ksfd_tpu.solvers.direct import extract_w_sparse as jextract
from ksfd_tpu.solvers.direct import make_sparse_step as jsparse
from ksfd_tpu_torch import Grid, NumericsOptions, SolutionParameters
from ksfd_tpu_torch.native import banded as tbanded
from ksfd_tpu_torch.ops import PDEOperators
from ksfd_tpu_torch.solvers import Solver, make_multistep_fn, make_step_fn
from ksfd_tpu_torch.solvers import banded_path, direct
from ksfd_tpu_torch.solvers.solver import route_petsc_direct
from ksfd_tpu_torch.solvers.steppers import get_tableau
from ksfd_tpu_torch.tools import validate
from helpers import make_clargs
from test_direct import PARAMS_2D, PARAMS_3D, _u0

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-12
ADAPT_REL = 1e-8
ATOL, RTOL = 0.01, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.fixture(scope="module")
def problems():
    """(reference ops, port ops, state) by name: the 1D manufactured
    problem at nx=32, tests/test_direct.py's 2D problem at 16^2 and its
    3D one at 8^3, and the 2D one at 24 x 8 (a short axis)."""
    from manufactured import exact_state, make_problem

    out = {}
    jps, jgrid, jops = make_problem(nx=32)
    _, _, tops = validate.make_problem(nx=32, device="cpu")
    out["1d"] = (jops, tops, np.asarray(exact_state(jps, jgrid, 0.0)))
    for name, params, shape in (("2d", PARAMS_2D, (16, 16)),
                                ("3d", PARAMS_3D, (8, 8, 8)),
                                ("2d-short", PARAMS_2D, (24, 8))):
        clargs = make_clargs(params=params)
        jps = KJ.SolutionParameters(clargs)
        ps = SolutionParameters(clargs)
        kw = dict(dim=len(shape), width=1, height=1, depth=1, dof=2,
                  order=3, **dict(zip(("nx", "ny", "nz"), shape)))
        jgrid = KJ.Grid(**kw)
        jops = KJ.ops.PDEOperators(jps, jgrid)
        tops = PDEOperators(ps, Grid(**kw), device="cpu")
        out[name] = (jops, tops, _u0(jgrid))
    return out


def assert_adaptive_close(s, ref, got, ref_u):
    """An adaptive run's t and h to ADAPT_REL relative and its state to
    ADAPT_REL of max|u|: each accept's h comes from an embedded error
    norm that is a cancelling sum, so the two packages' last-bit
    differences in the stage solutions move it by about 1e-6 relative,
    and h compounds that over the run."""
    assert s.t == pytest.approx(ref.t, rel=ADAPT_REL)
    assert s.h == pytest.approx(ref.h, rel=ADAPT_REL)
    dev = float(np.abs(np.asarray(got) - ref_u).max())
    assert dev <= ADAPT_REL * float(np.abs(ref_u).max()), dev


def assert_state_close(got, ref):
    ref = np.asarray(ref)
    dev = float(np.abs(np.asarray(got) - ref).max())
    assert dev <= REL * float(np.abs(ref).max()), dev


def test_banded_source_is_the_reference_copy():
    """The port compiles its own byte-equal copy of the C++, never a
    source out of the JAX package's tree."""
    with open(os.path.join(ROOT, "ksfd_tpu", "native", "banded.cpp"),
              "rb") as fh:
        ref = fh.read()
    assert tbanded.SOURCE.read_bytes() == ref
    assert str(tbanded.SOURCE).startswith(
        os.path.join(ROOT, "ksfd_tpu_torch", "csrc"))
    assert "_build" in str(tbanded.library_path())


def test_concurrent_first_builds_all_succeed(tmp_path):
    """Six processes build the library into one empty build directory
    at the same moment, as six xdist workers do at collection: each
    must load a whole library and solve."""
    script = textwrap.dedent("""
        import sys, time
        from pathlib import Path
        import numpy as np
        from ksfd_tpu_torch.native import banded
        banded.BUILD_DIR = Path(sys.argv[1])
        while time.time() < float(sys.argv[2]):
            time.sleep(0.001)
        assert banded.native_available()
        A = np.diag(np.full(12, 4.0)) + np.eye(12, k=1) + np.eye(12, k=-11)
        s = banded.CyclicBandedSolver.from_dense_cyclic(A, 1, 1)
        b = np.arange(12.0)
        assert np.abs(s.solve(b) - np.linalg.solve(A, b)).max() < 1e-12
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    start = time.time() + 4.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(tmp_path), repr(start)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert all(o.strip() == "ok" for o, _ in outs)
    libs = list(tmp_path.glob("*/libksfd_banded.so"))
    assert len(libs) == 1
    # no partial build left behind
    assert not list(tmp_path.glob("*/lib.*.so"))


def _cyclic_banded(n, w, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for i in range(n):
        for d in range(-w, w + 1):
            A[i, (i + d) % n] = rng.standard_normal()
        A[i, i] += 2 * w + 5
    return A


@pytest.mark.parametrize("n,w", [(16, 1), (64, 5), (96, 8)])
def test_cyclic_banded_vs_dense(n, w):
    """tests/test_native.py:37 on the port's build."""
    A = _cyclic_banded(n, w)
    solver = tbanded.CyclicBandedSolver.from_dense_cyclic(A, w, w)
    b = np.random.default_rng(1).standard_normal((4, n))
    np.testing.assert_allclose(solver.solve(b), np.linalg.solve(A, b.T).T,
                               atol=1e-11)
    np.testing.assert_allclose(solver.solve(b[0]),
                               np.linalg.solve(A, b[0]), atol=1e-11)
    solver.close()
    band = tbanded.band_storage_from_dense(np.triu(np.tril(A, w), -w), w, w)
    assert band.shape == (3 * w + 1, n)


def test_probe_stride_and_axis_strides():
    from ksfd_tpu.solvers.banded_path import probe_stride as jstride
    from ksfd_tpu.solvers.direct import axis_strides as jaxis

    for n, sw in ((128, 2), (125, 2), (30, 2), (64, 3)):
        assert banded_path.probe_stride(n, sw) == jstride(n, sw)
    for nps, sw in (((128, 128), 2), ((24, 36), 2), ((8, 8), 2),
                    ((125,), 1), ((16, 24, 10), 2)):
        assert direct.axis_strides(nps, sw) == jaxis(nps, sw)
    for nps in ((24, 8), (16, 16), (5, 7, 9)):
        assert direct._cross_offsets(nps, 2) == \
            __import__("ksfd_tpu.solvers.direct", fromlist=["x"]
                       )._cross_offsets(nps, 2)


def reference_w(jops, u, shift, t=0.0):
    """The reference's W = shift*I - J as a dense matrix (jax.jacfwd)."""
    shape = u.shape
    J = jax.jacfwd(lambda v: jops.rhs(v.reshape(shape), t).reshape(-1))(
        jnp.asarray(u).reshape(-1))
    return shift * np.eye(J.shape[0]) - np.asarray(J)


def test_extract_w_band_matches_reference_operator(problems):
    """The probed cyclic band, factored, solves the reference's W
    exactly: its solutions equal numpy's dense solve of the reference's
    matrix."""
    jops, tops, u = problems["1d"]
    shift = 2.3
    w_op, w_batch = direct.w_operator(tops, tops.groom(torch.from_numpy(u)),
                                      0.0, shift)
    grid = tops.grid
    solver = banded_path.extract_w_band(w_op, grid.nx, grid.dof,
                                        grid.stencil_width, w_batch=w_batch)
    W = reference_w(jops, u, shift)
    # the reference's ordering is field-major; the band's interleaved
    perm = np.arange(grid.n_dofs).reshape(grid.dof, grid.nx).T.reshape(-1)
    Wi = W[np.ix_(perm, perm)]
    b = np.random.default_rng(2).standard_normal(grid.n_dofs)
    x = solver.solve(b)
    np.testing.assert_allclose(x, np.linalg.solve(Wi, b), rtol=0,
                               atol=REL * np.abs(x).max())
    np.testing.assert_allclose(Wi @ x, b, rtol=0, atol=1e-10)
    solver.close()


@pytest.mark.parametrize("name", ["2d", "3d", "2d-short"])
def test_extract_w_sparse_matches_reference(problems, name):
    """The port's assembled matrix equals the reference's, entry for
    entry to 1e-12 of the largest; on the short axis (ny = 8 = 4*sw)
    the aliased offsets count once (verify passes)."""
    jops, tops, u = problems[name]
    grid = tops.grid
    shift = 1.7
    _, f_jvp = jax.linearize(lambda uu: jops.rhs(uu, 0.0), jnp.asarray(u))
    A_ref = jextract(lambda v: shift * v - f_jvp(v), grid.nps, grid.dof,
                     grid.stencil_width)
    w_op, w_batch = direct.w_operator(tops, tops.groom(torch.from_numpy(u)),
                                      0.0, shift)
    A = direct.extract_w_sparse(w_op, grid.nps, grid.dof, grid.stencil_width,
                                w_batch=w_batch)
    scale = abs(A_ref).max()
    assert abs(A - A_ref).max() <= REL * scale
    assert A.nnz == A_ref.nnz


def test_extract_w_sparse_verify_refuses_wider_coupling(problems):
    """An operator with a coupling outside the axis cross (a diagonal
    shift) fails verify instead of solving wrong."""
    _, tops, u = problems["2d"]
    grid = tops.grid

    def w_op(v):
        return v + 0.5 * torch.roll(v, shifts=(1, 1), dims=(-2, -1))

    with pytest.raises(Exception, match="axis-cross"):
        direct.extract_w_sparse(w_op, grid.nps, grid.dof, grid.stencil_width)


STEP_CASES = {
    # (problem, port ksp_type, the reference's step it is held to)
    "1d-dense": ("1d", "dense", "dense"),
    "1d-direct": ("1d", "direct", "dense"),
    "1d-banded": ("1d", "banded", "dense"),
    "1d-lu": ("1d", "lu", "lu"),
    "2d-dense": ("2d", "dense", "dense"),
    "2d-lu": ("2d", "lu", "lu"),
    "3d-lu": ("3d", "lu", "lu"),
}


def reference_step(jops, kind):
    if kind == "dense":
        step, _ = jstep(jops, KJ.NumericsOptions(ksp_type="dense"),
                        atol=ATOL, rtol=RTOL)
        return lambda u, t, h: step(jnp.asarray(u), jnp.asarray(t),
                                    jnp.asarray(h))
    return jsparse(jops, KJ.solvers.get_tableau("rosw"), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_exact_step_matches_reference(problems, case):
    """One exact step from the same state: u1 within 1e-12 of max|u1|,
    enorm to 1e-6 relative plus what that deviation moves it (1/atol
    per unit); no kernel namespace is built."""
    name, kt, kind = STEP_CASES[case]
    jops, tops, u = problems[name]
    h = 1.0 if name == "1d" else 0.5
    ref_u, ref_e = reference_step(jops, kind)(u, 0.0, h)
    step, tab = make_step_fn(tops, NumericsOptions(ksp_type=kt), atol=ATOL,
                             rtol=RTOL)
    assert step.build_info["kernels"] is None
    assert step.build_info["ksp_type"] == kt
    u1, e = step(torch.from_numpy(u), scalar(0.0), scalar(h))
    assert u1.dtype == torch.float64 and e.dtype == torch.float64
    assert_state_close(u1.numpy(), ref_u)
    bound = REL * float(np.abs(np.asarray(ref_u)).max())
    assert abs(float(e) - float(ref_e)) <= 1e-6 * float(ref_e) + bound / ATOL
    assert float(np.abs(np.asarray(ref_u) - u).max()) > 100 * bound


def test_exact_tiers_chain_in_the_multistep(problems):
    """make_multistep_fn loops an exact step (no f0 chain): 3 banded
    steps equal 3 dense ones."""
    _, tops, u = problems["1d"]
    outs = {}
    for kt in ("banded", "dense"):
        multi, _ = make_multistep_fn(tops, NumericsOptions(ksp_type=kt),
                                     atol=ATOL, rtol=RTOL)
        assert multi.kernels is None
        outs[kt] = multi(torch.from_numpy(u), scalar(0.0), scalar(1.0), 3)
    assert_state_close(outs["banded"][0].numpy(), outs["dense"][0].numpy())
    assert float(outs["banded"][1]) == float(outs["dense"][1]) == 3.0


def test_solver_lu_adaptive_2d_matches_reference(problems):
    """tests/test_direct.py:120: the Solver runs ksp_type lu adaptively,
    with the reference's accepts, t and h and state."""
    jops, tops, u = problems["2d"]
    kw = dict(t0=0.0, dt=1.0, tmax=20.0, maxsteps=20, rtol=RTOL, atol=ATOL)
    ref = JSolver(jops, KJ.NumericsOptions(ksp_type="lu"), **kw)
    ref_u = np.asarray(ref.solve(jnp.asarray(u)))
    s = Solver(tops, NumericsOptions(ksp_type="lu"), **kw)
    got = s.solve(u)
    assert s.t > 20.0 and s.snes_failures == 0 == ref.snes_failures
    assert (s.k, s.stats.step_attempts) == (ref.k, ref.k)
    assert_adaptive_close(s, ref, got, ref_u)
    assert s.build_info["ksp_type"] == "lu" and s.kernels is None


def sabotage(solver):
    """Every iterative tier of a Solver returns a non-finite error."""
    broken = (lambda u, t, h: (u, jnp.asarray(np.nan))) \
        if isinstance(solver, JSolver) else \
        (lambda u, t, h: (u, scalar(np.nan)))
    solver.step_fn = broken
    solver._fallback_fn = broken


def test_lu_rescue_engages_after_consecutive_failures(problems):
    """tests/test_direct.py:144: with the fast step and the fallback
    broken, the loop escalates to the exact sparse-LU step at the same
    h after LU_RESCUE_AFTER failures and parks there; the counts, t, h
    and the state equal the reference's under the same sabotage."""
    jops, tops, u = problems["2d"]
    kw = dict(t0=0.0, dt=0.5, tmax=100.0, maxsteps=3, rtol=RTOL, atol=ATOL)
    ref = JSolver(jops, KJ.NumericsOptions(), **kw)
    sabotage(ref)
    ref_u = np.asarray(ref.solve(jnp.asarray(u)))
    s = Solver(tops, NumericsOptions(), **kw)
    sabotage(s)
    got = s.solve(u)
    assert s.k == 3 == ref.k and not s.diverged
    assert s.snes_failures == ref.snes_failures
    assert Solver.LU_RESCUE_AFTER - 1 <= s.snes_failures < 3 * (
        Solver.LU_RESCUE_AFTER - 1)
    assert s.stats.exact_rescues == 1 and s.stats.exact_steps == 3
    assert_adaptive_close(s, ref, got.numpy(), ref_u)


def test_lu_rescue_respects_dof_cap(problems, monkeypatch):
    _, tops, _ = problems["2d"]
    s = Solver(tops, NumericsOptions(), t0=0.0, dt=0.5, tmax=100.0,
               maxsteps=1, rtol=RTOL, atol=ATOL)
    assert (Solver.LU_RESCUE_AFTER, Solver.LU_RESCUE_MAX_DOFS) == (
        JSolver.LU_RESCUE_AFTER, JSolver.LU_RESCUE_MAX_DOFS)
    monkeypatch.setattr(Solver, "LU_RESCUE_MAX_DOFS", 10)
    assert s._get_exact_step() is None
    monkeypatch.undo()
    assert s._get_exact_step() is not None
    for kt in ("dense", "banded", "lu"):
        t = Solver(tops if kt != "banded" else problems["1d"][1],
                   NumericsOptions(ksp_type=kt), maxsteps=1)
        assert t._get_exact_step() is None


def test_lu_rescue_reachable_from_the_chunk_without_fallback(problems):
    """tests/test_direct.py:192 with chebyshev (no GMRES fallback; the
    reference's fixed-count gmres is Queue A item 9): a chunk stuck at
    every dispatch escalates to one exact-LU retry at the same h after
    LU_RESCUE_AFTER dispatches, never to diverged."""
    _, tops, u = problems["2d"]
    s = Solver(tops, NumericsOptions(device_loop=True, ksp_type="chebyshev"),
               t0=0.0, dt=0.5, tmax=100.0, maxsteps=2, rtol=RTOL, atol=ATOL)
    assert s._chunk is not None and s._get_fallback() is None
    chunk_calls = []

    def stuck_chunk(u, t, h, tmax_eff, maxacc):
        chunk_calls.append(float(h))
        return u, t, h, 0, 1, True   # zero accepts, rejected

    stuck_chunk.tiers = s._chunk.tiers
    stuck_chunk.stats = SimpleNamespace(
        per_tier=[1] + [0] * (len(s._chunk.tiers) - 1))
    s._chunk = stuck_chunk
    got = s.solve(u)
    assert s.k == 2 and not s.diverged
    assert bool(torch.isfinite(got).all())
    assert len(chunk_calls) == 2 * Solver.LU_RESCUE_AFTER
    # each stuck dispatch shrinks h until the exact retry engages
    assert chunk_calls[1] < chunk_calls[0]
    assert s.stats.exact_steps == 2 and s.stats.dispatches == len(chunk_calls)
    assert s._lu_step is not None


def test_lu_rescue_exception_degrades_not_crashes(problems):
    """tests/test_direct.py:222: an exception in the exact step degrades
    to reject-and-shrink, disables the tier after two, and never
    crashes; the run ends as the reference's does."""
    jops, tops, u = problems["2d"]
    kw = dict(t0=0.0, dt=0.5, tmax=100.0, maxsteps=3, rtol=RTOL,
              atol=ATOL, hmin=1e-6)

    def boom(u, t, h):
        raise RuntimeError("Factor is exactly singular")

    ref = JSolver(jops, KJ.NumericsOptions(), **kw)
    sabotage(ref)
    ref._lu_step = boom
    ref.solve(jnp.asarray(u))
    s = Solver(tops, NumericsOptions(), **kw)
    sabotage(s)
    s._lu_step = boom
    s.solve(u)
    assert s._lu_errors >= 2 and s.k == 0
    assert s.h < 1e-5 or s.diverged
    assert (s._lu_errors, s.snes_failures, s.diverged) == (
        ref._lu_errors, ref.snes_failures, ref.diverged)
    assert s.h == pytest.approx(ref.h, rel=REL)


def test_route_petsc_direct_matches_reference():
    """tests/test_direct.py:253: the same routing decision on each grid,
    and the caps equal to the reference's."""
    for cap in ("PETSC_ROUTE_MAX_DOFS", "BANDED_ROUTE_MAX_DOFS"):
        assert getattr(Solver, cap) == getattr(JSolver, cap)
    grids = [dict(dim=1, width=1, nx=128, dof=3, order=3),
             dict(dim=2, width=1, height=1, nx=24, ny=24, dof=2, order=3),
             dict(dim=2, width=1, height=1, nx=64, ny=64, dof=2, order=3),
             dict(dim=2, width=1, height=1, nx=64, ny=64, dof=3, order=3),
             dict(dim=2, width=1, height=1, nx=512, ny=512, dof=3, order=3),
             dict(dim=1, width=1, nx=16384, dof=3, order=3),
             dict(dim=1, width=1, nx=131072, dof=3, order=3)]
    cases = [dict(petsc_direct=True), dict(petsc_direct=True,
                                           ts_type="arkimex"), dict()]
    for change in cases:
        nm = dataclasses.replace(NumericsOptions(), **change)
        jnm = dataclasses.replace(KJ.NumericsOptions(), **change)
        for g in grids:
            got = route_petsc_direct(nm, Grid(**g)).ksp_type
            assert got == jroute(jnm, KJ.Grid(**g)).ksp_type, (change, g)
    nm = dataclasses.replace(NumericsOptions(), petsc_direct=True)
    assert route_petsc_direct(nm, Grid(**grids[0])).ksp_type == "banded"
    assert route_petsc_direct(nm, Grid(**grids[1])).ksp_type == "lu"


def test_exact_tiers_refused_where_not_ported(problems):
    """The exact tiers on a mesh that is not parallel.grid_mesh's raise
    TypeError naming it (on a mesh they are the replicated host solve:
    tests/test_torch_mesh_solver.py, a 1D and a (2, 2) split in
    tests/test_torch_mesh_splits.py); banded on a 2D grid raises as the
    reference's does."""
    _, tops, _ = problems["2d"]
    with pytest.raises(TypeError, match="grid_mesh"):
        make_step_fn(tops, NumericsOptions(ksp_type="lu"), mesh=object())
    with pytest.raises(Exception, match="1D only"):
        make_step_fn(tops, NumericsOptions(ksp_type="banded"))
    assert get_tableau("rosw").order == 3
