"""The driver's decomposition and the y and z splits of the mesh.

The split is the reference's: ``grid_mesh`` asks ``mesh_shape_for``
(ksfd_tpu/parallel/mesh.py:33-84) and rank r takes the box at
``np.unravel_index(r, shape)``, as the reference's device array is
reshaped; a split of y or z takes the unfused step (the reference's
``pallas_mesh_ok`` sends it to XLA), the x split keeps B9.

- Gloo ranks on the CPU (tests/torch_mesh_ranks.py, 2 and 4 spawned
  once for the module) on the bench problem at 32^2 split (1, n) and,
  on 4, (2, 2): the layout (boxes, gather, the halo rows along y, the
  padded block equal to the periodic neighbourhood); single steps
  (float32 sweeps with the block pc, float64 sweeps and pc, the fast
  mode, the fixed-count GMRES) against one rank on the same unfused
  path and, for the first two, the reference's unsharded step; the
  Solver's adaptive loop and device loop against one rank; a 3D step
  of aggregation3d at 16^3 split (1, 1, 2) and (1, 2, 2); a mesh that
  would leave ranks idle refused.
- The driver (``python -m ksfd_tpu_torch``) over gloo processes beside
  the reference's driver (ksfdsolver.py, one CPU device per process)
  at the same count: a 24x32 grid over 4 processes, which both split
  (2, 2), and options92 (examples/eigenmode1d cut to 20 steps) over 2
  processes on its 1D mesh.  The slab files have the reference's
  ``/ranges``; the tsmerge'd series of the exact tiers (lu, banded:
  the replicated host solve) are bit-equal to the one-process run, and
  a with-G run with float32 sweeps over 4 processes (the y split's
  unfused step) is within 1e-5 of the increment of it.

Bounds as tests/test_torch_mesh_forms.py's: float64 paths to
``rtol=atol=1e-9``, float32 sweeps within 1e-5 of the increment,
adaptive runs by equal counts (and ``stats`` against one rank) with t,
h and the state within its ``MESH_ADAPT_RTOL``.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from test_torch_distributed import (
    PROBLEM,
    REPO,
    SMOOTH,
    env_of,
    finish,
    free_port,
    launch,
    merged,
    ok,
    series,
)
from test_torch_ensemble import ADAPT_RTOL
from test_torch_mesh_forms import (
    MESH_ADAPT_RTOL,
    hold_reference,
    reference_ops,
)
from torch_mesh_ranks import (
    N_SPLIT,
    N_SPLIT3,
    H,
    collect,
    mesh_step_from,
    rough_state,
    solver_cases,
    solver_problem,
    solver_run,
    solver_start,
    split3_problem,
    split3_step,
    split_shapes,
    split_steps,
    start_ranks,
)

STEPS = dict(split_steps())
#: the 24x32 grid the reference splits (2, 2) over 4 processes
GRID_24X32 = PROBLEM.replace(
    "width=1\nheight=1\nnelements=32\n",
    "width=0.75\nheight=1\nnelements=32\nnwidth=24\nnheight=32\n")
LU = (GRID_24X32 + SMOOTH + "dt=1e-3\nmaxsteps=2\n--petsc\n"
      "-ts_adapt_type none\n-ksp_type preonly\n-pc_type lu\n--\n")
#: its slab files' /ranges: rank r at unravel_index(r, (2, 2))
RANGES_2X2 = [((0, 12), (0, 16)), ((0, 12), (16, 32)), ((12, 24), (0, 16)),
              ((12, 24), (16, 32))]
FIXED = (GRID_24X32 + SMOOTH + "dt=1e-3\nmaxsteps=2\n--numerics\n"
         "-ts_adapt_type none\n-pc_dtype float32\n--\n")


def eigenmode1d_cut(steps):
    """examples/eigenmode1d with ``maxsteps=steps`` and no --save."""
    text = (REPO / "examples" / "eigenmode1d").read_text()
    return text.replace("maxsteps=10000", "maxsteps=%d" % steps).replace(
        "--save=solutions/eigenmode1d\n", "")


def reference_procs(opt, nprocs, *args):
    """The reference's driver over ``nprocs`` coordinated processes, one
    CPU device each (its tests/test_distributed.py launch)."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, str(REPO / "ksfdsolver.py"), "@" + str(opt)]
        + list(args), env=env_of(dict(
            KSFD_NUM_CPU_DEVICES="1", KSFD_COORDINATOR="127.0.0.1:%d" % port,
            KSFD_NUM_PROCS=str(nprocs), KSFD_PROC_ID=str(i))),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nprocs)]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def one_rank_runs():
    """The one-rank runs on the split cases' unfused path, and the
    reference's unsharded mixed and float64 steps, its 3D step and its
    adaptive Solver (its XLA step, which a y split takes)."""
    _, grid, ops = solver_problem(N_SPLIT)
    u0 = ops.groom(torch.from_numpy(rough_state((N_SPLIT, N_SPLIT))))
    one = {label: mesh_step_from(ops, NumericsOptions(use_pallas=False,
                                                      **nm), u0)
           for label, nm in split_steps()}
    cases = {c[0]: c for c in solver_cases()}
    for label in ("adaptive", "device_loop"):
        _, extra, nm, kw, start, fail = cases[label]
        one[label] = solver_run(ops, NumericsOptions(use_pallas=False, **nm),
                                solver_start(start, N_SPLIT),
                                fail_first=fail, **kw)
    one["3d"] = split3_step()
    _, _, jops = ge._make_problem(N_SPLIT, N_SPLIT)
    ju0 = jops.groom(jnp.asarray(rough_state((N_SPLIT, N_SPLIT))))
    ref = {}
    for label in ("mixed", "f64"):
        step, _ = jstep(jops, KJ.NumericsOptions(**STEPS[label]), atol=0.01,
                        rtol=1e-6)
        ref[label] = np.asarray(step(ju0, 0.0, 1e-3)[0])
    ps3, grid3, ops3 = split3_problem()
    jops3 = reference_ops(ps3, grid3)
    step, _ = jstep(jops3, KJ.NumericsOptions(pc_dtype="float32"),
                    atol=0.01, rtol=1e-6)
    u3 = jops3.groom(jnp.asarray(rough_state((N_SPLIT3,) * 3)))
    ref["3d"] = np.asarray(step(u3, 0.0, H)[0])
    _, _, nm, kw, start, _ = cases["adaptive"]
    js = JSolver(jops, KJ.NumericsOptions(use_pallas=False, **nm), **kw)
    u = np.asarray(js.solve(jnp.asarray(solver_start(start, N_SPLIT))))
    ref["adaptive"] = dict(u=u, k=js.k, t=float(js.t), h=float(js.h),
                           failures=js.snes_failures)
    return one, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The drivers (subprocesses) and the ranks started at once; the
    one-rank and reference runs here meanwhile."""
    d = tmp_path_factory.mktemp("splits")
    for name, text in (("lu", LU), ("fixed", FIXED),
                       ("eig", eigenmode1d_cut(20))):
        (d / name).write_text(text)
    started = {
        "lu1": launch(d / "lu", 1, "--save=%s" % (d / "lu1")),
        "lu4": launch(d / "lu", 4, "--save=%s" % (d / "lu4")),
        "jlu4": reference_procs(d / "lu", 4, "--save=%s" % (d / "jlu4")),
        "eig1": launch(d / "eig", 1, "--save=%s" % (d / "eig1")),
        "eig2": launch(d / "eig", 2, "--save=%s" % (d / "eig2")),
        "jeig2": reference_procs(d / "eig", 2, "--save=%s" % (d / "jeig2")),
        "withg1": launch(d / "fixed", 1, "--with_g",
                         "--save=%s" % (d / "withg1")),
        "withg4": launch(d / "fixed", 4, "--with_g",
                         "--save=%s" % (d / "withg4")),
    }
    handle = start_ranks({2: ["split_layout", "split_steps"],
                          4: ["split_layout", "split_steps"]})
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, ref = one_rank_runs()
    finally:
        torch.set_num_threads(prev)
    ranks = collect(handle, timeout=300)
    res = {name: finish(procs) for name, procs in started.items()}
    return dict(dir=d, res=res, ranks=ranks, one=one, ref=ref)


def per_rank(runs, n, case):
    return [runs["ranks"][n][r][case] for r in sorted(runs["ranks"][n])]


@pytest.mark.parametrize("n", [2, 4])
def test_split_layout(runs, n):
    """Each rank's box is the reference's (rank r at unravel_index(r,
    shape)); distribute/global_from_local give its block, gather the
    global state, the halo rows along y are the y-neighbours' with the
    ring closed, and the block padded along each split axis (corners
    included; an unsplit x is not padded, the roll wraps it) equals the
    periodic neighbourhood of the global state."""
    u = rough_state((N_SPLIT, N_SPLIT), seed=3)
    sw = 2
    for r, res in enumerate(per_rank(runs, n, "split_layout")):
        for shape in split_shapes(n)[0]:
            out = res[shape]
            coords = np.unravel_index(r, shape)
            ext = [N_SPLIT // s for s in shape]
            box = tuple((c * e, (c + 1) * e) for c, e in zip(coords, ext))
            assert out["box"] == out["pbox"] == box
            assert out["coords"] == tuple(int(c) for c in coords)
            (x0, x1), (y0, y1) = box
            np.testing.assert_array_equal(out["slab"], u[:, x0:x1, y0:y1])
            np.testing.assert_array_equal(out["gathered"], u)
            assert out["from_full"] and out["contiguous"]
            assert out["spec"] == (None, "x", "y")
            block = u[:, x0:x1]
            np.testing.assert_array_equal(
                out["lo"], block[:, :, np.arange(y0 - sw, y0) % N_SPLIT])
            np.testing.assert_array_equal(
                out["hi"], block[:, :, np.arange(y1, y1 + sw) % N_SPLIT])
            xw, yw = (sw if s > 1 else 0 for s in shape)
            xs = np.arange(x0 - xw, x1 + xw) % N_SPLIT
            ys = np.arange(y0 - yw, y1 + yw) % N_SPLIT
            np.testing.assert_array_equal(out["padded"], u[:, xs][:, :, ys])


@pytest.mark.parametrize("label", sorted(STEPS))
def test_split_steps_match_one_rank(runs, label):
    """Each step on the y splits (1, 2), (1, 4)... and (2, 2): no kernel
    (the gate's mesh refusal, pallas_mesh_ok), one error norm on every
    rank; float64 sweeps and the fixed-count GMRES to rtol=atol=1e-9 of
    the one-rank unfused step, float32 sweeps within 1e-5 of its
    increment (the fast mode's float32 state: 1e-4 of the increment
    plus 4 float32 ulps, tests/test_torch_fast32.py's bound); the mixed
    and float64 steps also against the reference's unsharded step."""
    one = runs["one"][label]
    u0 = rough_state((N_SPLIT, N_SPLIT))
    inc = np.abs(one["u"] - u0).max()
    for n in (2, 4):
        for shape in split_shapes(n)[0]:
            outs = [res[(shape, label)]
                    for res in per_rank(runs, n, "split_steps")]
            assert len({o["enorm"] for o in outs}) == 1
            got = outs[0]
            assert "'kernels': None" in got["info"]
            assert "pallas_mesh_ok" in got["info"]
            assert "'mesh_shape': %s" % (shape,) in got["info"]
            if label in ("f64", "gmres"):
                np.testing.assert_allclose(got["u"], one["u"], rtol=1e-9,
                                           atol=1e-9)
            elif label == "fast32":
                # a float32 state: tests/test_torch_fast32.py's bound
                assert np.abs(got["u"] - one["u"]).max() <= (
                    1e-4 * inc + 4 * np.finfo(np.float32).eps
                    * np.abs(u0).max())
            else:
                assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * inc
            if label == "f64":
                np.testing.assert_allclose(got["u"], runs["ref"]["f64"],
                                           rtol=1e-9, atol=1e-9)
            elif label == "mixed":
                ref = runs["ref"]["mixed"]
                assert np.abs(got["u"] - ref).max() <= 1e-5 * np.abs(
                    ref - u0).max()


@pytest.mark.parametrize("label", ["adaptive", "device_loop"])
def test_split_solver_matches_one_rank(runs, label):
    """The Solver's per-step adaptive loop and device loop on the y
    split: k, failures, stats and the monitor records equal on every
    rank; k, failures and stats equal to one rank's, t within
    MESH_ADAPT_RTOL; both held against the reference's per-step Solver
    on its XLA step (``hold_reference``: the same k and failures, t, h
    and the state within MESH_ADAPT_RTOL)."""
    one = runs["one"][label]
    u0 = solver_start({c[0]: c for c in solver_cases()}[label][4], N_SPLIT)
    for n in (2, 4):
        outs = [res[label] for res in per_rank(runs, n, "split_steps")]
        for got in outs:
            for key in ("k", "t", "h", "failures", "stats", "records"):
                assert got[key] == outs[0][key], (n, key)
        got = outs[0]
        assert (got["k"], got["failures"], got["stats"]) == (
            one["k"], one["failures"], one["stats"])
        assert got["t"] == pytest.approx(one["t"], rel=MESH_ADAPT_RTOL)
        hold_reference(got, runs["ref"]["adaptive"], u0, adaptive=True)


def test_split_3d_step(runs):
    """aggregation3d at 16^3 split (1, 1, 2) over 2 ranks and (1, 2, 2)
    over 4: the unfused mixed step within 1e-5 of the increment of one
    rank and of the reference's unsharded step, one error norm on every
    rank."""
    one = runs["one"]["3d"]
    u0 = rough_state((N_SPLIT3,) * 3)
    inc = np.abs(one["u"] - u0).max()
    for n in (2, 4):
        outs = [res["3d"] for res in per_rank(runs, n, "split_steps")]
        assert len({o["enorm"] for o in outs}) == 1
        assert "'mesh_shape': %s" % (split_shapes(n)[1][0],) in outs[0][
            "info"]
        assert np.abs(outs[0]["u"] - one["u"]).max() <= 1e-5 * inc
        ref = runs["ref"]["3d"]
        assert np.abs(outs[0]["u"] - ref).max() <= 1e-5 * np.abs(
            ref - u0).max()


def test_mesh_must_use_every_rank(runs):
    """A mesh shape that leaves ranks of the group idle raises
    ValueError naming the shape and the rank count."""
    for n in (2, 4):
        for res in per_rank(runs, n, "split_steps"):
            assert "uses %d ranks, the group has %d" % (n // 2, n) in res[
                "idle"]


def ranges_of(d, prefix, nprocs):
    import h5py

    out = []
    for r in range(nprocs):
        with h5py.File(d / ("%ss%dr%d.h5" % (prefix, nprocs, r)), "r") as h:
            out.append(tuple(tuple(int(v) for v in row)
                             for row in np.asarray(h["ranges"][()])))
    return out


def test_driver_splits_24x32_as_the_reference(runs):
    """24x32 over 4 processes: the port writes the reference driver's
    (2, 2) /ranges (rank r at unravel_index(r, (2, 2))); the exact lu
    tier's tsmerge'd series is bit-equal to one process, the reference's
    within 1e-10 of max|u|."""
    d = runs["dir"]
    for name in ("lu1", "lu4", "jlu4"):
        ok(runs["res"][name])
    assert ranges_of(d, "lu4", 4) == ranges_of(d, "jlu4", 4) == RANGES_2X2
    ks, times, states = series(merged(d, "lu4"))
    ks1, times1, states1 = series(d / "lu1")
    assert ks == ks1 == [0, 1, 2] and times == times1
    for a, b in zip(states, states1):
        np.testing.assert_array_equal(a, b)
    _, _, statesj = series(merged(d, "jlu4"))
    for a, b in zip(statesj, states1):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


def test_driver_1d_over_two_processes(runs):
    """options92 (examples/eigenmode1d, 20 steps, the banded tier) over
    2 processes on its 1D mesh: the reference driver's /ranges, and the
    tsmerge'd series bit-equal to one process; the reference's 2-process
    series has the same steps, its times and states within ADAPT_RTOL
    (relative, and of the increment) of the port's (an adaptive run;
    2.2e-8 and 2.7e-8 measured)."""
    d = runs["dir"]
    for name in ("eig1", "eig2", "jeig2"):
        ok(runs["res"][name])
    assert ranges_of(d, "eig2", 2) == ranges_of(d, "jeig2", 2) == [
        ((0, 64),), ((64, 128),)]
    ks, times, states = series(merged(d, "eig2"))
    ks1, times1, states1 = series(d / "eig1")
    assert ks == ks1 == list(range(21)) and times == times1
    for a, b in zip(states, states1):
        np.testing.assert_array_equal(a, b)
    ksj, timesj, statesj = series(merged(d, "jeig2"))
    assert ksj == ks1
    np.testing.assert_allclose(timesj, times1, rtol=ADAPT_RTOL)
    inc = np.abs(states1[-1] - states1[0]).max()
    for a, b in zip(statesj, states1):
        assert np.abs(a - b).max() <= ADAPT_RTOL * inc


def test_driver_with_g_over_four_processes(runs):
    """``--with_g`` with float32 sweeps over 4 processes (24x32 split
    (2, 2): the y split's unfused step): each slab file carries the
    dof + 1 fields with the reference driver's /ranges, and the
    tsmerge'd series is within 1e-5 of the increment of one process."""
    d = runs["dir"]
    for name in ("withg1", "withg4"):
        ok(runs["res"][name])
    assert ranges_of(d, "withg4", 4) == RANGES_2X2
    ks, times, states = series(merged(d, "withg4"))
    ks1, times1, states1 = series(d / "withg1")
    assert ks == ks1 and times == times1
    assert states[-1].shape == (4, 24, 32)
    inc = np.abs(states1[-1][:3] - states1[0][:3]).max()
    for a, b in zip(states, states1):
        assert np.abs(a - b).max() <= 1e-5 * inc
