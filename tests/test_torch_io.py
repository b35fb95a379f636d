"""The port's HDF5 I/O against ksfd_tpu's, on the CPU.

``ksfd_tpu_torch/io/`` beside ``ksfd_tpu/io/``: each package reads the
other's series (the grid, snapshots by k and by t, '/info' dt and
lastvart, '/solver_state'), the slab Gatherer and the virtual slab
view, ``Solution`` on a port run, and the two reference defects the
port does not copy (ROADMAP Queue C, ``io/timeseries.py:216``): the
view opened for 'r+', and a slab set that does not tile the grid.
"""

import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import ksfd_tpu as KJ
from ksfd_tpu import io as jio
from ksfd_tpu_torch import Grid, KSFDException
from ksfd_tpu_torch import io as tio
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.solvers import Solver
from ksfd_tpu_torch.tools.problems import OPTIONS92_PARAMS, make_clargs
from ksfd_tpu_torch.utils.cli import NumericsOptions

GRID = dict(dim=2, width=2.0, height=1.0, nx=16, ny=8, dof=3, order=3)
TIMES = [(0, 0.0), (1, 0.5), (3, 2.0)]


def states(shape=(3, 16, 8)):
    rng = np.random.default_rng(5)
    return {k: rng.standard_normal(shape) for k, _ in TIMES}


def write_series(io, grid, prefix, solver_state):
    ts = io.TimeSeries(prefix, grid=grid, mode="w")
    for k, t in TIMES:
        ts.store(states()[k], t, k=k)
    ts.save_solver_state(**solver_state)
    ts.close()


def read_series(io, prefix, grid_cls):
    ts = io.TimeSeries(prefix, mode="r")
    out = dict(
        grid=ts.grid, grid_ok=ts.grid == grid_cls(**GRID),
        by_k={k: ts.retrieve_by_number(k) for k, _ in TIMES},
        mid=ts.retrieve_by_time(1.25), times=list(ts.sorted_times()),
        state=ts.load_solver_state(),
        info_dt=float(ts.info["dt"][()]),
        info_lastvart=float(ts.info["lastvart"][()]),
    )
    ts.close()
    return out


def check_read(out):
    want = states()
    assert out["grid_ok"]
    assert out["times"] == [t for _, t in TIMES]
    for k, _ in TIMES:
        np.testing.assert_array_equal(out["by_k"][k], want[k])
    # t = 1.25 lies between k = 1 (t 0.5) and k = 3 (t 2.0)
    np.testing.assert_allclose(out["mid"], 0.5 * (want[1] + want[3]),
                               rtol=1e-15, atol=1e-15)
    st = out["state"]
    assert (st["t"], st["dt"], st["lastvart"], st["k"]) == (
        2.0, 0.25, 1.5, 3)
    assert (out["info_dt"], out["info_lastvart"]) == (0.25, 1.5)


def test_port_series_read_by_reference(tmp_path):
    prefix = str(tmp_path / "port")
    rng = torch.Generator().manual_seed(3)
    write_series(tio, Grid(**GRID), prefix,
                 dict(t=2.0, dt=0.25, lastvart=1.5, k=3,
                      rng_state=rng.get_state()))
    out = read_series(jio, prefix, KJ.Grid)
    check_read(out)
    assert "rng_key" not in out["state"]
    with h5py.File(prefix + "s1r0.h5", "r") as f:
        saved = np.asarray(f["solver_state/rng_state"][()])
        assert "rng_key" not in f["solver_state"]
    np.testing.assert_array_equal(saved, rng.get_state().numpy())
    # the port reads its own generator state back
    back = read_series(tio, prefix, Grid)
    check_read(back)
    assert torch.equal(back["state"]["rng_state"], rng.get_state())


def test_reference_series_read_by_port(tmp_path):
    prefix = str(tmp_path / "ref")
    write_series(jio, KJ.Grid(**GRID), prefix,
                 dict(t=2.0, dt=0.25, lastvart=1.5, k=3,
                      rng_key=jax.random.PRNGKey(7)))
    out = read_series(tio, prefix, Grid)
    check_read(out)
    # the JAX key is not read: JAX's draws cannot be continued here
    assert "rng_state" not in out["state"] and "rng_key" not in out["state"]


def write_slabs(io, grid, prefix, boxes, dofs=None):
    """A slab set, rank r holding boxes[r] of the states (with dofs[r]
    fields where given)."""
    full = states()
    for r, box in enumerate(boxes):
        g = grid if dofs is None else type(grid)(**dict(GRID, dof=dofs[r]))
        ts = io.TimeSeries(prefix, grid=g, mode="w", size=len(boxes),
                           rank=r, ranges=box)
        for k, t in TIMES:
            blk = full[k][(slice(0, g.dof),) + tuple(slice(*b) for b in box)]
            ts.store(blk, t, k=k)
        ts.close()


HALVES = [((0, 8), (0, 8)), ((8, 16), (0, 8))]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_gatherer_and_virtual_slab_view(tmp_path, writer):
    """A two-rank slab set: Gatherer yields each rank's block with its
    ranges, and one reader opens the set as the global series, in both
    packages, whichever wrote it."""
    prefix = str(tmp_path / "slab")
    io, grid = (tio, Grid(**GRID)) if writer == "port" else (
        jio, KJ.Grid(**GRID))
    write_slabs(io, grid, prefix, HALVES)
    want = states()
    got = [(ts.rank, ts.size, ts.ranges, ts.retrieve_by_number(3))
           for ts in tio.Gatherer(prefix)]
    ref = [(ts.rank, ts.size, ts.ranges, ts.retrieve_by_number(3))
           for ts in jio.Gatherer(prefix)]
    assert [g[:3] for g in got] == [r[:3] for r in ref] == [
        (0, 2, HALVES[0]), (1, 2, HALVES[1])]
    for (_, _, box, blk), (_, _, _, rblk) in zip(got, ref):
        np.testing.assert_array_equal(blk, rblk)
        np.testing.assert_array_equal(
            blk, want[3][(slice(None),) + tuple(slice(*b) for b in box)])
    view = tio.TimeSeries(prefix, mode="r")
    assert view.virtual and view.ranges is None
    np.testing.assert_array_equal(view.retrieve_by_number(1), want[1])
    np.testing.assert_array_equal(view.retrieve_by_time(2.0), want[3])
    view.close()


def test_slab_view_not_opened_for_writing(tmp_path):
    """Reference defect: its view engages for 'r+' (``mode[0] == 'r'``),
    so a store goes through the view into rank 0's slab file.  The
    port's 'r+' opens rank 0's own slab, with its block's shape."""
    prefix = str(tmp_path / "slab")
    write_slabs(tio, Grid(**GRID), prefix, HALVES)
    ref = jio.TimeSeries(prefix, mode="r+")
    assert ref.virtual  # the defect
    ref.close()
    ts = tio.TimeSeries(prefix, mode="r+")
    assert not ts.virtual and ts.ranges == HALVES[0]
    assert ts.local_shape == (3, 8, 8)
    with pytest.raises(ValueError):
        ts.store(states()[0], 5.0)  # a global state is not this block
    ts.close()


@pytest.mark.parametrize("stale", ["gap", "overlap", "fields"])
def test_slab_set_that_does_not_tile_is_refused(tmp_path, stale):
    """Reference defect: the view assembles a set whose ranges leave
    part of the grid unwritten (its array there is ``np.empty``), cover
    it twice, or whose fields differ (broadcast into every field).  The
    port refuses each."""
    prefix = str(tmp_path / "slab")
    boxes = {"gap": [((0, 8), (0, 8)), ((10, 16), (0, 8))],
             "overlap": [((0, 10), (0, 8)), ((8, 16), (0, 8))],
             "fields": HALVES}[stale]
    dofs = [3, 1] if stale == "fields" else None
    write_slabs(tio, Grid(**GRID), prefix, boxes, dofs=dofs)
    ref = jio.TimeSeries(prefix, mode="r")
    assert ref.virtual
    u = ref.retrieve_by_number(3)  # the reference assembles it
    assert u.shape == (3, 16, 8)
    ref.close()
    with pytest.raises(KSFDException, match="tile|fields"):
        tio.TimeSeries(prefix, mode="r")


def test_solution_on_a_port_run(tmp_path):
    """A port Solver run saved through the save monitor: Solution
    rebuilds the problem from '/info' and returns the stored states."""
    clargs = make_clargs(params=[p for p in OPTIONS92_PARAMS
                                 if not p.startswith("nelements=")]
                         + ["nelements=32"])
    ps, grid, ops = problem_from_clargs(clargs, 32, device="cpu")
    prefix = str(tmp_path / "run")
    ts = tio.TimeSeries(prefix, grid=grid, mode="w")
    tio.write_info(ts, clargs=clargs, ps=ps, sources=ops.sources)
    solver = Solver(ops, NumericsOptions(ksp_type="dense",
                                         adapt_type="none"),
                    t0=0.0, dt=1.0, tmax=1e9, maxsteps=4, rtol=1e-6,
                    atol=0.01)
    sm, _ = tio.make_save_monitor(ts)
    solver.add_monitor(sm)
    x = torch.arange(32, dtype=torch.float64) / 32
    u0 = 9000.0 + 100.0 * torch.sin(2 * np.pi * x)[None].repeat(3, 1)
    u = solver.solve(u0)
    ts.close()
    soln = tio.Solution(prefix, device="cpu")
    assert (soln.tmin, soln.tmax) == (0.0, 4.0)
    assert soln.grid == grid
    np.testing.assert_array_equal(soln.images(), u.numpy())
    np.testing.assert_array_equal(soln.images(0.0), ops.groom(u0).numpy())
    assert soln.ps.nligands == 2 and soln.clargs.params == clargs.params
    assert soln.derivatives.nligands == 2
    assert soln.params(0.0)["alpha_1"] == 1500
    st = soln.tseries.load_solver_state()
    assert st["k"] == 4 and st["t"] == 4.0 and st["dt"] == 1.0
    soln.close()
    # the reference's reader takes the same file
    ref = jio.TimeSeries(prefix, mode="r")
    np.testing.assert_array_equal(ref.retrieve_by_time(4.0), u.numpy())
    ref.close()


def test_checkpoint_monitor_zip_mode(tmp_path):
    """'--check=<prefix>.zip' archives each checkpoint and removes the
    file; the port's lastcheckpoint extracts the newest again."""
    from ksfd_tpu_torch.tools.lastcheckpoint import last_checkpoint

    grid = Grid(**GRID)
    cp = tio.make_checkpoint_monitor(str(tmp_path / "cp.zip"), grid)
    solver = type("S", (), dict(h=0.5, lastvart=0.0, rng_state=None))()
    for k, t in TIMES:
        cp(solver, k, t, torch.from_numpy(states()[k]))
    assert not list(tmp_path.glob("cp_*_s1r0.h5"))
    assert (tmp_path / "cps1r0.zip").exists()
    newest = last_checkpoint(str(tmp_path / "cp.zip"))
    assert newest == str(tmp_path / "cp_3_")
    ts = tio.TimeSeries(newest, mode="r")
    np.testing.assert_array_equal(ts.retrieve_by_number(3), states()[3])
    assert ts.load_solver_state()["k"] == 3
    ts.close()


def test_tsmerge_rebuilds_checkpoints_and_slabs(tmp_path):
    """The port's tsmerge: a slab set, and the '@' gather of per-step
    checkpoints, each into one global series."""
    from ksfd_tpu_torch.tools import tsmerge

    prefix = str(tmp_path / "slab")
    write_slabs(tio, Grid(**GRID), prefix, HALVES)
    assert tsmerge.main([prefix, "-o", str(tmp_path / "merged")]) == 0
    ts = tio.TimeSeries(str(tmp_path / "merged"), mode="r")
    for k, t in TIMES:
        np.testing.assert_array_equal(ts.retrieve_by_time(t), states()[k])
    ts.close()
    cp = tio.make_checkpoint_monitor(str(tmp_path / "cp"), Grid(**GRID))
    solver = type("S", (), dict(h=0.5, lastvart=0.0, rng_state=None))()
    for k, t in TIMES:
        cp(solver, k, t, states()[k])
    assert tsmerge.main([str(tmp_path / "cp@"), "-o",
                         str(tmp_path / "all")]) == 0
    ts = tio.TimeSeries(str(tmp_path / "all"), mode="r")
    assert list(ts.sorted_times()) == [t for _, t in TIMES]
    ts.close()


def test_snapshot_block_of_a_slab_raises():
    """A slab series stores a rank's block: the rank's slab itself, or
    that block cut from the global state; a state that holds neither
    raises."""
    full = torch.arange(3 * 16 * 8, dtype=torch.float64).reshape(3, 16, 8)
    for box in HALVES:
        want = full[:, box[0][0]:box[0][1]].numpy()
        np.testing.assert_array_equal(tio.snapshot_block(full, box), want)
        np.testing.assert_array_equal(
            tio.snapshot_block(torch.from_numpy(want), box), want)
    with pytest.raises(KSFDException, match="neither the block"):
        tio.snapshot_block(torch.zeros(3, 4, 8), HALVES[1])


def test_series_without_h5py_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(KSFDException, match="h5py"):
        tio.TimeSeries(str(tmp_path / "x"), grid=Grid(**GRID), mode="w")


def test_resume_of_one_ranks_slab_names_tsmerge(tmp_path):
    """One process cannot resume rank 0's slab of an incomplete
    two-rank set: it raises naming tsmerge, as the reference does."""
    from ksfd_tpu_torch import SolutionParameters
    from ksfd_tpu_torch.ic import resume_values

    prefix = str(tmp_path / "slab")
    write_slabs(tio, Grid(**GRID), prefix, HALVES[:1])
    clargs = make_clargs(params=["dim=2", "nelements=16", "width=2",
                                 "height=1"], resume=prefix)
    ps = SolutionParameters(clargs)
    with pytest.raises(KSFDException, match="tsmerge"):
        resume_values(clargs, Grid(**GRID), ps, device="cpu")
