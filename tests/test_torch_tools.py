"""The port's last tools: moviemaker, h5images and probe_hgap.

- ``ksfd_tpu_torch.tools.moviemaker`` and ``h5images`` on a run stored
  through the port's I/O (the manufactured 1D problem at 32, four
  dense-tier steps), as tests/test_tools.py:91-116 and :319-330 hold
  the reference's: three numbered frames, the images' last frame equal
  to the final state with its params attribute, and ``--names`` with
  the wrong count exiting 2 naming ``--names`` on stderr.
- ``ksfd_tpu_torch.tools.probe_hgap`` on the flagship's rough state at
  64^2 (its spacing kept, 10 accepts in memory): enorm(h) per tier over
  h = 0.0025, 0.01, 0.04, 0.16 against the reference's step on the same
  state, within 1e-3 relative of it, each tier's curve monotone
  wherever the reference's is, and rich3's enorm at the smallest h at
  most 1.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ksfd_tpu as KJ
import ksfd_tpu.ops as KJops
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import io as tio
from ksfd_tpu_torch.solvers import Solver
from ksfd_tpu_torch.tools import (
    flagship, h5images, moviemaker, probe_hgap, validate)
from ksfd_tpu_torch.utils.cli import NumericsOptions

HS = [0.0025, 0.01, 0.04, 0.16]
TIERS = ["rich3", "rich16", "cheb48"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def stored_run(tmp_path_factory):
    """A 4-step run stored through the port's I/O."""
    tmp = tmp_path_factory.mktemp("run")
    ps, grid, ops = validate.make_problem(32, device="cpu")
    prefix = str(tmp / "solutions" / "run")
    ts = tio.TimeSeries(prefix, grid=grid, mode="w")
    tio.write_info(ts, clargs=ps.clargs, ps=ps)
    solver = Solver(ops, NumericsOptions(ksp_type="dense", adapt_type="none"),
                    t0=0.0, dt=1.0, tmax=1e9, maxsteps=4, rtol=1e-6,
                    atol=0.01)
    monitor, closer = tio.make_save_monitor(ts)
    solver.add_monitor(monitor)
    u = solver.solve(torch.from_numpy(validate.exact_state(grid, 0.0)))
    closer()
    ts.close()
    return tmp, prefix, u.numpy(), grid


def run_tool(tool, *args):
    """``tool.main`` on the command line ``args`` in this process (what
    ``python -m ksfd_tpu_torch.tools.<tool>`` exits with): its exit code
    and its standard error."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        code = tool.main(list(args))
    return code, err.getvalue()


def test_moviemaker_tool(stored_run):
    tmp, prefix, *_ = stored_run
    frames = str(tmp / "frames" / "f")
    code, err = run_tool(moviemaker, "-n", "3", prefix, frames)
    assert code == 0, err
    for i in range(3):
        assert os.path.exists("{p}{n:04d}.png".format(p=frames, n=i))


def test_h5images_tool(stored_run):
    tmp, prefix, ufinal, grid = stored_run
    out = str(tmp / "images.h5")
    code, err = run_tool(h5images, "-n", "2", prefix, out)
    assert code == 0, err
    import h5py

    with h5py.File(out, "r") as f:
        assert f["images1"].shape == grid.Vshape
        np.testing.assert_array_equal(f["images1"][()], ufinal)
        assert "params" in f["images1"].attrs
        np.testing.assert_array_equal(f["times"][()], [0.0, 4.0])


def test_moviemaker_names_mismatch(stored_run):
    """--names with the wrong count exits 2 naming --names, instead of
    dropping fields."""
    tmp, prefix, *_ = stored_run
    code, err = run_tool(moviemaker, "-n", "1", "--names", "OnlyOne",
                         prefix, str(tmp / "frames_nm" / "f"))
    assert code == 2
    assert "--names" in err


@pytest.fixture(scope="module")
def hgap():
    """The probe on the flagship's 64^2 state after 10 accepts, and the
    reference's enorms of the same tiers on that state."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ops, u, t = probe_hgap.rough_state(nelements=64, accepts=10,
                                           device="cpu", out=lambda s: None)
        res = probe_hgap.probe(ops, u, t, HS, TIERS, out=lambda s: None)
    finally:
        torch.set_num_threads(prev)
    clargs = flagship.example_clargs(nelements=64)
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=2, width=jps.width, height=jps.height, nx=64, ny=64,
                    dof=3, order=jps.degree)
    jops = KJops.PDEOperators(jps, jgrid)
    ju = jnp.asarray(u.numpy())
    ref = {}
    for tag in TIERS:
        nm = probe_hgap.tier_numerics(tag)
        step, _ = jstep(jops, KJ.NumericsOptions(
            ts_type=nm.ts_type, ksp_type=nm.ksp_type,
            ksp_iters=nm.ksp_iters), atol=probe_hgap.ATOL,
            rtol=probe_hgap.RTOL)
        ref[tag] = [float(step(ju, t, h)[1]) for h in HS]
    return res, ref


def test_probe_hgap_curves_follow_the_reference(hgap):
    """Each tier's enorm(h) within 1e-3 relative of the reference's step
    on the same state, monotone wherever the reference's curve is;
    rich3 accepts the smallest h; the record names each tier's largest
    accepted h."""
    res, ref = hgap
    assert res["hs"] == HS
    for tag in TIERS:
        got, want = res["curves"][tag], ref[tag]
        np.testing.assert_allclose(got, want, rtol=1e-3)
        for i in range(len(HS) - 1):
            if want[i + 1] >= want[i]:
                assert got[i + 1] >= got[i], (tag, i)
            else:
                assert got[i + 1] <= got[i], (tag, i)
        ok = [h for h, e in zip(HS, got) if e <= 1.0]
        assert res["sustained"][tag] == (max(ok) if ok else None)
    assert res["curves"]["rich3"][0] <= 1.0
    json.dumps(res)
