"""The port's initial values and random fields against ksfd_tpu.

``ksfd_tpu_torch/randomfield.py`` and ``ksfd_tpu_torch/ic.py`` beside
``ksfd_tpu/randomfield.py`` and ``ksfd_tpu/ic.py`` on the CPU.  PyTorch
cannot reproduce JAX's PRNG draws, so the two packages are held on
given values (the coarse normals passed in, or the ``Generator.normal``
of both packages patched to return the same numbers), to 1e-12
relative; the port's own draws are held to their statistics and to bit
for bit reproduction from a seed and a saved state.
"""

import numpy as np
import pytest
import torch

import ksfd_tpu as KJ
from ksfd_tpu import ic as jic
from ksfd_tpu import randomfield as jrf
from ksfd_tpu_torch import Grid, SolutionParameters
from ksfd_tpu_torch import ic as tic
from ksfd_tpu_torch import randomfield as trf
from ksfd_tpu_torch.tools.flagship import example_clargs
from ksfd_tpu_torch.tools.problems import OPTIONS92_PARAMS, make_clargs

REL = 1e-12

GRIDS = {
    1: dict(dim=1, width=1.0, nx=64),
    2: dict(dim=2, width=4.0, height=2.0, nx=32, ny=16),
    3: dict(dim=3, width=1.0, height=1.0, depth=2.0, nx=8, ny=12, nz=16),
}


def grids(dim, coarse):
    """(reference Grid, port Grid, reference coarse Grid, port coarse
    Grid): the coarse one a quarter of the points per axis, or the grid
    itself."""
    kw = dict(GRIDS[dim], dof=1, order=3)
    ckw = dict(kw)
    if coarse:
        for ax in ("nx", "ny", "nz"):
            if ax in ckw:
                ckw[ax] = ckw[ax] // 4
    return (KJ.Grid(**kw), Grid(**kw), KJ.Grid(**ckw), Grid(**ckw))


@pytest.mark.parametrize("coarse", [False, True], ids=["same", "coarse"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_random_function_matches_reference(dim, coarse):
    """Given coarse values, the interpolated field equals the
    reference's (the copy when the grids agree)."""
    jg, tg, jrg, trg = grids(dim, coarse)
    vals = np.random.default_rng(dim).standard_normal(tuple(jrg.Sshape))
    ref = jrf.random_function(jg, randgrid=jrg, vals=vals)
    got = trf.random_function(tg, randgrid=trg, vals=torch.from_numpy(vals))
    assert got.shape == tuple(tg.Sshape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * np.abs(ref).max())
    if coarse:
        # a partition of unity: a constant field stays constant
        ones = trf.random_function(tg, randgrid=trg,
                                   vals=np.full(trg.Sshape, 3.5))
        np.testing.assert_allclose(ones, 3.5, rtol=1e-14)


def test_bump_and_axis_weights_match_reference():
    x = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(trf.bump_kernel(x), jrf.bump_kernel(x))
    for args in ((64, 1 / 64, 16, 1 / 16), (30, 0.1, 7, 3 / 7)):
        for a, b in zip(trf._axis_weights(*args), jrf._axis_weights(*args)):
            np.testing.assert_array_equal(a, b)


def test_generator_seed_and_state_reproduce():
    """A seed reproduces its stream; a saved state resumes it bit for
    bit; draws have the stated mean and scale."""
    trf.Generator(11)
    a = trf.Generator.get_rng().normal(size=(4, 5))
    state = trf.Generator.current_key()
    b = trf.Generator.get_rng().normal(loc=2.0, scale=3.0, size=(7,))
    trf.Generator(11)
    np.testing.assert_array_equal(trf.Generator.get_rng().normal(
        size=(4, 5)), a)
    trf.Generator(12)
    assert not np.array_equal(trf.Generator.get_rng().normal(size=(4, 5)), a)
    trf.Generator.set_key(state)
    np.testing.assert_array_equal(
        trf.Generator.get_rng().normal(loc=2.0, scale=3.0, size=(7,)), b)
    trf.Generator(13)
    big = trf.Generator.get_rng().normal(loc=5.0, scale=2.0, size=(200000,))
    assert abs(big.mean() - 5.0) < 5 * 2.0 / np.sqrt(big.size)
    assert abs(big.std() - 2.0) < 0.02
    # no seed after one: the stream goes on
    trf.Generator()
    assert trf.Generator._seed == 13


def problem_clargs(case):
    """The parsed command line of each start case."""
    if case == "options92-1d":
        # srho0=0, every U0 given
        return make_clargs(params=[
            p for p in OPTIONS92_PARAMS if not p.startswith("nelements")
        ] + ["nelements=64"])
    if case == "aggregation2d-32":
        # srho0=90 on a randgrid of 8 x 8, the ligands at rho*s/gamma
        return example_clargs("aggregation2d", 32)
    if case == "aggregation3d-16":
        return example_clargs("aggregation3d", 16)
    # Nworms on top of the noise, a ligand given and one at steady state
    return example_clargs("aggregation2d", 32,
                          extra=["Nworms=32000", "U0_2_1=500+x"])


def grids_for(ps):
    kw = dict(dim=ps.dim, width=ps.width, height=ps.height, depth=ps.depth,
              nx=ps.nwidth, ny=ps.nheight, nz=ps.ndepth,
              dof=ps.nligands + 1, order=ps.degree)
    return KJ.Grid(**kw), Grid(**kw)


@pytest.mark.parametrize("case", ["options92-1d", "aggregation2d-32",
                                  "aggregation3d-16", "nworms-u0-given"])
def test_start_values_match_reference(case, monkeypatch):
    """start_values of both packages from one parameter set, the normal
    draw of both Generators patched to the same numpy values."""
    clargs = problem_clargs(case)
    jps = KJ.SolutionParameters(clargs)
    tps = SolutionParameters(clargs)
    jg, tg = grids_for(tps)
    draws = []

    def given(self, loc=0.0, scale=1.0, size=()):
        z = np.random.default_rng(5).standard_normal(tuple(size))
        draws.append(z.shape)
        return z * scale + loc

    monkeypatch.setattr(jrf.Generator, "normal", given)
    monkeypatch.setattr(trf.Generator, "normal", given)
    ref, t_ref = jic.start_values(clargs, jg, jps)
    got, t = tic.start_values(clargs, tg, tps, device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == tuple(tg.Vshape)
    assert t == t_ref
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=REL * np.abs(ref).max())
    noisy = case != "options92-1d"
    assert len(draws) == 2 * noisy
    if noisy:
        # the coarse draw lives on nwidth // 4 points per axis
        assert draws[0] == tuple(n // 4 for n in tg.Sshape)
        assert got[0].std() > 10.0
    if case == "aggregation2d-32":
        # the ligands at the local steady state rho * s / gamma (= rho)
        np.testing.assert_allclose(got[1], got[0], rtol=1e-15)


def test_start_values_draw_from_the_port_generator():
    """Unpatched, the start is the port's own draw: reproducible from
    the seed, its rho field of the stated spread around rho0."""
    clargs = problem_clargs("aggregation2d-32")
    ps = SolutionParameters(clargs)
    _, tg = grids_for(ps)
    trf.Generator(7)
    u1, _ = tic.start_values(clargs, tg, ps, device="cpu")
    trf.Generator(7)
    u2, _ = tic.start_values(clargs, tg, ps, device="cpu")
    assert torch.equal(u1, u2)
    trf.Generator(8)
    u3, _ = tic.start_values(clargs, tg, ps, device="cpu")
    assert not torch.equal(u1, u3)
    # srho0=90 on the coarse points, averaged by the bumps in between
    assert 20.0 < float(u1[0].std()) < 90.0
    assert abs(float(u1[0].mean()) - 9000.0) < 50.0


def test_initial_values_and_resume(tmp_path):
    """A fresh start, then resume and restart from a written series:
    the last snapshot, t (kept or t0), dt and lastvart by the
    reference's priority (a dt= parameter over the file's), k and the
    noise generator's state; the reference reads the file the same
    way."""
    from ksfd_tpu_torch.io import TimeSeries

    clargs = problem_clargs("options92-1d")
    ps = SolutionParameters(clargs)
    jg, tg = grids_for(ps)
    u, t, extras = tic.initial_values(clargs, tg, ps, device="cpu")
    assert t == 0.0 and extras == {}
    ref, _ = tic.start_values(clargs, tg, ps, device="cpu")
    assert torch.equal(u, ref)
    prefix = str(tmp_path / "run")
    ts = TimeSeries(prefix, grid=tg, mode="w")
    u_last = u * 1.01
    ts.store(u.numpy(), 0.0, k=0)
    ts.store(u_last.numpy(), 1.5, k=7)
    gen = torch.Generator().manual_seed(4)
    ts.save_solver_state(t=1.5, dt=0.3, lastvart=1.25,
                         rng_state=gen.get_state(), k=7)
    ts.close()
    nodt = [p for p in clargs.params if not p.startswith("dt=")]
    for params, dt in ((clargs.params, 1.0), (nodt, 0.3)):
        cl = make_clargs(params=params, resume=prefix)
        tps, jps = SolutionParameters(cl), KJ.SolutionParameters(cl)
        got, t1, ex = tic.initial_values(cl, tg, tps, device="cpu")
        assert t1 == 1.5 and ex["k"] == 7 and torch.equal(u_last, got)
        assert torch.equal(ex["rng_state"], gen.get_state())
        assert (tps.params0["dt"], tps.params0["lastvart"]) == (dt, 1.25)
        ju, jt, jex = jic.resume_values(cl, jg, jps)
        np.testing.assert_array_equal(np.asarray(ju), got.numpy())
        assert (jt, jex["k"]) == (t1, 7)
        assert (jps.params0["dt"], jps.params0["lastvart"]) == (dt, 1.25)
    cl = make_clargs(params=clargs.params, restart=prefix)
    tps = SolutionParameters(cl)
    got, t2, ex = tic.initial_values(cl, tg, tps, device="cpu")
    assert t2 == 0.0 and ex == {} and torch.equal(u_last, got)
    assert tps.params0["lastvart"] == 0.0
