"""The mesh runs all that the reference's mesh runs: 1D meshes, the pc
forms, the flux form, with-G states and ensembles on a mesh.

Gloo ranks on the CPU (tests/torch_mesh_ranks.py ``case_mesh_forms``,
2 and 4 ranks spawned once for the module, ``grid_mesh``'s own split:
an x split of these grids) run, each from the same numpy start made
from a seed:

- single steps at h=1e-3 on the bench problem at 32^2 (``form_steps``):
  the spectral pc (float32, float64, bfloat16), the block pc in
  bfloat16, ``pc_type`` none with Richardson, Chebyshev and the
  fixed-count GMRES, ``pc_fft`` on with the block and the spectral pc,
  the flux form and with-G states (float32 and float64 sweeps);
- Solver runs (``form_solvers``): options92 (examples/eigenmode1d) and
  options93 (the manufactured problem with its rho source) on 1D meshes
  at 128, the flux form and with-G states at 32^2;
- EnsembleSolver runs of 2 members split over the mesh
  (``form_ensembles``): adaptive per step, the device loop, and
  fixed-dt noise.

This process runs the same unsharded, on one rank of the port and
through the reference (``REF_GROUPS``: six steps, every Solver run and
every ensemble), while the ranks run.  The bounds: the float64 paths
(float64 sweeps and pc, and the pc-less GMRES) to ``rtol=1e-9,
atol=1e-9`` (the reference's tests/test_sharding.py:87-89); float32
sweeps (and the bfloat16 pc, whose one sum is bfloat16 on the wire)
within 1e-5 of the increment; adaptive runs by equal step and
rejection counts (against one rank also equal ``stats``), and t, h
and the state within ``MESH_ADAPT_RTOL`` of one rank and of the
reference (the float32 sweeps' rounding moves the embedded error
norm); every rank's error norm, ``stats`` and records equal.  An
ensemble on a mesh is the reference's "xla" flavour (the unfused
step), so the reference's ``EnsembleSolver`` and the port's one-rank
ensemble run with ``use_pallas=False``; the noise run's reference
draws the port's normals (the generators differ), so its states
compare as a fixed-dt run's.
"""

import contextlib
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
import ksfd_tpu.ops as KJops
from ksfd_tpu.solvers import EnsembleSolver as JEnsemble
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import make_step_fn as jstep
from manufactured import make_problem as j_make_problem
from test_torch_ensemble import ADAPT_RTOL
from torch_mesh_ranks import (
    H,
    N_FORMS,
    collect,
    ensemble_start,
    form_ensemble,
    form_ensembles,
    form_solver,
    form_solvers,
    form_step,
    form_steps,
    forms_problem,
    forms_start,
    solver_problem,
    start_ranks,
)

STEPS = {s[0]: s for s in form_steps()}
SOLVERS = {s[0]: s for s in form_solvers()}
ENSEMBLES = {s[0]: s for s in form_ensembles()}
F64 = ("spectral_f64", "none_richardson", "none_chebyshev", "none_gmres",
       "flux_f64", "with_g_f64")


def reference_step(label):
    """The reference's unsharded step of ``label`` from the same start:
    the state after one step of H."""
    _, kind, nm = STEPS[label]
    jps, jgrid, jops = ge._make_problem(32, 32)
    if kind == "flux":
        jops = KJops.PDEOperators(jps, jgrid, flux_form=True)
    elif kind == "with_g":
        jops = KJops.WithGOperators(jps, KJops.with_g_grid(jgrid))
    u0 = jops.groom(jnp.asarray(forms_start(kind, jops.grid)))
    if kind == "with_g":
        u0 = jops.refresh_G(u0, 0.0)
    step, _ = jstep(jops, KJ.NumericsOptions(**nm), atol=0.01, rtol=1e-6)
    return np.asarray(step(u0, 0.0, H)[0])


def reference_ops(ps, grid, flux_form=False, with_g=False):
    """The reference's operators of the port's problem ``(ps, grid)``:
    the same command line, extents and fields."""
    jps = KJ.SolutionParameters(ps.clargs)
    jgrid = KJ.Grid(dim=grid.dim, width=jps.width, height=jps.height,
                    depth=jps.depth, dof=jps.nligands + 1, order=jps.degree,
                    **dict(zip(("nx", "ny", "nz"),
                               (int(n) for n in grid.nps))))
    if with_g:
        return KJops.WithGOperators(jps, KJops.with_g_grid(jgrid))
    return KJops.PDEOperators(jps, jgrid, flux_form=flux_form)


def reference_solver(label):
    """The reference's Solver run of ``form_solvers``'s ``label`` from
    the same start: the state, k, t, h and failures.  options93 runs the
    reference's manufactured problem (its rho source)."""
    _, kind, nm, kw = SOLVERS[label]
    ps, grid, _ = forms_problem(kind)
    if kind == "validate1d":
        jops = j_make_problem(128)[2]
    else:
        jops = reference_ops(ps, grid, flux_form=kind == "flux",
                             with_g=kind == "with_g")
    js = JSolver(jops, KJ.NumericsOptions(**nm), **kw)
    u = np.asarray(js.solve(jnp.asarray(forms_start(kind, grid))))
    return dict(u=u, k=js.k, t=float(js.t), h=float(js.h),
                failures=js.snes_failures)


@contextlib.contextmanager
def drawing(draws):
    """``jax.random.normal`` as the reference's ensemble calls it (under
    vmap, one draw per member) giving ``draws`` in turn, member by
    member: the port's normals, which its generators cannot draw."""
    queue = [np.asarray(d) for d in draws]
    normal = jax.random.normal

    def given(key, shape=(), dtype=float):
        return jax.pure_callback(
            lambda k: queue.pop(0).astype(dtype),
            jax.ShapeDtypeStruct(shape, dtype), key,
            vmap_method="sequential")
    jax.random.normal = given
    try:
        yield queue
    finally:
        jax.random.normal = normal


def reference_ensemble(label, draws):
    """The reference's EnsembleSolver run of ``form_ensembles``'s
    ``label`` in its "xla" flavour (``use_pallas=False``) from the same
    members, with ``draws`` for its noise: the states, k, t, h and
    failures."""
    _, nm, kw, extra = ENSEMBLES[label]
    ps, grid, _ = solver_problem(N_FORMS, extra)
    kw = dict(kw)
    if "rng_key" in kw:
        kw["rng_key"] = jax.random.PRNGKey(kw["rng_key"])
    es = JEnsemble(reference_ops(ps, grid),
                   KJ.NumericsOptions(use_pallas=False, **nm), **kw)
    with drawing(draws) as left:
        out = es.solve(jnp.asarray(ensemble_start()))
    assert not left
    return dict(u=np.asarray(out.u), k=np.asarray(out.k),
                t=np.asarray(out.t), h=np.asarray(out.h),
                failures=np.asarray(out.snes_failures))


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: the reference's runs, in this process and two more, of about equal
#: work each: every Solver run and ensemble, and six of the steps (the
#: others' one-rank paths are held against it by
#: tests/test_torch_pc_forms.py, test_torch_krylov.py and
#: test_torch_with_g.py).  Its device loop is not run: the port's
#: device loop is held against the reference's per-step ensemble, which
#: it equals on one rank.
REF_GROUPS = [
    ["spectral", "spectral_f64", "none_richardson", "flux"],
    ["validate1d", "eigen1d", "flux_solver", "with_g_solver"],
    ["fft_block", "with_g", "ens_step", "ens_noise"],
]


def reference_runs(labels):
    """The reference's runs of ``labels`` (steps, Solver runs and
    ensembles) in this process; the noise run takes the draws of the
    port's one-rank run (seeded: the ranks draw the same)."""
    torch.set_num_threads(1)
    out = {}
    for label in labels:
        if label in STEPS:
            out[label] = reference_step(label)
        elif label in SOLVERS:
            out[label] = reference_solver(label)
        else:
            draws = form_ensemble(label, use_pallas=False)["draws"]
            out[label] = reference_ensemble(label, draws)
    return out


@pytest.fixture(scope="module")
def runs():
    """The ranks' results, 2 and 4 at once; meanwhile the reference's
    runs (REF_GROUPS: the first here, the others in two processes) and
    the one-rank runs here."""
    handle = start_ranks({2: ["mesh_forms"], 4: ["mesh_forms"]})
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ProcessPoolExecutor(len(REF_GROUPS) - 1,
                                 mp_context=mp.get_context("spawn")) as pool:
            pending = [pool.submit(reference_runs, g)
                       for g in REF_GROUPS[1:]]
            one = {label: form_step(label) for label in STEPS}
            one.update({label: form_solver(label) for label in SOLVERS})
            for label in ENSEMBLES:
                one[label] = form_ensemble(label, use_pallas=False)
            ref = reference_runs(REF_GROUPS[0])
            for job in pending:
                ref.update(job.result(timeout=300))
    finally:
        torch.set_num_threads(prev)
    ranks = collect(handle, timeout=300)
    return dict(ranks=ranks, one=one, ref=ref)


#: adaptive runs with float32 sweeps on a mesh, against one rank and
#: the reference: t, h relative and the state relative to the
#: increment.  The embedded error norm is a cancelling sum (~4e-5) of
#: the float32 sweeps: it moves by 0.4-3.6% with the ranks' split of
#: its reductions (the float64 sweeps' by 1e-10: the step tests) and by
#: 1.7-3.5% from PyTorch to XLA, and the reference's ensemble vmaps its
#: step, which XLA rounds otherwise than its Solver's (3.8e-4 later in
#: t on these members).  Measured at most 5.5e-4 (t), 3.0e-4 (h) and
#: 5.1e-4 (the state); ADAPT_RTOL (tests/test_torch_ensemble.py, 1e-4)
#: holds for t against one rank's Solver.
MESH_ADAPT_RTOL = 1e-3


def hold_reference(got, ref, u0, adaptive, fields=slice(None)):
    """A Solver run against the reference's from the same start u0: the
    same k and failures; at fixed dt the same t and the state within
    1e-5 of the increment (over ``fields``), adaptive t, h and the state
    within MESH_ADAPT_RTOL."""
    assert (got["k"], got["failures"]) == (ref["k"], ref["failures"])
    inc = np.abs(ref["u"][fields] - u0[fields]).max()
    if adaptive:
        np.testing.assert_allclose([got["t"], got["h"]],
                                   [ref["t"], ref["h"]],
                                   rtol=MESH_ADAPT_RTOL)
        assert np.abs(got["u"] - ref["u"]).max() <= MESH_ADAPT_RTOL * inc
    else:
        assert got["t"] == pytest.approx(ref["t"], rel=1e-12)
        assert np.abs(got["u"] - ref["u"]).max() <= 1e-5 * inc


def per_rank(runs, n, label):
    return [runs["ranks"][n][r]["mesh_forms"][label]
            for r in sorted(runs["ranks"][n])]


def increment(label, u):
    _, kind, _ = STEPS[label]
    return float(np.abs(u - forms_start(kind, forms_problem(kind)[1])).max())


@pytest.mark.parametrize("label", sorted(STEPS))
def test_mesh_form_steps_match_one_rank_and_reference(runs, label):
    """Each form's step on 2 and 4 ranks: every rank the same error
    norm; float64 paths to rtol=atol=1e-9 of the one-rank step (and of
    the reference's), float32 sweeps within 1e-5 of the increment.  The
    x-slab keeps its halo-slab kernels (B9) where the one card runs its
    kernels; the flux form and with-G states take the unfused step as
    the reference's take XLA's; the spectral and block pcs take the
    sharded basis-GEMM apply (the FFT form its gathered apply), in the
    pc dtype asked."""
    one = runs["one"][label]
    _, kind, nm = STEPS[label]
    for n in (2, 4):
        outs = per_rank(runs, n, label)
        assert len({o["enorm"] for o in outs}) == 1
        got = outs[0]
        if label in F64:
            np.testing.assert_allclose(got["u"], one["u"], rtol=1e-9,
                                       atol=1e-9)
            assert got["enorm"] == pytest.approx(one["enorm"], rel=1e-8)
        else:
            assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * increment(
                label, one["u"])
        info = got["info"]
        assert "'mesh_shape': (%d, 1)" % n in info
        if kind in ("flux", "with_g"):
            assert "'kernels': None" in info
        else:
            assert "halo-slab (B9) over %d x-slabs" % n in info
        if nm.get("pc_type") == "none":
            assert "'pc': None" in info
        elif nm.get("pc_fft") == "on":
            assert "FFT, gathered" in info
        else:
            assert "one all_reduce per apply" in info
            assert ("spectral" in info) == (nm.get("pc_type") == "spectral")
        if "pc_dtype" in nm:
            assert "'pc_dtype': '%s'" % nm["pc_dtype"] in info
    if label in runs["ref"]:
        ref = runs["ref"][label]
        got = per_rank(runs, 2, label)[0]
        if label in F64:
            np.testing.assert_allclose(got["u"], ref, rtol=1e-9, atol=1e-9)
        else:
            assert np.abs(got["u"] - ref).max() <= 1e-5 * increment(label,
                                                                      ref)


@pytest.mark.parametrize("label", ["eigen1d", "validate1d"])
def test_mesh_1d_solver(runs, label):
    """The Solver on a 1D mesh (a 128-point grid over 2 and 4 ranks,
    one (sw, ) halo block a side): options92 adaptive and options93
    with its rho source at fixed dt, each with the same k, failures and
    stats as one rank, t within ADAPT_RTOL of it, and held against the
    reference's Solver from the same start (``hold_reference``);
    options93's states also within 1e-5 of the increment of one rank."""
    one, ref = runs["one"][label], runs["ref"][label]
    u0 = forms_start(label, forms_problem(label)[1])
    for n in (2, 4):
        outs = per_rank(runs, n, label)
        for got in outs:
            assert (got["k"], got["failures"], got["stats"],
                    got["records"]) == (outs[0]["k"], outs[0]["failures"],
                                        outs[0]["stats"], outs[0]["records"])
        got = outs[0]
        assert "'mesh_shape': (%d,)" % n in got["info"]
        assert (got["k"], got["failures"], got["stats"]) == (
            one["k"], one["failures"], one["stats"])
        assert got["t"] == pytest.approx(one["t"], rel=ADAPT_RTOL)
        hold_reference(got, ref, u0, adaptive=label == "eigen1d")
    if label == "validate1d":
        got = per_rank(runs, 4, label)[0]
        inc = np.abs(ref["u"] - u0).max()
        assert ref["k"] == got["k"] == 4
        assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * inc


def test_mesh_flux_form_solver(runs):
    """The flux form's adaptive Solver (its halo 2*sw rows wide: the
    nested first-derivative stencils) over 2 and 4 ranks: the same k,
    failures and stats as one rank, t within ADAPT_RTOL of it, held
    against the reference's flux-form Solver (``hold_reference``), and
    sum(rho) conserved over the run to 1e-9 relative on every rank."""
    one, ref = runs["one"]["flux_solver"], runs["ref"]["flux_solver"]
    u0 = forms_start("flux", forms_problem("flux")[1])
    for n in (2, 4):
        for got in per_rank(runs, n, "flux_solver"):
            assert (got["k"], got["failures"], got["stats"]) == (
                one["k"], one["failures"], one["stats"])
            assert got["t"] == pytest.approx(one["t"], rel=ADAPT_RTOL)
            hold_reference(got, ref, u0, adaptive=True)
            mass = [rec[4] for rec in got["records"]]
            assert max(abs(m - mass[0]) for m in mass) <= 1e-9 * mass[0]


def test_mesh_with_g_solver(runs):
    """A with-G Solver (G refreshed after every accept, pointwise: no
    halo) over 2 and 4 ranks: within 1e-5 of the increment of one rank
    and of the reference's with-G Solver (``hold_reference``, the
    increment of the physical fields), the G slot equal to G of the
    physical fields."""
    one, ref = runs["one"]["with_g_solver"], runs["ref"]["with_g_solver"]
    _, _, ops = forms_problem("with_g")
    u0 = forms_start("with_g", ops.grid)
    inc = np.abs(one["u"][:-1] - u0[:-1]).max()
    for n in (2, 4):
        got = per_rank(runs, n, "with_g_solver")[0]
        assert (got["k"], got["stats"]) == (one["k"], one["stats"])
        assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * inc
        hold_reference(got, ref, u0, adaptive=False, fields=slice(0, -1))
        u = torch.from_numpy(got["u"])
        np.testing.assert_allclose(
            got["u"][-1], ops.refresh_G(u, got["t"])[-1].numpy(),
            rtol=1e-12)




@pytest.mark.parametrize("label", sorted(ENSEMBLES))
def test_mesh_ensembles(runs, label):
    """Two members, each split over 2 and 4 ranks (the unfused step, the
    halo rows of both members in one exchange): per member k, t, h and
    failures equal on every rank; k, failures and the device loop's
    totals equal to the one-rank ensemble's, t and h within
    MESH_ADAPT_RTOL of it on the adaptive runs; at fixed dt t and h
    equal, the noise draws (at the global shape) bit-equal and the
    states within 1e-5 of the increment.  Against the reference's
    EnsembleSolver ("xla" flavour, per step; the noise run drawing the
    port's normals): k and failures equal, at fixed dt t and h equal and
    the states within 1e-5 of the increment, adaptive t, h and the
    states within MESH_ADAPT_RTOL."""
    one = runs["one"][label]
    ref = runs["ref"]["ens_step" if label == "ens_loop" else label]
    _, nm, _, _ = ENSEMBLES[label]
    fixed = nm.get("adapt_type") == "none"
    inc = np.abs(one["u"] - ensemble_start()).max()
    ref_inc = np.abs(ref["u"] - ensemble_start()).max()
    for n in (2, 4):
        outs = per_rank(runs, n, label)
        for got in outs:
            assert (got["k"], got["t"], got["h"], got["failures"],
                    got["totals"]) == (outs[0]["k"], outs[0]["t"],
                                       outs[0]["h"], outs[0]["failures"],
                                       outs[0]["totals"])
        got = outs[0]
        assert "'kernels': None" in got["info"]
        assert got["k"] == one["k"] and got["failures"] == one["failures"]
        assert got["totals"] == one["totals"]
        assert len(got["draws"]) == len(one["draws"])
        for a, b in zip(got["draws"], one["draws"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["k"], ref["k"])
        np.testing.assert_array_equal(got["failures"], ref["failures"])
        if fixed:
            assert got["t"] == one["t"] and got["h"] == one["h"]
            assert np.abs(got["u"] - one["u"]).max() <= 1e-5 * inc
            np.testing.assert_array_equal(got["t"], ref["t"])
            np.testing.assert_array_equal(got["h"], ref["h"])
            assert np.abs(got["u"] - ref["u"]).max() <= 1e-5 * ref_inc
        else:
            # an accept's h comes from an embedded error norm over
            # float32 sweeps, whose reductions the ranks split
            for key in ("t", "h"):
                np.testing.assert_allclose(got[key], one[key],
                                           rtol=MESH_ADAPT_RTOL)
                np.testing.assert_allclose(got[key], ref[key],
                                           rtol=MESH_ADAPT_RTOL)
            assert np.abs(got["u"] - ref["u"]).max() <= \
                MESH_ADAPT_RTOL * ref_inc
    if nm.get("device_loop"):
        assert "'dispatches': 1" in one["totals"]
    if label == "ens_noise":
        assert len(one["draws"]) == 4


def test_flux_form_needs_its_reach():
    """The flux form reads 2*sw rows beyond a point: a split whose blocks
    hold fewer rows than that raises ValueError naming the reach (a
    block takes halo rows from its next neighbours only); the product
    rule's sw rows fit the same split."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel.mesh import SlabMesh
    from ksfd_tpu_torch.solvers import make_step_fn

    _, grid, flux = forms_problem("flux")
    _, _, plain = forms_problem("bench")
    n = grid.nps[0] // grid.stencil_width
    mesh = SlabMesh(grid, None, (1, n), 0, "gloo", "cpu", ["cpu"] * n)
    assert flux.reach == 2 * plain.reach == 2 * grid.stencil_width
    make_step_fn(plain, NumericsOptions(), mesh=mesh)
    with pytest.raises(ValueError, match="narrower than the stencil reach"):
        make_step_fn(flux, NumericsOptions(), mesh=mesh)
