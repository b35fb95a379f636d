"""The port's fixed-dt main path against ksfd_tpu on the CPU.

The reference runs its default numerics with the Pallas kernels in
interpret mode (KSFD_PALLAS_INTERPRET=1, as tests/test_pallas.py does);
the port runs the plain versions of its kernels.  States agree to
1e-5 of the increment, the mixed-precision envelope of
tests/test_pallas.py.  The embedded error norm agrees to 1e-2
relative: at these accepted steps it is a cancelling sum far below the
increments, so the float32 sweeps' rounding moves it (the reference's
own float64 16-sweep solve moves it by 0.4% at 64^2, h=1e-3).
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu.solvers import make_multistep_fn as jmultistep
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import (
    numpy_from_tensors,
    problem_from_clargs,
    tensors_from_numpy,
)
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.parallel.mesh import SlabMesh
from ksfd_tpu_torch import ops as KT_ops
from ksfd_tpu_torch import solvers as tsolver
from ksfd_tpu_torch.solvers import linalg as tlinalg
from ksfd_tpu_torch.solvers import make_multistep_fn, make_step_fn

N = 64
H = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def problems():
    jps, _, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return jops, tops


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


def rough_state(seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal((N, N))),
        6000 + scale * np.abs(rng.standard_normal((N, N))),
        6000 + 0.5 * scale * np.abs(rng.standard_normal((N, N))),
    ])


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


def test_step_matches_reference(problems, interpret):
    jops, tops = problems
    u0 = np.array(jops.groom(jnp.asarray(rough_state())))
    step_j, _ = jstep(jops, KJ.NumericsOptions(), atol=0.01, rtol=1e-6)
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0), jnp.asarray(H))
    step_t, tab = make_step_fn(tops, NumericsOptions(), atol=0.01, rtol=1e-6)
    assert tab.name == "ros34pw2"
    u1, e = step_t(torch.from_numpy(u0), scalar(0.0), scalar(H))
    assert u1.dtype == torch.float64 and e.dim() == 0
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u1.numpy() - u_ref).max() / inc < 1e-5
    assert float(e_ref) < 1.0
    assert abs(float(e) - float(e_ref)) <= 1e-2 * float(e_ref)


def test_multistep_chain_matches_reference(problems, interpret):
    jops, tops = problems
    u0 = np.array(jops.groom(jnp.asarray(rough_state())))
    multi_j, _ = jmultistep(jops, KJ.NumericsOptions(), atol=0.01,
                            rtol=1e-6, static_steps=False)
    u_ref, t_ref, e_ref = multi_j(jnp.asarray(u0), jnp.asarray(0.0),
                                  jnp.asarray(H), 6)
    multi_t, _ = make_multistep_fn(tops, NumericsOptions(), atol=0.01,
                                   rtol=1e-6, static_steps=False)
    u6, t6, e6 = multi_t(torch.from_numpy(u0), scalar(0.0), scalar(H), 6)
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u6.numpy() - u_ref).max() / inc < 1e-5
    assert abs(float(t6) - float(t_ref)) < 1e-15
    assert abs(float(e6) - float(e_ref)) <= 1e-2 * float(e_ref)


def test_launch_counts_per_step(problems):
    """Per step: 8 resid (2 per stage solve), 4 delta (3 stage RHS and
    the f0 advance), 0 jvp, 0 rhs.  On the CPU the wrappers run their plain
    bodies, so the bodies' calls are counted here."""
    _, tops = problems
    kern = make_fused_kernels(tops)
    calls = {name: 0 for name in kern.kernels}
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    multi, _ = make_multistep_fn(tops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6, kernels=kern)
    u, t, e = multi(torch.from_numpy(rough_state()), scalar(0.0),
                    scalar(H), 3)
    assert calls == dict(rhs=0, jvp=0, resid=24, delta=12)
    assert all(k.launches == 0 for k in kern.kernels.values())
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(e))
    assert abs(float(t) - 3 * H) < 1e-15


# each case keeps the id it had when the list held the options that
# the DIRK path, the pc forms and the fixed-count Krylov tiers now run
# (test_ported_options_step); "gmres_fixed" is no ksp_type of the
# reference's (its solver function, ksp_type gmres)
@pytest.mark.parametrize("change", [
    dict(ksp_type="gmres_fixed"), dict(precision="bfloat16"),
], ids=["change2", "change5"])
def test_off_path_options_raise(problems, change):
    _, tops = problems
    numerics = dataclasses.replace(NumericsOptions(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP|item"):
        make_step_fn(tops, numerics)


@pytest.mark.parametrize("change", [
    dict(pc_type="spectral"), dict(pc_fft="on"), dict(pc_dtype="bfloat16"),
    dict(ts_type="ark324"), dict(pc_fft="auto"), dict(ts_type="ark436"),
    dict(ts_type="arkimex"), dict(ksp_type="gmres"),
    dict(ksp_type="gmres_rolled", ksp_restart=6, ksp_max_it=2),
    dict(ksp_type="gmres_restarted"), dict(pc_type="none"),
], ids=["change3", "change6", "change8", "change9", "change10", "change11",
        "change12", "change0", "change1", "change4", "change7"])
def test_ported_options_step(change):
    """The options that raised until the DIRK path (ROADMAP Queue A item
    7), the pc forms (item 8) and the fixed-count Krylov tiers (item 9)
    were ported build and take one finite 32^2 step on the CPU, as
    test_off_path_options_raise's cases once raised under the same ids
    (tests/test_torch_krylov.py holds the Krylov steps against the
    reference's)."""
    jps, _, _ = ge._make_problem(32, 32)
    _, _, tops = problem_from_clargs(jps.clargs, 32, 32, device="cpu")
    numerics = dataclasses.replace(NumericsOptions(), **change)
    step, _ = make_step_fn(tops, numerics, atol=0.01, rtol=1e-6)
    u0 = torch.from_numpy(rough_state()[:, :32, :32].copy())
    u1, enorm = step(u0, scalar(0.0), scalar(H))
    assert u1.shape == u0.shape and u1.dtype == torch.float64
    assert bool(torch.isfinite(u1).all()) and bool(torch.isfinite(enorm))
    assert float((u1 - u0).abs().max()) > 0.0


@pytest.mark.parametrize("build,item", [
    (lambda ops: tsolver.make_adaptive_chunk_fn(ops, mesh=object()),
     "grid_mesh"),
    # the spectral pc on a mesh, once refused, takes the sharded apply
    # (tests/test_torch_mesh_forms.py runs it over ranks)
    (lambda ops, n=2: tsolver.make_step_fn(
        ops, NumericsOptions(pc_type="spectral"), atol=0.01, rtol=1e-6,
        mesh=SlabMesh(ops.grid, None, (n, 1), 0, "gloo", "cpu",
                      ["cpu"] * n)),
     None),
], ids=["<lambda>-item 14", "<lambda>-item 8"])
def test_later_entry_points_raise(problems, build, item):
    """A mesh that is not parallel.grid_mesh's raises TypeError naming
    it.  The spectral pc builds its sharded apply on a 2-rank mesh and,
    on a one-rank mesh, steps within 1e-5 of the increment of the
    one-card step."""
    _, tops = problems
    if item is not None:
        with pytest.raises(TypeError, match=item):
            build(tops)
        return
    step, _ = build(tops)
    assert step.build_info["pc"].startswith("sharded spectral basis-GEMM")
    u0 = tops.groom(torch.from_numpy(rough_state()))
    args = (u0, scalar(0.0), scalar(H))
    want = tsolver.make_step_fn(tops, NumericsOptions(pc_type="spectral"),
                                atol=0.01, rtol=1e-6)[0](*args)[0]
    got = build(tops, n=1)[0](*args)[0]
    inc = float((want - u0).abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * inc


def test_mesh_not_ported(problems):
    """A mesh that is not parallel.grid_mesh's raises TypeError naming
    it."""
    _, tops = problems
    with pytest.raises(TypeError, match="grid_mesh"):
        make_step_fn(tops, NumericsOptions(), mesh=object())


def test_interop_round_trip(problems):
    """State, base RHS and preconditioner basis carried across as
    numpy reproduce the reference's arrays and its pc apply."""
    jops, tops = problems
    u = jnp.asarray(rough_state(seed=4))
    arrays = dict(
        state=np.asarray(u), f0=np.asarray(jops.rhs(u, 0.0)),
    )
    tens = tensors_from_numpy(arrays, device="cpu")
    assert tens["state"].dtype == torch.float64
    assert tuple(tens["state"].shape) == (3, N, N)
    back = numpy_from_tensors(tens)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    np.testing.assert_allclose(
        tops.rhs(tens["state"], 0.0).numpy(), arrays["f0"],
        rtol=0, atol=1e-12 * np.abs(arrays["f0"]).max(),
    )
    jpc = jlinalg.BlockSpectralPreconditioner(jops.grid, jops,
                                              compute_dtype="float64")
    tpc = tlinalg.BlockSpectralPreconditioner(tops.grid, tops,
                                              compute_dtype="float64",
                                              device="cpu")
    Qx, Qy, lam = tensors_from_numpy(
        [np.asarray(jpc.Qs[0]), np.asarray(jpc.Qs[1]), np.asarray(jpc.lam)],
        device="cpu",
    )
    tpc.load_state_dict(dict(Qx=Qx, Qy=Qy, lam=lam))
    v = np.random.default_rng(5).standard_normal((3, N, N))
    means = [9000.0, 6000.0, 800.0]
    ref = np.asarray(jpc.apply_linearized(
        jnp.asarray(v), 100.0, 0.0, [jnp.asarray(m) for m in means], 2.0))
    out = tpc.apply_linearized(
        torch.from_numpy(v), 100.0, 0.0,
        [torch.tensor(m, dtype=torch.float64) for m in means], 2.0).numpy()
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


_FORBIDDEN_IMPORT = re.compile(
    r"^(import|from)\s+(jax|ksfd_tpu|helpers|tests|__graft_entry__)"
    r"(\s|\.|,|$)")


def test_port_source_has_no_jax_import():
    """No module of the port (its tools/ included), nor chip_smoke.py,
    imports jax, the JAX package, __graft_entry__ or the reference's
    test helpers (tests/helpers.py): the port keeps its own copy of
    what it needs (``import ksfd_tpu_torch`` is the port itself)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ksfd_tpu_torch")):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    for name in ("fused_stencil3d.py", "ensemble.py", "ic.py",
                 "randomfield.py", os.path.join("native", "banded.py"),
                 "banded_path.py", "direct.py",
                 os.path.join("tools", "probe_coeff_kernel.py"),
                 os.path.join("tools", "problems.py"),
                 os.path.join("tools", "validate.py"),
                 os.path.join("tools", "flagship.py"),
                 os.path.join("tools", "peakstats.py")):
        assert any(p.endswith(name) for p in paths), name
    for path in paths:
        with open(path) as fh:
            for line in fh:
                assert not _FORBIDDEN_IMPORT.match(line.strip()), (path, line)
    for line in ("import ksfd_tpu", "import jax", "from ksfd_tpu.ops import x",
                 "import ksfd_tpu as K", "from jax import numpy",
                 "from helpers import make_clargs",
                 "from tests.helpers import OPTIONS92_PARAMS",
                 "import __graft_entry__ as ge"):
        assert _FORBIDDEN_IMPORT.match(line), line
    assert not _FORBIDDEN_IMPORT.match("import ksfd_tpu_torch")


def test_chip_smoke_problem_matches_helpers():
    """chip_smoke.py keeps its own copy of the reference's test
    parameters and of make_clargs (tests/helpers.py); the copies agree,
    so a change to either shows here."""
    import chip_smoke
    import helpers

    assert chip_smoke.OPTIONS92_PARAMS == helpers.OPTIONS92_PARAMS
    for kw in (dict(), dict(params=["dim=2"], source=["x"], seed=3,
                            cappotential="linear", extra=1)):
        assert vars(chip_smoke.make_clargs(**kw)) == vars(
            helpers.make_clargs(**kw))
    jps, _, _ = ge._make_problem(16, 16)
    assert vars(chip_smoke.bench_clargs(16)) == vars(jps.clargs)


_NO_JAX = r"""
import os
import sys
sys.modules["jax"] = None
sys.path[:0] = [ROOT]
import torch
from chip_smoke import OPTIONS92_PARAMS, make_clargs
import ksfd_tpu_torch
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.solvers import make_multistep_fn
keep = ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
params = [p for p in OPTIONS92_PARAMS if p.split("=", 1)[0] not in keep]
params += ["nelements=16", "dim=2", "height=1", "rho0=murho + arho*x",
           "U0_1_1=", "U0_2_1="]
ps, grid, ops = problem_from_clargs(make_clargs(params=params), 16, 16,
                                    device="cpu")
multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01, rtol=1e-6)
u0 = torch.full(grid.Vshape, 9000.0, dtype=torch.float64)
u0[0, 3, 4] += 1.0
u, t, e = multi(u0, torch.tensor(0.0, dtype=torch.float64),
                torch.tensor(1.0, dtype=torch.float64), 2)
assert torch.isfinite(u).all() and torch.isfinite(e)
assert float(t) == 2.0
# the sharded multistep over a one-rank gloo mesh (the slab wraps onto
# itself) agrees with the unsharded one
import tempfile
import torch.distributed as dist
import ksfd_tpu_torch.parallel as par
store = os.path.join(tempfile.mkdtemp(), "store")
dist.init_process_group("gloo", init_method="file://" + store, rank=0,
                        world_size=1)
mesh = par.grid_mesh(grid, device="cpu")
multi_s, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01, rtol=1e-6,
                               mesh=mesh)
u_s, t_s, e_s = multi_s(par.distribute(u0, grid, mesh)[0],
                        torch.tensor(0.0, dtype=torch.float64),
                        torch.tensor(1.0, dtype=torch.float64), 2)
dist.destroy_process_group()
assert float((u_s - u).abs().max()) <= 1e-5 * float((u - u0).abs().max())
assert sys.modules["jax"] is None
assert "ksfd_tpu" not in sys.modules and "helpers" not in sys.modules
assert not [m for m in sys.modules if m.startswith(("jax.", "ksfd_tpu."))]
print("OK", float(e))
"""


_DEFAULT_DEVICE_BUILDS = {
    "problem_from_clargs": lambda tops: problem_from_clargs(
        tops.ps.clargs, 8, 8),
    "tensors_from_numpy": lambda tops: tensors_from_numpy(np.zeros(3)),
    "PDEOperators": lambda tops: KT_ops.PDEOperators(tops.ps, tops.grid),
    "SpatialExpression": lambda tops: KT_ops.SpatialExpression(
        tops.ps, tops.grid, "x"),
    "SpectralPreconditioner": lambda tops: tlinalg.SpectralPreconditioner(
        tops.grid),
    "BlockSpectralPreconditioner":
        lambda tops: tlinalg.BlockSpectralPreconditioner(tops.grid, tops),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE_BUILDS))
def test_entry_points_default_to_the_card(problems, entry):
    """An entry point told no device runs on the card; without one it
    raises rather than building on the CPU."""
    _, tops = problems
    build = _DEFAULT_DEVICE_BUILDS[entry]
    if torch.cuda.is_available():
        built = build(tops)
        devices = {t.device.type for t in _tensors_of(built)}
        assert devices == {"cuda"}, devices
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(tops)


def _tensors_of(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.buffers())
    if isinstance(obj, tuple):
        return [t for o in obj for t in _tensors_of(o)]
    if hasattr(obj, "device"):  # operators, spatial expressions
        return [torch.empty(0, device=obj.device)]
    return []


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", "ROOT = %r\n" % ROOT + _NO_JAX],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
