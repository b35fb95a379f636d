"""The port's 3D fixed-dt main path against ksfd_tpu on the CPU.

The problem is ``examples/aggregation3d`` (rho plus an attractant and a
repellent ligand group, degree 3) on a non-cubic 16 x 8 x 16 grid that
the reference's 3D Pallas kernels accept in interpret mode
(KSFD_PALLAS_INTERPRET=1, as tests/test_3d.py runs them).  Each case
feeds the same seeded numpy inputs through both packages.  Tolerances:
float64 operators and the float64 preconditioner to 1e-12 relative;
the float32 preconditioner to 1e-5; the plain versions of the float32
kernels to 1e-5 of the reference's largest value (the 2D bound of
tests/test_torch_kernels.py), the delta kernel also to 3e-6 of the
float64 oracle increment (tests/test_3d.py's bound); steps to 1e-5 of
the increment (tests/test_torch_solver.py).

csrc/stencil3d.cu runs here too: its kernel bodies compile as host C++
(the CUDA qualifiers defined away, one thread walking each block) and
are held against the plain versions at this size and at an odd one.
The CUDA build itself runs only on a card (``cuda`` marker;
chip_smoke.py runs the same comparison at 256^3 x 3).
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ksfd_tpu as KJ
from helpers import make_clargs
from ksfd_tpu.ops.pallas_stencil import make_pallas_kernels
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu.solvers import make_multistep_fn as jmultistep
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import (
    numpy_from_tensors,
    problem_from_clargs,
    tensors_from_numpy,
)
from ksfd_tpu_torch.ops.codegen import pointwise_header
from ksfd_tpu_torch.ops.fused_stencil import kernels_available, make_fused_kernels
from ksfd_tpu_torch.ops.fused_stencil3d import CSRC3D
from ksfd_tpu_torch.ops.stencil import deriv_coeffs
from ksfd_tpu_torch.solvers import linalg as tlinalg
from ksfd_tpu_torch.solvers import make_multistep_fn, make_step_fn
from ksfd_tpu_torch.tools.problems import example_params, with_fields

SHAPE = (16, 8, 16)
# at this size and h=1e-3 the embedded error norm (~3e-6) is float32
# rounding of the sweeps; at 1e-2 (~8e-4) it carries the step's error
H = 1e-2


def aggregation3d_params(n, dof=3):
    """The parameter lines of examples/aggregation3d, nelements=n, with
    ``dof`` fields (tools/problems.py ``with_fields``)."""
    return with_fields(example_params("aggregation3d"), dof) + [
        "nelements=%d" % n]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


def _problems(shape):
    clargs = make_clargs(params=aggregation3d_params(shape[0]))
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=3, width=1, height=1, depth=1, nx=shape[0],
                    ny=shape[1], nz=shape[2], dof=3, order=3)
    jops = KJ.ops.PDEOperators(jps, jgrid)
    _, tgrid, tops = problem_from_clargs(clargs, *shape, device="cpu")
    assert tgrid.state() == jgrid.state()
    return jops, tops


@pytest.fixture(scope="module")
def problems():
    return _problems(SHAPE)


@pytest.fixture(scope="module")
def pallas(problems):
    """The reference's 3D Pallas kernels in interpret mode."""
    return make_pallas_kernels(problems[0], interpret=True)


def rough_state(shape=SHAPE, seed=0, scale=1000.0, dof=3):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + f * scale * np.abs(rng.standard_normal(shape))
        for f in ((3, 1, 0.5) + (0.25,) * max(0, dof - 3))[:dof]
    ])


def wave_state(shape=SHAPE, dof=3):
    """Near-uniform fields with ~1-amplitude structure along all axes."""
    X, Y, Z = np.meshgrid(*[np.arange(n) / n for n in shape], indexing="ij")
    wave = np.sin(2 * np.pi * (X + Y + Z))
    return np.stack([9000 + a * wave for a in (1, 0.7, 0.1, 0.4)[:dof]])


def with_clamps(u, ops):
    """Points below, at and NaN against the floors (active clamps); on a
    grid thinner than a point's index the index wraps."""
    u = u.copy()
    nx, ny, nz = u.shape[1:]
    u[0, 3 % nx, 5 % ny, 2] = 0.5 * ops.rhomin
    u[0, 7 % nx, 2, nz - 1] = ops.rhomin
    u[1, 4 % nx, 4 % ny, 0] = ops.Umin
    u[-1, nx - 1, ny - 1, 9 % nz] = np.nan
    return u


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


# ---------------------------------------------------------------- operators


def test_problem_and_free_energy_match(problems):
    jops, tops = problems
    assert tops.grid.Vshape == (3,) + SHAPE
    assert str(jops.G_expr) == str(tops.G_expr)
    assert tops.stage_delta_ok() == jops.stage_delta_ok() is True
    means = [9000.0, 9000.0, 9000.0]
    jc = jops.linearization_coefficients([jnp.asarray(m) for m in means], 0.0)
    tc = tops.linearization_coefficients([scalar(m) for m in means], 0.0)
    for ja, ta in zip(jc, tc):
        np.testing.assert_allclose(
            [float(x) for x in ta], [float(x) for x in ja], rtol=1e-14
        )


def test_groom_matches(problems):
    jops, tops = problems
    u = with_clamps(rough_state(seed=2) - 6500.0, tops)
    np.testing.assert_array_equal(
        tops.groom(torch.as_tensor(u)).numpy(),
        np.asarray(jops.groom(jnp.asarray(u))),
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_rhs_matches(problems, seed):
    jops, tops = problems
    u = rough_state(seed=seed)
    ref = jops.rhs(jnp.asarray(u), 0.5)
    out = tops.rhs(torch.as_tensor(u), 0.5)
    assert out.dtype == torch.float64 and out.shape == (3,) + SHAPE
    assert rel(out.numpy(), ref) < 1e-12


def test_jacobian_action_matches(problems):
    jops, tops = problems
    u = rough_state(seed=5)
    v = np.random.default_rng(6).standard_normal(u.shape)
    ref = jops.jacobian_action(jnp.asarray(u), 0.5, jnp.asarray(v))
    out = tops.jacobian_action(torch.as_tensor(u), 0.5, torch.as_tensor(v))
    assert rel(out.numpy(), ref) < 1e-12


# ------------------------------------------------- kernels (plain versions)


@pytest.mark.parametrize("state", ["rough", "wave"])
def test_plain_resid_and_jvp_match_pallas(problems, pallas, state):
    _, tops = problems
    fk = make_fused_kernels(tops)
    rng = np.random.default_rng(1)
    u = with_clamps(rough_state() if state == "rough" else wave_state(), tops)
    u, v, b = (a.astype(np.float32) for a in (
        u, rng.standard_normal(u.shape), rng.standard_normal(u.shape)))
    ref = np.asarray(pallas.jvp(jnp.asarray(u), jnp.asarray(v), 0.5))
    out = fk.jvp(torch.from_numpy(u), torch.from_numpy(v), 0.5)
    assert out.dtype == torch.float32 and np.isfinite(ref).all()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    ref = np.asarray(pallas.resid(*[jnp.asarray(a) for a in (u, v, b)],
                                  0.5, 7.5))
    out = fk.resid(*[torch.from_numpy(a) for a in (u, v, b)], 0.5, 7.5)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("state,scale", [
    ("rough", 100.0), ("wave", 1e-3), ("floor", None),
])
def test_plain_delta_matches_pallas_and_oracle(problems, pallas, state,
                                               scale):
    jops, tops = problems
    fk = make_fused_kernels(tops)
    rng = np.random.default_rng(3)
    u0 = jops.groom(jnp.asarray(wave_state() if state == "wave"
                                else rough_state()))
    if state == "floor":
        # a fifth of the points clamp to the floor (the big branch)
        drop = rng.random(u0.shape) < 0.2
        d = jnp.asarray(np.where(drop, -2.0 * np.asarray(u0),
                                 100.0 * rng.standard_normal(u0.shape)))
    else:
        d = jnp.asarray(scale * rng.standard_normal(u0.shape))
    ug = jops.groom(u0 + d)
    dd = ug - u0
    ref = np.asarray(pallas.delta(u0, dd, ug, 0.5))
    out = fk.delta(*[torch.from_numpy(np.array(a)) for a in (u0, dd, ug)],
                   0.5).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    oracle = np.asarray(jops.rhs(ug, 0.5) - jops.rhs(u0, 0.5))
    assert rel(out, oracle) < 3e-6


# --------------------------------------------------------- preconditioner


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("use_rho_diff", [True, False])
def test_apply_linearized_matches(problems, dtype, tol, use_rho_diff):
    jops, tops = problems
    jpc = jlinalg.BlockSpectralPreconditioner(jops.grid, jops,
                                              compute_dtype=dtype)
    tpc = tlinalg.BlockSpectralPreconditioner(tops.grid, tops,
                                              compute_dtype=dtype,
                                              device="cpu")
    assert tuple(tpc.lam.shape) == SHAPE and tpc.lam_cd.dtype == getattr(
        torch, dtype)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(jops.grid.Vshape)
    means = [9000.0, 6000.0, 800.0]
    rd = 3.0 if use_rho_diff else None
    shift = 1.0 / (1e-2 * 0.435866521508459)
    ref = jpc.apply_linearized(jnp.asarray(v), shift, 0.0,
                               [jnp.asarray(m) for m in means], rho_diff=rd)
    out = tpc.apply_linearized(torch.as_tensor(v), shift, 0.0,
                               [scalar(m) for m in means], rho_diff=rd)
    assert out.dtype == torch.float64
    assert rel(out.numpy(), ref) < tol


def test_spectral_apply_matches(problems):
    jops, tops = problems
    jpc = jlinalg.SpectralPreconditioner(jops.grid, compute_dtype="float64")
    tpc = tlinalg.SpectralPreconditioner(tops.grid, compute_dtype="float64",
                                         device="cpu")
    v = np.random.default_rng(8).standard_normal(jops.grid.Vshape)
    diff, decay = tops.stiff_coefficients(0.0)
    ref = jpc.apply(jnp.asarray(v), 50.0, diff, decay)
    out = tpc.apply(torch.as_tensor(v), 50.0, diff, decay)
    assert rel(out.numpy(), ref) < 1e-12


def test_interop_round_trip_3d(problems):
    """A 3D state and the reference's per-axis bases carried across as
    numpy keep the (dof, nx, ny, nz) layout and reproduce the
    reference's pc apply; lam_cd follows a loaded lam."""
    jops, tops = problems
    u = rough_state(seed=4)
    tens = tensors_from_numpy(dict(state=u), device="cpu")
    assert tuple(tens["state"].shape) == (3,) + SHAPE
    np.testing.assert_array_equal(numpy_from_tensors(tens)["state"], u)
    jpc = jlinalg.BlockSpectralPreconditioner(jops.grid, jops,
                                              compute_dtype="float32")
    tpc = tlinalg.BlockSpectralPreconditioner(tops.grid, tops,
                                              compute_dtype="float32",
                                              device="cpu")
    Qx, Qy, Qz, lam = tensors_from_numpy(
        [np.asarray(q, dtype=np.float32) for q in jpc.Qs]
        + [2.0 * np.asarray(jpc.lam)], device="cpu")
    tpc.load_state_dict(dict(Qx=Qx, Qy=Qy, Qz=Qz, lam=lam))
    assert torch.equal(tpc.lam_cd, lam.float())


# ------------------------------------------------------------- main path


def test_step_matches_reference(problems, interpret):
    jops, tops = problems
    u0 = np.array(jops.groom(jnp.asarray(rough_state())))
    step_j, _ = jstep(jops, KJ.NumericsOptions(), atol=0.01, rtol=1e-6)
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0), jnp.asarray(H))
    step_t, _ = make_step_fn(tops, NumericsOptions(), atol=0.01, rtol=1e-6)
    u1, e = step_t(torch.from_numpy(u0), scalar(0.0), scalar(H))
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
                                  jnp.asarray(H), 4)
    multi_t, _ = make_multistep_fn(tops, NumericsOptions(), atol=0.01,
                                   rtol=1e-6)
    u4, t4, e4 = multi_t(torch.from_numpy(u0), scalar(0.0), scalar(H), 4)
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert np.abs(u4.numpy() - u_ref).max() / inc < 1e-5
    assert abs(float(t4) - float(t_ref)) < 1e-15
    assert abs(float(e4) - float(e_ref)) <= 1e-2 * float(e_ref)


def test_launch_counts_per_step(problems):
    """Per 3D step: 8 resid, 4 delta, 0 jvp and 0 rhs (the plain bodies'
    calls, counted on the CPU; no kernel launch)."""
    _, tops = problems
    kern = make_fused_kernels(tops)
    assert kern.build.csrc == CSRC3D
    calls = {name: 0 for name in kern.kernels}
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    multi, _ = make_multistep_fn(tops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6, kernels=kern)
    u, t, e = multi(torch.from_numpy(wave_state()), scalar(0.0), scalar(1.0),
                    2)
    assert calls == dict(rhs=0, jvp=0, resid=16, delta=8)
    assert all(k.launches == 0 for k in kern.kernels.values())
    assert bool(torch.isfinite(u).all()) and float(e) < 1.0


def test_small_extent_rejected():
    """The kernels still reject a 3D extent under 2*sw+1, and the gate
    says so; the step then takes the unfused path (the reference's XLA
    path where pallas3d_available refuses), which runs and launches
    nothing (tests/test_torch_unfused.py holds it against the
    reference)."""
    clargs = make_clargs(params=aggregation3d_params(8))
    _, _, ops = problem_from_clargs(clargs, 8, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="2\\*sw\\+1"):
        make_fused_kernels(ops)
    assert not kernels_available(ops.grid, ops)
    multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6)
    assert multi.kernels is None and multi.build_info["kernels"] is None
    assert "2*sw+1" in multi.build_info["kernel_refusal"]
    u, _, e = multi(torch.from_numpy(wave_state((8, 4, 8))), scalar(0.0),
                    scalar(1.0), 2)
    assert bool(torch.isfinite(u).all()) and float(e) < 1.0


# ------------------------------------------------- generated code on the host


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the generated code")
    return cxx


_HEADER_SHIM = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
#include "ksfd_pointwise.cuh"
extern "C" void eval_all(int n, const float* f, const float* d,
                         const float* s, float* G, float* dG, float* Gd) {
  for (int i = 0; i < n; ++i) {
    const float* fi = f + i * KSFD_DOF;
    G[i] = ksfd_G(fi, 0.0F);
    ksfd_dG(fi, 0.0F, dG + i * KSFD_DOF);
    Gd[i] = ksfd_G_delta(fi, d + i * KSFD_DOF, s + i * KSFD_DOF, 0.0F);
  }
}
extern "C" void stencils(const float* p, float* out) {
  // p: 2*KSFD_SW+1 points at stride 1 around p[KSFD_SW]
  const float* c = p + KSFD_SW;
  out[0] = ksfd_d1x(c, 1); out[1] = ksfd_d2x(c, 1);
  out[2] = ksfd_d1y(c, 1); out[3] = ksfd_d2y(c, 1);
  out[4] = ksfd_d1z(c, 1); out[5] = ksfd_d2z(c, 1);
}
"""


def test_generated_header_3d(problems, tmp_path):
    """The 3D header is the 2D one plus a z axis: it compiles as host
    C++, declares KSFD_DIM 3, its six star stencils apply each axis's
    coefficients, and G, dG and G_delta equal the torchify'd float32
    functions to 1e-6 of their largest value."""
    cxx = _cxx()
    _, tops = problems
    text = pointwise_header(tops)
    assert "#define KSFD_DIM 3" in text and "ksfd_d2z" in text
    (tmp_path / "ksfd_pointwise.cuh").write_text(text)
    (tmp_path / "shim.cpp").write_text(_HEADER_SHIM)
    lib = tmp_path / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
                   check=True, capture_output=True)
    shim = ctypes.CDLL(str(lib))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    shim.stencils.argtypes = [ctypes.c_void_p] * 2
    shim.eval_all.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    rng = np.random.default_rng(12)
    p = rng.standard_normal(2 * tops.sw + 1).astype(np.float32)
    out = np.empty(6, np.float32)
    shim.stencils(ptr(p), ptr(out))
    for d in range(3):
        for k, order in enumerate((1, 2)):
            cs = deriv_coeffs(order, tops.sw, tops.spacing[d])
            ref = float(np.dot(cs.astype(np.float32), p))
            assert abs(out[2 * d + k] - ref) <= 1e-5 * np.abs(
                cs * p).sum(), (d, order)
    n = 600
    f = np.stack([300 + 25000 * rng.random(n), 30 + 25000 * rng.random(n),
                  3 + 2500 * rng.random(n)], axis=1)
    d = f * rng.uniform(-0.3, 0.3, size=f.shape)
    s = f + d
    s[400:500, 0] = tops.rhomin
    d = s - f
    f, d, s = (np.ascontiguousarray(a, dtype=np.float32) for a in (f, d, s))
    G, Gd = np.empty(n, np.float32), np.empty(n, np.float32)
    dG = np.empty((n, 3), np.float32)
    shim.eval_all(n, ptr(f), ptr(d), ptr(s), ptr(G), ptr(dG), ptr(Gd))
    cols = lambda a: [torch.from_numpy(a[:, k].copy()) for k in range(3)]
    close = lambda a, b: np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    assert close(G, tops._G_fn(*cols(f), 0.0).numpy())
    for k, fn in enumerate(tops._dG_fns):
        assert close(dG[:, k], fn(*cols(f), 0.0).numpy()), k
    assert close(Gd, tops._G_delta_fn(*cols(f), *cols(d), *cols(s),
                                      0.0).numpy())


_KERNEL_SHIM = r"""
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(n)
struct ksfd_uint3 { unsigned x, y, z; };
static ksfd_uint3 blockIdx, threadIdx;
static inline void __syncthreads() {}
#include "stencil3d.cu"
float ksfd_smem[SMEM_FLOATS_MAX];

// one host thread walks every block of the kernel's 1D launch grid of
// nb members in turn (the grid as the source exports it)
extern "C" int run(int which, const float* sc, const float* a,
                   const float* b, const float* c, float* out, int nx,
                   int ny, int nz, int nb) {
  threadIdx = {0, 0, 0};
  const long long blocks = ksfd_blocks(which, nx, ny, nz, nb);
  for (long long bx = 0; bx < blocks; ++bx) {
    blockIdx = {(unsigned)bx, 0, 0};
    if (which == 0) jvp_kernel<false>(sc, a, b, nullptr, out, nx, ny, nz);
    if (which == 1) jvp_kernel<true>(sc, a, b, c, out, nx, ny, nz);
    if (which == 2) delta_kernel(sc, a, b, c, out, nx, ny, nz);
    if (which == 3) rhs_kernel(sc, a, out, nx, ny, nz);
  }
  return 0;
}
"""


#: the host harness's kernel numbers
HOST_KERNELS = dict(jvp=0, resid=1, delta=2, rhs=3)


def host_kernels_3d(tops, tmp_path, source=None):
    """csrc/stencil3d.cu's kernel bodies (or the text ``source`` in its
    place) compiled as host C++ (KSFD_NT=1) with the problem's header:
    ``run(which, sc, a, b, c, out, nx, ny, nz, nb)``."""
    cxx = _cxx()
    fk = make_fused_kernels(tops)
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "ksfd_pointwise.cuh").write_text(fk.build.header)
    if source is None:
        shutil.copy(CSRC3D, tmp_path / "stencil3d.cu")
    else:
        (tmp_path / "stencil3d.cu").write_text(source)
    (tmp_path / "shim.cpp").write_text(_KERNEL_SHIM)
    lib = tmp_path / "libkern.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-DKSFD_NT=1", "-I",
         str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(lib))
    host.run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 4)
    return fk, host


def host_run_3d(host, name, sc, operands, shape, dof):
    """The host harness on prepared operands (with or without a leading
    member axis); returns the output."""
    nb = int(sc.shape[0]) if sc.dim() == 2 else 1
    ptrs = [x.data_ptr() for x in (sc, *operands)]
    ptrs += [None] * (4 - len(ptrs))
    out = torch.empty(((nb,) if sc.dim() == 2 else ()) + (dof,) + shape,
                      dtype=torch.float32)
    host.run(HOST_KERNELS[name], *ptrs, out.data_ptr(), *shape, nb)
    return out


@pytest.mark.parametrize("shape", [SHAPE, (9, 7, 11)])
def test_cuda_source_bodies_match_plain(shape, tmp_path):
    """The kernel bodies of csrc/stencil3d.cu (rhs on the raw state
    too), compiled as host C++ (KSFD_NT=1), equal the plain versions to
    1e-5 of max|plain| on a tiled grid and on an odd one whose tiles are
    ragged in every axis (the periodic wrap and the bounds guards)."""
    clargs = make_clargs(params=aggregation3d_params(shape[0]))
    _, _, tops = problem_from_clargs(clargs, *shape, device="cpu")
    fk, host = host_kernels_3d(tops, tmp_path)
    rng = np.random.default_rng(9)
    u64 = tops.groom(torch.from_numpy(with_clamps(rough_state(shape), tops)))
    raw = torch.from_numpy(with_clamps(rough_state(shape), tops))
    v = torch.from_numpy(rng.standard_normal(u64.shape))
    b = torch.from_numpy(rng.standard_normal(u64.shape))
    d = torch.from_numpy(100.0 * rng.standard_normal(u64.shape))
    u1 = tops.groom(u64 + d)
    cases = [(0, fk.jvp, (raw, v, 0.5)), (1, fk.resid, (raw, v, b, 0.5, 7.5)),
             (2, fk.delta, (u64, u1 - u64, u1, 0.5)),
             (3, fk.kernels["rhs"], (raw, 0.5))]
    for which, k, args in cases:
        assert HOST_KERNELS[k.name] == which
        sc, operands = k.prepare(*args)
        out = host_run_3d(host, k.name, sc, operands, shape, 3)
        ref = k.body(sc, operands)
        assert torch.isfinite(out).all(), k.name
        err = float((out - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (k.name, err)


def batched_args_3d(tops, name, nb, shape, seed=21, dof=3):
    """Per-member argument tuples of 3D kernel ``name`` for nb members:
    distinct rough states (with clamps), tangents, increments, t and
    shift, so each member's scalar pack differs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(nb):
        raw = torch.from_numpy(with_clamps(
            rough_state(shape, seed=seed + i, dof=dof), tops))
        u64 = tops.groom(raw)
        v = torch.from_numpy(rng.standard_normal(u64.shape))
        b = torch.from_numpy(rng.standard_normal(u64.shape))
        u1 = tops.groom(u64 + torch.from_numpy(
            100.0 * rng.standard_normal(u64.shape)))
        t, shift = scalar(0.1 * i), scalar(3.0 + i)
        out.append(dict(
            rhs=(raw.float(), t.float()), jvp=(raw.float(), v, t),
            resid=(raw.float(), v, b, t, shift),
            delta=(u64, u1 - u64, u1, t),
        )[name])
    return out


@pytest.mark.parametrize("shape", [SHAPE, (9, 7, 11), (9, 17, 70)])
def test_cuda_source_batched_bodies_match_single_members(shape, tmp_path):
    """The member-batched bodies of csrc/stencil3d.cu (one 1D grid, the
    member slowest in the block index, one (nb, k) scalar pack row per
    member), compiled as host C++ with nb = 3, equal three single-member
    runs bit for bit, for each of the four 3D kernels, and the plain
    version under vmap within 1e-5 of its largest value: on a tiled
    grid, on one ragged in every axis and on one with several tiles in
    every axis (so each part of the block index's decoding counts)."""
    from torch.func import vmap

    clargs = make_clargs(params=aggregation3d_params(shape[0]))
    _, _, tops = problem_from_clargs(clargs, *shape, device="cpu")
    fk, host = host_kernels_3d(tops, tmp_path)
    for name in HOST_KERNELS:
        k = fk.kernels[name]
        prepared = [k.prepare(*args)
                    for args in batched_args_3d(tops, name, 3, shape)]
        sc_b = torch.stack([p[0] for p in prepared])
        ops_b = [torch.stack(xs) for xs in zip(*[p[1] for p in prepared])]
        out = host_run_3d(host, name, sc_b, ops_b, shape, 3)
        for i, (sc, operands) in enumerate(prepared):
            single = host_run_3d(host, name, sc, operands, shape, 3)
            assert torch.equal(out[i], single), (name, i)
        ref = vmap(k.body)(sc_b, ops_b)
        assert float((out - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), name


#: x extents of the march (jvp and resid walk x in chunks of up to LX =
#: 32 planes): several chunks with a ragged last one, several whole
#: chunks, and fewer planes than one chunk (nx = 2*sw + 1, every plane
#: of the window wrapped once)
MARCH_SHAPES = {"chunks_ragged": (70, 9, 33), "chunks_whole": (64, 6, 32),
                "nx_2sw1": (5, 17, 40)}

#: the march cases, (shape, fields): the shapes with aggregation3d's 3
#: fields, then several ragged chunks with 2 and with 4 fields (where a
#: point's raw values outnumber its window arrays for jvp and resid too,
#: and delta's u1 lands in its first arrays at 2)
MARCH_CASES = {**{k: (s, 3) for k, s in MARCH_SHAPES.items()},
               "dof2_ragged": ((70, 9, 33), 2),
               "dof4_ragged": ((70, 9, 33), 4)}


def march_args_3d(tops, name, shape, dof=3):
    """Three members' argument tuples of 3D kernel ``name`` for the
    march cases: ``batched_args_3d``'s (raw states with clamped and NaN
    points for rhs, jvp and resid), the third member of delta with a
    fifth of its points clamped to the floor by the increment, and that
    of rhs on the near-uniform state (where one ulp of G is the whole
    centred rho row)."""
    per = batched_args_3d(tops, name, 3, shape, seed=31, dof=dof)
    if name == "delta":
        u64, _, _, t = per[2]
        drop = torch.from_numpy(
            np.random.default_rng(33).random(u64.shape) < 0.2)
        u1 = tops.groom(u64 - 2.0 * u64 * drop)
        assert bool((u1[:, drop[0]] <= tops.rhomin).any())
        per[2] = (u64, u1 - u64, u1, t)
    if name == "rhs":
        per[2] = (torch.from_numpy(wave_state(shape, dof)).float(),
                  per[2][1])
    return per


@pytest.mark.parametrize("case", list(MARCH_CASES.values()),
                         ids=list(MARCH_CASES))
@pytest.mark.parametrize("name", ["jvp", "resid", "delta", "rhs"])
def test_cuda_march_bodies_match_plain_and_members(name, case, tmp_path):
    """The march bodies of csrc/stencil3d.cu (all four kernels),
    compiled as host C++ (KSFD_NT=1) and launched on the grid the source
    exports (``ksfd_blocks``): within 1e-5 of max|plain| of the plain
    version (jvp, resid and rhs on a raw state with clamped and NaN
    points, delta with increments that clamp a fifth of the points to
    the floor, rhs also on the near-uniform state: there only its U
    rows, since row 0 is held on the card alone), and a batched run of
    three members equal bit for bit to three single runs, where the x
    chunks are several with a ragged last one, several whole ones, or
    fewer planes than one chunk, with 3 fields and with 2 and 4."""
    shape, dof = case
    clargs = make_clargs(params=aggregation3d_params(shape[0], dof))
    _, _, tops = problem_from_clargs(clargs, *shape, device="cpu")
    assert tops.nligands + 1 == dof
    assert 2 * tops.sw + 1 == MARCH_SHAPES["nx_2sw1"][0]
    fk, host = host_kernels_3d(tops, tmp_path)
    host.ksfd_blocks.argtypes = [ctypes.c_int] * 5
    host.ksfd_blocks.restype = ctypes.c_longlong
    # the cases' chunk counts, against one chunk's blocks
    which = HOST_KERNELS[name]
    assert host.ksfd_blocks(which, *shape, 2) == 2 * -(-shape[0] // 32) * \
        host.ksfd_blocks(which, 1, *shape[1:], 1)
    k = fk.kernels[name]
    per = march_args_3d(tops, name, shape, dof)
    prepared = [k.prepare(*args) for args in per]
    for i, (sc, operands) in enumerate(prepared):
        out = host_run_3d(host, name, sc, operands, shape, dof)
        ref = k.body(sc, operands)
        assert torch.isfinite(out).all()
        err = (out - ref).abs()
        if name == "rhs" and i == 2:
            # near-uniform: one ulp of G is the whole centred row 0, and
            # the host's logf/tanhf are not torch's, so here row 0 is
            # only of the rounding floor's size (test_torch_fast32.py);
            # chip_smoke.py phase 8 holds it to 1e-5 of max|plain| on
            # the card.  The U rows keep 1e-5 of their own size.
            from test_torch_fast32 import rounding_floor

            floor = rounding_floor(tops, per[2][0].double())
            assert floor <= 4 * float(ref[0].abs().max())
            assert float(err[0].max()) <= 1e-5 * float(
                ref[0].abs().max()) + floor
            for l in range(1, dof):
                assert float(err[l].max()) <= 1e-5 * float(
                    ref[l].abs().max()), l
            continue
        assert float(err.max()) <= 1e-5 * float(ref.abs().max()), i
    sc_b = torch.stack([p[0] for p in prepared])
    ops_b = [torch.stack(xs) for xs in zip(*[p[1] for p in prepared])]
    out = host_run_3d(host, name, sc_b, ops_b, shape, dof)
    for i, (sc, operands) in enumerate(prepared):
        assert torch.equal(out[i], host_run_3d(host, name, sc, operands,
                                               shape, dof)), i


def test_probe_stencil3d_variants_follow_the_source(tmp_path):
    """tools/probe_stencil3d.py's variants are text edits of the march
    of csrc/stencil3d.cu: every anchor is found once, every variant
    differs from the source and compiles as host C++ (KSFD_NT=1),
    ``full``, the source itself, keeps all four kernels within 1e-5 of
    max|plain|, and a launch geometry it times (``--geometry``)
    computes what ``full`` computes bit for bit (on a grid of several y
    tiles)."""
    from concurrent.futures import ThreadPoolExecutor

    from ksfd_tpu_torch.tools.probe_stencil3d import geometry, variants

    src = CSRC3D.read_text()
    out = variants(src)
    assert set(out) == {"full", "no_pointwise", "loads_only", "rows_only"}
    assert out["full"] == src and len(set(out.values())) == len(out)
    gname, text = geometry(src, "Delta=16,512,2")
    assert gname == "delta_16x32_2b" and text.count(
        "MY = 16, NT = KSFD_THREADS(512), MINB = 2;") == 3
    for spec in ("Jvp=8,256,3", "Rhs=8,256,4"):
        assert geometry(src, spec)[1] != src
    with pytest.raises(RuntimeError):
        geometry(src, "Box=16,512,2")
    out[gname] = text
    shape = (9, 17, 11)
    clargs = make_clargs(params=aggregation3d_params(shape[0]))
    _, _, tops = problem_from_clargs(clargs, *shape, device="cpu")
    with ThreadPoolExecutor(len(out)) as pool:
        hosts = dict(zip(out, pool.map(
            lambda kv: host_kernels_3d(tops, tmp_path / kv[0],
                                       source=kv[1]), out.items())))
    runs = {}
    for variant, (fk, host) in hosts.items():
        runs[variant] = {}
        for name in HOST_KERNELS:
            k = fk.kernels[name]
            sc, operands = k.prepare(*batched_args_3d(tops, name, 1,
                                                      shape)[0])
            runs[variant][name] = host_run_3d(host, name, sc, operands,
                                              shape, 3)
            if variant == "full":
                ref = k.body(sc, operands)
                assert float((runs["full"][name] - ref).abs().max()) <= \
                    1e-5 * float(ref.abs().max()), name
    for name in HOST_KERNELS:
        assert torch.equal(runs[gname][name], runs["full"][name]), name


@pytest.mark.cuda
def test_cuda_kernels_match_plain_3d():
    """On a card: each 3D CUDA kernel equals its plain version (1e-5 of
    the largest reference value) and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    clargs = make_clargs(params=aggregation3d_params(SHAPE[0]))
    _, _, tops = problem_from_clargs(clargs, *SHAPE, device="cuda")
    fk = make_fused_kernels(tops)
    rng = np.random.default_rng(5)
    to = lambda a: torch.as_tensor(a, device="cuda")
    u64 = tops.groom(to(rough_state()))
    u, v, b = u64.float(), to(rng.standard_normal(u64.shape)).float(), \
        to(rng.standard_normal(u64.shape)).float()
    d = to(100.0 * rng.standard_normal(u64.shape))
    u1 = tops.groom(u64 + d)
    for k, args in [(fk.jvp, (u, v, 0.5)), (fk.resid, (u, v, b, 0.5, 7.5)),
                    (fk.delta, (u64, u1 - u64, u1, 0.5))]:
        n0 = k.launches
        out, ref = k(*args), k.plain(*args)
        assert k.launches == n0 + 1
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
