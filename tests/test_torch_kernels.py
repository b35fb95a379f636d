"""The port's fused stencil kernels against the Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; here it
is held against ksfd_tpu's Pallas kernel in interpret mode on the same
seeded numpy inputs, and the delta kernel also against the float64
oracle increment at the bounds of tests/test_pallas.py.  The generated
CUDA header is compiled as host C++ and checked against the torchify'd
float32 expressions.  The CUDA kernels themselves run only on a card:
those tests carry the ``cuda`` marker and skip elsewhere
(chip_smoke.py runs the same comparison at full size).
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ksfd_tpu.ops.pallas_stencil import make_pallas_kernels
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import fused_stencil
from ksfd_tpu_torch.ops.codegen import pointwise_header
from ksfd_tpu_torch.ops.fused_stencil import CSRC, make_fused_kernels

N = 32


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    """(JAX ops, port ops, Pallas kernels in interpret mode, port
    kernels) of the bench problem at N^2 x 3."""
    jps, _, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return (jops, tops, make_pallas_kernels(jops, tile_x=16, interpret=True),
            make_fused_kernels(tops))


def rough_state(seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal((N, N))),
        6000 + scale * np.abs(rng.standard_normal((N, N))),
        6000 + 0.5 * scale * np.abs(rng.standard_normal((N, N))),
    ])


def wave_state():
    """Near-uniform fields ~1e4 with ~1-amplitude structure."""
    wave = np.sin(2 * np.pi * np.arange(N) / N)[:, None] * np.ones((N, N))
    return np.stack([9000 + wave, 6162 + 0.7 * wave, 797 + 0.1 * wave])


def f32(*arrays):
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("state", ["rough", "wave"])
def test_plain_resid_and_jvp_match_pallas(built, state):
    jops, tops, pk, fk = built
    rng = np.random.default_rng(1)
    u = rough_state() if state == "rough" else wave_state()
    # active clamps (tangent masked): below, at and NaN against a floor
    u[0, 3, 5] = 0.5 * tops.rhomin
    u[0, 7, 2] = tops.rhomin
    u[1, 4, 4] = tops.Umin
    u[2, 1, 9] = np.nan
    u, v, b = f32(u, rng.standard_normal(u.shape),
                  rng.standard_normal(u.shape))
    ref = np.asarray(pk.jvp(jnp.asarray(u), jnp.asarray(v), 0.5))
    out = fk.jvp(*[torch.from_numpy(a) for a in (u, v)], 0.5)
    assert out.dtype == torch.float32 and np.isfinite(ref).all()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    ref = np.asarray(pk.resid(*[jnp.asarray(a) for a in (u, v, b)], 0.5, 7.5))
    out = fk.resid(*[torch.from_numpy(a) for a in (u, v, b)], 0.5, 7.5)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("state,scale,oracle_tol", [
    ("rough", 100.0, 3e-6),
    ("wave", 1e-3, 1e-6),
    ("floor", None, 3e-6),
])
def test_plain_delta_matches_pallas_and_oracle(built, state, scale,
                                               oracle_tol):
    jops, tops, pk, fk = built
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
    ref = np.asarray(pk.delta(u0, dd, ug, 0.5))
    out = fk.delta(*[torch.from_numpy(np.array(a)) for a in (u0, dd, ug)],
                   0.5).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    oracle = np.asarray(jops.rhs(ug, 0.5) - jops.rhs(u0, 0.5))
    for x in (out, ref):
        assert np.abs(x - oracle).max() / np.abs(oracle).max() < oracle_tol


def test_plain_path_counts_no_launch(built):
    _, _, _, fk = built
    u = torch.from_numpy(rough_state().astype(np.float32))
    before = {k: kk.launches for k, kk in fk.kernels.items()}
    fk.rhs(u, 0.0)
    fk.jvp(u, u, 0.0)
    fk.resid(u, u, u, 0.0, 1.0)
    fk.delta(u.double(), 0 * u.double(), u.double(), 0.0)
    assert {k: kk.launches for k, kk in fk.kernels.items()} == before


def test_wrapper_raises_on_other_devices(built):
    _, _, _, fk = built
    u = torch.empty((3, N, N), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fk.kernels["rhs"](u, 0.0)
    with pytest.raises(ValueError, match="meta"):
        fk.jvp(u, u, 0.0)
    with pytest.raises(ValueError, match="meta"):
        fk.resid(u, u, u, 0.0, 1.0)
    with pytest.raises(ValueError, match="meta"):
        fk.delta(u, u, u, 0.0)


def test_build_raises_without_nvcc(built, monkeypatch, tmp_path):
    _, tops, _, _ = built
    monkeypatch.setattr(fused_stencil.shutil, "which", lambda name: None)
    monkeypatch.setattr(fused_stencil, "NVCC_DEFAULT",
                        str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(fused_stencil, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        make_fused_kernels(tops).build.library()
    assert not (tmp_path / "build").exists()


def test_header_is_single_precision(built):
    _, tops, _, _ = built
    text = pointwise_header(tops)
    assert "log1pf(" in text and "tanhf(" in text and "logf(" in text
    for word in ("double", "log(", "tanh(", "log1p(", "fmax("):
        assert word not in text.replace("log1pf(", "").replace(
            "logf(", "").replace("tanhf(", "").replace("fmaxf(", ""), word


_HOST_SHIM = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
#include "ksfd_pointwise.cuh"
extern "C" void eval_all(int n, const float* f, const float* d,
                         const float* s, float* G, float* dG, float* Gd) {
  for (int i = 0; i < n; ++i) {
    const float* fi = f + i * KSFD_DOF;
    G[i] = ksfd_G(fi);
    ksfd_dG(fi, dG + i * KSFD_DOF);
    Gd[i] = ksfd_G_delta(fi, d + i * KSFD_DOF, s + i * KSFD_DOF);
  }
}
"""


def test_generated_header_matches_torchify(built, tmp_path):
    """The generated header compiled as host C++ evaluates G, each
    dG_i and G_delta like the torchify'd float32 functions, to 1e-6 of
    each function's largest value within each group of points: big
    increments (the direct log difference), moderate ones, clamp-to-
    floor shifted states and small increments (where log1p matters)."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the generated header")
    _, tops, _, _ = built
    (tmp_path / "ksfd_pointwise.cuh").write_text(pointwise_header(tops))
    (tmp_path / "shim.cpp").write_text(_HOST_SHIM)
    lib = tmp_path / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
                   check=True, capture_output=True)
    rng = np.random.default_rng(11)
    n = 800
    f = np.stack([300 + 25000 * rng.random(n), 30 + 25000 * rng.random(n),
                  3 + 2500 * rng.random(n)], axis=1)
    # point groups, each held to its own scale
    groups = dict(
        big=slice(0, 200),        # |d| >= a/2: the direct log difference
        moderate=slice(200, 400),
        floor=slice(400, 600),    # shifted state clamped to the floor
        small=slice(600, 800),    # |d| ~ 1e-5 a: where log1p matters
    )
    d = f * rng.uniform(-0.3, 0.3, size=f.shape)
    d[groups["big"]] = f[groups["big"]] * rng.uniform(0.5, 3.0, (200, 3))
    d[groups["small"]] = f[groups["small"]] * 1e-5 * rng.standard_normal(
        (200, 3))
    s = f + d
    s[400:500, 0] = tops.rhomin
    s[450:600, 1:] = tops.Umin
    d = s - f
    f, d, s = (np.ascontiguousarray(a, dtype=np.float32) for a in (f, d, s))
    G, Gd = np.empty(n, np.float32), np.empty(n, np.float32)
    dG = np.empty((n, 3), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    shim = ctypes.CDLL(str(lib))
    shim.eval_all.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    shim.eval_all(n, ptr(f), ptr(d), ptr(s), ptr(G), ptr(dG), ptr(Gd))

    cols = lambda a: [torch.from_numpy(a[:, k].copy()) for k in range(3)]

    def close(out, ref):
        return all(
            np.abs(out[g] - ref[g]).max() <= 1e-6 * np.abs(ref[g]).max()
            for g in groups.values()
        )

    assert close(G, tops._G_fn(*cols(f), 0.0).numpy())
    for k, fn in enumerate(tops._dG_fns):
        assert close(dG[:, k], fn(*cols(f), 0.0).numpy()), k
    ref = tops._G_delta_fn(*cols(f), *cols(d), *cols(s), 0.0).numpy()
    assert np.isfinite(Gd).all() and np.isfinite(ref).all()
    assert close(Gd, ref)


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
#include "stencil2d.cu"

// one host thread walks every block of the launch grid in turn
extern "C" int run(int which, const float* sc, const float* a,
                   const float* b, const float* c, float* out, int nx,
                   int ny) {
  threadIdx = {0, 0, 0};
  for (unsigned by = 0; by < (unsigned)((nx + TX - 1) / TX); ++by)
    for (unsigned bx = 0; bx < (unsigned)((ny + TY - 1) / TY); ++bx) {
      blockIdx = {bx, by, 0};
      if (which == 0) jvp_kernel<false>(sc, a, b, nullptr, out, nx, ny);
      if (which == 1) jvp_kernel<true>(sc, a, b, c, out, nx, ny);
      if (which == 2) delta_kernel(sc, a, b, c, out, nx, ny);
      if (which == 3) rhs_kernel(sc, a, out, nx, ny);
    }
  return 0;
}
"""


@pytest.mark.parametrize("shape", [(N, N), (20, 36)])
def test_cuda_source_bodies_match_plain(shape, tmp_path):
    """The four kernel bodies of csrc/stencil2d.cu, compiled as host C++
    (KSFD_NT=1), equal the plain versions to 1e-5 of max|plain| on a
    tiled grid and on one whose tiles are ragged in both axes (the
    periodic wrap and the bounds guards); jvp, resid and rhs on a raw
    state with points below, at and NaN against the floors."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    jps, _, _ = ge._make_problem(*shape)
    _, _, tops = problem_from_clargs(jps.clargs, *shape, device="cpu")
    fk = make_fused_kernels(tops)
    (tmp_path / "ksfd_pointwise.cuh").write_text(fk.build.header)
    shutil.copy(CSRC, tmp_path / os.path.basename(CSRC))
    (tmp_path / "shim.cpp").write_text(_KERNEL_SHIM)
    lib = tmp_path / "libkern.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-DKSFD_NT=1", "-I",
         str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(lib))
    host.run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 2)
    rng = np.random.default_rng(9)
    u = np.stack([
        6000 + 3000 * np.abs(rng.standard_normal(shape)),
        6000 + 1000 * np.abs(rng.standard_normal(shape)),
        6000 + 500 * np.abs(rng.standard_normal(shape)),
    ])
    u[0, 3, 5] = 0.5 * tops.rhomin
    u[0, shape[0] - 1, shape[1] - 1] = tops.rhomin
    u[1, 4, 4] = tops.Umin
    u[2, 1, shape[1] - 1] = np.nan
    raw = torch.from_numpy(u)
    u64 = tops.groom(raw)
    v = torch.from_numpy(rng.standard_normal(u.shape))
    b = torch.from_numpy(rng.standard_normal(u.shape))
    d = torch.from_numpy(100.0 * rng.standard_normal(u.shape))
    u1 = tops.groom(u64 + d)
    cases = [(0, fk.jvp, (raw, v, 0.5)), (1, fk.resid, (raw, v, b, 0.5, 7.5)),
             (2, fk.delta, (u64, u1 - u64, u1, 0.5)),
             (3, fk.kernels["rhs"], (raw, 0.5))]
    for which, k, args in cases:
        sc, operands = k.prepare(*args)
        ptrs = [x.data_ptr() for x in (sc, *operands)]
        ptrs += [None] * (4 - len(ptrs))
        out = torch.empty_like(operands[0])
        host.run(which, *ptrs, out.data_ptr(), *shape)
        ref = k.body(sc, operands)
        assert torch.isfinite(out).all(), k.name
        err = float((out - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (k.name, err)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(built):
    """On a card: each CUDA kernel equals its plain version (1e-5 of
    the largest reference value) and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    _, tops, _, fk = built
    rng = np.random.default_rng(5)
    to = lambda a: torch.as_tensor(a, device="cuda")
    u64 = tops.groom(to(rough_state()))
    u, v, b = u64.float(), to(rng.standard_normal(u64.shape)).float(), \
        to(rng.standard_normal(u64.shape)).float()
    d = to(100.0 * rng.standard_normal(u64.shape))
    u1 = tops.groom(u64 + d)
    cases = [(fk.jvp, (u, v, 0.5)), (fk.resid, (u, v, b, 0.5, 7.5)),
             (fk.delta, (u64, u1 - u64, u1, 0.5)),
             (fk.kernels["rhs"], (u, 0.5))]
    for k, args in cases:
        n0 = k.launches
        out, ref = k(*args), k.plain(*args)
        assert k.launches == n0 + 1
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
