"""B11, the coefficient-field resid kernel, and its probe, against the
reference.

The port's ``prepare`` (float32 coefficient fields) and the plain
version of ``coeff_resid`` are held against the reference's
``build_coeff_resid(ops, interpret=True)`` (tools/probe_coeff_kernel.py,
its Pallas kernel in interpret mode) on the probe's rough state, and
against the port's plain B1 with the reference's own assert (relative
deviation < 1e-5).  The CUDA source's ``coeff_resid_kernel`` body is
compiled as host C++ and held against the plain version; the kernel
itself runs only on a card (``cuda`` marker; chip_smoke.py phase 15
runs it at 1024^2).
"""

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_stencil import (
    CSRC,
    entry_names,
    make_fused_kernels,
    stencil_entries,
)
from ksfd_tpu_torch.tools import probe_coeff_kernel as tprobe
from ksfd_tpu_torch.tools.problems import bench_clargs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
T, SHIFT = 0.5, 37.0


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_probe():
    """tools/probe_coeff_kernel.py as a module (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "ref_probe_coeff_kernel",
        os.path.join(ROOT, "tools", "probe_coeff_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def built():
    """(JAX ops, port ops, port kernels, the probe's (u, v, b)) at
    N^2 x 3 of the bench problem."""
    jps, _, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    u, v, b = tprobe.probe_state(tops.grid, "cpu")
    return jops, tops, make_fused_kernels(tops), (u, v, b)


def test_prepare_and_plain_b11_match_reference(built):
    """The coefficient fields of the port's prepare equal the
    reference's jitted prepare (rho_g and maskpack exactly, G and the
    masked dG'_i to 1e-5 of each plane's largest value: the same
    float32 expressions compiled by XLA and by PyTorch round apart,
    3e-6 of dG/drho ~ s2/rho here), and the plain B11 on them equals
    the reference's interpret-mode Pallas kernel to 1e-5 of its max."""
    jops, tops, kern, (u, v, b) = built
    rprep, rresid = _reference_probe().build_coeff_resid(jops,
                                                         interpret=True)
    C_ref = np.asarray(rprep(jnp.asarray(u.numpy()), T))
    prepare, cresid = tprobe.build_coeff_resid(tops, kern)
    C = prepare(u, T)
    assert C.dtype == torch.float32 and tuple(C.shape) == (6, N, N)
    Cn = C.numpy()
    np.testing.assert_array_equal(Cn[0], C_ref[0])
    np.testing.assert_array_equal(Cn[-1], C_ref[-1])
    assert (Cn[-1] == 7).all()          # the rough state clamps nothing
    for k in range(1, 5):
        scale = np.abs(C_ref[k]).max()
        assert np.abs(Cn[k] - C_ref[k]).max() <= 1e-5 * scale, k
    r_ref = np.asarray(rresid(jnp.asarray(C_ref), jnp.asarray(v.numpy()),
                              jnp.asarray(b.numpy()), T, SHIFT))
    out = cresid(C, v, b, T, SHIFT).numpy()
    assert np.isfinite(r_ref).all()
    assert np.abs(out - r_ref).max() <= 1e-5 * np.abs(r_ref).max()


def test_b11_matches_b1_on_clamped_state(built):
    """B11 from the coefficient fields equals the production resid B1
    on the same (u, v, b) (the reference's assert: relative deviation
    < 1e-5), also where clamps are active: below, at and NaN against
    the floors (maskpack's bits mask the tangents, the masked dG'_i
    take the raw tangent)."""
    _, tops, kern, (u, v, b) = built
    u = u.clone()
    u[0, 3, 5] = 0.5 * tops.rhomin
    u[0, 7, 2] = tops.rhomin
    u[1, 4, 4] = tops.Umin
    u[2, 1, 9] = float("nan")
    prepare, cresid = tprobe.build_coeff_resid(tops, kern)
    C = prepare(u, T)
    assert C[-1, 3, 5] == 6 and C[-1, 7, 2] == 6 and C[-1, 4, 4] == 5
    assert C[-1, 1, 9] == 3 and C[2, 3, 5] == 0 and C[4, 1, 9] == 0
    r1 = kern.resid(u.float(), v, b, T, SHIFT)
    r11 = cresid(C, v, b, T, SHIFT)
    assert torch.isfinite(r11).all()
    dev = float((r1 - r11).abs().max() / r1.abs().max())
    assert dev < 1e-5, dev


def test_probe_main_runs_on_the_cpu(capsys):
    """The probe's command line on the CPU (plain versions): the last
    line is the reference's JSON keys plus the card field."""
    assert tprobe.main(["--nx", "16", "--sweeps", "2", "--repeats", "1",
                        "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert {"nx", "production_us", "coeff_us", "speedup", "rel_dev",
            "card"} <= set(out)
    assert out["nx"] == 16 and out["card"] == "cpu"
    assert out["rel_dev"] < 1e-5


def test_b11_is_2d_only():
    """The 3D kernels have no coeff_resid, as the reference has no 3D
    B11: the 3D library is never asked for the entry."""
    assert "coeff_resid" in entry_names(2)
    assert "coeff_resid" not in entry_names(3)
    assert "ksfd_coeff_resid" in stencil_entries(2)
    assert "ksfd_coeff_resid" not in stencil_entries(3)
    # entries of both dimensions take the member count before the stream
    assert len(stencil_entries(2)["ksfd_resid"]) == 5 + 2 + 1 + 1
    assert len(stencil_entries(3)["ksfd_resid"]) == 5 + 3 + 1 + 1
    from helpers import make_clargs
    from test_torch_3d import aggregation3d_params

    _, _, ops3 = problem_from_clargs(
        make_clargs(params=aggregation3d_params(8)), 8, 8, 8, device="cpu")
    kern3 = make_fused_kernels(ops3)
    assert not hasattr(kern3, "coeff_resid")
    with pytest.raises(NotImplementedError, match="2D"):
        tprobe.build_coeff_resid(ops3)


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
alignas(16) float ksfd_smem[SMEM_FLOATS_MAX];

// one host thread walks every block of the launch grid in turn: the
// march's 1D grid (jvp, resid, delta, rhs; the members slowest) as the
// source exports it, coeff_resid's tiles with the members on blockIdx.z
extern "C" int run(int which, const float* sc, const float* a,
                   const float* b, const float* c, float* out, int nx,
                   int ny, int nb) {
  threadIdx = {0, 0, 0};
  if (which < KSFD_COEFF_RESID) {
    for (long long bx = 0; bx < ksfd_blocks(which, nx, ny, nb); ++bx) {
      blockIdx = {(unsigned)bx, 0, 0};
      if (which == KSFD_JVP) jvp_kernel<false>(sc, a, b, nullptr, out, nx, ny);
      if (which == KSFD_RESID) jvp_kernel<true>(sc, a, b, c, out, nx, ny);
      if (which == KSFD_DELTA) delta_kernel(sc, a, b, c, out, nx, ny);
      if (which == KSFD_RHS) rhs_kernel(sc, a, out, nx, ny);
    }
    return 0;
  }
  for (unsigned bz = 0; bz < (unsigned)nb; ++bz)
  for (unsigned by = 0; by < (unsigned)((nx + TX - 1) / TX); ++by)
    for (unsigned bx = 0; bx < (unsigned)((ny + TY - 1) / TY); ++bx) {
      blockIdx = {bx, by, bz};
      coeff_resid_kernel(sc, a, b, c, out, nx, ny);
    }
  return 0;
}
"""

#: the host harness's kernel numbers
HOST_KERNELS = dict(jvp=0, resid=1, delta=2, rhs=3, coeff_resid=4)


def host_kernels(tops, tmp_path, source=None):
    """csrc/stencil2d.cu's kernel bodies (or the text ``source`` in its
    place) compiled as host C++ (KSFD_NT=1) with the problem's header:
    ``run(which, sc, a, b, c, out, nx, ny, nb)``, or None without a C++
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        return None
    fk = make_fused_kernels(tops)
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "ksfd_pointwise.cuh").write_text(fk.build.header)
    (tmp_path / os.path.basename(CSRC)).write_text(
        CSRC.read_text() if source is None else source)
    (tmp_path / "shim.cpp").write_text(_KERNEL_SHIM)
    lib = tmp_path / "libkern.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-DKSFD_NT=1", "-I",
         str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(lib))
    host.run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 3)
    return host


def host_run(host, which, sc, operands, shape, dof):
    """The host harness on prepared operands (with or without a leading
    member axis); returns the output."""
    nb = int(sc.shape[0]) if sc.dim() == 2 else 1
    ptrs = [x.data_ptr() for x in (sc, *operands)]
    ptrs += [None] * (4 - len(ptrs))
    out = torch.empty(((nb,) if sc.dim() == 2 else ()) + (dof,) + shape,
                      dtype=torch.float32)
    host.run(HOST_KERNELS[which], *ptrs, out.data_ptr(), *shape, nb)
    return out


@pytest.mark.parametrize("shape,dof", [
    pytest.param((N, N), 3, id="shape0"),
    pytest.param((20, 36), 3, id="shape1"),
    pytest.param((20, 36), 2, id="dof2_ragged"),
    pytest.param((20, 36), 4, id="dof4_ragged"),
])
def test_cuda_source_coeff_resid_body_matches_plain(shape, dof, tmp_path):
    """``coeff_resid_kernel`` of csrc/stencil2d.cu, compiled as host C++,
    equals its plain version to 1e-5 of max|plain| on a tiled grid and
    on one whose tiles are ragged in both axes, with clamps active; with
    2 and 4 fields too (tools/problems.py with_fields)."""
    if dof == 3:
        clargs = ge._make_problem(*shape)[0].clargs
    else:
        clargs = bench_clargs(shape[0], dof)
    _, _, tops = problem_from_clargs(clargs, *shape, device="cpu")
    host = host_kernels(tops, tmp_path)
    if host is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    kern = make_fused_kernels(tops)
    u, v, b = tprobe.probe_state(tops.grid, "cpu", seed=4)
    u[0, 3, 5] = 0.5 * tops.rhomin
    u[1, shape[0] - 1, shape[1] - 1] = tops.Umin
    u[dof - 1, 1, shape[1] - 1] = float("nan")
    prepare, cresid = tprobe.build_coeff_resid(tops, kern)
    sc, operands = cresid.prepare(prepare(u, T), v, b, T, SHIFT)
    out = host_run(host, "coeff_resid", sc, operands, shape, dof)
    ref = cresid.body(sc, operands)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_coeff_resid_matches_plain_and_b1(built):
    """On a card: B11 equals its plain version (1e-5 of the largest
    value) and B1 (relative deviation < 1e-5), and counts its launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    jps, _, _ = ge._make_problem(N, N)
    _, _, ops = problem_from_clargs(jps.clargs, N, N, device="cuda")
    kern = make_fused_kernels(ops)
    u, v, b = tprobe.probe_state(ops.grid, "cuda")
    prepare, cresid = tprobe.build_coeff_resid(ops, kern)
    C = prepare(u, T)
    n0 = cresid.launches
    out = cresid(C, v, b, T, SHIFT)
    assert cresid.launches == n0 + 1
    ref = cresid.plain(C, v, b, T, SHIFT)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    r1 = kern.resid(u.float(), v, b, T, SHIFT)
    assert float((r1 - out).abs().max() / r1.abs().max()) < 1e-5
