"""The port's fused block-pc apply (``-pc_pallas 1``) against ksfd_tpu.

ops/fused_pc.py's plain versions stand for the CUDA kernels of
csrc/pc2d.cu on the CPU.  They are held against the reference's fused
Pallas apply in interpret mode (float32 dots, as tests/test_pallas.py:749
runs it) at 128^2, the reference's alignment gate; against the port's own
basis-GEMM ``apply_linearized`` at ragged 2D sizes, which the port's gate
admits and the reference's does not; and the CUDA source's kernel bodies,
compiled as host C++, against the plain versions.  Tolerances: the scalar
pack to 1e-7 relative (float32 casts of the same float64 numbers), the
apply to 1e-5 of max|reference| (float32 products summed in another
order, tests/test_pallas.py:783), a pc_pallas step to 1e-5 of the
increment (the mixed-precision envelope of tests/test_torch_solver.py).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke
import ksfd_tpu as KJ
from ksfd_tpu.ops.pallas_pc import make_pallas_block_pc
from ksfd_tpu.ops.pallas_pc import pack_pc_scalars as jpack
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_pc import (
    CSRC_PC,
    fused_pc_available,
    make_fused_block_pc,
    pack_pc_scalars,
)
from ksfd_tpu_torch.solvers import make_multistep_fn, make_step_fn
from ksfd_tpu_torch.solvers.linalg import BlockSpectralPreconditioner

N = 128


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


def problem(shape):
    """The bench problem (options84 class) of the reference's and the
    port's at ``shape``: (jps, jgrid, jops, tops)."""
    jps, jgrid, jops = ge._make_problem(*shape)
    _, _, tops = problem_from_clargs(jps.clargs, *shape, device="cpu")
    return jps, jgrid, jops, tops


@pytest.fixture(scope="module")
def prob128():
    return problem((N, N))


def pc_inputs(tops, seed=3):
    """A groomed rough state (bench.py's _rough_state, numpy seed 1234),
    the reference's pc statistics of it at t=0 as float64 numpy numbers,
    a shift and a float32 v from a numpy seed."""
    u0 = tops.groom(torch.from_numpy(
        chip_smoke.rough_state(tops.grid, tops.ps))).numpy()
    nf = u0.shape[0]
    means = [float(u0[i].mean()) for i in range(nf)]
    dG0 = tops._dG_fns[0](*[torch.from_numpy(u0[i]) for i in range(nf)],
                          0.0).numpy()
    rho_diff = float((u0[0] * dG0).max())
    v = np.random.default_rng(seed).standard_normal(u0.shape).astype(
        np.float32)
    return SimpleNamespace(u0=u0, means=means, rho_diff=rho_diff, v=v,
                           shift=2.29, t=0.0)


def port_pack(tops, x):
    f64 = lambda a: torch.tensor(a, dtype=torch.float64)
    return pack_pc_scalars(tops, f64(x.shift), f64(x.t),
                           [f64(m) for m in x.means], f64(x.rho_diff))


def test_pack_pc_scalars_matches_reference(prob128):
    _, _, jops, tops = prob128
    x = pc_inputs(tops)
    ref = np.asarray(jpack(jops, x.shift, x.t,
                           [jnp.asarray(m) for m in x.means], x.rho_diff))
    out = port_pack(tops, x)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (11,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-7, atol=0)


def test_fused_pc_matches_reference_kernels(prob128):
    """The plain fwd + inv against the reference's Pallas apply
    (interpret mode) on the same scalar pack, at 128^2 x 3."""
    _, jgrid, jops, tops = prob128
    x = pc_inputs(tops)
    sc = jpack(jops, x.shift, x.t, [jnp.asarray(m) for m in x.means],
               x.rho_diff)
    jpc = make_pallas_block_pc(jgrid, jops, interpret=True)
    ref_modes = np.asarray(jpc.fwd(sc, jnp.asarray(x.v)))
    ref = np.asarray(jpc(sc, jnp.asarray(x.v)))
    pc = make_fused_block_pc(tops.grid, tops)
    sct, v = torch.from_numpy(np.array(sc)), torch.from_numpy(x.v)
    modes = pc.fwd(sct, v)
    out = pc(sct, v)
    assert out.dtype == torch.float32 and out.shape == v.shape
    for got, want in ((modes.numpy(), ref_modes), (out.numpy(), ref)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert pc.fwd.launches == pc.inv.launches == 0


@pytest.mark.parametrize("shape", [(48, 40), (45, 37)])
def test_fused_pc_ragged_matches_apply_linearized(shape):
    """At sizes the reference's gate refuses (not 128-aligned), the fused
    apply equals the port's float32 basis-GEMM apply with rho_diff set."""
    _, _, _, tops = problem(shape)
    assert fused_pc_available(tops.grid, tops)
    x = pc_inputs(tops)
    f64 = lambda a: torch.tensor(a, dtype=torch.float64)
    means = [f64(m) for m in x.means]
    pcg = BlockSpectralPreconditioner(tops.grid, tops, compute_dtype="float32",
                                      device="cpu")
    v = torch.from_numpy(x.v)
    want = pcg.apply_linearized(v, f64(x.shift), f64(x.t), means,
                                rho_diff=f64(x.rho_diff))
    got = make_fused_block_pc(tops.grid, tops)(port_pack(tops, x), v)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# -- the CUDA source's kernel bodies on the host -------------------------

# pc2d.cu's kernel bodies as host C++20: one std::thread per CUDA thread,
# a std::barrier for __syncthreads, a function-local static array for
# each __shared__ tile, the blocks of a launch in turn.
_PC_SHIM = r"""
#include <barrier>
#include <thread>
#include <vector>
struct float4 { float x, y, z, w; };
static inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
struct ksfd_uint3 { unsigned x, y, z; };
static ksfd_uint3 blockIdx;
static thread_local ksfd_uint3 threadIdx;
static std::barrier<>* ksfd_bar;
static inline void __syncthreads() { ksfd_bar->arrive_and_wait(); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(n)
#define __align__(n) __attribute__((aligned(n)))
#include "pc2d.cu"

template <class F> static void launch(int nx, int ny, int nb, F body) {
  for (unsigned bz = 0; bz < (unsigned)nb; ++bz)
  for (unsigned by = 0; by < (unsigned)((nx + BM - 1) / BM); ++by)
    for (unsigned bx = 0; bx < (unsigned)((ny + BN - 1) / BN); ++bx) {
      blockIdx = {bx, by, bz};
      std::barrier<> bar(NT);
      ksfd_bar = &bar;
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < (unsigned)NT; ++t)
        pool.emplace_back([&body, t] { threadIdx = {t, 0, 0}; body(); });
      for (auto& th : pool) th.join();
    }
}

// the two grids of an entry, each over nb members on blockIdx.z
extern "C" int pc_fwd3(const float* sc, const float* v, const float* qxt,
                       const float* qy, const float* lam, float* tmp,
                       float* out, int nx, int ny, int nb, int vec) {
  launch(nx, ny, nb, [=] { pc_gemm<3, false, false>(
      qxt, v, tmp, nx, ny, nx, vec, nullptr, nullptr); });
  launch(nx, ny, nb, [=] { pc_gemm<3, true, true>(
      tmp, qy, out, nx, ny, ny, vec, sc, lam); });
  return 0;
}

extern "C" int pc_inv3(const float* c, const float* qx, const float* qyt,
                       float* tmp, float* out, int nx, int ny, int nb,
                       int vec) {
  launch(nx, ny, nb, [=] { pc_gemm<3, false, false>(
      qx, c, tmp, nx, ny, nx, vec, nullptr, nullptr); });
  launch(nx, ny, nb, [=] { pc_gemm<3, true, false>(
      tmp, qyt, out, nx, ny, ny, vec, nullptr, nullptr); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_pc(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    d = tmp_path_factory.mktemp("pc2d")
    shutil.copy(CSRC_PC, d / "pc2d.cu")
    (d / "shim.cpp").write_text(_PC_SHIM)
    lib = d / "libpc.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         str(d), "-o", str(lib), str(d / "shim.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    host.pc_fwd3.argtypes = [P] * 7 + [I] * 4
    host.pc_inv3.argtypes = [P] * 5 + [I] * 4
    return host


def host_pc_run(host, pc, sc, v, vec):
    """The host fwd then inv on prepared operands, one member or a
    leading member axis: (modes, out)."""
    o = pc.owner
    nb = int(v.shape[0]) if v.dim() == 4 else 1
    shape = tuple(v.shape[-2:])
    tmp, modes, out = (torch.empty_like(v) for _ in range(3))
    host.pc_fwd3(sc.data_ptr(), v.data_ptr(), o.QxT.data_ptr(),
                 o.Qy.data_ptr(), o.lam2d.data_ptr(), tmp.data_ptr(),
                 modes.data_ptr(), *shape, nb, vec)
    host.pc_inv3(modes.data_ptr(), o.Qx.data_ptr(), o.QyT.data_ptr(),
                 tmp.data_ptr(), out.data_ptr(), *shape, nb, vec)
    return modes, out


@pytest.mark.parametrize("shape,vec", [
    ((48, 40), 1), ((48, 40), 0), ((45, 37), 0), ((132, 68), 1)])
def test_cuda_source_bodies_match_plain(host_pc, shape, vec):
    """The fwd (two products and the arrow epilogue) and inv bodies of
    csrc/pc2d.cu, compiled as host C++, equal the plain versions to 1e-5
    of max|plain|: one tile, ragged tiles in both axes, several tiles,
    with the 16-byte loads (vec=1) and the masked scalar ones.  vec=1
    needs both extents divisible by 4, as the entries' vec_ok checks:
    otherwise a row's last float4 reads past the row (past the buffer
    for the last one)."""
    _, _, _, tops = problem(shape)
    x = pc_inputs(tops)
    pc = make_fused_block_pc(tops.grid, tops)
    sc = port_pack(tops, x)
    v = torch.from_numpy(x.v).contiguous()
    modes, out = host_pc_run(host_pc, pc, sc, v, vec)
    for got, want in ((modes, pc.fwd.plain(sc, v)),
                      (out, pc.inv.plain(modes))):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def batched_pc_inputs(tops, nb):
    """nb members' scalar packs (a shift and means of their own) and
    float32 right-hand sides, stacked: ((nb, k) pack, (nb, dof, nx, ny))."""
    x = pc_inputs(tops)
    rng = np.random.default_rng(8)
    packs, vs = [], []
    for i in range(nb):
        xi = SimpleNamespace(**vars(x))
        xi.shift = x.shift * (1.0 + i)
        xi.means = [m * (1.0 + 0.01 * i) for m in x.means]
        packs.append(port_pack(tops, xi))
        vs.append(torch.from_numpy(rng.standard_normal(
            tops.grid.Vshape).astype(np.float32)))
    return torch.stack(packs), torch.stack(vs)


@pytest.mark.parametrize("shape,vec", [((48, 40), 1), ((45, 37), 0)])
def test_cuda_source_batched_bodies_match_single_members(host_pc, shape,
                                                         vec):
    """The member-batched pc2d.cu bodies (the members on blockIdx.z,
    their own pack rows, the bases shared), compiled as host C++ with
    nb = 3, equal three single-member runs bit for bit, in fwd and inv,
    with the 16-byte loads and with ragged masked tiles; and the plain
    version under vmap within 1e-5 of its largest value."""
    from torch.func import vmap

    _, _, _, tops = problem(shape)
    pc = make_fused_block_pc(tops.grid, tops)
    sc_b, v_b = batched_pc_inputs(tops, 3)
    modes_b, out_b = host_pc_run(host_pc, pc, sc_b, v_b, vec)
    for i in range(3):
        modes, out = host_pc_run(host_pc, pc, sc_b[i].contiguous(),
                                 v_b[i].contiguous(), vec)
        assert torch.equal(modes_b[i], modes) and torch.equal(out_b[i], out)
    for got, want in ((modes_b, vmap(pc.fwd.plain)(sc_b, v_b)),
                      (out_b, vmap(pc.inv.plain)(modes_b))):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_fused_pc_under_vmap_matches_members():
    """Under torch.func.vmap each fused-pc entry (through the custom op's
    vmap rule) equals the per-member calls bit for bit, also with the
    right-hand side unbatched (broadcast); on the CPU it launches
    nothing."""
    from torch.func import vmap

    _, _, _, tops = problem((32, 32))
    pc = make_fused_block_pc(tops.grid, tops)
    sc_b, v_b = batched_pc_inputs(tops, 3)
    modes = vmap(pc.fwd)(sc_b, v_b)
    assert torch.equal(modes, torch.stack([pc.fwd(sc_b[i], v_b[i])
                                           for i in range(3)]))
    out = vmap(pc)(sc_b, v_b)
    assert torch.equal(out, torch.stack([pc(sc_b[i], v_b[i])
                                         for i in range(3)]))
    shared = vmap(pc.fwd, in_dims=(0, None))(sc_b, v_b[0])
    assert torch.equal(shared, torch.stack([pc.fwd(sc_b[i], v_b[0])
                                            for i in range(3)]))
    assert pc.fwd.launches == pc.inv.launches == 0


# -- the pc_pallas step ---------------------------------------------------


def test_pc_pallas_step_matches_reference(prob128, interpret):
    """One default-numerics step with -pc_pallas 1 at 128^2 against the
    reference's (its fused pc and stencil kernels in interpret mode)."""
    _, _, jops, tops = prob128
    u0 = tops.groom(torch.from_numpy(
        chip_smoke.rough_state(tops.grid, tops.ps))).numpy()
    step_j, _ = jstep(jops, KJ.NumericsOptions(pc_pallas=True), atol=0.01,
                      rtol=1e-6)
    from ksfd_tpu.solvers.solver import BUILD_INFO

    assert BUILD_INFO["pallas_pc"]
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0),
                          jnp.asarray(1e-3))
    step_t, _ = make_step_fn(tops, NumericsOptions(pc_pallas=True),
                             atol=0.01, rtol=1e-6)
    u1, e = step_t(torch.from_numpy(u0), torch.tensor(0.0, dtype=torch.float64),
                   torch.tensor(1e-3, dtype=torch.float64))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert inc > 0 and np.isfinite(float(e_ref))
    assert np.abs(u1.numpy() - u_ref).max() <= 1e-5 * inc


@pytest.mark.parametrize("precision,per_step", [
    ("float64", dict(rhs=0, jvp=0, resid=8, delta=4, pc_fwd=12, pc_inv=12)),
    ("float32", dict(rhs=4, jvp=8, resid=0, delta=0, pc_fwd=12, pc_inv=12)),
])
def test_pc_pallas_launch_counts_per_step(precision, per_step):
    """Per pc_pallas step: 12 pc_fwd and 12 pc_inv (3 applies per stage
    solve), beside the stencil kernels of the precision's path.  On the
    CPU the wrappers run their plain bodies, so the bodies' calls are
    counted, and no launch."""
    _, _, _, tops = problem((32, 32))
    nm = NumericsOptions(pc_pallas=True, precision=precision)
    multi, _ = make_multistep_fn(tops, nm, atol=0.01, rtol=1e-6)
    wrappers = dict(multi.kernels.kernels, **multi.fused_pc.kernels)
    calls = {name: 0 for name in wrappers}
    for name, k in wrappers.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    u, t, e = multi(torch.from_numpy(chip_smoke.initial_state(tops.grid)),
                    torch.tensor(0.0, dtype=torch.float64),
                    torch.tensor(1.0, dtype=torch.float64), 2)
    assert calls == {k: 2 * c for k, c in per_step.items()}
    assert all(k.launches == 0 for k in wrappers.values())
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(e))


# -- the gate --------------------------------------------------------------


def test_pc_pallas_on_a_3d_grid_raises():
    """The fused pc is 2D, as the reference's is; a 3D request raises
    instead of falling back to the basis-GEMM apply."""
    shape = (16, 8, 16)
    _, grid, ops = problem_from_clargs(chip_smoke.agg3d_clargs(16), *shape,
                                       device="cpu")
    assert not fused_pc_available(grid, ops)
    with pytest.raises(NotImplementedError, match="Queue B item 1"):
        make_step_fn(ops, NumericsOptions(pc_pallas=True))
    with pytest.raises(NotImplementedError, match="Queue B item 1"):
        make_fused_block_pc(grid, ops)


@pytest.mark.parametrize("pc_dtype", ["float64", "f64"])
def test_pc_pallas_with_float64_transforms_raises(pc_dtype):
    _, _, _, tops = problem((32, 32))
    nm = NumericsOptions(pc_pallas=True, pc_dtype=pc_dtype)
    assert not fused_pc_available(tops.grid, tops, pc_dtype)
    with pytest.raises(NotImplementedError, match="Queue B item 1"):
        make_step_fn(tops, nm)
    with pytest.raises(NotImplementedError, match="Queue B item 1"):
        make_multistep_fn(tops, dataclasses.replace(nm, precision="float32"))


def test_fused_pc_refuses_other_devices():
    _, _, _, tops = problem((32, 32))
    pc = make_fused_block_pc(tops.grid, tops)
    v = torch.zeros(tops.grid.Vshape, device="meta")
    sc = torch.zeros(11, device="meta")
    with pytest.raises(ValueError, match="pc_fwd kernel"):
        pc.fwd(sc, v)
    with pytest.raises(ValueError, match="pc_inv kernel"):
        pc.inv(v)


# -- on a card -------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_pc_kernels_match_plain():
    """On a card: B5a and B5b equal their plain versions to 1e-5 of
    max|plain| at an aligned and a ragged size and count one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    for shape in ((128, 128), (45, 37)):
        jps, _, _ = ge._make_problem(*shape)
        _, _, tops = problem_from_clargs(jps.clargs, *shape, device="cuda")
        x = pc_inputs(problem_from_clargs(jps.clargs, *shape,
                                          device="cpu")[2])
        pc = make_fused_block_pc(tops.grid, tops)
        sc = port_pack(tops, x).cuda()
        v = torch.from_numpy(x.v).cuda()
        modes = pc.fwd(sc, v)
        out = pc.inv(modes)
        assert pc.fwd.launches == pc.inv.launches == 1
        for got, want in ((modes, pc.fwd.plain(sc, v)),
                          (out, pc.inv.plain(modes))):
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (shape, err)
