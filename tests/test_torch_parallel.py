"""The port's slab mesh and B9, the halo-slab builds of the stencil kernels.

- ``mesh_shape_for`` against the reference's over a table.
- Gloo ranks on the CPU (2 and 4, spawned once for the module,
  tests/torch_mesh_ranks.py): ``distribute``/``local_values``/
  ``global_from_local``/``owned_box``/``gather`` round-trip, the halo
  rows are the neighbours' rows with the ring closed, the reductions,
  a y split's boxes and the refusals of a split needing more ranks
  and of slabs thinner than sw; the
  sharded block-pc apply against the reference's
  ``make_sharded_block_apply`` on a (2, 1) mesh (the port's
  ``make_sharded_apply``), in float32 and
  bfloat16.
- B9's plain versions on S in {1, 2, 4} slabs of one global state (the
  halo rows cut from it, in one process): stitched, they equal the
  unsharded plain versions bit for bit under one scalar pack, and the
  reference's sharded interpret-mode kernels on a (2, 1) mesh within
  1e-5 relative (test_pallas.py:181-215's bound).
- The halo-slab CUDA bodies compiled as host C++ on ragged slabs: each
  within 1e-5 of max|plain| of its plain version and, stitched, equal to
  the unsharded host bodies bit for bit; on a card (``cuda`` marker) the
  same for the CUDA launches.
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
import ksfd_tpu as KJ
from helpers import make_clargs
from ksfd_tpu.ops.pallas_stencil import make_pallas_kernels
from ksfd_tpu.parallel import distribute as jdistribute
from ksfd_tpu.parallel import grid_mesh as jgrid_mesh
from ksfd_tpu.parallel import mesh_shape_for as jmesh_shape_for
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu_torch import Grid
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_stencil import CSRC, make_fused_kernels
from ksfd_tpu_torch.ops.fused_stencil3d import CSRC3D
from ksfd_tpu_torch.parallel import mesh_shape_for
from ksfd_tpu_torch.parallel.mesh import SlabMesh
from ksfd_tpu_torch.tools.problems import bench_clargs
from test_torch_3d import aggregation3d_params
from test_torch_3d import rough_state as rough_state3d
from torch_mesh_ranks import (
    H,
    N2,
    N2_SMALL,
    rough_state,
    run_ranks,
)

RANK_CASES = ["layout", "reduce", "refusals"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results, over 2 ranks (with the sharded pc apply) and
    over 4: one spawn of each for the module."""
    return run_ranks({2: RANK_CASES + ["pc_apply"], 4: RANK_CASES})


@pytest.mark.parametrize("n,dims,nps", [
    (1, 2, (64, 64)), (2, 2, (64, 64)), (4, 2, (64, 64)), (8, 2, (64, 64)),
    (8, 2, (32, 32)), (4, 2, (36, 36)), (6, 2, (48, 30)), (4, 3, (32,) * 3),
    (8, 3, (16, 16, 16)), (8, 1, (6,)), (8, 1, (1024,)), (3, 2, None),
    (12, 3, None), (16, 2, (64, 64)),
])
def test_mesh_shape_for_matches_reference(n, dims, nps):
    assert mesh_shape_for(n, dims, nps) == jmesh_shape_for(n, dims, nps)


@pytest.mark.parametrize("n", [2, 4])
def test_layout_round_trip(ranks, n):
    """A global state becomes each rank's slab and back: the blocks,
    their boxes, the numpy round trip and the all_gather."""
    u = rough_state((N2_SMALL, N2_SMALL), seed=3)
    rows = N2_SMALL // n
    for r, res in ranks[n].items():
        out = res["layout"]
        np.testing.assert_array_equal(out["slab"],
                                      u[:, r * rows:(r + 1) * rows])
        box = ((r * rows, (r + 1) * rows), (0, N2_SMALL))
        assert out["box"].tolist() == [list(b) for b in box]
        assert out["pbox"].tolist() == out["box"].tolist()
        assert out["block_equal"] and out["from_block"] and out["from_full"]
        assert out["same_mesh"] and (out["count"], out["index"]) == (n, r)
        np.testing.assert_array_equal(out["gathered"], u)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_rows_are_the_neighbours_rows(ranks, n):
    """lo is the left neighbour's last sw rows and hi the right
    neighbour's first sw rows, the ring closed (rank 0's lo is the
    grid's last rows), each contiguous; two slabs exchanged at once get
    the same rows."""
    sw = 2
    u = rough_state((N2_SMALL, N2_SMALL), seed=3)
    v = rough_state((N2_SMALL, N2_SMALL), seed=4).astype(np.float32)
    rows = N2_SMALL // n
    for r, res in ranks[n].items():
        out = res["layout"]
        x0, x1 = r * rows, (r + 1) * rows
        lo_rows = np.arange(x0 - sw, x0) % N2_SMALL
        hi_rows = np.arange(x1, x1 + sw) % N2_SMALL
        np.testing.assert_array_equal(out["lo"], u[:, lo_rows])
        np.testing.assert_array_equal(out["hi"], u[:, hi_rows])
        np.testing.assert_array_equal(out["lo_v"], v[:, lo_rows])
        np.testing.assert_array_equal(out["hi_v"], v[:, hi_rows])
        np.testing.assert_array_equal(out["lo_u32"],
                                      u[:, lo_rows].astype(np.float32))
        assert out["contiguous"]


@pytest.mark.parametrize("n", [2, 4])
def test_reductions(ranks, n):
    """Sum, max and min over the ranks, the same on every rank, the
    input untouched; bfloat16 sums go over gloo as bfloat16."""
    ranks_ = np.arange(n)
    for r, res in ranks[n].items():
        out = res["reduce"]
        np.testing.assert_array_equal(out["sum"], [np.sum(1.0 + ranks_),
                                                   np.sum(-2.0 * ranks_)])
        np.testing.assert_array_equal(out["max"], [float(n), 0.0])
        np.testing.assert_array_equal(out["min"], [1.0, -2.0 * (n - 1)])
        np.testing.assert_array_equal(out["bf16"], [np.sum(0.5 + ranks_)])
        assert out["bf16_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(out["x_kept"], [1.0 + r, -2.0 * r])


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_refusals(ranks, n):
    """A y split, once refused, gives each rank its box of the (1, n)
    split (tests/test_torch_mesh_splits.py runs it); an x-and-y split
    that needs more ranks than the group has, and slabs thinner than the
    stencil width, raise."""
    w = N2_SMALL // n
    for r, res in ranks[n].items():
        out = res["refusals"]
        assert out["y"] == ((0, N2_SMALL), (w * r, w * (r + 1)))
        assert "uses %d ranks, the group has %d" % (2 * n, n) in out["xy"]
        assert "at least sw=2 rows" in out["rows"], out["rows"]


def test_nccl_two_ranks_on_one_device_raise():
    """NCCL cannot pair two ranks on one card: the mesh refuses it
    before any collective (gloo may share a card)."""
    grid = Grid(dim=2, nx=16, ny=16, dof=3)
    with pytest.raises(ValueError, match="NCCL cannot run two ranks"):
        SlabMesh(grid, None, (2, 1), 0, "nccl", "cuda:0", ["cuda:0", "cuda:0"])
    SlabMesh(grid, None, (2, 1), 0, "nccl", "cuda:0", ["cuda:0", "cuda:1"])
    SlabMesh(grid, None, (2, 1), 0, "gloo", "cuda:0", ["cuda:0", "cuda:0"])


@pytest.fixture(scope="module")
def ref_bench():
    _, jgrid, jops = ge._make_problem(N2, N2)
    return jgrid, jops


@pytest.mark.parametrize("dtype,tol", [
    # float32: the products' rounding in another order (1e-5 of max)
    ("float32", 1e-5),
    # bfloat16: the operands, the two forward intermediates and the
    # reduced coefficients each round to 8 bits (4 x 2^-8 of max)
    ("bfloat16", 4 * 2.0 ** -8),
])
def test_sharded_pc_apply_matches_reference(ranks, ref_bench, dtype, tol):
    """make_sharded_apply over 2 gloo ranks against the
    reference's on a (2, 1) mesh: the same residual and statistics."""
    jgrid, jops = ref_bench
    u = jops.groom(jnp.asarray(rough_state((N2, N2))))
    v = np.random.default_rng(5).standard_normal(u.shape).astype(np.float32)
    u32 = u.astype(jnp.float32)
    t = jnp.asarray(0.0, jnp.float32)
    means = [jnp.mean(u32[i]) for i in range(3)]
    rho_diff = jnp.max(u32[0] * jops._dG_fns[0](*u32, t))
    shift = 1.0 / (H * 0.435866521508459)
    mesh = jgrid_mesh(jgrid, shape=(2, 1))
    pc = jlinalg.BlockSpectralPreconditioner(jgrid, jops,
                                             compute_dtype=dtype)
    apply = jlinalg.make_sharded_block_apply(pc, jops, mesh)
    vs, _ = jdistribute(jnp.asarray(v), jgrid, mesh=mesh)
    ref = np.asarray(apply(vs, shift, t, means, rho_diff))
    for res in ranks[2].values():
        out = res["pc_apply"]
        assert out[dtype + "_dtype"] == "torch.float32"
        err = np.abs(out[dtype] - ref).max()
        assert err <= tol * np.abs(ref).max(), (dtype, err)


# ---------------------------------------------------- B9 in one process


def slab_meshes(grid, S, device="cpu"):
    """The S ranks' meshes of an x split, without a process group: the
    B9 bodies and ``cut`` need no communication."""
    return [SlabMesh(grid, None, (S,) + (1,) * (grid.dim - 1), r, "gloo",
                     device, [device] * S)
            for r in range(S)]


def entry_args(ops, u64, seed=1):
    """Each entry's arguments on the global state (f64 tensors)."""
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal(u64.shape))
    b = torch.from_numpy(rng.standard_normal(u64.shape))
    d = torch.from_numpy(100.0 * rng.standard_normal(u64.shape))
    u1 = ops.groom(u64 + d)
    u32 = u64.float()
    return dict(rhs=(u32, 0.5), jvp=(u32, v, 0.5), resid=(u32, v, b, 0.5, 7.5),
                delta=(u64, u1 - u64, u1, 0.5))


def slab_operands(kernel, mesh, operands):
    """A slab kernel's operands cut from the unsharded prepared ones:
    each stencil operand's slab with its halo rows, then the own-point
    operands' slabs."""
    sw = kernel._owner.ops.sw
    out = []
    for x in operands[:kernel.n_st]:
        out += list(mesh.cut(x, sw))
    return out + [mesh.cut(x, sw)[0] for x in operands[kernel.n_st:]]


@pytest.fixture(scope="module")
def problem2d():
    n = N2_SMALL
    jps, jgrid, jops = ge._make_problem(n, n)
    _, grid, tops = problem_from_clargs(jps.clargs, n, n, device="cpu")
    u64 = tops.groom(torch.from_numpy(rough_state((n, n))))
    return jgrid, jops, grid, tops, u64


@pytest.mark.parametrize("S", [1, 2, 4])
def test_b9_plain_slabs_stitch_bit_equal(problem2d, S):
    """Each B9 plain version on S slabs (halo rows cut from the global
    state), stitched, equals the unsharded plain version bit for bit
    under the same scalar pack."""
    _, _, grid, tops, u64 = problem2d
    full = make_fused_kernels(tops)
    meshes = slab_meshes(grid, S)
    slab = make_fused_kernels(tops, mesh=meshes[0])
    assert slab.kind == "halo-slab (B9) over %d x-slabs" % S
    for name, args in entry_args(tops, u64).items():
        sc, operands = full.kernels[name].prepare(*args)
        ref = full.kernels[name].body(sc, operands)
        k = slab.kernels[name]
        outs = [k.body(sc, slab_operands(k, m, operands)) for m in meshes]
        assert torch.equal(torch.cat(outs, dim=1), ref), name
        assert k.launches == 0


def test_b9_plain_matches_reference_sharded(problem2d):
    """The B9 plain versions on 2 slabs against the reference's sharded
    interpret-mode kernels on a (2, 1) mesh: within 1e-5 relative
    (test_pallas.py:181-215; the means are each side's own)."""
    jgrid, jops, grid, tops, u64 = problem2d
    mesh = jgrid_mesh(jgrid, shape=(2, 1))
    pk = make_pallas_kernels(jops, tile_x=16, interpret=True, mesh=mesh)
    full = make_fused_kernels(tops)
    meshes = slab_meshes(grid, 2)
    slab = make_fused_kernels(tops, mesh=meshes[0])
    args = entry_args(tops, u64)
    for name, args_ in args.items():
        # the port's slab kernels take their pack from the prepare of
        # each rank; the means of this one-process check come from the
        # unsharded prepare, the reference's from its global reduction
        sc, operands = full.kernels[name].prepare(*args_)
        k = slab.kernels[name]
        out = torch.cat([k.body(sc, slab_operands(k, m, operands))
                         for m in meshes], dim=1).numpy()
        jargs = [jdistribute(jnp.asarray(a.numpy()), jgrid, mesh=mesh)[0]
                 if isinstance(a, torch.Tensor) else a for a in args_]
        ref = np.asarray(getattr(pk, name)(*jargs))
        scale = np.abs(ref).max()
        assert np.abs(out - ref).max() <= 1e-5 * scale, name


# ------------------------------------------- the CUDA bodies on the host

_SHIM_2D = r"""
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

// one host thread walks every block of the march's 1D grid as the source
// exports it; p holds the operands in the entry's order (the unsharded
// one, or the halo-slab one: each stencil operand with its lo and hi
// rows)
extern "C" int run(int which, int halo, const float* sc,
                   const float* const* p, float* out, int nx, int ny) {
  threadIdx = {0, 0, 0};
  for (long long bx = 0; bx < ksfd_blocks(which, nx, ny, 1); ++bx) {
    blockIdx = {(unsigned)bx, 0, 0};
    if (!halo) {
      if (which == 0) jvp_kernel<false>(sc, p[0], p[1], nullptr, out, nx, ny);
      if (which == 1) jvp_kernel<true>(sc, p[0], p[1], p[2], out, nx, ny);
      if (which == 2) delta_kernel(sc, p[0], p[1], p[2], out, nx, ny);
      if (which == 3) rhs_kernel(sc, p[0], out, nx, ny);
    } else {
      if (which == 0)
        jvp_halo_kernel<false>(sc, p[0], p[1], p[2], p[3], p[4], p[5],
                               nullptr, out, nx, ny);
      if (which == 1)
        jvp_halo_kernel<true>(sc, p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                              out, nx, ny);
      if (which == 2)
        delta_halo_kernel(sc, p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                          p[7], p[8], out, nx, ny);
      if (which == 3) rhs_halo_kernel(sc, p[0], p[1], p[2], out, nx, ny);
    }
  }
  return 0;
}
"""

_SHIM_3D = r"""
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

// one member's grid as the source exports it (a halo-slab build has its
// kernel's)
extern "C" int run(int which, int halo, const float* sc,
                   const float* const* p, float* out, int nx, int ny,
                   int nz) {
  threadIdx = {0, 0, 0};
  const long long blocks = ksfd_blocks(which, nx, ny, nz, 1);
  for (long long bx = 0; bx < blocks; ++bx) {
    blockIdx = {(unsigned)bx, 0, 0};
    if (!halo) {
      if (which == 0) jvp_kernel<false>(sc, p[0], p[1], nullptr, out, nx, ny, nz);
      if (which == 1) jvp_kernel<true>(sc, p[0], p[1], p[2], out, nx, ny, nz);
      if (which == 2) delta_kernel(sc, p[0], p[1], p[2], out, nx, ny, nz);
      if (which == 3) rhs_kernel(sc, p[0], out, nx, ny, nz);
    } else {
      if (which == 0)
        jvp_halo_kernel<false>(sc, p[0], p[1], p[2], p[3], p[4], p[5],
                               nullptr, out, nx, ny, nz);
      if (which == 1)
        jvp_halo_kernel<true>(sc, p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                              out, nx, ny, nz);
      if (which == 2)
        delta_halo_kernel(sc, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                          p[8], out, nx, ny, nz);
      if (which == 3) rhs_halo_kernel(sc, p[0], p[1], p[2], out, nx, ny, nz);
    }
  }
  return 0;
}
"""

HOST_KERNELS = dict(jvp=0, resid=1, delta=2, rhs=3)


def host_library(header, csrc, shim, tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    (tmp_path / "ksfd_pointwise.cuh").write_text(header)
    shutil.copy(csrc, tmp_path / os.path.basename(csrc))
    (tmp_path / "shim.cpp").write_text(shim)
    lib = tmp_path / "libkern.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-DKSFD_NT=1", "-I",
         str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(lib))


def host_run(host, name, halo, sc, operands, shape, dof):
    ptrs = (ctypes.c_void_p * len(operands))(
        *[x.data_ptr() for x in operands])
    out = torch.empty((dof,) + tuple(shape), dtype=torch.float32)
    host.run.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * len(shape))
    host.run(HOST_KERNELS[name], int(halo), ctypes.c_void_p(sc.data_ptr()),
             ptrs, ctypes.c_void_p(out.data_ptr()), *shape)
    return out


def with_clamps(u, ops):
    """Points below, at and NaN against the floors, near both slab
    boundaries of a 2-way split (the raw rhs/jvp/resid states)."""
    u = u.copy()
    nx = u.shape[1]
    for i, (x, val) in enumerate(((0, 0.5 * ops.rhomin),
                                  (nx // 2 - 1, ops.rhomin),
                                  (nx // 2, np.nan), (nx - 1, ops.Umin))):
        u[(i % len(u), x) + (1,) * (u.ndim - 2)] = val
    return u


@pytest.mark.parametrize("dim,shape,splits", [
    (2, (20, 36), (2, 4)),       # 10 and 5 rows: one ragged 16-row tile
    (2, (40, 68), (2,)),         # 20 rows: a full tile and a ragged one
    (3, (12, 10, 20), (2, 4)),   # 6 and 3 rows: ragged 4-row tiles
    (3, (8, 10, 20), (4,)),      # sw = 2 rows: the march's window in halos
    (3, (140, 6, 9), (2,)),      # 70 rows: x chunks of 32, 32 and 6
    (2, (72, 256), (2, 4)),      # 36 and 18 rows: the 2D march's chunks
                                 # of 32 (two steps) and partial steps
    (2, (8, 130), (4,)),         # sw = 2 rows: the 2D march's window in
                                 # halos, a ragged strip of 2 columns
])
def test_cuda_halo_bodies_match_plain_and_stitch(dim, shape, splits,
                                                 tmp_path):
    """The halo-slab bodies of csrc/stencil{2,3}d.cu, compiled as host
    C++ (KSFD_NT=1), on ragged slabs, slabs of sw rows and of several
    x chunks of the march: within 1e-5 of max|plain| of the
    B9 plain version, and stitched equal to the unsharded host bodies
    bit for bit (rhs, jvp, resid on a raw state with clamped and NaN
    points at the slab boundaries)."""
    _halo_stitch(dim, shape, splits, tmp_path)


@pytest.mark.parametrize("dim,dof", [
    pytest.param(3, 2, id="2"), pytest.param(3, 4, id="4"),
    pytest.param(2, 2, id="2d_dof2"), pytest.param(2, 4, id="2d_dof4"),
    pytest.param(2, 5, id="2d_dof5"), pytest.param(2, 6, id="2d_dof6"),
])
def test_cuda_halo_bodies_stitch_other_field_counts(dim, dof, tmp_path):
    """As test_cuda_halo_bodies_match_plain_and_stitch, 3D and 2D, with
    2 and with 4 fields (a point's raw values outnumber jvp's and
    resid's window arrays at 4), in 2D also with 5 and 6 (the most the
    2D build holds: delta's ring passes 48 KB of shared memory at 5,
    jvp's at 6), on slabs of several x chunks and of sw rows."""
    big, thin = (((140, 6, 9), (8, 10, 20)) if dim == 3
                 else ((72, 256), (8, 130)))
    _halo_stitch(dim, big, (2, 4), tmp_path, dof)
    (tmp_path / "sw").mkdir()
    _halo_stitch(dim, thin, (4,), tmp_path / "sw", dof)


def _halo_stitch(dim, shape, splits, tmp_path, dof=3):
    clargs = (make_clargs(params=aggregation3d_params(shape[0], dof))
              if dim == 3 else bench_clargs(shape[0], dof))
    _, grid, tops = problem_from_clargs(clargs, *shape, device="cpu")
    full = make_fused_kernels(tops)
    host = host_library(full.build.header, CSRC3D if dim == 3 else CSRC,
                        _SHIM_3D if dim == 3 else _SHIM_2D, tmp_path)
    raw = torch.from_numpy(with_clamps(rough_state3d(shape, dof=dof), tops))
    u64 = tops.groom(raw)
    args = entry_args(tops, u64, seed=7)
    for name in ("rhs", "jvp", "resid"):
        args[name] = (raw.float(),) + args[name][1:]
    for S in splits:
        meshes = slab_meshes(grid, S)
        slab = make_fused_kernels(tops, mesh=meshes[0])
        for name, a in args.items():
            sc, operands = full.kernels[name].prepare(*a)
            ref_full = host_run(host, name, False, sc, operands, shape, dof)
            k = slab.kernels[name]
            outs = []
            for m in meshes:
                ops_m = slab_operands(k, m, operands)
                out = host_run(host, name, True, sc, ops_m, m.local_shape,
                               dof)
                plain = k.body(sc, ops_m)
                err = float((out - plain).abs().max())
                assert torch.isfinite(out).all(), (name, S)
                assert err <= 1e-5 * float(plain.abs().max()), (name, S, err)
                outs.append(out)
            assert torch.equal(torch.cat(outs, dim=1), ref_full), (name, S)


@pytest.mark.cuda
def test_cuda_halo_kernels_match_plain_and_stitch():
    """On a card: each B9 launch within 1e-5 of max|plain| of its plain
    version, counted, and the stitched slabs equal to the unsharded
    launch bit for bit (chip_smoke.py runs this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    for dim, shape in ((2, (64, 64)), (3, (16, 16, 32))):
        clargs = (make_clargs(params=aggregation3d_params(shape[0]))
                  if dim == 3 else bench_clargs(shape[0]))
        _, grid, tops = problem_from_clargs(clargs, *shape, device="cuda")
        full = make_fused_kernels(tops)
        u64 = tops.groom(torch.from_numpy(rough_state(shape)).cuda())
        meshes = slab_meshes(grid, 2, device="cuda")
        slab = make_fused_kernels(tops, mesh=meshes[0])
        for name, a in entry_args(tops, u64).items():
            a = tuple(x.cuda() if isinstance(x, torch.Tensor) else x
                      for x in a)
            sc, operands = full.kernels[name].prepare(*a)
            ref = full.kernels[name].launch(sc, operands)
            k = slab.kernels[name]
            outs = []
            for m in meshes:
                ops_m = slab_operands(k, m, operands)
                n0 = k.launches
                out = k.launch(sc, ops_m)
                assert k.launches == n0 + 1
                plain = k.body(sc, ops_m)
                assert float((out - plain).abs().max()) <= 1e-5 * float(
                    plain.abs().max())
                outs.append(out)
            assert torch.equal(torch.cat(outs, dim=1), ref), name
