// Fused float32 stencil kernels of the Keller-Segel operator, 3D
// periodic, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of ksfd_tpu/ops/pallas_stencil3d.py:
//   ksfd_rhs    <- rhs_kernel   :366
//   ksfd_resid  <- resid_kernel :426 (rows from _jvp_rows :390)
//   ksfd_jvp    <- jvp_kernel   :419
//   ksfd_delta  <- delta_kernel :440
// They compute what csrc/stencil2d.cu computes, with a third stencil
// axis.  The problem (G, dG, G_delta, the stencil coefficients of all
// three axes, groom floors, ligand coefficients) comes from the header
// that ops/codegen.py generates (ksfd_pointwise.cuh, KSFD_DIM 3).  The
// wrappers, scalar packs and plain PyTorch versions are in
// ops/fused_stencil3d.py and ops/fused_stencil.py.
//
// Layout: the natural (dof, nx, ny, nz), z contiguous, any extents
// >= 2*SW+1 (bounds guards, no alignment), 64-bit element offsets.
// The TPU's folded (dof, nx, ny*nz) lane layout is not carried over.
//
// Bound: memory.  At 256^3 x 3 f32 one operand is 201 MB; resid reads
// u, v, b and writes out (805 MB, 240 us at the H100 SXM's 3.35 TB/s),
// jvp 604 MB (180 us), delta 805 MB (240 us), rhs 403 MB (120 us).  Design (the simple one;
// a 2.5D march along x with a rolling window of 2*SW+1 planes is the
// faster design, left for later): one block of NT threads per
// TX x TY x TZ tile, z fastest.  The block reads its inputs over a
// box with an SW-wide halo straight from global memory by periodic
// index arithmetic, evaluates G / dG.v / G_delta ONCE per box point
// into dynamic shared memory, then applies the star stencils from
// there.  The star stencils never read a box point with two or more
// coordinates in the halo (edges and corners), so those are skipped:
// at 4 x 8 x 32 and SW=2, 2,688 of the box's 3,456 points are
// evaluated, 2.6 per output point.  Shared memory is (4 + NL) arrays
// of the 8 x 12 x 36 box for resid/jvp/delta, 82,944 B for three
// fields, and (2 + NL) arrays for rhs, 55,296 B: above the 48 KB
// static limit, so each entry opts its kernel into its own amount of
// dynamic shared memory before it launches.  On an H100 80GB HBM3 at 700 W
// this design takes 1.1-1.3 ms per launch at 256^3 x 3, 5-6x the
// bound: the re-evaluated pointwise functions, not the bytes, set its
// time (PERF.md, chip_smoke.py phase 5).
//
// Semantics kept from the Pallas body (as in stencil2d.cu):
//   - where-form clamp: x >= min ? x : min, so NaN -> min;
//   - the J-action tangent is zeroed where the clamp is active, with a
//     strict '>' ; the resid shift term uses the RAW tangent;
//   - rhs centres rho, G and each U on f64 means and adds the f64
//     mean-level reaction balances, all from the scalar pack; the
//     rho*lap(Gc) term takes the uncentred groomed rho;
//   - delta centres G on the f64 mean G(means) and rho on its f64 mean,
//     both passed in the scalar pack;
//   - the scalar pack is a small f32 DEVICE array read here, never a
//     host float, so a launch needs no host sync.
// The build passes -fmad=false (ops/fused_stencil.py NVCC_FLAGS): no
// multiply-add contraction, so every product and sum rounds as in the
// plain version's separate PyTorch operations, and rhs on a
// near-uniform state (where one ulp of G moves the centred rho row by
// its whole size) matches its plain version.
// Every C entry launches on the caller's stream, allocates nothing and
// returns the first CUDA error (0 on success).
//
// Member-batched builds (pallas_stencil3d.py:191-192, :246-260, B8 in
// 3D): every entry takes a member count nb >= 1 and launches one grid
// of nb x the tiles.  The grid is one-dimensional (gridDim.x's 2^31 - 1
// leaves the member count uncapped) and a block decodes its tile from
// blockIdx.x with the member slowest, then the x tile, the y tile and
// the z tile fastest, so the blocks of a batched launch run in the
// order of nb single launches back to back.  That order matters: a
// 4-wide x tile reads 2 * SW halo planes besides its 4, which can come from
// L2 only while the x-neighbour tiles run close by; a member-major fold
// into the z tiles interleaved the members and took 1.05-1.08x the time
// of nb single launches on the H100 (PERF.md, section 6).  Operands are
// contiguous (nb, DOF, nx, ny, nz) and the scalar pack is (nb, k), one
// row per member, as the batched Pallas build's per-member pack rows.
// A block adds member * DOF * nx * ny * nz (64-bit) to its pointers and
// member * k to the pack, and nothing else changes: a member's
// arithmetic is that of a single launch, so a batched launch equals nb
// single launches bit for bit, and nb = 1 is the single-member kernel.
//
// Halo-slab builds (B9 in 3D, pallas_stencil3d.py pad_x :474-486,
// shardwrap :488-500, padded_src :263): ksfd_<name>_halo runs the same
// kernel on one rank's local x-slab (nx = the slab's rows), as
// csrc/stencil2d.cu's halo entries do.  Each stencil operand comes as
// the slab plus its lo and hi halo buffers, each a contiguous
// (DOF, SW, ny, nz) block of the ring neighbours' boundary rows; a box
// row r in [-SW, nx + SW) reads lo, the slab or hi in place of
// wrap(r, nx), and y and z still wrap inside the slab.  No padded copy
// of an operand is made.  One member; the 1D member-slowest grid decode
// stays for the unsharded build (here it decodes one member's tiles).
// The arithmetic per point is the unsharded kernel's, so the stitched
// slabs equal one unsharded launch bit for bit under one scalar pack.
//
// Without __CUDACC__ (a host C++ compiler with the CUDA qualifiers
// defined away, KSFD_NT=1 and one thread walking each block) the kernel
// bodies compile as plain C++; tests/test_torch_3d.py runs them so on
// the CPU.  The C entries exist only in the nvcc build.

#include <math.h>
#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ksfd_pointwise.cuh"

static_assert(KSFD_DIM == 3, "stencil3d.cu needs the 3D pointwise header");

#ifndef KSFD_NT
#define KSFD_NT 256
#endif

extern __shared__ float ksfd_smem[];

namespace {

constexpr int SW = KSFD_SW;
constexpr int DOF = KSFD_DOF;
constexpr int NL = DOF - 1;        // ligand fields
constexpr int TX = 4;              // tile extent along x
constexpr int TY = 8;              // along y
constexpr int TZ = 32;             // along z (contiguous)
constexpr int NT = KSFD_NT;        // threads per block
constexpr int HX = TX + 2 * SW;
constexpr int HY = TY + 2 * SW;
constexpr int HZ = TZ + 2 * SW;
constexpr int SY = HZ;             // box stride along y
constexpr int SX = HY * HZ;        // box stride along x
constexpr int HN = HX * HY * HZ;
constexpr int TN = TX * TY * TZ;
// shared arrays per box point: resid/jvp rho, G, dG.v, v_rho, v_U[NL];
// delta d_rho, G0c + dG, rho0c, dG, d_U[NL]; rhs rho_c, Gc, Uc[NL]
constexpr int NARR = 4 + (NL > 0 ? NL : 1);
constexpr int NARR_RHS = 2 + (NL > 0 ? NL : 1);
// scalar pack lengths, the row stride of a batched pack
constexpr int SC_RHS = 2 * DOF + 1;  // t, means, G(means), reactions
constexpr int SC_JVP = 1;            // t
constexpr int SC_RESID = 2;          // t, shift
constexpr int SC_DELTA = 3;          // t, rho_mean, G0_mean
constexpr size_t SMEM_BYTES = sizeof(float) * NARR * HN;
constexpr size_t SMEM_BYTES_RHS = sizeof(float) * NARR_RHS * HN;
static_assert(SMEM_BYTES <= 227 * 1024, "tile too large for shared memory");

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// A box point that some star stencil of the tile reads: at most one
// of its coordinates lies in the halo.
__device__ __forceinline__ bool on_star(int hx, int hy, int hz) {
  const int out = (hx < SW || hx >= SW + TX) + (hy < SW || hy >= SW + TY) +
                  (hz < SW || hz >= SW + TZ);
  return out <= 1;
}

// Where box point (hx, hy, hz) of the tile at (x0, y0, z0) reads an
// operand: ``part`` 1 is the operand itself at in-field offset ``g``
// (wrapped periodically) with one field's extent ``plane``; in the
// halo-slab build rows below 0 are in lo (part 0) and rows at or past nx
// in hi (part 2), whose fields are SW rows.
struct Rows {
  int part;
  size_t g, plane;
};

template <bool HALO>
__device__ __forceinline__ Rows box_rows(int hx, int hy, int hz, int x0,
                                         int y0, int z0, int nx, int ny,
                                         int nz) {
  const int r = x0 + hx - SW;
  const size_t yz = (size_t)wrap(y0 + hy - SW, ny) * nz + wrap(z0 + hz - SW, nz);
  const size_t pl = (size_t)ny * nz;
  if (!HALO)
    return Rows{1, ((size_t)wrap(r, nx) * ny + wrap(y0 + hy - SW, ny)) * nz +
                       wrap(z0 + hz - SW, nz),
                (size_t)nx * pl};
  if (r < 0) return Rows{0, (size_t)(r + SW) * pl + yz, (size_t)SW * pl};
  // a ragged last tile's box reaches past the halo: rows no output
  // reads, loaded from hi's last row so that every read stays in hi
  if (r >= nx)
    return Rows{2, (size_t)(r - nx < SW ? r - nx : SW - 1) * pl + yz,
                (size_t)SW * pl};
  return Rows{1, (size_t)r * pl + yz, (size_t)nx * pl};
}

// The base of the part that w reads: the operand p, or its lo or hi.
template <bool HALO>
__device__ __forceinline__ const float* part(const float* p, const float* lo,
                                             const float* hi, const Rows& w) {
  return !HALO || w.part == 1 ? p : (w.part == 0 ? lo : hi);
}

// The tile origin (x0, y0, z0) of this block and its member, decoded
// from the 1D grid: member slowest, then x, y and z tiles.
struct Tile {
  int x0, y0, z0;
  size_t member;
};

__device__ __forceinline__ Tile tile_of(int nx, int ny, int nz) {
  const unsigned ntz = (nz + TZ - 1) / TZ, nty = (ny + TY - 1) / TY;
  const unsigned per_member = ntz * nty * ((nx + TX - 1) / TX);
  const unsigned member = blockIdx.x / per_member;
  const unsigned r = blockIdx.x - member * per_member;
  const unsigned xz = r / ntz, yt = xz % nty;
  return Tile{(int)(xz / nty) * TX, (int)yt * TY, (int)(r - xz * ntz) * TZ,
              (size_t)member};
}

__device__ __forceinline__ float lap(const float* p) {
  return ksfd_d2x(p, SX) + ksfd_d2y(p, SY) + ksfd_d2z(p, 1);
}

__device__ __forceinline__ float graddot(const float* a, const float* b) {
  return ksfd_d1x(a, SX) * ksfd_d1x(b, SX) + ksfd_d1y(a, SY) * ksfd_d1y(b, SY) +
         ksfd_d1z(a, 1) * ksfd_d1z(b, 1);
}

// The full centred RHS of the float32 fast mode (no sources: the
// wrapper adds them).  u is the RAW state (groomed here).
// sc = [t, mean_0 .. mean_{DOF-1}, G(means), react_1 .. react_NL]
// (t is unused: the generated G carries no time dependence).
template <bool HALO>
__device__ __forceinline__ void rhs_body(
    const float* __restrict__ sc, const float* __restrict__ u,
    const float* __restrict__ u_lo, const float* __restrict__ u_hi,
    float* __restrict__ out, int nx, int ny, int nz) {
  float* s_rc = ksfd_smem;
  float* s_Gc = s_rc + HN;
  float* s_Uc = s_Gc + HN;  // NL arrays of HN
  const Tile tl = tile_of(nx, ny, nz);
  const int x0 = tl.x0, y0 = tl.y0, z0 = tl.z0;
  const size_t plane = (size_t)nx * ny * nz;
  const size_t member = tl.member * DOF * plane;
  sc += tl.member * SC_RHS;
  u += member;
  out += member;
  const float rho_mean = sc[1], G_mean = sc[1 + DOF];

  for (int i = threadIdx.x; i < HN; i += NT) {
    const int hx = i / SX, r = i - hx * SX, hy = r / SY, hz = r - hy * SY;
    if (!on_star(hx, hy, hz)) continue;
    const Rows w = box_rows<HALO>(hx, hy, hz, x0, y0, z0, nx, ny, nz);
    const float* up = part<HALO>(u, u_lo, u_hi, w);
    float f[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      const float raw = up[k * w.plane + w.g];
      const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
      f[k] = raw >= lo ? raw : lo;
    }
    s_rc[i] = f[0] - rho_mean;
    s_Gc[i] = ksfd_G(f) - G_mean;
#pragma unroll
    for (int l = 0; l < NL; ++l) s_Uc[l * HN + i] = f[1 + l] - sc[2 + l];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TN; i += NT) {
    const int ix = i / (TY * TZ), r = i - ix * (TY * TZ);
    const int iy = r / TZ, iz = r - iy * TZ;
    const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
    if (gx >= nx || gy >= ny || gz >= nz) continue;
    const int c = (ix + SW) * SX + (iy + SW) * SY + (iz + SW);
    const size_t g = ((size_t)gx * ny + gy) * nz + gz;
    // the uncentred groomed rho at the output point
    const float raw = u[g];
    const float rho = raw >= KSFD_RHOMIN ? raw : KSFD_RHOMIN;
    const float rc = s_rc[c];
    out[g] = graddot(&s_rc[c], &s_Gc[c]) + rho * lap(&s_Gc[c]);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* Uc = &s_Uc[l * HN + c];
      out[(1 + l) * plane + g] = -ksfd_gamma(l) * Uc[0] + ksfd_s(l) * rc +
                                 sc[2 + DOF + l] + ksfd_D(l) * lap(Uc);
    }
  }
}

__global__ void __launch_bounds__(NT)
rhs_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           float* __restrict__ out, int nx, int ny, int nz) {
  rhs_body<false>(sc, u, nullptr, nullptr, out, nx, ny, nz);
}

// B9: one rank's slab with its halo rows (one member)
__global__ void __launch_bounds__(NT)
rhs_halo_kernel(const float* __restrict__ sc, const float* __restrict__ u,
                const float* __restrict__ u_lo,
                const float* __restrict__ u_hi, float* __restrict__ out,
                int nx, int ny, int nz) {
  rhs_body<true>(sc, u, u_lo, u_hi, out, nx, ny, nz);
}

// The J-action rows (and, with RESID, the fused Richardson residual
// b - shift*v + J(u)v).  sc = [t, shift] (t is unused: the generated
// G carries no time dependence).
template <bool RESID, bool HALO>
__device__ __forceinline__ void jvp_body(
    const float* __restrict__ sc, const float* __restrict__ u,
    const float* __restrict__ u_lo, const float* __restrict__ u_hi,
    const float* __restrict__ v, const float* __restrict__ v_lo,
    const float* __restrict__ v_hi, const float* __restrict__ b,
    float* __restrict__ out, int nx, int ny, int nz) {
  float* s_rho = ksfd_smem;
  float* s_G = s_rho + HN;
  float* s_dG = s_G + HN;
  float* s_vr = s_dG + HN;
  float* s_vU = s_vr + HN;  // NL arrays of HN
  const Tile tl = tile_of(nx, ny, nz);
  const int x0 = tl.x0, y0 = tl.y0, z0 = tl.z0;
  const size_t plane = (size_t)nx * ny * nz;
  const size_t member = tl.member * DOF * plane;
  sc += tl.member * (RESID ? SC_RESID : SC_JVP);
  u += member;
  v += member;
  out += member;
  if (RESID) b += member;

  for (int i = threadIdx.x; i < HN; i += NT) {
    const int hx = i / SX, r = i - hx * SX, hy = r / SY, hz = r - hy * SY;
    if (!on_star(hx, hy, hz)) continue;
    const Rows w = box_rows<HALO>(hx, hy, hz, x0, y0, z0, nx, ny, nz);
    const float* up = part<HALO>(u, u_lo, u_hi, w);
    const float* vp = part<HALO>(v, v_lo, v_hi, w);
    float f[DOF], vm[DOF], dg[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      const float raw = up[k * w.plane + w.g];
      const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
      f[k] = raw >= lo ? raw : lo;
      vm[k] = raw > lo ? vp[k * w.plane + w.g] : 0.0f;
    }
    ksfd_dG(f, dg);
    float dG = dg[0] * vm[0];
#pragma unroll
    for (int k = 1; k < DOF; ++k) dG = dG + dg[k] * vm[k];
    s_rho[i] = f[0];
    s_G[i] = ksfd_G(f);
    s_dG[i] = dG;
    s_vr[i] = vm[0];
#pragma unroll
    for (int l = 0; l < NL; ++l) s_vU[l * HN + i] = vm[1 + l];
  }
  __syncthreads();

  const float shift = RESID ? sc[1] : 0.0f;
  for (int i = threadIdx.x; i < TN; i += NT) {
    const int ix = i / (TY * TZ), r = i - ix * (TY * TZ);
    const int iy = r / TZ, iz = r - iy * TZ;
    const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
    if (gx >= nx || gy >= ny || gz >= nz) continue;
    const int c = (ix + SW) * SX + (iy + SW) * SY + (iz + SW);
    const size_t g = ((size_t)gx * ny + gy) * nz + gz;
    const float vr = s_vr[c];
    float row = graddot(&s_vr[c], &s_G[c]) + graddot(&s_rho[c], &s_dG[c]) +
                vr * lap(&s_G[c]) + s_rho[c] * lap(&s_dG[c]);
    out[g] = RESID ? b[g] - shift * v[g] + row : row;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* vU = &s_vU[l * HN + c];
      row = -ksfd_gamma(l) * vU[0] + ksfd_s(l) * vr + ksfd_D(l) * lap(vU);
      const size_t gl = (1 + l) * plane + g;
      out[gl] = RESID ? b[gl] - shift * v[gl] + row : row;
    }
  }
}

template <bool RESID>
__global__ void __launch_bounds__(NT)
jvp_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ b,
           float* __restrict__ out, int nx, int ny, int nz) {
  jvp_body<RESID, false>(sc, u, nullptr, nullptr, v, nullptr, nullptr, b,
                         out, nx, ny, nz);
}

// B9: one rank's slab; u and v with their halo rows, b at its own
// points only
template <bool RESID>
__global__ void __launch_bounds__(NT)
jvp_halo_kernel(const float* __restrict__ sc, const float* __restrict__ u,
                const float* __restrict__ u_lo,
                const float* __restrict__ u_hi, const float* __restrict__ v,
                const float* __restrict__ v_lo,
                const float* __restrict__ v_hi, const float* __restrict__ b,
                float* __restrict__ out, int nx, int ny, int nz) {
  jvp_body<RESID, true>(sc, u, u_lo, u_hi, v, v_lo, v_hi, b, out, nx, ny,
                        nz);
}

// Exact increment rhs(u1) - rhs(u0) of the source-free RHS, with
// d = u1 - u0 and u0 groomed.  sc = [t, rho_mean, G0_mean].
template <bool HALO>
__device__ __forceinline__ void delta_body(
    const float* __restrict__ sc, const float* __restrict__ u0,
    const float* __restrict__ u0_lo, const float* __restrict__ u0_hi,
    const float* __restrict__ d, const float* __restrict__ d_lo,
    const float* __restrict__ d_hi, const float* __restrict__ u1,
    const float* __restrict__ u1_lo, const float* __restrict__ u1_hi,
    float* __restrict__ out, int nx, int ny, int nz) {
  float* s_d0 = ksfd_smem;
  float* s_Gs = s_d0 + HN;
  float* s_r0c = s_Gs + HN;
  float* s_dG = s_r0c + HN;
  float* s_dU = s_dG + HN;  // NL arrays of HN
  const Tile tl = tile_of(nx, ny, nz);
  const int x0 = tl.x0, y0 = tl.y0, z0 = tl.z0;
  const size_t plane = (size_t)nx * ny * nz;
  const size_t member = tl.member * DOF * plane;
  sc += tl.member * SC_DELTA;
  u0 += member;
  d += member;
  u1 += member;
  out += member;
  const float rho_mean = sc[1], G_mean = sc[2];

  for (int i = threadIdx.x; i < HN; i += NT) {
    const int hx = i / SX, r = i - hx * SX, hy = r / SY, hz = r - hy * SY;
    if (!on_star(hx, hy, hz)) continue;
    const Rows w = box_rows<HALO>(hx, hy, hz, x0, y0, z0, nx, ny, nz);
    const float* u0p = part<HALO>(u0, u0_lo, u0_hi, w);
    const float* dp = part<HALO>(d, d_lo, d_hi, w);
    const float* u1p = part<HALO>(u1, u1_lo, u1_hi, w);
    float f[DOF], dd[DOF], s[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      f[k] = u0p[k * w.plane + w.g];
      dd[k] = dp[k * w.plane + w.g];
      s[k] = u1p[k * w.plane + w.g];
    }
    const float G0c = ksfd_G(f) - G_mean;
    const float dG = ksfd_G_delta(f, dd, s);
    s_d0[i] = dd[0];
    s_Gs[i] = G0c + dG;
    s_r0c[i] = f[0] - rho_mean;
    s_dG[i] = dG;
#pragma unroll
    for (int l = 0; l < NL; ++l) s_dU[l * HN + i] = dd[1 + l];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TN; i += NT) {
    const int ix = i / (TY * TZ), r = i - ix * (TY * TZ);
    const int iy = r / TZ, iz = r - iy * TZ;
    const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
    if (gx >= nx || gy >= ny || gz >= nz) continue;
    const int c = (ix + SW) * SX + (iy + SW) * SY + (iz + SW);
    const size_t g = ((size_t)gx * ny + gy) * nz + gz;
    const float drho = s_d0[c];
    out[g] = graddot(&s_d0[c], &s_Gs[c]) + graddot(&s_r0c[c], &s_dG[c]) +
             drho * lap(&s_Gs[c]) + u0[g] * lap(&s_dG[c]);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* dU = &s_dU[l * HN + c];
      out[(1 + l) * plane + g] =
          -ksfd_gamma(l) * dU[0] + ksfd_s(l) * drho + ksfd_D(l) * lap(dU);
    }
  }
}

__global__ void __launch_bounds__(NT)
delta_kernel(const float* __restrict__ sc, const float* __restrict__ u0,
             const float* __restrict__ d, const float* __restrict__ u1,
             float* __restrict__ out, int nx, int ny, int nz) {
  delta_body<false>(sc, u0, nullptr, nullptr, d, nullptr, nullptr, u1,
                    nullptr, nullptr, out, nx, ny, nz);
}

// B9: one rank's slab; u0, d and u1 with their halo rows
__global__ void __launch_bounds__(NT)
delta_halo_kernel(const float* __restrict__ sc,
                  const float* __restrict__ u0,
                  const float* __restrict__ u0_lo,
                  const float* __restrict__ u0_hi,
                  const float* __restrict__ d,
                  const float* __restrict__ d_lo,
                  const float* __restrict__ d_hi,
                  const float* __restrict__ u1,
                  const float* __restrict__ u1_lo,
                  const float* __restrict__ u1_hi, float* __restrict__ out,
                  int nx, int ny, int nz) {
  delta_body<true>(sc, u0, u0_lo, u0_hi, d, d_lo, d_hi, u1, u1_lo, u1_hi,
                   out, nx, ny, nz);
}

#ifdef __CUDACC__
// the tiles of one member, nb times, in one dimension
long long tiles_of(int nx, int ny, int nz) {
  return (long long)((nz + TZ - 1) / TZ) * ((ny + TY - 1) / TY) *
         ((nx + TX - 1) / TX);
}

// Opt the kernel into smem bytes of dynamic shared memory (above the
// 48 KB default), then launch it for nb members.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int nx, int ny, int nz, int nb,
           void* stream, Args... args) {
  const long long blocks = nb * tiles_of(nx, ny, nz);
  if (nb < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(args..., nx,
                                                               ny, nz);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" {

// nb: members (>= 1), with the tiles in one grid dimension
int ksfd_rhs(const float* sc, const float* u, float* out, int nx, int ny,
             int nz, int nb, void* stream) {
  return launch(rhs_kernel, SMEM_BYTES_RHS, nx, ny, nz, nb, stream, sc, u,
                out);
}

int ksfd_jvp(const float* sc, const float* u, const float* v, float* out,
             int nx, int ny, int nz, int nb, void* stream) {
  return launch(jvp_kernel<false>, SMEM_BYTES, nx, ny, nz, nb, stream, sc, u,
                v, (const float*)nullptr, out);
}

int ksfd_resid(const float* sc, const float* u, const float* v,
               const float* b, float* out, int nx, int ny, int nz, int nb,
               void* stream) {
  return launch(jvp_kernel<true>, SMEM_BYTES, nx, ny, nz, nb, stream, sc, u,
                v, b, out);
}

int ksfd_delta(const float* sc, const float* u0, const float* d,
               const float* u1, float* out, int nx, int ny, int nz, int nb,
               void* stream) {
  return launch(delta_kernel, SMEM_BYTES, nx, ny, nz, nb, stream, sc, u0, d,
                u1, out);
}

// B9, the halo-slab entries: one rank's slab of nx rows (>= SW), each
// stencil operand X followed by its lo and hi rows ((DOF, SW, ny, nz)
// each); one member
int ksfd_rhs_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, float* out, int nx, int ny, int nz,
                  void* stream) {
  return launch(rhs_halo_kernel, SMEM_BYTES_RHS, nx, ny, nz, 1, stream, sc,
                u, u_lo, u_hi, out);
}

int ksfd_jvp_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, const float* v, const float* v_lo,
                  const float* v_hi, float* out, int nx, int ny, int nz,
                  void* stream) {
  return launch(jvp_halo_kernel<false>, SMEM_BYTES, nx, ny, nz, 1, stream,
                sc, u, u_lo, u_hi, v, v_lo, v_hi, (const float*)nullptr,
                out);
}

int ksfd_resid_halo(const float* sc, const float* u, const float* u_lo,
                    const float* u_hi, const float* v, const float* v_lo,
                    const float* v_hi, const float* b, float* out, int nx,
                    int ny, int nz, void* stream) {
  return launch(jvp_halo_kernel<true>, SMEM_BYTES, nx, ny, nz, 1, stream, sc,
                u, u_lo, u_hi, v, v_lo, v_hi, b, out);
}

int ksfd_delta_halo(const float* sc, const float* u0, const float* u0_lo,
                    const float* u0_hi, const float* d, const float* d_lo,
                    const float* d_hi, const float* u1, const float* u1_lo,
                    const float* u1_hi, float* out, int nx, int ny, int nz,
                    void* stream) {
  return launch(delta_halo_kernel, SMEM_BYTES, nx, ny, nz, 1, stream, sc, u0,
                u0_lo, u0_hi, d, d_lo, d_hi, u1, u1_lo, u1_hi, out);
}

int ksfd_smem_bytes() { return (int)SMEM_BYTES; }
int ksfd_smem_bytes_rhs() { return (int)SMEM_BYTES_RHS; }

}  // extern "C"
#endif
