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
// jvp 604 MB (180 us), delta 805 MB (240 us), rhs 403 MB (120 us).  The
// operations (273 f32 operations a point for resid, 264 for jvp, with a
// transcendental counted as one) take 68 us at 67 TFLOP/s, but a
// transcendental is tens of instructions: the pointwise evaluations
// are what a design must not repeat.
//
// jvp and resid: a march along x (a 2.5D design).  A block owns
// MY x MZ = 16 x 32 (y, z) columns of one member (z contiguous: a warp
// reads 128 B rows) and walks a chunk of up to LX = 32 x planes (at
// 256^3 one member is 8 x 16 x 8 = 1,024 blocks, 3.9 waves of the 264
// resident on 132 SMs).  It keeps a rolling window of 2*SW+1 planes of
// the pointwise arrays (rho, G, dG.v, v_rho, v_U[NL]) in shared memory,
// one slot per plane plus a landing slot.  A plane's interior is
// evaluated once, in place, when it lands as plane x + SW; when plane x
// becomes the centre, only its star halo in y and z (2*SW rows and
// columns, no edges or corners) is evaluated, into a centre plane with
// that halo beside a copy of its interior.  Each chunk starts with 2*SW
// warm-up planes.  Evaluations per output: (LX + 2*SW)/LX + 2*SW*(MY +
// MZ)/(MY*MZ) = 1.125 + 0.375 = 1.5 (2.6 in the box design).  The
// wrapped (y, z) offsets of the interior and the halo are computed once
// per block, outside the march; a plane's row wraps once (or, in the
// halo-slab build, picks lo, the slab or hi) when it is fetched: no %
// in the march loop.  Loads overlap arithmetic: the raw u and v of
// plane x + 1 + SW are copied into the free slot with cp.async from the
// start of step x (while plane x + SW and the halo are evaluated and
// the rows of x computed), the next centre's halo from the start of
// the rows, and resid's b and raw v at the centre into shared memory
// while the step evaluates.  Shared memory 99,200 B a block (resid
// 111,488 B) and 512 threads: 2 blocks (32 warps) per SM, 64 registers
// a thread.  The x stencils gather a point's 2*SW+1 window values in x
// order into a small array and call ksfd_d1x/ksfd_d2x on it with stride
// 1, so every sum keeps the box design's order and no value depends on
// where a chunk or slab starts.  On an H100 80GB HBM3 at 700 W the march
// takes 0.58 ms (jvp) and 0.67 ms (resid) at 256^3 x 3, 0.31 and 0.36 of
// the byte bound, against 1.20 and 1.28 ms for the box design; without
// any global load it still takes 0.54-0.57 ms: the evaluations and the
// rows' shared-memory arithmetic, not the bytes, set its time
// (tools/probe_stencil3d.py, PERF.md).
//
// rhs and delta keep the box design for now: one block of NT threads
// per TX x TY x TZ tile, z fastest.  The block reads its inputs over a
// box with an SW-wide halo straight from global memory by periodic
// index arithmetic, evaluates G / G_delta once per box point into
// dynamic shared memory, then applies the star stencils from there.
// The star stencils never read a box point with two or more
// coordinates in the halo (edges and corners), so those are skipped:
// at 4 x 8 x 32 and SW=2, 2,688 of the box's 3,456 points are
// evaluated, 2.6 per output point.  Shared memory is (4 + NL) arrays of
// the 8 x 12 x 36 box for delta, 82,944 B for three fields, and (2 +
// NL) arrays for rhs, 55,296 B.  Each entry opts its kernel into its
// own amount of dynamic shared memory before it launches.  On an H100
// 80GB HBM3 at 700 W the box design takes 0.7-1.4 ms per launch at
// 256^3 x 3, 5-6x the bound (PERF.md, chip_smoke.py phase 5).
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
// blockIdx.x with the member slowest, then the x tile (the x chunk of
// the march), the y tile and the z tile fastest, so the blocks of a
// batched launch run in the order of nb single launches back to back.
// That order matters: a box's 4-wide x tile reads 2 * SW halo planes
// besides its 4 (a chunk 2 * SW besides its 32), which can come from
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
// row or a march plane r in [-SW, nx + SW) reads lo, the slab or hi in
// place of wrap(r, nx), and y and z still wrap inside the slab.  No padded copy
// of an operand is made.  One member; the 1D member-slowest grid decode
// stays for the unsharded build (here it decodes one member's tiles).
// The arithmetic per point is the unsharded kernel's, so the stitched
// slabs equal one unsharded launch bit for bit under one scalar pack.
//
// Without __CUDACC__ (a host C++ compiler with the CUDA qualifiers
// defined away, KSFD_NT=1 and one thread walking each block) the kernel
// bodies compile as plain C++ (every phase of the march is a loop over
// the block's points between barriers, cp.async a plain copy);
// tests/test_torch_3d.py runs them so on the CPU, launching each
// kernel's grid as ksfd_blocks exports it, into a ksfd_smem of
// SMEM_FLOATS_MAX words.  The launching C entries exist only in the
// nvcc build; the geometry (ksfd_blocks, ksfd_threads, ksfd_smem_floats)
// in both.

#include <math.h>
#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ksfd_pointwise.cuh"

static_assert(KSFD_DIM == 3, "stencil3d.cu needs the 3D pointwise header");

// threads per block of the box kernels (rhs, delta) and of the march
// (jvp, resid); a host build sets KSFD_NT=1 for both
#ifndef KSFD_NT
#define KSFD_NT 256
#define KSFD_NT_MARCH 512
#define KSFD_MARCH_MIN_BLOCKS 2
#else
#define KSFD_NT_MARCH KSFD_NT
#endif
#ifdef __CUDACC__
#define KSFD_MARCH_BOUNDS \
  __launch_bounds__(KSFD_NT_MARCH, KSFD_MARCH_MIN_BLOCKS)
#else
#define KSFD_MARCH_BOUNDS
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
constexpr size_t BOX_FLOATS = (size_t)NARR * HN;  // delta
constexpr size_t BOX_FLOATS_RHS = (size_t)NARR_RHS * HN;
static_assert(4 * BOX_FLOATS <= 227 * 1024, "tile too large for shared memory");

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

// -- the march of jvp and resid ------------------------------------------
// A block owns MY x MZ (y, z) columns of one member and marches along x
// through a chunk of up to LX planes (module note).  Window arrays per
// point: the groomed rho, G, dG.v, the masked tangent v_rho and v_U[NL].
constexpr int MY = 16;             // column tile along y
constexpr int MZ = 32;             // along z (contiguous)
constexpr int LX = 32;             // planes per chunk
constexpr int NTM = KSFD_NT_MARCH; // threads per block
constexpr int MW = 2 * SW + 1;     // window planes
constexpr int NSLOT = MW + 1;      // the window and the landing slot
constexpr int MTN = MY * MZ;       // a plane's interior points
constexpr int CY = MY + 2 * SW;
constexpr int CZ = MZ + 2 * SW;    // centre plane stride along y
constexpr int CN = CY * CZ;        // the centre plane with its star halo
constexpr int NRING = 2 * SW * (MZ + MY);  // its star halo (no corners)
constexpr int NRAW = 2 * DOF;      // raw u and v of a point
constexpr int NSARR = NARR > NRAW ? NARR : NRAW;  // arrays per slot
// dynamic shared memory, in 4-byte words: the (y, z) offsets of the
// interior and the ring and the ring's positions in the centre plane
// (ints), the slots, the centre plane, the next ring's raw u and v;
// resid adds b and the raw v of the centre (NRAW arrays of MTN)
constexpr size_t MARCH_FLOATS = (size_t)MTN + 2 * NRING +
                                (size_t)NSLOT * NSARR * MTN +
                                (size_t)NARR * CN + (size_t)NRAW * NRING;
static_assert((MZ & (MZ - 1)) == 0 && MZ >= 32, "MZ: a power of two >= 32");
static_assert(4 * (MARCH_FLOATS + NRAW * MTN) <= 227 * 1024,
              "window too large");

// The block's (y, z) column tile, x chunk [xa, xb) and member, decoded
// from the 1D grid: member slowest, then the x chunk, y and z tiles.
struct Column {
  int xa, xb, y0, z0;
  size_t member;
};

__device__ __forceinline__ Column column_of(int nx, int ny, int nz) {
  const unsigned ntz = (nz + MZ - 1) / MZ, nty = (ny + MY - 1) / MY;
  const unsigned per_member = ntz * nty * ((nx + LX - 1) / LX);
  const unsigned member = blockIdx.x / per_member;
  const unsigned r = blockIdx.x - member * per_member;
  const unsigned xy = r / ntz, yt = xy % nty;
  const int xa = (int)(xy / nty) * LX;
  return Column{xa, xa + LX < nx ? xa + LX : nx, (int)yt * MY,
                (int)(r - xy * ntz) * MZ, (size_t)member};
}

// Where plane p of u and v lies: its rows and the stride of a field.
// Unsharded, p (in [-nx, 2 nx)) wraps once; in the halo-slab build rows
// below 0 are in lo and rows at or past nx in hi (SW rows a field),
// a ragged chunk's overreach clamped to hi's last row.
struct Plane {
  const float *u, *v;
  size_t fs;
};

template <bool HALO>
__device__ __forceinline__ Plane plane_of(int p, const float* u,
                                          const float* u_lo,
                                          const float* u_hi, const float* v,
                                          const float* v_lo,
                                          const float* v_hi, int nx,
                                          size_t pl) {
  if (!HALO) {
    const size_t w = p < 0 ? p + nx : (p >= nx ? p - nx : p);
    return Plane{u + w * pl, v + w * pl, (size_t)nx * pl};
  }
  if (p < 0)
    return Plane{u_lo + (size_t)(p + SW) * pl, v_lo + (size_t)(p + SW) * pl,
                 (size_t)SW * pl};
  if (p >= nx) {
    const size_t r = p - nx < SW ? p - nx : SW - 1;
    return Plane{u_hi + r * pl, v_hi + r * pl, (size_t)SW * pl};
  }
  return Plane{u + (size_t)p * pl, v + (size_t)p * pl, (size_t)nx * pl};
}

// One 4-byte copy from global into shared memory, asynchronous on the
// card (cp.async: it lands while the block computes); the end of a
// group of copies; and the wait until at most N of this thread's latest
// groups are in flight.
__device__ __forceinline__ void copy_f32(float* dst, const float* src) {
#ifdef __CUDACC__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copies_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void copies_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Start the copies of the raw u and v of n points of one plane into dst
// (NRAW arrays of stride ds): point j's (y, z) offset is off[j].
__device__ __forceinline__ void fetch(float* dst, int ds, const int* offs,
                                      int n, const Plane& pl) {
  const float* ub = pl.u;
  const float* vb = pl.v;
  const size_t fs = pl.fs;
  for (int j = threadIdx.x; j < n; j += NTM) {
    const int off = offs[j];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      copy_f32(&dst[k * ds + j], &ub[k * fs + off]);
      copy_f32(&dst[(DOF + k) * ds + j], &vb[k * fs + off]);
    }
  }
}

// One point's window values from its raw u and v (NRAW values at
// stride rs) into dst (NARR values at stride ds); raw and dst may be
// the same point of one slot: every read comes before the writes.
__device__ __forceinline__ void jvp_point(const float* raw, int rs,
                                          float* dst, int ds) {
  float f[DOF], vm[DOF], dg[DOF];
#pragma unroll
  for (int k = 0; k < DOF; ++k) {
    const float r = raw[k * rs];
    const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
    f[k] = r >= lo ? r : lo;
    vm[k] = r > lo ? raw[(DOF + k) * rs] : 0.0f;
  }
  ksfd_dG(f, dg);
  float dG = dg[0] * vm[0];
#pragma unroll
  for (int k = 1; k < DOF; ++k) dG = dG + dg[k] * vm[k];
  dst[0] = f[0];
  dst[1 * ds] = ksfd_G(f);
  dst[2 * ds] = dG;
  dst[3 * ds] = vm[0];
#pragma unroll
  for (int l = 0; l < NL; ++l) dst[(4 + l) * ds] = vm[1 + l];
}

// The star stencils of the march: x from a point's 2*SW+1 window values
// gathered in x order (stride 1), y and z from the centre plane.
__device__ __forceinline__ float lap(const float* xs, const float* p) {
  return ksfd_d2x(xs + SW, 1) + ksfd_d2y(p, CZ) + ksfd_d2z(p, 1);
}

__device__ __forceinline__ float graddot(const float* xa, const float* xb,
                                         const float* a, const float* b) {
  return ksfd_d1x(xa + SW, 1) * ksfd_d1x(xb + SW, 1) +
         ksfd_d1y(a, CZ) * ksfd_d1y(b, CZ) + ksfd_d1z(a, 1) * ksfd_d1z(b, 1);
}

// The rows of centre plane x: plane x - SW + k's window arrays start at
// word xs[k] of slots; with RESID, bv holds b and the raw v of plane x
// (NRAW arrays of MTN).
template <bool RESID>
__device__ __forceinline__ void jvp_rows(
    const float* slots, const int* xs, const float* cen, const float* bv,
    const int* offs, const Column& cl, int x, size_t pl, size_t plane,
    float shift, float* __restrict__ out, int ny, int nz) {
  const float* c_rho = cen;
  const float* c_G = cen + CN;
  const float* c_dG = cen + 2 * CN;
  const float* c_vr = cen + 3 * CN;
  const float* c_vU = cen + 4 * CN;  // NL arrays of CN
  for (int j = threadIdx.x; j < MTN; j += NTM) {
    const int iy = j / MZ, iz = j - iy * MZ;
    if (cl.y0 + iy >= ny || cl.z0 + iz >= nz) continue;
    const int c = (iy + SW) * CZ + iz + SW;
    float xrho[MW], xG[MW], xdG[MW], xvr[MW];
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      const float* w = slots + xs[k] + j;
      xrho[k] = w[0];
      xG[k] = w[MTN];
      xdG[k] = w[2 * MTN];
      xvr[k] = w[3 * MTN];
    }
    const float vr = c_vr[c];
    float row = graddot(xvr, xG, &c_vr[c], &c_G[c]) +
                graddot(xrho, xdG, &c_rho[c], &c_dG[c]) +
                vr * lap(xG, &c_G[c]) + c_rho[c] * lap(xdG, &c_dG[c]);
    const size_t g = (size_t)x * pl + offs[j];
    out[g] = RESID ? bv[j] - shift * bv[DOF * MTN + j] + row : row;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xvU[MW];
#pragma unroll
      for (int k = 0; k < MW; ++k) xvU[k] = slots[xs[k] + (4 + l) * MTN + j];
      row = -ksfd_gamma(l) * xvU[SW] + ksfd_s(l) * vr +
            ksfd_D(l) * lap(xvU, &c_vU[l * CN + c]);
      const int jl = (1 + l) * MTN + j;
      out[(1 + l) * plane + g] =
          RESID ? bv[jl] - shift * bv[DOF * MTN + jl] + row : row;
    }
  }
}

// The J-action rows (and, with RESID, the fused Richardson residual
// b - shift*v + J(u)v).  sc = [t, shift] (t is unused: the generated
// G carries no time dependence).  Step x of the march: plane x + SW has
// landed in the landing slot and the star halo (ring) of centre x in
// s_ring.  Start the copies of plane x + 1 + SW into the slot that
// plane x - 1 - SW left (and, with RESID, of b and v at plane x);
// evaluate the landed plane in place and the ring into the centre plane,
// beside a copy of the centre's interior; start the copies of the ring
// of x + 1; compute the rows of x.  The first 2*SW steps of a chunk only
// fill the window.
template <bool RESID, bool HALO>
__device__ __forceinline__ void jvp_body(
    const float* __restrict__ sc, const float* __restrict__ u,
    const float* __restrict__ u_lo, const float* __restrict__ u_hi,
    const float* __restrict__ v, const float* __restrict__ v_lo,
    const float* __restrict__ v_hi, const float* __restrict__ b,
    float* __restrict__ out, int nx, int ny, int nz) {
  int* s_off = reinterpret_cast<int*>(ksfd_smem);  // MTN + NRING
  int* s_pos = s_off + MTN + NRING;                 // NRING
  float* s_slot = ksfd_smem + MTN + 2 * NRING;      // NSLOT x NSARR x MTN
  float* s_cen = s_slot + NSLOT * NSARR * MTN;      // NARR x CN
  float* s_ring = s_cen + NARR * CN;                // NRAW x NRING
  float* s_bv = s_ring + NRAW * NRING;              // RESID: NRAW x MTN
  const Column cl = column_of(nx, ny, nz);
  const size_t pl = (size_t)ny * nz, plane = (size_t)nx * pl;
  // a halo-slab launch has one member: its pointers stay the kernel's
  // parameters (fewer live registers)
  const size_t mb = HALO ? 0 : cl.member;
  const size_t member = mb * DOF * plane;
  sc += mb * (RESID ? SC_RESID : SC_JVP);
  u += member;
  v += member;
  out += member;
  if (RESID) b += member;
  const float shift = RESID ? sc[1] : 0.0f;

  // the wrapped (y, z) offsets of the interior, then of the ring (y halo
  // rows, then z halo columns), and the ring's centre-plane positions
  for (int j = threadIdx.x; j < MTN + NRING; j += NTM) {
    int hy, hz;
    if (j < MTN) {
      hy = SW + j / MZ;
      hz = SW + j % MZ;
    } else if (j < MTN + 2 * SW * MZ) {
      const int r = (j - MTN) / MZ;
      hy = r < SW ? r : r + MY;
      hz = SW + (j - MTN) % MZ;
    } else {
      const int r = j - MTN - 2 * SW * MZ, col = r % (2 * SW);
      hy = SW + r / (2 * SW);
      hz = col < SW ? col : col + MZ;
    }
    s_off[j] = wrap(cl.y0 + hy - SW, ny) * nz + wrap(cl.z0 + hz - SW, nz);
    if (j >= MTN) s_pos[j - MTN] = hy * CZ + hz;
  }
  __syncthreads();

  const int xa = cl.xa, xb = cl.xb;
  int land = 0;  // the slot of the entering plane x + SW
  fetch(s_slot, MTN, s_off, MTN,
        plane_of<HALO>(xa - SW, u, u_lo, u_hi, v, v_lo, v_hi, nx, pl));
  copies_commit();
  for (int x = xa - 2 * SW; x < xb; ++x) {
    copies_wait<0>();
    __syncthreads();
    const int next = land + 1 == NSLOT ? 0 : land + 1;
    if (RESID && x >= xa) {
      fetch(s_bv, MTN, s_off, MTN, Plane{b + x * pl, v + x * pl, plane});
      copies_commit();
    }
    if (x + 1 < xb) {
      fetch(s_slot + next * NSARR * MTN, MTN, s_off, MTN,
            plane_of<HALO>(x + 1 + SW, u, u_lo, u_hi, v, v_lo, v_hi, nx,
                           pl));
      copies_commit();
    }
    float* in = s_slot + land * NSARR * MTN;
    for (int j = threadIdx.x; j < MTN; j += NTM)
      jvp_point(&in[j], MTN, &in[j], MTN);
    int xs[MW];  // the slots of planes x - SW .. x + SW, in words
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      const int s = land - 2 * SW + k;
      xs[k] = (s < 0 ? s + NSLOT : s) * NSARR * MTN;
    }
    if (x >= xa) {
      for (int j = threadIdx.x; j < NRING; j += NTM)
        jvp_point(&s_ring[j], NRING, &s_cen[s_pos[j]], CN);
      for (int j = threadIdx.x; j < MTN; j += NTM) {
        const int iy = j / MZ, c = (iy + SW) * CZ + j - iy * MZ + SW;
#pragma unroll
        for (int a = 0; a < NARR; ++a)
          s_cen[a * CN + c] = s_slot[xs[SW] + a * MTN + j];
      }
    }
    // with RESID, b and v of plane x have landed (the plane copies of
    // x + 1 + SW may still be in flight)
    if (RESID && x >= xa) {
      if (x + 1 < xb)
        copies_wait<1>();
      else
        copies_wait<0>();
    }
    __syncthreads();
    if (x + 1 < xb && x + 1 >= xa) {
      fetch(s_ring, NRING, s_off + MTN, NRING,
            plane_of<HALO>(x + 1, u, u_lo, u_hi, v, v_lo, v_hi, nx, pl));
      copies_commit();
    }
    if (x >= xa)
      jvp_rows<RESID>(s_slot, xs, s_cen, s_bv, s_off, cl, x, pl, plane, shift,
                      out, ny, nz);
    land = next;
  }
}

template <bool RESID>
__global__ void KSFD_MARCH_BOUNDS
jvp_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ b,
           float* __restrict__ out, int nx, int ny, int nz) {
  jvp_body<RESID, false>(sc, u, nullptr, nullptr, v, nullptr, nullptr, b,
                         out, nx, ny, nz);
}

// B9: one rank's slab; u and v with their halo rows, b at its own
// points only
template <bool RESID>
__global__ void KSFD_MARCH_BOUNDS
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

// Launch geometry of each kernel (KSFD_JVP .. KSFD_RHS; a halo-slab
// build has its kernel's): blocks of the 1D grid for nb members, threads
// and 4-byte words of dynamic shared memory per block.
enum { KSFD_JVP = 0, KSFD_RESID = 1, KSFD_DELTA = 2, KSFD_RHS = 3 };

constexpr bool marches(int which) {
  return which == KSFD_JVP || which == KSFD_RESID;
}

long long grid_blocks(int which, int nx, int ny, int nz, int nb) {
  if (marches(which))
    return (long long)nb * ((nz + MZ - 1) / MZ) * ((ny + MY - 1) / MY) *
           ((nx + LX - 1) / LX);
  return (long long)nb * ((nz + TZ - 1) / TZ) * ((ny + TY - 1) / TY) *
         ((nx + TX - 1) / TX);
}

constexpr size_t smem_floats(int which) {
  return which == KSFD_JVP     ? MARCH_FLOATS
         : which == KSFD_RESID ? MARCH_FLOATS + (size_t)NRAW * MTN
         : which == KSFD_RHS   ? BOX_FLOATS_RHS
                               : BOX_FLOATS;
}

constexpr int block_threads(int which) { return marches(which) ? NTM : NT; }

// the most any kernel takes (a host harness sizes its ksfd_smem by it)
constexpr size_t SMEM_FLOATS_MAX =
    smem_floats(KSFD_RESID) > BOX_FLOATS ? smem_floats(KSFD_RESID)
                                         : BOX_FLOATS;

#ifdef __CUDACC__
// Opt the kernel into its dynamic shared memory (above the 48 KB
// default), then launch it for nb members.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int which, int nx, int ny, int nz, int nb,
           void* stream, Args... args) {
  const long long blocks = grid_blocks(which, nx, ny, nz, nb);
  if (nb < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)(4 * smem_floats(which));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, block_threads(which), smem,
           (cudaStream_t)stream>>>(args..., nx, ny, nz);
  return (int)cudaGetLastError();
}

// resident blocks per SM of a kernel at its threads and shared memory
template <typename Kernel>
int occupancy(Kernel kernel, int which) {
  const int smem = (int)(4 * smem_floats(which));
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, block_threads(which), smem) != cudaSuccess)
    return -1;
  return n;
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" {

// nb: members (>= 1), with the tiles in one grid dimension
int ksfd_rhs(const float* sc, const float* u, float* out, int nx, int ny,
             int nz, int nb, void* stream) {
  return launch(rhs_kernel, KSFD_RHS, nx, ny, nz, nb, stream, sc, u,
                out);
}

int ksfd_jvp(const float* sc, const float* u, const float* v, float* out,
             int nx, int ny, int nz, int nb, void* stream) {
  return launch(jvp_kernel<false>, KSFD_JVP, nx, ny, nz, nb, stream, sc, u,
                v, (const float*)nullptr, out);
}

int ksfd_resid(const float* sc, const float* u, const float* v,
               const float* b, float* out, int nx, int ny, int nz, int nb,
               void* stream) {
  return launch(jvp_kernel<true>, KSFD_RESID, nx, ny, nz, nb, stream, sc, u,
                v, b, out);
}

int ksfd_delta(const float* sc, const float* u0, const float* d,
               const float* u1, float* out, int nx, int ny, int nz, int nb,
               void* stream) {
  return launch(delta_kernel, KSFD_DELTA, nx, ny, nz, nb, stream, sc, u0, d,
                u1, out);
}

// B9, the halo-slab entries: one rank's slab of nx rows (>= SW), each
// stencil operand X followed by its lo and hi rows ((DOF, SW, ny, nz)
// each); one member
int ksfd_rhs_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, float* out, int nx, int ny, int nz,
                  void* stream) {
  return launch(rhs_halo_kernel, KSFD_RHS, nx, ny, nz, 1, stream, sc,
                u, u_lo, u_hi, out);
}

int ksfd_jvp_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, const float* v, const float* v_lo,
                  const float* v_hi, float* out, int nx, int ny, int nz,
                  void* stream) {
  return launch(jvp_halo_kernel<false>, KSFD_JVP, nx, ny, nz, 1, stream,
                sc, u, u_lo, u_hi, v, v_lo, v_hi, (const float*)nullptr,
                out);
}

int ksfd_resid_halo(const float* sc, const float* u, const float* u_lo,
                    const float* u_hi, const float* v, const float* v_lo,
                    const float* v_hi, const float* b, float* out, int nx,
                    int ny, int nz, void* stream) {
  return launch(jvp_halo_kernel<true>, KSFD_RESID, nx, ny, nz, 1, stream, sc,
                u, u_lo, u_hi, v, v_lo, v_hi, b, out);
}

int ksfd_delta_halo(const float* sc, const float* u0, const float* u0_lo,
                    const float* u0_hi, const float* d, const float* d_lo,
                    const float* d_hi, const float* u1, const float* u1_lo,
                    const float* u1_hi, float* out, int nx, int ny, int nz,
                    void* stream) {
  return launch(delta_halo_kernel, KSFD_DELTA, nx, ny, nz, 1, stream, sc, u0,
                u0_lo, u0_hi, d, d_lo, d_hi, u1, u1_lo, u1_hi, out);
}

// resident blocks per SM of kernel `which`, unsharded (halo 0) or its
// halo-slab build (halo 1); -1 if the runtime cannot tell
int ksfd_occupancy(int which, int halo) {
  switch (which + 4 * (halo != 0)) {
    case KSFD_JVP: return occupancy(jvp_kernel<false>, which);
    case KSFD_RESID: return occupancy(jvp_kernel<true>, which);
    case KSFD_DELTA: return occupancy(delta_kernel, which);
    case KSFD_RHS: return occupancy(rhs_kernel, which);
    case 4 + KSFD_JVP: return occupancy(jvp_halo_kernel<false>, which);
    case 4 + KSFD_RESID: return occupancy(jvp_halo_kernel<true>, which);
    case 4 + KSFD_DELTA: return occupancy(delta_halo_kernel, which);
    case 4 + KSFD_RHS: return occupancy(rhs_halo_kernel, which);
  }
  return -1;
}

}  // extern "C"
#endif

// The launch geometry, in the nvcc build and in a host build alike:
// blocks of kernel `which` (KSFD_JVP 0, KSFD_RESID 1, KSFD_DELTA 2,
// KSFD_RHS 3) for nb members, its threads and its 4-byte words of
// dynamic shared memory per block.
extern "C" {
long long ksfd_blocks(int which, int nx, int ny, int nz, int nb) {
  return grid_blocks(which, nx, ny, nz, nb);
}
int ksfd_threads(int which) { return block_threads(which); }
int ksfd_smem_floats(int which) { return (int)smem_floats(which); }
}  // extern "C"
