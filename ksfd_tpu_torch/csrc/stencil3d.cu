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
// One design for the four kernels, a march along x (a 2.5D design),
// written once (march_body) over a policy per kernel (Jvp<RESID>,
// Delta, Rhs: its geometry, operands, scalar pack, one point's
// evaluation and one output point's rows).  A block owns MY x MZ (y, z)
// columns of one member (MZ = 32, z contiguous: a warp reads 128 B rows)
// and walks a chunk of up to LX = 32 x planes.  It keeps a rolling
// window of 2*SW+1 planes of the kernel's pointwise arrays in shared
// memory, one slot per plane plus a landing slot: jvp and resid rho, G,
// dG.v, v_rho, v_U[NL]; delta d_rho, Gs = (G(u0) - G0_mean) + dG, rho0c,
// dG = G_delta(u0, d, u1), d_U[NL]; rhs rho_c, Gc, Uc[NL].  A plane's
// interior is evaluated once, in place, when it lands as plane x + SW;
// when plane x becomes the centre, only its star halo in y and z (2*SW
// rows and columns, no edges or corners) is evaluated, into a centre
// plane with that halo beside a copy of its interior.  Each chunk starts
// with 2*SW warm-up planes.  Evaluations per output: (LX + 2*SW)/LX +
// 2*SW*(MY + MZ)/(MY*MZ) = 1.125 + 0.375 = 1.5 at MY = 16, 1.75 at
// MY = 8.  The wrapped (y, z) offsets of the interior and the halo are
// computed once per block, outside the march; a plane's row wraps once
// (or, in the halo-slab build, picks lo, the slab or hi) when it is
// fetched: no % in the march loop.  Loads overlap arithmetic: the raw
// operands of plane x + 1 + SW are copied with cp.async from the start
// of step x (while plane x + SW and the halo are evaluated and the rows
// of x computed), the next centre's halo from the start of the rows,
// and resid's b and raw v at the centre into shared memory while the
// step evaluates.  A point's raw values land where they are evaluated:
// in its slot's arrays and, those that do not fit there (delta: u0, d
// and u1 are 9 values for 6 arrays), in a double-buffered landing area;
// delta's d lands straight in its final arrays.  The x stencils gather
// a point's 2*SW+1 window values in x order into a small array and call
// ksfd_d1x/ksfd_d2x on it with stride 1, so every sum keeps the plain
// version's order and no value depends on where a chunk or slab starts.
// The uncentred values that the rows multiply by (delta's u0 rho, rhs's
// groomed rho) are read at the output point from global memory, never
// rebuilt from a centred value.
//
// Geometry, chosen by timing on the H100 (tools/probe_stencil3d.py):
// jvp, resid and rhs own 16 x 32 columns with 512 threads, 2 blocks (32
// warps) per SM at up to 64 registers, in 99,200 B (jvp), 111,488 B
// (resid) and 66,560 B (rhs) of shared memory; delta, whose evaluation
// (G and G_delta) is the heaviest, 8 x 32 columns with 256 threads, 3
// blocks (24 warps) per SM at 76 registers, in 61,440 B.  A step of
// 8 x 32 columns evaluates 256 interior and 160 halo points on 256
// threads (of 16 x 32, 512 and 192 on 512), so fewer threads idle while
// the others evaluate a second point: at 256^3 x 3 delta took 0.75 ms
// against 0.78-0.79 ms at 16 x 32 and 2 blocks per SM, 0.86 ms at one.
// On an H100 80GB HBM3 at 700 W the march takes 0.58 ms (jvp), 0.68 ms
// (resid), 0.77 ms (delta) and 0.38 ms (rhs) at 256^3 x 3, 0.31, 0.35,
// 0.31 and 0.32 of the byte bound, against 1.20, 1.28, 1.35 and 0.71 ms
// for the earlier box design, whose block read a box around its tile
// straight from global memory by three runtime % per operand and box
// point (2.6 evaluations per output).  Without any global load the
// march takes nearly as long: the evaluations and the rows'
// shared-memory arithmetic, not the bytes, set its time (PERF.md).
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
// of nb x the blocks.  The grid is one-dimensional (gridDim.x's 2^31 - 1
// leaves the member count uncapped) and a block decodes its columns from
// blockIdx.x with the member slowest, then the x chunk, the y tile and
// the z tile fastest, so the blocks of a batched launch run in the order
// of nb single launches back to back.  That order matters: a chunk reads
// 2 * SW planes besides its 32, which can come from L2 only while the
// x-neighbour chunks run close by; a member-major fold into the z tiles
// interleaved the members and took 1.05-1.08x the time of nb single
// launches on the H100 (PERF.md, section 6).  Operands are contiguous
// (nb, DOF, nx, ny, nz) and the scalar pack is (nb, k), one row per
// member, as the batched Pallas build's per-member pack rows.  A block
// adds member * DOF * nx * ny * nz (64-bit) to its pointers and member *
// k to the pack, and nothing else changes: a member's arithmetic is
// that of a single launch, so a batched launch equals nb single
// launches bit for bit, and nb = 1 is the single-member kernel.
//
// Halo-slab builds (B9 in 3D, pallas_stencil3d.py pad_x :474-486,
// shardwrap :488-500, padded_src :263): ksfd_<name>_halo runs the same
// kernel on one rank's local x-slab (nx = the slab's rows), as
// csrc/stencil2d.cu's halo entries do.  Each stencil operand comes as
// the slab plus its lo and hi halo buffers, each a contiguous
// (DOF, SW, ny, nz) block of the ring neighbours' boundary rows; a march
// plane r in [-SW, nx + SW) reads lo, the slab or hi in place of
// wrap(r, nx) (a ragged chunk's overreach clamped to hi's last row),
// and y and z still wrap inside the slab.  No padded copy of an operand
// is made.  One member: a halo-slab block adds no member offset, so its
// pointers stay the kernel's parameters (fewer live registers).  The
// arithmetic per point is the unsharded kernel's, so the stitched slabs
// equal one unsharded launch bit for bit under one scalar pack.
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

// threads per block of a kernel; a host build sets KSFD_NT=1 for all
#ifndef KSFD_NT
#define KSFD_THREADS(n) (n)
#else
#define KSFD_THREADS(n) KSFD_NT
#endif
// the threads and resident blocks per SM that ptxas sizes a kernel's
// registers for
#ifdef __CUDACC__
#define KSFD_BOUNDS(K) __launch_bounds__(K::NT, K::MINB)
#define KSFD_HOST_DEVICE __host__ __device__
#else
#define KSFD_BOUNDS(K)
#define KSFD_HOST_DEVICE
#endif

extern __shared__ float ksfd_smem[];

namespace {

constexpr int SW = KSFD_SW;
constexpr int DOF = KSFD_DOF;
constexpr int NL = DOF - 1;           // ligand fields
constexpr int NLA = NL > 0 ? NL : 1;  // arrays kept for them (never 0)
constexpr int MZ = 32;                // column tile along z (contiguous)
constexpr int LX = 32;                // planes per chunk
constexpr int MW = 2 * SW + 1;        // window planes
constexpr int NSLOT = MW + 1;         // the window and the landing slot
constexpr int CZ = MZ + 2 * SW;       // centre plane stride along y
static_assert((MZ & (MZ - 1)) == 0 && MZ >= 32, "MZ: a power of two >= 32");
static_assert(NSLOT % 2 == 0, "the landing area alternates with the slots");
// scalar pack lengths, the row stride of a batched pack
constexpr int SC_RHS = 2 * DOF + 1;  // t, means, G(means), reactions
constexpr int SC_JVP = 1;            // t
constexpr int SC_RESID = 2;          // t, shift
constexpr int SC_DELTA = 3;          // t, rho_mean, G0_mean

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
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

// A point's raw values as they landed: value a (a policy's lands(q)
// order) at lo[a * s] below NARR, at hi[(a - NARR) * s] from there on.
template <int NARR>
struct Raw {
  const float* lo;
  const float* hi;
  int s;
  __device__ __forceinline__ float operator[](int a) const {
    return a < NARR ? lo[a * s] : hi[(a - NARR) * s];
  }
};

// One output point of centre plane x: array a of plane x - SW + k of its
// window at slots[xs[k] + a * mtn + j], of the centre plane at cen[a *
// cn + c]; resid's staged b and raw v, raw value q at bv[q * mtn].
struct At {
  const float* slots;
  const int* xs;
  int j, mtn;
  const float* cen;
  int c, cn;
  const float* bv;
  __device__ __forceinline__ void x(int a, float (&w)[MW]) const {
#pragma unroll
    for (int k = 0; k < MW; ++k) w[k] = slots[xs[k] + a * mtn + j];
  }
  __device__ __forceinline__ const float* centre(int a) const {
    return cen + a * cn + c;
  }
};

// -- the policies ---------------------------------------------------------
// Each names its column tile MY, threads NT and the resident blocks per
// SM its registers are sized for (MINB); its NOP stencil operands of DOF
// fields (raw value q = operand * DOF + field lands in array lands(q)),
// NARR window arrays a point, NSC scalars a member; whether it stages
// b and v at the centre (STAGE); point(): one point's window values
// from its raw values into dst (array stride ds; raw and dst may be
// the same point of one slot: every read comes before the writes);
// row(): the DOF rows of output point g (u: operand 0).

// jvp and resid: the J-action rows (with RESID, the fused Richardson
// residual b - shift*v + J(u)v) from u and v; sc = [t] or [t, shift] (t
// feeds the generated G and the ligand coefficients).
template <bool RESID>
struct Jvp {
  static constexpr int MY = 16, NT = KSFD_THREADS(512), MINB = 2;
  static constexpr int NOP = 2, NARR = 4 + NLA;
  static constexpr int NSC = RESID ? SC_RESID : SC_JVP;
  static constexpr bool STAGE = RESID;
  static constexpr KSFD_HOST_DEVICE int lands(int q) { return q; }

  static __device__ __forceinline__ void point(const Raw<NARR>& raw,
                                               float* dst, int ds,
                                               const float* s) {
    float f[DOF], vm[DOF], dg[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      const float r = raw[k];
      const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
      f[k] = r >= lo ? r : lo;
      vm[k] = r > lo ? raw[DOF + k] : 0.0f;
    }
    ksfd_dG(f, s[0], dg);
    float dG = dg[0] * vm[0];
#pragma unroll
    for (int k = 1; k < DOF; ++k) dG = dG + dg[k] * vm[k];
    dst[0] = f[0];
    dst[1 * ds] = ksfd_G(f, s[0]);
    dst[2 * ds] = dG;
    dst[3 * ds] = vm[0];
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[(4 + l) * ds] = vm[1 + l];
  }

  static __device__ __forceinline__ void row(const At& at, const float* s,
                                             const float* u, size_t g,
                                             size_t plane, float* out) {
    float xrho[MW], xG[MW], xdG[MW], xvr[MW];
    at.x(0, xrho);
    at.x(1, xG);
    at.x(2, xdG);
    at.x(3, xvr);
    const float* c_rho = at.centre(0);
    const float* c_G = at.centre(1);
    const float* c_dG = at.centre(2);
    const float* c_vr = at.centre(3);
    const float vr = c_vr[0];
    float row = graddot(xvr, xG, c_vr, c_G) + graddot(xrho, xdG, c_rho, c_dG) +
                vr * lap(xG, c_G) + c_rho[0] * lap(xdG, c_dG);
    const int vs = DOF * at.mtn;  // b, then the raw v
    out[g] = RESID ? at.bv[0] - s[1] * at.bv[vs] + row : row;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xvU[MW];
      at.x(4 + l, xvU);
      row = -ksfd_gamma(l, s[0]) * xvU[SW] + ksfd_s(l, s[0]) * vr +
            ksfd_D(l, s[0]) * lap(xvU, at.centre(4 + l));
      const int jl = (1 + l) * at.mtn;
      out[(1 + l) * plane + g] =
          RESID ? at.bv[jl] - s[1] * at.bv[vs + jl] + row : row;
    }
  }
};

// delta: the exact increment rhs(u1) - rhs(u0) of the source-free RHS
// from u0 (groomed), d = u1 - u0 and u1; sc = [t, rho_mean, G0_mean].
struct Delta {
  static constexpr int MY = 8, NT = KSFD_THREADS(256), MINB = 3;
  static constexpr int NOP = 3, NARR = 4 + NLA;
  static constexpr int NSC = SC_DELTA;
  static constexpr bool STAGE = false;
  // d in its final arrays (d_rho 0, d_U 4 ..); u0 then u1 in arrays 1 to
  // 3, where Gs, rho0c and dG are written, and past the slot
  static constexpr KSFD_HOST_DEVICE int lands(int q) {
    if (q >= DOF && q < 2 * DOF) return q == DOF ? 0 : 3 + q - DOF;
    const int r = q < DOF ? q : q - DOF;
    return r < 3 ? 1 + r : NARR + r - 3;
  }

  static __device__ __forceinline__ void point(const Raw<NARR>& raw,
                                               float* dst, int ds,
                                               const float* s) {
    float f[DOF], dd[DOF], u1[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      f[k] = raw[lands(k)];
      dd[k] = raw[lands(DOF + k)];
      u1[k] = raw[lands(2 * DOF + k)];
    }
    const float G0c = ksfd_G(f, s[0]) - s[2];
    const float dG = ksfd_G_delta(f, dd, u1, s[0]);
    dst[0] = dd[0];
    dst[1 * ds] = G0c + dG;
    dst[2 * ds] = f[0] - s[1];
    dst[3 * ds] = dG;
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[(4 + l) * ds] = dd[1 + l];
  }

  static __device__ __forceinline__ void row(const At& at, const float* s,
                                             const float* u0, size_t g,
                                             size_t plane, float* out) {
    float xd0[MW], xGs[MW], xr0c[MW], xdG[MW];
    at.x(0, xd0);
    at.x(1, xGs);
    at.x(2, xr0c);
    at.x(3, xdG);
    const float* c_d0 = at.centre(0);
    const float* c_Gs = at.centre(1);
    const float* c_r0c = at.centre(2);
    const float* c_dG = at.centre(3);
    const float drho = c_d0[0];
    out[g] = graddot(xd0, xGs, c_d0, c_Gs) + graddot(xr0c, xdG, c_r0c, c_dG) +
             drho * lap(xGs, c_Gs) + u0[g] * lap(xdG, c_dG);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xdU[MW];
      at.x(4 + l, xdU);
      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xdU[SW] +
                                 ksfd_s(l, s[0]) * drho +
                                 ksfd_D(l, s[0]) * lap(xdU, at.centre(4 + l));
    }
  }
};

// rhs: the full centred RHS of the float32 fast mode (no sources: the
// wrapper adds them) from the RAW state u, groomed here; sc = [t,
// mean_0 .. mean_{DOF-1}, G(means), react_1 .. react_NL].
struct Rhs {
  static constexpr int MY = 16, NT = KSFD_THREADS(512), MINB = 2;
  static constexpr int NOP = 1, NARR = 2 + NLA;
  static constexpr int NSC = SC_RHS;
  static constexpr bool STAGE = false;
  static constexpr KSFD_HOST_DEVICE int lands(int q) { return q; }

  static __device__ __forceinline__ void point(const Raw<NARR>& raw,
                                               float* dst, int ds,
                                               const float* s) {
    float f[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      const float r = raw[k];
      const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
      f[k] = r >= lo ? r : lo;
    }
    dst[0] = f[0] - s[1];
    dst[1 * ds] = ksfd_G(f, s[0]) - s[1 + DOF];
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[(2 + l) * ds] = f[1 + l] - s[2 + l];
  }

  static __device__ __forceinline__ void row(const At& at, const float* s,
                                             const float* u, size_t g,
                                             size_t plane, float* out) {
    float xrc[MW], xGc[MW];
    at.x(0, xrc);
    at.x(1, xGc);
    const float* c_rc = at.centre(0);
    const float* c_Gc = at.centre(1);
    // the uncentred groomed rho at the output point
    const float raw = u[g];
    const float rho = raw >= KSFD_RHOMIN ? raw : KSFD_RHOMIN;
    const float rc = c_rc[0];
    out[g] = graddot(xrc, xGc, c_rc, c_Gc) + rho * lap(xGc, c_Gc);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xUc[MW];
      at.x(2 + l, xUc);
      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xUc[SW] +
                                 ksfd_s(l, s[0]) * rc + s[2 + DOF + l] +
                                 ksfd_D(l, s[0]) * lap(xUc, at.centre(2 + l));
    }
  }
};

// -- the march --------------------------------------------------------------
// K::lands() sends a point's nraw raw values to distinct arrays below
// nraw (the ring holds nraw arrays), so past the slot below NARR + NEXT
template <class K>
constexpr KSFD_HOST_DEVICE bool lands_ok(int nraw) {
  for (int q = 0; q < nraw; ++q) {
    if (K::lands(q) < 0 || K::lands(q) >= nraw) return false;
    for (int p = 0; p < q; ++p)
      if (K::lands(p) == K::lands(q)) return false;
  }
  return true;
}

// The geometry of policy K's march: a plane's MTN interior points, the
// centre plane of CN points with its star halo, the ring of NRING halo
// points, a point's NRAW raw values of which NEXT land past its slot,
// and the dynamic shared memory in 4-byte words: the (y, z) offsets of
// the interior and the ring and the ring's positions in the centre
// plane (ints), the slots, the landing area (two planes), the centre
// plane, the next ring's raw values; STAGE adds b and the raw v of the
// centre.
template <class K>
struct Geo {
  static constexpr int MTN = K::MY * MZ;
  static constexpr int CN = (K::MY + 2 * SW) * CZ;
  static constexpr int NRING = 2 * SW * (MZ + K::MY);
  static constexpr int NRAW = K::NOP * DOF;
  static constexpr int NEXT = NRAW > K::NARR ? NRAW - K::NARR : 0;
  static constexpr size_t FLOATS =
      (size_t)MTN + 2 * NRING + (size_t)NSLOT * K::NARR * MTN +
      2 * (size_t)NEXT * MTN + (size_t)K::NARR * CN + (size_t)NRAW * NRING +
      (K::STAGE ? (size_t)NRAW * MTN : 0);
  static_assert(4 * FLOATS <= 227 * 1024, "window too large");
  static_assert(lands_ok<K>(NRAW), "lands(): raw values collide");
};

// The block's (y, z) column tile, x chunk [xa, xb) and member, decoded
// from the 1D grid: member slowest, then the x chunk, y and z tiles.
struct Column {
  int xa, xb, y0, z0;
  size_t member;
};

template <int MY>
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

// N stencil operands: each the array (the slab, in a halo-slab build)
// and its lo and hi halo rows (halo-slab builds only).
template <int N>
struct Operands {
  const float* p[N];
  const float* lo[N];
  const float* hi[N];
};

// Where plane p of each operand lies: its rows and the stride of a
// field.  Unsharded, p (in [-nx, 2 nx)) wraps once; in the halo-slab
// build rows below 0 are in lo and rows at or past nx in hi (SW rows a
// field), a ragged chunk's overreach clamped to hi's last row.
template <int N>
struct Plane {
  const float* p[N];
  size_t fs;
};

template <bool HALO, int N>
__device__ __forceinline__ Plane<N> plane_of(int p, const Operands<N>& o,
                                             int nx, size_t pl) {
  Plane<N> r;
  if (!HALO) {
    const size_t w = p < 0 ? p + nx : (p >= nx ? p - nx : p);
#pragma unroll
    for (int i = 0; i < N; ++i) r.p[i] = o.p[i] + w * pl;
    r.fs = (size_t)nx * pl;
  } else if (p < 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) r.p[i] = o.lo[i] + (size_t)(p + SW) * pl;
    r.fs = (size_t)SW * pl;
  } else if (p >= nx) {
    const size_t w = p - nx < SW ? p - nx : SW - 1;
#pragma unroll
    for (int i = 0; i < N; ++i) r.p[i] = o.hi[i] + w * pl;
    r.fs = (size_t)SW * pl;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r.p[i] = o.p[i] + (size_t)p * pl;
    r.fs = (size_t)nx * pl;
  }
  return r;
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

// Start the copies of the raw values of n points of one plane: point
// j's (y, z) offset is offs[j]; raw value q (field k of operand i)
// lands in array a = K::lands(q) of dst or, from NARR on, in array
// a - NARR of ext (both of stride ds).  A point's copies go field by
// field, the operands in turn (u0 v0 u1 v1 ...: operand by operand was
// slower on the H100).
template <class K, int N>
__device__ __forceinline__ void fetch(float* dst, float* ext, int ds,
                                      const int* offs, int n,
                                      const Plane<N>& pl) {
  const size_t fs = pl.fs;
  for (int j = threadIdx.x; j < n; j += K::NT) {
    const int off = offs[j];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int q = i * DOF + k, a = K::lands(q);
        float* to =
            a < K::NARR ? &dst[a * ds + j] : &ext[(a - K::NARR) * ds + j];
        copy_f32(to, &pl.p[i][k * fs + off]);
      }
    }
  }
}

// Policy K's kernel on its block's columns.  Step x of the march: plane
// x + SW has landed in the landing slot (and area) and the star halo
// (ring) of centre x in s_ring.  Start the copies of plane x + 1 + SW
// into the slot that plane x - 1 - SW left (and, with STAGE, of b and v
// at plane x); evaluate the landed plane in place and the ring into the
// centre plane, beside a copy of the centre's interior; start the
// copies of the ring of x + 1; compute the rows of x.  The first 2*SW
// steps of a chunk only fill the window.
template <class K, bool HALO>
__device__ __forceinline__ void march_body(const float* __restrict__ sc,
                                           Operands<K::NOP> o,
                                           const float* __restrict__ b,
                                           float* __restrict__ out, int nx,
                                           int ny, int nz) {
  using G = Geo<K>;
  constexpr int NT = K::NT, MY = K::MY, NARR = K::NARR;
  constexpr int MTN = G::MTN, CN = G::CN, NRING = G::NRING;
  int* s_off = reinterpret_cast<int*>(ksfd_smem);  // MTN + NRING
  int* s_pos = s_off + MTN + NRING;                 // NRING
  float* s_slot = ksfd_smem + MTN + 2 * NRING;      // NSLOT x NARR x MTN
  float* s_ext = s_slot + NSLOT * NARR * MTN;       // 2 x NEXT x MTN
  float* s_cen = s_ext + 2 * G::NEXT * MTN;         // NARR x CN
  float* s_ring = s_cen + NARR * CN;                // NRAW x NRING
  float* s_bv = s_ring + G::NRAW * NRING;           // STAGE: NRAW x MTN
  const Column cl = column_of<MY>(nx, ny, nz);
  const size_t pl = (size_t)ny * nz, plane = (size_t)nx * pl;
  const size_t mb = HALO ? 0 : cl.member;
  const size_t member = mb * DOF * plane;
  sc += mb * K::NSC;
  float s[K::NSC];
#pragma unroll
  for (int i = 0; i < K::NSC; ++i) s[i] = sc[i];
#pragma unroll
  for (int i = 0; i < K::NOP; ++i) o.p[i] += member;
  out += member;
  if (K::STAGE) b += member;

  // the wrapped (y, z) offsets of the interior, then of the ring (y halo
  // rows, then z halo columns), and the ring's centre-plane positions
  for (int j = threadIdx.x; j < MTN + NRING; j += NT) {
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
  fetch<K>(s_slot, s_ext, MTN, s_off, MTN,
           plane_of<HALO>(xa - SW, o, nx, pl));
  copies_commit();
  for (int x = xa - 2 * SW; x < xb; ++x) {
    copies_wait<0>();
    __syncthreads();
    const int next = land + 1 == NSLOT ? 0 : land + 1;
    if constexpr (K::STAGE) {
      if (x >= xa) {
        // raw value q of b and v at s_bv[q * MTN], past NARR too
        fetch<K>(s_bv, s_bv + NARR * MTN, MTN, s_off, MTN,
                 Plane<2>{{b + x * pl, o.p[1] + x * pl}, plane});
        copies_commit();
      }
    }
    if (x + 1 < xb) {
      fetch<K>(s_slot + next * NARR * MTN, s_ext + (next & 1) * G::NEXT * MTN,
               MTN, s_off, MTN, plane_of<HALO>(x + 1 + SW, o, nx, pl));
      copies_commit();
    }
    float* in = s_slot + land * NARR * MTN;
    const float* ext = s_ext + (land & 1) * G::NEXT * MTN;
    for (int j = threadIdx.x; j < MTN; j += NT)
      K::point(Raw<NARR>{&in[j], &ext[j], MTN}, &in[j], MTN, s);
    int xs[MW];  // the slots of planes x - SW .. x + SW, in words
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      const int sl = land - 2 * SW + k;
      xs[k] = (sl < 0 ? sl + NSLOT : sl) * NARR * MTN;
    }
    if (x >= xa) {
      for (int j = threadIdx.x; j < NRING; j += NT)
        K::point(Raw<NARR>{&s_ring[j], &s_ring[NARR * NRING + j], NRING},
                 &s_cen[s_pos[j]], CN, s);
      for (int j = threadIdx.x; j < MTN; j += NT) {
        const int iy = j / MZ, c = (iy + SW) * CZ + j - iy * MZ + SW;
#pragma unroll
        for (int a = 0; a < NARR; ++a)
          s_cen[a * CN + c] = s_slot[xs[SW] + a * MTN + j];
      }
    }
    // with STAGE, b and v of plane x have landed (the plane copies of
    // x + 1 + SW may still be in flight)
    if (K::STAGE && x >= xa) {
      if (x + 1 < xb)
        copies_wait<1>();
      else
        copies_wait<0>();
    }
    __syncthreads();
    if (x + 1 < xb && x + 1 >= xa) {
      fetch<K>(s_ring, s_ring + NARR * NRING, NRING, s_off + MTN, NRING,
               plane_of<HALO>(x + 1, o, nx, pl));
      copies_commit();
    }
    if (x >= xa) {
      for (int j = threadIdx.x; j < MTN; j += NT) {
        const int iy = j / MZ, iz = j - iy * MZ;
        if (cl.y0 + iy >= ny || cl.z0 + iz >= nz) continue;
        const At at{s_slot, xs, j, MTN,
                    s_cen, (iy + SW) * CZ + iz + SW, CN, s_bv + j};
        K::row(at, s, o.p[0], (size_t)x * pl + s_off[j], plane, out);
      }
    }
    land = next;
  }
}

// -- the kernels ----------------------------------------------------------
template <bool RESID>
__global__ void KSFD_BOUNDS(Jvp<RESID>)
jvp_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ b,
           float* __restrict__ out, int nx, int ny, int nz) {
  march_body<Jvp<RESID>, false>(sc, Operands<2>{{u, v}, {}, {}}, b, out, nx,
                                ny, nz);
}

// B9: one rank's slab; u and v with their halo rows, b at its own
// points only
template <bool RESID>
__global__ void KSFD_BOUNDS(Jvp<RESID>)
jvp_halo_kernel(const float* __restrict__ sc, const float* __restrict__ u,
                const float* __restrict__ u_lo,
                const float* __restrict__ u_hi, const float* __restrict__ v,
                const float* __restrict__ v_lo,
                const float* __restrict__ v_hi, const float* __restrict__ b,
                float* __restrict__ out, int nx, int ny, int nz) {
  march_body<Jvp<RESID>, true>(
      sc, Operands<2>{{u, v}, {u_lo, v_lo}, {u_hi, v_hi}}, b, out, nx, ny,
      nz);
}

__global__ void KSFD_BOUNDS(Delta)
delta_kernel(const float* __restrict__ sc, const float* __restrict__ u0,
             const float* __restrict__ d, const float* __restrict__ u1,
             float* __restrict__ out, int nx, int ny, int nz) {
  march_body<Delta, false>(sc, Operands<3>{{u0, d, u1}, {}, {}}, nullptr,
                           out, nx, ny, nz);
}

// B9: one rank's slab; u0, d and u1 with their halo rows
__global__ void KSFD_BOUNDS(Delta)
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
  march_body<Delta, true>(sc,
                          Operands<3>{{u0, d, u1},
                                      {u0_lo, d_lo, u1_lo},
                                      {u0_hi, d_hi, u1_hi}},
                          nullptr, out, nx, ny, nz);
}

__global__ void KSFD_BOUNDS(Rhs)
rhs_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           float* __restrict__ out, int nx, int ny, int nz) {
  march_body<Rhs, false>(sc, Operands<1>{{u}, {}, {}}, nullptr, out, nx, ny,
                         nz);
}

// B9: one rank's slab with its halo rows (one member)
__global__ void KSFD_BOUNDS(Rhs)
rhs_halo_kernel(const float* __restrict__ sc, const float* __restrict__ u,
                const float* __restrict__ u_lo,
                const float* __restrict__ u_hi, float* __restrict__ out,
                int nx, int ny, int nz) {
  march_body<Rhs, true>(sc, Operands<1>{{u}, {u_lo}, {u_hi}}, nullptr, out,
                        nx, ny, nz);
}

// Launch geometry of each kernel (KSFD_JVP .. KSFD_RHS; a halo-slab
// build has its kernel's): blocks of the 1D grid for nb members, threads
// and 4-byte words of dynamic shared memory per block.
enum { KSFD_JVP = 0, KSFD_RESID = 1, KSFD_DELTA = 2, KSFD_RHS = 3 };

template <class K>
long long blocks_of(int nx, int ny, int nz, int nb) {
  return (long long)nb * ((nz + MZ - 1) / MZ) * ((ny + K::MY - 1) / K::MY) *
         ((nx + LX - 1) / LX);
}

long long grid_blocks(int which, int nx, int ny, int nz, int nb) {
  switch (which) {
    case KSFD_JVP: return blocks_of<Jvp<false>>(nx, ny, nz, nb);
    case KSFD_RESID: return blocks_of<Jvp<true>>(nx, ny, nz, nb);
    case KSFD_DELTA: return blocks_of<Delta>(nx, ny, nz, nb);
  }
  return blocks_of<Rhs>(nx, ny, nz, nb);
}

constexpr size_t smem_floats(int which) {
  return which == KSFD_JVP     ? Geo<Jvp<false>>::FLOATS
         : which == KSFD_RESID ? Geo<Jvp<true>>::FLOATS
         : which == KSFD_DELTA ? Geo<Delta>::FLOATS
                               : Geo<Rhs>::FLOATS;
}

constexpr int block_threads(int which) {
  return which == KSFD_JVP     ? Jvp<false>::NT
         : which == KSFD_RESID ? Jvp<true>::NT
         : which == KSFD_DELTA ? Delta::NT
                               : Rhs::NT;
}

constexpr size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// the most any kernel takes (a host harness sizes its ksfd_smem by it)
constexpr size_t SMEM_FLOATS_MAX =
    larger(larger(smem_floats(KSFD_JVP), smem_floats(KSFD_RESID)),
           larger(smem_floats(KSFD_DELTA), smem_floats(KSFD_RHS)));

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

// nb: members (>= 1), with the blocks in one grid dimension
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
