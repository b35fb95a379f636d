// Fused float32 stencil kernels of the Keller-Segel operator, 2D
// periodic, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of ksfd_tpu/ops/pallas_stencil.py:
//   ksfd_rhs    <- rhs_kernel   :584
//   ksfd_resid  <- resid_kernel :655 (rows from _jvp_rows :613)
//   ksfd_jvp    <- jvp_kernel   :648
//   ksfd_delta  <- delta_kernel :674
//   ksfd_coeff_resid <- tools/probe_coeff_kernel.py resid_kernel :114
// The problem (free energy G, its field derivatives dG, the increment
// form G_delta, stencil coefficients, groom floors, ligand
// coefficients) comes from the header that ops/codegen.py generates
// (ksfd_pointwise.cuh).  The wrappers, scalar packs and plain PyTorch
// versions are in ops/fused_stencil.py.
//
// Bound: memory.  At 1024^2 x 3 f32 each kernel reads one to four
// state-sized arrays and writes one (rhs: u -> out, 25 MB, 7.5 us at
// the H100 SXM's 3.35 TB/s; jvp: u, v -> out, 38 MB, 11.3 us; resid: u,
// v, b -> out and delta: u0, d, u1 -> out, 50 MB, 15 us).  None reaches
// it, and no single part sets the time (tools/probe_stencil2d.py;
// PERF.md, section 6): dropping the pointwise evaluations (logf, tanhf
// and divisions a point), the star-stencil rows or the loads' address
// arithmetic each saves a fifth to a third of a kernel's time.  At
// 1024^2 a march's blocks fill the card in about one wave, so a launch
// lasts as long as one block's chain of dependent phases: per step a
// round trip to memory for the landing rows, their evaluation, a
// barrier, the rows.  resid adds a second round trip per step, for b
// and v at the outputs, and that is all of its time over jvp (the
// probe's no_output_reads); reading them before the barrier or
// prefetching b into L2 at the step's start was slower (PERF.md).
//
// One design for the four kernels of the step, a march along x,
// written once (march_body) over a policy per kernel (Jvp<RESID>,
// Delta, Rhs: its geometry, operands, ring arrays, scalar pack, one
// point's evaluation and one output point's rows).  A block walks a
// chunk of LX rows of a TY-column strip in steps of TX rows, and the
// 2*SW evaluated rows that two steps share stay in a ring in shared
// memory, so a point is evaluated (LX + 2*SW)/LX * (TY + 2*SW)/TY times
// an output (1.20 at 64 columns and chunks of 32), with no % outside
// the block's setup.  The ring holds every evaluated value an output's
// rows read, the uncentred ones too (delta's rho0, rhs's groomed rho):
// the tile design before it read those at the output point from global
// memory, a second round trip per step.  Threads run along the contiguous y
// axis, so global reads and writes coalesce and shared-memory reads are
// conflict free; a strip starts on a 256-byte line (60-column strips
// took 25 % longer).  B11's coeff_resid, a probe of the reference, keeps
// the earlier tile: one block per TX x TY tile reads its inputs with an
// SW-wide halo straight from global memory by periodic index arithmetic
// and stages them in shared memory once per halo point.
//
// Geometry, chosen by timing on the H100 (tools/probe_stencil2d.py;
// PERF.md, section 6).  The rows phase is bound by shared-memory
// bandwidth (delta reads about 55 ring values an output), so a thread
// computes a run of RX consecutive rows of one column: neighbouring
// outputs share their x windows' loads.  jvp and resid: 64-column
// strips, steps of 16 rows, chunks of 32, 256 threads at 5 blocks per
// SM (48 registers), runs of one row (runs of 2 spill in some builds).
// delta, whose evaluation (G and G_delta from 9 raw values) is the
// heaviest: the same strips at 4 blocks per SM (64 registers) with runs
// of 4 rows (2 above 3 fields, where 4 spill): at 1024^2 x 3 32.5 us
// against 34.0 with runs of one.  rhs: one step of 32 rows a chunk (no
// second landing phase and barrier) at 4 blocks per SM with runs of 4:
// 15.8 us against 18.4 with jvp's geometry.
//
// Semantics kept from the Pallas body:
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
// Member-batched builds (pallas_stencil.py:523-535, B8): every entry
// takes a member count nb >= 1 and launches one grid of nb x the blocks
// (the march: one 1D grid, the member slowest, then the x chunk, the y
// strip fastest; coeff_resid: the member on blockIdx.z).  Operands are
// contiguous (nb, planes, nx, ny) and the scalar pack is (nb, k), one
// row per member, as the batched Pallas build reads scv(sc_ref, b, j)
// (pallas_stencil.py:530).  A block adds member * planes * nx * ny to
// its pointers and member * k to the pack, and nothing else changes:
// the arithmetic of a member is that of a single launch, so a batched
// launch equals nb single launches bit for bit, and nb = 1 is the
// single-member kernel.
//
// Halo-slab builds (B9, the sharded builds of pallas_stencil.py: pad_x
// :718-735, shardwrap :737-755, padded_src :539): ksfd_<name>_halo runs
// the same kernel on one rank's local x-slab (nx = the slab's rows).
// Each operand that the stencil reads comes as the slab plus its lo and
// hi halo buffers, the SW rows below and above it from the ring
// neighbours, each a contiguous (DOF, SW, ny) block; a row r in [-SW,
// nx + SW) reads lo, the slab or hi in place of wrap(r, nx) (the march
// picks the part once per row, as it wraps a row once).  y still wraps
// inside the slab; resid's b and the own-point reads need no halo.  The
// TPU build pads every operand into a fresh array (pad_x's concatenate,
// a full HBM copy of each operand per call); here the landing rows read
// the halo buffers where they lie, so the only extra traffic is the
// 2 * SW rows.  The halo depth is SW rows, not the TPU's 8-row DMA unit
// (_halo_rows :316).  A halo-slab launch has no member axis (a batched
// build is never sharded, pallas_stencil.py:526), and its arithmetic per
// point is the unsharded kernel's (the x stencils gather a point's
// window in x order, wherever a chunk or slab starts), so the stitched
// slabs equal one unsharded launch bit for bit under one scalar pack.
// Each __global__ entry instantiates the march with HALO false (the
// unsharded and member-batched build) or true.
//
// Without __CUDACC__ (a host C++ compiler with the CUDA qualifiers
// defined away, KSFD_NT=1 and one thread walking each block) the kernel
// bodies compile as plain C++; tests/test_torch_kernels.py runs them so
// on the CPU, launching the march's 1D grid as ksfd_blocks exports it
// into a ksfd_smem of SMEM_FLOATS_MAX words.  The launching C entries
// exist only in the nvcc build; the geometry (ksfd_blocks, ksfd_threads,
// ksfd_smem_bytes) in both.

#include <math.h>
#include <stddef.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ksfd_pointwise.cuh"

static_assert(KSFD_DIM == 2, "stencil2d.cu needs the 2D pointwise header");

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
#else
#define KSFD_BOUNDS(K)
#endif

// the march's ring: dynamic shared memory, as rhs's (36 rows) passes
// 48 KB at 3 fields, delta's at 5 and jvp's at 6
extern __shared__ float ksfd_smem[];

namespace {

constexpr int SW = KSFD_SW;
constexpr int DOF = KSFD_DOF;
constexpr int NL = DOF - 1;           // ligand fields
constexpr int NLA = NL > 0 ? NL : 1;  // arrays kept for them (never 0)
// scalar pack lengths, the row stride of a batched pack
constexpr int SC_RHS = 2 * DOF + 1;  // t, means, G(means), reactions
constexpr int SC_JVP = 1;            // t
constexpr int SC_RESID = 2;          // t, shift
constexpr int SC_DELTA = 3;          // t, rho_mean, G0_mean

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// -- B11's tile ---------------------------------------------------------------
constexpr int TX = 16;                // tile rows (x)
constexpr int TY = 64;                // tile columns (y, contiguous)
constexpr int NT = KSFD_THREADS(256); // threads per block
constexpr int HX = TX + 2 * SW;
constexpr int HY = TY + 2 * SW;
constexpr int HN = HX * HY;
// coefficient planes of coeff_resid: rho_g, G, dG'_0..dG'_{DOF-1},
// maskpack (tools/probe_coeff_kernel.py:183-205)
constexpr int NC = DOF + 3;
// coeff_resid reads NC + DOF planes per halo point (9 at DOF = 3).
// Staged raw they would need (NC + DOF) * HN * 4 B of shared memory,
// 48,960 B at DOF = 3, over the 48 KB static limit.  It folds them as
// it loads them into the 4 + NL arrays of B1's rows (rho, G, dG.v and
// the DOF masked tangents: 32,640 B at DOF = 3).
static_assert((4 + NL) * HN * 4 <= 48 * 1024,
              "tile too large for static shared memory");

__device__ __forceinline__ float lap(const float* p) {
  return ksfd_d2x(p, HY) + ksfd_d2y(p, 1);
}

__device__ __forceinline__ float graddot(const float* a, const float* b) {
  return ksfd_d1x(a, HY) * ksfd_d1x(b, HY) + ksfd_d1y(a, 1) * ksfd_d1y(b, 1);
}

// B11: the Richardson residual b - shift*v + J(u)v (resid_kernel's
// rows) fed from precomputed float32 coefficient fields C = [rho_g, G,
// dG'_0..dG'_{DOF-1}, maskpack] (NC planes), with no pointwise
// transcendental (tools/probe_coeff_kernel.py:114-161).  The dG'_i are
// already masked (zero where field i's clamp is active), so dG = sum_i
// dG'_i * v_i takes the raw tangent; the masked tangents of the rows
// come from maskpack's bits (bit i: u_i above its floor).  sc = [t,
// shift].
__global__ void __launch_bounds__(NT)
coeff_resid_kernel(const float* __restrict__ sc, const float* __restrict__ C,
                   const float* __restrict__ v, const float* __restrict__ b,
                   float* __restrict__ out, int nx, int ny) {
  __shared__ float s_rho[HN], s_G[HN], s_dG[HN], s_vr[HN];
  __shared__ float s_vU[NLA][HN];
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)nx * ny;
  const size_t member = blockIdx.z * (size_t)DOF * plane;
  sc += blockIdx.z * SC_RESID;
  C += blockIdx.z * (size_t)NC * plane;
  v += member;
  b += member;
  out += member;
  const float t = sc[0], shift = sc[1];

  for (int i = threadIdx.x; i < HN; i += NT) {
    const int hx = i / HY, hy = i - hx * HY;
    const size_t g =
        (size_t)wrap(x0 + hx - SW, nx) * ny + wrap(y0 + hy - SW, ny);
    float vv[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) vv[k] = v[k * plane + g];
    // maskpack holds small integers, exact in float32
    const int mask = (int)C[(2 + DOF) * plane + g];
    float dG = C[2 * plane + g] * vv[0];
#pragma unroll
    for (int k = 1; k < DOF; ++k) dG = dG + C[(2 + k) * plane + g] * vv[k];
    s_rho[i] = C[g];
    s_G[i] = C[plane + g];
    s_dG[i] = dG;
    s_vr[i] = (mask & 1) ? vv[0] : 0.0f;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      s_vU[l][i] = ((mask >> (1 + l)) & 1) ? vv[1 + l] : 0.0f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * TY; i += NT) {
    const int ix = i / TY, iy = i - ix * TY;
    const int gx = x0 + ix, gy = y0 + iy;
    if (gx >= nx || gy >= ny) continue;
    const int c = (ix + SW) * HY + (iy + SW);
    const size_t g = (size_t)gx * ny + gy;
    const float vr = s_vr[c];
    float row = graddot(&s_vr[c], &s_G[c]) + graddot(&s_rho[c], &s_dG[c]) +
                vr * lap(&s_G[c]) + s_rho[c] * lap(&s_dG[c]);
    out[g] = b[g] - shift * v[g] + row;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      row = -ksfd_gamma(l, t) * s_vU[l][c] + ksfd_s(l, t) * vr +
            ksfd_D(l, t) * lap(&s_vU[l][c]);
      const size_t gl = (1 + l) * plane + g;
      out[gl] = b[gl] - shift * v[gl] + row;
    }
  }
}

// -- the march ----------------------------------------------------------------
constexpr int MW = 2 * SW + 1;  // window rows of a stencil

// The star stencils of the march: x from a point's 2*SW + 1 window
// values gathered in x order (stride 1), y from the centre row.
__device__ __forceinline__ float lap(const float* xs, const float* p) {
  return ksfd_d2x(xs + SW, 1) + ksfd_d2y(p, 1);
}

__device__ __forceinline__ float graddot(const float* xa, const float* xb,
                                         const float* a, const float* b) {
  return ksfd_d1x(xa + SW, 1) * ksfd_d1x(xb + SW, 1) +
         ksfd_d1y(a, 1) * ksfd_d1y(b, 1);
}

// One output point of a step: array a of window row k (grid row x - SW
// + k) at base[xs[k] + a * as], the centre row's at centre(a) (the
// point at offset 0, its y neighbours beside it).
struct At {
  const float* base;
  int xs[MW];
  int as;
  __device__ __forceinline__ void x(int a, float (&w)[MW]) const {
#pragma unroll
    for (int k = 0; k < MW; ++k) w[k] = base[xs[k] + a * as];
  }
  __device__ __forceinline__ const float* centre(int a) const {
    return base + xs[SW] + a * as;
  }
};

// N stencil operands: each the array (the slab, in a halo-slab build)
// and its lo and hi halo rows (halo-slab builds only).
template <int N>
struct Operands {
  const float* p[N];
  const float* lo[N];
  const float* hi[N];
};

// -- the policies -------------------------------------------------------------
// Each names its geometry: a block owns TY output columns, steps TX rows
// at a time through a chunk of LX rows with NT threads, a thread computes
// the outputs of RX consecutive rows of a column, and ptxas sizes its
// registers for MINB resident blocks per SM; its NOP stencil
// operands of DOF fields (a point's raw value op * DOF + field), NARR
// ring arrays, NSC scalars a member, whether it reads b at its own
// points (OWN); point(): one point's ring values from its raw values;
// row(): the DOF rows of output point g.

// jvp and resid: the J-action rows (with RESID, the fused Richardson
// residual b - shift*v + J(u)v) from u and v; ring: rho, G, dG.v,
// v_rho, v_U[NL]; sc = [t] or [t, shift] (t feeds the generated G and
// the ligand coefficients, which may depend on it).
template <bool RESID>
struct Jvp {
  static constexpr int TY = 64, TX = 16, LX = 32, NT = KSFD_THREADS(256), MINB = 5,
                       RX = 1;
  static constexpr int NOP = 2, NARR = 4 + NLA;
  static constexpr int NSC = RESID ? SC_RESID : SC_JVP;
  static constexpr bool OWN = RESID;

  static __device__ __forceinline__ void point(const float (&raw)[NOP * DOF],
                                               float (&val)[NARR],
                                               const float* s) {
    float f[DOF], vm[DOF], dg[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
      f[k] = raw[k] >= lo ? raw[k] : lo;
      vm[k] = raw[k] > lo ? raw[DOF + k] : 0.0f;
    }
    ksfd_dG(f, s[0], dg);
    float dG = dg[0] * vm[0];
#pragma unroll
    for (int k = 1; k < DOF; ++k) dG = dG + dg[k] * vm[k];
    val[0] = f[0];
    val[1] = ksfd_G(f, s[0]);
    val[2] = dG;
    val[3] = vm[0];
    val[4] = 0.0f;  // with no ligand field, the unused array
#pragma unroll
    for (int l = 0; l < NL; ++l) val[4 + l] = vm[1 + l];
  }

  static __device__ __forceinline__ void row(const At& at, const float* s,
                                             const Operands<NOP>& o,
                                             const float* __restrict__ b,
                                             float* __restrict__ out,
                                             size_t g, size_t plane) {
    const float* __restrict__ v = o.p[1];
    float xrho[MW], xG[MW], xdG[MW], xvr[MW];
    at.x(0, xrho);
    at.x(1, xG);
    at.x(2, xdG);
    at.x(3, xvr);
    const float* c_rho = at.centre(0);
    const float* c_G = at.centre(1);
    const float* c_dG = at.centre(2);
    const float* c_vr = at.centre(3);
    const float vr = xvr[SW];
    float row = graddot(xvr, xG, c_vr, c_G) + graddot(xrho, xdG, c_rho, c_dG) +
                vr * lap(xG, c_G) + xrho[SW] * lap(xdG, c_dG);
    out[g] = RESID ? b[g] - s[1] * v[g] + row : row;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xvU[MW];
      at.x(4 + l, xvU);
      row = -ksfd_gamma(l, s[0]) * xvU[SW] + ksfd_s(l, s[0]) * vr +
            ksfd_D(l, s[0]) * lap(xvU, at.centre(4 + l));
      const size_t gl = (1 + l) * plane + g;
      out[gl] = RESID ? b[gl] - s[1] * v[gl] + row : row;
    }
  }
};

// delta: the exact increment rhs(u1) - rhs(u0) of the source-free RHS
// from u0 (groomed), d = u1 - u0 and u1; ring: d_rho, Gs = (G(u0) -
// G0_mean) + dG, rho0c, dG = G_delta(u0, d, u1), rho0, d_U[NL]; sc =
// [t, rho_mean, G0_mean].
struct Delta {
  static constexpr int TY = 64, TX = 16, LX = 32, NT = KSFD_THREADS(256), MINB = 4,
                       RX = DOF > 3 ? 2 : 4;
  static constexpr int NOP = 3, NARR = 5 + NLA;
  static constexpr int NSC = SC_DELTA;
  static constexpr bool OWN = false;

  static __device__ __forceinline__ void point(const float (&raw)[NOP * DOF],
                                               float (&val)[NARR],
                                               const float* s) {
    float f[DOF], dd[DOF], u1[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      f[k] = raw[k];
      dd[k] = raw[DOF + k];
      u1[k] = raw[2 * DOF + k];
    }
    const float G0c = ksfd_G(f, s[0]) - s[2];
    const float dG = ksfd_G_delta(f, dd, u1, s[0]);
    val[0] = dd[0];
    val[1] = G0c + dG;
    val[2] = f[0] - s[1];
    val[3] = dG;
    val[4] = f[0];
    val[5] = 0.0f;  // with no ligand field, the unused array
#pragma unroll
    for (int l = 0; l < NL; ++l) val[5 + l] = dd[1 + l];
  }

  static __device__ __forceinline__ void row(const At& at, const float* s,
                                             const Operands<NOP>& o,
                                             const float* __restrict__ b,
                                             float* __restrict__ out,
                                             size_t g, size_t plane) {
    float xd0[MW], xGs[MW], xr0c[MW], xdG[MW];
    at.x(0, xd0);
    at.x(1, xGs);
    at.x(2, xr0c);
    at.x(3, xdG);
    const float* c_d0 = at.centre(0);
    const float* c_Gs = at.centre(1);
    const float* c_r0c = at.centre(2);
    const float* c_dG = at.centre(3);
    const float drho = xd0[SW];
    const float rho0 = at.centre(4)[0];
    out[g] = graddot(xd0, xGs, c_d0, c_Gs) + graddot(xr0c, xdG, c_r0c, c_dG) +
             drho * lap(xGs, c_Gs) + rho0 * lap(xdG, c_dG);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xdU[MW];
      at.x(5 + l, xdU);
      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xdU[SW] +
                                 ksfd_s(l, s[0]) * drho +
                                 ksfd_D(l, s[0]) * lap(xdU, at.centre(5 + l));
    }
  }
};

// rhs: the full centred RHS of the float32 fast mode (no sources: the
// wrapper adds them) from the RAW state u, groomed here; ring: rho_c,
// Gc, the groomed rho, Uc[NL]; sc = [t, mean_0 .. mean_{DOF-1},
// G(means), react_1 .. react_NL] (t feeds the generated G and the
// ligand coefficients).
struct Rhs {
  static constexpr int TY = 64, TX = 32, LX = 32, NT = KSFD_THREADS(256), MINB = 4,
                       RX = 4;
  static constexpr int NOP = 1, NARR = 3 + NLA;
  static constexpr int NSC = SC_RHS;
  static constexpr bool OWN = false;

  static __device__ __forceinline__ void point(const float (&raw)[NOP * DOF],
                                               float (&val)[NARR],
                                               const float* s) {
    float f[DOF];
#pragma unroll
    for (int k = 0; k < DOF; ++k) {
      const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
      f[k] = raw[k] >= lo ? raw[k] : lo;
    }
    val[0] = f[0] - s[1];
    val[1] = ksfd_G(f, s[0]) - s[1 + DOF];
    val[2] = f[0];
    val[3] = 0.0f;  // with no ligand field, the unused array
#pragma unroll
    for (int l = 0; l < NL; ++l) val[3 + l] = f[1 + l] - s[2 + l];
  }

  static __device__ __forceinline__ void row(const At& at, const float* s,
                                             const Operands<NOP>& o,
                                             const float* __restrict__ b,
                                             float* __restrict__ out,
                                             size_t g, size_t plane) {
    float xrc[MW], xGc[MW];
    at.x(0, xrc);
    at.x(1, xGc);
    const float* c_rc = at.centre(0);
    const float* c_Gc = at.centre(1);
    const float rc = xrc[SW];
    // the uncentred groomed rho at the output point
    const float rho = at.centre(2)[0];
    out[g] = graddot(xrc, xGc, c_rc, c_Gc) + rho * lap(xGc, c_Gc);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float xUc[MW];
      at.x(3 + l, xUc);
      out[(1 + l) * plane + g] = -ksfd_gamma(l, s[0]) * xUc[SW] +
                                 ksfd_s(l, s[0]) * rc + s[2 + DOF + l] +
                                 ksfd_D(l, s[0]) * lap(xUc, at.centre(3 + l));
    }
  }
};

// A block's shared memory under policy K: a ring of TX + 2*SW rows of
// the NARR arrays over the TY + 2*SW evaluated columns (the y halo),
// where each landing row of a step reads each operand (row_of) with the
// stride of a field, and the evaluated columns' wrapped y offsets.
template <class K>
struct Ring {
  static constexpr int MHY = K::TY + 2 * SW;  // evaluated columns of a row
  static constexpr int MR = K::TX + 2 * SW;   // ring rows
  float ring[MR][K::NARR][MHY];
  const float* rp[MR][K::NOP];
  size_t rfs[MR];
  int col[MHY];
  static_assert(K::TX >= 1 && K::LX >= K::TX && K::RX >= 1,
                "LX >= TX >= 1, RX >= 1");
};

// Where row r of each operand lies, with the stride of a field.
// Unsharded r (in [xa - SW, xb + SW)) wraps; in the halo-slab build rows
// below 0 are in lo and rows at or past nx in hi (SW rows a field).
template <int N>
struct MRow {
  const float* p[N];
  size_t fs;
};

template <bool HALO, int N>
__device__ __forceinline__ MRow<N> row_of(int r, const Operands<N>& o, int nx,
                                          int ny) {
  MRow<N> m;
  if (!HALO) {
    while (r < 0) r += nx;
    while (r >= nx) r -= nx;
  } else if (r < 0) {
    const size_t w = (size_t)(r + SW) * ny;
#pragma unroll
    for (int i = 0; i < N; ++i) m.p[i] = o.lo[i] + w;
    m.fs = (size_t)SW * ny;
    return m;
  } else if (r >= nx) {
    const size_t w = (size_t)(r - nx) * ny;
#pragma unroll
    for (int i = 0; i < N; ++i) m.p[i] = o.hi[i] + w;
    m.fs = (size_t)SW * ny;
    return m;
  }
  const size_t w = (size_t)r * ny;
#pragma unroll
  for (int i = 0; i < N; ++i) m.p[i] = o.p[i] + w;
  m.fs = (size_t)nx * ny;
  return m;
}

// The block's chunk [xa, xb), first output column y0 and member, from
// the 1D grid: member slowest, then the x chunk, the y strip fastest.
struct Strip {
  int xa, xb, y0;
  size_t member;
};

template <class K>
__device__ __forceinline__ Strip strip_of(int nx, int ny) {
  const unsigned nty = (ny + K::TY - 1) / K::TY;
  const unsigned per_member = nty * ((nx + K::LX - 1) / K::LX);
  const unsigned member = blockIdx.x / per_member;
  const unsigned r = blockIdx.x - member * per_member;
  const int xa = (int)(r / nty) * K::LX;
  return Strip{xa, xa + K::LX < nx ? xa + K::LX : nx, (int)(r % nty) * K::TY,
               (size_t)member};
}

// Policy K's kernel on its block's strip and chunk.  A step lands the TX
// rows below the window (the chunk's first step also its 2*SW warm-up
// rows): its first threads fill the table of where each landing row
// lies, then every thread evaluates landing points (each once, in
// parallel over the block) into the ring; the 2*SW rows above them stay
// from the step before.  Then each thread computes the rows of output
// points of the step's TX rows.  Window row k of the step at x0 is grid
// row x0 - SW + k, in ring slot (rb + k) mod MR.  The wrapped y offsets
// of the evaluated columns are computed once per block and a grid row
// wraps (or, in the halo-slab build, picks lo, the slab or hi) where it
// lands: no % in the march.
template <class K, bool HALO>
__device__ __forceinline__ void march_body(const float* __restrict__ sc,
                                           Operands<K::NOP> o,
                                           const float* __restrict__ b,
                                           float* __restrict__ out, int nx,
                                           int ny) {
  using R = Ring<K>;
  constexpr int NOP = K::NOP, NARR = K::NARR, MHY = R::MHY, MR = R::MR;
  R& sm = *reinterpret_cast<R*>(ksfd_smem);
  const Strip st = strip_of<K>(nx, ny);
  const size_t plane = (size_t)nx * ny;
  // one member in a halo-slab build: its pointers stay the parameters
  if (!HALO) {
    const size_t m = st.member * DOF * plane;
#pragma unroll
    for (int i = 0; i < NOP; ++i) o.p[i] += m;
    out += m;
    if (K::OWN) b += m;
    sc += st.member * K::NSC;
  }
  float s[K::NSC];
#pragma unroll
  for (int i = 0; i < K::NSC; ++i) s[i] = sc[i];
  const int xa = st.xa, xb = st.xb, y0 = st.y0;
  for (int c = threadIdx.x; c < MHY; c += K::NT)
    sm.col[c] = wrap(y0 - SW + c, ny);
  int rb = 0;  // the ring slot of window row 0
  for (int x0 = xa; x0 < xb; x0 += K::TX) {
    const int nrow = xb - x0 < K::TX ? xb - x0 : K::TX;
    const int k0 = x0 == xa ? 0 : 2 * SW;
    const int nk = nrow + 2 * SW - k0;
    // where the landing rows lie (the step before is past its loads)
    for (int kk = threadIdx.x; kk < nk; kk += K::NT) {
      const MRow<NOP> rw = row_of<HALO>(x0 - SW + k0 + kk, o, nx, ny);
#pragma unroll
      for (int i = 0; i < NOP; ++i) sm.rp[kk][i] = rw.p[i];
      sm.rfs[kk] = rw.fs;
    }
    // the step before is done with the ring (and the table is in)
    __syncthreads();
    for (int i = threadIdx.x; i < nk * MHY; i += K::NT) {
      const int kk = i / MHY, c = i - kk * MHY, k = k0 + kk;
      const int col = sm.col[c];
      const size_t fs = sm.rfs[kk];
      float raw[NOP * DOF], val[NARR];
#pragma unroll
      for (int q = 0; q < DOF; ++q) {
#pragma unroll
        for (int op = 0; op < NOP; ++op)
          raw[op * DOF + q] = sm.rp[kk][op][col + q * fs];
      }
      K::point(raw, val, s);
      const int sl = rb + k < MR ? rb + k : rb + k - MR;
#pragma unroll
      for (int a = 0; a < NARR; ++a) sm.ring[sl][a][c] = val[a];
    }
    __syncthreads();
    // a thread's outputs: a run of RX consecutive rows of one column, so
    // that neighbouring outputs share their x windows' loads (a full run
    // is unrolled, and the compiler keeps a loaded value for the next)
    const int nrun = (nrow + K::RX - 1) / K::RX;
    for (int i = threadIdx.x; i < nrun * K::TY; i += K::NT) {
      const int kr = i / K::TY, ty = i - kr * K::TY, y = y0 + ty;
      if (y >= ny) continue;
      const int kx0 = kr * K::RX;
      // output row kx: window row k in ring slot (rb + kx + k) mod MR
      const auto at = [&](int kx) {
        At a;
        a.base = &sm.ring[0][0][ty + SW];
        a.as = MHY;
#pragma unroll
        for (int k = 0; k < MW; ++k) {
          const int sl = rb + kx + k < MR ? rb + kx + k : rb + kx + k - MR;
          a.xs[k] = sl * NARR * MHY;
        }
        return a;
      };
      const size_t g = (size_t)(x0 + kx0) * ny + y;
      if (kx0 + K::RX <= nrow) {
#pragma unroll
        for (int r = 0; r < K::RX; ++r)
          K::row(at(kx0 + r), s, o, b, out, g + (size_t)r * ny, plane);
      } else {
        for (int r = 0; kx0 + r < nrow; ++r)
          K::row(at(kx0 + r), s, o, b, out, g + (size_t)r * ny, plane);
      }
    }
    rb = rb + nrow < MR ? rb + nrow : rb + nrow - MR;
  }
}

// -- the kernels --------------------------------------------------------------
template <bool RESID>
__global__ void KSFD_BOUNDS(Jvp<RESID>)
jvp_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ b,
           float* __restrict__ out, int nx, int ny) {
  march_body<Jvp<RESID>, false>(sc, Operands<2>{{u, v}, {}, {}}, b, out, nx,
                                ny);
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
                float* __restrict__ out, int nx, int ny) {
  march_body<Jvp<RESID>, true>(
      sc, Operands<2>{{u, v}, {u_lo, v_lo}, {u_hi, v_hi}}, b, out, nx, ny);
}

__global__ void KSFD_BOUNDS(Delta)
delta_kernel(const float* __restrict__ sc, const float* __restrict__ u0,
             const float* __restrict__ d, const float* __restrict__ u1,
             float* __restrict__ out, int nx, int ny) {
  march_body<Delta, false>(sc, Operands<3>{{u0, d, u1}, {}, {}}, nullptr,
                           out, nx, ny);
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
                  int nx, int ny) {
  march_body<Delta, true>(sc,
                          Operands<3>{{u0, d, u1},
                                      {u0_lo, d_lo, u1_lo},
                                      {u0_hi, d_hi, u1_hi}},
                          nullptr, out, nx, ny);
}

__global__ void KSFD_BOUNDS(Rhs)
rhs_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           float* __restrict__ out, int nx, int ny) {
  march_body<Rhs, false>(sc, Operands<1>{{u}, {}, {}}, nullptr, out, nx, ny);
}

// B9: one rank's slab with its halo rows (one member)
__global__ void KSFD_BOUNDS(Rhs)
rhs_halo_kernel(const float* __restrict__ sc, const float* __restrict__ u,
                const float* __restrict__ u_lo,
                const float* __restrict__ u_hi, float* __restrict__ out,
                int nx, int ny) {
  march_body<Rhs, true>(sc, Operands<1>{{u}, {u_lo}, {u_hi}}, nullptr, out,
                        nx, ny);
}

// Launch geometry of each kernel (a halo-slab build has its kernel's):
// blocks for nb members, threads and bytes of shared memory per block
// (the march's dynamic ring; coeff_resid's static tile).
enum { KSFD_JVP = 0, KSFD_RESID = 1, KSFD_DELTA = 2, KSFD_RHS = 3,
       KSFD_COEFF_RESID = 4 };

template <class K>
long long blocks_of(int nx, int ny, int nb) {
  return (long long)nb * ((ny + K::TY - 1) / K::TY) *
         ((nx + K::LX - 1) / K::LX);
}

long long grid_blocks(int which, int nx, int ny, int nb) {
  switch (which) {
    case KSFD_JVP: return blocks_of<Jvp<false>>(nx, ny, nb);
    case KSFD_RESID: return blocks_of<Jvp<true>>(nx, ny, nb);
    case KSFD_DELTA: return blocks_of<Delta>(nx, ny, nb);
    case KSFD_RHS: return blocks_of<Rhs>(nx, ny, nb);
  }
  return (long long)nb * ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
}

constexpr size_t smem_bytes(int which) {
  return which == KSFD_JVP     ? sizeof(Ring<Jvp<false>>)
         : which == KSFD_RESID ? sizeof(Ring<Jvp<true>>)
         : which == KSFD_DELTA ? sizeof(Ring<Delta>)
         : which == KSFD_RHS   ? sizeof(Ring<Rhs>)
                               : 4 * (4 + NLA) * (size_t)HN;
}

constexpr int block_threads(int which) {
  return which == KSFD_JVP     ? Jvp<false>::NT
         : which == KSFD_RESID ? Jvp<true>::NT
         : which == KSFD_DELTA ? Delta::NT
         : which == KSFD_RHS   ? Rhs::NT
                               : NT;
}

constexpr size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// the most any march takes, in 4-byte words (a host harness sizes its
// ksfd_smem by it)
constexpr size_t SMEM_FLOATS_MAX =
    larger(larger(smem_bytes(KSFD_JVP), smem_bytes(KSFD_RESID)),
           larger(smem_bytes(KSFD_DELTA), smem_bytes(KSFD_RHS))) / 4;
static_assert(SMEM_FLOATS_MAX * 4 <= 227 * 1024,
              "march ring too large for shared memory");

#ifdef __CUDACC__
// The march's ring is dynamic shared memory: above the 48 KB default a
// kernel has to be opted in first.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

// Launch march kernel `which` for nb members on one 1D grid (at most
// 2^31 - 1 blocks), the members slowest.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int which, int nx, int ny, int nb, void* stream,
           Args... args) {
  const long long blocks = grid_blocks(which, nx, ny, nb);
  if (nb < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(which);
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, block_threads(which), smem,
           (cudaStream_t)stream>>>(args..., nx, ny);
  return (int)cudaGetLastError();
}

// resident blocks per SM of a kernel at its threads and dynamic shared
// memory (none for the tile); -1 if the runtime cannot tell
template <typename Kernel>
int occupancy(Kernel kernel, int which, int dynamic) {
  int n = 0;
  if (opt_in(kernel, dynamic) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, block_threads(which), dynamic) != cudaSuccess)
    return -1;
  return n;
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" {

// nb: members (>= 1; coeff_resid: at most 65535, gridDim.z's limit)
int ksfd_rhs(const float* sc, const float* u, float* out, int nx, int ny,
             int nb, void* stream) {
  return launch(rhs_kernel, KSFD_RHS, nx, ny, nb, stream, sc, u, out);
}

int ksfd_jvp(const float* sc, const float* u, const float* v, float* out,
             int nx, int ny, int nb, void* stream) {
  return launch(jvp_kernel<false>, KSFD_JVP, nx, ny, nb, stream, sc, u, v,
                (const float*)nullptr, out);
}

int ksfd_resid(const float* sc, const float* u, const float* v,
               const float* b, float* out, int nx, int ny, int nb,
               void* stream) {
  return launch(jvp_kernel<true>, KSFD_RESID, nx, ny, nb, stream, sc, u, v,
                b, out);
}

int ksfd_delta(const float* sc, const float* u0, const float* d,
               const float* u1, float* out, int nx, int ny, int nb,
               void* stream) {
  return launch(delta_kernel, KSFD_DELTA, nx, ny, nb, stream, sc, u0, d, u1,
                out);
}

int ksfd_coeff_resid(const float* sc, const float* C, const float* v,
                     const float* b, float* out, int nx, int ny, int nb,
                     void* stream) {
  coeff_resid_kernel<<<dim3((ny + TY - 1) / TY, (nx + TX - 1) / TX, nb), NT,
                       0, (cudaStream_t)stream>>>(sc, C, v, b, out, nx, ny);
  return (int)cudaGetLastError();
}

// B9, the halo-slab entries: one rank's slab of nx rows (>= SW), each
// stencil operand X followed by its lo and hi rows ((DOF, SW, ny)
// each); one member
int ksfd_rhs_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, float* out, int nx, int ny,
                  void* stream) {
  return launch(rhs_halo_kernel, KSFD_RHS, nx, ny, 1, stream, sc, u, u_lo,
                u_hi, out);
}

int ksfd_jvp_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, const float* v, const float* v_lo,
                  const float* v_hi, float* out, int nx, int ny,
                  void* stream) {
  return launch(jvp_halo_kernel<false>, KSFD_JVP, nx, ny, 1, stream, sc, u,
                u_lo, u_hi, v, v_lo, v_hi, (const float*)nullptr, out);
}

int ksfd_resid_halo(const float* sc, const float* u, const float* u_lo,
                    const float* u_hi, const float* v, const float* v_lo,
                    const float* v_hi, const float* b, float* out, int nx,
                    int ny, void* stream) {
  return launch(jvp_halo_kernel<true>, KSFD_RESID, nx, ny, 1, stream, sc, u,
                u_lo, u_hi, v, v_lo, v_hi, b, out);
}

int ksfd_delta_halo(const float* sc, const float* u0, const float* u0_lo,
                    const float* u0_hi, const float* d, const float* d_lo,
                    const float* d_hi, const float* u1, const float* u1_lo,
                    const float* u1_hi, float* out, int nx, int ny,
                    void* stream) {
  return launch(delta_halo_kernel, KSFD_DELTA, nx, ny, 1, stream, sc, u0,
                u0_lo, u0_hi, d, d_lo, d_hi, u1, u1_lo, u1_hi, out);
}

// resident blocks per SM of kernel `which` (KSFD_JVP 0 .. KSFD_RHS 3,
// KSFD_COEFF_RESID 4), unsharded (halo 0) or its halo-slab build (halo
// 1, none for coeff_resid); -1 if the runtime cannot tell
int ksfd_occupancy(int which, int halo) {
  const int smem = (int)smem_bytes(which);
  switch (which + 8 * (halo != 0)) {
    case KSFD_JVP: return occupancy(jvp_kernel<false>, which, smem);
    case KSFD_RESID: return occupancy(jvp_kernel<true>, which, smem);
    case KSFD_DELTA: return occupancy(delta_kernel, which, smem);
    case KSFD_RHS: return occupancy(rhs_kernel, which, smem);
    case KSFD_COEFF_RESID: return occupancy(coeff_resid_kernel, which, 0);
    case 8 + KSFD_JVP: return occupancy(jvp_halo_kernel<false>, which, smem);
    case 8 + KSFD_RESID: return occupancy(jvp_halo_kernel<true>, which, smem);
    case 8 + KSFD_DELTA: return occupancy(delta_halo_kernel, which, smem);
    case 8 + KSFD_RHS: return occupancy(rhs_halo_kernel, which, smem);
  }
  return -1;
}

}  // extern "C"
#endif

// The launch geometry, in the nvcc build and in a host build alike:
// blocks of kernel `which` (KSFD_JVP 0, KSFD_RESID 1, KSFD_DELTA 2,
// KSFD_RHS 3: the march's 1D grid; KSFD_COEFF_RESID 4: the tiles) for nb
// members, its threads and its bytes of shared memory per block.
extern "C" {
long long ksfd_blocks(int which, int nx, int ny, int nb) {
  return grid_blocks(which, nx, ny, nb);
}
int ksfd_threads(int which) { return block_threads(which); }
int ksfd_smem_bytes(int which) { return (int)smem_bytes(which); }
}  // extern "C"
