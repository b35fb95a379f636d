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
// it.  For jvp and resid no single part sets the time either
// (tools/probe_stencil2d.py; PERF.md, section 6): dropping the
// pointwise evaluations (three logf, a tanhf, three divisions a point),
// the star-stencil rows or the loads' address arithmetic each saves a
// fifth to a third of jvp's time.  At 1024^2 the march's 512 blocks are
// one wave (132 SMs x 5), so a launch lasts as long as one block's
// chain of dependent phases: per step a round trip to memory for the
// landing rows, their evaluation, a barrier, the rows.  resid adds a
// second round trip per step, for b and v at the outputs, and that is
// all of its time over jvp (the probe's no_output_reads); reading them
// before the barrier or prefetching b into L2 at the step's start was
// slower (early_reads, b_prefetch).
//
// Two designs.  rhs, delta and coeff_resid run one block per TX x TY
// tile: the block reads its inputs with an SW-wide halo straight from
// global memory by periodic index arithmetic (no padded copy),
// evaluates G / dG.v / G_delta ONCE per halo point into shared memory
// (the halo costs (TX+2SW)(TY+2SW)/(TX*TY) = 1.33x pointwise work at
// 16x64, SW=2), then applies the star stencils from shared memory.  jvp
// and resid march along x (march_body below): a block walks a chunk of
// 32 rows of a 64-column strip in steps of 16 rows, and the 2*SW
// evaluated rows that two steps share stay in a ring in shared memory,
// so a point is evaluated 1.20x an output (1.33x for the tile), with no
// % outside the block's setup.  On an H100 80GB HBM3 at 700 W they take
// about 25 us (jvp) and 30 us (resid) at 1024^2 x 3, 0.45 and 0.51 of
// the byte bound, against 30.3 and 33.4 us for the tile body on the
// same header (PERF.md, section 6, with the geometries tried: a march
// of single rows with the x window in registers and cp.async loads took
// 44-54 us, too few warps per SM to hide a step's latency).  Threads
// run along the contiguous y axis, so global reads and writes coalesce
// and shared-memory reads are conflict free; a strip starts on a
// 256-byte line (60-column strips took 25 % longer).
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
// returns cudaGetLastError().
//
// Member-batched builds (pallas_stencil.py:523-535, B8): every entry
// takes a member count nb >= 1 and launches one grid of nb x the tiles,
// the member on blockIdx.z (the march: one 1D grid, the member slowest,
// then the x chunk, the y strip fastest).  Operands are contiguous (nb,
// planes, nx, ny) and the scalar pack is (nb, k), one row per member, as the
// batched Pallas build reads scv(sc_ref, b, j) (pallas_stencil.py:530).
// A block adds member * planes * nx * ny to its pointers and member * k
// to the pack, and nothing else changes: the arithmetic of a member is
// that of a single launch, so a batched launch equals nb single
// launches bit for bit, and nb = 1 is the single-member kernel.
//
// Halo-slab builds (B9, the sharded builds of pallas_stencil.py: pad_x
// :718-735, shardwrap :737-755, padded_src :539): ksfd_<name>_halo runs
// the same kernel on one rank's local x-slab (nx = the slab's rows).
// Each operand that the stencil reads comes as the slab plus its lo and
// hi halo buffers, the SW rows below and above it from the ring
// neighbours, each a contiguous (DOF, SW, ny) block; a halo row index r
// in [-SW, nx + SW) reads lo, the slab or hi in place of wrap(r, nx) (the
// march picks the part once per row, as it wraps a row once).  y
// still wraps inside the slab; resid's b and the own-point reads need no
// halo.  The TPU build pads every operand into a fresh array (pad_x's
// concatenate, a full HBM copy of each operand per call); here the
// block's halo loads read the halo buffers where they lie, so the only
// extra traffic is the 2 * SW rows.  The halo depth is SW rows, not the
// TPU's 8-row DMA unit (_halo_rows :316).  A halo-slab launch has no
// member axis (a batched build is never sharded, pallas_stencil.py:526),
// and its arithmetic per point is the unsharded kernel's, so the
// stitched slabs equal one unsharded launch bit for bit under one scalar
// pack.  The bodies are shared: each __global__ entry instantiates one
// with HALO false (the unsharded and member-batched build, unchanged) or
// true.
//
// Without __CUDACC__ (a host C++ compiler with the CUDA qualifiers
// defined away, KSFD_NT=1 and one thread walking each block) the kernel
// bodies compile as plain C++; tests/test_torch_kernels.py runs them so
// on the CPU, launching the march's 1D grid as ksfd_blocks exports it.
// The launching C entries exist only in the nvcc build; the geometry
// (ksfd_blocks, ksfd_threads, ksfd_smem_bytes) in both.

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
// the march's threads and the resident blocks per SM that ptxas sizes
// its registers for
#ifdef __CUDACC__
#define KSFD_MARCH_BOUNDS __launch_bounds__(March::NT, March::MINB)
#else
#define KSFD_MARCH_BOUNDS
#endif

namespace {

constexpr int SW = KSFD_SW;
constexpr int DOF = KSFD_DOF;
constexpr int NL = DOF - 1;           // ligand fields
constexpr int NLA = NL > 0 ? NL : 1;  // arrays kept for them (never 0)
// the tile of rhs, delta and coeff_resid
constexpr int TX = 16;                // tile rows (x)
constexpr int TY = 64;                // tile columns (y, contiguous)
constexpr int NT = KSFD_THREADS(256); // threads per block
constexpr int HX = TX + 2 * SW;
constexpr int HY = TY + 2 * SW;
constexpr int HN = HX * HY;
// shared arrays per halo point: rhs 2 + NL, delta 4 + NL, coeff_resid
// 4 + NL
static_assert((4 + NL) * HN * 4 <= 48 * 1024, "tile too large for static shared memory");
// scalar pack lengths, the row stride of a batched pack
constexpr int SC_RHS = 2 * DOF + 1;  // t, means, G(means), reactions
constexpr int SC_JVP = 1;            // t
constexpr int SC_RESID = 2;          // t, shift
constexpr int SC_DELTA = 3;          // t, rho_mean, G0_mean
// coefficient planes of coeff_resid: rho_g, G, dG'_0..dG'_{DOF-1},
// maskpack (tools/probe_coeff_kernel.py:183-205)
constexpr int NC = DOF + 3;
// coeff_resid reads NC + DOF planes per halo point (9 at DOF = 3).
// Staged raw they would need (NC + DOF) * HN * 4 B of shared memory,
// 48,960 B at DOF = 3 with the 16x64 tile, over the 48 KB static
// limit.  It folds them as it loads them into the 4 + NL arrays of
// B1's rows (rho, G, dG.v and the DOF masked tangents: 32,640 B at
// DOF = 3), so the assert above covers it.

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Where halo point (r, y) of a tile reads an operand: ``part`` 1 is the
// operand itself at in-plane offset ``g`` with one field's plane
// ``plane``; in the halo-slab build rows below 0 are in lo (part 0) and
// rows at or past nx in hi (part 2), whose planes are SW rows.
struct Rows {
  int part;
  size_t g, plane;
};

template <bool HALO>
__device__ __forceinline__ Rows rows_at(int r, int y, int nx, int ny) {
  const int yy = wrap(y, ny);
  if (!HALO) return Rows{1, (size_t)wrap(r, nx) * ny + yy, (size_t)nx * ny};
  if (r < 0) return Rows{0, (size_t)(r + SW) * ny + yy, (size_t)SW * ny};
  // a ragged last tile's box reaches past the halo: rows no output
  // reads, loaded from hi's last row so that every read stays in hi
  if (r >= nx)
    return Rows{2, (size_t)(r - nx < SW ? r - nx : SW - 1) * ny + yy,
                (size_t)SW * ny};
  return Rows{1, (size_t)r * ny + yy, (size_t)nx * ny};
}

// The base of the part that w reads: the operand p, or its lo or hi.
template <bool HALO>
__device__ __forceinline__ const float* part(const float* p, const float* lo,
                                             const float* hi, const Rows& w) {
  return !HALO || w.part == 1 ? p : (w.part == 0 ? lo : hi);
}

__device__ __forceinline__ float lap(const float* p) {
  return ksfd_d2x(p, HY) + ksfd_d2y(p, 1);
}

__device__ __forceinline__ float graddot(const float* a, const float* b) {
  return ksfd_d1x(a, HY) * ksfd_d1x(b, HY) + ksfd_d1y(a, 1) * ksfd_d1y(b, 1);
}

// The full centred RHS of the float32 fast mode (no sources: the
// wrapper adds them).  u is the RAW state (groomed here).
// sc = [t, mean_0 .. mean_{DOF-1}, G(means), react_1 .. react_NL]
// (t is unused: the generated G carries no time dependence).
template <bool HALO>
__device__ __forceinline__ void rhs_body(
    const float* __restrict__ sc, const float* __restrict__ u,
    const float* __restrict__ u_lo, const float* __restrict__ u_hi,
    float* __restrict__ out, int nx, int ny) {
  __shared__ float s_rc[HN], s_Gc[HN];
  __shared__ float s_Uc[NL > 0 ? NL : 1][HN];
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)nx * ny;
  const size_t member = blockIdx.z * (size_t)DOF * plane;
  sc += blockIdx.z * SC_RHS;
  u += member;
  out += member;
  const float rho_mean = sc[1], G_mean = sc[1 + DOF];

  for (int i = threadIdx.x; i < HN; i += NT) {
    const int hx = i / HY, hy = i - hx * HY;
    const Rows w = rows_at<HALO>(x0 + hx - SW, y0 + hy - SW, nx, ny);
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
    for (int l = 0; l < NL; ++l) s_Uc[l][i] = f[1 + l] - sc[2 + l];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * TY; i += NT) {
    const int ix = i / TY, iy = i - ix * TY;
    const int gx = x0 + ix, gy = y0 + iy;
    if (gx >= nx || gy >= ny) continue;
    const int c = (ix + SW) * HY + (iy + SW);
    const size_t g = (size_t)gx * ny + gy;
    // the uncentred groomed rho at the output point
    const float raw = u[g];
    const float rho = raw >= KSFD_RHOMIN ? raw : KSFD_RHOMIN;
    const float rc = s_rc[c];
    out[g] = graddot(&s_rc[c], &s_Gc[c]) + rho * lap(&s_Gc[c]);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      out[(1 + l) * plane + g] = -ksfd_gamma(l) * s_Uc[l][c] +
                                 ksfd_s(l) * rc + sc[2 + DOF + l] +
                                 ksfd_D(l) * lap(&s_Uc[l][c]);
    }
  }
}

__global__ void __launch_bounds__(NT)
rhs_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           float* __restrict__ out, int nx, int ny) {
  rhs_body<false>(sc, u, nullptr, nullptr, out, nx, ny);
}

// B9: one rank's slab with its halo rows (no member axis)
__global__ void __launch_bounds__(NT)
rhs_halo_kernel(const float* __restrict__ sc, const float* __restrict__ u,
                const float* __restrict__ u_lo,
                const float* __restrict__ u_hi, float* __restrict__ out,
                int nx, int ny) {
  rhs_body<true>(sc, u, u_lo, u_hi, out, nx, ny);
}

// The rows of _jvp_rows (pallas_stencil.py:613) from the staged halo
// arrays of a tile (rho, G, dG.v and the masked tangents) into out, and
// with RESID the fused Richardson residual b - shift*v + J(u)v: B11's
// rows, summed as the march's jvp_rows below.
template <bool RESID>
__device__ __forceinline__ void jvp_rows_out(
    const float* s_rho, const float* s_G, const float* s_dG,
    const float* s_vr, const float (*s_vU)[HN], float shift,
    const float* __restrict__ v, const float* __restrict__ b,
    float* __restrict__ out, int x0, int y0, int nx, int ny) {
  const size_t plane = (size_t)nx * ny;
  for (int i = threadIdx.x; i < TX * TY; i += NT) {
    const int ix = i / TY, iy = i - ix * TY;
    const int gx = x0 + ix, gy = y0 + iy;
    if (gx >= nx || gy >= ny) continue;
    const int c = (ix + SW) * HY + (iy + SW);
    const size_t g = (size_t)gx * ny + gy;
    const float vr = s_vr[c];
    float row = graddot(&s_vr[c], &s_G[c]) + graddot(&s_rho[c], &s_dG[c]) +
                vr * lap(&s_G[c]) + s_rho[c] * lap(&s_dG[c]);
    out[g] = RESID ? b[g] - shift * v[g] + row : row;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      row = -ksfd_gamma(l) * s_vU[l][c] + ksfd_s(l) * vr +
            ksfd_D(l) * lap(&s_vU[l][c]);
      const size_t gl = (1 + l) * plane + g;
      out[gl] = RESID ? b[gl] - shift * v[gl] + row : row;
    }
  }
}

// B11: jvp_kernel<true> fed from precomputed float32 coefficient fields
// C = [rho_g, G, dG'_0..dG'_{DOF-1}, maskpack] (NC planes), with no
// pointwise transcendental (tools/probe_coeff_kernel.py:114-161).  The
// dG'_i are already masked (zero where field i's clamp is active), so
// dG = sum_i dG'_i * v_i takes the raw tangent; the masked tangents of
// the rows come from maskpack's bits (bit i: u_i above its floor).
// sc = [t, shift].
__global__ void __launch_bounds__(NT)
coeff_resid_kernel(const float* __restrict__ sc, const float* __restrict__ C,
                   const float* __restrict__ v, const float* __restrict__ b,
                   float* __restrict__ out, int nx, int ny) {
  __shared__ float s_rho[HN], s_G[HN], s_dG[HN], s_vr[HN];
  __shared__ float s_vU[NL > 0 ? NL : 1][HN];
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)nx * ny;
  const size_t member = blockIdx.z * (size_t)DOF * plane;
  sc += blockIdx.z * SC_RESID;
  C += blockIdx.z * (size_t)NC * plane;
  v += member;
  b += member;
  out += member;

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

  jvp_rows_out<true>(s_rho, s_G, s_dG, s_vr, s_vU, sc[1], v, b, out, x0, y0,
                     nx, ny);
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
    float* __restrict__ out, int nx, int ny) {
  __shared__ float s_d0[HN], s_Gs[HN], s_r0c[HN], s_dG[HN];
  __shared__ float s_dU[NL > 0 ? NL : 1][HN];
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)nx * ny;
  const size_t member = blockIdx.z * (size_t)DOF * plane;
  sc += blockIdx.z * SC_DELTA;
  u0 += member;
  d += member;
  u1 += member;
  out += member;
  const float rho_mean = sc[1], G_mean = sc[2];

  for (int i = threadIdx.x; i < HN; i += NT) {
    const int hx = i / HY, hy = i - hx * HY;
    const Rows w = rows_at<HALO>(x0 + hx - SW, y0 + hy - SW, nx, ny);
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
    for (int l = 0; l < NL; ++l) s_dU[l][i] = dd[1 + l];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * TY; i += NT) {
    const int ix = i / TY, iy = i - ix * TY;
    const int gx = x0 + ix, gy = y0 + iy;
    if (gx >= nx || gy >= ny) continue;
    const int c = (ix + SW) * HY + (iy + SW);
    const size_t g = (size_t)gx * ny + gy;
    const float drho = s_d0[c];
    out[g] = graddot(&s_d0[c], &s_Gs[c]) + graddot(&s_r0c[c], &s_dG[c]) +
             drho * lap(&s_Gs[c]) + u0[g] * lap(&s_dG[c]);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      out[(1 + l) * plane + g] = -ksfd_gamma(l) * s_dU[l][c] +
                                 ksfd_s(l) * drho +
                                 ksfd_D(l) * lap(&s_dU[l][c]);
    }
  }
}

__global__ void __launch_bounds__(NT)
delta_kernel(const float* __restrict__ sc, const float* __restrict__ u0,
             const float* __restrict__ d, const float* __restrict__ u1,
             float* __restrict__ out, int nx, int ny) {
  delta_body<false>(sc, u0, nullptr, nullptr, d, nullptr, nullptr, u1,
                    nullptr, nullptr, out, nx, ny);
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
                  int nx, int ny) {
  delta_body<true>(sc, u0, u0_lo, u0_hi, d, d_lo, d_hi, u1, u1_lo, u1_hi,
                   out, nx, ny);
}

// -- the march of jvp and resid ---------------------------------------------
// A block owns the TY output columns [y0, y0 + TY) of one member and
// marches down a chunk [xa, xb) of up to LX rows in steps of TX rows.  A
// ring of TX + 2*SW rows of the pointwise arrays (rho, G, dG.v, v_rho,
// v_U[NL]) over the TY + 2*SW evaluated columns (the y halo) lives in
// shared memory.  A step evaluates the TX rows that land below the
// window (the chunk's first step also its 2*SW warm-up rows), each
// point once and in parallel over the block's threads; the 2*SW rows
// below them stay in the ring from the step before.  Then each thread
// computes the rows of output points of the step's TX rows: the x
// stencils gather a point's 2*SW + 1 window values in x order, the y
// stencils read the centre row.  Evaluations per output:
// (LX + 2*SW)/LX * (TY + 2*SW)/TY, 1.20 here.  With LX = TX the march
// is the tile of rhs and delta; with TX = 1 a march of single rows.  A
// step's landing rows find u and v through a table of row bases that
// its first threads fill (row_of), so a point's loads cost no row
// arithmetic.  Geometry, chosen by timing on the H100
// (tools/probe_stencil2d.py; PERF.md, section 6): 256 threads and 5
// blocks per SM (48 registers; at 3 blocks resid took 67 registers and
// 3 blocks per SM, 37.8 us against 29.8 at 1024^2 x 3).
struct March {
  static constexpr int TY = 64, TX = 16, LX = 32, NT = KSFD_THREADS(256), MINB = 5;
};
constexpr int MTY = March::TY;
constexpr int MTX = March::TX;
constexpr int MNT = March::NT;
constexpr int MHY = MTY + 2 * SW;      // evaluated columns of a row
constexpr int MR = MTX + 2 * SW;       // ring rows
constexpr int NARR = 4 + NLA;          // rho, G, dG.v, v_rho, v_U[NL]
constexpr int NRAW = 2 * DOF;          // a point's raw u and v
constexpr int MW = 2 * SW + 1;         // window rows of a stencil
static_assert(MTX >= 1 && March::LX >= MTX, "LX >= TX >= 1");
// a block's shared memory: the ring, where each landing row of a step
// reads u and v (row_of), and the evaluated columns' wrapped y offsets
struct MarchSmem {
  float ring[MR][NARR][MHY];
  const float* ru[MR];
  const float* rv[MR];
  size_t rfs[MR];
  int col[MHY];
};
static_assert(sizeof(MarchSmem) <= 48 * 1024,
              "march ring too large for static shared memory");

// Where row r of u and v lies, with the stride of a field.  Unsharded r
// (in [xa - SW, xb + SW)) wraps; in the halo-slab build rows below 0 are
// in lo and rows at or past nx in hi (SW rows a field).
struct MRow {
  const float* u;
  const float* v;
  size_t fs;
};

template <bool HALO>
__device__ __forceinline__ MRow row_of(int r, const float* u,
                                       const float* u_lo, const float* u_hi,
                                       const float* v, const float* v_lo,
                                       const float* v_hi, int nx, int ny) {
  if (!HALO) {
    while (r < 0) r += nx;
    while (r >= nx) r -= nx;
  } else if (r < 0) {
    const size_t o = (size_t)(r + SW) * ny;
    return MRow{u_lo + o, v_lo + o, (size_t)SW * ny};
  } else if (r >= nx) {
    const size_t o = (size_t)(r - nx) * ny;
    return MRow{u_hi + o, v_hi + o, (size_t)SW * ny};
  }
  const size_t o = (size_t)r * ny;
  return MRow{u + o, v + o, (size_t)nx * ny};
}

// One point's window values (the groom, the tangent mask, G and dG.v)
// from its raw u and v, as the tile body evaluated them.
__device__ __forceinline__ void jvp_point(const float (&raw)[NRAW],
                                          float (&val)[NARR]) {
  float f[DOF], vm[DOF], dg[DOF];
#pragma unroll
  for (int k = 0; k < DOF; ++k) {
    const float lo = k == 0 ? KSFD_RHOMIN : KSFD_UMIN;
    f[k] = raw[k] >= lo ? raw[k] : lo;
    vm[k] = raw[k] > lo ? raw[DOF + k] : 0.0f;
  }
  ksfd_dG(f, dg);
  float dG = dg[0] * vm[0];
#pragma unroll
  for (int k = 1; k < DOF; ++k) dG = dG + dg[k] * vm[k];
  val[0] = f[0];
  val[1] = ksfd_G(f);
  val[2] = dG;
  val[3] = vm[0];
  val[4] = 0.0f;  // with no ligand field, the unused array
#pragma unroll
  for (int l = 0; l < NL; ++l) val[4 + l] = vm[1 + l];
}

// The star stencils of the march: x from a point's window values
// gathered in x order (stride 1), y from the centre row.
__device__ __forceinline__ float lap(const float* xs, const float* p) {
  return ksfd_d2x(xs + SW, 1) + ksfd_d2y(p, 1);
}

__device__ __forceinline__ float graddot(const float* xa, const float* xb,
                                         const float* a, const float* b) {
  return ksfd_d1x(xa + SW, 1) * ksfd_d1x(xb + SW, 1) +
         ksfd_d1y(a, 1) * ksfd_d1y(b, 1);
}

// The DOF rows of output point g from its x window (array a's 2*SW + 1
// values at w[a], in x order) and the centre row cen (array a at
// cen[a * ca], the point at offset 0); with RESID the residual b -
// shift*v + J(u)v from the point's b and raw v.
template <bool RESID>
__device__ __forceinline__ void jvp_rows(const float (&w)[NARR][MW],
                                         const float* cen, int ca,
                                         float shift,
                                         const float* __restrict__ v,
                                         const float* __restrict__ b,
                                         float* __restrict__ out, size_t g,
                                         size_t plane) {
  const float vr = w[3][SW];
  float row = graddot(w[3], w[1], cen + 3 * ca, cen + 1 * ca) +
              graddot(w[0], w[2], cen, cen + 2 * ca) +
              vr * lap(w[1], cen + 1 * ca) + w[0][SW] * lap(w[2], cen + 2 * ca);
  out[g] = RESID ? b[g] - shift * v[g] + row : row;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    row = -ksfd_gamma(l) * w[4 + l][SW] + ksfd_s(l) * vr +
          ksfd_D(l) * lap(w[4 + l], cen + (4 + l) * ca);
    const size_t gl = (1 + l) * plane + g;
    out[gl] = RESID ? b[gl] - shift * v[gl] + row : row;
  }
}

// The block's chunk [xa, xb), first output column y0 and member, from
// the 1D grid: member slowest, then the x chunk, the y strip fastest.
struct Strip {
  int xa, xb, y0;
  size_t member;
};

__device__ __forceinline__ Strip strip_of(int nx, int ny) {
  const unsigned nty = (ny + MTY - 1) / MTY;
  const unsigned per_member = nty * ((nx + March::LX - 1) / March::LX);
  const unsigned member = blockIdx.x / per_member;
  const unsigned r = blockIdx.x - member * per_member;
  const int xa = (int)(r / nty) * March::LX;
  return Strip{xa, xa + March::LX < nx ? xa + March::LX : nx,
               (int)(r % nty) * MTY, (size_t)member};
}

// The J-action rows (with RESID, the fused Richardson residual b -
// shift*v + J(u)v) on the block's strip and chunk.  Window row k of the
// step at x0 is grid row x0 - SW + k, in ring slot (rb + k) mod MR.  The
// wrapped y offsets of the evaluated columns are computed once per block
// and a grid row wraps (or, in the halo-slab build, picks lo, the slab
// or hi) where it is read: no % in the march.  sc = [t] or [t, shift]
// (t is unused: the generated G carries no time dependence).
template <bool RESID, bool HALO>
__device__ __forceinline__ void march_body(
    const float* __restrict__ sc, const float* __restrict__ u,
    const float* __restrict__ u_lo, const float* __restrict__ u_hi,
    const float* __restrict__ v, const float* __restrict__ v_lo,
    const float* __restrict__ v_hi, const float* __restrict__ b,
    float* __restrict__ out, int nx, int ny) {
  __shared__ MarchSmem sm;
  const Strip st = strip_of(nx, ny);
  const size_t plane = (size_t)nx * ny;
  // one member in a halo-slab build: its pointers stay the parameters
  if (!HALO) {
    const size_t m = st.member * DOF * plane;
    u += m;
    v += m;
    out += m;
    if (RESID) b += m;
    sc += st.member * (RESID ? SC_RESID : SC_JVP);
  }
  const float shift = RESID ? sc[1] : 0.0f;
  const int xa = st.xa, xb = st.xb, y0 = st.y0;
  for (int c = threadIdx.x; c < MHY; c += MNT)
    sm.col[c] = wrap(y0 - SW + c, ny);
  int rb = 0;  // the ring slot of window row 0
  for (int x0 = xa; x0 < xb; x0 += MTX) {
    const int nrow = xb - x0 < MTX ? xb - x0 : MTX;
    const int k0 = x0 == xa ? 0 : 2 * SW;
    const int nk = nrow + 2 * SW - k0;
    // where the landing rows lie (the step before is past its loads)
    for (int kk = threadIdx.x; kk < nk; kk += MNT) {
      const MRow rw = row_of<HALO>(x0 - SW + k0 + kk, u, u_lo, u_hi, v,
                                   v_lo, v_hi, nx, ny);
      sm.ru[kk] = rw.u;
      sm.rv[kk] = rw.v;
      sm.rfs[kk] = rw.fs;
    }
    // the step before is done with the ring (and the tables are in)
    __syncthreads();
    for (int i = threadIdx.x; i < nk * MHY; i += MNT) {
      const int kk = i / MHY, c = i - kk * MHY, k = k0 + kk;
      const float* ru = sm.ru[kk] + sm.col[c];
      const float* rv = sm.rv[kk] + sm.col[c];
      const size_t fs = sm.rfs[kk];
      float raw[NRAW], val[NARR];
#pragma unroll
      for (int q = 0; q < DOF; ++q) {
        raw[q] = ru[q * fs];
        raw[DOF + q] = rv[q * fs];
      }
      jvp_point(raw, val);
      const int sl = rb + k < MR ? rb + k : rb + k - MR;
#pragma unroll
      for (int a = 0; a < NARR; ++a) sm.ring[sl][a][c] = val[a];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrow * MTY; i += MNT) {
      const int kx = i / MTY, ty = i - kx * MTY, y = y0 + ty;
      if (y >= ny) continue;
      float w[NARR][MW];
#pragma unroll
      for (int k = 0; k < MW; ++k) {
        const int sl = rb + kx + k < MR ? rb + kx + k : rb + kx + k - MR;
#pragma unroll
        for (int a = 0; a < NARR; ++a) w[a][k] = sm.ring[sl][a][ty + SW];
      }
      const int cs = rb + kx + SW < MR ? rb + kx + SW : rb + kx + SW - MR;
      jvp_rows<RESID>(w, &sm.ring[cs][0][ty + SW], MHY, shift, v, b, out,
                      (size_t)(x0 + kx) * ny + y, plane);
    }
    rb = rb + nrow < MR ? rb + nrow : rb + nrow - MR;
  }
}

template <bool RESID>
__global__ void KSFD_MARCH_BOUNDS
jvp_kernel(const float* __restrict__ sc, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ b,
           float* __restrict__ out, int nx, int ny) {
  march_body<RESID, false>(sc, u, nullptr, nullptr, v, nullptr, nullptr, b,
                           out, nx, ny);
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
                float* __restrict__ out, int nx, int ny) {
  march_body<RESID, true>(sc, u, u_lo, u_hi, v, v_lo, v_hi, b, out, nx, ny);
}

// blocks of the march's 1D grid for nb members
long long march_blocks(int nx, int ny, int nb) {
  return (long long)nb * ((ny + MTY - 1) / MTY) *
         ((nx + March::LX - 1) / March::LX);
}

#ifdef __CUDACC__
dim3 grid_for(int nx, int ny, int nb) {
  return dim3((ny + TY - 1) / TY, (nx + TX - 1) / TX, nb);
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" {

// nb: members (>= 1, at most 65535, gridDim.z's limit)
int ksfd_rhs(const float* sc, const float* u, float* out, int nx, int ny,
             int nb, void* stream) {
  rhs_kernel<<<grid_for(nx, ny, nb), NT, 0, (cudaStream_t)stream>>>(
      sc, u, out, nx, ny);
  return (int)cudaGetLastError();
}

// the march: one 1D grid, members slowest (at most 2^31 - 1 blocks)
int ksfd_jvp(const float* sc, const float* u, const float* v, float* out,
             int nx, int ny, int nb, void* stream) {
  const long long blocks = march_blocks(nx, ny, nb);
  if (nb < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  jvp_kernel<false><<<(unsigned)blocks, MNT, 0, (cudaStream_t)stream>>>(
      sc, u, v, nullptr, out, nx, ny);
  return (int)cudaGetLastError();
}

int ksfd_resid(const float* sc, const float* u, const float* v,
               const float* b, float* out, int nx, int ny, int nb,
               void* stream) {
  const long long blocks = march_blocks(nx, ny, nb);
  if (nb < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  jvp_kernel<true><<<(unsigned)blocks, MNT, 0, (cudaStream_t)stream>>>(
      sc, u, v, b, out, nx, ny);
  return (int)cudaGetLastError();
}

int ksfd_delta(const float* sc, const float* u0, const float* d,
               const float* u1, float* out, int nx, int ny, int nb,
               void* stream) {
  delta_kernel<<<grid_for(nx, ny, nb), NT, 0, (cudaStream_t)stream>>>(
      sc, u0, d, u1, out, nx, ny);
  return (int)cudaGetLastError();
}

int ksfd_coeff_resid(const float* sc, const float* C, const float* v,
                     const float* b, float* out, int nx, int ny, int nb,
                     void* stream) {
  coeff_resid_kernel<<<grid_for(nx, ny, nb), NT, 0,
                       (cudaStream_t)stream>>>(sc, C, v, b, out, nx, ny);
  return (int)cudaGetLastError();
}

// B9, the halo-slab entries: one rank's slab of nx rows (>= SW), each
// stencil operand X followed by its lo and hi rows ((DOF, SW, ny)
// each); one member
int ksfd_rhs_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, float* out, int nx, int ny,
                  void* stream) {
  rhs_halo_kernel<<<grid_for(nx, ny, 1), NT, 0, (cudaStream_t)stream>>>(
      sc, u, u_lo, u_hi, out, nx, ny);
  return (int)cudaGetLastError();
}

int ksfd_jvp_halo(const float* sc, const float* u, const float* u_lo,
                  const float* u_hi, const float* v, const float* v_lo,
                  const float* v_hi, float* out, int nx, int ny,
                  void* stream) {
  jvp_halo_kernel<false>
      <<<(unsigned)march_blocks(nx, ny, 1), MNT, 0, (cudaStream_t)stream>>>(
          sc, u, u_lo, u_hi, v, v_lo, v_hi, nullptr, out, nx, ny);
  return (int)cudaGetLastError();
}

int ksfd_resid_halo(const float* sc, const float* u, const float* u_lo,
                    const float* u_hi, const float* v, const float* v_lo,
                    const float* v_hi, const float* b, float* out, int nx,
                    int ny, void* stream) {
  jvp_halo_kernel<true>
      <<<(unsigned)march_blocks(nx, ny, 1), MNT, 0, (cudaStream_t)stream>>>(
          sc, u, u_lo, u_hi, v, v_lo, v_hi, b, out, nx, ny);
  return (int)cudaGetLastError();
}

int ksfd_delta_halo(const float* sc, const float* u0, const float* u0_lo,
                    const float* u0_hi, const float* d, const float* d_lo,
                    const float* d_hi, const float* u1, const float* u1_lo,
                    const float* u1_hi, float* out, int nx, int ny,
                    void* stream) {
  delta_halo_kernel<<<grid_for(nx, ny, 1), NT, 0, (cudaStream_t)stream>>>(
      sc, u0, u0_lo, u0_hi, d, d_lo, d_hi, u1, u1_lo, u1_hi, out, nx, ny);
  return (int)cudaGetLastError();
}

// resident blocks per SM of kernel `which` (KSFD_JVP 0, KSFD_RESID 1,
// KSFD_DELTA 2, KSFD_RHS 3, KSFD_COEFF_RESID 4), unsharded (halo 0) or
// its halo-slab build (halo 1); -1 if the runtime cannot tell
int ksfd_occupancy(int which, int halo) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (which + 8 * (halo != 0)) {
    case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, jvp_kernel<false>, MNT, 0); break;
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, jvp_kernel<true>, MNT, 0); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, delta_kernel, NT, 0); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, rhs_kernel, NT, 0); break;
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, coeff_resid_kernel, NT, 0); break;
    case 8: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, jvp_halo_kernel<false>, MNT, 0); break;
    case 9: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, jvp_halo_kernel<true>, MNT, 0); break;
    case 10: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, delta_halo_kernel, NT, 0); break;
    case 11: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, rhs_halo_kernel, NT, 0); break;
  }
  return err == cudaSuccess ? n : -1;
}

}  // extern "C"
#endif

// The launch geometry, in the nvcc build and in a host build alike:
// blocks of kernel `which` (KSFD_JVP 0, KSFD_RESID 1: the march's 1D
// grid; KSFD_DELTA 2, KSFD_RHS 3, KSFD_COEFF_RESID 4: the tiles) for nb
// members, its threads and its bytes of static shared memory per block.
extern "C" {
long long ksfd_blocks(int which, int nx, int ny, int nb) {
  if (which < 2) return march_blocks(nx, ny, nb);
  return (long long)nb * ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
}
int ksfd_threads(int which) { return which < 2 ? MNT : NT; }
int ksfd_smem_bytes(int which) {
  return which < 2 ? (int)sizeof(MarchSmem)
                   : 4 * (which == 3 ? 2 + NLA : 4 + NLA) * HN;
}
}  // extern "C"
