// Fused float32 block-preconditioner apply, 2D, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of ksfd_tpu/ops/pallas_pc.py:
//   ksfd_pc_fwd <- fwd_kernel :153 (launched by pl.pallas_call :196):
//                  per field c_f = Qx^T v_f Qy, then the per-mode arrow
//                  inverse (a Schur complement on the rho row, :164-183)
//   ksfd_pc_inv <- inv_kernel :185 (pl.pallas_call :222):
//                  per field out_f = Qx c_f Qy^T
// The wrappers, the basis planes, the scalar pack and the plain PyTorch
// versions are in ops/fused_pc.py.
//
// Bound: operations.  Each entry is two products per field, 2 * nf *
// 2 n^3 flops: 12.9 GFLOP at 1024^2 x 3.  Design: 3xTF32 on the tensor
// cores.  Every operand x is split into hi = tf32(x) (round to nearest,
// ties away: cvt.rna) and lo = tf32(x - hi); a product is
//   A B ~ A_lo B_hi + A_hi B_lo + A_hi B_hi
// in three TF32 wgmma passes (the small terms first), float32-class
// results for 3 x 12.9 GFLOP, 78 us at the H100 SXM's 495 TF32 TFLOP/s
// (against 11 us for the bytes).  The tensor cores' float32 accumulation
// truncates, and summing all of K in one accumulator drifts past
// chip_smoke.py's 1e-5 check at K = 1024: each stage of BK = 32 is summed
// in the tensor cores from zero and added to a running sum in registers,
// rounded to nearest.
//
// Layouts.  A TF32 wgmma reads a shared-memory operand only K-major, so
// each product takes the state-side operand as A (from registers, split
// there) and the basis as B (K-major in shared memory, split once when
// ops/fused_pc.py builds it: a hi and a lo plane, rows padded to a
// multiple of 4 floats).  D = A B^T-stored, i.e. D[m][n] = sum_k
// A[m][k] Bt[n][k], and every product stores D TRANSPOSED:
//   fwd P1: A = v_f (x, y), Bt = Qy^T (ky, y)   -> S^T (ky, x) in tmp
//   fwd P2: A = S^T (ky, x), Bt = Qx^T (kx, x)  -> c (kx, ky), arrow
//   inv P1: A = c_f (kx, ky), Bt = Qy (y, ky)   -> S^T (y, kx) in tmp
//   inv P2: A = S^T (y, kx), Bt = Qx (x, kx)    -> out (x, y)
// so the forward entry computes Qx^T (v Qy) and the inverse Qx (c Qy^T):
// the plain versions' (Qx^T v) Qy re-associated, inside the 1e-5 check.
// P1 runs with M = nx, N = ny, K = ny; P2 with M = ny, N = nx, K = nx.
//
// Kernel (pc_gemm_tc): a block owns a BM x BN = 128 x 64 tile of D for
// NACC planes: 1 for the plain products (the grid walks tiles x fields x
// members), all nf fields of a member for fwd P2 with nf <= MAX_NF = 4,
// whose epilogue is the arrow inverse in registers (it needs every field
// of a mode).  Above MAX_NF fields the epilogue's nf accumulator tiles
// would not fit the 232 registers a consumer thread has (5 x 32 + 32 =
// 192 at nf = 5, past the budget from 6 on): there fwd P2 is a plain
// product into the output and an elementwise pass (pc_arrow_pass) solves
// each mode's arrow in place, reading and writing the nf mode planes
// once more (2 nf n^2 floats: about 13 us at 1024^2 x 5 against some 130
// us of products at the 3xTF32 bound).  Narrower tiles (BN = 32) would
// keep the epilogue at the price of twice the B tile loads per output;
// the pass is the simpler of the two and leaves the products as they
// are for every field count.  Three
// warpgroups: warpgroup 0 (setmaxnreg 40) has one thread issue TMA loads
// of the NACC A tiles and the B hi/lo tiles (BK = 32 floats = 128 B rows,
// 128-byte swizzle, out-of-range boxes zero-filled) into a ring of
// STAGES shared-memory stages, each signalled by a full and an empty
// mbarrier; warpgroups 1 and 2 (setmaxnreg 232) each own 64 rows: per
// stage and field they read their A fragments from shared memory, split
// them, and issue 4 k-steps x 3 wgmma.m64n64k8.tf32 with B from the
// swizzled tile.  Tile shapes, not a persistent scheduler, fill the 132
// SMs: 128 x 64 tiles give 384 blocks per plain product at 1024^2 x 3
// (2.9 waves) and 864 at 1536^2 x 3 (6.5 waves).
//
// Extents.  TMA needs 16-byte row pitches.  The basis planes and tmp are
// pitched by the port; when ny % 4 != 0 (or an operand is not 16-byte
// aligned) the entry first copies its state operand into a pitched part
// of the scratch (pc_gemm_pitch_copy, part of the same call).  Scratch
// (floats): nb nf (ny nxp + nx nyp), nxp and nyp the extents rounded up
// to 4 (ops/fused_pc.py scratch_floats); the wrapper allocates it.
//
// Fields: any nf >= 1.  nf = 1 (no ligand) is the NF = 1 instance, whose
// arrow is x = c0 / (shift - rho_diff lam).
//
// Members: every entry takes nb >= 1; A planes and outputs are (nb, nf,
// ., .) and the scalar pack (nb, 3 + 4 NL); a block's work depends on
// its tile and planes only, so a batched launch equals nb single
// launches bit for bit.  Numerics of the epilogue: each product and sum
// rounds once, as the plain version's separate PyTorch operations do
// (the library builds with -fmad=false).  Every C entry launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Without __CUDACC__ (a host C++20 compiler) the same source builds a
// scalar host path from the shared pieces below: the tile walk, the
// split with TF32 rounding emulated bit for bit, the k-step order of the
// three products, the transposed stores and the arrow epilogue, with
// each wgmma a scalar loop over its k-step.  tests/test_torch_pc.py
// runs it on the CPU (entries ksfd_pc_fwd_host, ksfd_pc_inv_host,
// ksfd_tf32_split).

#include <stddef.h>
#include <stdint.h>
#include <cstring>
#ifdef __CUDACC__
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#define KSFD_HD __host__ __device__ __forceinline__
#else
#define KSFD_HD inline
#endif

namespace {

constexpr int BM = 128;       // tile rows (two consumer warpgroups)
constexpr int BN = 64;        // tile columns (wgmma n)
constexpr int BK = 32;        // floats per stage along K (128-byte rows)
constexpr int KSTEP = 8;      // wgmma k for tf32
constexpr int NTHREADS = 384; // producer + two consumer warpgroups

KSFD_HD int pitch4(int n) { return (n + 3) & ~3; }

// tf32(x): round to nearest, ties away from zero, to 10 mantissa bits,
// in a float32 container (the low 13 bits zero): cvt.rna.tf32.f32.
KSFD_HD float tf32_rna(float x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  float y;
  memcpy(&y, &u, 4);
  return y;
#endif
}

// The split of one operand: hi = tf32(x), lo = x - hi (exact, so hi + lo
// == x); the product reads tf32(lo).
KSFD_HD void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = x - hi;
}

// The work of one product: D (M x N) = A (planes of M x K, row pitch
// lda) times Bt^T (N x K, pitch ldb), stored transposed into planes of
// dst (dst[n * ldd + m], plane stride dst_plane).  A block (unit) is one
// BM x BN tile of one group of NACC consecutive planes.
struct Walk {
  int M, N, K;
  int tiles_m, tiles_n;
  int ldd;
  size_t dst_plane;
  KSFD_HD int units(int groups) const { return groups * tiles_m * tiles_n; }
  KSFD_HD void unit(int u, int& group, int& m0, int& n0) const {
    n0 = (u % tiles_n) * BN;
    u /= tiles_n;
    m0 = (u % tiles_m) * BM;
    group = u / tiles_m;
  }
};

KSFD_HD Walk make_walk(int M, int N, int K, int ldd, size_t dst_plane) {
  Walk w;
  w.M = M; w.N = N; w.K = K;
  w.tiles_m = (M + BM - 1) / BM;
  w.tiles_n = (N + BN - 1) / BN;
  w.ldd = ldd;
  w.dst_plane = dst_plane;
  return w;
}

// The arrow inverse of one mode, the arithmetic of pallas_pc.py:164-183,
// in place on the nf mode values x[f * stride], from sc = [shift,
// rho_diff, rho_mean, dG_1..dG_nl, s_1..s_nl, gamma_1..gamma_nl,
// D_1..D_nl] (one member's row) and lam = lam2d at the mode.  Each inv_d
// is computed again for the back substitution (the same value bit for
// bit).  The fwd epilogue inlines it with nf a constant (1 to MAX_NF =
// 4); the arrow pass above MAX_NF fields runs it with nf at run time.
KSFD_HD void arrow_solve(const float* sc, int nf, float lm, float* x,
                         size_t stride) {
  const int nl = nf - 1;
  const float shift = sc[0], rho_diff = sc[1], rho_mean = sc[2];
  float schur = shift - rho_diff * lm;
  float num = x[0];
  for (int l = 0; l < nl; ++l) {
    const float inv_d = 1.0f / (shift + sc[3 + 2 * nl + l]
                                - sc[3 + 3 * nl + l] * lm);
    const float b_over_d = (-rho_mean * sc[3 + l]) * lm * inv_d;
    schur = schur - b_over_d * (-sc[3 + nl + l]);
    num = num - b_over_d * x[(1 + l) * stride];
  }
  const float x_r = num / schur;
  x[0] = x_r;
  for (int l = 0; l < nl; ++l) {
    const float inv_d = 1.0f / (shift + sc[3 + 2 * nl + l]
                                - sc[3 + 3 * nl + l] * lm);
    x[(1 + l) * stride] = (x[(1 + l) * stride] - (-sc[3 + nl + l]) * x_r)
                          * inv_d;
  }
}

// One output element (m, n) of the tile's group: the plain store of a
// product, or (EPI, fwd P2, m = ky, n = kx) the arrow inverse of all NF
// fields of the mode from lam[n * ldd + m] and the member's pack row.
template <int NF, int NACC, bool EPI>
KSFD_HD void store_element(const Walk& w, int group, int m, int n,
                           const float (&acc)[NACC], float* dst,
                           const float* sc, const float* lam) {
  const size_t g = (size_t)n * w.ldd + m;
  if constexpr (EPI) {
    static_assert(NACC == NF, "the arrow epilogue holds every field");
    float x[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) x[f] = acc[f];
    arrow_solve(sc + (size_t)group * (3 + 4 * (NF - 1)), NF, lam[g], x, 1);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      dst[((size_t)group * NF + f) * w.dst_plane + g] = x[f];
  } else {
#pragma unroll
    for (int f = 0; f < NACC; ++f)
      dst[((size_t)group * NACC + f) * w.dst_plane + g] = acc[f];
  }
}

// The entry's layout: pitches, the A operand of P1 (the state itself or
// its pitched copy in the scratch) and tmp's S^T planes.
struct Plan {
  int nxp, nyp, planes;
  bool direct;          // P1 reads the state as it lies
  float* st;            // S^T planes: planes x ny x nxp
  float* pitched;       // the state's pitched copy: planes x nx x nyp
  int lda1;
};

KSFD_HD Plan make_plan(int nf, int nx, int ny, int nb, float* tmp,
                       bool aligned) {
  Plan p;
  p.nxp = pitch4(nx);
  p.nyp = pitch4(ny);
  p.planes = nb * nf;
  p.direct = aligned && ny % 4 == 0;
  p.st = tmp;
  p.pitched = tmp + (size_t)p.planes * ny * p.nxp;
  p.lda1 = p.direct ? ny : p.nyp;
  return p;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------- card

constexpr int A_TILE_BYTES = BM * BK * 4;       // 16 KB, one plane
constexpr int B_TILE_BYTES = 2 * BN * BK * 4;   // 16 KB, hi and lo planes

template <int NACC>
struct Ring {
  static constexpr int STAGE = NACC * A_TILE_BYTES + B_TILE_BYTES;
  static constexpr int STAGES =
      196608 / STAGE > 6 ? 6 : (196608 / STAGE < 2 ? 2 : 196608 / STAGE);
  // tiles, then the full and empty barriers; +1024 to align the base
  static constexpr int BYTES = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// A wait that outlasts ~2^35 cycles (about 20 s) traps: a fault in the
// ring becomes a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (!start) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), layout type 1.  A k-step
// of 8 floats advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d = a (registers, tf32) * b (descriptor) + (accumulate ? d : 0),
// m64n64k8
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Element (r, k) of a 128-byte-swizzled tile (row r at r * 128 bytes,
// 16-byte chunk c of row r stored at chunk c ^ (r % 8)).
__device__ __forceinline__ float swz_ld(const char* tile, int r, int k) {
  const int off = r * 128 + ((((k >> 2) ^ (r & 7)) << 4) | ((k & 3) << 2));
  return *reinterpret_cast<const float*>(tile + off);
}

template <int NF, int NACC, bool EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
pc_gemm_tc(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b, Walk w, float* dst,
           const float* __restrict__ sc, const float* __restrict__ lam) {
  using R = Ring<NACC>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int group, m0, n0;
  w.unit(blockIdx.x, group, m0, n0);
  const int kt_count = (w.K + BK - 1) / BK;

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < kt_count; ++kt) {
        const int s = kt % R::STAGES;
        mbar_wait(&empty[s], ((kt / R::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], R::STAGE);
        char* st = smem + s * R::STAGE;
#pragma unroll
        for (int f = 0; f < NACC; ++f)
          tma_load_3d(st + f * A_TILE_BYTES, &map_a, kt * BK, m0,
                      group * NACC + f, &full[s]);
        tma_load_3d(st + NACC * A_TILE_BYTES, &map_b, kt * BK, n0, 0,
                    &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;                  // consumer: rows 64 c .. 64 c + 63
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * c + 16 * warp + g; // fragment rows r0 and r0 + 8
    // acc: the running sums, rounded to nearest; part: one stage's sum
    // in the tensor cores, whose float32 accumulation truncates (a
    // bias that grows with the number of k-steps summed in place)
    float acc[NACC][32], part[32];
#pragma unroll
    for (int f = 0; f < NACC; ++f)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[f][i] = 0.f;

    for (int kt = 0; kt < kt_count; ++kt) {
      const int s = kt % R::STAGES;
      mbar_wait(&full[s], (kt / R::STAGES) & 1);
      const char* st = smem + s * R::STAGE;
      const uint64_t b_hi = desc_sw128(st + NACC * A_TILE_BYTES);
      const uint64_t b_lo = desc_sw128(st + NACC * A_TILE_BYTES
                                       + B_TILE_BYTES / 2);
#pragma unroll
      for (int f = 0; f < NACC; ++f) {
        const char* at = st + f * A_TILE_BYTES;
        uint32_t hi[BK / KSTEP][4], lo[BK / KSTEP][4];
#pragma unroll
        for (int ks = 0; ks < BK / KSTEP; ++ks) {
          const int k0 = ks * KSTEP + t;
          const float x[4] = {swz_ld(at, r0, k0), swz_ld(at, r0 + 8, k0),
                              swz_ld(at, r0, k0 + 4),
                              swz_ld(at, r0 + 8, k0 + 4)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float h, l;
            split(x[j], h, l);
            hi[ks][j] = __float_as_uint(h);
            lo[ks][j] = __float_as_uint(tf32_rna(l));
          }
        }
        fence_acc(part);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < BK / KSTEP; ++ks) {
          // 2 = 32 bytes >> 4: one k-step along the 128-byte rows
          wgmma_tf32(part, lo[ks], b_hi + 2 * ks, ks > 0);
          wgmma_tf32(part, hi[ks], b_lo + 2 * ks, 1);
          wgmma_tf32(part, hi[ks], b_hi + 2 * ks, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[f][i] += part[i];
      }
      mbar_arrive(&empty[s]);
    }

    // accumulator layout of m64n64: d[4j + 2h + e] is row 16 warp + g +
    // 8 h, column 8 j + 2 t + e of the warpgroup's 64 x 64 block
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + r0 + 8 * h, n = n0 + 8 * j + 2 * t + e;
          if (m >= w.M || n >= w.N) continue;
          float v[NACC];
#pragma unroll
          for (int f = 0; f < NACC; ++f) v[f] = acc[f][4 * j + 2 * h + e];
          store_element<NF, NACC, EPI>(w, group, m, n, v, dst, sc, lam);
        }
  }
}

// rows of src (pitch ny) into dst (pitch nyp): the state's pitched copy
__global__ void pc_gemm_pitch_copy(const float* __restrict__ src,
                                   float* __restrict__ dst, size_t rows,
                                   int ny, int nyp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * ny) return;
  const size_t r = i / ny;
  dst[r * nyp + (i - r * ny)] = src[i];
}

// The arrow pass above MAX_NF fields: thread i solves mode i % plane of
// member i / plane in place on the (nb, nf, nx, ny) modes.  Bound:
// bytes.
__global__ void pc_arrow_pass(float* __restrict__ modes,
                              const float* __restrict__ sc,
                              const float* __restrict__ lam, int nf,
                              size_t plane, int nb) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane * nb) return;
  const size_t member = i / plane, g = i - member * plane;
  arrow_solve(sc + member * (3 + 4 * (nf - 1)), nf, lam[g],
            modes + member * nf * plane + g, plane);
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// planes of rows x cols floats (row pitch `pitch` floats), boxes of
// BK x box_rows x box_planes with 128-byte swizzle, zero fill outside
bool encode(CUtensorMap* map, const float* base, int cols, int rows,
            int planes, int pitch, int box_rows, int box_planes) {
  auto fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 4,
                                 (cuuint64_t)pitch * 4 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows,
                             (cuuint32_t)box_planes};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)base, dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product: D = A Bt^T over `groups` groups of NACC planes; A planes
// of M x K at pitch lda, Bt the basis's [hi; lo] planes of N x K at
// pitch ldb.
template <int NF, int NACC, bool EPI>
int product(const float* a, int lda, int planes, const float* bt, int ldb,
            const Walk& w, float* dst, const float* sc, const float* lam,
            cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!encode(&ma, a, w.K, w.M, planes, lda, BM, 1)
      || !encode(&mb, bt, w.K, w.N, 2, ldb, BN, 2))
    return (int)cudaErrorInvalidValue;
  auto kernel = pc_gemm_tc<NF, NACC, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<NACC>::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<w.units(planes / NACC), NTHREADS, Ring<NACC>::BYTES, s>>>(
      ma, mb, w, dst, sc, lam);
  return (int)cudaGetLastError();
}

bool aligned16(const float* p) { return (uintptr_t)p % 16 == 0; }

// P1 of both entries: the state (or its pitched copy) times the y basis
// into the S^T planes of tmp
int first_product(const float* state, const float* by, const Plan& p,
                  int nx, int ny, cudaStream_t s) {
  const float* a = state;
  if (!p.direct) {
    const size_t n = (size_t)p.planes * nx * ny;
    pc_gemm_pitch_copy<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        state, p.pitched, (size_t)p.planes * nx, ny, p.nyp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a = p.pitched;
  }
  return product<1, 1, false>(a, p.lda1, p.planes, by, p.nyp,
                              make_walk(nx, ny, ny, p.nxp,
                                        (size_t)ny * p.nxp),
                              p.st, nullptr, nullptr, s);
}

template <int NF>
int fwd(const float* sc, const float* v, const float* bx, const float* by,
        const float* lam, float* tmp, float* out, int nx, int ny, int nb,
        cudaStream_t s) {
  const Plan p = make_plan(NF, nx, ny, nb, tmp, aligned16(v));
  int err = first_product(v, by, p, nx, ny, s);
  if (err) return err;
  // c = arrow^{-1}((S^T Qx)^T): M = ny (ky), N = nx (kx), K = nx
  return product<NF, NF, true>(p.st, p.nxp, p.planes, bx, p.nxp,
                               make_walk(ny, nx, nx, ny, (size_t)nx * ny),
                               out, sc, lam, s);
}

// fwd above MAX_NF fields: P2 as the plain product into out, then the
// arrow pass in place
int fwd_any(const float* sc, const float* v, const float* bx,
            const float* by, const float* lam, float* tmp, float* out,
            int nf, int nx, int ny, int nb, cudaStream_t s) {
  const Plan p = make_plan(nf, nx, ny, nb, tmp, aligned16(v));
  int err = first_product(v, by, p, nx, ny, s);
  if (err) return err;
  err = product<1, 1, false>(p.st, p.nxp, p.planes, bx, p.nxp,
                             make_walk(ny, nx, nx, ny, (size_t)nx * ny),
                             out, nullptr, nullptr, s);
  if (err) return err;
  const size_t n = (size_t)nx * ny * nb;
  pc_arrow_pass<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      out, sc, lam, nf, (size_t)nx * ny, nb);
  return (int)cudaGetLastError();
}

int inv(const float* c, const float* bx, const float* by, float* tmp,
        float* out, int nf, int nx, int ny, int nb, cudaStream_t s) {
  const Plan p = make_plan(nf, nx, ny, nb, tmp, aligned16(c));
  int err = first_product(c, by, p, nx, ny, s);
  if (err) return err;
  // out = (S^T Qx^T-stored)^T: M = ny (y), N = nx (x), K = nx
  return product<1, 1, false>(p.st, p.nxp, p.planes, bx, p.nxp,
                              make_walk(ny, nx, nx, ny, (size_t)nx * ny),
                              out, nullptr, nullptr, s);
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
// nf >= 1: for nf <= 4 (ops/fused_pc.py MAX_NF) fwd P2 keeps nf
// accumulator tiles in registers, so each such nf is its own instance;
// above, fwd_any.  nb: members, >= 1.
// bx and by: the [hi; lo] planes of the x and y basis of the entry
// (fwd: Qx^T, Qy^T; inv: Qx, Qy), rows padded to nxp and nyp floats.
extern "C" {

int ksfd_pc_fwd(const float* sc, const float* v, const float* bx,
                const float* by, const float* lam, float* tmp, float* out,
                int nf, int nx, int ny, int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb < 1 || nf < 1 || nx < 1 || ny < 1)
    return (int)cudaErrorInvalidValue;
  switch (nf) {
    case 1: return fwd<1>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, s);
    case 2: return fwd<2>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, s);
    case 3: return fwd<3>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, s);
    case 4: return fwd<4>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, s);
    default:
      return fwd_any(sc, v, bx, by, lam, tmp, out, nf, nx, ny, nb, s);
  }
}

int ksfd_pc_inv(const float* c, const float* bx, const float* by,
                float* tmp, float* out, int nf, int nx, int ny, int nb,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb < 1 || nf < 1 || nx < 1 || ny < 1)
    return (int)cudaErrorInvalidValue;
  return inv(c, bx, by, tmp, out, nf, nx, ny, nb, s);
}

}  // extern "C"
#else
// ---------------------------------------------------------------- host

namespace {

// One product on the host, the card's arithmetic element by element:
// the same walk over units and tiles, and per element of D the stages of
// BK in order, each summed from zero over its k-steps (the three passes
// lo.hi, hi.lo, hi.hi of 8 terms each) and added to the running sum; A
// and Bt zero outside M x K and N x K, as TMA fills them.
template <int NF, int NACC, bool EPI>
void product(const float* a, int lda, int planes, const float* bt, int ldb,
             const Walk& w, float* dst, const float* sc, const float* lam) {
  const float* bt_lo = bt + (size_t)w.N * ldb;
  const size_t a_plane = (size_t)w.M * lda;
  for (int u = 0; u < w.units(planes / NACC); ++u) {
    int group, m0, n0;
    w.unit(u, group, m0, n0);
    for (int m = m0; m < m0 + BM && m < w.M; ++m)
      for (int n = n0; n < n0 + BN && n < w.N; ++n) {
        float acc[NACC];
        for (int f = 0; f < NACC; ++f) {
          const float* ar = a + (group * NACC + f) * a_plane
                            + (size_t)m * lda;
          float sum = 0.f, stage = 0.f;
          for (int k0 = 0; k0 < w.K; k0 += KSTEP) {
            float ah[KSTEP], al[KSTEP], bh[KSTEP], bl[KSTEP];
            for (int kk = 0; kk < KSTEP; ++kk) {
              const int k = k0 + kk;
              float x = k < w.K ? ar[k] : 0.f, h, l;
              split(x, h, l);
              ah[kk] = h;
              al[kk] = tf32_rna(l);
              bh[kk] = k < w.K ? bt[(size_t)n * ldb + k] : 0.f;
              bl[kk] = k < w.K ? bt_lo[(size_t)n * ldb + k] : 0.f;
            }
            float p[3] = {0.f, 0.f, 0.f};
            for (int kk = 0; kk < KSTEP; ++kk) {
              p[0] += al[kk] * bh[kk];
              p[1] += ah[kk] * bl[kk];
              p[2] += ah[kk] * bh[kk];
            }
            stage = k0 % BK ? stage + p[0] : p[0];
            stage += p[1];
            stage += p[2];
            if ((k0 + KSTEP) % BK == 0 || k0 + KSTEP >= w.K) sum += stage;
          }
          acc[f] = sum;
        }
        store_element<NF, NACC, EPI>(w, group, m, n, acc, dst, sc, lam);
      }
  }
}

void first_product(const float* state, const float* by, const Plan& p,
                   int nx, int ny) {
  const float* a = state;
  if (!p.direct) {
    for (size_t r = 0; r < (size_t)p.planes * nx; ++r)
      for (int j = 0; j < ny; ++j) p.pitched[r * p.nyp + j] = state[r * ny + j];
    a = p.pitched;
  }
  product<1, 1, false>(a, p.lda1, p.planes, by, p.nyp,
                       make_walk(nx, ny, ny, p.nxp, (size_t)ny * p.nxp),
                       p.st, nullptr, nullptr);
}

template <int NF>
void fwd(const float* sc, const float* v, const float* bx, const float* by,
         const float* lam, float* tmp, float* out, int nx, int ny, int nb,
         bool direct) {
  const Plan p = make_plan(NF, nx, ny, nb, tmp, direct);
  first_product(v, by, p, nx, ny);
  product<NF, NF, true>(p.st, p.nxp, p.planes, bx, p.nxp,
                        make_walk(ny, nx, nx, ny, (size_t)nx * ny), out, sc,
                        lam);
}

void fwd_any(const float* sc, const float* v, const float* bx,
             const float* by, const float* lam, float* tmp, float* out,
             int nf, int nx, int ny, int nb, bool direct) {
  const Plan p = make_plan(nf, nx, ny, nb, tmp, direct);
  first_product(v, by, p, nx, ny);
  product<1, 1, false>(p.st, p.nxp, p.planes, bx, p.nxp,
                       make_walk(ny, nx, nx, ny, (size_t)nx * ny), out,
                       nullptr, nullptr);
  const size_t plane = (size_t)nx * ny;
  for (int member = 0; member < nb; ++member)
    for (size_t g = 0; g < plane; ++g)
      arrow_solve(sc + (size_t)member * (3 + 4 * (nf - 1)), nf, lam[g],
                out + (size_t)member * nf * plane + g, plane);
}

void inv(const float* c, const float* bx, const float* by, float* tmp,
         float* out, int nf, int nx, int ny, int nb, bool direct) {
  const Plan p = make_plan(nf, nx, ny, nb, tmp, direct);
  first_product(c, by, p, nx, ny);
  product<1, 1, false>(p.st, p.nxp, p.planes, bx, p.nxp,
                       make_walk(ny, nx, nx, ny, (size_t)nx * ny), out,
                       nullptr, nullptr);
}

}  // namespace

// The host entries: the card's arguments, with `direct` (0 or 1) in
// place of the stream: 0 takes the pitched-copy path whatever the
// extents, as the card does for ny % 4 != 0.
extern "C" {

int ksfd_pc_fwd_host(const float* sc, const float* v, const float* bx,
                     const float* by, const float* lam, float* tmp,
                     float* out, int nf, int nx, int ny, int nb, int direct) {
  if (nf < 1) return 1;
  switch (nf) {
    case 1: fwd<1>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, direct); break;
    case 2: fwd<2>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, direct); break;
    case 3: fwd<3>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, direct); break;
    case 4: fwd<4>(sc, v, bx, by, lam, tmp, out, nx, ny, nb, direct); break;
    default: fwd_any(sc, v, bx, by, lam, tmp, out, nf, nx, ny, nb, direct);
  }
  return 0;
}

int ksfd_pc_inv_host(const float* c, const float* bx, const float* by,
                     float* tmp, float* out, int nf, int nx, int ny, int nb,
                     int direct) {
  if (nf < 1) return 1;
  inv(c, bx, by, tmp, out, nf, nx, ny, nb, direct);
  return 0;
}

// the split of n floats: hi = tf32(x), lo = x - hi
void ksfd_tf32_split(const float* x, float* hi, float* lo, int n) {
  for (int i = 0; i < n; ++i) split(x[i], hi[i], lo[i]);
}

}  // extern "C"
#endif
