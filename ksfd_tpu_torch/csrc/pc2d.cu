// Fused float32 block-preconditioner apply, 2D, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of ksfd_tpu/ops/pallas_pc.py:
//   ksfd_pc_fwd <- fwd_kernel :153 (launched by pl.pallas_call :196):
//                  per field c_f = Qx^T v_f Qy, then the per-mode arrow
//                  inverse (a Schur complement on the rho row, :164-183)
//   ksfd_pc_inv <- inv_kernel :185 (pl.pallas_call :222):
//                  per field out_f = Qx c_f Qy^T
// The wrappers, the scalar pack and the plain PyTorch versions are in
// ops/fused_pc.py.  Every product takes row-major operands: the caller
// passes Qx^T and Qy^T pre-transposed, as pallas_pc.py:148-151 does.
//
// Bound: operations.  Each entry is two float32 products per field,
// 2 * nf * 2 n^3 flops: at 1024^2 x 3 that is 12.9 GFLOP, 192 us at the
// H100 SXM's 67 TFLOP/s of float32 outside the tensor cores, against
// 11 us for the bytes (v in, modes out, the two bases).  Design: a
// batched shared-memory tiled SGEMM, written out by hand.  A block owns
// one BM x BN output tile for ALL nf fields, so the operand shared by the
// fields (the basis) is read once per block; 256 threads each hold a
// TM x TN register micro-tile per field, fed by 16-byte shared-memory
// loads, and global tiles come in as 16-byte loads where the extents
// allow (vec), masked at the ragged edges either way (no 128-alignment,
// unlike pallas_pc_available).  Each entry runs two launches: the left
// product T_f = L v_f, then the right product T_f R.  T goes through
// device memory (12.6 MB at 1024^2 x 3, inside the 50 MB L2); the TPU's
// VMEM-resident v has no counterpart, since Hopper's blocks run in
// parallel and carry nothing between them.  In the forward entry the
// right product's epilogue applies the arrow inverse in registers: the
// block holds the same (kx, ky) mode for all nf fields, reads lam2d and
// the scalar pack from device memory and writes the nf solved modes.
//
// Numerics: float32 operands and float32 accumulation (the numerics of
// the port's cuBLAS apply with TF32 off, and of the reference's
// interpret-mode tests); the TPU kernel's bf16 MXU operands are not
// copied.  The products accumulate with explicit fmaf, so the library's
// -fmad=false (ops/fused_stencil.py NVCC_FLAGS) leaves them fused, while
// the epilogue rounds every product and sum once, as the plain version's
// separate PyTorch operations do.  TF32 or bf16 wgmma, TMA and a
// pipelined ring of tiles are a later change that makes this fast.
// Every C entry launches on the caller's stream, allocates nothing (the
// wrapper passes the scratch T) and returns cudaGetLastError().
//
// Members (the reference's ensemble vmaps the two pallas_calls,
// pallas_pc.py:196 and :222): every entry takes a member count nb >= 1
// (at most 65535) and runs both of its grids over nb members on
// blockIdx.z.  v, c, T and the output are contiguous (nb, NF, nx, ny)
// and the scalar pack is (nb, 3 + 4 NL), one row per member; the bases
// and lam2d are shared by all members and not broadcast.  A block adds
// member * NF * nx * ny to its per-member pointers and member * (3 + 4
// NL) to the pack, and nothing else changes, so a batched launch equals
// nb single launches bit for bit and nb = 1 is the single-member apply.
//
// Without __CUDACC__ (a host C++20 compiler, one std::thread per CUDA
// thread and a std::barrier for __syncthreads) the kernel bodies compile
// as plain C++; tests/test_torch_pc.py runs them so on the CPU.  The C
// entries exist only in the nvcc build.

#include <stddef.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KSFD_FMA(a, b, c) __fmaf_rn(a, b, c)
#else
#include <cmath>
#define KSFD_FMA(a, b, c) std::fma(a, b, c)
#endif

namespace {

constexpr int BM = 64;        // tile rows (output rows, x or kx)
constexpr int BN = 64;        // tile columns (output columns, y or ky)
constexpr int BK = 16;        // depth of one shared-memory stage
constexpr int TM = 4;         // micro-tile rows per thread
constexpr int TN = 4;         // micro-tile columns per thread
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads
constexpr int PAD = 4;        // A tiles are stored transposed, padded
static_assert(NT == 256, "the tile loaders assume 256 threads");
static_assert(BM * BK == 4 * NT && BK * BN == 4 * NT,
              "each thread loads one float4 of each tile");

// Four consecutive floats of row r, columns c..c+3, of a row-major
// R x Cn matrix, zero outside it.  vec: Cn % 4 == 0 and 16-byte aligned
// rows, so an in-range group is one 16-byte load.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int r,
                                        int c, int R, int Cn, int vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= R) return x;
  const float* q = p + (size_t)r * Cn;
  if (vec) {
    if (c < Cn) x = *reinterpret_cast<const float4*>(q + c);
    return x;
  }
  if (c < Cn) x.x = q[c];
  if (c + 1 < Cn) x.y = q[c + 1];
  if (c + 2 < Cn) x.z = q[c + 2];
  if (c + 3 < Cn) x.w = q[c + 3];
  return x;
}

// C_f = A_f B_f for f < NF: A is M x K (one per field when A_BATCH,
// else shared), B is K x N (shared when A_BATCH, else one per field), C
// is NF x M x N.  EPI (forward right product): C holds the arrow-solved
// modes instead, from sc = [shift, rho_diff, rho_mean, dG_1..dG_nl,
// s_1..s_nl, gamma_1..gamma_nl, D_1..D_nl] and lam (M x N, f32).  The
// member blockIdx.z selects its own per-field operand, C and pack row.
template <int NF, bool A_BATCH, bool EPI>
__global__ void __launch_bounds__(NT)
pc_gemm(const float* __restrict__ A, const float* __restrict__ B,
        float* __restrict__ C, int M, int N, int K, int vec,
        const float* __restrict__ sc, const float* __restrict__ lam) {
  constexpr int NA = A_BATCH ? NF : 1;
  constexpr int NB = A_BATCH ? 1 : NF;
  __shared__ __align__(16) float As[NA][BK][BM + PAD];
  __shared__ __align__(16) float Bs[NB][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ar = tid / (BK / 4), ac = (tid % (BK / 4)) * 4;   // A loader
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;   // B loader
  const size_t a_stride = (size_t)M * K, b_stride = (size_t)K * N;
  const size_t member = blockIdx.z;
  if (A_BATCH) {
    A += member * NF * a_stride;
  } else {
    B += member * NF * b_stride;
  }
  C += member * NF * (size_t)M * N;
  if (EPI) sc += member * (3 + 4 * (NF - 1));

  float acc[NF][TM][TN];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[f][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int f = 0; f < NA; ++f) {
      const float4 x = load4(A + f * a_stride, m0 + ar, k0 + ac, M, K, vec);
      As[f][ac + 0][ar] = x.x;
      As[f][ac + 1][ar] = x.y;
      As[f][ac + 2][ar] = x.z;
      As[f][ac + 3][ar] = x.w;
    }
#pragma unroll
    for (int f = 0; f < NB; ++f) {
      *reinterpret_cast<float4*>(&Bs[f][br][bc]) =
          load4(B + f * b_stride, k0 + br, n0 + bc, K, N, vec);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[NA][TM], b[NB][TN];
#pragma unroll
      for (int f = 0; f < NA; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(&As[f][k][ty * TM]);
        a[f][0] = x.x; a[f][1] = x.y; a[f][2] = x.z; a[f][3] = x.w;
      }
#pragma unroll
      for (int f = 0; f < NB; ++f) {
        const float4 y = *reinterpret_cast<const float4*>(&Bs[f][k][tx * TN]);
        b[f][0] = y.x; b[f][1] = y.y; b[f][2] = y.z; b[f][3] = y.w;
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[f][i][j] = KSFD_FMA(a[A_BATCH ? f : 0][i],
                                    b[A_BATCH ? 0 : f][j], acc[f][i][j]);
    }
    __syncthreads();
  }

  const size_t plane = (size_t)M * N;
  if (!EPI) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      const int col = n0 + tx * TN;
      if (row >= M || col >= N) continue;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float* c = C + f * plane + (size_t)row * N + col;
        if (vec) {
          *reinterpret_cast<float4*>(c) = make_float4(
              acc[f][i][0], acc[f][i][1], acc[f][i][2], acc[f][i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (col + j < N) c[j] = acc[f][i][j];
        }
      }
    }
    return;
  }

  // arrow inverse per mode, the arithmetic of pallas_pc.py:164-183
  constexpr int NL = NF - 1;
  constexpr int NLA = NL > 0 ? NL : 1;
  const float shift = sc[0], rho_diff = sc[1], rho_mean = sc[2];
  float nrdG[NLA], ms[NLA], gam[NLA], Dl[NLA];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    nrdG[l] = -rho_mean * sc[3 + l];      // (-rho_mean * dG_l)
    ms[l] = -sc[3 + NL + l];              // c_l = -s_l
    gam[l] = sc[3 + 2 * NL + l];
    Dl[l] = sc[3 + 3 * NL + l];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= N) continue;
      const size_t g = (size_t)row * N + col;
      const float lm = lam[g];
      float schur = shift - rho_diff * lm;
      float num = acc[0][i][j];
      float inv_d[NLA];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        inv_d[l] = 1.0f / (shift + gam[l] - Dl[l] * lm);
        const float b_over_d = nrdG[l] * lm * inv_d[l];
        schur = schur - b_over_d * ms[l];
        num = num - b_over_d * acc[1 + l][i][j];
      }
      const float x_r = num / schur;
      C[g] = x_r;
#pragma unroll
      for (int l = 0; l < NL; ++l)
        C[(1 + l) * plane + g] = (acc[1 + l][i][j] - ms[l] * x_r) * inv_d[l];
    }
  }
}

#ifdef __CUDACC__
int vec_ok(int nx, int ny, const float* const* ptrs, int n) {
  if (nx % 4 || ny % 4) return 0;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16) return 0;
  return 1;
}

dim3 grid_for(int nx, int ny, int nb) {
  return dim3((ny + BN - 1) / BN, (nx + BM - 1) / BM, nb);
}

template <int NF>
int fwd(const float* sc, const float* v, const float* qxt, const float* qy,
        const float* lam, float* tmp, float* out, int nx, int ny, int nb,
        cudaStream_t s) {
  const float* ptrs[] = {v, qxt, qy, tmp, out};
  const int vec = vec_ok(nx, ny, ptrs, 5);
  // T_f = Qx^T v_f  (M = nx, K = nx, N = ny; the basis is shared)
  pc_gemm<NF, false, false><<<grid_for(nx, ny, nb), NT, 0, s>>>(
      qxt, v, tmp, nx, ny, nx, vec, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // modes = arrow^{-1}(T_f Qy)  (M = nx, K = ny, N = ny)
  pc_gemm<NF, true, true><<<grid_for(nx, ny, nb), NT, 0, s>>>(
      tmp, qy, out, nx, ny, ny, vec, sc, lam);
  return (int)cudaGetLastError();
}

template <int NF>
int inv(const float* c, const float* qx, const float* qyt, float* tmp,
        float* out, int nx, int ny, int nb, cudaStream_t s) {
  const float* ptrs[] = {c, qx, qyt, tmp, out};
  const int vec = vec_ok(nx, ny, ptrs, 5);
  // T_f = Qx c_f, then out_f = T_f Qy^T
  pc_gemm<NF, false, false><<<grid_for(nx, ny, nb), NT, 0, s>>>(
      qx, c, tmp, nx, ny, nx, vec, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pc_gemm<NF, true, false><<<grid_for(nx, ny, nb), NT, 0, s>>>(
      tmp, qyt, out, nx, ny, ny, vec, nullptr, nullptr);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// nf is 2..4 (ops/fused_pc.py MAX_NF): a block keeps nf accumulator
// tiles in registers, so each nf is its own instance.  nb: members, 1 to
// 65535 (gridDim.z's limit).
extern "C" {

int ksfd_pc_fwd(const float* sc, const float* v, const float* qxt,
                const float* qy, const float* lam, float* tmp, float* out,
                int nf, int nx, int ny, int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  switch (nf) {
    case 2: return fwd<2>(sc, v, qxt, qy, lam, tmp, out, nx, ny, nb, s);
    case 3: return fwd<3>(sc, v, qxt, qy, lam, tmp, out, nx, ny, nb, s);
    case 4: return fwd<4>(sc, v, qxt, qy, lam, tmp, out, nx, ny, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ksfd_pc_inv(const float* c, const float* qx, const float* qyt,
                float* tmp, float* out, int nf, int nx, int ny, int nb,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  switch (nf) {
    case 2: return inv<2>(c, qx, qyt, tmp, out, nx, ny, nb, s);
    case 3: return inv<3>(c, qx, qyt, tmp, out, nx, ny, nb, s);
    case 4: return inv<4>(c, qx, qyt, tmp, out, nx, ny, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
#endif
