// The basis-GEMM block preconditioner's per-mode arrow solve, one
// elementwise kernel over the modes (1D, 2D or 3D alike).
//
// Replaces the chain of some 30 full-plane PyTorch operations of
// ksfd_tpu_torch/solvers/linalg.py BlockSpectralPreconditioner
// (the counterpart of ksfd_tpu/solvers/linalg.py
// BlockSpectralPreconditioner._arrow_solve, XLA elementwise code in the
// reference) between the forward and the inverse cuBLAS products.  The
// wrapper, the scalar pack and the plain version are in linalg.py.
//
// Per mode (Laplacian eigenvalue lam <= 0) the nf x nf system
//   a x_r + sum_l b_l x_l = y_r,   c_l x_r + d_l x_l = y_l
// with a = shift - rho_diff lam, b_l = (-rho_mean lam) dG_l, c_l = -s_l,
// d_l = (shift + gamma_l) - D_l lam is solved by a Schur complement on
// the rho row; each of nextra trailing fields (a with-G state's G) gets
// c / shift.
//
// Numerics: the plain version's operation order, every product,
// quotient, sum and difference rounded on its own (__fmul_rn, __fdiv_rn,
// __fadd_rn, __fsub_rn and their double forms: no contraction into a
// multiply-add, no reciprocal), so on the card the kernel equals the
// plain chain of separate PyTorch operations bit for bit.
//
// Bound: bytes.  One pass reads the nf + nextra mode planes of each
// member and lam once (shared by the members) and writes nf + nextra
// planes: 7 float32 planes at nf = 3, 66 MB and 19.7 us at 1536^2 and
// 3.35 TB/s.  Thread i solves mode i of member blockIdx.y; the pack of
// a member, (3 + 4 nl) values [shift, rho_diff, rho_mean, dG_1..dG_nl,
// s_1..s_nl, gamma_1..gamma_nl, D_1..D_nl], is read by every thread
// (one cached line).  Up to MAX_NL ligands the mode's ligand values stay
// in registers (an instance per count); above, the back substitution
// reads them again.
//
// Layout: modes and out (nb, nf + nextra, S), lam (S), pack (nb, P),
// S the modes of one field.  The entry launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
//
// Without __CUDACC__ (a host C++ compiler, -ffp-contract=off) the same
// source builds arrow_modes_host, the same per-mode body in a loop, for
// the CPU tests.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ARROW_HD __host__ __device__ __forceinline__
#else
#define ARROW_HD inline
#endif

namespace {

constexpr int MAX_NL = 4;

#ifdef __CUDACC__
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
#else
template <typename T> inline T mul(T a, T b) { return a * b; }
template <typename T> inline T dvd(T a, T b) { return a / b; }
template <typename T> inline T add(T a, T b) { return a + b; }
template <typename T> inline T sub(T a, T b) { return a - b; }
#endif

// Mode i of one member: p its pack, c and out its (nf + nextra, S)
// planes.  NL >= 0 is the ligand count known at compile time, NL < 0
// takes nl_rt.
template <typename T, int NL>
ARROW_HD void solve_mode(const T* p, const T* c, T* out, T lam, int nl_rt,
                         int nextra, long long S, long long i) {
  const int nl = NL >= 0 ? NL : nl_rt;
  const T shift = p[0];
  const T nrm = -p[2];
  const T* dG = p + 3;
  const T* s = dG + nl;
  const T* gamma = s + nl;
  const T* D = gamma + nl;
  T schur = sub(shift, mul(p[1], lam));
  T rhs = c[i];
  T y[NL > 0 ? NL : 1];
#pragma unroll
  for (int l = 0; l < nl; ++l) {
    const T b = mul(mul(nrm, lam), dG[l]);
    const T d = sub(add(shift, gamma[l]), mul(D[l], lam));
    const T yl = c[(1 + l) * S + i];
    if constexpr (NL > 0) y[l] = yl;
    schur = sub(schur, dvd(mul(b, -s[l]), d));
    rhs = sub(rhs, dvd(mul(b, yl), d));
  }
  const T xr = dvd(rhs, schur);
  out[i] = xr;
#pragma unroll
  for (int l = 0; l < nl; ++l) {
    const T d = sub(add(shift, gamma[l]), mul(D[l], lam));
    T yl;
    if constexpr (NL > 0) {
      yl = y[l];
    } else {
      yl = c[(1 + l) * S + i];
    }
    out[(1 + l) * S + i] = dvd(sub(yl, mul(-s[l], xr)), d);
  }
  for (int e = nl + 1; e < nl + 1 + nextra; ++e)
    out[e * S + i] = dvd(c[e * S + i], shift);
}

#ifdef __CUDACC__
template <typename T, int NL>
__global__ void __launch_bounds__(256)
arrow_modes(const T* __restrict__ pack, int P, const T* __restrict__ c,
            const T* __restrict__ lam, T* __restrict__ out, int nl,
            int nextra, long long S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const long long per = (long long)(nl + 1 + nextra) * S;
  const long long b = blockIdx.y;
  solve_mode<T, NL>(pack + b * P, c + b * per, out + b * per, lam[i], nl,
                    nextra, S, i);
}

template <typename T, int NL>
void launch(const void* pack, int P, const void* c, const void* lam,
            void* out, int nl, int nextra, long long S, int nb,
            cudaStream_t st) {
  const dim3 grid((unsigned)((S + 255) / 256), (unsigned)nb);
  arrow_modes<T, NL><<<grid, 256, 0, st>>>(
      (const T*)pack, P, (const T*)c, (const T*)lam, (T*)out, nl, nextra, S);
}
#else
// The host path of the same body, for the CPU tests.
template <typename T, int NL>
void launch(const void* pack, int P, const void* c, const void* lam,
            void* out, int nl, int nextra, long long S, int nb) {
  const long long per = (long long)(nl + 1 + nextra) * S;
  for (long long b = 0; b < nb; ++b)
    for (long long i = 0; i < S; ++i)
      solve_mode<T, NL>((const T*)pack + b * P, (const T*)c + b * per,
                        (T*)out + b * per, ((const T*)lam)[i], nl, nextra,
                        S, i);
}
#endif  // __CUDACC__

// The instance for nl ligands (NL = nl up to MAX_NL, else -1) in the
// operands' type.
template <typename... A>
void dispatch(int dbl, int nl, A... args) {
#define ARROW_CASE(N)                                          \
  case N:                                                      \
    if (dbl) launch<double, N>(args...);                       \
    else launch<float, N>(args...);                            \
    break;
  switch (nl) {
    ARROW_CASE(0)
    ARROW_CASE(1)
    ARROW_CASE(2)
    ARROW_CASE(3)
    ARROW_CASE(MAX_NL)
    default:
      if (dbl) launch<double, -1>(args...);
      else launch<float, -1>(args...);
  }
#undef ARROW_CASE
}

}  // namespace

extern "C" {

// pack (nb, P), modes and out (nb, nl + 1 + nextra, S), lam (S); dbl 1:
// double operands, else float.
#ifdef __CUDACC__
int ksfd_arrow_modes(const void* pack, int P, const void* modes,
                     const void* lam, void* out, int nl, int nextra,
                     long long S, int nb, int dbl, void* stream) {
  if (nl < 0 || nextra < 0 || P != 3 + 4 * nl || nb < 1 || nb > 65535 ||
      S < 1)
    return (int)cudaErrorInvalidValue;
  dispatch(dbl, nl, pack, P, modes, lam, out, nl, nextra, S, nb,
           (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
#else
int arrow_modes_host(const void* pack, int P, const void* modes,
                     const void* lam, void* out, int nl, int nextra,
                     long long S, int nb, int dbl) {
  if (nl < 0 || nextra < 0 || P != 3 + 4 * nl || nb < 1 || S < 1) return 1;
  dispatch(dbl, nl, pack, P, modes, lam, out, nl, nextra, S, nb);
  return 0;
}
#endif

}  // extern "C"
