// Phased projected-Jacobi sweeps of the boxed LCP, batched, for Hopper
// (sm_90a).
//
// One kernel replaces both Pallas TPU kernels of
// diffdart_tpu/ops/pallas_lcp.py: `_sweep_kernel` (:26, the batched block
// kernel of jacobi_sweeps_pallas, called by sim/batched.py::step_batched) and
// `_sweep_kernel1` (:124, the single-env kernel of
// jacobi_sweeps_pallas_single, which vmap grids over the batch inside
// ops/lcp_lowrank.py::_solve_impl with contact_solver='lowrank_pallas').
// Both compute the same function; the port's batch-first convention calls
// this kernel once over the whole batch from both wrappers
// (diffdart_tpu_torch/ops/pallas_lcp.py).
//
// What it computes, per env (the plain version is ops/lcp.py::_jacobi of the
// port, in the same order of half-sweeps, clips and floors): row scale
// clip(diag/rowsum, 0.3, 0.9)/diag with diag and rowsum floored at 1e-12;
// lam = 0; `iters` times a non-friction half-sweep then a friction
// half-sweep, each r = A lam + b, cand = lam - r * scale, clipped to the
// bounds of the lam the half-sweep started from (friction rows: +-mu *
// lam[fidx]; +-inf bounds become +-3.4e38 as in the Pallas wrappers). All
// arithmetic is in the input type: unlike the TPU's kernel 4, whose matvec
// accumulates in float32 for float64 inputs, the float64 instantiation
// accumulates in float64, as _jacobi does.
//
// Design: one block per env. The env's A is loaded once, coalesced, into
// dynamic shared memory with an odd row stride to spread the banks. Its
// size, D (D | 1) + 5 D values, caps D at what the card's opt-in shared
// memory per block holds (227 KB on the H100: D <= 167 in float64, 238 in
// float32; jacobi_sweeps_max_d); above 48 KB the launcher opts in with
// cudaFuncSetAttribute. Threads loop over rows, so any D up to the cap runs; one thread per row computes its dot product
// over the shared A and the shared lam, and barriers separate reading the
// old lam from writing the new one. What bounds it on the H100: bytes. A
// (B, D, D) matrix is read once (28.9 MB at B = 4096, D = 42 in float32)
// and the sweeps do ~3.4e4 operations per env, so DRAM time (~10 us at
// 3.35 TB/s) exceeds arithmetic time (~2 us at 67 TFLOP/s). This first
// version is right and simple; each block keeps only D of its threads busy
// and its dot products are serial, so it is not expected near that bound.
//
// The same per-env code is compiled for the host (no __CUDACC__): one
// "thread" walks every row of each phase, and the barriers are no-ops. The
// CPU tests use that build to check the arithmetic without a GPU.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <vector>
#define HD inline
#endif
// a block barrier in the device pass; the host build has one "thread"
#ifdef __CUDA_ARCH__
#define SYNC() __syncthreads()
#else
#define SYNC() ((void)0)
#endif

namespace sweeps {

constexpr int THREADS = 64;

// torch.maximum / torch.minimum semantics (a NaN operand propagates)
template <typename S>
HD S tmax(S a, S b) { return (a != a) ? a : ((b != b) ? b : (a > b ? a : b)); }
template <typename S>
HD S tmin(S a, S b) { return (a != a) ? a : ((b != b) ? b : (a < b ? a : b)); }
// clip as jnp.clip and _jacobi take it: max with lo first, then min with hi
template <typename S>
HD S clampv(S x, S lo, S hi) { return tmin(tmax(x, lo), hi); }
HD float t_abs(float x) { return fabsf(x); }
HD double t_abs(double x) { return fabs(x); }
HD bool t_finite(float x) { return isfinite(x); }
HD bool t_finite(double x) { return isfinite(x); }

// Shared (or host scratch) layout: As[D * ld], lam[D], nl[D], scale[D],
// bounds lo[D], hi[D].
template <typename S>
HD void env_sweeps(const S* A, const S* b, const S* lo, const S* hi, const S* mu,
                   const int64_t* fidx, S* lam_out, int D, int iters, S* sh, int tid, int nt) {
  const int ld = D | 1;  // odd stride: rows of a warp's threads fall in different banks
  S* As = sh;
  S* lam = As + D * ld;
  S* nl = lam + D;
  S* scale = nl + D;
  S* lo_s = scale + D;
  S* hi_s = lo_s + D;
  const S big = S(3.4e38);
  for (int k = tid; k < D * D; k += nt) As[(k / D) * ld + k % D] = A[k];
  for (int i = tid; i < D; i += nt) {
    lam[i] = S(0);
    lo_s[i] = t_finite(lo[i]) ? lo[i] : -big;
    hi_s[i] = t_finite(hi[i]) ? hi[i] : big;
  }
  SYNC();
  for (int i = tid; i < D; i += nt) {
    const S* row = As + i * ld;
    S rs = S(0);
    for (int j = 0; j < D; ++j) rs += t_abs(row[j]);
    const S d = tmax(row[i], S(1e-12));
    rs = tmax(rs, S(1e-12));
    scale[i] = clampv(d / rs, S(0.3), S(0.9)) / d;
  }
  SYNC();
  for (int it = 0; it < iters; ++it) {
    for (int phase = 0; phase < 2; ++phase) {  // 0: normal/limit rows, 1: friction rows
      for (int i = tid; i < D; i += nt) {
        const int f = (int)fidx[i];
        const bool fr = f >= 0;
        S out = lam[i];
        if (fr == (phase == 1)) {
          const S* row = As + i * ld;
          S r = S(0);
          for (int j = 0; j < D; ++j) r += row[j] * lam[j];
          r += b[i];
          S cand = lam[i] - r * scale[i];
          S lo_e = lo_s[i], hi_e = hi_s[i];
          if (fr) {
            lo_e = -mu[i] * lam[f];
            hi_e = mu[i] * lam[f];
          }
          out = clampv(cand, lo_e, hi_e);
        }
        nl[i] = out;
      }
      SYNC();
      for (int i = tid; i < D; i += nt) lam[i] = nl[i];
      SYNC();
    }
  }
  for (int i = tid; i < D; i += nt) lam_out[i] = lam[i];
}

HD int scratch_elems(int D) { return D * (D | 1) + 5 * D; }

// the largest D whose scratch, `elem` bytes per value, fits `limit` bytes
inline int max_rows(int elem, long long limit) {
  int D = 0;
  while ((long long)elem * scratch_elems(D + 1) <= limit) ++D;
  return D;
}

#ifdef __CUDACC__
template <typename S>
__global__ void __launch_bounds__(THREADS) jacobi_sweeps_kernel(
    const S* __restrict__ A, const S* __restrict__ b, const S* __restrict__ lo,
    const S* __restrict__ hi, const S* __restrict__ mu, const int64_t* __restrict__ fidx,
    S* __restrict__ lam, int D, int iters) {
  extern __shared__ unsigned char smem_raw[];
  S* sh = reinterpret_cast<S*>(smem_raw);
  const int64_t e = blockIdx.x;
  env_sweeps<S>(A + e * D * D, b + e * D, lo + e * D, hi + e * D, mu + e * D, fidx,
                lam + e * D, D, iters, sh, threadIdx.x, blockDim.x);
}

// the current device's opt-in shared memory per block, in bytes
inline long long smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

template <typename S>
static int launch(const void* A, const void* b, const void* lo, const void* hi, const void* mu,
                  const void* fidx, void* lam, int B, int D, int iters, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const size_t smem = sizeof(S) * (size_t)scratch_elems(D);
  if ((long long)smem > smem_limit()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default, opt in
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_sweeps_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_sweeps_kernel<S><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const S*)A, (const S*)b, (const S*)lo, (const S*)hi, (const S*)mu,
      (const int64_t*)fidx, (S*)lam, D, iters);
  return (int)cudaGetLastError();
}
#else
template <typename S>
static int launch(const void* A, const void* b, const void* lo, const void* hi, const void* mu,
                  const void* fidx, void* lam, int B, int D, int iters, void*) {
  std::vector<S> sh(scratch_elems(D > 0 ? D : 1));
  for (int64_t e = 0; e < B; ++e)
    env_sweeps<S>((const S*)A + e * D * D, (const S*)b + e * D, (const S*)lo + e * D,
                  (const S*)hi + e * D, (const S*)mu + e * D, (const int64_t*)fidx,
                  (S*)lam + e * D, D, iters, sh.data(), 0, 1);
  return 0;
}
#endif

}  // namespace sweeps

extern "C" {

// the largest D the kernel takes for values of `elem_bytes` bytes (the host
// build has no cap)
int jacobi_sweeps_max_d(int elem_bytes) {
#ifdef __CUDACC__
  return sweeps::max_rows(elem_bytes, sweeps::smem_limit());
#else
  return elem_bytes > 0 ? 1 << 30 : 0;
#endif
}

// lam (B, D) = the sweeps of the boxed LCP (A (B, D, D), b/lo/hi/mu (B, D),
// fidx (D,) int64); all contiguous. Returns a CUDA error code (0 = launched).
int jacobi_sweeps_f32(const void* A, const void* b, const void* lo, const void* hi,
                      const void* mu, const void* fidx, void* lam, int B, int D, int iters,
                      void* stream) {
  return sweeps::launch<float>(A, b, lo, hi, mu, fidx, lam, B, D, iters, stream);
}

int jacobi_sweeps_f64(const void* A, const void* b, const void* lo, const void* hi,
                      const void* mu, const void* fidx, void* lam, int B, int D, int iters,
                      void* stream) {
  return sweeps::launch<double>(A, b, lo, hi, mu, fidx, lam, B, D, iters, stream);
}

}  // extern "C"
