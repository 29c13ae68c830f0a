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
// accumulates in float64, as _jacobi does. Each row's |A| sum and dot
// product run serially over j = 0..D-1, one multiply and one add per term
// (-fmad=false), so the kernel, its host build and the first version of
// this kernel (one block per env) give the same lam bit for bit.
//
// What bounds it on the H100: bytes. A (B, D, D) is read once, 28.9 MB at
// B = 4096, D = 42 in float32 (32.3 MB with b, lo, hi, mu and lam), about
// 9.7 us at 3.35 TB/s; the sweeps' ~2.1e4 operations per env take about
// 1.3 us at 67 TFLOP/s. What holds it back in practice is each lane's
// chain: a row's dot product is D dependent adds in the serial order, so a
// half-sweep lasts at least D add latencies, and a warp sweeps its envs one
// after another (PERF.md, section 6: the stages of an env timed in the kernel).
//
// Design: a warp per env; persistent warps (the grid is what the card holds
// at once: cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs),
// up to four per block, each looping over envs.
// - Phase lists. The rows of each phase form a compact list (slot order:
//   the fidx < 0 rows, then the friction rows, each in row order), built
//   once per block from fidx with ballots. In a half-sweep lane k takes the
//   phase's k-th row (and k + 32, ...), so no lane idles on a row of the
//   other phase (at D = 42: 22 and 20 rows, one pass each).
// - The register path (float32, 15 <= D <= 48, at most 32 rows per phase:
//   the half-cheetah's 42 rows, the cube's 24). The warp's next env is
//   copied into its stage in shared memory (A in row order, then b, lo, hi,
//   mu) while it sweeps the current one: A by one bulk copy
//   (cp.async.bulk, the Tensor Memory Accelerator, completed on the warp's
//   mbarrier) where its D * D values are a multiple of 16 bytes, else by
//   one cp.async per element; b, lo, hi, mu by one cp.async per element.
//   Each lane loads its row of each phase from the stage into registers
//   once per env, which frees the stage for the next copy: the registers
//   are the env's second buffer. The row scales and the half-sweeps then
//   read only lam from shared memory (16-byte broadcasts), and the sums run
//   over all RMAX terms, +0 past D, with no predicate in the chain.
// - The direct path (float64, any D past 48, or phases of more than 32
//   rows): one buffer per warp, A copied into it in slot order by one
//   cp.async per element, with the odd row stride D | 1 that puts the 32
//   lanes' values of one column in different banks; b, lo, hi, mu read from
//   device memory. The cap on D is what 227 KB holds for one such warp: 167
//   rows in float64, 238 in float32 (jacobi_sweeps_max_d), as in the first
//   version of this kernel.
// - A warp keeps only a few 4-byte cp.async in flight, so one per element
//   of A put an env's whole copy on the warp's chain, where the bulk copy
//   is one instruction. The chain of a lane's dot product is D dependent
//   adds; an add under a predicate, or a load issued just before its use,
//   lengthens it (PERF.md, section 6).
// - Within a warp, __syncwarp() separates reading the old lam from writing
//   the new one.
// The launcher caches, per device, dtype and D, the warps per block and the
// grid it computed, so that a launch costs one kernel launch and one
// cudaGetLastError.
//
// The same per-warp code is compiled for the host (no __CUDACC__): lanes()
// runs a phase's 32 lanes in turn and ballot() collects their predicates,
// on scratch filled with NaN before each env's copy and solve, so a row that
// is skipped, read twice or read after its neighbour's write fails a CPU
// test. It takes the card's path and copy (a bulk copy is a memcpy there).
// The CPU tests use that build to check the arithmetic without a GPU.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#define HD __host__ __device__ __forceinline__
#define HDN __host__ __device__ __noinline__
#else
#define HD inline
#define HDN inline
#endif
#include <cstring>
#include <vector>

namespace sweeps {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 4;  // the most warps (envs in flight) per block

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

// fn(lane) on every lane of the warp, then the lanes meet; the host build
// runs the 32 lanes one after another
template <typename Fn>
HD void lanes(Fn&& fn) {
#ifdef __CUDA_ARCH__
  fn((int)(threadIdx.x % WARP));
  __syncwarp();
#else
  for (int lane = 0; lane < WARP; ++lane) fn(lane);
#endif
}

// the warp's mask of pred(lane)
template <typename Fn>
HD unsigned ballot(Fn&& pred) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(0xffffffffu, pred((int)(threadIdx.x % WARP)));
#else
  unsigned m = 0;
  for (int lane = 0; lane < WARP; ++lane) m |= (unsigned)(bool)pred(lane) << lane;
  return m;
#endif
}

HD int popc(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// one element from device memory into shared memory, asynchronously
template <typename S>
HD void copy_async(S* dst, const S* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  // no memory clobber: nothing reads the destination before copies_wait,
  // which has one, so the compiler may hoist the next copies' address loads
  if constexpr (sizeof(S) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

HD void copies_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this lane's copy groups are pending, then meet,
// so that each lane sees the others' copies
template <int N>
HD void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncwarp();
#endif
}

// Shared memory. Per warp, in values: lam (row order), nl and scale (slot
// order), D each (the register path uses all 3 D for lam); then one buffer.
// Where the register path can run (float32, 15 <= D <= RMAX), the buffer is
// the stage: A in row order (D * D), then b, lo, hi, mu (4 D, row order).
// Otherwise it holds A in slot order with the odd row stride D | 1, as the
// direct path copies it (D * (D | 1) <= D * D + 4 D: the direct path also
// runs in a stage where the phases turn out too long for registers). Each
// part starts on 16 bytes (lam's 16-byte loads, the bulk copy's
// destination). Per block, after its warps: an mbarrier per warp, slot[D]
// (row | (fidx + 1) << 16) and pos[D] (row -> slot), int32; then 8 values of
// slack, as the direct path's row sums load up to 8 values past a row's end
// (values they never use).
constexpr int RMAX = 48;  // the register path's longest row
HD size_t round16(size_t vals, int elem) {
  const size_t q = 16 / elem;
  return (vals + q - 1) / q * q;
}
HD size_t head_vals(int elem, int D) { return round16(3 * (size_t)D, elem); }
// whether the register path can run at D in values of `elem` bytes (it
// holds lam, RMAX values, in the head)
HD bool regs_possible(int elem, int D) {
  return elem == 4 && D <= RMAX && head_vals(elem, D) >= RMAX;
}
HD size_t buffer_vals(int elem, int D) {
  return regs_possible(elem, D) ? (size_t)D * D + 4 * (size_t)D : (size_t)D * (D | 1);
}
HD size_t warp_vals(int elem, int D) {
  return head_vals(elem, D) + round16(buffer_vals(elem, D), elem);
}
HD size_t block_bytes(int elem, int D, int warps) {
  return (size_t)elem * warps * warp_vals(elem, D) + 8 * (size_t)warps + 8 * (size_t)D +
         8 * (size_t)elem;
}

// the largest D whose one-warp block fits `limit` bytes
inline int max_rows(int elem, long long limit) {
  int D = 0;
  while ((long long)block_bytes(elem, D + 1, 1) <= limit) ++D;
  return D;
}

// whether the register path's stage takes each env's A by one bulk copy:
// its (D, D) block a multiple of 16 bytes, on a 16-byte aligned A
inline bool bulk_fits(int elem, int D, const void* A) {
  return regs_possible(elem, D) && ((size_t)elem * D * D) % 16 == 0 && ((uintptr_t)A & 15) == 0;
}

// The phase lists: slots 0..n0-1 hold the rows with fidx < 0, slots
// n0..D-1 the friction rows, each in row order. Returns n0 (every warp
// counts it); `write`: this warp also stores slot[] and pos[].
HD int build_lists(const int64_t* fidx, int D, int* slot, int* pos, bool write) {
  int n0 = 0;
  for (int base = 0; base < D; base += WARP)
    n0 += popc(ballot([&](int l) { return base + l < D && fidx[base + l] < 0; }));
  if (!write) return n0;
  int c0 = 0, c1 = n0;
  for (int base = 0; base < D; base += WARP) {
    const unsigned m0 = ballot([&](int l) { return base + l < D && fidx[base + l] < 0; });
    const unsigned m1 = ballot([&](int l) { return base + l < D && fidx[base + l] >= 0; });
    lanes([&](int l) {
      const int r = base + l;
      if (r >= D) return;
      const int f = (int)fidx[r];
      const unsigned below = (1u << l) - 1u;
      const int s = f < 0 ? c0 + popc(m0 & below) : c1 + popc(m1 & below);
      slot[s] = r | ((f < 0 ? 0 : f + 1) << 16);
      pos[r] = s;
    });
    c0 += popc(m0);
    c1 += popc(m1);
  }
  return n0;
}

template <typename S>
struct Problem {
  const S* A;
  const S* b;
  const S* lo;
  const S* hi;
  const S* mu;
  S* lam;
  int B, D, iters;
};

#ifndef __CUDA_ARCH__
template <typename S>
inline void poison(S* p, size_t n) { std::memset((void*)p, 0xff, n * sizeof(S)); }
#endif

// ---- the bulk copy (the Tensor Memory Accelerator) and its mbarrier ----
#ifdef __CUDA_ARCH__
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
#endif

// the warp's mbarrier, one arrival (lane 0's) per phase
HD void mbar_init(uint64_t* m) {
#ifdef __CUDA_ARCH__
  if (threadIdx.x % WARP == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(m)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
#endif
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory in one copy, which completes m's phase; lane 0
// issues it
template <typename S>
HD void bulk_copy(S* dst, const S* src, unsigned bytes, uint64_t* m) {
#ifdef __CUDA_ARCH__
  if (threadIdx.x % WARP == 0) {
    // the lanes' earlier reads of dst (generic proxy) before the copy's
    // writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(m)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(m))
        : "memory");
  }
#else
  (void)m;
  std::memcpy((void*)dst, (const void*)src, bytes);
#endif
}

// every lane waits for m's phase of parity `parity` to complete
HD void mbar_wait(uint64_t* m, int parity) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(m)),
      "r"(parity)
      : "memory");
#else
  (void)m;
  (void)parity;
#endif
}

// x[0..7] = lam[j..j+7], lam + j 16-byte aligned (two or four 16-byte loads
// of a broadcast on the card)
HD void load8(const float* x, float* out) {
#ifdef __CUDA_ARCH__
  const float4 u = reinterpret_cast<const float4*>(x)[0], w = reinterpret_cast<const float4*>(x)[1];
  out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
  out[4] = w.x, out[5] = w.y, out[6] = w.z, out[7] = w.w;
#else
  for (int t = 0; t < 8; ++t) out[t] = x[t];
#endif
}
HD void load8(const double* x, double* out) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const double2 u = reinterpret_cast<const double2*>(x)[t];
    out[2 * t] = u.x, out[2 * t + 1] = u.y;
  }
#else
  for (int t = 0; t < 8; ++t) out[t] = x[t];
#endif
}

// The direct path's row sums add their terms in the serial order j = 0..D-1,
// so every rounding is the serial loop's. What differs is only when the
// terms are loaded: in blocks of eight, the next block's loads issued,
// without a branch, before the current block's sums. The last block's loads
// run up to 8 values past the row (the slack of block_bytes) and are not
// used.

// sum over j of row[j] * lam[j], lam 16-byte aligned
template <typename S>
HD S dot_row(const S* row, const S* lam, int D) {
  const int nb = D / 8;
  S r = S(0), a[8], x[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) a[t] = row[t];
  load8(lam, x);
  for (int k = 0; k < nb; ++k) {
    S an[8], xn[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) an[t] = row[8 * k + 8 + t];
    load8(lam + 8 * k + 8, xn);
#pragma unroll
    for (int t = 0; t < 8; ++t) r += a[t] * x[t];
#pragma unroll
    for (int t = 0; t < 8; ++t) a[t] = an[t], x[t] = xn[t];
  }
  for (int j = 8 * nb; j < D; ++j) r += row[j] * lam[j];
  return r;
}

// the sums over j of |p[j]| and of |q[j]|, two independent chains
template <typename S>
HD void abs_sum2(const S* p, const S* q, int D, S* sp, S* sq) {
  const int nb = D / 8;
  S u = S(0), w = S(0), a[8], c[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) a[t] = p[t], c[t] = q[t];
  for (int k = 0; k < nb; ++k) {
    S an[8], cn[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) an[t] = p[8 * k + 8 + t], cn[t] = q[8 * k + 8 + t];
#pragma unroll
    for (int t = 0; t < 8; ++t) u += t_abs(a[t]), w += t_abs(c[t]);
#pragma unroll
    for (int t = 0; t < 8; ++t) a[t] = an[t], c[t] = cn[t];
  }
  for (int j = 8 * nb; j < D; ++j) u += t_abs(p[j]), w += t_abs(q[j]);
  *sp = u;
  *sq = w;
}

// ---- the stage: a warp's next env, in row order ----

// Start the copy of env e into the stage: A by one bulk copy (`bulk`) or one
// cp.async per element, b, lo, hi, mu one cp.async per element; one commit
// per lane.
template <typename S>
HD void stage_env(Problem<S> p, S* stage, uint64_t* mbar, int e, bool bulk) {
  const int D = p.D;
  const S* src = p.A + (int64_t)e * D * D;
  const int64_t o = (int64_t)e * D;
  S* v = stage + (size_t)D * D;
#ifndef __CUDA_ARCH__
  poison(stage, (size_t)D * D + 4 * (size_t)D);
#endif
  if (bulk) bulk_copy(stage, src, (unsigned)(sizeof(S) * D * D), mbar);
  lanes([&](int l) {
    if (!bulk)
      for (int k = l; k < D * D; k += WARP) copy_async(stage + k, src + k);
    for (int k = l; k < D; k += WARP) {
      copy_async(v + k, p.b + o + k);
      copy_async(v + D + k, p.lo + o + k);
      copy_async(v + 2 * D + k, p.hi + o + k);
      copy_async(v + 3 * D + k, p.mu + o + k);
    }
    copies_commit();
  });
}

// wait for the stage: this lane's copies, then (bulk) phase `parity` of the
// bulk copy's mbarrier; the lanes meet
HD void stage_wait(uint64_t* mbar, int parity, bool bulk) {
  copies_wait<0>();
  if (bulk) mbar_wait(mbar, parity);
}

// ---- the register path: float32, 15 <= D <= RMAX, <= 32 rows per phase ----
// Each lane holds its row of each phase in registers for the whole env
// (loaded once from the stage, which then takes the next env's copy): the
// row scales and the dot products read no A from shared memory, and a
// half-sweep loads only lam (16-byte broadcasts). The arithmetic is the
// shared path's, term for term and in its order. On the host, lanes run in
// turn, so each keeps its state in one of 32 LaneRows.
struct LaneRows {
  float a[2][RMAX];  // the lane's row of phase 0 and of phase 1
  float b[2], lo[2], hi[2], mu[2], scale[2], out[2];
  int i[2], f[2];  // the row, and its normal row (friction) or -1
  bool on[2];      // the lane has a row in that phase
};

HD bool regs_fit(int elem, int D, int n0) {
  return regs_possible(elem, D) && n0 <= WARP && D - n0 <= WARP;
}

// Lane l's rows (phase 0: slot l; phase 1: slot n0 + l) from the stage (A
// in row order, then b, lo, hi, mu), and their row scales. Both rows at
// once, without a branch (a lane with no row in a phase loads slot 0's and
// marks it off), so that their loads and their two |A| sums overlap.
HD void regs_rows(LaneRows& L, const float* stage, int D, int n0, const int* slot, int l) {
  const float big = 3.4e38f;
  const float* v = stage + (size_t)D * D;
  const float* row[2];
#pragma unroll
  for (int ph = 0; ph < 2; ++ph) {
    const int s = (ph ? n0 : 0) + l;
    L.on[ph] = s < (ph ? D : n0);
    const int info = slot[L.on[ph] ? s : 0], i = info & 0xffff;
    row[ph] = stage + (size_t)i * D;
    L.i[ph] = i;
    L.f[ph] = (info >> 16) - 1;
    L.b[ph] = v[i];
    L.lo[ph] = t_finite(v[D + i]) ? v[D + i] : -big;
    L.hi[ph] = t_finite(v[2 * D + i]) ? v[2 * D + i] : big;
    L.mu[ph] = v[3 * D + i];
  }
  // loads at a clamped index, not under a predicate per element: ptxas has
  // seven predicate registers, and predicated loads go out a few at a time.
  // Past D the row is +0 (see regs_half).
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
      const float x = row[ph][j < D ? j : D - 1];
      L.a[ph][j] = j < D ? x : 0.0f;
    }
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) rs[ph] += t_abs(L.a[ph][j]);
  }
#pragma unroll
  for (int ph = 0; ph < 2; ++ph) {
    const float d = tmax(row[ph][L.i[ph]], 1e-12f);
    L.scale[ph] = clampv(d / tmax(rs[ph], 1e-12f), 0.3f, 0.9f) / d;
  }
}

// The half-sweep of phase PH from the lane's registers and lam. The sums
// run over all RMAX terms without a predicate (an add under a predicate per
// term puts the predicate's latency in the chain): past D the row and lam
// (kept 0 there) are +0, and each such term adds +0 * +0 = +0, which leaves
// the sum's bits as they are, since a sum that starts at +0 is never -0 in
// round-to-nearest. So the sums equal the serial ones bit for bit.
template <int PH>
HD void regs_half(LaneRows& L, const float* lam) {
  if (!L.on[PH]) return;
  float x[RMAX];
#pragma unroll
  for (int q = 0; q < RMAX / 8; ++q) load8(lam + 8 * q, x + 8 * q);
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < RMAX; ++j) r += L.a[PH][j] * x[j];
  r += L.b[PH];
  float lo_e = L.lo[PH], hi_e = L.hi[PH];
  if (L.f[PH] >= 0) {
    const float lf = lam[L.f[PH]];
    lo_e = -L.mu[PH] * lf;
    hi_e = L.mu[PH] * lf;
  }
  L.out[PH] = clampv(lam[L.i[PH]] - r * L.scale[PH], lo_e, hi_e);
}

// Env e on the register path: its rows from the stage, then (next < B) the
// copy of env `next` into the stage, then the sweeps and lam out.
template <typename S>
HD void regs_env(Problem<S> p, S* stage, uint64_t* mbar, S* lam, const int* slot, int n0, int e,
                 int next, bool bulk) {
  if constexpr (sizeof(S) == 4) {
    const int D = p.D;
#ifdef __CUDA_ARCH__
    LaneRows st[1];
#define LANE_ROWS(l) st[0]
#else
    std::vector<LaneRows> st(WARP);
    poison(lam, (size_t)RMAX);
#define LANE_ROWS(l) st[l]
#endif
    // lam has RMAX values here (the room of nl and scale, which this path
    // does not use; regs_possible), 0 past D for the whole env
    lanes([&](int l) {
      LaneRows& L = LANE_ROWS(l);
      regs_rows(L, stage, D, n0, slot, l);
      for (int i = l; i < RMAX; i += WARP) lam[i] = 0.0f;
    });
    if (next < p.B) stage_env(p, stage, mbar, next, bulk);
    for (int it = 0; it < p.iters; ++it) {
      lanes([&](int l) { regs_half<0>(LANE_ROWS(l), lam); });
      lanes([&](int l) {
        LaneRows& L = LANE_ROWS(l);
        if (L.on[0]) lam[L.i[0]] = L.out[0];
      });
      lanes([&](int l) { regs_half<1>(LANE_ROWS(l), lam); });
      lanes([&](int l) {
        LaneRows& L = LANE_ROWS(l);
        if (L.on[1]) lam[L.i[1]] = L.out[1];
      });
    }
#undef LANE_ROWS
    S* out = p.lam + (int64_t)e * D;
    lanes([&](int l) {
      for (int i = l; i < D; i += WARP) out[i] = lam[i];
    });
  }
}

// ---- the direct path: A copied into slot order as it lands ----

// Start the copy of env e's A into buf (slot order, stride ld); one commit
// per lane.
template <typename S>
HD void issue_direct(Problem<S> p, S* buf, const int* pos, int e) {
  const int D = p.D, ld = D | 1;
  const S* src = p.A + (int64_t)e * D * D;
#ifndef __CUDA_ARCH__
  poison(buf, (size_t)D * (D | 1));
#endif
  lanes([&](int l) {
    // element k = r D + j of A, consecutive over the lanes; the
    // destinations of eight copies first, then the copies
    constexpr int AHEAD = 8;
    int r = l / D, j = l % D;
    for (int k0 = l; k0 < D * D; k0 += AHEAD * WARP) {
      int dst[AHEAD];
#pragma unroll
      for (int t = 0; t < AHEAD; ++t) {
        dst[t] = r < D ? pos[r] * ld + j : 0;
        for (j += WARP; j >= D; j -= D) ++r;
      }
#pragma unroll
      for (int t = 0; t < AHEAD; ++t)
        if (k0 + t * WARP < D * D) copy_async(buf + dst[t], src + k0 + t * WARP);
    }
    copies_commit();
  });
}

// Env e's sweeps on the warp from its A in As (slot order, stride D | 1) and
// its b, lo, hi, mu in device memory, with lam, nl and scale in shared
// memory.
template <typename S>
HD void solve_env(Problem<S> p, const S* As, S* lam, S* nl, S* scale, const int* slot, int n0,
                  int e) {
  const int D = p.D, ld = D | 1;
  const int64_t o = (int64_t)e * D;
  const S *bv = p.b + o, *lov = p.lo + o, *hiv = p.hi + o, *muv = p.mu + o;
  const S big = S(3.4e38);
#ifndef __CUDA_ARCH__
  poison(lam, 3 * (size_t)D);  // lam, nl, scale
#endif
  // the row scales, a lane's slots s and s + 32 at once (at D = 42 the
  // lanes below 10 have two)
  auto row_scale = [&](int s, S sum) {
    const S d = tmax(As[(size_t)s * ld + (slot[s] & 0xffff)], S(1e-12));
    scale[s] = clampv(d / tmax(sum, S(1e-12)), S(0.3), S(0.9)) / d;
  };
  lanes([&](int l) {
    for (int i = l; i < D; i += WARP) lam[i] = S(0);
    for (int s = l; s < D; s += 2 * WARP) {
      const int s2 = s + WARP < D ? s + WARP : s;
      S u, w;
      abs_sum2(As + (size_t)s * ld, As + (size_t)s2 * ld, D, &u, &w);
      row_scale(s, u);
      if (s2 != s) row_scale(s2, w);
    }
  });
  for (int it = 0; it < p.iters; ++it) {
    for (int phase = 0; phase < 2; ++phase) {  // 0: normal/limit rows, 1: friction rows
      const int s0 = phase ? n0 : 0, s1 = phase ? D : n0;
      lanes([&](int l) {
        for (int s = s0 + l; s < s1; s += WARP) {
          // the row's own operands first, then its dot product
          const int info = slot[s], i = info & 0xffff, f = (info >> 16) - 1;
          const S bi = bv[i], li = lam[i], sc = scale[s];
          S lo_e, hi_e;
          if (f >= 0) {
            const S m = muv[i], lf = lam[f];
            lo_e = -m * lf;
            hi_e = m * lf;
          } else {
            lo_e = t_finite(lov[i]) ? lov[i] : -big;
            hi_e = t_finite(hiv[i]) ? hiv[i] : big;
          }
          S r = dot_row(As + (size_t)s * ld, lam, D);
          r += bi;
          nl[s] = clampv(li - r * sc, lo_e, hi_e);
        }
      });
      lanes([&](int l) {
        for (int s = s0 + l; s < s1; s += WARP) lam[slot[s] & 0xffff] = nl[s];
      });
    }
  }
  S* out = p.lam + o;
  lanes([&](int l) {
    for (int i = l; i < D; i += WARP) out[i] = lam[i];
  });
}

// The direct path's loop over the warp's envs first, first + stride, ...:
// one buffer, each env's copy waited for, swept, then the next one's
// started. A function of its own on the card (not inlined), so that ptxas
// sizes the register path's registers for it alone: inlined beside the
// shared-memory paths, it took 232 registers where it needs 168, and fewer
// warps fit on an SM.
template <typename S>
HDN void direct_envs(Problem<S> p, S* wsh, const int* slot, const int* pos, int n0, int first,
                     int stride) {
  const int D = p.D;
  S* lam = wsh;
  S* nl = lam + D;
  S* scale = nl + D;
  S* buf = wsh + head_vals(sizeof(S), D);
  if (first < p.B) issue_direct(p, buf, pos, first);
  for (int64_t e = first; e < p.B; e += stride) {
    copies_wait<0>();
    solve_env(p, buf, lam, nl, scale, slot, n0, (int)e);
    if (e + stride < p.B) issue_direct(p, buf, pos, (int)(e + stride));
  }
}

// The warp's envs first, first + stride, ... in its shared memory wsh: the
// register path where it fits (the stage takes env n + 1 while the lanes
// sweep env n from their registers), else the direct path.
template <typename S>
HD void warp_envs(Problem<S> p, S* wsh, uint64_t* mbar, const int* slot, const int* pos, int n0,
                  int first, int stride, bool bulk) {
  const int D = p.D;
  if (!regs_fit(sizeof(S), D, n0)) return direct_envs(p, wsh, slot, pos, n0, first, stride);
  S* stage = wsh + head_vals(sizeof(S), D);
  if (first < p.B) stage_env(p, stage, mbar, first, bulk);
  int n = 0;
  for (int64_t e = first; e < p.B; e += stride, ++n) {
    stage_wait(mbar, n & 1, bulk);
    const int next = e + stride < p.B ? (int)(e + stride) : p.B;
    regs_env(p, stage, mbar, wsh, slot, n0, (int)e, next, bulk);
  }
}

#ifdef __CUDACC__
template <typename S>
__global__ void __launch_bounds__(MAX_WARPS* WARP)
    jacobi_sweeps_kernel(Problem<S> p, const int64_t* __restrict__ fidx, int bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / WARP, warp = threadIdx.x / WARP;
  const size_t wv = warp_vals(sizeof(S), p.D);
  S* base = reinterpret_cast<S*>(smem_raw);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(base + warps * wv) + warp;
  int* slot = reinterpret_cast<int*>(reinterpret_cast<uint64_t*>(base + warps * wv) + warps);
  int* pos = slot + p.D;
  S* wsh = base + warp * wv;
  const int first = blockIdx.x * warps + warp;
  mbar_init(mbar);
  const int n0 = build_lists(fidx, p.D, slot, pos, warp == 0);
  __syncthreads();
  warp_envs(p, wsh, mbar, slot, pos, n0, first, gridDim.x * warps, bulk != 0);
}

// the current device's opt-in shared memory per block, in bytes
inline long long smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// How a launch at D runs on the current device, computed once per device,
// dtype and D: warps per block, blocks per SM (from the occupancy the
// kernel gets), SMs, and the block's shared memory.
struct Config {
  int warps, blocks_per_sm, sms;
  size_t smem;
};
constexpr int CACHED_DEVICES = 16, CACHED_D = 256;

template <typename S>
static int compute_config(int D, Config* c) {
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if ((long long)block_bytes(sizeof(S), D, 1) > limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(jacobi_sweeps_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err != cudaSuccess) return (int)err;
  *c = Config{0, 0, sms, 0};
  // the warps per block that give the most warps per SM; ties: more per block
  for (int warps = MAX_WARPS; warps >= 1; warps /= 2) {
    const size_t bytes = block_bytes(sizeof(S), D, warps);
    if ((long long)bytes > limit) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jacobi_sweeps_kernel<S>,
                                                        warps * WARP, bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks * warps > c->blocks_per_sm * c->warps) *c = Config{warps, blocks, sms, bytes};
  }
  return c->blocks_per_sm > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <typename S>
static int config(int D, Config* c) {
  static Config cache[CACHED_DEVICES][CACHED_D];
  static std::atomic<bool> ready[CACHED_DEVICES][CACHED_D];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidDevice;
  if (dev >= CACHED_DEVICES || D >= CACHED_D) return compute_config<S>(D, c);
  if (ready[dev][D].load(std::memory_order_acquire)) {
    *c = cache[dev][D];
    return 0;
  }
  const int err = compute_config<S>(D, c);
  if (err) return err;
  cache[dev][D] = *c;
  ready[dev][D].store(true, std::memory_order_release);
  return 0;
}

template <typename S>
static int launch(const void* A, const void* b, const void* lo, const void* hi, const void* mu,
                  const void* fidx, void* lam, int B, int D, int iters, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  Config c;
  const int err = config<S>(D, &c);
  if (err) return err;
  const long long want = (B + (long long)c.warps - 1) / c.warps,
                  resident = (long long)c.blocks_per_sm * c.sms;
  const int grid = (int)(want < resident ? want : resident);
  const Problem<S> p{(const S*)A, (const S*)b, (const S*)lo, (const S*)hi, (const S*)mu, (S*)lam,
                     B, D, iters};
  jacobi_sweeps_kernel<S><<<grid, c.warps * WARP, c.smem, (cudaStream_t)stream>>>(
      p, (const int64_t*)fidx, (int)bulk_fits(sizeof(S), D, A));
  return (int)cudaGetLastError();
}

template <typename S>
static int describe(int D, int* out) {
  Config c;
  const int err = config<S>(D, &c);
  if (err) return err;
  out[0] = regs_possible(sizeof(S), D);
  out[1] = c.warps;
  out[2] = c.blocks_per_sm * c.warps;
  out[3] = (int)c.smem;
  out[4] = (int)(sizeof(S) * warp_vals(sizeof(S), D));
  return 0;
}
#else
// Host build: one warp runs every env in turn, on the card's layout, path
// and copy (a bulk copy is a memcpy here).
template <typename S>
static int launch(const void* A, const void* b, const void* lo, const void* hi, const void* mu,
                  const void* fidx, void* lam, int B, int D, int iters, void*) {
  if (B <= 0 || D <= 0) return 0;
  std::vector<S> wsh(warp_vals(sizeof(S), D) + 8);  // + the row sums' slack
  std::vector<int> lists(2 * (size_t)D);
  uint64_t mbar = 0;
  const int n0 = build_lists((const int64_t*)fidx, D, lists.data(), lists.data() + D, true);
  const Problem<S> p{(const S*)A, (const S*)b, (const S*)lo, (const S*)hi, (const S*)mu, (S*)lam,
                     B, D, iters};
  warp_envs(p, wsh.data(), &mbar, lists.data(), lists.data() + D, n0, 0, 1,
            bulk_fits(sizeof(S), D, A));
  return 0;
}

template <typename S>
static int describe(int D, int* out) {
  out[0] = regs_possible(sizeof(S), D);
  out[1] = 1;
  out[2] = 0;  // no card: no occupancy
  out[3] = (int)block_bytes(sizeof(S), D, 1);
  out[4] = (int)(sizeof(S) * warp_vals(sizeof(S), D));
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

// the largest D for values of `elem_bytes` bytes and `limit` bytes of shared
// memory per block
int jacobi_sweeps_max_rows_for(int elem_bytes, long long limit) {
  return sweeps::max_rows(elem_bytes, limit);
}

// The launch at D in values of `elem_bytes` bytes: out = {buffers per warp,
// warps per block, warps per SM (0 in the host build), shared bytes per
// block, shared bytes per warp}. Returns a CUDA error code.
int jacobi_sweeps_config(int elem_bytes, int D, int* out) {
  return elem_bytes == 4 ? sweeps::describe<float>(D, out) : sweeps::describe<double>(D, out);
}

// The phase lists of fidx (D,) int64, as the kernel builds them: slot[s] =
// row | (fidx[row] + 1) << 16 (0 above the row for fidx < 0), pos[row] = s.
// Returns n0, the number of rows with fidx < 0 (slots 0..n0-1).
int jacobi_sweeps_lists(const void* fidx, int D, int* slot, int* pos) {
  return sweeps::build_lists((const int64_t*)fidx, D, slot, pos, true);
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
