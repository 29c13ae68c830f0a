// Fused constrained timestep for Hopper (sm_90a): one thread per env.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// diffdart_tpu/ops/pallas_step.py:55 (built by build_pallas_step), whose body
// is diffdart_tpu/sim/tilestep.py::build_tile_step. The plain PyTorch version
// of the same arithmetic is diffdart_tpu_torch/sim/tilestep.py; this file
// follows it op for op and in the same summation order, so the two agree to
// rounding (bit for bit where the order is the same, since the build turns
// off FMA contraction: -fmad=false, and keeps IEEE sin/cos/sqrt/division).
//
// What it computes, per env: FK, world motion subspaces, body velocities, the
// structured world inertias, the mass matrix (plus armature and implicit
// damping/spring terms), bias forces, an unrolled Cholesky and Minv, v*,
// capsule/sphere/box vs fixed-plane contacts, the LCP rows (contact normal,
// two friction rows per contact, joint-limit rows, servo and joint-friction
// rows), the matrix-free boxed LCP
// (diag and |A| row sums from D^2 dot products of length nv, phased Jacobi
// sweeps applying J Minv J^T + cfm, then two guarded Woodbury polish passes,
// each building S = cfm M + J^T (I+B) F J and solving it by Gaussian
// elimination without pivoting), v' = v* + Minv J^T lam and the
// position update.
//
// Forward-only saving: the TPU kernel ends _tile_lcp with a probe pass and a
// gradient pass (sim/tilestep.py:1160-1180) whose value is exactly `best`
// (best + (g - g) == best for finite g, and non-finite envs select best), so
// this kernel returns `best` directly and skips both passes.
//
// Model data: the TPU kernel bakes the model in as trace constants. Here the
// model is a packed descriptor in device memory (DescI: topology as int32;
// DescF<T>: parameters in the state dtype), built once per model by
// ops/fused_step.py, which also checks every size cap below and raises for a
// model over one. The subset is the plain version's: REVOLUTE / PRISMATIC /
// PLANAR / WELD / FREE / BALL joints (quaternion FK and geometric
// integration), capsule / sphere / box vs fixed-plane contacts, joint-limit
// rows, and servo / joint-friction rows with constant boxes.
//
// What bounds it on the H100: not DRAM. An env reads 3 vectors and writes 2
// (5 x 9 values for the half-cheetah), but its LCP at D = 42, nv = 9 does tens
// of thousands of dependent flops on per-thread arrays (J and W alone are
// 2 x 42 x 9 values) that do not fit in registers and live in local memory
// (L1/L2). At B = 4096 one thread per env also gives only 128 warps for 132
// SMs, so the kernel is latency bound: few warps per SM to hide local-memory
// and dependent-arithmetic latency. This first version keeps that simple
// design (32-thread blocks, one warp per SM) and states its time beside the
// bound in PERF.md; a warp per env with J and W in shared memory, or an
// in-kernel time loop, are the next steps.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace fused {

constexpr int MAX_NB = 16;
constexpr int MAX_NQ = 16;
constexpr int MAX_NV = 16;
constexpr int MAX_PAIRS = 16;
constexpr int MAX_NC = 32;
constexpr int MAX_LIM = 16;
constexpr int MAX_D = 64;

enum { J_WELD = 0, J_REVOLUTE = 1, J_PRISMATIC = 2, J_BALL = 5, J_PLANAR = 9, J_FREE = 10 };
enum { G_SPHERE = 0, G_BOX = 1, G_CAPSULE = 2 };

// Field order and sizes must match _I_LAYOUT / _F_LAYOUT in
// ops/fused_step.py (checked at load time through fused_step_layout).
struct DescI {
  int nb, nq, nv, npair, nc, nlim, nservo, nfric, D, iters, passes;
  int parent[MAX_NB];
  int jtype[MAX_NB];
  int q_off[MAX_NB];
  int v_off[MAX_NB];
  int anc[MAX_NB][MAX_NV];  // 1 iff dof j is on the path from the world to body b
  int dof_body[MAX_NV];
  int dof_qidx[MAX_NV];
  int pair_body[MAX_PAIRS];
  int pair_type[MAX_PAIRS];
  int lim_dof[MAX_LIM];
  int servo_dof[MAX_NV];
  int fric_dof[MAX_NV];
};

template <typename T>
struct DescF {
  T X_rot[MAX_NB][9];
  T X_pos[MAX_NB][3];
  T axis[MAX_NB][3];
  T axis2[MAX_NB][3];
  T rot_ax[MAX_NB][3];  // rotation axis: axis (REVOLUTE), axis x axis2 (PLANAR)
  T rot_K[MAX_NB][9];   // [rot_ax]x
  T rot_K2[MAX_NB][9];  // rot_ax rot_ax^T - I
  T mass[MAX_NB];
  T com[MAX_NB][3];
  T inertia[MAX_NB][9];
  T damping[MAX_NV];
  T m_extra[MAX_NV];  // armature + dt damping + dt^2 spring
  T spring[MAX_NV];
  T q_rest[MAX_NV];
  T lim_lo[MAX_LIM];
  T lim_hi[MAX_LIM];
  T neg_grav[3];
  T dt, cfm, erp_dt;
  T pair_rot[MAX_PAIRS][9];  // geom frame in body frame
  T pair_pos[MAX_PAIRS][3];
  T pair_size[MAX_PAIRS][3];
  T pair_n[MAX_PAIRS][3];  // plane normal (world)
  T pair_p[MAX_PAIRS][3];  // plane point (world)
  T pair_t1[MAX_PAIRS][3];
  T pair_t2[MAX_PAIRS][3];
  T pair_mu[MAX_PAIRS];
  T pair_rest[MAX_PAIRS];
  T servo_tgt[MAX_NV];  // per servo row
  T box_c[2 * MAX_NV];  // constant boxes [-c, c]: servo rows, then joint-friction rows
};

// max/min that propagate NaN like torch.maximum/minimum
template <typename T>
HD T tmax(T a, T b) { return (a != a) ? a : ((b != b) ? b : (a > b ? a : b)); }
template <typename T>
HD T tmin(T a, T b) { return (a != a) ? a : ((b != b) ? b : (a < b ? a : b)); }
template <typename T>
HD T tclip(T x, T lo, T hi) { return tmin(tmax(x, lo), hi); }

HD float t_sin(float x) { return sinf(x); }
HD double t_sin(double x) { return sin(x); }
HD float t_cos(float x) { return cosf(x); }
HD double t_cos(double x) { return cos(x); }
HD float t_sqrt(float x) { return sqrtf(x); }
HD double t_sqrt(double x) { return sqrt(x); }
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float t_rsqrt(float x) { return rsqrtf(x); }  // as torch.rsqrt on CUDA
__device__ __forceinline__ double t_rsqrt(double x) { return rsqrt(x); }
#else
inline float t_rsqrt(float x) { return 1.0f / sqrtf(x); }  // as torch.rsqrt on the CPU
inline double t_rsqrt(double x) { return 1.0 / sqrt(x); }
#endif
HD float t_abs(float x) { return fabsf(x); }
HD double t_abs(double x) { return fabs(x); }
HD bool t_finite(float x) { return isfinite(x); }
HD bool t_finite(double x) { return isfinite(x); }

// safe_div: plain division in f64; in f32 a dead denominator (|den| <= 1e-20)
// contributes 0 (ops/tile.py:safe_div)
HD double safe_div(double n, double d) { return n / d; }
HD float safe_div(float n, float d) { return fabsf(d) <= 1e-20f ? 0.0f : n / d; }

template <typename T>
HD T dot3(const T* a, const T* b) {
  T acc = a[0] * b[0];
  acc = acc + a[1] * b[1];
  acc = acc + a[2] * b[2];
  return acc;
}

// out = A B (row-major 3x3)
template <typename T>
HD void matmul3(const T* A, const T* B, T* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T acc = A[i * 3 + 0] * B[0 * 3 + j];
      acc = acc + A[i * 3 + 1] * B[1 * 3 + j];
      acc = acc + A[i * 3 + 2] * B[2 * 3 + j];
      out[i * 3 + j] = acc;
    }
}

// out = A B^T
template <typename T>
HD void matmul3_bt(const T* A, const T* B, T* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T acc = A[i * 3 + 0] * B[j * 3 + 0];
      acc = acc + A[i * 3 + 1] * B[j * 3 + 1];
      acc = acc + A[i * 3 + 2] * B[j * 3 + 2];
      out[i * 3 + j] = acc;
    }
}

template <typename T>
HD void matvec3(const T* R, const T* x, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = dot3(R + 3 * i, x);
}

template <typename T>
HD void matTvec3(const T* R, const T* x, T* out) {
  for (int i = 0; i < 3; ++i) {
    T acc = R[0 * 3 + i] * x[0];
    acc = acc + R[1 * 3 + i] * x[1];
    acc = acc + R[2 * 3 + i] * x[2];
    out[i] = acc;
  }
}

template <typename T>
HD void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Rodrigues for a constant unit axis: R = (I + s K) + (1 - c) K2
template <typename T>
HD void exp_so3(const T* K, const T* K2, T theta, T* R) {
  const T s = t_sin(theta), c = t_cos(theta);
  const T omc = T(1) - c;
  for (int k = 0; k < 9; ++k) {
    const T d = (k % 4 == 0) ? T(1) : T(0);
    R[k] = (d + s * K[k]) + omc * K2[k];
  }
}

// Structured world spatial inertia applied to a motion (w, vl):
//   n = Ic_w w + m (c x vl - c x (c x w));  f = m vl - m c x w
template <typename T>
HD void iw_apply(T m, const T* c, const T* Icw, const T* w, const T* vl, T* n, T* f) {
  T cxw[3], cxv[3], cxcxw[3], Iw[3];
  cross3(c, w, cxw);
  cross3(c, vl, cxv);
  cross3(c, cxw, cxcxw);
  matvec3(Icw, w, Iw);
  for (int k = 0; k < 3; ++k) {
    n[k] = Iw[k] + (cxv[k] - cxcxw[k]) * m;
    f[k] = vl[k] * m - cxw[k] * m;
  }
}

// q <- q / |q| (ops/tile.py quat_normalize_t)
template <typename T>
HD void quat_normalize(const T* q, T* out) {
  T n2 = q[0] * q[0];
  n2 = n2 + q[1] * q[1];
  n2 = n2 + q[2] * q[2];
  n2 = n2 + q[3] * q[3];
  const T inv = t_rsqrt(n2);
  for (int k = 0; k < 4; ++k) out[k] = q[k] * inv;
}

template <typename T>
HD void quat_to_mat(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = T(1) - (yy + zz) * T(2);
  R[1] = (xy - wz) * T(2);
  R[2] = (xz + wy) * T(2);
  R[3] = (xy + wz) * T(2);
  R[4] = T(1) - (xx + zz) * T(2);
  R[5] = (yz - wx) * T(2);
  R[6] = (xz - wy) * T(2);
  R[7] = (yz + wx) * T(2);
  R[8] = T(1) - (xx + yy) * T(2);
}

// R^3 -> unit quaternion, half-angle convention, Taylor branch near 0
template <typename T>
HD void quat_exp(const T* v, T* out) {
  const T h2 = dot3(v, v) * T(0.25);
  T w, sinc;
  if (h2 < T(1e-8)) {
    w = (T(1) - h2 / T(2)) + (h2 * h2) / T(24);
    sinc = (T(1) - h2 / T(6)) + (h2 * h2) / T(120);
  } else {
    const T r = t_sqrt(h2);
    w = t_cos(r);
    sinc = t_sin(r) / r;
  }
  const T s = sinc * T(0.5);
  out[0] = w;
  for (int k = 0; k < 3; ++k) out[1 + k] = s * v[k];
}

template <typename T>
HD void quat_mul(const T* a, const T* b, T* out) {
  out[0] = (a[0] * b[0] - a[1] * b[1]) - (a[2] * b[2] + a[3] * b[3]);
  out[1] = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) - a[3] * b[2];
  out[2] = (a[0] * b[2] - a[1] * b[3]) + (a[2] * b[0] + a[3] * b[1]);
  out[3] = (a[0] * b[3] + a[1] * b[2]) + (a[3] * b[0] - a[2] * b[1]);
}

template <typename T>
struct Lcp {
  int D, nc, nv;
  int box0;  // first constant-box row (servo, then joint friction)
  T J[MAX_D][MAX_NV];
  T box_c[2 * MAX_NV];
  T b[MAX_D];
  T mu[MAX_NC];
  bool valid[MAX_D];
  T cfm;

  HD bool is_fr(int i) const { return i >= nc && i < 3 * nc; }
  HD int fidx(int i) const { return i < 2 * nc ? i - nc : i - 2 * nc; }
  HD bool is_box(int i) const { return i >= box0; }

  // project a candidate onto the row's box; invalid rows pin to 0
  HD T clip_row(int i, T cand, const T* lam) const {
    T c;
    if (is_fr(i)) {
      const T bound = mu[fidx(i)] * lam[fidx(i)];
      c = tclip(cand, -bound, bound);
    } else if (is_box(i)) {
      c = tclip(cand, -box_c[i - box0], box_c[i - box0]);
    } else {
      c = tmax(cand, T(0));
    }
    return valid[i] ? c : T(0);
  }

  // out = J Minv J^T lam + cfm lam, matrix-free
  HD void matvec(const T (*Minv)[MAX_NV], const T* lam, T* out) const {
    T jt[MAX_NV], u[MAX_NV];
    for (int j = 0; j < nv; ++j) jt[j] = T(0);
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < nv; ++j) jt[j] = jt[j] + J[i][j] * lam[i];
    for (int k = 0; k < nv; ++k) {
      T acc = T(0);
      for (int j = 0; j < nv; ++j) acc = acc + Minv[k][j] * jt[j];
      u[k] = acc;
    }
    for (int i = 0; i < D; ++i) {
      T acc = cfm * lam[i];
      for (int j = 0; j < nv; ++j) acc = acc + J[i][j] * u[j];
      out[i] = acc;
    }
  }

  HD T nat_residual(const T (*Minv)[MAX_NV], const T* lam) const {
    T w[MAX_D];
    matvec(Minv, lam, w);
    T res = T(0);
    for (int i = 0; i < D; ++i) {
      const T proj = clip_row(i, lam[i] - (w[i] + b[i]), lam);
      res = tmax(res, t_abs(lam[i] - proj));
    }
    return res;
  }

  // one active-set Woodbury pass from iterate lam (sim/tilestep.py one_pass)
  HD void one_pass(const T (*M)[MAX_NV], const T* lam, T* out) const {
    const T tol = T(1e-8);
    T Ff[MAX_D], fbm[MAX_D], pin[MAX_D];
    for (int i = 0; i < D; ++i) {
      pin[i] = T(0);
      const T tol_sc = tmax(t_abs(lam[i]), T(1)) * tol;
      if (is_fr(i)) {
        const T bound = mu[fidx(i)] * lam[fidx(i)];
        const bool at_lo = lam[i] <= tol_sc - bound;
        const bool at_hi = lam[i] >= bound - tol_sc;
        const bool degen = at_lo && at_hi;
        const bool free_ = !at_lo && !at_hi && valid[i];
        const bool frb = (at_lo || at_hi) && !degen && valid[i];
        Ff[i] = free_ ? T(1) : T(0);
        fbm[i] = ((frb ? T(1) : T(0)) * (at_hi ? T(1) : T(-1))) * mu[fidx(i)];
      } else if (is_box(i)) {
        // constant box [-c, +c]: at-bound rows pin to +-c, entering the KKT
        // rhs as cfm * c_pin
        const T cb = box_c[i - box0];
        const bool at_lo = lam[i] <= tol_sc - cb;
        const bool at_hi = lam[i] >= cb - tol_sc;
        const bool degen = at_lo && at_hi;
        const bool pinned = (at_lo || at_hi) && !degen && valid[i];
        Ff[i] = (!at_lo && !at_hi && valid[i]) ? T(1) : T(0);
        fbm[i] = T(0);
        pin[i] = ((pinned ? T(1) : T(0)) * (at_hi ? T(1) : T(-1))) * cb;
      } else {
        Ff[i] = (!(lam[i] <= tol_sc) && valid[i]) ? T(1) : T(0);
        fbm[i] = T(0);
      }
    }
    // S = cfm M + J^T (I+B) F J
    T S[MAX_NV][MAX_NV];
    for (int a = 0; a < nv; ++a)
      for (int c = 0; c < nv; ++c) S[a][c] = cfm * M[a][c];
    for (int i = 0; i < D; ++i) {
      T X[MAX_NV];
      for (int j = 0; j < nv; ++j) X[j] = Ff[i] * J[i][j];
      if (is_fr(i)) {
        const int n = fidx(i);
        const T coef = fbm[i] * Ff[n];
        for (int j = 0; j < nv; ++j) X[j] = X[j] + coef * J[n][j];
      }
      for (int a = 0; a < nv; ++a)
        for (int c = 0; c < nv; ++c) S[a][c] = S[a][c] + J[i][a] * X[c];
    }
    // rhs_u = J^T (I+B) r with r = -F b
    T r[MAX_D], rhs[MAX_NV], u[MAX_NV];
    for (int i = 0; i < D; ++i) r[i] = Ff[i] * (-b[i]);
    for (int j = 0; j < nv; ++j) rhs[j] = T(0);
    for (int i = 0; i < D; ++i) {
      T t = r[i];
      if (is_fr(i)) t = t + fbm[i] * r[fidx(i)];
      if (is_box(i)) t = t + cfm * pin[i];
      for (int j = 0; j < nv; ++j) rhs[j] = rhs[j] + J[i][j] * t;
    }
    // Gaussian elimination without pivoting (S is unsymmetric when the
    // friction-bound coupling is active); exact zeros below the diagonal are
    // skipped as the plain version skips its structural zeros
    for (int k = 0; k < nv - 1; ++k)
      for (int i = k + 1; i < nv; ++i) {
        if (S[i][k] == T(0)) continue;
        const T f = safe_div(S[i][k], S[k][k]);
        for (int j = k + 1; j < nv; ++j) S[i][j] = S[i][j] - f * S[k][j];
        rhs[i] = rhs[i] - f * rhs[k];
      }
    for (int i = nv - 1; i >= 0; --i) {
      T s = rhs[i];
      for (int j = i + 1; j < nv; ++j) s = s - S[i][j] * u[j];
      u[i] = safe_div(s, S[i][i]);
    }
    // x = (r - F J u) / cfm on the free set; lam' = (I+B) x, projected
    T x[MAX_D];
    for (int i = 0; i < D; ++i) {
      T ju = T(0);
      for (int j = 0; j < nv; ++j) ju = ju + J[i][j] * u[j];
      x[i] = Ff[i] * ((r[i] - Ff[i] * ju) / cfm);
    }
    T lam_new[MAX_D];
    for (int i = 0; i < D; ++i) {
      T t = x[i];
      if (is_fr(i)) t = t + fbm[i] * x[fidx(i)];
      if (is_box(i)) t = t + pin[i];
      lam_new[i] = t;
    }
    for (int i = 0; i < D; ++i) out[i] = clip_row(i, lam_new[i], lam_new);
  }
};

template <typename T>
HD void env_step(const DescI& I, const DescF<T>& F, const T* __restrict__ q_in,
                 const T* __restrict__ v_in, const T* __restrict__ tau_in, T* __restrict__ q_out,
                 T* __restrict__ v_out, int B, int e) {
  const int nb = I.nb, nq = I.nq, nv = I.nv;
  const T dt = F.dt;
  T q[MAX_NQ], v[MAX_NV], tau[MAX_NV];
  for (int k = 0; k < nq; ++k) q[k] = q_in[(int64_t)k * B + e];
  for (int k = 0; k < nv; ++k) {
    v[k] = v_in[(int64_t)k * B + e];
    tau[k] = tau_in[(int64_t)k * B + e];
  }

  // ---------------- FK ----------------
  T R[MAX_NB][9], P[MAX_NB][3];
  for (int i = 0; i < nb; ++i) {
    const int o = I.q_off[i];
    T Rj[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    T pj[3] = {0, 0, 0};
    const int jt = I.jtype[i];
    if (jt == J_REVOLUTE) {
      exp_so3(F.rot_K[i], F.rot_K2[i], q[o], Rj);
    } else if (jt == J_PRISMATIC) {
      for (int k = 0; k < 3; ++k) pj[k] = F.axis[i][k] * q[o];
    } else if (jt == J_PLANAR) {
      exp_so3(F.rot_K[i], F.rot_K2[i], q[o + 2], Rj);
      for (int k = 0; k < 3; ++k) pj[k] = F.axis[i][k] * q[o] + F.axis2[i][k] * q[o + 1];
    } else if (jt == J_FREE || jt == J_BALL) {
      T qn[4];
      quat_normalize(q + o, qn);
      quat_to_mat(qn, Rj);
      if (jt == J_FREE)
        for (int k = 0; k < 3; ++k) pj[k] = q[o + 4 + k];
    }
    T Rpc[9], ppc[3];
    matmul3(F.X_rot[i], Rj, Rpc);
    matvec3(F.X_rot[i], pj, ppc);
    for (int k = 0; k < 3; ++k) ppc[k] = ppc[k] + F.X_pos[i][k];
    const int par = I.parent[i];
    if (par < 0) {
      for (int k = 0; k < 9; ++k) R[i][k] = Rpc[k];
      for (int k = 0; k < 3; ++k) P[i][k] = ppc[k];
    } else {
      matmul3(R[par], Rpc, R[i]);
      matvec3(R[par], ppc, P[i]);
      for (int k = 0; k < 3; ++k) P[i][k] = P[i][k] + P[par][k];
    }
  }

  // ---------------- world motion subspace columns Sw = (w, v) per dof -------
  T Sw[MAX_NV][6];
  for (int i = 0; i < nb; ++i) {
    const int o = I.v_off[i];
    const int jt = I.jtype[i];
    int nrow = 0;
    T wl[6][3], vl[6][3];
    if (jt == J_REVOLUTE) {
      nrow = 1;
      for (int k = 0; k < 3; ++k) { wl[0][k] = F.axis[i][k]; vl[0][k] = T(0); }
    } else if (jt == J_PRISMATIC) {
      nrow = 1;
      for (int k = 0; k < 3; ++k) { wl[0][k] = T(0); vl[0][k] = F.axis[i][k]; }
    } else if (jt == J_PLANAR) {
      nrow = 3;
      T Rj[9];
      exp_so3(F.rot_K[i], F.rot_K2[i], q[I.q_off[i] + 2], Rj);
      matTvec3(Rj, F.axis[i], vl[0]);
      matTvec3(Rj, F.axis2[i], vl[1]);
      for (int k = 0; k < 3; ++k) {
        wl[0][k] = T(0);
        wl[1][k] = T(0);
        wl[2][k] = F.rot_ax[i][k];
        vl[2][k] = T(0);
      }
    } else if (jt == J_FREE || jt == J_BALL) {
      // S = I6 (FREE: 3 angular then 3 linear unit rows) or [I3 | 0] (BALL)
      nrow = jt == J_FREE ? 6 : 3;
      for (int r = 0; r < nrow; ++r)
        for (int k = 0; k < 3; ++k) {
          wl[r][k] = (r < 3 && k == r) ? T(1) : T(0);
          vl[r][k] = (r >= 3 && k == r - 3) ? T(1) : T(0);
        }
    }
    for (int r = 0; r < nrow; ++r) {
      T ww[3], rv[3], pxw[3];
      matvec3(R[i], wl[r], ww);
      matvec3(R[i], vl[r], rv);
      cross3(P[i], ww, pxw);
      for (int k = 0; k < 3; ++k) {
        Sw[o + r][k] = ww[k];
        Sw[o + r][3 + k] = rv[k] + pxw[k];
      }
    }
  }

  // ---------------- body velocities ----------------
  T V[MAX_NB][6];
  for (int b = 0; b < nb; ++b) {
    for (int k = 0; k < 6; ++k) V[b][k] = T(0);
    for (int j = 0; j < nv; ++j)
      if (I.anc[b][j])
        for (int k = 0; k < 6; ++k) V[b][k] = V[b][k] + Sw[j][k] * v[j];
  }

  // ---------------- world spatial inertia (structured) ----------------
  T cw[MAX_NB][3], Icw[MAX_NB][9];
  for (int b = 0; b < nb; ++b) {
    matvec3(R[b], F.com[b], cw[b]);
    for (int k = 0; k < 3; ++k) cw[b][k] = cw[b][k] + P[b][k];
    T RI[9];
    matmul3(R[b], F.inertia[b], RI);
    matmul3_bt(RI, R[b], Icw[b]);
  }

  // ---------------- mass matrix ----------------
  T M[MAX_NV][MAX_NV];
  for (int a = 0; a < nv; ++a)
    for (int c = 0; c < nv; ++c) M[a][c] = T(0);
  for (int b = 0; b < nb; ++b) {
    for (int jj = 0; jj < nv; ++jj) {
      if (!I.anc[b][jj]) continue;
      T n[3], f[3];
      iw_apply(F.mass[b], cw[b], Icw[b], Sw[jj], Sw[jj] + 3, n, f);
      for (int ii = 0; ii <= jj; ++ii) {
        if (!I.anc[b][ii]) continue;
        M[ii][jj] = M[ii][jj] + (dot3(Sw[ii], n) + dot3(Sw[ii] + 3, f));
      }
    }
  }
  for (int i = 0; i < nv; ++i) {
    M[i][i] = M[i][i] + F.m_extra[i];
    for (int j = 0; j < i; ++j) M[i][j] = M[j][i];
  }

  // ---------------- bias forces C ----------------
  T sdot[MAX_NV][6];
  for (int j = 0; j < nv; ++j) {
    const int b = I.dof_body[j];
    T sw[3], sv1[3], sv2[3];
    cross3(V[b], Sw[j], sw);
    cross3(V[b], Sw[j] + 3, sv1);
    cross3(V[b] + 3, Sw[j], sv2);
    for (int k = 0; k < 3; ++k) {
      sdot[j][k] = sw[k];
      sdot[j][3 + k] = sv1[k] + sv2[k];
    }
    const int kk = j - I.v_off[b];
    if (I.jtype[b] == J_PLANAR && kk < 2) {
      // d/dt (Rj^T a) = -q2dot (n x (Rj^T a)); world lin = R_b @ that
      T Rj[9], rta[3], nx[3], dlin[3], wd[3];
      exp_so3(F.rot_K[b], F.rot_K2[b], q[I.q_off[b] + 2], Rj);
      matTvec3(Rj, kk == 0 ? F.axis[b] : F.axis2[b], rta);
      cross3(F.rot_ax[b], rta, nx);
      for (int k = 0; k < 3; ++k) dlin[k] = nx[k] * v[I.v_off[b] + 2];
      matvec3(R[b], dlin, wd);
      for (int k = 0; k < 3; ++k) sdot[j][3 + k] = sdot[j][3 + k] - wd[k];
    }
  }
  T C[MAX_NV];
  for (int i = 0; i < nv; ++i) C[i] = T(0);
  for (int b = 0; b < nb; ++b) {
    T a[6] = {0, 0, 0, F.neg_grav[0], F.neg_grav[1], F.neg_grav[2]};
    for (int j = 0; j < nv; ++j)
      if (I.anc[b][j])
        for (int k = 0; k < 6; ++k) a[k] = a[k] + sdot[j][k] * v[j];
    T Fn[3], Ff[3], nIV[3], fIV[3], c1[3], c2[3], c3[3];
    iw_apply(F.mass[b], cw[b], Icw[b], a, a + 3, Fn, Ff);
    iw_apply(F.mass[b], cw[b], Icw[b], V[b], V[b] + 3, nIV, fIV);
    cross3(V[b], nIV, c1);
    cross3(V[b] + 3, fIV, c2);
    cross3(V[b], fIV, c3);
    for (int k = 0; k < 3; ++k) {
      Fn[k] = Fn[k] + (c1[k] + c2[k]);
      Ff[k] = Ff[k] + c3[k];
    }
    for (int i = 0; i < nv; ++i)
      if (I.anc[b][i]) C[i] = C[i] + (dot3(Sw[i], Fn) + dot3(Sw[i] + 3, Ff));
  }

  // ---------------- unconstrained velocity ----------------
  T rhs[MAX_NV];
  for (int i = 0; i < nv; ++i) {
    T fj = (-F.damping[i]) * v[i];
    if (F.spring[i] != T(0))
      fj = fj - F.spring[i] * ((q[I.dof_qidx[i]] - F.q_rest[i]) + dt * v[i]);
    rhs[i] = tau[i] + (fj - C[i]);
  }
  T L[MAX_NV][MAX_NV];
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j <= i; ++j) {
      T s = M[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j)
        L[i][i] = t_sqrt(tmax(s, T(1e-12)));
      else
        L[i][j] = s / L[j][j];
    }
  T Minv[MAX_NV][MAX_NV];
  for (int col = 0; col < nv; ++col) {
    T y[MAX_NV], x[MAX_NV];
    for (int i = 0; i < nv; ++i) {
      T s = (i == col) ? T(1) : T(0);
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s / L[i][i];
    }
    for (int i = nv - 1; i >= 0; --i) {
      T s = y[i];
      for (int k = i + 1; k < nv; ++k) s = s - L[k][i] * x[k];
      x[i] = s / L[i][i];
    }
    for (int i = 0; i < nv; ++i) Minv[i][col] = x[i];
  }
  T v_star[MAX_NV];
  for (int i = 0; i < nv; ++i) {
    T acc = T(0);
    for (int k = 0; k < nv; ++k) acc = acc + Minv[i][k] * rhs[k];
    v_star[i] = v[i] + dt * acc;
  }

  T v_new[MAX_NV];
  const int D = I.D;
  if (D == 0) {
    for (int i = 0; i < nv; ++i) v_new[i] = v_star[i];
  } else {
    Lcp<T> lcp;
    lcp.D = D;
    lcp.nc = I.nc;
    lcp.nv = nv;
    lcp.cfm = F.cfm;
    const int nc = I.nc;
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < nv; ++j) lcp.J[i][j] = T(0);

    // ---------------- contacts (geom vs fixed plane) and their rows ------
    int c = 0;
    for (int p = 0; p < I.npair; ++p) {
      const int b = I.pair_body[p];
      const int gt = I.pair_type[p];
      T Rg[9], pg[3];
      matmul3(R[b], F.pair_rot[p], Rg);
      matvec3(R[b], F.pair_pos[p], pg);
      for (int k = 0; k < 3; ++k) pg[k] = pg[k] + P[b][k];
      const T* n = F.pair_n[p];
      const int nslot = gt == G_BOX ? 8 : (gt == G_CAPSULE ? 2 : 1);
      for (int s = 0; s < nslot; ++s, ++c) {
        T cpt[3], pos[3], dv[3], depth;
        if (gt == G_BOX) {
          // corners in (sx, sy, sz) order, each from -1 to +1
          const T loc[3] = {F.pair_size[p][0] * ((s & 4) ? T(1) : T(-1)),
                            F.pair_size[p][1] * ((s & 2) ? T(1) : T(-1)),
                            F.pair_size[p][2] * ((s & 1) ? T(1) : T(-1))};
          matvec3(Rg, loc, cpt);
          for (int k = 0; k < 3; ++k) cpt[k] = cpt[k] + pg[k];
          for (int k = 0; k < 3; ++k) dv[k] = cpt[k] - F.pair_p[p][k];
          depth = -dot3(dv, n);
          for (int k = 0; k < 3; ++k) pos[k] = cpt[k] + n[k] * (depth * T(0.5));
        } else {
          const T r = F.pair_size[p][0];
          if (gt == G_CAPSULE) {
            const T hl = F.pair_size[p][1];
            for (int k = 0; k < 3; ++k) {
              const T d = Rg[k * 3 + 2] * hl;
              cpt[k] = s == 0 ? pg[k] - d : pg[k] + d;
            }
          } else {
            for (int k = 0; k < 3; ++k) cpt[k] = pg[k];
          }
          for (int k = 0; k < 3; ++k) dv[k] = cpt[k] - F.pair_p[p][k];
          depth = r - dot3(dv, n);
          const T back = r - depth * T(0.5);
          for (int k = 0; k < 3; ++k) pos[k] = cpt[k] - n[k] * back;
        }
        // rows: normal, t1, t2 over the body's ancestor dofs
        for (int j = 0; j < nv; ++j) {
          if (!I.anc[b][j]) continue;
          T wxp[3], lin[3];
          cross3(Sw[j], pos, wxp);
          for (int k = 0; k < 3; ++k) lin[k] = Sw[j][3 + k] + wxp[k];
          lcp.J[c][j] = dot3(lin, n);
          lcp.J[nc + c][j] = dot3(lin, F.pair_t1[p]);
          lcp.J[2 * nc + c][j] = dot3(lin, F.pair_t2[p]);
        }
        T target = tmin(F.erp_dt * tmax(depth - T(1e-5), T(0)), T(2));
        if (F.pair_rest[p] != T(0)) {
          T vn = T(0);
          for (int j = 0; j < nv; ++j) vn = vn + lcp.J[c][j] * v[j];
          const T bounce = F.pair_rest[p] * tmax(-vn - T(0.01), T(0));
          target = tmax(target, bounce);
        }
        T bn = T(0), bt1 = T(0), bt2 = T(0);
        for (int j = 0; j < nv; ++j) {
          bn = bn + lcp.J[c][j] * v_star[j];
          bt1 = bt1 + lcp.J[nc + c][j] * v_star[j];
          bt2 = bt2 + lcp.J[2 * nc + c][j] * v_star[j];
        }
        lcp.b[c] = bn - target;
        lcp.b[nc + c] = bt1;
        lcp.b[2 * nc + c] = bt2;
        const bool ok = depth > T(0);
        lcp.valid[c] = lcp.valid[nc + c] = lcp.valid[2 * nc + c] = ok;
        lcp.mu[c] = F.pair_mu[p];
      }
    }
    // ---------------- joint-limit rows ----------------
    const int nlim = I.nlim;
    for (int li = 0; li < nlim; ++li) {
      const int dof = I.lim_dof[li];
      const T qd = q[I.dof_qidx[dof]];
      const T step = qd + dt * v[dof];
      const T viol_lo = F.lim_lo[li] - qd, pred_lo = F.lim_lo[li] - step;
      const T viol_hi = qd - F.lim_hi[li], pred_hi = step - F.lim_hi[li];
      const int ilo = 3 * nc + li, ihi = 3 * nc + nlim + li;
      lcp.J[ilo][dof] = T(1);
      lcp.b[ilo] = v_star[dof] - tmin(F.erp_dt * tmax(viol_lo, T(0)), T(2));
      lcp.valid[ilo] = viol_lo > T(0) || pred_lo > T(0);
      lcp.J[ihi][dof] = T(-1);
      lcp.b[ihi] = (-v_star[dof]) - tmin(F.erp_dt * tmax(viol_hi, T(0)), T(2));
      lcp.valid[ihi] = viol_hi > T(0) || pred_hi > T(0);
    }
    // ---------------- servo and joint-friction rows (constant boxes) ----
    lcp.box0 = 3 * nc + 2 * nlim;
    for (int k = 0; k < I.nservo + I.nfric; ++k) {
      const int i = lcp.box0 + k;
      const bool servo = k < I.nservo;
      const int dof = servo ? I.servo_dof[k] : I.fric_dof[k - I.nservo];
      lcp.J[i][dof] = T(1);
      lcp.b[i] = servo ? v_star[dof] - F.servo_tgt[k] : v_star[dof];
      lcp.valid[i] = true;
      lcp.box_c[k] = F.box_c[k];
    }

    // ---------------- sweep scaling from diag and |A| row sums -----------
    T scale[MAX_D];
    {
      T W[MAX_D][MAX_NV];  // W[i][k] = (Minv J^T)[k, i]
      for (int i = 0; i < D; ++i)
        for (int k = 0; k < nv; ++k) {
          T acc = T(0);
          for (int j = 0; j < nv; ++j) acc = acc + Minv[k][j] * lcp.J[i][j];
          W[i][k] = acc;
        }
      T diag[MAX_D], rowsum[MAX_D];
      for (int i = 0; i < D; ++i) {
        T acc = T(0);
        for (int k = 0; k < nv; ++k) acc = acc + lcp.J[i][k] * W[i][k];
        diag[i] = tmax(acc + F.cfm, T(1e-12));
        rowsum[i] = t_abs(diag[i]);
      }
      // A is symmetric: each off-diagonal entry is computed once (as
      // J_i . W_j, i < j) and credited to both rows, in the plain version's
      // order
      for (int i = 0; i < D; ++i)
        for (int j = i + 1; j < D; ++j) {
          T acc = T(0);
          for (int k = 0; k < nv; ++k) acc = acc + lcp.J[i][k] * W[j][k];
          const T ae = t_abs(acc);
          rowsum[i] = rowsum[i] + ae;
          rowsum[j] = rowsum[j] + ae;
        }
      for (int i = 0; i < D; ++i)
        scale[i] = tclip(diag[i] / tmax(rowsum[i], T(1e-12)), T(0.3), T(0.9)) / diag[i];
    }

    // ---------------- phased Jacobi sweeps (warm start) ----------------
    T lam[MAX_D], r[MAX_D];
    for (int i = 0; i < D; ++i) lam[i] = T(0);
    for (int it = 0; it < I.iters; ++it)
      for (int phase = 0; phase < 2; ++phase) {
        lcp.matvec(Minv, lam, r);
        // rows of one phase never read each other's lam, so the update is
        // in place
        for (int i = 0; i < D; ++i) {
          if ((int)lcp.is_fr(i) != phase) continue;
          const T cand = lam[i] - scale[i] * (r[i] + lcp.b[i]);
          lam[i] = lcp.clip_row(i, cand, lam);
        }
      }

    // ---------------- guarded Woodbury polish passes ----------------
    T best[MAX_D], cand[MAX_D];
    for (int i = 0; i < D; ++i) best[i] = lam[i];
    T best_res = lcp.nat_residual(Minv, best);
    for (int pass = 0; pass < I.passes; ++pass) {
      lcp.one_pass(M, lam, cand);
      bool finite = true;
      for (int i = 0; i < D; ++i) finite = finite && t_finite(cand[i]);
      if (finite)
        for (int i = 0; i < D; ++i) lam[i] = cand[i];
      const T res = lcp.nat_residual(Minv, lam);
      if (res < best_res)
        for (int i = 0; i < D; ++i) best[i] = lam[i];
      best_res = tmin(res, best_res);
    }

    // ---------------- v' = v* + Minv J^T lam ----------------
    T jt[MAX_NV];
    for (int j = 0; j < nv; ++j) jt[j] = T(0);
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < nv; ++j) jt[j] = jt[j] + lcp.J[i][j] * best[i];
    for (int k = 0; k < nv; ++k) {
      T acc = T(0);
      for (int j = 0; j < nv; ++j) acc = acc + Minv[k][j] * jt[j];
      v_new[k] = v_star[k] + acc;
    }
  }

  // ---------------- integrate (scalar joints): q' = q + dt v' -----------
  for (int k = 0; k < nq; ++k) q_out[(int64_t)k * B + e] = q[k];
  for (int i = 0; i < nb; ++i) {
    const int jt = I.jtype[i];
    const int o = I.q_off[i], vo = I.v_off[i];
    if (jt == J_FREE || jt == J_BALL) {
      // quaternion-exponential update; FREE: child-frame linear velocity
      T quat[4], w_dt[3], dq[4], prod[4], nq_[4];
      quat_normalize(q + o, quat);
      for (int k = 0; k < 3; ++k) w_dt[k] = dt * v_new[vo + k];
      quat_exp(w_dt, dq);
      quat_mul(quat, dq, prod);
      quat_normalize(prod, nq_);
      for (int k = 0; k < 4; ++k) q_out[(int64_t)(o + k) * B + e] = nq_[k];
      if (jt == J_FREE) {
        T Rq[9], dp[3];
        quat_to_mat(quat, Rq);
        matvec3(Rq, v_new + vo + 3, dp);
        for (int k = 0; k < 3; ++k) q_out[(int64_t)(o + 4 + k) * B + e] = q[o + 4 + k] + dp[k] * dt;
      }
      continue;
    }
    const int ndof = jt == J_PLANAR ? 3 : (jt == J_WELD ? 0 : 1);
    for (int k = 0; k < ndof; ++k)
      q_out[(int64_t)(I.q_off[i] + k) * B + e] = q[I.q_off[i] + k] + dt * v_new[I.v_off[i] + k];
  }
  for (int k = 0; k < nv; ++k) v_out[(int64_t)k * B + e] = v_new[k];
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(32) fused_step_kernel(
    const DescI* __restrict__ di, const DescF<T>* __restrict__ df, const T* __restrict__ q,
    const T* __restrict__ v, const T* __restrict__ tau, T* __restrict__ qo, T* __restrict__ vo,
    int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  env_step<T>(*di, *df, q, v, tau, qo, vo, B, e);
}

template <typename T>
static int launch(const void* di, const void* df, const void* q, const void* v, const void* tau,
                  void* qo, void* vo, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;  // one warp per block: B = 4096 spreads over 128 SMs
  const int blocks = (B + threads - 1) / threads;
  fused_step_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const DescI*)di, (const DescF<T>*)df, (const T*)q, (const T*)v, (const T*)tau, (T*)qo,
      (T*)vo, B);
  return (int)cudaGetLastError();
}
#else
// Host build of the same per-env code, for checking the arithmetic on a
// machine without a GPU (tests/test_torch_fused_step.py).
template <typename T>
static int launch(const void* di, const void* df, const void* q, const void* v, const void* tau,
                  void* qo, void* vo, int B, void*) {
  for (int e = 0; e < B; ++e)
    env_step<T>(*(const DescI*)di, *(const DescF<T>*)df, (const T*)q, (const T*)v,
                (const T*)tau, (T*)qo, (T*)vo, B, e);
  return 0;
}
#endif

}  // namespace fused

extern "C" {

// sizes the Python packer checks its layout against
void fused_step_layout(int* out) {
  out[0] = (int)(sizeof(fused::DescI) / sizeof(int));
  out[1] = (int)(sizeof(fused::DescF<float>) / sizeof(float));
  out[2] = (int)(sizeof(fused::DescF<double>) / sizeof(double));
  out[3] = fused::MAX_NB;
  out[4] = fused::MAX_NQ;
  out[5] = fused::MAX_NV;
  out[6] = fused::MAX_PAIRS;
  out[7] = fused::MAX_NC;
  out[8] = fused::MAX_LIM;
  out[9] = fused::MAX_D;
}

int fused_step_f32(const void* di, const void* df, const void* q, const void* v,
                   const void* tau, void* qo, void* vo, int B, void* stream) {
  return fused::launch<float>(di, df, q, v, tau, qo, vo, B, stream);
}

int fused_step_f64(const void* di, const void* df, const void* q, const void* v,
                   const void* tau, void* qo, void* vo, int B, void* stream) {
  return fused::launch<double>(di, df, q, v, tau, qo, vo, B, stream);
}

}  // extern "C"
