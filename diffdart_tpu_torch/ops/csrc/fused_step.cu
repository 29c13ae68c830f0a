// Fused constrained timestep for Hopper (sm_90a), and its vector-Jacobian
// product.
//
// Kernel 1, fused_step_kernel: one thread per env. Replaces the Pallas TPU
// kernel `_fwd_kernel` of diffdart_tpu/ops/pallas_step.py:55 (built by
// build_pallas_step), whose body is diffdart_tpu/sim/tilestep.py::
// build_tile_step. The plain PyTorch version of the same arithmetic is
// diffdart_tpu_torch/sim/tilestep.py; this file follows it op for op and in
// the same summation order, so the two agree to rounding (bit for bit where
// the order is the same, since the build turns off FMA contraction:
// -fmad=false, and keeps IEEE sin/cos/sqrt/division).
//
// Kernel 2, fused_step_vjp_kernel: one thread per (env, input direction).
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// diffdart_tpu/ops/pallas_step.py:60, which is jax.vjp of the same tile step
// with the forward recomputed in the kernel. The VJP of one step is
// g . d(q', v')/dx_k for the K = nq + 2 nv inputs x = (q, v, tau). Thread
// (e, k) seeds a unit tangent on x_k, runs env_step on dual numbers (primal
// plus one tangent) and writes gq . dq'/dx_k + gv . dv'/dx_k: no reduction
// across threads, and the derivative is taken of the very code kernel 1 runs,
// so the two cannot drift apart (the dual run's primal equals kernel 1's
// output bit for bit). Why forward mode: it reuses env_step as it is, where
// a reverse-mode adjoint would be a second code of the same length that only
// the host build could check here; and B K threads (3,456 warps at B = 4096
// for the half-cheetah, K = 27) fill the card where kernel 1's one thread
// per env leaves it nearly idle. Its cost is K recomputations of the primal
// per env; a reverse-mode adjoint with one thread per env is the redesign
// for speed.
//
// What each kernel computes, per env: FK, world motion subspaces, body
// velocities, the structured world inertias, the mass matrix (plus armature
// and implicit damping/spring terms), bias forces, an unrolled Cholesky and
// Minv, v*, capsule/sphere/box vs fixed-plane contacts, the LCP rows (contact
// normal, two friction rows per contact, joint-limit rows, servo and
// joint-friction rows), the matrix-free boxed LCP (diag and |A| row sums from
// D^2 dot products of length nv, phased Jacobi sweeps applying
// J Minv J^T + cfm, then two guarded Woodbury polish passes, each building
// S = cfm M + J^T (I+B) F J and solving it by Gaussian elimination without
// pivoting), v' = v* + Minv J^T lam and the position update.
//
// Gradient semantics (sim/tilestep.py:_tile_lcp of both packages): the
// sweeps and polish passes are stop-gradient, so the tangent build runs them
// on primal values only. It then runs what kernel 1 skips: a probe pass at
// `best` (primal) whose finiteness and drift decide `ok`, and one more
// Woodbury pass on dual J, b and M at `ok ? best : 0`, whose tangent is the
// implicit-function-theorem tangent of lam; the value stays `best`, and envs
// that are not `ok` get a zero tangent. Kernel 1 returns `best` directly
// (the value of that straight-through output) and skips both passes.
//
// Model data: the TPU kernels bake the model in as trace constants. Here the
// model is a packed descriptor in device memory (DescI: topology as int32;
// DescF<S>: parameters in the state dtype), built once per model by
// ops/fused_step.py, which also checks every size cap below and raises for a
// model over one. The subset is the plain version's: REVOLUTE / PRISMATIC /
// PLANAR / WELD / FREE / BALL joints (quaternion FK and geometric
// integration), capsule / sphere / box vs fixed-plane contacts, joint-limit
// rows, and servo / joint-friction rows with constant boxes.
//
// What bounds them on the H100: not DRAM. An env reads 3 vectors and writes
// 2 (the VJP: 5 and 3), but its LCP at D = 42, nv = 9 does tens of thousands
// of dependent flops on per-thread arrays (J and W alone are 2 x 42 x 9
// values; twice that as duals) that do not fit in registers and live in
// local memory (L1/L2). Kernel 1 at B = 4096 has only 128 warps for 132
// SMs, so it is latency bound. The VJP kernel has 27x the warps but each
// thread's stack is twice kernel 1's, so the resident threads' working sets
// do not fit in L1 and local-memory traffic through L2 is its expected
// bound (not yet confirmed by a trace). Both first versions keep the simple
// design and state their times beside the bound in PERF.md.
//
// Types: V is the value type (S, or Dual<S> in the VJP), S the descriptor's
// scalar (float or double).

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

template <typename S>
struct DescF {
  S X_rot[MAX_NB][9];
  S X_pos[MAX_NB][3];
  S axis[MAX_NB][3];
  S axis2[MAX_NB][3];
  S rot_ax[MAX_NB][3];  // rotation axis: axis (REVOLUTE), axis x axis2 (PLANAR)
  S rot_K[MAX_NB][9];   // [rot_ax]x
  S rot_K2[MAX_NB][9];  // rot_ax rot_ax^T - I
  S mass[MAX_NB];
  S com[MAX_NB][3];
  S inertia[MAX_NB][9];
  S damping[MAX_NV];
  S m_extra[MAX_NV];  // armature + dt damping + dt^2 spring
  S spring[MAX_NV];
  S q_rest[MAX_NV];
  S lim_lo[MAX_LIM];
  S lim_hi[MAX_LIM];
  S neg_grav[3];
  S dt, cfm, erp_dt;
  S pair_rot[MAX_PAIRS][9];  // geom frame in body frame
  S pair_pos[MAX_PAIRS][3];
  S pair_size[MAX_PAIRS][3];
  S pair_n[MAX_PAIRS][3];  // plane normal (world)
  S pair_p[MAX_PAIRS][3];  // plane point (world)
  S pair_t1[MAX_PAIRS][3];
  S pair_t2[MAX_PAIRS][3];
  S pair_mu[MAX_PAIRS];
  S pair_rest[MAX_PAIRS];
  S servo_tgt[MAX_NV];  // per servo row
  S box_c[2 * MAX_NV];  // constant boxes [-c, c]: servo rows, then joint-friction rows
};

// ---------------- scalar functions ----------------

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
HD bool is_zero(float x) { return x == 0.0f; }
HD bool is_zero(double x) { return x == 0.0; }
HD float primal(float x) { return x; }
HD double primal(double x) { return x; }

// safe_div: plain division in f64; in f32 a dead denominator (|den| <= 1e-20)
// contributes 0 (ops/tile.py:safe_div)
HD double safe_div(double n, double d) { return n / d; }
HD float safe_div(float n, float d) { return fabsf(d) <= 1e-20f ? 0.0f : n / d; }

// ---------------- dual numbers (the VJP kernel's value type) ----------------
// Derivatives follow torch's autograd formulas, which are JAX's: maximum and
// minimum split the tangent evenly at a tie, abs has a zero tangent at 0, a
// select takes the tangent of the chosen branch. Comparisons read the primal.

template <typename S>
struct Dual {
  S v, d;  // primal, tangent
  Dual() = default;
  HD Dual(S x) : v(x), d(S(0)) {}
  HD Dual(S x, S dx) : v(x), d(dx) {}
  HD Dual operator-() const { return Dual(-v, -d); }
  friend HD Dual operator+(const Dual& a, const Dual& b) { return Dual(a.v + b.v, a.d + b.d); }
  friend HD Dual operator+(const Dual& a, S b) { return Dual(a.v + b, a.d); }
  friend HD Dual operator+(S a, const Dual& b) { return Dual(a + b.v, b.d); }
  friend HD Dual operator-(const Dual& a, const Dual& b) { return Dual(a.v - b.v, a.d - b.d); }
  friend HD Dual operator-(const Dual& a, S b) { return Dual(a.v - b, a.d); }
  friend HD Dual operator-(S a, const Dual& b) { return Dual(a - b.v, -b.d); }
  friend HD Dual operator*(const Dual& a, const Dual& b) {
    return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
  }
  friend HD Dual operator*(const Dual& a, S b) { return Dual(a.v * b, a.d * b); }
  friend HD Dual operator*(S a, const Dual& b) { return Dual(a * b.v, a * b.d); }
  friend HD Dual operator/(const Dual& a, const Dual& b) {
    const S q = a.v / b.v;
    return Dual(q, (a.d - q * b.d) / b.v);
  }
  friend HD Dual operator/(const Dual& a, S b) { return Dual(a.v / b, a.d / b); }
  friend HD bool operator<(const Dual& a, const Dual& b) { return a.v < b.v; }
  friend HD bool operator>(const Dual& a, const Dual& b) { return a.v > b.v; }
};

// max/min of two duals: the tangent is b' + w (a' - b'), w = 1, 0 or 0.5 at a
// tie (or NaN), as torch's forward-mode formula writes it, so that it rounds
// as torch.autograd.forward_ad does (a select rounds otherwise)
template <typename S>
HD Dual<S> tmax(Dual<S> a, Dual<S> b) {
  const S w = a.v > b.v ? S(1) : (a.v < b.v ? S(0) : S(0.5));
  return Dual<S>(tmax(a.v, b.v), b.d + w * (a.d - b.d));
}
template <typename S>
HD Dual<S> tmin(Dual<S> a, Dual<S> b) {
  const S w = a.v < b.v ? S(1) : (a.v > b.v ? S(0) : S(0.5));
  return Dual<S>(tmin(a.v, b.v), b.d + w * (a.d - b.d));
}
template <typename S>
HD Dual<S> t_sin(Dual<S> x) { return Dual<S>(t_sin(x.v), x.d * t_cos(x.v)); }
template <typename S>
HD Dual<S> t_cos(Dual<S> x) { return Dual<S>(t_cos(x.v), x.d * (-t_sin(x.v))); }
template <typename S>
HD Dual<S> t_sqrt(Dual<S> x) {
  const S r = t_sqrt(x.v);
  return Dual<S>(r, x.d / (S(2) * r));
}
template <typename S>
HD Dual<S> t_rsqrt(Dual<S> x) {
  const S r = t_rsqrt(x.v);
  return Dual<S>(r, (S(-0.5) * ((r * r) * r)) * x.d);
}
template <typename S>
HD Dual<S> t_abs(Dual<S> x) {
  return Dual<S>(t_abs(x.v), x.v > S(0) ? x.d : (x.v < S(0) ? -x.d : S(0)));
}
template <typename S>
HD bool t_finite(Dual<S> x) { return t_finite(x.v); }
template <typename S>
HD bool is_zero(Dual<S> x) { return x.v == S(0) && x.d == S(0); }
template <typename S>
HD S primal(Dual<S> x) { return x.v; }
template <typename S>
HD Dual<S> safe_div(Dual<S> n, Dual<S> d) {
  if (sizeof(S) == 4 && t_abs(d.v) <= S(1e-20)) return Dual<S>(S(0));
  return n / d;
}

// val<U>(x): x as a U, where U is x's type or its primal type (the detached
// stages of the LCP read dual arrays as primal values)
template <typename U>
struct Val {
  template <typename X>
  static HD U of(const X& x) { return primal(x); }
};
template <typename S>
struct Val<Dual<S>> {
  static HD Dual<S> of(const Dual<S>& x) { return x; }
};
template <typename U, typename X>
HD U val(const X& x) { return Val<U>::of(x); }

// ---------------- small linear algebra ----------------

template <typename A, typename B>
HD auto dot3(const A* a, const B* b) {
  auto acc = a[0] * b[0];
  acc = acc + a[1] * b[1];
  acc = acc + a[2] * b[2];
  return acc;
}

// out = A B (row-major 3x3)
template <typename A, typename B, typename O>
HD void matmul3(const A* a, const B* b, O* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      O acc = a[i * 3 + 0] * b[0 * 3 + j];
      acc = acc + a[i * 3 + 1] * b[1 * 3 + j];
      acc = acc + a[i * 3 + 2] * b[2 * 3 + j];
      out[i * 3 + j] = acc;
    }
}

// out = A B^T
template <typename V>
HD void matmul3_bt(const V* a, const V* b, V* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      V acc = a[i * 3 + 0] * b[j * 3 + 0];
      acc = acc + a[i * 3 + 1] * b[j * 3 + 1];
      acc = acc + a[i * 3 + 2] * b[j * 3 + 2];
      out[i * 3 + j] = acc;
    }
}

template <typename A, typename B, typename O>
HD void matvec3(const A* R, const B* x, O* out) {
  for (int i = 0; i < 3; ++i) out[i] = dot3(R + 3 * i, x);
}

template <typename A, typename B, typename O>
HD void matTvec3(const A* R, const B* x, O* out) {
  for (int i = 0; i < 3; ++i) {
    O acc = R[0 * 3 + i] * x[0];
    acc = acc + R[1 * 3 + i] * x[1];
    acc = acc + R[2 * 3 + i] * x[2];
    out[i] = acc;
  }
}

template <typename A, typename B, typename O>
HD void cross3(const A* a, const B* b, O* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Rodrigues for a constant unit axis: R = (I + s K) + (1 - c) K2
template <typename V, typename S>
HD void exp_so3(const S* K, const S* K2, V theta, V* R) {
  const V s = t_sin(theta), c = t_cos(theta);
  const V omc = V(1) - c;
  for (int k = 0; k < 9; ++k) {
    const V d = (k % 4 == 0) ? V(1) : V(0);
    R[k] = (d + s * K[k]) + omc * K2[k];
  }
}

// Structured world spatial inertia applied to a motion (w, vl):
//   n = Ic_w w + m (c x vl - c x (c x w));  f = m vl - m c x w
template <typename V, typename S>
HD void iw_apply(S m, const V* c, const V* Icw, const V* w, const V* vl, V* n, V* f) {
  V cxw[3], cxv[3], cxcxw[3], Iw[3];
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
template <typename V>
HD void quat_normalize(const V* q, V* out) {
  V n2 = q[0] * q[0];
  n2 = n2 + q[1] * q[1];
  n2 = n2 + q[2] * q[2];
  n2 = n2 + q[3] * q[3];
  const V inv = t_rsqrt(n2);
  for (int k = 0; k < 4; ++k) out[k] = q[k] * inv;
}

template <typename V>
HD void quat_to_mat(const V* q, V* R) {
  const V w = q[0], x = q[1], y = q[2], z = q[3];
  const V xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const V wx = w * x, wy = w * y, wz = w * z;
  R[0] = V(1) - (yy + zz) * V(2);
  R[1] = (xy - wz) * V(2);
  R[2] = (xz + wy) * V(2);
  R[3] = (xy + wz) * V(2);
  R[4] = V(1) - (xx + zz) * V(2);
  R[5] = (yz - wx) * V(2);
  R[6] = (xz - wy) * V(2);
  R[7] = (yz + wx) * V(2);
  R[8] = V(1) - (xx + yy) * V(2);
}

// R^3 -> unit quaternion, half-angle convention, Taylor branch near 0
template <typename V>
HD void quat_exp(const V* v, V* out) {
  const V h2 = dot3(v, v) * V(0.25);
  V w, sinc;
  if (h2 < V(1e-8)) {
    w = (V(1) - h2 / V(2)) + (h2 * h2) / V(24);
    sinc = (V(1) - h2 / V(6)) + (h2 * h2) / V(120);
  } else {
    const V r = t_sqrt(h2);
    w = t_cos(r);
    sinc = t_sin(r) / r;
  }
  const V s = sinc * V(0.5);
  out[0] = w;
  for (int k = 0; k < 3; ++k) out[1 + k] = s * v[k];
}

template <typename V>
HD void quat_mul(const V* a, const V* b, V* out) {
  out[0] = (a[0] * b[0] - a[1] * b[1]) - (a[2] * b[2] + a[3] * b[3]);
  out[1] = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) - a[3] * b[2];
  out[2] = (a[0] * b[2] - a[1] * b[3]) + (a[2] * b[0] + a[3] * b[1]);
  out[3] = (a[0] * b[3] + a[1] * b[2]) + (a[3] * b[0] - a[2] * b[1]);
}

// ---------------- the boxed LCP ----------------
// J, b (and the M, Minv passed in) hold values of type V; the multipliers
// of the detached stages (sweeps, polish, probe) are primal (S), and those
// stages read J, b, M and Minv as primal values.
template <typename V, typename S>
struct Lcp {
  int D, nc, nv;
  int box0;  // first constant-box row (servo, then joint friction)
  V J[MAX_D][MAX_NV];
  S box_c[2 * MAX_NV];
  V b[MAX_D];
  S mu[MAX_NC];
  bool valid[MAX_D];
  S cfm;

  HD bool is_fr(int i) const { return i >= nc && i < 3 * nc; }
  HD int fidx(int i) const { return i < 2 * nc ? i - nc : i - 2 * nc; }
  HD bool is_box(int i) const { return i >= box0; }

  // project a candidate onto the row's box; invalid rows pin to 0
  template <typename U>
  HD U clip_row(int i, U cand, const U* lam) const {
    U c;
    if (is_fr(i)) {
      const U bound = mu[fidx(i)] * lam[fidx(i)];
      c = tclip(cand, -bound, bound);
    } else if (is_box(i)) {
      c = tclip(cand, U(-box_c[i - box0]), U(box_c[i - box0]));
    } else {
      c = tmax(cand, U(0));
    }
    return valid[i] ? c : U(0);
  }

  // out = J Minv J^T lam + cfm lam, matrix-free (primal)
  HD void matvec(const V (*Minv)[MAX_NV], const S* lam, S* out) const {
    S jt[MAX_NV], u[MAX_NV];
    for (int j = 0; j < nv; ++j) jt[j] = S(0);
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < nv; ++j) jt[j] = jt[j] + primal(J[i][j]) * lam[i];
    for (int k = 0; k < nv; ++k) {
      S acc = S(0);
      for (int j = 0; j < nv; ++j) acc = acc + primal(Minv[k][j]) * jt[j];
      u[k] = acc;
    }
    for (int i = 0; i < D; ++i) {
      S acc = cfm * lam[i];
      for (int j = 0; j < nv; ++j) acc = acc + primal(J[i][j]) * u[j];
      out[i] = acc;
    }
  }

  HD S nat_residual(const V (*Minv)[MAX_NV], const S* lam) const {
    S w[MAX_D];
    matvec(Minv, lam, w);
    S res = S(0);
    for (int i = 0; i < D; ++i) {
      const S proj = clip_row<S>(i, lam[i] - (w[i] + primal(b[i])), lam);
      res = tmax(res, t_abs(lam[i] - proj));
    }
    return res;
  }

  // one active-set Woodbury pass from iterate lam (sim/tilestep.py
  // one_pass). The active set comes from lam and carries no tangent; with
  // U = V the pass is differentiated through J, b and M.
  template <typename U>
  HD void one_pass(const V (*M)[MAX_NV], const S* lam, U* out) const {
    const S tol = S(1e-8);
    S Ff[MAX_D], fbm[MAX_D], pin[MAX_D];
    for (int i = 0; i < D; ++i) {
      pin[i] = S(0);
      const S tol_sc = tmax(t_abs(lam[i]), S(1)) * tol;
      if (is_fr(i)) {
        const S bound = mu[fidx(i)] * lam[fidx(i)];
        const bool at_lo = lam[i] <= tol_sc - bound;
        const bool at_hi = lam[i] >= bound - tol_sc;
        const bool degen = at_lo && at_hi;
        const bool free_ = !at_lo && !at_hi && valid[i];
        const bool frb = (at_lo || at_hi) && !degen && valid[i];
        Ff[i] = free_ ? S(1) : S(0);
        fbm[i] = ((frb ? S(1) : S(0)) * (at_hi ? S(1) : S(-1))) * mu[fidx(i)];
      } else if (is_box(i)) {
        // constant box [-c, +c]: at-bound rows pin to +-c, entering the KKT
        // rhs as cfm * c_pin
        const S cb = box_c[i - box0];
        const bool at_lo = lam[i] <= tol_sc - cb;
        const bool at_hi = lam[i] >= cb - tol_sc;
        const bool degen = at_lo && at_hi;
        const bool pinned = (at_lo || at_hi) && !degen && valid[i];
        Ff[i] = (!at_lo && !at_hi && valid[i]) ? S(1) : S(0);
        fbm[i] = S(0);
        pin[i] = ((pinned ? S(1) : S(0)) * (at_hi ? S(1) : S(-1))) * cb;
      } else {
        Ff[i] = (!(lam[i] <= tol_sc) && valid[i]) ? S(1) : S(0);
        fbm[i] = S(0);
      }
    }
    // S = cfm M + J^T (I+B) F J
    U Sm[MAX_NV][MAX_NV];
    for (int a = 0; a < nv; ++a)
      for (int c = 0; c < nv; ++c) Sm[a][c] = cfm * val<U>(M[a][c]);
    for (int i = 0; i < D; ++i) {
      U X[MAX_NV];
      for (int j = 0; j < nv; ++j) X[j] = Ff[i] * val<U>(J[i][j]);
      if (is_fr(i)) {
        const int n = fidx(i);
        const S coef = fbm[i] * Ff[n];
        for (int j = 0; j < nv; ++j) X[j] = X[j] + coef * val<U>(J[n][j]);
      }
      for (int a = 0; a < nv; ++a)
        for (int c = 0; c < nv; ++c) Sm[a][c] = Sm[a][c] + val<U>(J[i][a]) * X[c];
    }
    // rhs_u = J^T (I+B) r with r = -F b
    U r[MAX_D], rhs[MAX_NV], u[MAX_NV];
    for (int i = 0; i < D; ++i) r[i] = Ff[i] * (-val<U>(b[i]));
    for (int j = 0; j < nv; ++j) rhs[j] = U(0);
    for (int i = 0; i < D; ++i) {
      U t = r[i];
      if (is_fr(i)) t = t + fbm[i] * r[fidx(i)];
      if (is_box(i)) t = t + cfm * pin[i];
      for (int j = 0; j < nv; ++j) rhs[j] = rhs[j] + val<U>(J[i][j]) * t;
    }
    // Gaussian elimination without pivoting (S is unsymmetric when the
    // friction-bound coupling is active); exact zeros below the diagonal are
    // skipped as the plain version skips its structural zeros (a dual is
    // skipped only when its tangent is zero too)
    for (int k = 0; k < nv - 1; ++k)
      for (int i = k + 1; i < nv; ++i) {
        if (is_zero(Sm[i][k])) continue;
        const U f = safe_div(Sm[i][k], Sm[k][k]);
        for (int j = k + 1; j < nv; ++j) Sm[i][j] = Sm[i][j] - f * Sm[k][j];
        rhs[i] = rhs[i] - f * rhs[k];
      }
    for (int i = nv - 1; i >= 0; --i) {
      U s = rhs[i];
      for (int j = i + 1; j < nv; ++j) s = s - Sm[i][j] * u[j];
      u[i] = safe_div(s, Sm[i][i]);
    }
    // x = (r - F J u) / cfm on the free set; lam' = (I+B) x, projected
    U x[MAX_D];
    for (int i = 0; i < D; ++i) {
      U ju = U(0);
      for (int j = 0; j < nv; ++j) ju = ju + val<U>(J[i][j]) * u[j];
      x[i] = Ff[i] * ((r[i] - Ff[i] * ju) / cfm);
    }
    U lam_new[MAX_D];
    for (int i = 0; i < D; ++i) {
      U t = x[i];
      if (is_fr(i)) t = t + fbm[i] * x[fidx(i)];
      if (is_box(i)) t = t + pin[i];
      lam_new[i] = t;
    }
    for (int i = 0; i < D; ++i) out[i] = clip_row<U>(i, lam_new[i], lam_new);
  }
};

// v' = v* + Minv J^T lam
template <typename V, typename S, typename L>
HD void apply_impulse(const Lcp<V, S>& lcp, const V (*Minv)[MAX_NV], const V* v_star,
                      const L* lam, V* v_new) {
  const int nv = lcp.nv;
  V jt[MAX_NV];
  for (int j = 0; j < nv; ++j) jt[j] = V(0);
  for (int i = 0; i < lcp.D; ++i)
    for (int j = 0; j < nv; ++j) jt[j] = jt[j] + lcp.J[i][j] * lam[i];
  for (int k = 0; k < nv; ++k) {
    V acc = V(0);
    for (int j = 0; j < nv; ++j) acc = acc + Minv[k][j] * jt[j];
    v_new[k] = v_star[k] + acc;
  }
}

// One env's step from (q, v, tau) to (q_new, v_new), on values of type V.
// GRAD (V = Dual<S> only) adds the probe pass and the differentiable
// Woodbury pass of the gradient attachment.
template <typename V, typename S, bool GRAD>
HD void env_step(const DescI& I, const DescF<S>& F, const V* __restrict__ q,
                 const V* __restrict__ v, const V* __restrict__ tau, V* __restrict__ q_new,
                 V* __restrict__ v_new) {
  const int nb = I.nb, nq = I.nq, nv = I.nv;
  const S dt = F.dt;

  // ---------------- FK ----------------
  V R[MAX_NB][9], P[MAX_NB][3];
  for (int i = 0; i < nb; ++i) {
    const int o = I.q_off[i];
    V Rj[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    V pj[3] = {0, 0, 0};
    const int jt = I.jtype[i];
    if (jt == J_REVOLUTE) {
      exp_so3(F.rot_K[i], F.rot_K2[i], q[o], Rj);
    } else if (jt == J_PRISMATIC) {
      for (int k = 0; k < 3; ++k) pj[k] = F.axis[i][k] * q[o];
    } else if (jt == J_PLANAR) {
      exp_so3(F.rot_K[i], F.rot_K2[i], q[o + 2], Rj);
      for (int k = 0; k < 3; ++k) pj[k] = F.axis[i][k] * q[o] + F.axis2[i][k] * q[o + 1];
    } else if (jt == J_FREE || jt == J_BALL) {
      V qn[4];
      quat_normalize(q + o, qn);
      quat_to_mat(qn, Rj);
      if (jt == J_FREE)
        for (int k = 0; k < 3; ++k) pj[k] = q[o + 4 + k];
    }
    V Rpc[9], ppc[3];
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
  V Sw[MAX_NV][6];
  for (int i = 0; i < nb; ++i) {
    const int o = I.v_off[i];
    const int jt = I.jtype[i];
    int nrow = 0;
    V wl[6][3], vl[6][3];
    if (jt == J_REVOLUTE) {
      nrow = 1;
      for (int k = 0; k < 3; ++k) { wl[0][k] = F.axis[i][k]; vl[0][k] = V(0); }
    } else if (jt == J_PRISMATIC) {
      nrow = 1;
      for (int k = 0; k < 3; ++k) { wl[0][k] = V(0); vl[0][k] = F.axis[i][k]; }
    } else if (jt == J_PLANAR) {
      nrow = 3;
      V Rj[9];
      exp_so3(F.rot_K[i], F.rot_K2[i], q[I.q_off[i] + 2], Rj);
      matTvec3(Rj, F.axis[i], vl[0]);
      matTvec3(Rj, F.axis2[i], vl[1]);
      for (int k = 0; k < 3; ++k) {
        wl[0][k] = V(0);
        wl[1][k] = V(0);
        wl[2][k] = F.rot_ax[i][k];
        vl[2][k] = V(0);
      }
    } else if (jt == J_FREE || jt == J_BALL) {
      // S = I6 (FREE: 3 angular then 3 linear unit rows) or [I3 | 0] (BALL)
      nrow = jt == J_FREE ? 6 : 3;
      for (int r = 0; r < nrow; ++r)
        for (int k = 0; k < 3; ++k) {
          wl[r][k] = (r < 3 && k == r) ? V(1) : V(0);
          vl[r][k] = (r >= 3 && k == r - 3) ? V(1) : V(0);
        }
    }
    for (int r = 0; r < nrow; ++r) {
      V ww[3], rv[3], pxw[3];
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
  V Vb[MAX_NB][6];
  for (int b = 0; b < nb; ++b) {
    for (int k = 0; k < 6; ++k) Vb[b][k] = V(0);
    for (int j = 0; j < nv; ++j)
      if (I.anc[b][j])
        for (int k = 0; k < 6; ++k) Vb[b][k] = Vb[b][k] + Sw[j][k] * v[j];
  }

  // ---------------- world spatial inertia (structured) ----------------
  V cw[MAX_NB][3], Icw[MAX_NB][9];
  for (int b = 0; b < nb; ++b) {
    matvec3(R[b], F.com[b], cw[b]);
    for (int k = 0; k < 3; ++k) cw[b][k] = cw[b][k] + P[b][k];
    V RI[9];
    matmul3(R[b], F.inertia[b], RI);
    matmul3_bt(RI, R[b], Icw[b]);
  }

  // ---------------- mass matrix ----------------
  V M[MAX_NV][MAX_NV];
  for (int a = 0; a < nv; ++a)
    for (int c = 0; c < nv; ++c) M[a][c] = V(0);
  for (int b = 0; b < nb; ++b) {
    for (int jj = 0; jj < nv; ++jj) {
      if (!I.anc[b][jj]) continue;
      V n[3], f[3];
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
  V sdot[MAX_NV][6];
  for (int j = 0; j < nv; ++j) {
    const int b = I.dof_body[j];
    V sw[3], sv1[3], sv2[3];
    cross3(Vb[b], Sw[j], sw);
    cross3(Vb[b], Sw[j] + 3, sv1);
    cross3(Vb[b] + 3, Sw[j], sv2);
    for (int k = 0; k < 3; ++k) {
      sdot[j][k] = sw[k];
      sdot[j][3 + k] = sv1[k] + sv2[k];
    }
    const int kk = j - I.v_off[b];
    if (I.jtype[b] == J_PLANAR && kk < 2) {
      // d/dt (Rj^T a) = -q2dot (n x (Rj^T a)); world lin = R_b @ that
      V Rj[9], rta[3], nx[3], dlin[3], wd[3];
      exp_so3(F.rot_K[b], F.rot_K2[b], q[I.q_off[b] + 2], Rj);
      matTvec3(Rj, kk == 0 ? F.axis[b] : F.axis2[b], rta);
      cross3(F.rot_ax[b], rta, nx);
      for (int k = 0; k < 3; ++k) dlin[k] = nx[k] * v[I.v_off[b] + 2];
      matvec3(R[b], dlin, wd);
      for (int k = 0; k < 3; ++k) sdot[j][3 + k] = sdot[j][3 + k] - wd[k];
    }
  }
  V C[MAX_NV];
  for (int i = 0; i < nv; ++i) C[i] = V(0);
  for (int b = 0; b < nb; ++b) {
    V a[6] = {0, 0, 0, F.neg_grav[0], F.neg_grav[1], F.neg_grav[2]};
    for (int j = 0; j < nv; ++j)
      if (I.anc[b][j])
        for (int k = 0; k < 6; ++k) a[k] = a[k] + sdot[j][k] * v[j];
    V Fn[3], Ff[3], nIV[3], fIV[3], c1[3], c2[3], c3[3];
    iw_apply(F.mass[b], cw[b], Icw[b], a, a + 3, Fn, Ff);
    iw_apply(F.mass[b], cw[b], Icw[b], Vb[b], Vb[b] + 3, nIV, fIV);
    cross3(Vb[b], nIV, c1);
    cross3(Vb[b] + 3, fIV, c2);
    cross3(Vb[b], fIV, c3);
    for (int k = 0; k < 3; ++k) {
      Fn[k] = Fn[k] + (c1[k] + c2[k]);
      Ff[k] = Ff[k] + c3[k];
    }
    for (int i = 0; i < nv; ++i)
      if (I.anc[b][i]) C[i] = C[i] + (dot3(Sw[i], Fn) + dot3(Sw[i] + 3, Ff));
  }

  // ---------------- unconstrained velocity ----------------
  V rhs[MAX_NV];
  for (int i = 0; i < nv; ++i) {
    V fj = (-F.damping[i]) * v[i];
    if (F.spring[i] != S(0))
      fj = fj - F.spring[i] * ((q[I.dof_qidx[i]] - F.q_rest[i]) + dt * v[i]);
    rhs[i] = tau[i] + (fj - C[i]);
  }
  V L[MAX_NV][MAX_NV];
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j <= i; ++j) {
      V s = M[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j)
        L[i][i] = t_sqrt(tmax(s, V(1e-12)));
      else
        L[i][j] = s / L[j][j];
    }
  V Minv[MAX_NV][MAX_NV];
  for (int col = 0; col < nv; ++col) {
    V y[MAX_NV], x[MAX_NV];
    for (int i = 0; i < nv; ++i) {
      V s = (i == col) ? V(1) : V(0);
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s / L[i][i];
    }
    for (int i = nv - 1; i >= 0; --i) {
      V s = y[i];
      for (int k = i + 1; k < nv; ++k) s = s - L[k][i] * x[k];
      x[i] = s / L[i][i];
    }
    for (int i = 0; i < nv; ++i) Minv[i][col] = x[i];
  }
  V v_star[MAX_NV];
  for (int i = 0; i < nv; ++i) {
    V acc = V(0);
    for (int k = 0; k < nv; ++k) acc = acc + Minv[i][k] * rhs[k];
    v_star[i] = v[i] + dt * acc;
  }

  const int D = I.D;
  if (D == 0) {
    for (int i = 0; i < nv; ++i) v_new[i] = v_star[i];
  } else {
    Lcp<V, S> lcp;
    lcp.D = D;
    lcp.nc = I.nc;
    lcp.nv = nv;
    lcp.cfm = F.cfm;
    const int nc = I.nc;
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < nv; ++j) lcp.J[i][j] = V(0);

    // ---------------- contacts (geom vs fixed plane) and their rows ------
    int c = 0;
    for (int p = 0; p < I.npair; ++p) {
      const int b = I.pair_body[p];
      const int gt = I.pair_type[p];
      V Rg[9], pg[3];
      matmul3(R[b], F.pair_rot[p], Rg);
      matvec3(R[b], F.pair_pos[p], pg);
      for (int k = 0; k < 3; ++k) pg[k] = pg[k] + P[b][k];
      const S* n = F.pair_n[p];
      const int nslot = gt == G_BOX ? 8 : (gt == G_CAPSULE ? 2 : 1);
      for (int s = 0; s < nslot; ++s, ++c) {
        V cpt[3], pos[3], dv[3], depth;
        if (gt == G_BOX) {
          // corners in (sx, sy, sz) order, each from -1 to +1
          const S loc[3] = {F.pair_size[p][0] * ((s & 4) ? S(1) : S(-1)),
                            F.pair_size[p][1] * ((s & 2) ? S(1) : S(-1)),
                            F.pair_size[p][2] * ((s & 1) ? S(1) : S(-1))};
          matvec3(Rg, loc, cpt);
          for (int k = 0; k < 3; ++k) cpt[k] = cpt[k] + pg[k];
          for (int k = 0; k < 3; ++k) dv[k] = cpt[k] - F.pair_p[p][k];
          depth = -dot3(dv, n);
          for (int k = 0; k < 3; ++k) pos[k] = cpt[k] + n[k] * (depth * S(0.5));
        } else {
          const S r = F.pair_size[p][0];
          if (gt == G_CAPSULE) {
            const S hl = F.pair_size[p][1];
            for (int k = 0; k < 3; ++k) {
              const V d = Rg[k * 3 + 2] * hl;
              cpt[k] = s == 0 ? pg[k] - d : pg[k] + d;
            }
          } else {
            for (int k = 0; k < 3; ++k) cpt[k] = pg[k];
          }
          for (int k = 0; k < 3; ++k) dv[k] = cpt[k] - F.pair_p[p][k];
          depth = r - dot3(dv, n);
          const V back = r - depth * S(0.5);
          for (int k = 0; k < 3; ++k) pos[k] = cpt[k] - n[k] * back;
        }
        // rows: normal, t1, t2 over the body's ancestor dofs
        for (int j = 0; j < nv; ++j) {
          if (!I.anc[b][j]) continue;
          V wxp[3], lin[3];
          cross3(Sw[j], pos, wxp);
          for (int k = 0; k < 3; ++k) lin[k] = Sw[j][3 + k] + wxp[k];
          lcp.J[c][j] = dot3(lin, n);
          lcp.J[nc + c][j] = dot3(lin, F.pair_t1[p]);
          lcp.J[2 * nc + c][j] = dot3(lin, F.pair_t2[p]);
        }
        V target = tmin(F.erp_dt * tmax(depth - S(1e-5), V(0)), V(2));
        if (F.pair_rest[p] != S(0)) {
          V vn = V(0);
          for (int j = 0; j < nv; ++j) vn = vn + lcp.J[c][j] * v[j];
          const V bounce = F.pair_rest[p] * tmax(-vn - S(0.01), V(0));
          target = tmax(target, bounce);
        }
        V bn = V(0), bt1 = V(0), bt2 = V(0);
        for (int j = 0; j < nv; ++j) {
          bn = bn + lcp.J[c][j] * v_star[j];
          bt1 = bt1 + lcp.J[nc + c][j] * v_star[j];
          bt2 = bt2 + lcp.J[2 * nc + c][j] * v_star[j];
        }
        lcp.b[c] = bn - target;
        lcp.b[nc + c] = bt1;
        lcp.b[2 * nc + c] = bt2;
        const bool ok = depth > V(0);
        lcp.valid[c] = lcp.valid[nc + c] = lcp.valid[2 * nc + c] = ok;
        lcp.mu[c] = F.pair_mu[p];
      }
    }
    // ---------------- joint-limit rows ----------------
    const int nlim = I.nlim;
    for (int li = 0; li < nlim; ++li) {
      const int dof = I.lim_dof[li];
      const V qd = q[I.dof_qidx[dof]];
      const V step = qd + dt * v[dof];
      const V viol_lo = F.lim_lo[li] - qd, pred_lo = F.lim_lo[li] - step;
      const V viol_hi = qd - F.lim_hi[li], pred_hi = step - F.lim_hi[li];
      const int ilo = 3 * nc + li, ihi = 3 * nc + nlim + li;
      lcp.J[ilo][dof] = V(1);
      lcp.b[ilo] = v_star[dof] - tmin(F.erp_dt * tmax(viol_lo, V(0)), V(2));
      lcp.valid[ilo] = viol_lo > V(0) || pred_lo > V(0);
      lcp.J[ihi][dof] = V(-1);
      lcp.b[ihi] = (-v_star[dof]) - tmin(F.erp_dt * tmax(viol_hi, V(0)), V(2));
      lcp.valid[ihi] = viol_hi > V(0) || pred_hi > V(0);
    }
    // ---------------- servo and joint-friction rows (constant boxes) ----
    lcp.box0 = 3 * nc + 2 * nlim;
    for (int k = 0; k < I.nservo + I.nfric; ++k) {
      const int i = lcp.box0 + k;
      const bool servo = k < I.nservo;
      const int dof = servo ? I.servo_dof[k] : I.fric_dof[k - I.nservo];
      lcp.J[i][dof] = V(1);
      lcp.b[i] = servo ? v_star[dof] - F.servo_tgt[k] : v_star[dof];
      lcp.valid[i] = true;
      lcp.box_c[k] = F.box_c[k];
    }

    // ---------------- sweep scaling from diag and |A| row sums -----------
    S scale[MAX_D];
    {
      S W[MAX_D][MAX_NV];  // W[i][k] = (Minv J^T)[k, i]
      for (int i = 0; i < D; ++i)
        for (int k = 0; k < nv; ++k) {
          S acc = S(0);
          for (int j = 0; j < nv; ++j) acc = acc + primal(Minv[k][j]) * primal(lcp.J[i][j]);
          W[i][k] = acc;
        }
      S diag[MAX_D], rowsum[MAX_D];
      for (int i = 0; i < D; ++i) {
        S acc = S(0);
        for (int k = 0; k < nv; ++k) acc = acc + primal(lcp.J[i][k]) * W[i][k];
        diag[i] = tmax(acc + F.cfm, S(1e-12));
        rowsum[i] = t_abs(diag[i]);
      }
      // A is symmetric: each off-diagonal entry is computed once (as
      // J_i . W_j, i < j) and credited to both rows, in the plain version's
      // order
      for (int i = 0; i < D; ++i)
        for (int j = i + 1; j < D; ++j) {
          S acc = S(0);
          for (int k = 0; k < nv; ++k) acc = acc + primal(lcp.J[i][k]) * W[j][k];
          const S ae = t_abs(acc);
          rowsum[i] = rowsum[i] + ae;
          rowsum[j] = rowsum[j] + ae;
        }
      for (int i = 0; i < D; ++i)
        scale[i] = tclip(diag[i] / tmax(rowsum[i], S(1e-12)), S(0.3), S(0.9)) / diag[i];
    }

    // ---------------- phased Jacobi sweeps (warm start) ----------------
    S lam[MAX_D], r[MAX_D];
    for (int i = 0; i < D; ++i) lam[i] = S(0);
    for (int it = 0; it < I.iters; ++it)
      for (int phase = 0; phase < 2; ++phase) {
        lcp.matvec(Minv, lam, r);
        // rows of one phase never read each other's lam, so the update is
        // in place
        for (int i = 0; i < D; ++i) {
          if ((int)lcp.is_fr(i) != phase) continue;
          const S cand = lam[i] - scale[i] * (r[i] + primal(lcp.b[i]));
          lam[i] = lcp.template clip_row<S>(i, cand, lam);
        }
      }

    // ---------------- guarded Woodbury polish passes ----------------
    S best[MAX_D], cand[MAX_D];
    for (int i = 0; i < D; ++i) best[i] = lam[i];
    S best_res = lcp.nat_residual(Minv, best);
    for (int pass = 0; pass < I.passes; ++pass) {
      lcp.template one_pass<S>(M, lam, cand);
      bool finite = true;
      for (int i = 0; i < D; ++i) finite = finite && t_finite(cand[i]);
      if (finite)
        for (int i = 0; i < D; ++i) lam[i] = cand[i];
      const S res = lcp.nat_residual(Minv, lam);
      if (res < best_res)
        for (int i = 0; i < D; ++i) best[i] = lam[i];
      best_res = tmin(res, best_res);
    }

    if constexpr (GRAD) {
      // ---------------- gradient attachment ----------------
      // probe pass at best (primal): envs where it is non-finite or drifts
      // keep the value and get a zero tangent
      S probe[MAX_D];
      lcp.template one_pass<S>(M, best, probe);
      bool finite = true;
      S drift = S(0);
      for (int i = 0; i < D; ++i) {
        finite = finite && t_finite(probe[i]);
        const S g = t_finite(probe[i]) ? probe[i] : S(1e30);
        drift = tmax(drift, t_abs(g - best[i]));
      }
      const bool ok = finite && drift <= (best_res + S(1)) * S(1e-5);
      // the differentiable pass, on sanitized inputs where not ok
      for (int i = 0; i < D; ++i) cand[i] = ok ? best[i] : S(0);
      V lam_g[MAX_D];
      lcp.template one_pass<V>(M, cand, lam_g);
      for (int i = 0; i < D; ++i) lam_g[i] = V(best[i], ok ? lam_g[i].d : S(0));
      apply_impulse(lcp, Minv, v_star, lam_g, v_new);
    } else {
      apply_impulse(lcp, Minv, v_star, best, v_new);
    }
  }

  // ---------------- integrate (scalar joints): q' = q + dt v' -----------
  for (int k = 0; k < nq; ++k) q_new[k] = q[k];
  for (int i = 0; i < nb; ++i) {
    const int jt = I.jtype[i];
    const int o = I.q_off[i], vo = I.v_off[i];
    if (jt == J_FREE || jt == J_BALL) {
      // quaternion-exponential update; FREE: child-frame linear velocity
      V quat[4], w_dt[3], dq[4], prod[4];
      quat_normalize(q + o, quat);
      for (int k = 0; k < 3; ++k) w_dt[k] = dt * v_new[vo + k];
      quat_exp(w_dt, dq);
      quat_mul(quat, dq, prod);
      quat_normalize(prod, q_new + o);
      if (jt == J_FREE) {
        V Rq[9], dp[3];
        quat_to_mat(quat, Rq);
        matvec3(Rq, v_new + vo + 3, dp);
        for (int k = 0; k < 3; ++k) q_new[o + 4 + k] = q[o + 4 + k] + dp[k] * dt;
      }
      continue;
    }
    const int ndof = jt == J_PLANAR ? 3 : (jt == J_WELD ? 0 : 1);
    for (int k = 0; k < ndof; ++k) q_new[o + k] = q[o + k] + dt * v_new[vo + k];
  }
}

// Kernel 1's per-env work: SoA (k, B) in and out.
template <typename S>
HD void env_fwd(const DescI& I, const DescF<S>& F, const S* __restrict__ q_in,
                const S* __restrict__ v_in, const S* __restrict__ tau_in, S* __restrict__ q_out,
                S* __restrict__ v_out, int B, int e) {
  const int nq = I.nq, nv = I.nv;
  S q[MAX_NQ], v[MAX_NV], tau[MAX_NV], qn[MAX_NQ], vn[MAX_NV];
  for (int k = 0; k < nq; ++k) q[k] = q_in[(int64_t)k * B + e];
  for (int k = 0; k < nv; ++k) {
    v[k] = v_in[(int64_t)k * B + e];
    tau[k] = tau_in[(int64_t)k * B + e];
  }
  env_step<S, S, false>(I, F, q, v, tau, qn, vn);
  for (int k = 0; k < nq; ++k) q_out[(int64_t)k * B + e] = qn[k];
  for (int k = 0; k < nv; ++k) v_out[(int64_t)k * B + e] = vn[k];
}

// The VJP kernel's per-(env, direction) work: direction kd of the inputs
// (q | v | tau) gets a unit tangent; the cotangent (gq, gv) dotted with the
// output tangent is row kd of (dq | dv | dtau). Direction 0 also writes the
// primal output when q_out is given.
template <typename S>
HD void env_vjp(const DescI& I, const DescF<S>& F, const S* __restrict__ q_in,
                const S* __restrict__ v_in, const S* __restrict__ tau_in,
                const S* __restrict__ gq, const S* __restrict__ gv, S* __restrict__ dq,
                S* __restrict__ dv, S* __restrict__ dtau, S* __restrict__ q_out,
                S* __restrict__ v_out, int B, int e, int kd) {
  using V = Dual<S>;
  const int nq = I.nq, nv = I.nv;
  V q[MAX_NQ], v[MAX_NV], tau[MAX_NV], qn[MAX_NQ], vn[MAX_NV];
  for (int k = 0; k < nq; ++k) q[k] = V(q_in[(int64_t)k * B + e], k == kd ? S(1) : S(0));
  for (int k = 0; k < nv; ++k) {
    v[k] = V(v_in[(int64_t)k * B + e], nq + k == kd ? S(1) : S(0));
    tau[k] = V(tau_in[(int64_t)k * B + e], nq + nv + k == kd ? S(1) : S(0));
  }
  env_step<V, S, true>(I, F, q, v, tau, qn, vn);
  S acc = S(0);
  for (int k = 0; k < nq; ++k) acc = acc + gq[(int64_t)k * B + e] * qn[k].d;
  for (int k = 0; k < nv; ++k) acc = acc + gv[(int64_t)k * B + e] * vn[k].d;
  if (kd < nq)
    dq[(int64_t)kd * B + e] = acc;
  else if (kd < nq + nv)
    dv[(int64_t)(kd - nq) * B + e] = acc;
  else
    dtau[(int64_t)(kd - nq - nv) * B + e] = acc;
  if (q_out != nullptr && kd == 0) {
    for (int k = 0; k < nq; ++k) q_out[(int64_t)k * B + e] = qn[k].v;
    for (int k = 0; k < nv; ++k) v_out[(int64_t)k * B + e] = vn[k].v;
  }
}

#ifdef __CUDACC__
template <typename S>
__global__ void __launch_bounds__(32) fused_step_kernel(
    const DescI* __restrict__ di, const DescF<S>* __restrict__ df, const S* __restrict__ q,
    const S* __restrict__ v, const S* __restrict__ tau, S* __restrict__ qo, S* __restrict__ vo,
    int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  env_fwd<S>(*di, *df, q, v, tau, qo, vo, B, e);
}

constexpr int VJP_THREADS = 64;

template <typename S>
__global__ void __launch_bounds__(VJP_THREADS) fused_step_vjp_kernel(
    const DescI* __restrict__ di, const DescF<S>* __restrict__ df, const S* __restrict__ q,
    const S* __restrict__ v, const S* __restrict__ tau, const S* __restrict__ gq,
    const S* __restrict__ gv, S* __restrict__ dq, S* __restrict__ dv, S* __restrict__ dtau,
    S* __restrict__ qo, S* __restrict__ vo, int B, int K) {
  // envs fastest: a warp reads neighbouring envs of one direction
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * K) return;
  env_vjp<S>(*di, *df, q, v, tau, gq, gv, dq, dv, dtau, qo, vo, B, (int)(t % B), (int)(t / B));
}

template <typename S>
static int launch(const void* di, const void* df, const void* q, const void* v, const void* tau,
                  void* qo, void* vo, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;  // one warp per block: B = 4096 spreads over 128 SMs
  const int blocks = (B + threads - 1) / threads;
  fused_step_kernel<S><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const DescI*)di, (const DescF<S>*)df, (const S*)q, (const S*)v, (const S*)tau, (S*)qo,
      (S*)vo, B);
  return (int)cudaGetLastError();
}

template <typename S>
static int launch_vjp(const void* di, const void* df, const void* q, const void* v,
                      const void* tau, const void* gq, const void* gv, void* dq, void* dv,
                      void* dtau, void* qo, void* vo, int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int64_t n = (int64_t)B * K;
  const int blocks = (int)((n + VJP_THREADS - 1) / VJP_THREADS);
  fused_step_vjp_kernel<S><<<blocks, VJP_THREADS, 0, (cudaStream_t)stream>>>(
      (const DescI*)di, (const DescF<S>*)df, (const S*)q, (const S*)v, (const S*)tau,
      (const S*)gq, (const S*)gv, (S*)dq, (S*)dv, (S*)dtau, (S*)qo, (S*)vo, B, K);
  return (int)cudaGetLastError();
}
#else
// Host build of the same per-env code, for checking the arithmetic on a
// machine without a GPU (tests/test_torch_fused_step.py).
template <typename S>
static int launch(const void* di, const void* df, const void* q, const void* v, const void* tau,
                  void* qo, void* vo, int B, void*) {
  for (int e = 0; e < B; ++e)
    env_fwd<S>(*(const DescI*)di, *(const DescF<S>*)df, (const S*)q, (const S*)v,
               (const S*)tau, (S*)qo, (S*)vo, B, e);
  return 0;
}

template <typename S>
static int launch_vjp(const void* di, const void* df, const void* q, const void* v,
                      const void* tau, const void* gq, const void* gv, void* dq, void* dv,
                      void* dtau, void* qo, void* vo, int B, int K, void*) {
  for (int k = 0; k < K; ++k)
    for (int e = 0; e < B; ++e)
      env_vjp<S>(*(const DescI*)di, *(const DescF<S>*)df, (const S*)q, (const S*)v,
                 (const S*)tau, (const S*)gq, (const S*)gv, (S*)dq, (S*)dv, (S*)dtau, (S*)qo,
                 (S*)vo, B, e, k);
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

// (dq, dv, dtau) = (gq, gv) . d(q', v')/d(q, v, tau); K = nq + 2 nv. qo and
// vo may be null; when given they receive the primal step (q', v').
int fused_step_vjp_f32(const void* di, const void* df, const void* q, const void* v,
                       const void* tau, const void* gq, const void* gv, void* dq, void* dv,
                       void* dtau, void* qo, void* vo, int B, int K, void* stream) {
  return fused::launch_vjp<float>(di, df, q, v, tau, gq, gv, dq, dv, dtau, qo, vo, B, K, stream);
}

int fused_step_vjp_f64(const void* di, const void* df, const void* q, const void* v,
                       const void* tau, const void* gq, const void* gv, void* dq, void* dv,
                       void* dtau, void* qo, void* vo, int B, int K, void* stream) {
  return fused::launch_vjp<double>(di, df, q, v, tau, gq, gv, dq, dv, dtau, qo, vo, B, K, stream);
}

}  // extern "C"
