// Fused constrained timestep for Hopper (sm_90a), and its vector-Jacobian
// product.
//
// Kernel 1, fused_step_kernel: one warp per env. Replaces the Pallas TPU
// kernel `_fwd_kernel` of diffdart_tpu/ops/pallas_step.py:55 (built by
// build_pallas_step), whose body is diffdart_tpu/sim/tilestep.py::
// build_tile_step. The plain PyTorch version of the same arithmetic is
// diffdart_tpu_torch/sim/tilestep.py; this file follows it op for op and in
// the same summation order, so the two agree to rounding (bit for bit where
// the order is the same, since the build turns off FMA contraction:
// -fmad=false, and keeps IEEE sin/cos/sqrt/division). The step runs in three
// stages: lane 0 runs env_front (FK through the LCP rows) into the env's
// Front in shared memory; the warp's 32 lanes run the detached LCP solve
// (lcp_solve_warp: scaling, Jacobi sweeps, Woodbury polish) on it, each
// output element on one lane, with the serial solve's operations in its
// order, so the result is the serial lcp_solve's bit for bit; lane 0 runs
// env_back (the impulse and the integration) and writes q', v'.
//
// Kernel 2, fused_step_vjp_kernel: one thread per env, reverse mode on a
// tape. Replaces the Pallas TPU kernel `_bwd_kernel` of
// diffdart_tpu/ops/pallas_step.py:60, which is jax.vjp of the same tile step
// with the forward recomputed in the kernel. The VJP of one step is
// (dq, dv, dtau) = (gq, gv) . d(q', v')/d(q, v, tau). Each thread records
// the step once on Adj<S> values, env_front and then env_back with the
// gradient attachment, at the step's detached LCP solution (`best` and its
// residual, which record nothing). That solution is kernel 1's: a
// differentiable forward launch writes it (D + 1 values per env),
// FusedStepFn saves it beside (q, v, tau), and the VJP reads it, so the
// backward pass does not solve the LCP again. A launch given none (a direct
// call, the counting launch) solves it itself with the serial lcp_solve,
// bit for bit the warp's; ops/fused_step.py counts those launches
// (VJP_KERNEL.self_solved). Every elementary operation appends a node
// (its operands' node indices and the partials of torch's backward formula)
// to the env's tape in device memory. The thread then seeds the adjoints of
// q', v' with gq, gv, sweeps the nodes from last to first, adding each
// node's adjoint times its partials into its operands' adjoints, and reads
// dq, dv, dtau from the K = nq + 2 nv leaf nodes. The gradient is taken of
// the very code kernel 1 runs (the same env_front and env_back at kernel
// 1's own solution, so the recording's primal is kernel 1's output bit for
// bit): the two cannot drift apart, and nothing of the physics is written
// twice. The recorded operations are the
// plain version's, in its order and with its constant folding
// (ops/tile.py), and the sweep runs them in the order torch's engine runs
// the plain version's backward (highest sequence number first), so the
// adjoint sums round as torch's do.
//
// The tape: node n of env e sits at n * B + e (node-major, env-minor: a
// warp's 32 stores coalesce while its envs take the same branches), reached
// by the operators through a per-thread context (tape base, B, e, node
// counter) in a __shared__ slot per thread of the 32-thread block. A node is
// 16 bytes in float32 (two int32 operand indices, two partials) and its
// adjoint 4; 24 and 8 in float64. Every env of a model records the same
// number of nodes (the node kinds below): the half-cheetah records 7,243 in
// float32, 144,860 bytes per env and 593 MB per launch at B = 4096 (7,153
// and 228,896 bytes per env in float64); the octahedron of the tests (one
// hull of 6 vertices, 4 slots) 3,903 in float32. ops/fused_step.py counts the nodes
// once per model and dtype with a launch that only counts, sizes the tape
// with a margin, and raises when an env overflows it: the kernel then
// counts on, stores nothing past the capacity, sets a flag and writes no
// result for that env.
//
// What each kernel computes, per env: FK, world motion subspaces, body
// velocities, the structured world inertias, the mass matrix (plus armature
// and implicit damping/spring terms), bias forces, an unrolled Cholesky and
// Minv, v*, capsule/sphere/box/convex-hull vs fixed-plane contacts (a hull's
// 4 deepest vertices, hull_slots), the LCP rows (contact
// normal, two friction rows per contact, joint-limit rows, servo and
// joint-friction rows), the matrix-free boxed LCP (diag and |A| row sums from
// D^2 dot products of length nv, phased Jacobi sweeps applying
// J Minv J^T + cfm, then two guarded Woodbury polish passes, each building
// S = cfm M + J^T (I+B) F J and solving it by Gaussian elimination without
// pivoting), v' = v* + Minv J^T lam and the position update.
//
// Gradient semantics (sim/tilestep.py:_tile_lcp of both packages): the
// sweeps and polish passes are stop-gradient, so the recording takes their
// result as a primal value (kernel 1's, or the serial solve's), and records
// nothing of them. It then runs what kernel 1 skips: a probe pass at `best` (primal) whose finiteness and drift decide
// `ok`, and one more Woodbury pass on the recorded J, b and M at
// `ok ? best : 0`, whose adjoint is the implicit-function-theorem gradient
// of lam; the value stays `best` (straight_through), and envs that are not
// `ok` get no gradient through lam. Kernel 1 returns `best` directly (the
// value of that straight-through output) and skips both passes.
//
// Model data: the TPU kernels bake the model in as trace constants. Here the
// model is a packed descriptor in device memory (DescI: topology as int32;
// DescF<S>: parameters in the state dtype), built once per model by
// ops/fused_step.py, which also checks every size cap below and raises for a
// model over one. The subset is the plain version's: REVOLUTE / PRISMATIC /
// PLANAR / WELD / FREE / BALL joints (quaternion FK and geometric
// integration), capsule / sphere / box / convex-hull vs fixed-plane contacts
// (the hulls' real vertices in one pool of MAX_HULL_VERTS), joint-limit
// rows, and servo / joint-friction rows with constant boxes.
//
// What bounds them on the H100: not DRAM. An env of kernel 1 reads 3
// vectors and writes 2, but its LCP at D = 42, nv = 9 does about 30k
// multiply-adds (the scaling's D^2 dot products of length nv, the sweeps'
// and residuals' matvecs, the Woodbury passes), nearly all of them
// independent per output element, while the front end's few thousand are a
// chain on one thread. So kernel 1 gives each env a warp: the solve spreads
// over 32 lanes; the env's J, M and Minv sit in shared memory (rows padded
// to an odd stride, RowStride, so that lanes reading one row each hit
// different banks), with the solve's scratch sized from the model's D and
// nv, and so do lane 0's inputs and the front end's working arrays (in
// local memory a lone lane's words sit 128 bytes apart, a cache sector
// each); the other warps of an SM (fused_step_occupancy says how many fit)
// overlap one warp's serial front end with their solves. That front end is
// now what bounds kernel 1: a chain of dependent operations on one lane,
// which more warps per SM do not shorten, so its next step is to share the
// front end's work across the lanes (PERF.md). The VJP kernel is one
// thread per env: its recording runs the front and back ends on 8-byte Adj
// values at the solution kernel 1's warp saved (a solve on one thread per
// env, one warp per SM, cost it about a quarter of the recording) and
// stores the tape, written once and read once (2 x 593 MB at B = 4096,
// 0.35 ms at 3.35 TB/s: the floor of this design, not of the work). The sweep hides what latency it can with one
// warp per SM: it loads SWEEP_CHUNK nodes' records and adjoints at once and
// adds into earlier chunks' adjoints by reductions it does not wait for.
// Both kernels state their times beside the bound in PERF.md.
//
// Types: V is the value type (S, or Adj<S> in the VJP), S the descriptor's
// scalar (float or double).

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define HD_NOINLINE __host__ __device__ __noinline__
#else
#include <algorithm>
#include <vector>
#define HD inline
#define HD_NOINLINE inline
#endif

namespace fused {

constexpr int MAX_NB = 16;
constexpr int MAX_NQ = 16;
constexpr int MAX_NV = 16;
constexpr int MAX_PAIRS = 16;
constexpr int MAX_NC = 32;
constexpr int MAX_LIM = 16;
constexpr int MAX_D = 64;
constexpr int MAX_HULL_VERTS = 64;  // the hull vertex pool, over all convex pairs
constexpr int HULL_SLOTS = 4;       // slots of a convex pair: its 4 deepest vertices

enum { J_WELD = 0, J_REVOLUTE = 1, J_PRISMATIC = 2, J_BALL = 5, J_PLANAR = 9, J_FREE = 10 };
enum { G_SPHERE = 0, G_BOX = 1, G_CAPSULE = 2, G_CONVEX = 6 };

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
  int pair_vert_off[MAX_PAIRS];  // a convex pair's first vertex in hull_verts
  int pair_nvert[MAX_PAIRS];     // and its vertex count (0 for other pairs)
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
  S pair_off[MAX_PAIRS];             // p_pl . n, folded in float64 on the host
  S hull_verts[MAX_HULL_VERTS][3];  // geom-local hull vertices, real ones only
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

// The plain version's torch.where, and a product or sum with a value that the
// plain version holds as a tensor without a gradient (an active-set mask):
// on plain values, the ordinary operations. The Adj overloads below record
// them as the plain version's autograd graph has them.
template <typename T>
HD T select(bool c, T a, T b) { return c ? a : b; }
HD float mmul(float m, float x) { return m * x; }
HD double mmul(double m, double x) { return m * x; }
HD float madd(float x, float c) { return x + c; }
HD double madd(double x, double c) { return x + c; }

// ---------------- the tape (the VJP kernel's reverse mode) ----------------
// Adj<S> is a value and the index of the tape node that made it. Every
// elementary operation on an Adj appends one node: the indices of its (at
// most two) active operands and its local partials, the factors by which
// torch's backward formula of that operation scales the output's gradient.
// A reverse sweep over the nodes, last to first, then accumulates each
// node's adjoint into its operands' adjoints, in the order torch's engine
// runs the plain version's backward (highest sequence number first).
//
// Index >= 0: a node. The negative kinds record nothing, and fold as the
// plain version (ops/tile.py) folds its Python constants and None:
//   K_CONST  a constant of the model or a literal (a Python float there),
//   K_ZERO   a structural zero (None there: x * 0, 0 / x),
//   K_OPAQUE a value without a gradient that the plain version holds as a
//            tensor (a mask, a select of constants): never folded.
// The kinds depend on the model, not on the data, so every env of a model
// records the same number of nodes (data-dependent choices record a node
// either way: a select, a masked product, a dead safe_div denominator).
constexpr int K_CONST = -1, K_ZERO = -2, K_OPAQUE = -3;
constexpr int DIV_EDGE = 1 << 30;  // flag on p0: the adjoint is divided by w0
constexpr int IDX_MASK = DIV_EDGE - 1;

// node n of env e sits at n * B + e (node-major, env-minor: a warp's stores
// coalesce); the adjoints follow the nodes in the same layout
template <typename S>
struct alignas(sizeof(S) == 4 ? 16 : 8) Node {
  int p0, p1;  // operands' node indices (-1: none), p0 may carry DIV_EDGE
  S w0, w1;    // local partials
};

// Per-thread recording context, reached by the operators without an
// argument: a __shared__ slot per thread of the 32-thread block on the card,
// a thread_local on the host.
struct TapeCtx {
  unsigned char* nodes;  // Node<S>[cap][B]; null: count only
  unsigned char* adj;    // S[cap][B]
  int64_t B;
  int e, n, cap;
};
#ifdef __CUDACC__
__shared__ TapeCtx tape_slots[32];
#endif
#ifndef __CUDA_ARCH__
static thread_local TapeCtx tape_host;
#endif
HD TapeCtx& tape_ctx() {
#ifdef __CUDA_ARCH__
  return tape_slots[threadIdx.x];
#else
  return tape_host;
#endif
}

// Tape traffic. The nodes are written once and read once, much later
// (evict-first on the card: __stcs / __ldcs); the sweep reads an adjoint at
// L2 (__ldcg), where the atomics that add into it are performed.
template <typename S>
HD void store_stream(S* p, S x) {
#ifdef __CUDA_ARCH__
  __stcs(p, x);
#else
  *p = x;
#endif
}
template <typename S>
HD void store_node(Node<S>* p, const Node<S>& r) {
  int* i = reinterpret_cast<int*>(p);
  S* w = reinterpret_cast<S*>(i + 2);
  store_stream(i, r.p0);
  store_stream(i + 1, r.p1);
  store_stream(w, r.w0);
  store_stream(w + 1, r.w1);
}
template <typename S>
HD Node<S> load_node(const Node<S>* p) {
  const int* i = reinterpret_cast<const int*>(p);
  const S* w = reinterpret_cast<const S*>(i + 2);
#ifdef __CUDA_ARCH__
  return Node<S>{__ldcs(i), __ldcs(i + 1), __ldcs(w), __ldcs(w + 1)};
#else
  return *p;
#endif
}
template <typename S>
HD S load_adj(const S* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}
// adj += c, performed where the sweep's loads read it (a reduction at L2 on
// the card, which the thread does not wait for)
template <typename S>
HD void add_adj(S* p, S c) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, c);
#else
  *p = *p + c;
#endif
}

// Append a node; past the capacity it is counted and not stored.
template <typename S>
HD int tape_rec(int p0, S w0, int p1, S w1) {
  TapeCtx& t = tape_ctx();
  const int n = t.n++;
  if (t.nodes != nullptr && n < t.cap) {
    const int64_t o = (int64_t)n * t.B + t.e;
    store_node(reinterpret_cast<Node<S>*>(t.nodes) + o, Node<S>{p0, p1, w0, w1});
    store_stream(reinterpret_cast<S*>(t.adj) + o, S(0));
  }
  return n;
}

template <typename S>
struct Adj {
  S v;  // value, bit for bit kernel 1's
  int i;
  Adj() = default;
  HD Adj(S x) : v(x), i(K_CONST) {}
  HD Adj(S x, int idx) : v(x), i(idx) {}
};

// The operators below take their operands by value (8 bytes in float32).

template <typename S>
HD bool zero_(Adj<S> a) { return a.i == K_ZERO || (a.i == K_CONST && a.v == S(0)); }
template <typename S>
HD bool one_(Adj<S> a) { return a.i == K_CONST && a.v == S(1); }

// the value `val` of an operation on a and b with partials wa, wb: a node
// over the active operands, else a constant (opaque if either is)
template <typename S>
HD Adj<S> link(S val, Adj<S> a, S wa, Adj<S> b, S wb, int aflag = 0) {
  if (a.i >= 0) return Adj<S>(val, tape_rec<S>(a.i | aflag, wa, b.i >= 0 ? b.i : -1, wb));
  if (b.i >= 0) return Adj<S>(val, tape_rec<S>(b.i, wb, -1, S(0)));
  return Adj<S>(val, (a.i == K_OPAQUE || b.i == K_OPAQUE) ? K_OPAQUE : K_CONST);
}
template <typename S>
HD Adj<S> link1(S val, Adj<S> a, S wa, int aflag = 0) {
  if (a.i >= 0) return Adj<S>(val, tape_rec<S>(a.i | aflag, wa, -1, S(0)));
  return Adj<S>(val, a.i == K_OPAQUE ? K_OPAQUE : K_CONST);
}
// as link, for partials that torch masks to an exact 0 (no edge then); a
// node is recorded whenever an operand is active
template <typename S>
HD Adj<S> link_masked(S val, Adj<S> a, S wa, Adj<S> b, S wb) {
  if (a.i < 0 && b.i < 0) return link(val, a, wa, b, wb);
  const bool ea = a.i >= 0 && wa != S(0), eb = b.i >= 0 && wb != S(0);
  if (ea) return Adj<S>(val, tape_rec<S>(a.i, wa, eb ? b.i : -1, wb));
  return Adj<S>(val, tape_rec<S>(eb ? b.i : -1, wb, -1, S(0)));
}

// torch's backward formulas: add and sub pass the gradient (negated for the
// subtrahend), mul scales it by the other operand, div divides it by the
// denominator and scales the denominator's by -(a / b) / b
template <typename S>
HD Adj<S> operator+(Adj<S> a, Adj<S> b) {
  const S val = a.v + b.v;
  if (zero_(a)) return Adj<S>(val, zero_(b) ? K_ZERO : b.i);
  if (zero_(b)) return Adj<S>(val, a.i);
  return link(val, a, S(1), b, S(1));
}
template <typename S>
HD Adj<S> operator-(Adj<S> a) {
  return link1(-a.v, a, S(-1));
}
template <typename S>
HD Adj<S> operator-(Adj<S> a, Adj<S> b) {
  const S val = a.v - b.v;
  if (zero_(b)) return Adj<S>(val, zero_(a) ? K_ZERO : a.i);
  if (zero_(a)) return link1(val, b, S(-1));
  return link(val, a, S(1), b, S(-1));
}
template <typename S>
HD Adj<S> operator*(Adj<S> a, Adj<S> b) {
  const S val = a.v * b.v;
  if (zero_(a) || zero_(b)) return Adj<S>(val, K_ZERO);
  if (one_(a)) return Adj<S>(val, b.i);
  if (one_(b)) return Adj<S>(val, a.i);
  return link(val, a, b.v, b, a.v);
}
template <typename S>
HD Adj<S> operator/(Adj<S> a, Adj<S> b) {
  const S val = a.v / b.v;
  if (zero_(a)) return Adj<S>(val, K_ZERO);
  return link(val, a, b.v, b, -(val / b.v), DIV_EDGE);
}
template <typename S> HD Adj<S> operator+(Adj<S> a, S b) { return a + Adj<S>(b); }
template <typename S> HD Adj<S> operator+(S a, Adj<S> b) { return Adj<S>(a) + b; }
template <typename S> HD Adj<S> operator-(Adj<S> a, S b) { return a - Adj<S>(b); }
template <typename S> HD Adj<S> operator-(S a, Adj<S> b) { return Adj<S>(a) - b; }
template <typename S> HD Adj<S> operator*(Adj<S> a, S b) { return a * Adj<S>(b); }
template <typename S> HD Adj<S> operator*(S a, Adj<S> b) { return Adj<S>(a) * b; }
template <typename S> HD Adj<S> operator/(Adj<S> a, S b) { return a / Adj<S>(b); }
template <typename S>
HD bool operator<(Adj<S> a, Adj<S> b) { return a.v < b.v; }
template <typename S>
HD bool operator>(Adj<S> a, Adj<S> b) { return a.v > b.v; }

// maximum / minimum: the gradient goes to the larger (smaller) operand,
// halved at a tie, and to both when one is NaN; an operand that gets
// none has no edge (torch masks it to an exact 0)
template <typename S>
HD Adj<S> tmax(Adj<S> a, Adj<S> b) {
  const bool tie = a.v == b.v;
  const S wa = tie ? S(0.5) : (a.v < b.v ? S(0) : S(1));
  const S wb = tie ? S(0.5) : (a.v > b.v ? S(0) : S(1));
  return link_masked(tmax(a.v, b.v), a, wa, b, wb);
}
template <typename S>
HD Adj<S> tmin(Adj<S> a, Adj<S> b) {
  const bool tie = a.v == b.v;
  const S wa = tie ? S(0.5) : (a.v > b.v ? S(0) : S(1));
  const S wb = tie ? S(0.5) : (a.v < b.v ? S(0) : S(1));
  return link_masked(tmin(a.v, b.v), a, wa, b, wb);
}
template <typename S>
HD Adj<S> t_sin(Adj<S> x) { return link1(t_sin(x.v), x, t_cos(x.v)); }
template <typename S>
HD Adj<S> t_cos(Adj<S> x) { return link1(t_cos(x.v), x, -t_sin(x.v)); }
template <typename S>
HD Adj<S> t_sqrt(Adj<S> x) {
  const S r = t_sqrt(x.v);
  return link1(r, x, S(2) * r, DIV_EDGE);  // torch: grad / (2 result)
}
template <typename S>
HD Adj<S> t_rsqrt(Adj<S> x) {
  const S r = t_rsqrt(x.v);
  // torch: -0.5 grad result^3, result^3 = (r r) r; the factor -0.5 is exact
  return link1(r, x, ((r * r) * r) * S(-0.5));
}
template <typename S>
HD Adj<S> t_abs(Adj<S> x) {
  return link1(t_abs(x.v), x, x.v > S(0) ? S(1) : (x.v < S(0) ? S(-1) : S(0)));
}
template <typename S>
HD bool t_finite(Adj<S> x) { return t_finite(x.v); }
// a structural zero: only a constant may be skipped (an active node whose
// value is 0 still carries partials)
template <typename S>
HD bool is_zero(Adj<S> x) { return zero_(x); }
template <typename S>
HD S primal(Adj<S> x) { return x.v; }
// the plain version's float32 safe_div, torch.where(dead, 0, n / where(dead,
// 1, d)): the division is recorded whether or not the denominator is dead
template <typename S>
HD Adj<S> safe_div(Adj<S> n, Adj<S> d) {
  if (sizeof(S) == 8) return n / d;
  const bool dead = t_abs(d.v) <= S(1e-20);
  if (zero_(n)) return Adj<S>(safe_div(n.v, d.v), K_ZERO);
  if (d.i == K_CONST || d.i == K_ZERO) return dead ? Adj<S>(S(0), K_ZERO) : n / d;
  const Adj<S> q = n / select(dead, Adj<S>(S(1)), d);
  return select(dead, Adj<S>(S(0)), q);
}
template <typename S>
HD Adj<S> select(bool c, Adj<S> a, Adj<S> b) {
  Adj<S> x = c ? a : b;
  if (x.i >= 0) return Adj<S>(x.v, tape_rec<S>(x.i, S(1), -1, S(0)));
  if (a.i >= 0 || b.i >= 0) return Adj<S>(x.v, tape_rec<S>(-1, S(0), -1, S(0)));
  return Adj<S>(x.v, K_OPAQUE);
}
template <typename S>
HD Adj<S> mmul(S m, Adj<S> x) {
  if (zero_(x)) return Adj<S>(m * x.v, K_ZERO);
  return x.i >= 0 ? Adj<S>(m * x.v, tape_rec<S>(x.i, m, -1, S(0))) : Adj<S>(m * x.v, K_OPAQUE);
}
template <typename S>
HD Adj<S> madd(Adj<S> x, S c) {
  return x.i >= 0 ? Adj<S>(x.v + c, tape_rec<S>(x.i, S(1), -1, S(0))) : Adj<S>(x.v + c, K_OPAQUE);
}
// the gradient attachment's straight-through output: value `best`, the
// gradient of g where ok (torch.where(ok, best + (g - g.detach()), best))
template <typename S>
HD Adj<S> straight_through(S best, bool ok, Adj<S> g) {
  if (g.i < 0) return Adj<S>(best, K_OPAQUE);
  return Adj<S>(best, tape_rec<S>(ok ? g.i : -1, S(1), -1, S(0)));
}

// Row stride of J, M and Minv: odd for kernel 1's plain values, so that
// lanes reading one row each hit different shared-memory banks; the VJP's
// Adj values live in a thread's local memory, unpadded.
template <typename V>
struct RowStride {
  static constexpr int n = MAX_NV + 1;
};
template <typename S>
struct RowStride<Adj<S>> {
  static constexpr int n = MAX_NV;
};

// val<U>(x): x as a U, where U is x's type or its primal type (the detached
// stages of the LCP read Adj arrays as primal values)
template <typename U>
struct Val {
  template <typename X>
  static HD U of(const X& x) { return primal(x); }
};
template <typename S>
struct Val<Adj<S>> {
  static HD Adj<S> of(const Adj<S>& x) { return x; }
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

// R^3 -> unit quaternion, half-angle convention, Taylor branch near 0. Both
// branches are evaluated and one is selected, in the plain version's order
// (ops/tile.py _cos_sqrt_t, _sinc_t2_t), so that the VJP's tape records its
// graph (and the same number of nodes in every env).
template <typename V>
HD void quat_exp(const V* v, V* out) {
  const V h2 = dot3(v, v) * V(0.25);
  const bool small = h2 < V(1e-8);
  const V safe = select(small, V(1), h2);
  V t = V(1) - h2 / V(2);
  V h4 = h2 * h2;
  const V w_taylor = t + h4 / V(24);
  const V w = select(small, w_taylor, t_cos(t_sqrt(safe)));
  const V r = t_sqrt(select(small, V(1), h2));
  t = V(1) - h2 / V(6);
  h4 = h2 * h2;
  const V s_taylor = t + h4 / V(120);
  const V sin_r = t_sin(r);
  const V sinc = select(small, s_taylor, sin_r / r);
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
// stages read J, b, M and Minv as primal values. The per-element pieces
// below (one output element each) serve the serial solve and the warp's
// alike, so the two compute every element with the same operations.
template <typename V, typename S>
struct Lcp {
  int D, nc, nv;
  int box0;  // first constant-box row (servo, then joint friction)
  static constexpr int LD = RowStride<V>::n;
  V J[MAX_D][LD];
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
    // servo and joint-friction rows are always valid (the plain version
    // returns them unselected)
    return is_box(i) ? c : select(valid[i], c, U(0));
  }

  // the scaling: W[i][k] = (Minv J^T)[k, i]; J_i . w for a row w of W; the
  // diagonal from J_i . W_i; a row's scale from its diagonal and |A| row sum
  HD S w_elem(const V (*Minv)[LD], int i, int k) const {
    S acc = S(0);
    for (int j = 0; j < nv; ++j) acc = acc + primal(Minv[k][j]) * primal(J[i][j]);
    return acc;
  }
  HD S jw(int i, const S* w) const {
    S acc = S(0);
    for (int k = 0; k < nv; ++k) acc = acc + primal(J[i][k]) * w[k];
    return acc;
  }
  HD S diag_of(S jw_ii) const { return tmax(jw_ii + cfm, S(1e-12)); }
  static HD S scale_of(S diag, S rowsum) {
    return tclip(diag / tmax(rowsum, S(1e-12)), S(0.3), S(0.9)) / diag;
  }

  // out = J Minv J^T lam + cfm lam, matrix-free (primal), element by
  // element: jt = J^T lam, u = Minv jt, out_i = cfm lam_i + J_i . u
  HD S jt_elem(int j, const S* lam) const {
    S acc = S(0);
    for (int i = 0; i < D; ++i) acc = acc + primal(J[i][j]) * lam[i];
    return acc;
  }
  HD S u_elem(const V (*Minv)[LD], int k, const S* jt) const {
    S acc = S(0);
    for (int j = 0; j < nv; ++j) acc = acc + primal(Minv[k][j]) * jt[j];
    return acc;
  }
  HD S out_elem(int i, const S* lam, const S* u) const {
    S acc = cfm * lam[i];
    for (int j = 0; j < nv; ++j) acc = acc + primal(J[i][j]) * u[j];
    return acc;
  }
  HD void matvec(const V (*Minv)[LD], const S* lam, S* out) const {
    S jt[MAX_NV], u[MAX_NV];
    for (int j = 0; j < nv; ++j) jt[j] = jt_elem(j, lam);
    for (int k = 0; k < nv; ++k) u[k] = u_elem(Minv, k, jt);
    for (int i = 0; i < D; ++i) out[i] = out_elem(i, lam, u);
  }

  // row i of a half-sweep: its new lam from its (A lam)_i; reads lam only at
  // i and, for a friction row, at fidx(i), a row of the other phase
  HD S sweep_row(int i, S scale_i, S Alam_i, const S* lam) const {
    const S cand = lam[i] - scale_i * (Alam_i + primal(b[i]));
    return clip_row<S>(i, cand, lam);
  }
  // row i's term of the natural-map residual, from w_i = (A lam)_i
  HD S residual_row(int i, S w_i, const S* lam) const {
    const S proj = clip_row<S>(i, lam[i] - (w_i + primal(b[i])), lam);
    return t_abs(lam[i] - proj);
  }

  HD S nat_residual(const V (*Minv)[LD], const S* lam) const {
    S w[MAX_D];
    matvec(Minv, lam, w);
    S res = S(0);
    for (int i = 0; i < D; ++i) res = tmax(res, residual_row(i, w[i], lam));
    return res;
  }

  // row i's active-set masks of a Woodbury pass from iterate lam: free (Ff),
  // friction-bound coupling (fbm) and constant-box pin; reads lam at i and,
  // for a friction row, at fidx(i)
  HD void pass_masks(int i, const S* lam, S& Ff, S& fbm, S& pin) const {
    const S tol = S(1e-8);
    pin = S(0);
    const S tol_sc = tmax(t_abs(lam[i]), S(1)) * tol;
    if (is_fr(i)) {
      const S bound = mu[fidx(i)] * lam[fidx(i)];
      const bool at_lo = lam[i] <= tol_sc - bound;
      const bool at_hi = lam[i] >= bound - tol_sc;
      const bool degen = at_lo && at_hi;
      const bool free_ = !at_lo && !at_hi && valid[i];
      const bool frb = (at_lo || at_hi) && !degen && valid[i];
      Ff = free_ ? S(1) : S(0);
      fbm = ((frb ? S(1) : S(0)) * (at_hi ? S(1) : S(-1))) * mu[fidx(i)];
    } else if (is_box(i)) {
      // constant box [-c, +c]: at-bound rows pin to +-c, entering the KKT
      // rhs as cfm * c_pin
      const S cb = box_c[i - box0];
      const bool at_lo = lam[i] <= tol_sc - cb;
      const bool at_hi = lam[i] >= cb - tol_sc;
      const bool degen = at_lo && at_hi;
      const bool pinned = (at_lo || at_hi) && !degen && valid[i];
      Ff = (!at_lo && !at_hi && valid[i]) ? S(1) : S(0);
      fbm = S(0);
      pin = ((pinned ? S(1) : S(0)) * (at_hi ? S(1) : S(-1))) * cb;
    } else {
      Ff = (!(lam[i] <= tol_sc) && valid[i]) ? S(1) : S(0);
      fbm = S(0);
    }
  }

  // one active-set Woodbury pass from iterate lam (sim/tilestep.py
  // one_pass). The active set comes from lam and carries no gradient; with
  // U = V the pass is differentiated through J, b and M. The masks (Ff, fbm,
  // pin) are tensors without a gradient in the plain version: mmul / madd.
  template <typename U>
  HD void one_pass(const V (*M)[LD], const S* lam, U* out) const {
    S Ff[MAX_D], fbm[MAX_D], pin[MAX_D];
    for (int i = 0; i < D; ++i) pass_masks(i, lam, Ff[i], fbm[i], pin[i]);
    // S = cfm M + J^T (I+B) F J
    U Sm[MAX_NV][MAX_NV];
    for (int a = 0; a < nv; ++a)
      for (int c = 0; c < nv; ++c) Sm[a][c] = cfm * val<U>(M[a][c]);
    for (int i = 0; i < D; ++i) {
      U X[MAX_NV];
      for (int j = 0; j < nv; ++j) X[j] = mmul(Ff[i], val<U>(J[i][j]));
      if (is_fr(i)) {
        const int n = fidx(i);
        const S coef = fbm[i] * Ff[n];
        for (int j = 0; j < nv; ++j) X[j] = X[j] + mmul(coef, val<U>(J[n][j]));
      }
      for (int a = 0; a < nv; ++a)
        for (int c = 0; c < nv; ++c) Sm[a][c] = Sm[a][c] + val<U>(J[i][a]) * X[c];
    }
    // rhs_u = J^T ((I+B) r + cfm pin) with r = -F b, all of (I+B) r first
    // and then the sums, as the plain version creates them
    U r[MAX_D], ibr[MAX_D], rhs[MAX_NV], u[MAX_NV];
    for (int i = 0; i < D; ++i) r[i] = mmul(Ff[i], -val<U>(b[i]));
    for (int i = 0; i < D; ++i) {
      U t = r[i];
      if (is_fr(i)) t = t + mmul(fbm[i], r[fidx(i)]);
      if (is_box(i)) t = madd(t, cfm * pin[i]);
      ibr[i] = t;
    }
    for (int j = 0; j < nv; ++j) rhs[j] = U(0);
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < nv; ++j) rhs[j] = rhs[j] + val<U>(J[i][j]) * ibr[i];
    // Gaussian elimination without pivoting (S is unsymmetric when the
    // friction-bound coupling is active); zeros below the diagonal are
    // skipped as the plain version skips its structural zeros (an Adj only
    // when it is a constant)
    for (int k = 0; k < nv - 1; ++k)
      for (int i = k + 1; i < nv; ++i) {
        if (is_zero(Sm[i][k])) continue;
        const U f = safe_div(Sm[i][k], Sm[k][k]);
        for (int j = k + 1; j < nv; ++j) Sm[i][j] = Sm[i][j] - f * Sm[k][j];
        rhs[i] = rhs[i] - f * rhs[k];
      }
    back_substitute(&Sm[0][0], MAX_NV, rhs, u, nv);
    // x = (r - F J u) / cfm on the free set; lam' = (I+B) x, projected
    U x[MAX_D];
    for (int i = 0; i < D; ++i) {
      U ju = U(0);
      for (int j = 0; j < nv; ++j) ju = ju + val<U>(J[i][j]) * u[j];
      x[i] = mmul(Ff[i], (r[i] - mmul(Ff[i], ju)) / cfm);
    }
    U lam_new[MAX_D];
    for (int i = 0; i < D; ++i) {
      U t = x[i];
      if (is_fr(i)) t = t + mmul(fbm[i], x[fidx(i)]);
      if (is_box(i)) t = madd(t, pin[i]);
      lam_new[i] = t;
    }
    for (int i = 0; i < D; ++i) out[i] = clip_row<U>(i, lam_new[i], lam_new);
  }

  // u = Sm^-1 rhs for the upper triangle that the elimination left in Sm
  // (row stride ld): a chain, on one thread
  template <typename U>
  static HD void back_substitute(const U* Sm, int ld, const U* rhs, U* u, int nv) {
    for (int i = nv - 1; i >= 0; --i) {
      U s = rhs[i];
      for (int j = i + 1; j < nv; ++j) s = s - Sm[i * ld + j] * u[j];
      u[i] = safe_div(s, Sm[i * ld + i]);
    }
  }
};

// v' = v* + Minv J^T lam
template <typename V, typename S, typename L>
HD void apply_impulse(const Lcp<V, S>& lcp, const V (*Minv)[RowStride<V>::n], const V* v_star,
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

// What env_front hands the solve and env_back: the env's LCP, its mass
// matrix and inverse, and the unconstrained velocity. Kernel 1 keeps it in
// shared memory, the VJP kernel in the thread's local memory.
template <typename V, typename S>
struct Front {
  Lcp<V, S> lcp;
  V M[MAX_NV][RowStride<V>::n];
  V Minv[MAX_NV][RowStride<V>::n];
  V v_star[MAX_NV];
};

// The front end's working arrays (kernel 1: in the env's shared memory,
// in the room the solve's scratch takes later; the VJP: local memory).
template <typename V>
struct FrontWork {
  V R[MAX_NB][9], P[MAX_NB][3];
  V Sw[MAX_NV][6], wl[6][3], vl[6][3];
  V Vb[MAX_NB][6], cw[MAX_NB][3], Icw[MAX_NB][9];
  V sdot[MAX_NV][6], C[MAX_NV], rhs[MAX_NV];
  V L[MAX_NV][MAX_NV], y[MAX_NV], x[MAX_NV];
  V v[MAX_NV], tau[MAX_NV];  // kernel 1's inputs (the VJP's are its tape leaves)
};

// A hull vertex vl (geom-local, a descriptor constant) in the world,
// w = Rg vl + pg, and its depth below the plane, off - w . n. The plain
// version skips a zero coordinate of vl (a structural zero there); the full
// product here differs from that sum only in the sign of a zero
// (0 * x + y == y), and on Adj values it records the same nodes whichever
// vertex a slot takes (a vertex coordinate is never folded: Opaque), so
// every env of a model records the same number of nodes.
template <typename V>
struct Opaque {
  template <typename S>
  static HD V of(S x) { return x; }
};
template <typename S>
struct Opaque<Adj<S>> {
  static HD Adj<S> of(S x) { return Adj<S>(x, K_OPAQUE); }
};

template <typename V, typename S>
HD V hull_vertex(const S* vl, const V* Rg, const V* pg, const S* n, S off, V* w) {
  const V x[3] = {Opaque<V>::of(vl[0]), Opaque<V>::of(vl[1]), Opaque<V>::of(vl[2])};
  matvec3(Rg, x, w);
  for (int i = 0; i < 3; ++i) w[i] = w[i] + pg[i];
  return off - dot3(w, n);
}

// The slots of a convex pair, chosen on primal values (no tape node): the
// indices of its HULL_SLOTS deepest vertices, deepest first, as the plain
// version's _topk_tile_slots chooses them. Each slot is a running maximum
// over the scores (NaN propagates, as torch.maximum), then the first vertex
// whose score equals it, so a later equal value never wins a tie; the
// winner's score drops to -1e30. -1 where no score equals the maximum (a NaN
// state); slots past the hull's vertex count are left -1 (dead slots).
template <typename S>
HD void hull_slots(const S (*verts)[3], int nvert, const S* Rg, const S* pg, const S* n, S off,
                   int* sel) {
  S ms[MAX_HULL_VERTS];
  for (int j = 0; j < nvert; ++j) {
    S w[3];
    ms[j] = hull_vertex<S, S>(verts[j], Rg, pg, n, off, w);
  }
  for (int s = 0; s < HULL_SLOTS; ++s) sel[s] = -1;
  const int k = nvert < HULL_SLOTS ? nvert : HULL_SLOTS;
  for (int s = 0; s < k; ++s) {
    S best = ms[0];
    for (int j = 1; j < nvert; ++j) best = tmax(best, ms[j]);
    for (int j = 0; j < nvert; ++j)
      if (ms[j] == best) {
        sel[s] = j;
        ms[j] = S(-1e30);
        break;
      }
  }
}

// The step's first stage, one env, on values of type V: FK, the mass
// matrix and its inverse, the unconstrained velocity v*, the contacts and
// the LCP rows, into fr (lcp.D = 0: no rows); w holds its working arrays.
template <typename V, typename S>
HD void env_front(const DescI& I, const DescF<S>& F, const V* __restrict__ q,
                  const V* __restrict__ v, const V* __restrict__ tau, Front<V, S>& fr,
                  FrontWork<V>& w) {
  const int nb = I.nb, nv = I.nv;
  const S dt = F.dt;

  // ---------------- FK ----------------
  auto& R = w.R;
  auto& P = w.P;
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
  auto& Sw = w.Sw;
  for (int i = 0; i < nb; ++i) {
    const int o = I.v_off[i];
    const int jt = I.jtype[i];
    int nrow = 0;
    auto& wl = w.wl;
    auto& vl = w.vl;
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
  auto& Vb = w.Vb;
  for (int b = 0; b < nb; ++b) {
    for (int k = 0; k < 6; ++k) Vb[b][k] = V(0);
    for (int j = 0; j < nv; ++j)
      if (I.anc[b][j])
        for (int k = 0; k < 6; ++k) Vb[b][k] = Vb[b][k] + Sw[j][k] * v[j];
  }

  // ---------------- world spatial inertia (structured) ----------------
  auto& cw = w.cw;
  auto& Icw = w.Icw;
  for (int b = 0; b < nb; ++b) {
    matvec3(R[b], F.com[b], cw[b]);
    for (int k = 0; k < 3; ++k) cw[b][k] = cw[b][k] + P[b][k];
    V RI[9];
    matmul3(R[b], F.inertia[b], RI);
    matmul3_bt(RI, R[b], Icw[b]);
  }

  // ---------------- mass matrix ----------------
  auto& M = fr.M;
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
  auto& sdot = w.sdot;
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
  auto& C = w.C;
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
  auto& rhs = w.rhs;
  for (int i = 0; i < nv; ++i) {
    V fj = (-F.damping[i]) * v[i];
    if (F.spring[i] != S(0))
      fj = fj - F.spring[i] * ((q[I.dof_qidx[i]] - F.q_rest[i]) + dt * v[i]);
    rhs[i] = tau[i] + (fj - C[i]);
  }
  auto& L = w.L;
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j <= i; ++j) {
      V s = M[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j)
        L[i][i] = t_sqrt(tmax(s, V(1e-12)));
      else
        L[i][j] = s / L[j][j];
    }
  auto& Minv = fr.Minv;
  for (int col = 0; col < nv; ++col) {
    auto& y = w.y;
    auto& x = w.x;
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
  auto& v_star = fr.v_star;
  for (int i = 0; i < nv; ++i) {
    V acc = V(0);
    for (int k = 0; k < nv; ++k) acc = acc + Minv[i][k] * rhs[k];
    v_star[i] = v[i] + dt * acc;
  }

  const int D = I.D;
  Lcp<V, S>& lcp = fr.lcp;
  lcp.D = D;
  lcp.nc = I.nc;
  lcp.nv = nv;
  lcp.cfm = F.cfm;
  if (D == 0) return;
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
    const int nslot = gt == G_BOX ? 8 : (gt == G_CAPSULE ? 2 : (gt == G_CONVEX ? HULL_SLOTS : 1));
    const S(*verts)[3] = F.hull_verts + I.pair_vert_off[p];
    const int nvert = I.pair_nvert[p];
    int sel[HULL_SLOTS];
    if (gt == G_CONVEX) {
      S Rgp[9], pgp[3];
      for (int k = 0; k < 9; ++k) Rgp[k] = primal(Rg[k]);
      for (int k = 0; k < 3; ++k) pgp[k] = primal(pg[k]);
      hull_slots<S>(verts, nvert, Rgp, pgp, n, F.pair_off[p], sel);
    }
    for (int s = 0; s < nslot; ++s, ++c) {
      V cpt[3], pos[3], dv[3], depth;
      if (gt == G_CONVEX) {
        // slot s: the vertex hull_slots chose, its depth and its world
        // position (the gradient reaches that vertex alone, as through the
        // plain version's selects); a slot past the hull's vertex count is a
        // structural zero, never valid
        if (s >= nvert) {
          depth = V(0);
          for (int k = 0; k < 3; ++k) pos[k] = V(0);
        } else {
          const bool found = sel[s] >= 0;
          V w[3];
          const V d = hull_vertex<V, S>(verts[found ? sel[s] : 0], Rg, pg, n, F.pair_off[p], w);
          depth = select(found, d, V(0));
          for (int k = 0; k < 3; ++k) pos[k] = select(found, w[k], V(0));
        }
      } else if (gt == G_BOX) {
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
}

// The detached solve (stop-gradient), serial: scaling, phased Jacobi
// sweeps from lam = 0, guarded Woodbury polish passes, on primal values.
// Writes the best iterate to `best` and returns its natural-map residual.
// The VJP runs it only when no forward solution is handed in (env_vjp): a
// function of its own on the card, so that the recording's registers are
// allocated without it.
template <typename V, typename S>
HD_NOINLINE S lcp_solve(const DescI& I, const Front<V, S>& f, S* best) {
  const Lcp<V, S>& lcp = f.lcp;
  const int D = lcp.D, nv = lcp.nv;

  // ---------------- sweep scaling from diag and |A| row sums -----------
  S scale[MAX_D];
  {
    S W[MAX_D][MAX_NV];  // W[i][k] = (Minv J^T)[k, i]
    for (int i = 0; i < D; ++i)
      for (int k = 0; k < nv; ++k) W[i][k] = lcp.w_elem(f.Minv, i, k);
    S diag[MAX_D], rowsum[MAX_D];
    for (int i = 0; i < D; ++i) {
      diag[i] = lcp.diag_of(lcp.jw(i, W[i]));
      rowsum[i] = t_abs(diag[i]);
    }
    // A is symmetric: each off-diagonal entry is computed once (as
    // J_i . W_j, i < j) and credited to both rows, in the plain version's
    // order
    for (int i = 0; i < D; ++i)
      for (int j = i + 1; j < D; ++j) {
        const S ae = t_abs(lcp.jw(i, W[j]));
        rowsum[i] = rowsum[i] + ae;
        rowsum[j] = rowsum[j] + ae;
      }
    for (int i = 0; i < D; ++i) scale[i] = lcp.scale_of(diag[i], rowsum[i]);
  }

  // ---------------- phased Jacobi sweeps (warm start) ----------------
  S lam[MAX_D], r[MAX_D];
  for (int i = 0; i < D; ++i) lam[i] = S(0);
  for (int it = 0; it < I.iters; ++it)
    for (int phase = 0; phase < 2; ++phase) {
      lcp.matvec(f.Minv, lam, r);
      // rows of one phase never read each other's lam, so the update is
      // in place
      for (int i = 0; i < D; ++i)
        if ((int)lcp.is_fr(i) == phase) lam[i] = lcp.sweep_row(i, scale[i], r[i], lam);
    }

  // ---------------- guarded Woodbury polish passes ----------------
  S cand[MAX_D];
  for (int i = 0; i < D; ++i) best[i] = lam[i];
  S best_res = lcp.nat_residual(f.Minv, best);
  for (int pass = 0; pass < I.passes; ++pass) {
    lcp.template one_pass<S>(f.M, lam, cand);
    bool finite = true;
    for (int i = 0; i < D; ++i) finite = finite && t_finite(cand[i]);
    if (finite)
      for (int i = 0; i < D; ++i) lam[i] = cand[i];
    const S res = lcp.nat_residual(f.Minv, lam);
    if (res < best_res)
      for (int i = 0; i < D; ++i) best[i] = lam[i];
    best_res = tmin(res, best_res);
  }
  return best_res;
}

// The step's last stage, one env: v' = v* + Minv J^T lam at the solve's
// best iterate, then the position update. GRAD (V = Adj<S> only) adds the
// probe pass and the differentiable Woodbury pass of the gradient
// attachment. best and best_res are the solve's (unread when lcp.D = 0).
template <typename V, typename S, bool GRAD>
HD void env_back(const DescI& I, const DescF<S>& F, const V* __restrict__ q,
                 const Front<V, S>& f, const S* best, S best_res, V* __restrict__ q_new,
                 V* __restrict__ v_new) {
  const int nb = I.nb, nq = I.nq, nv = I.nv;
  const S dt = F.dt;
  const Lcp<V, S>& lcp = f.lcp;
  const auto& M = f.M;
  const auto& Minv = f.Minv;
  const auto& v_star = f.v_star;
  const int D = lcp.D;
  if (D == 0) {
    for (int i = 0; i < nv; ++i) v_new[i] = v_star[i];
  } else {
    if constexpr (GRAD) {
      // ---------------- gradient attachment ----------------
      // probe pass at best (primal): envs where it is non-finite or drifts
      // keep the value and get no gradient
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
      S cand[MAX_D];
      for (int i = 0; i < D; ++i) cand[i] = ok ? best[i] : S(0);
      V lam_g[MAX_D];
      lcp.template one_pass<V>(M, cand, lam_g);
      for (int i = 0; i < D; ++i) lam_g[i] = straight_through(best[i], ok, lam_g[i]);
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

// ---------------- the warp's solve (kernel 1) ----------------
// One warp per env. Each phase below is a lanes() call: lane l takes the
// phase's output elements l, l + 32, ... and computes each of them alone,
// with the serial solve's operations in its order (the Lcp pieces above, or
// Lcp::one_pass's expressions written out for one element), so every
// element is the serial solve's bit for bit. A phase reads only what
// earlier phases wrote, and the lanes meet at __syncwarp() after each
// phase. The host build runs a phase's 32 lanes one after another (the
// meeting is the end of that loop), so the CPU tests run the card's
// partition: a missed or doubled element shows there, and only races are
// left for the card to find.
constexpr int WARP = 32;

template <typename Fn>
HD void lanes(Fn&& fn) {
#ifdef __CUDA_ARCH__
  fn((int)(threadIdx.x % WARP));
  __syncwarp();
#else
  for (int lane = 0; lane < WARP; ++lane) fn(lane);
#endif
}

// fn() on lane 0 alone (a chain), then the lanes meet
template <typename Fn>
HD void lane0(Fn&& fn) {
#ifdef __CUDA_ARCH__
  if (threadIdx.x % WARP == 0) fn();
  __syncwarp();
#else
  fn();
#endif
}

// the lanes meet outside a phase: after each has read a reduction's
// partials, before a later phase may write them again
HD void meet() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// Kernel 1's scratch of one env, in shared memory after its Front, sized
// from the model's D and nv: lane 0's q and the solve's kept vectors, then
// one room that the front end's working arrays, the scaling's W, |A|
// triangle and diagonal, and a Woodbury pass's arrays take in turn.
template <typename S>
struct WarpScratch {
  S *q, *lam, *best, *cand, *scale, *red, *jt, *u;
  S* work;  // the front end's FrontWork<S>
  S *W, *tri, *diag;
  S *Ff, *fbm, *pin, *r, *ibr, *x, *lam_new, *Sm, *rhs, *uu;

  // lays the arrays out from base (null: counts only); returns the count
  HD int carve(S* base, int D, int nv) {
    int n = 0, end = 0;
    auto take = [&](S*& p, int k) {
      p = base != nullptr ? base + n : nullptr;
      n += k;
      end = n > end ? n : end;
    };
    take(q, MAX_NQ), take(lam, D), take(best, D), take(cand, D), take(scale, D), take(red, WARP);
    take(jt, nv), take(u, nv);
    const int room = n;
    take(work, (int)(sizeof(FrontWork<S>) / sizeof(S)));
    n = room;
    take(W, D * nv), take(tri, D * (D - 1) / 2), take(diag, D);
    n = room;
    take(Ff, D), take(fbm, D), take(pin, D), take(r, D), take(ibr, D), take(x, D);
    take(lam_new, D), take(Sm, nv * nv), take(rhs, nv), take(uu, nv);
    return end;
  }
};

// |A_ij| for i < j in the scratch's upper triangle (row-major)
HD int tri_at(int i, int j, int D) { return i * D - i * (i + 1) / 2 + (j - i - 1); }

template <typename S>
HD int front_bytes() { return (int)((sizeof(Front<S, S>) + 15) / 16 * 16); }

// shared memory of one env (one warp) of kernel 1: its Front, then the
// solve's scratch; a multiple of 16 bytes
template <typename S>
HD int env_smem_bytes(int D, int nv) {
  WarpScratch<S> s;
  const int n = s.carve(nullptr, D, nv);
  return front_bytes<S>() + (int)((n * sizeof(S) + 15) / 16 * 16);
}

// jt = J^T lam (one lane per element), then u = Minv jt
template <typename S>
HD void warp_jt_u(const Front<S, S>& f, const WarpScratch<S>& s, const S* lam) {
  const Lcp<S, S>& lcp = f.lcp;
  lanes([&](int lane) {
    for (int j = lane; j < lcp.nv; j += WARP) s.jt[j] = lcp.jt_elem(j, lam);
  });
  lanes([&](int lane) {
    for (int k = lane; k < lcp.nv; k += WARP) s.u[k] = lcp.u_elem(f.Minv, k, s.jt);
  });
}

// The natural-map residual of lam. Each lane takes the max over its rows,
// and the lanes' maxima combine in lane order: max is exact (tmax returns
// one of its operands), so any order gives the serial result (a NaN
// anywhere gives a NaN, whose payload may differ; a NaN residual compares
// false either way, and kernel 1 writes no residual).
template <typename S>
HD S warp_residual(const Front<S, S>& f, const WarpScratch<S>& s, const S* lam) {
  const Lcp<S, S>& lcp = f.lcp;
  warp_jt_u(f, s, lam);
  lanes([&](int lane) {
    S part = S(0);
    for (int i = lane; i < lcp.D; i += WARP)
      part = tmax(part, lcp.residual_row(i, lcp.out_elem(i, lam, s.u), lam));
    s.red[lane] = part;
  });
  S res = S(0);
  for (int l = 0; l < WARP; ++l) res = tmax(res, s.red[l]);
  meet();
  return res;
}

// One Woodbury pass from lam into out: Lcp::one_pass<S>, element by
// element. Returns whether every element of out is finite (&& of the lanes'
// &&, exact in any order).
template <typename S>
HD bool warp_one_pass(const Front<S, S>& f, const WarpScratch<S>& s, const S* lam, S* out) {
  const Lcp<S, S>& lcp = f.lcp;
  const int D = lcp.D, nv = lcp.nv;
  const S cfm = lcp.cfm;
  lanes([&](int lane) {  // the row masks and r = -F b
    for (int i = lane; i < D; i += WARP) {
      lcp.pass_masks(i, lam, s.Ff[i], s.fbm[i], s.pin[i]);
      s.r[i] = s.Ff[i] * -lcp.b[i];
    }
  });
  lanes([&](int lane) {
    // Sm = cfm M + J^T (I+B) F J, entry (a, c) on one lane, summed over the
    // rows in order with row i's X rebuilt as one_pass builds it
    for (int t = lane; t < nv * nv; t += WARP) {
      const int a = t / nv, c = t % nv;
      S acc = cfm * f.M[a][c];
      for (int i = 0; i < D; ++i) {
        S x = s.Ff[i] * lcp.J[i][c];
        if (lcp.is_fr(i)) {
          const int n = lcp.fidx(i);
          x = x + (s.fbm[i] * s.Ff[n]) * lcp.J[n][c];
        }
        acc = acc + lcp.J[i][a] * x;
      }
      s.Sm[t] = acc;
    }
    // (I+B) r + cfm pin
    for (int i = lane; i < D; i += WARP) {
      S t = s.r[i];
      if (lcp.is_fr(i)) t = t + s.fbm[i] * s.r[lcp.fidx(i)];
      if (lcp.is_box(i)) t = t + cfm * s.pin[i];
      s.ibr[i] = t;
    }
  });
  lanes([&](int lane) {  // rhs = J^T ((I+B) r + cfm pin)
    for (int j = lane; j < nv; j += WARP) {
      S acc = S(0);
      for (int i = 0; i < D; ++i) acc = acc + lcp.J[i][j] * s.ibr[i];
      s.rhs[j] = acc;
    }
  });
  // elimination, one pivot per phase: each element right of the pivot
  // column in a row below it (and that row's rhs) on one lane; the row's
  // factor is recomputed by each of its lanes, bit for bit the same
  for (int k = 0; k < nv - 1; ++k) {
    const int w = nv - k;  // columns k+1 .. nv-1, then the rhs
    lanes([&](int lane) {
      for (int t = lane; t < (nv - 1 - k) * w; t += WARP) {
        const int i = k + 1 + t / w, j = k + 1 + t % w;
        const S sik = s.Sm[i * nv + k];
        if (is_zero(sik)) continue;
        const S fct = safe_div(sik, s.Sm[k * nv + k]);
        if (j < nv)
          s.Sm[i * nv + j] = s.Sm[i * nv + j] - fct * s.Sm[k * nv + j];
        else
          s.rhs[i] = s.rhs[i] - fct * s.rhs[k];
      }
    });
  }
  lane0([&] { Lcp<S, S>::back_substitute(s.Sm, nv, s.rhs, s.uu, nv); });
  lanes([&](int lane) {  // x = (r - F J u) / cfm on the free set
    for (int i = lane; i < D; i += WARP) {
      S ju = S(0);
      for (int j = 0; j < nv; ++j) ju = ju + lcp.J[i][j] * s.uu[j];
      s.x[i] = s.Ff[i] * ((s.r[i] - s.Ff[i] * ju) / cfm);
    }
  });
  lanes([&](int lane) {  // lam' = (I+B) x + pin
    for (int i = lane; i < D; i += WARP) {
      S t = s.x[i];
      if (lcp.is_fr(i)) t = t + s.fbm[i] * s.x[lcp.fidx(i)];
      if (lcp.is_box(i)) t = t + s.pin[i];
      s.lam_new[i] = t;
    }
  });
  lanes([&](int lane) {  // projected
    bool fin = true;
    for (int i = lane; i < D; i += WARP) {
      out[i] = lcp.template clip_row<S>(i, s.lam_new[i], s.lam_new);
      fin = fin && t_finite(out[i]);
    }
    s.red[lane] = fin ? S(1) : S(0);
  });
  bool finite = true;
  for (int l = 0; l < WARP; ++l) finite = finite && s.red[l] != S(0);
  meet();
  return finite;
}

// lcp_solve on a warp: the same scaling, sweeps and polish passes, bit for
// bit, with the best iterate in s.best; returns its residual.
template <typename S>
HD S lcp_solve_warp(const DescI& I, const Front<S, S>& f, const WarpScratch<S>& s) {
  const Lcp<S, S>& lcp = f.lcp;
  const int D = lcp.D, nv = lcp.nv;
  if (D == 0) return S(0);

  // ---------------- sweep scaling from diag and |A| row sums -----------
  lanes([&](int lane) {  // W, element t = (i, k) on lane t % 32
    int i = lane / nv, k = lane % nv;
    for (int t = lane; t < D * nv; t += WARP) {
      s.W[t] = lcp.w_elem(f.Minv, i, k);
      for (k += WARP; k >= nv; k -= nv) ++i;
    }
  });
  lanes([&](int lane) {
    for (int i = lane; i < D; i += WARP) s.diag[i] = lcp.diag_of(lcp.jw(i, s.W + i * nv));
    // |A_ij| = |J_i . W_j| for i < j: the triangle's entry t (row-major) on
    // lane t % 32, walking row i at offset o = j - i - 1
    int i = 0, o = lane;
    for (; i < D - 1 && o >= D - 1 - i; ++i) o -= D - 1 - i;
    for (int t = lane; i < D - 1; t += WARP) {
      s.tri[t] = t_abs(lcp.jw(i, s.W + (i + 1 + o) * nv));
      for (o += WARP; i < D - 1 && o >= D - 1 - i; ++i) o -= D - 1 - i;
    }
  });
  // row r's sum on one lane, in the serial order of credits: |diag_r|, then
  // |A_ir| for i < r (down column r of the triangle), then |A_rj| for j > r
  // (along its row r)
  lanes([&](int lane) {
    for (int r = lane; r < D; r += WARP) {
      S rs = t_abs(s.diag[r]);
      for (int i = 0, at = r - 1; i < r; at += D - i - 2, ++i) rs = rs + s.tri[at];
      for (int at = tri_at(r, r + 1, D), j = r + 1; j < D; ++j, ++at) rs = rs + s.tri[at];
      s.scale[r] = lcp.scale_of(s.diag[r], rs);
      s.lam[r] = S(0);
    }
  });

  // ---------------- phased Jacobi sweeps (warm start) ----------------
  for (int it = 0; it < I.iters; ++it)
    for (int phase = 0; phase < 2; ++phase) {
      warp_jt_u(f, s, s.lam);
      // row i's lane takes (A lam)_i and updates lam_i in place: a row reads
      // lam only at itself and, for a friction row, at its normal row,
      // which only the other phase writes
      lanes([&](int lane) {
        for (int i = lane; i < D; i += WARP)
          if ((int)lcp.is_fr(i) == phase)
            s.lam[i] = lcp.sweep_row(i, s.scale[i], lcp.out_elem(i, s.lam, s.u), s.lam);
      });
    }

  // ---------------- guarded Woodbury polish passes ----------------
  lanes([&](int lane) {
    for (int i = lane; i < D; i += WARP) s.best[i] = s.lam[i];
  });
  S best_res = warp_residual(f, s, s.best);
  for (int pass = 0; pass < I.passes; ++pass) {
    if (warp_one_pass(f, s, s.lam, s.cand))
      lanes([&](int lane) {
        for (int i = lane; i < D; i += WARP) s.lam[i] = s.cand[i];
      });
    const S res = warp_residual(f, s, s.lam);
    if (res < best_res)
      lanes([&](int lane) {
        for (int i = lane; i < D; i += WARP) s.best[i] = s.lam[i];
      });
    best_res = tmin(res, best_res);
  }
  return best_res;
}

// Kernel 1's per-env work, on one warp (the host build: its lanes in turn):
// SoA (k, B) in and out. sh: the env's shared memory, env_smem_bytes(D, nv)
// bytes, which also holds lane 0's inputs and the front end's working
// arrays (in local memory a lone lane's words would sit 128 bytes apart,
// one cache sector each). front_only: stop after env_front and write v* to v_out, q_out
// untouched (the front end's share of the time). sol, when given, receives
// the detached solve's result, env-major (B, D + 1): row e holds `best`,
// then `best_res`, element i written by lane i % 32, so a warp's stores
// cover one contiguous row (nothing when D = 0). The VJP reads it back
// instead of solving again.
template <typename S>
HD void env_fwd(const DescI& I, const DescF<S>& F, const S* __restrict__ q_in,
                const S* __restrict__ v_in, const S* __restrict__ tau_in, S* __restrict__ q_out,
                S* __restrict__ v_out, S* __restrict__ sol, int B, int e, unsigned char* sh,
                bool front_only) {
  const int nq = I.nq, nv = I.nv;
  Front<S, S>& f = *reinterpret_cast<Front<S, S>*>(sh);
  WarpScratch<S> s;
  s.carve(reinterpret_cast<S*>(sh + front_bytes<S>()), I.D, nv);
  S* q = s.q;
  lane0([&] {
    FrontWork<S>& w = *reinterpret_cast<FrontWork<S>*>(s.work);
    for (int k = 0; k < nq; ++k) q[k] = q_in[(int64_t)k * B + e];
    for (int k = 0; k < nv; ++k) {
      w.v[k] = v_in[(int64_t)k * B + e];
      w.tau[k] = tau_in[(int64_t)k * B + e];
    }
    env_front<S, S>(I, F, q, w.v, w.tau, f, w);
    if (front_only)
      for (int k = 0; k < nv; ++k) v_out[(int64_t)k * B + e] = f.v_star[k];
  });
  if (front_only) return;
  const S best_res = lcp_solve_warp<S>(I, f, s);
  const int D = I.D;
  if (sol != nullptr && D > 0)
    lanes([&](int lane) {
      S* row = sol + (int64_t)e * (D + 1);
      for (int i = lane; i <= D; i += WARP) row[i] = i < D ? s.best[i] : best_res;
    });
  lane0([&] {
    S qn[MAX_NQ], vn[MAX_NV];
    env_back<S, S, false>(I, F, q, f, s.best, best_res, qn, vn);
    for (int k = 0; k < nq; ++k) q_out[(int64_t)k * B + e] = qn[k];
    for (int k = 0; k < nv; ++k) v_out[(int64_t)k * B + e] = vn[k];
  });
}

// The VJP kernel's per-env work: record the step's stages on Adj values
// (the K = nq + 2 nv inputs are the tape's first K nodes), seed the
// adjoints of the outputs with (gq, gv), sweep the tape from its last node
// to its first, and read (dq | dv | dtau) from the K leaves. Between
// env_front and env_back sits the detached LCP solution, which records
// nothing: read from `sol` (kernel 1's row of the env, (B, D + 1)) when
// given, else solved here by the serial lcp_solve, bit for bit the same. `status` gets the largest node
// count of any env (atomic max) and, where an env needs more nodes than
// `cap`, the overflow flag; that env then writes nothing. With tape == null
// the launch only counts; with dq == null it records the tape and stops
// (the recording's share of the time, chip_smoke.py phase 9). q_out / v_out,
// when given, receive the recorded primal step, which is kernel 1's output
// bit for bit.
HD void note_count(int* status, int n, bool over) {
#ifdef __CUDA_ARCH__
  atomicMax(status, n);
  if (over) atomicExch(status + 1, 1);
#else
  if (n > status[0]) status[0] = n;
  if (over) status[1] = 1;
#endif
}

// The reverse sweep over nodes count-1 .. K, SWEEP_CHUNK nodes at a time.
// A chunk's records and adjoints are loaded together (independent loads,
// one round trip per chunk); its nodes' contributions to nodes of the same
// chunk are added in registers, the others into memory (add_adj), so no
// node waits on a store. Every adjoint still receives its contributions in
// the order torch's engine adds them, by decreasing consumer index: those
// of later chunks (in memory, loaded with the chunk), then those of its own
// chunk, in order. A function of its own on the card (not inlined into the
// recording), so that ptxas schedules its loads apart from the recording's
// register pressure.
constexpr int SWEEP_CHUNK = 8;

template <typename S>
HD_NOINLINE void sweep(const Node<S>* __restrict__ nodes, S* __restrict__ adj, int count, int K,
              int64_t B, int e) {
  for (int top = count - 1; top >= K; top -= SWEEP_CHUNK) {
    const int lo = top - SWEEP_CHUNK + 1 > K ? top - SWEEP_CHUNK + 1 : K;
    Node<S> r[SWEEP_CHUNK];
    S acc[SWEEP_CHUNK];
#pragma unroll
    for (int j = 0; j < SWEEP_CHUNK; ++j)
      if (lo + j <= top) {
        r[j] = load_node(nodes + (lo + j) * B + e);
        acc[j] = load_adj(adj + (lo + j) * B + e);
      }
#pragma unroll
    for (int j = SWEEP_CHUNK - 1; j >= 0; --j) {
      if (lo + j > top) continue;
      const S a = acc[j];
#pragma unroll
      for (int edge = 0; edge < 2; ++edge) {
        const int pe = edge == 0 ? r[j].p0 : r[j].p1;
        if (pe < 0) continue;
        const int p = pe & IDX_MASK;
        const S c = edge == 0 ? ((pe & DIV_EDGE) ? a / r[j].w0 : a * r[j].w0) : a * r[j].w1;
        if (p >= lo) {
#pragma unroll
          for (int k = 0; k < SWEEP_CHUNK; ++k)
            if (k < j && p == lo + k) acc[k] = acc[k] + c;
        } else {
          add_adj(adj + p * B + e, c);
        }
      }
    }
  }
}

template <typename S>
HD void env_vjp(const DescI& I, const DescF<S>& F, const S* __restrict__ q_in,
                const S* __restrict__ v_in, const S* __restrict__ tau_in,
                const S* __restrict__ sol, const S* __restrict__ gq, const S* __restrict__ gv,
                S* __restrict__ dq,
                S* __restrict__ dv, S* __restrict__ dtau, S* __restrict__ q_out,
                S* __restrict__ v_out, unsigned char* tape, int* status, int B, int cap, int e) {
  using V = Adj<S>;
  const int nq = I.nq, nv = I.nv, K = nq + 2 * nv;
  TapeCtx& t = tape_ctx();
  t.nodes = tape;
  t.adj = tape == nullptr ? nullptr : tape + (int64_t)cap * B * sizeof(Node<S>);
  t.B = B;
  t.e = e;
  t.n = 0;
  t.cap = cap;
  V q[MAX_NQ], v[MAX_NV], tau[MAX_NV], qn[MAX_NQ], vn[MAX_NV];
  for (int k = 0; k < nq; ++k) q[k] = V(q_in[(int64_t)k * B + e], tape_rec<S>(-1, S(0), -1, S(0)));
  for (int k = 0; k < nv; ++k) v[k] = V(v_in[(int64_t)k * B + e], tape_rec<S>(-1, S(0), -1, S(0)));
  for (int k = 0; k < nv; ++k)
    tau[k] = V(tau_in[(int64_t)k * B + e], tape_rec<S>(-1, S(0), -1, S(0)));
  Front<V, S> f;
  FrontWork<V> fw;
  env_front<V, S>(I, F, q, v, tau, f, fw);
  const int D = f.lcp.D;
  S best[MAX_D], best_res = S(0);
  if (D > 0 && sol != nullptr) {
    const S* __restrict__ row = sol + (int64_t)e * (D + 1);
    for (int i = 0; i < D; ++i) best[i] = row[i];
    best_res = row[D];
  } else if (D > 0) {
    best_res = lcp_solve<V, S>(I, f, best);
  }
  env_back<V, S, true>(I, F, q, f, best, best_res, qn, vn);
  const int count = t.n;
  note_count(status, count, tape != nullptr && count > cap);
  if (tape == nullptr || count > cap) return;
  if (q_out != nullptr) {
    for (int k = 0; k < nq; ++k) q_out[(int64_t)k * B + e] = qn[k].v;
    for (int k = 0; k < nv; ++k) v_out[(int64_t)k * B + e] = vn[k].v;
  }
  if (dq == nullptr) return;
  const Node<S>* __restrict__ nodes = reinterpret_cast<const Node<S>*>(t.nodes);
  S* __restrict__ adj = reinterpret_cast<S*>(t.adj);
  const int64_t Bl = B;
  for (int k = 0; k < nq; ++k)
    if (qn[k].i >= 0) add_adj(adj + qn[k].i * Bl + e, gq[k * Bl + e]);
  for (int k = 0; k < nv; ++k)
    if (vn[k].i >= 0) add_adj(adj + vn[k].i * Bl + e, gv[k * Bl + e]);
  sweep(nodes, adj, count, K, Bl, e);
  for (int k = 0; k < nq; ++k) dq[k * Bl + e] = load_adj(adj + k * Bl + e);
  for (int k = 0; k < nv; ++k) dv[k * Bl + e] = load_adj(adj + (nq + k) * Bl + e);
  for (int k = 0; k < nv; ++k) dtau[k * Bl + e] = load_adj(adj + (nq + nv + k) * Bl + e);
}

#ifdef __CUDACC__
// one block of one warp per env, with env_bytes of dynamic shared memory
// (blocks of several envs timed the same)
template <typename S>
__global__ void __launch_bounds__(WARP) fused_step_kernel(
    const DescI* __restrict__ di, const DescF<S>* __restrict__ df, const S* __restrict__ q,
    const S* __restrict__ v, const S* __restrict__ tau, S* __restrict__ qo, S* __restrict__ vo,
    S* __restrict__ sol, int B, int env_bytes, int front_only) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (env_smem_bytes<S>(di->D, di->nv) > env_bytes) __trap();  // the launcher sized another model
  env_fwd<S>(*di, *df, q, v, tau, qo, vo, sol, B, blockIdx.x, smem, front_only != 0);
}

template <typename S>
__global__ void __launch_bounds__(32) fused_step_vjp_kernel(
    const DescI* __restrict__ di, const DescF<S>* __restrict__ df, const S* __restrict__ q,
    const S* __restrict__ v, const S* __restrict__ tau, const S* __restrict__ sol,
    const S* __restrict__ gq, const S* __restrict__ gv, S* __restrict__ dq, S* __restrict__ dv,
    S* __restrict__ dtau, S* __restrict__ qo, S* __restrict__ vo, unsigned char* tape,
    int* status, int B, int cap, int sol_w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  if (sol != nullptr && sol_w != di->D + 1) __trap();  // rows of another width than D + 1
  env_vjp<S>(*di, *df, q, v, tau, sol, gq, gv, dq, dv, dtau, qo, vo, tape, status, B, cap, e);
}

// the current device's opt-in shared memory per block, in bytes
inline long long smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// Kernel 1's block for a model of D rows and nv dofs: its dynamic shared
// memory in bytes, opted in above the default 48 KB (an error code when the
// card cannot give it).
template <typename S>
static int block_smem(int D, int nv, int* smem) {
  *smem = env_smem_bytes<S>(D, nv);
  if (*smem > smem_limit()) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(fused_step_kernel<S>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return 0;
}

template <typename S>
static int launch(const void* di, const void* df, const void* q, const void* v, const void* tau,
                  void* qo, void* vo, void* sol, int B, int D, int nv, int front_only,
                  void* stream) {
  if (B <= 0) return 0;
  int smem = 0;
  const int err = block_smem<S>(D, nv, &smem);
  if (err) return err;
  fused_step_kernel<S><<<B, WARP, smem, (cudaStream_t)stream>>>(
      (const DescI*)di, (const DescF<S>*)df, (const S*)q, (const S*)v, (const S*)tau, (S*)qo,
      (S*)vo, (S*)sol, B, smem, front_only);
  return (int)cudaGetLastError();
}

// kernel 1's resident warps (blocks) per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename S>
static int occupancy(int D, int nv, int* warps) {
  int smem = 0;
  const int err = block_smem<S>(D, nv, &smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(warps, fused_step_kernel<S>, WARP,
                                                             smem);
}

template <typename S>
static int launch_vjp(const void* di, const void* df, const void* q, const void* v,
                      const void* tau, const void* sol, const void* gq, const void* gv, void* dq,
                      void* dv, void* dtau, void* qo, void* vo, void* tape, void* status, int B,
                      int cap, int sol_w, void* stream) {
  if (B <= 0) return 0;
  fused_step_vjp_kernel<S><<<(B + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const DescI*)di, (const DescF<S>*)df, (const S*)q, (const S*)v, (const S*)tau,
      (const S*)sol, (const S*)gq, (const S*)gv, (S*)dq, (S*)dv, (S*)dtau, (S*)qo, (S*)vo,
      (unsigned char*)tape, (int*)status, B, cap, sol_w);
  return (int)cudaGetLastError();
}
#else
// Host build of the same per-env code, for checking the arithmetic on a
// machine without a GPU (tests/test_torch_fused_step.py): kernel 1's warp
// runs its 32 lanes in turn (lanes()), one env after another, on shared
// memory filled with NaNs (0xff bytes) before each env, so that an element
// no lane wrote poisons the result. D and nv must be the descriptor's.
template <typename S>
static int launch(const void* di, const void* df, const void* q, const void* v, const void* tau,
                  void* qo, void* vo, void* sol, int B, int D, int nv, int front_only, void*) {
  const DescI& I = *(const DescI*)di;
  if (D != I.D || nv != I.nv) return 1;
  std::vector<unsigned char> sh(env_smem_bytes<S>(D, nv));
  for (int e = 0; e < B; ++e) {
    std::fill(sh.begin(), sh.end(), (unsigned char)0xff);
    env_fwd<S>(I, *(const DescF<S>*)df, (const S*)q, (const S*)v, (const S*)tau, (S*)qo, (S*)vo,
               (S*)sol, B, e, sh.data(), front_only != 0);
  }
  return 0;
}

template <typename S>
static int launch_vjp(const void* di, const void* df, const void* q, const void* v,
                      const void* tau, const void* sol, const void* gq, const void* gv, void* dq,
                      void* dv, void* dtau, void* qo, void* vo, void* tape, void* status, int B,
                      int cap, int sol_w, void*) {
  if (sol != nullptr && sol_w != ((const DescI*)di)->D + 1) return 1;
  for (int e = 0; e < B; ++e)
    env_vjp<S>(*(const DescI*)di, *(const DescF<S>*)df, (const S*)q, (const S*)v,
               (const S*)tau, (const S*)sol, (const S*)gq, (const S*)gv, (S*)dq, (S*)dv,
               (S*)dtau, (S*)qo, (S*)vo, (unsigned char*)tape, (int*)status, B, cap, e);
  return 0;
}
#endif

}  // namespace fused

// Built in three parts at once (ops/_build.py reads KERNEL_PARTS and
// compiles part i with -DKERNEL_PART=i): 0, the step kernels and the layout;
// 1, the float32 VJP; 2, the float64 VJP. Without KERNEL_PART (the host
// build), everything.
#define KERNEL_PARTS 3
#if !defined(KERNEL_PART)
#define PART(i) 1
#else
#define PART(i) (KERNEL_PART == (i))
#endif

extern "C" {

#if PART(0)
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
  out[10] = (int)sizeof(fused::Node<float>);
  out[11] = (int)sizeof(fused::Node<double>);
  out[12] = fused::MAX_HULL_VERTS;
}

// (q', v') = step(q, v, tau), one warp per env; D and nv are the
// descriptor's (they size the shared memory). sol may be null; when given
// (B * (D + 1) values) it receives each env's detached LCP solution, `best`
// then `best_res` (nothing when D = 0), for the VJP. front_only != 0: stop
// after the front end and write v* to vo (q' and sol are not written).
// Returns a CUDA error code (0 = launched), the refusal of the shared
// memory included.
int fused_step_f32(const void* di, const void* df, const void* q, const void* v,
                   const void* tau, void* qo, void* vo, void* sol, int B, int D, int nv,
                   int front_only, void* stream) {
  return fused::launch<float>(di, df, q, v, tau, qo, vo, sol, B, D, nv, front_only, stream);
}

int fused_step_f64(const void* di, const void* df, const void* q, const void* v,
                   const void* tau, void* qo, void* vo, void* sol, int B, int D, int nv,
                   int front_only, void* stream) {
  return fused::launch<double>(di, df, q, v, tau, qo, vo, sol, B, D, nv, front_only, stream);
}

// kernel 1's footprint for a model of D rows and nv dofs in values of
// elem_bytes bytes: out = [shared bytes per env (one warp, one block),
// resident warps per SM] (0 in the host build). Returns a CUDA error code.
int fused_step_occupancy(int elem_bytes, int D, int nv, int* out) {
  out[0] = elem_bytes == 4 ? fused::env_smem_bytes<float>(D, nv)
                           : fused::env_smem_bytes<double>(D, nv);
#ifdef __CUDACC__
  return elem_bytes == 4 ? fused::occupancy<float>(D, nv, out + 1)
                         : fused::occupancy<double>(D, nv, out + 1);
#else
  out[1] = 0;
  return 0;
#endif
}
#endif

// (dq, dv, dtau) = (gq, gv) . d(q', v')/d(q, v, tau), one thread per env.
// sol: the step's detached LCP solution as fused_step_f32/f64 wrote it
// (B rows of sol_w = D + 1 values; another width traps on the card and
// returns 1 on the host), or null: the VJP then solves the LCP itself.
// tape: cap * B * (sizeof(Node<S>) + sizeof(S)) bytes of device memory (null:
// count only, nothing else written); status: two zeroed ints, [the largest
// node count of any env, 1 if an env needed more than cap]. qo and vo may be
// null; when given they receive the primal step (q', v'). dq null: record
// the tape only, and write no gradient.
#if PART(1)
int fused_step_vjp_f32(const void* di, const void* df, const void* q, const void* v,
                       const void* tau, const void* sol, const void* gq, const void* gv,
                       void* dq, void* dv, void* dtau, void* qo, void* vo, void* tape,
                       void* status, int B, int cap, int sol_w, void* stream) {
  return fused::launch_vjp<float>(di, df, q, v, tau, sol, gq, gv, dq, dv, dtau, qo, vo, tape,
                                  status, B, cap, sol_w, stream);
}
#endif

#if PART(2)
int fused_step_vjp_f64(const void* di, const void* df, const void* q, const void* v,
                       const void* tau, const void* sol, const void* gq, const void* gv,
                       void* dq, void* dv, void* dtau, void* qo, void* vo, void* tape,
                       void* status, int B, int cap, int sol_w, void* stream) {
  return fused::launch_vjp<double>(di, df, q, v, tau, sol, gq, gv, dq, dv, dtau, qo, vo, tape,
                                   status, B, cap, sol_w, stream);
}
#endif

}  // extern "C"
