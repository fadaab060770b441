// Whole WALNUTS transitions on the card: one launch per draw, or one launch
// per block of draws, with no host work inside a draw.
//
// Replaces the two kernels of walnuts_tpu/ops/fused_transition.py, which
// share one body (_tile_machine, fused_transition.py:182):
// make_fused_transition (fused_transition.py:441, pallas_call at :518) and
// make_fused_sample_block (fused_transition.py:555, pallas_call at :673).
// Per chain, one transition is a state machine over attempts:
//
//   1. integrate steps_total leapfrog micro steps of signed size dt from the
//      cursor, the model's value and gradient inlined (leapfrog.cuh);
//   2. classify the attempt: forward within max_error or not, halve and
//      restart, start or continue the reversibility levels, leaf accepted
//      or failed;
//   3. on an accepted leaf, merge it with the stack's spans (U-turn test and
//      Barker combine per merge), then push it or, when the subtree is
//      complete, combine it into the orbit (Metropolis) and test the
//      orbit's U-turn: deeper, exhausted or done;
//   4. set the next attempt's direction, step, step count and start.
//
// Decisions draw from a counter hash (murmur3 finalizer of seed, chain
// index and counter), bit for bit the reference's; the counter advances
// max_depth + 2 per attempt whether or not a merge happens. Momenta come
// from outside. The sample-block entry point runs num_draws transitions of
// every chain in one launch, reads draw i's momenta from rho[i], writes
// draws[i] and logps[i], and does not count a draw's first evaluation
// (carried over from the draw before) in n_grads.
//
// What bounds it on the H100: operations. A transition reads and writes a
// few rows of D values a chain, and evaluates the model ~10 times and more.
// A launch ends with its slowest chain, and chains differ by 10x in their
// evaluations: in a sample block of 100 logistic-regression draws the
// largest per-chain count is ~3.8x the mean, and that chain alone, one
// warp among 16 on a busy SM, ran ~43 ms against the ~29 ms the whole
// block's work took the card.
//
// Design. On the TPU a tile of chains steps the machine in lock step: every
// attempt integrates to the tile's largest step count under masks, every
// merge level is computed on every lane and selected, and the tile loops
// until its slowest chain is done. Here a warp runs one chain's own
// `while (!done)`: it integrates the chain's own step count, merges only
// the levels this leaf merges (the stack slot is an index), and hashes only
// the uniforms it uses. The scalars of the machine (joints, weights,
// counters, flags) are warp-uniform registers.
//
// - A persistent grid fed by a counter: as many blocks as the card holds
//   at once (no more than the chains need), each warp, or group of warps,
//   taking its next chain from `sched` (an int32 counter that is 0 at
//   launch, then the chain indices in the order they are taken) until none
//   is left. The wrapper orders the chains most expensive first by the
//   evaluations the launches before measured for them, so the long chains
//   start at once and the chains that end last are short ones; 8 warps a
//   block keep a long chain's share of its SM's issue slots up. A chain's
//   result depends on nothing but its own inputs, not on the warp that
//   runs it or the order.
// - Each chain runner (a warp, or a group's leader) has its own span
//   workspace in device memory that the wrapper allocates, (8 max_depth +
//   22) rows of D floats: the orbit (8 rows: theta, rho, grad at the
//   backward and at the forward end, the selected theta and grad), the leaf
//   being merged (8), the macro step's start (3), the forward attempt's end
//   (3) and max_depth stack slots (8 each), then the slots' four scalars
//   (once a warp, not a copy in every lane's local memory). At the sizes
//   timed it stays in the 50 MB L2 (1056 runners x 6.3 KB at D = 25,
//   max_depth 5); in shared memory beside X it timed alike on the card.
//   Only the cursor (theta, rho, grad) and inv_mass stay in registers.
// - The row helpers stride the features over the lanes, whatever layout the
//   cursor has, and every helper that writes rows ends with __syncwarp(),
//   so any lane may read any element afterwards.
// - Standard normal, funnel, ill-conditioned normal (models.cuh): blocks of
//   8 warps, a warp a chain; the cursor is strided over the lanes (4
//   registers a lane for D <= 128, 32 for D <= 1024).
// - Logistic regression (logreg_chain.cuh): one block of 8 warps per SM
//   stages X once (at the width P rounded up to 4), lane k of a warp holding
//   feature k of the cursor. A chain is run by a group of G warps (G = 1, 2
//   or 4, the wrapper's choice): its leader runs the chain's control (tree,
//   halvings, U-turns) and takes the chains from the counter; at each
//   evaluation its helpers sum their share of the rows, meet it at the
//   group's named barrier (bar.sync) and wait there for the next one. So
//   the chain that ends a launch takes about 1 / G of a warp's time per
//   evaluation, while the control is run once. The leader adds the
//   partial sums in rank order: a launch repeats bit for bit.
//
// Limits, checked by the wrapper (ValueError): float32 only, D <= 1024
// (logistic regression: D <= 32, N <= 1024 rows), max_depth <= 16.
//
// Built with -fmad=false: the leapfrog, the simple bodies, the kinetic
// energy, the U-turn's dot products and the log-sum-exp round every product
// and sum as the plain PyTorch version does. logf, log1pf and expf may
// still differ from PyTorch's by an ulp, which can flip a decision on a
// rare chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "leapfrog.cuh"

namespace {

constexpr int WARPS = 8;       // warps per block of the simple bodies' kernel
constexpr int MAX_DEPTH = 16;  // the deepest tree the entry points take
constexpr int LOGREG_WARPS = 8;  // warps per block of the logistic-regression kernel

// The operands of both entry points: every pointer, then the sizes, then
// the float scalars. Mirrors ops/fused_transition.py::TransitionArgs field
// by field (the wrapper compares sizeof).
struct TransitionArgs {
  const float *theta, *rho, *logp0, *grad0, *step, *inv_mass;  // inputs
  const int* min_micro;
  const void *c0, *c1;  // the body's constants
  float* work;          // (runners, 8 max_depth + 22, D): a workspace per runner
  int* sched;           // (C + 1): the counter, 0 at launch, then chain indices
  long long* trace;     // (C, 3) or null: per chain its start and end (ns), SM
  float *draws, *logps;  // (N, C, D), (N, C); null for a single transition
  float *theta_out, *grad_out, *logp_out;
  int *depth_out, *ngrads_out;  // depth_out null for a sample block
  int chains, dim, num_draws, body, max_depth, max_step_halvings, n_data, seed;
  int skip_first_grad;  // 1: n_grads leaves out each draw's first evaluation
  int sms;              // SMs of the card
  int group;            // logistic regression: warps a chain (1, 2 or 4)
  float max_error, p0, p1;
};

// rows of the workspace, in units of D floats; the stack's scalars follow
// its rows
constexpr int ACC = 0, LEAF = 8, MS = 16, FWD = 19, STACK = 22;
// rows of a span
constexpr int TB = 0, RB = 1, TF = 3, RF = 4, TS = 6, GS = 7;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The chain's decision stream: uniform (0, 1] from (seed, chain, counter).
struct Rng {
  uint32_t base;  // hash(seed ^ 0x9E3779B9) ^ hash(chain)
  __device__ __forceinline__ float uniform(uint32_t ctr) const {
    const uint32_t bits = hash32(base ^ (ctr * 0x27D4EB2Fu));
    return __uint2float_rn(bits >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  }
};

// The four scalars of a span: joint log density at the backward and the
// forward end, log density of the selected point, log weight.
struct SpanScalars {
  float lb, lf, ls, lw;
};

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b), mn = fminf(a, b);
  const float safe = m + log1pf(expf(mn - m));
  return isinf(m) ? m : safe;
}

// n contiguous floats, features strided over the lanes.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n,
                                          int lane) {
  for (int j = lane; j < n; j += 32) dst[j] = src[j];
  __syncwarp();
}

// A span of one point: rows {0, 3, 6} theta, {1, 4} rho, {2, 5, 7} grad,
// from three rows theta, rho, grad.
__device__ __forceinline__ void point_span(float* span, const float* theta,
                                           const float* rho, const float* grad,
                                           int D, int lane) {
  for (int j = lane; j < D; j += 32) {
    const float t = theta[j], r = rho[j], g = grad[j];
    span[j] = t;
    span[D + j] = r;
    span[2 * D + j] = g;
    span[3 * D + j] = t;
    span[4 * D + j] = r;
    span[5 * D + j] = g;
    span[6 * D + j] = t;
    span[7 * D + j] = g;
  }
  __syncwarp();
}

// Has the joined span (older then newer in time when fwd, else the other
// way round) turned back on itself?
__device__ __forceinline__ bool uturn(const float* older, const float* newer,
                                      bool fwd, const float* inv_mass, int D,
                                      int lane) {
  const float* bk = fwd ? older : newer;
  const float* fw = fwd ? newer : older;
  float lo = 0.f, hi = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float delta = inv_mass[j] * (fw[TF * D + j] - bk[TB * D + j]);
    lo += bk[RB * D + j] * delta;
    hi += fw[RF * D + j] * delta;
  }
  lo = wt::warp_sum(lo);
  hi = wt::warp_sum(hi);
  return (hi < 0.f) | (lo < 0.f);
}

// Merge the spans old and new into `res`, which holds one of them
// (res_is_new says which; `other` holds the other): the backward rows of
// the one that is earlier in time, the forward rows of the later one, the
// selection of new with probability w_new / (w_old + w_new) (Barker) or
// min(1, w_new / w_old) (Metropolis).
__device__ __forceinline__ SpanScalars combine(
    float u, float* res, const float* other, bool res_is_new,
    const SpanScalars& old_s, const SpanScalars& new_s, bool fwd, bool barker,
    int D, int lane) {
  const float logw = lse(old_s.lw, new_s.lw);
  const float denom = barker ? logw : old_s.lw;
  const bool take_new = logf(u) < (new_s.lw - denom);
  // backward rows come from old when fwd, forward rows from new when fwd
  if (fwd == res_is_new) copy_rows(res, other, 3 * D, lane);
  if (fwd != res_is_new) copy_rows(res + 3 * D, other + 3 * D, 3 * D, lane);
  if (take_new != res_is_new) copy_rows(res + 6 * D, other + 6 * D, 2 * D, lane);
  return SpanScalars{fwd ? old_s.lb : new_s.lb, fwd ? new_s.lf : old_s.lf,
                     take_new ? new_s.ls : old_s.ls, logw};
}

// The cursor of the simple bodies: features strided over the lanes.
template <int NR, template <typename, int> class Model>
struct StridedCursor {
  float th[NR], rh[NR], gr[NR], im[NR];
  Model<float, NR> model;
  int D, lane;

  __device__ __forceinline__ void init(const wt::ModelParams<float>& params,
                                       const float* inv_mass, int D_,
                                       int lane_) {
    D = D_;
    lane = lane_;
    model.init(params, D, lane);
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int j = lane + 32 * k;
      im[k] = j < D ? inv_mass[j] : 0.f;
    }
  }
  // rows: theta, rho, grad; the momentum times rho_sign (1 or -1)
  __device__ __forceinline__ void load(const float* rows, float rho_sign) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int j = lane + 32 * k;
      const bool in = j < D;
      th[k] = in ? rows[j] : 0.f;
      rh[k] = in ? rows[D + j] * rho_sign : 0.f;
      gr[k] = in ? rows[2 * D + j] : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* rows) const {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int j = lane + 32 * k;
      if (j < D) {
        rows[j] = th[k];
        rows[D + j] = rh[k];
        rows[2 * D + j] = gr[k];
      }
    }
    __syncwarp();
  }
  __device__ __forceinline__ float kinetic() const {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NR; ++k) ss += (im[k] * rh[k]) * rh[k];
    return -0.5f * wt::warp_sum(ss);
  }
  __device__ __forceinline__ float integrate(float h, int n) {
    return wt::leapfrog_strided(th, rh, gr, im, model, h, n, lane);
  }
};

// The cursor of the logistic-regression body: lane k holds feature k (0 at
// k >= P); the evaluation is shared by the warps of a group
// (logreg_eval_group).
template <int KP>
struct LogregCursor {
  float th, rh, gr, im;
  wt::LogregGroup ev;
  int P, lane;

  __device__ __forceinline__ void init(const float* inv_mass, int P_,
                                       int lane_) {
    P = P_;
    lane = lane_;
    im = lane < P ? inv_mass[lane] : 0.f;
  }
  __device__ __forceinline__ void load(const float* rows, float rho_sign) {
    const bool in = lane < P;
    th = in ? rows[lane] : 0.f;
    rh = in ? rows[P + lane] * rho_sign : 0.f;
    gr = in ? rows[2 * P + lane] : 0.f;
  }
  __device__ __forceinline__ void store(float* rows) const {
    if (lane < P) {
      rows[lane] = th;
      rows[P + lane] = rh;
      rows[2 * P + lane] = gr;
    }
    __syncwarp();
  }
  __device__ __forceinline__ float kinetic() const {
    return -0.5f * wt::warp_sum((im * rh) * rh);
  }
  __device__ __forceinline__ float integrate(float h, int n) {
    return wt::leapfrog_logreg_group<KP>(th, rh, gr, im, ev, h, n, lane);
  }
};

struct Outcome {
  float lp;     // log density of the selected point
  int depth;    // the reference's out_depth
  int n_grads;  // model evaluations, the start point's counted as one
};

// One transition of one chain from (theta0, rho0, grad0, lp0); the selected
// point ends in the orbit's rows TS and GS of `work`. theta0 and grad0 may
// be those very rows (the draw before).
template <class Cursor>
__device__ __forceinline__ Outcome transition(Cursor& cur, float* work, const float* theta0,
                              const float* rho0, const float* grad0, float lp0,
                              float step, int min_micro, float max_error,
                              int MD, int max_halvings, const Rng& rng,
                              uint32_t ctr, const float* inv_mass, int D,
                              int lane) {
  float* acc = work + ACC * D;
  float* leaf = work + LEAF * D;
  float* ms = work + MS * D;
  float* fwd = work + FWD * D;
  // the scalars of the stack's spans, once a warp (not a copy a lane)
  SpanScalars* stack_s = reinterpret_cast<SpanScalars*>(work + (STACK + 8 * MD) * D);

  // theta0 and grad0 are read and the orbit's rows written feature by
  // feature in the same lane, so the aliasing is safe
  for (int j = lane; j < D; j += 32) {
    ms[j] = theta0[j];
    ms[D + j] = rho0[j];
    ms[2 * D + j] = grad0[j];
  }
  __syncwarp();
  point_span(acc, ms, ms + D, ms + 2 * D, D, lane);
  cur.load(ms, 1.f);
  const float joint0 = lp0 + cur.kinetic();
  SpanScalars acc_s{joint0, joint0, lp0, joint0};
  bool fwd_dir = rng.uniform(ctr++) < 0.5f;
  float dt = fwd_dir ? step : -step;
  float ms_joint = joint0, fwd_lp = lp0, fwd_joint = joint0;
  int depth = 1, out_depth = MD + 1, leaf_idx = 0, n_leaves = 1;
  int halvings = 0, steps_total = min_micro, n_grads = 1;
  bool in_fwd = true;

  for (;;) {
    const float lp_n = cur.integrate(dt, steps_total);
    n_grads += steps_total;
    const float joint_n = lp_n + cur.kinetic();

    // classify the attempt
    // (neither accepted, failed nor restarted: a reversibility level is next)
    bool leaf_ok = false, leaf_fail = false, restart = false;
    if (in_fwd) {
      if (fabsf(ms_joint - joint_n) <= max_error) {
        cur.store(fwd);
        fwd_lp = lp_n;
        fwd_joint = joint_n;
        leaf_ok = steps_total < 2 * min_micro;
      } else if (halvings + 1 < max_halvings) {
        restart = true;
      } else {
        leaf_fail = true;
      }
    } else {
      if (fabsf(joint_n - fwd_joint) <= max_error) {
        leaf_fail = true;  // the coarser step also holds: not reversible
      } else {
        leaf_ok = steps_total < 2 * min_micro;
      }
    }

    // this attempt's uniforms sit at fixed offsets from its counter
    const uint32_t ctr_merge = ctr, ctr_top = ctr + MD, ctr_dir = ctr + MD + 1;
    ctr += MD + 2;

    // the merge cascade
    SpanScalars leaf_s{fwd_joint, fwd_joint, fwd_lp, fwd_joint};
    int n_merges = 0;
    if (leaf_ok) {
      point_span(leaf, fwd, fwd + D, fwd + 2 * D, D, lane);
      n_merges = min(__ffs(leaf_idx + 1) - 1, MD);
      for (int i = 0; i < n_merges; ++i) {
        const float* top = work + (STACK + 8 * i) * D;
        if (uturn(top, leaf, fwd_dir, inv_mass, D, lane)) {
          leaf_ok = false;  // a sub-span turned back: the transition ends
          leaf_fail = true;
          break;
        }
        leaf_s = combine(rng.uniform(ctr_merge + i), leaf, top, true,
                         stack_s[i], leaf_s, fwd_dir, true, D, lane);
      }
    }
    const bool subtree_done = leaf_ok && leaf_idx + 1 >= n_leaves;
    const bool push = leaf_ok && !subtree_done;
    if (push) {
      if (lane == 0) stack_s[n_merges] = leaf_s;
      copy_rows(work + (STACK + 8 * n_merges) * D, leaf, 8 * D, lane);
    }

    // the orbit: Metropolis combine and U-turn
    bool deeper = false, finished = leaf_fail;
    if (subtree_done) {
      const bool ut_top = uturn(acc, leaf, fwd_dir, inv_mass, D, lane);
      acc_s = combine(rng.uniform(ctr_top), acc, leaf, false, acc_s, leaf_s,
                      fwd_dir, false, D, lane);
      if (ut_top) {
        finished = true;
      } else if (depth + 1 <= MD) {
        deeper = true;
      } else {
        finished = true;
        depth = MD + 1;  // exhausted
      }
    }
    if (finished) {
      out_depth = depth;
      break;
    }

    // the next attempt
    if (deeper) {
      fwd_dir = rng.uniform(ctr_dir) < 0.5f;
      depth += 1;
      n_leaves = 1 << (depth - 1);
      leaf_idx = 0;
      copy_rows(ms, acc + (fwd_dir ? 3 : 0) * D, 3 * D, lane);
      ms_joint = fwd_dir ? acc_s.lf : acc_s.lb;
    } else if (push) {
      leaf_idx += 1;
      copy_rows(ms, fwd, 3 * D, lane);
      ms_joint = fwd_joint;
    }
    if (deeper || push) {  // a new macro step
      halvings = 0;
      in_fwd = true;
      steps_total = min_micro;
      dt = fwd_dir ? step : -step;
      cur.load(ms, 1.f);
    } else if (restart) {
      halvings += 1;
      in_fwd = true;
      steps_total *= 2;
      dt *= 0.5f;
      cur.load(ms, 1.f);
    } else {  // a reversibility level: back from the forward end, step doubled
      in_fwd = false;
      steps_total /= 2;
      dt *= 2.0f;
      cur.load(fwd, -1.f);
    }
  }
  return Outcome{acc_s.ls, out_depth, n_grads};
}

// The card's clock in nanoseconds, and the SM a thread runs on.
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// All num_draws transitions of chain c, in the warp's workspace `work`.
template <class Cursor>
__device__ __forceinline__ void run_chain(const TransitionArgs& a, Cursor& cur,
                                          int c, float* work, int lane) {
  const int D = a.dim, C = a.chains;
  const size_t row = static_cast<size_t>(c) * D;
  const float* inv_mass = a.inv_mass + row;
  const Rng rng{hash32(static_cast<uint32_t>(a.seed) ^ 0x9E3779B9u) ^
                hash32(static_cast<uint32_t>(c))};
  const float step = a.step[c];
  const int min_micro = a.min_micro[c];
  const float* theta0 = a.theta + row;
  const float* grad0 = a.grad0 + row;
  float lp = a.logp0[c];
  int n_grads = 0, depth = 0;
  if (a.trace != nullptr && lane == 0) {
    a.trace[3 * c] = global_ns();
    a.trace[3 * c + 2] = sm_id();
  }
  for (int i = 0; i < a.num_draws; ++i) {
    const size_t at = static_cast<size_t>(i) * C + c;
    // decision streams of successive draws start a large odd stride apart
    const uint32_t ctr0 = 1u + 0x9E3779B1u * static_cast<uint32_t>(i);
    const Outcome o = transition(cur, work, theta0, a.rho + at * D, grad0, lp,
                                 step, min_micro, a.max_error, a.max_depth,
                                 a.max_step_halvings, rng, ctr0, inv_mass, D,
                                 lane);
    lp = o.lp;
    depth = o.depth;
    n_grads += o.n_grads - a.skip_first_grad;
    theta0 = work + (ACC + TS) * D;
    grad0 = work + (ACC + GS) * D;
    if (a.draws != nullptr) {
      copy_rows(a.draws + at * D, theta0, D, lane);
      if (lane == 0) a.logps[at] = lp;
    }
  }
  copy_rows(a.theta_out + row, theta0, D, lane);
  copy_rows(a.grad_out + row, grad0, D, lane);
  if (lane == 0) {
    a.logp_out[c] = lp;
    a.ngrads_out[c] = n_grads;
    if (a.depth_out != nullptr) a.depth_out[c] = depth;
    if (a.trace != nullptr) a.trace[3 * c + 1] = global_ns();
  }
}

// The next chain for a warp, -1 when none is left: lane 0 takes the next
// index from the counter sched[0].
__device__ __forceinline__ int next_chain(int* sched, int C, int lane) {
  int i = 0;
  if (lane == 0) i = atomicAdd(sched, 1);
  i = __shfl_sync(0xffffffffu, i, 0);
  return i < C ? sched[1 + i] : -1;
}

// Floats of a runner's span workspace: (8 max_depth + 22) rows of D
// floats, then the 4 scalars of each of the max_depth stack slots.
__host__ __device__ __forceinline__ size_t work_floats(int max_depth, int D) {
  return static_cast<size_t>(STACK + 8 * max_depth) * D + 4 * max_depth;
}

// The span workspace of the block's `runner`th chain runner, of `runners`
// a block.
__device__ __forceinline__ float* runner_work(const TransitionArgs& a,
                                              int runner, int runners) {
  const size_t at = static_cast<size_t>(blockIdx.x) * runners + runner;
  return a.work + at * work_floats(a.max_depth, a.dim);
}

template <int NR, template <typename, int> class Model>
__global__ void __launch_bounds__(WARPS * 32)
    transition_kernel(TransitionArgs a) {
  const int lane = threadIdx.x & 31;
  float* work = runner_work(a, threadIdx.x >> 5, WARPS);
  const wt::ModelParams<float> params{static_cast<const float*>(a.c0), a.p0,
                                      a.p1};
  for (;;) {
    const int c = next_chain(a.sched, a.chains, lane);
    if (c < 0) break;  // warp-uniform; no block-wide sync follows
    StridedCursor<NR, Model> cur;
    cur.init(params, a.inv_mass + static_cast<size_t>(c) * a.dim, a.dim, lane);
    run_chain(a, cur, c, work, lane);
  }
}

// Shared memory of the logistic-regression kernel, in floats: X (N rows at
// the padded width), y (N rounded up to 4), then per group (at most W) its
// exchange (LOGREG_PART a warp: W LOGREG_PART in all, rounded up to 4), its
// coefficient slot (KP) and its command word (rounded up to 4).
template <int KP, int W>
struct LogregSmem {
  static constexpr int PART = (W * wt::LOGREG_PART + 3) / 4 * 4;
  int ys, part, coef, command, total;
  __host__ __device__ explicit LogregSmem(int N)
      : ys(N * wt::logreg_stride(KP)),
        part(ys + (N + 3) / 4 * 4),
        coef(part + PART),
        command(coef + W * KP),
        total(command + (W + 3) / 4 * 4) {}
};

// Groups of G warps: the leader (rank 0) runs a chain, the helpers share
// its evaluations.
template <int KP, int W>
__global__ void __launch_bounds__(W * 32, 1)
    transition_logreg_kernel(TransitionArgs a) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const LogregSmem<KP, W> at(a.n_data);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = a.group, grp = warp / G, rank = warp % G;
  wt::logreg_stage<KP>(static_cast<const float*>(a.c0),
                       static_cast<const float*>(a.c1), sm, sm + at.ys,
                       a.n_data, a.dim);
  __syncthreads();
  const wt::LogregGroup ev{sm,
                           sm + at.ys,
                           sm + at.coef + grp * KP,
                           sm + at.part + grp * G * wt::LOGREG_PART,
                           reinterpret_cast<int*>(sm + at.command) + grp,
                           a.n_data,
                           G,
                           rank,
                           1 + grp};
  if (rank > 0) {
    wt::logreg_help<KP>(ev, lane);
    return;
  }
  float* work = runner_work(a, grp, W / G);
  LogregCursor<KP> cur;
  cur.ev = ev;
  for (;;) {
    const int c = next_chain(a.sched, a.chains, lane);
    if (c < 0) break;  // warp-uniform; no block-wide sync follows
    cur.init(a.inv_mass + static_cast<size_t>(c) * a.dim, a.dim, lane);
    run_chain(a, cur, c, work, lane);
  }
  wt::logreg_release(ev, lane);
}

// How a launch covers the card: `blocks` blocks of `warps` warps, as many
// as the card holds at once and no more than the chains need, `runners`
// of them a block running chains, each with its span workspace.
struct Plan {
  const void* kernel;
  int blocks, warps, runners;
  size_t smem;
};

template <class Kernel>
cudaError_t plan_for(Kernel kernel, int warps, int runners, size_t smem,
                     const TransitionArgs& a, Plan* p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        warps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (a.chains + runners - 1) / runners;
  *p = Plan{reinterpret_cast<const void*>(kernel), min(per_sm * a.sms, need),
            warps, runners, smem};
  return cudaSuccess;
}

template <int KP, int W = LOGREG_WARPS>
cudaError_t plan_logreg(const TransitionArgs& a, Plan* p) {
  const int G = a.group;
  // a named barrier per group: ids 1..15
  if (!(G == 1 || G == 2 || G == 4) || W % G != 0 || (G > 1 && W / G > 15))
    return cudaErrorInvalidValue;
  const size_t smem = LogregSmem<KP, W>(a.n_data).total * sizeof(float);
  return plan_for(transition_logreg_kernel<KP, W>, W, W / G, smem, a, p);
}

template <template <typename, int> class Model>
cudaError_t plan_simple(const TransitionArgs& a, Plan* p) {
  if (a.group != 1) return cudaErrorInvalidValue;
  if (a.dim <= 128)
    return plan_for(transition_kernel<4, Model>, WARPS, WARPS, 0, a, p);
  return plan_for(transition_kernel<32, Model>, WARPS, WARPS, 0, a, p);
}

cudaError_t plan(const TransitionArgs& a, Plan* p) {
  if (a.chains <= 0 || a.dim <= 0 || a.dim > 1024 || a.num_draws <= 0 ||
      a.max_depth <= 0 || a.max_depth > MAX_DEPTH || a.max_step_halvings <= 0 ||
      a.sms <= 0)
    return cudaErrorInvalidValue;
  switch (a.body) {
    case wt::BODY_STD_NORMAL:
      return plan_simple<wt::StdNormal>(a, p);
    case wt::BODY_FUNNEL:
      return plan_simple<wt::Funnel>(a, p);
    case wt::BODY_ILL_NORMAL:
      if (a.c0 == nullptr) return cudaErrorInvalidValue;
      return plan_simple<wt::IllNormal>(a, p);
    case wt::BODY_LOGREG:
      if (a.dim > wt::LOGREG_MAX_FEATURES || a.n_data <= 0 ||
          a.n_data > wt::LOGREG_MAX_ROWS || a.c0 == nullptr || a.c1 == nullptr)
        return cudaErrorInvalidValue;
      return wt::logreg_by_width(a.dim, [&](auto width) {
        return plan_logreg<decltype(width)::value>(a, p);
      });
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_plan(const TransitionArgs& a, const Plan& p,
                        cudaStream_t stream) {
  if (a.work == nullptr || a.sched == nullptr) return cudaErrorInvalidValue;
  void* params[] = {const_cast<TransitionArgs*>(&a)};
  cudaError_t err = cudaLaunchKernel(p.kernel, dim3(p.blocks), dim3(p.warps * 32),
                                     params, p.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch(const TransitionArgs& a, cudaStream_t stream) {
  Plan p;
  const cudaError_t err = plan(a, &p);
  return err != cudaSuccess ? err : launch_plan(a, p, stream);
}

}  // namespace

extern "C" int wt_transition_args_size() {
  return static_cast<int>(sizeof(TransitionArgs));
}

// The floats of device memory a launch with these operands needs for its
// runners' span workspaces (work and sched may be null here).
extern "C" int wt_transition_workspace(const void* args, long long* floats) {
  const TransitionArgs& a = *static_cast<const TransitionArgs*>(args);
  Plan p;
  const cudaError_t err = plan(a, &p);
  if (err == cudaSuccess)
    *floats = static_cast<long long>(p.blocks) * p.runners *
              work_floats(a.max_depth, a.dim);
  return static_cast<int>(err);
}

// One transition of every chain: num_draws must be 1, draws and logps null;
// n_grads counts the start point's evaluation.
extern "C" int wt_fused_transition(const void* args, void* stream) {
  const TransitionArgs& a = *static_cast<const TransitionArgs*>(args);
  if (a.num_draws != 1 || a.draws != nullptr || a.skip_first_grad != 0 ||
      a.depth_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

// num_draws transitions of every chain, rho (N, C, D) read and draws
// (N, C, D), logps (N, C) written per draw; n_grads leaves out each draw's
// first evaluation.
extern "C" int wt_fused_sample_block(const void* args, void* stream) {
  const TransitionArgs& a = *static_cast<const TransitionArgs*>(args);
  if (a.draws == nullptr || a.logps == nullptr || a.skip_first_grad != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}
