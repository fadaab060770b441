// The logistic-regression model on the card: the staged design matrix, the
// per-row term, and one chain's log density and gradient by one warp.
//
// Shared by logreg.cu (the staging layout and the per-row term), and by
// integrator.cu and fused_transition.cu through leapfrog.cuh (one chain's
// evaluation per leapfrog step, inside the attempt loop).
//
// Layout. The features are zero-padded to a width KP, P rounded up to 4 (a
// template parameter: 4, 8, ..., 32), and a row of X sits in shared memory
// at a stride of 4 m words with m odd (logreg_stride), so a lane reads its
// row with KP / 4 16-byte loads and the 8 lanes of a quarter-warp, reading 8
// consecutive rows, land on 8 different groups of 4 banks: no conflicts.
//
// One chain, one warp (logreg_eval). Lanes stride over the rows; a lane
// keeps its row in registers between the logit and the gradient FMAs, so
// each row is read once per evaluation. Every lane holds the chain's KP
// coefficients; the gradient partials are summed over the warp by a
// reduce-scatter that leaves lane k with feature k. All products are
// explicit IEEE fp32 FMAs: no tensor cores, no TF32, and no dependence on
// the compiler's contraction flag.
//
// One chain, a group of G warps (the whole-transition kernels): the group's
// first warp, its leader, runs the chain; at each evaluation it posts the
// coefficients, and warp `rank` of the group (the leader is rank 0) sums
// rows rank * 32 + lane, stepping 32 G, so one evaluation takes about 1 / G
// of a warp's time (logreg_eval_group). The other warps, its helpers, do
// nothing else (logreg_help): between evaluations they wait at the group's
// barrier and take no issue slots from the SM. The leader adds the warps'
// partial sums in rank order, so a chain's result depends on G only
// through that order. Each warp reads the coefficients from the group's
// slot in shared memory into registers once an evaluation.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "models.cuh"

namespace wt {

constexpr int LOGREG_MAX_FEATURES = 32;  // P <= 32
constexpr int LOGREG_MAX_ROWS = 1024;    // rows the per-chain kernels stage whole

// Row stride in shared memory at padded width kp: 4 m words, m odd.
__host__ __device__ constexpr int logreg_stride(int kp) {
  return (kp / 4) % 2 ? kp : kp + 4;
}

// Shared memory of the per-chain kernels: `rows` rows of X, then y.
__host__ __device__ constexpr size_t logreg_smem_bytes(int kp, int rows) {
  return static_cast<size_t>(rows) * (logreg_stride(kp) + 1) * sizeof(float);
}

// Calls f(std::integral_constant<int, KP>) with KP = P rounded up to 4;
// cudaErrorInvalidValue outside 1 <= P <= 32.
template <class F>
cudaError_t logreg_by_width(int P, F&& f) {
  switch ((P + 3) / 4) {
    case 1: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 8>{});
    case 3: return f(std::integral_constant<int, 12>{});
    case 4: return f(std::integral_constant<int, 16>{});
    case 5: return f(std::integral_constant<int, 20>{});
    case 6: return f(std::integral_constant<int, 24>{});
    case 7: return f(std::integral_constant<int, 28>{});
    case 8: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

// Stage rows [0, rows) of x (N, P) and y into shared memory, features
// zero-padded to KP. Every thread of the block calls it; the caller
// synchronizes after it.
template <int KP>
__device__ __forceinline__ void logreg_stage(const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             float* xs, float* ys, int rows,
                                             int P) {
  constexpr int XS = logreg_stride(KP);
  for (int i = threadIdx.x; i < rows * KP; i += blockDim.x) {
    const int r = i / KP, k = i % KP;
    xs[r * XS + k] = k < P ? x[static_cast<size_t>(r) * P + k] : 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) ys[i] = y[i];
}

// A row's KP staged values, by 16-byte loads.
template <int KP>
__device__ __forceinline__ void logreg_row(const float* xr, float (&xv)[KP]) {
#pragma unroll
  for (int q = 0; q < KP / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(xr)[q];
    xv[4 * q] = v.x;
    xv[4 * q + 1] = v.y;
    xv[4 * q + 2] = v.z;
    xv[4 * q + 3] = v.w;
  }
}

// theta . x_r, in 4 independent FMA chains.
template <int KP>
__device__ __forceinline__ float logreg_logit(const float (&th)[KP],
                                              const float (&xv)[KP]) {
  float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
#pragma unroll
  for (int k = 0; k < KP; k += 4) {
    l0 = fmaf(th[k], xv[k], l0);
    l1 = fmaf(th[k + 1], xv[k + 1], l1);
    l2 = fmaf(th[k + 2], xv[k + 2], l2);
    l3 = fmaf(th[k + 3], xv[k + 3], l3);
  }
  return (l0 + l1) + (l2 + l3);
}

// One row's term from its logit l and label yr: lacc += log sigmoid(z) and
// the return value is y sigmoid(-z), z = yr l, in the overflow-free forms
// log sigmoid(z) = -(max(0, -z) + log1p(exp(-|z|))) and sigmoid(-z) =
// e / (1 + e) or 1 / (1 + e) with e = exp(-|z|) (one IEEE division of the
// selected numerator).
__device__ __forceinline__ float logreg_term(float l, float yr, float& lacc) {
  const float z = yr * l;
  const float e = expf(-fabsf(z));
  lacc -= fmaxf(-z, 0.f) + log1pf(e);
  const float sig_neg = (z >= 0.f ? e : 1.f) / (1.f + e);
  return yr * sig_neg;
}

// The smallest power of two >= kp.
__host__ __device__ constexpr int logreg_pow2(int kp) {
  return kp <= 4 ? 4 : kp <= 8 ? 8 : kp <= 16 ? 16 : 32;
}

// Sum v over the warp and leave lane l with entry l mod W: butterfly sums
// over the lane bits >= log2 W, then recursive halving over the others
// (at each step a lane keeps the half its lane bit names and adds its
// partner's copy of that half). W - 1 + W log2(32 / W) shuffles, not
// 5 W; every sum in a fixed order.
template <int W>
__device__ __forceinline__ float reduce_scatter(float (&v)[W], int lane) {
#pragma unroll
  for (int off = 16; off >= W; off >>= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
#pragma unroll
  for (int half = W / 2; half >= 1; half >>= 1) {
    const bool upper = (lane & half) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? v[j] : v[j + half];
      const float keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return v[0];
}

// acc += s x, over the KP features.
template <int KP, int W>
__device__ __forceinline__ void logreg_axpy(float s, const float (&xv)[KP],
                                            float (&acc)[W]) {
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = fmaf(s, xv[k], acc[k]);
}

// One chain's evaluation by one warp at th (the chain's KP coefficients,
// the same in every lane; th_own = th[lane], 0 at lane >= KP). Returns the
// log density in every lane (bitwise the same) and sets g_own to feature
// `lane` of the gradient (0 at lane >= KP). xs, ys: N rows staged by
// logreg_stage<KP>; lane l takes rows l, l + 32, ...
template <int KP>
__device__ __forceinline__ float logreg_eval(const float (&th)[KP],
                                             float th_own, const float* xs,
                                             const float* ys, int N, int lane,
                                             float& g_own) {
  constexpr int XS = logreg_stride(KP);
  constexpr int W = logreg_pow2(KP);
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
  float lacc = 0.f;
  for (int r = lane; r < N; r += 32) {
    float xv[KP];
    logreg_row<KP>(xs + r * XS, xv);
    const float s = logreg_term(logreg_logit<KP>(th, xv), ys[r], lacc);
    logreg_axpy<KP, W>(s, xv, acc);
  }
  lacc = warp_sum(lacc);
  const float g = reduce_scatter<W>(acc, lane);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) sq = fmaf(th[k], th[k], sq);
  g_own = lane < KP ? g - th_own : 0.f;
  return fmaf(-0.5f, sq, lacc);
}

// Barrier `id` (1..15; 0 is __syncthreads's) over the `threads` threads of
// a group of warps.
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// floats of a warp's partial sums in a group's exchange: 32 gradient
// features, then the log-likelihood
constexpr int LOGREG_PART = 33;

// What the leader posts to its helpers before each barrier.
enum LogregCommand { LOGREG_EVAL = 0, LOGREG_EXIT = 1 };

// Where one warp of a group evaluates: the staged rows, the group's
// coefficient slot (KP floats, 16-byte aligned, written by the leader),
// its exchange (G x LOGREG_PART floats), its command word, and the warp's
// place in the group. At each evaluation the group passes the barrier
// twice: after the leader has posted (helpers read the slot and the
// command), and after every warp has written its partial sums (the leader
// reads them before it posts again).
struct LogregGroup {
  const float *xs, *ys;
  float *coef, *part;
  int* command;
  int N, G, rank, bar;
};

// This warp's share of an evaluation at the coefficients in e.coef: its
// rows' gradient partial, feature `lane` (reduce-scattered over the warp),
// and its rows' log-likelihood (in every lane).
template <int KP>
__device__ __forceinline__ float logreg_partial(const LogregGroup& e, int lane,
                                                float& lacc) {
  constexpr int XS = logreg_stride(KP);
  constexpr int W = logreg_pow2(KP);
  float th[KP];  // the coefficients, read once an evaluation
#pragma unroll
  for (int k = 0; k < KP; k += 4) {
    const float4 t = reinterpret_cast<const float4*>(e.coef)[k / 4];
    th[k] = t.x;
    th[k + 1] = t.y;
    th[k + 2] = t.z;
    th[k + 3] = t.w;
  }
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
  lacc = 0.f;
  for (int r = e.rank * 32 + lane; r < e.N; r += 32 * e.G) {
    float xv[KP];
    logreg_row<KP>(e.xs + r * XS, xv);
    const float s = logreg_term(logreg_logit<KP>(th, xv), e.ys[r], lacc);
    logreg_axpy<KP, W>(s, xv, acc);
  }
  lacc = warp_sum(lacc);
  return reduce_scatter<W>(acc, lane);
}

// One chain's evaluation by the leader of a group of e.G warps (G = 1: a
// warp alone, no barrier). th_own: feature `lane` of the coefficients (0 at
// lane >= KP). Returns the log density and sets g_own to feature `lane` of
// the gradient.
template <int KP>
__device__ __forceinline__ float logreg_eval_group(float th_own,
                                                   const LogregGroup& e,
                                                   int lane, float& g_own) {
  __syncwarp();  // every lane has read the slot of the evaluation before
  if (lane < KP) e.coef[lane] = th_own;
  if (lane == 0) *e.command = LOGREG_EVAL;
  __syncwarp();
  if (e.G > 1) group_sync(e.bar, 32 * e.G);  // posted
  float lacc;
  float g = logreg_partial<KP>(e, lane, lacc);
  if (e.G > 1) {
    group_sync(e.bar, 32 * e.G);  // every helper's partial is written
    for (int q = 1; q < e.G; ++q) {
      g += e.part[q * LOGREG_PART + lane];
      lacc += e.part[q * LOGREG_PART + 32];
    }
  }
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < KP; k += 4) {
    const float4 t = reinterpret_cast<const float4*>(e.coef)[k / 4];
    sq = fmaf(t.x, t.x, sq);
    sq = fmaf(t.y, t.y, sq);
    sq = fmaf(t.z, t.z, sq);
    sq = fmaf(t.w, t.w, sq);
  }
  g_own = lane < KP ? g - th_own : 0.f;
  return fmaf(-0.5f, sq, lacc);
}

// A helper of a group (rank >= 1): its share of every evaluation the leader
// posts, until the leader posts LOGREG_EXIT.
template <int KP>
__device__ __forceinline__ void logreg_help(const LogregGroup& e, int lane) {
  for (;;) {
    group_sync(e.bar, 32 * e.G);  // posted
    if (*e.command == LOGREG_EXIT) return;
    float lacc;
    const float g = logreg_partial<KP>(e, lane, lacc);
    e.part[e.rank * LOGREG_PART + lane] = g;
    if (lane == 0) e.part[e.rank * LOGREG_PART + 32] = lacc;
    group_sync(e.bar, 32 * e.G);  // written
  }
}

// The leader's last post: its helpers return from logreg_help.
__device__ __forceinline__ void logreg_release(const LogregGroup& e, int lane) {
  if (e.G == 1) return;
  if (lane == 0) *e.command = LOGREG_EXIT;
  __syncwarp();
  group_sync(e.bar, 32 * e.G);
}

}  // namespace wt
