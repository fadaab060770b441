// The leapfrog loop of one chain, by one warp, with the model inlined (the
// logistic-regression group version: the model's rows split over a group).
//
// Shared by integrator.cu (one attempt per launch) and fused_transition.cu
// (every attempt of a whole transition). n times, with signed step h:
//
//   rho   += h/2 * grad
//   theta += h * inv_mass .* rho
//   lp, grad = model(theta)
//   rho   += h/2 * grad
//
// Returns the last lp, or -inf when n == 0 (the cursor is then untouched).
// Every product and sum is rounded on its own, in the plain PyTorch
// version's order: the sources that include this are built with
// -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "logreg_chain.cuh"
#include "models.cuh"

namespace wt {

// Features strided over the lanes (models.cuh): feature lane + 32 k in
// register k.
template <typename T, int NR, class Model>
__device__ __forceinline__ T leapfrog_strided(T (&th)[NR], T (&rh)[NR],
                                              T (&gr)[NR], const T (&im)[NR],
                                              const Model& model, T h, int n,
                                              int lane) {
  const T half = T(0.5) * h;
  T lp = static_cast<T>(-INFINITY);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      rh[k] = rh[k] + half * gr[k];
      th[k] = th[k] + (h * im[k]) * rh[k];
    }
    lp = model.vg(th, gr, lane);
#pragma unroll
    for (int k = 0; k < NR; ++k) rh[k] = rh[k] + half * gr[k];
  }
  return lp;
}

// Logistic regression (logreg_chain.cuh): lane k holds feature k of the
// cursor (0 at k >= P), as the strided bodies do at D <= 32; after each
// position update the coefficients are broadcast to every lane by shuffles
// for the evaluation. xs (N rows at width KP) and ys are staged in shared
// memory.
template <int KP>
__device__ __forceinline__ float leapfrog_logreg(float& th, float& rh,
                                                 float& gr, float im,
                                                 const float* xs,
                                                 const float* ys, int N,
                                                 float h, int n, int lane) {
  const float half = 0.5f * h;
  float lp = -INFINITY;
  for (int i = 0; i < n; ++i) {
    rh = rh + half * gr;
    th = th + (h * im) * rh;
    float tv[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) tv[k] = __shfl_sync(0xffffffffu, th, k);
    lp = logreg_eval<KP>(tv, th, xs, ys, N, lane, gr);
    rh = rh + half * gr;
  }
  return lp;
}

// The same loop, run by the leader of a group of warps that shares the
// chain's evaluations (logreg_eval_group).
template <int KP>
__device__ __forceinline__ float leapfrog_logreg_group(float& th, float& rh,
                                                       float& gr, float im,
                                                       const LogregGroup& e,
                                                       float h, int n,
                                                       int lane) {
  const float half = 0.5f * h;
  float lp = -INFINITY;
  for (int i = 0; i < n; ++i) {
    rh = rh + half * gr;
    th = th + (h * im) * rh;
    lp = logreg_eval_group<KP>(th, e, lane, gr);
    rh = rh + half * gr;
  }
  return lp;
}

}  // namespace wt
