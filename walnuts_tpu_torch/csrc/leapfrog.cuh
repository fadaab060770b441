// The leapfrog loop of one chain, by one warp, with the model inlined.
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

// Logistic regression (logreg_chain.cuh): every lane holds the chain's
// whole cursor; xs (N rows, stride LOGREG_XS) and ys are staged in shared
// memory.
__device__ __forceinline__ float leapfrog_logreg(
    float (&th)[LOGREG_KP], float (&rh)[LOGREG_KP], float (&gr)[LOGREG_KP],
    const float (&im)[LOGREG_KP], const float* xs, const float* ys, int N,
    float h, int n, int lane) {
  const float half = 0.5f * h;
  float lp = -INFINITY;
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < LOGREG_KP; ++k) {
      rh[k] = rh[k] + half * gr[k];
      th[k] = th[k] + (h * im[k]) * rh[k];
      gr[k] = 0.f;
    }
    float lacc = 0.f;
    logreg_accumulate(xs, ys, N, lane, th, gr, lacc);
    logreg_reduce(gr, lacc);
    lp = logreg_finish(th, gr, lacc);
#pragma unroll
    for (int k = 0; k < LOGREG_KP; ++k) rh[k] = rh[k] + half * gr[k];
  }
  return lp;
}

}  // namespace wt
