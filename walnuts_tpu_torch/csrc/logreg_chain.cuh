// One chain's logistic-regression log density and gradient, by one warp.
//
// Shared by logreg.cu (one evaluation per launch) and integrator.cu (one
// evaluation per leapfrog step, inside the attempt loop). The design matrix
// sits in shared memory, zero-padded to KP columns with row stride XS (odd,
// so the 32 lanes of a warp, reading 32 different rows, hit 32 different
// banks). Lanes stride over rows; each lane keeps the chain's KP
// coefficients and KP gradient partials in registers; the partials are
// summed across the warp with xor shuffles, which leave the full sums in
// every lane. All products are explicit IEEE fp32 FMAs: no tensor cores,
// no TF32, and no dependence on the compiler's contraction flag.

#pragma once

#include <cuda_runtime.h>

namespace wt {

constexpr int LOGREG_KP = 32;             // padded feature width: P <= 32
constexpr int LOGREG_XS = LOGREG_KP + 1;  // shared-memory row stride
constexpr int LOGREG_MAX_ROWS = 1024;     // rows of X staged at once

// Stage rows [r0, r0 + rows) of x (N, P) and y into shared memory. Every
// thread of the block calls it; the caller synchronizes around it.
__device__ __forceinline__ void logreg_stage(const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             float* xs, float* ys, int r0,
                                             int rows, int P) {
  for (int i = threadIdx.x; i < rows * LOGREG_KP; i += blockDim.x) {
    const int r = i / LOGREG_KP, k = i % LOGREG_KP;
    xs[r * LOGREG_XS + k] =
        k < P ? x[static_cast<size_t>(r0 + r) * P + k] : 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) ys[i] = y[r0 + i];
}

// Add this lane's rows of the staged chunk to its partials: acc[k] +=
// sum_r s_r x_rk and lacc += sum_r log sigmoid(z_r), in the overflow-free
// forms log sigmoid(z) = -(max(0, -z) + log1p(exp(-|z|))) and
// sigmoid(-z) = e / (1 + e) or 1 / (1 + e) with e = exp(-|z|).
__device__ __forceinline__ void logreg_accumulate(const float* xs,
                                                  const float* ys, int rows,
                                                  int lane,
                                                  const float (&th)[LOGREG_KP],
                                                  float (&acc)[LOGREG_KP],
                                                  float& lacc) {
  for (int r = lane; r < rows; r += 32) {
    const float* xr = xs + r * LOGREG_XS;
    float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
#pragma unroll
    for (int k = 0; k < LOGREG_KP; k += 4) {
      l0 = fmaf(th[k], xr[k], l0);
      l1 = fmaf(th[k + 1], xr[k + 1], l1);
      l2 = fmaf(th[k + 2], xr[k + 2], l2);
      l3 = fmaf(th[k + 3], xr[k + 3], l3);
    }
    const float yr = ys[r];
    const float z = yr * ((l0 + l1) + (l2 + l3));
    const float e = expf(-fabsf(z));
    lacc -= fmaxf(-z, 0.f) + log1pf(e);
    const float sig_neg = z >= 0.f ? e / (1.f + e) : 1.f / (1.f + e);
    const float s = yr * sig_neg;
#pragma unroll
    for (int k = 0; k < LOGREG_KP; ++k) acc[k] = fmaf(s, xr[k], acc[k]);
  }
}

// Sum the partials over the warp; every lane ends with the full sums.
__device__ __forceinline__ void logreg_reduce(float (&acc)[LOGREG_KP],
                                              float& lacc) {
#pragma unroll
  for (int k = 0; k < LOGREG_KP; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lacc += __shfl_xor_sync(0xffffffffu, lacc, off);
}

// From the reduced sums: the gradient (into acc) and the log density.
__device__ __forceinline__ float logreg_finish(const float (&th)[LOGREG_KP],
                                               float (&acc)[LOGREG_KP],
                                               float lacc) {
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < LOGREG_KP; ++k) {
    sq = fmaf(th[k], th[k], sq);
    acc[k] = acc[k] - th[k];
  }
  return fmaf(-0.5f, sq, lacc);
}

}  // namespace wt
