// Device bodies of the hand-written model value-and-gradients.
//
// Counterparts of walnuts_tpu/models/kernels.py (std_normal_vg :23,
// funnel_vg :31, ill_conditioned_normal_vg :103; logistic_regression_vg :58
// is in logreg_chain.cuh). One warp holds one chain: feature j = lane + 32 k
// sits in register k of lane `lane`, NR registers a lane; features at or
// beyond D hold zeros, which every body maps to a zero gradient and a zero
// contribution to the log density. Each body writes the gradient over `gr`
// and returns the log density in every lane. The arithmetic is the plain
// PyTorch version's, product by product (integrator.cu is built with
// -fmad=false); only the order of the feature sums differs.

#pragma once

#include <cuda_runtime.h>

namespace wt {

enum Body { BODY_STD_NORMAL = 0, BODY_FUNNEL = 1, BODY_ILL_NORMAL = 2,
            BODY_LOGREG = 3 };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Scalar parameters and constants of a body.
template <typename T>
struct ModelParams {
  const T* c0;  // ill-conditioned normal: inv_var (D,)
  T p0;         // funnel: 1 / scale^2
  T p1;         // funnel: 0.5 * (D - 1)
};

// lp = -0.5 sum theta^2; grad = -theta
template <typename T, int NR>
struct StdNormal {
  __device__ __forceinline__ void init(const ModelParams<T>&, int, int) {}
  __device__ __forceinline__ T vg(const T (&th)[NR], T (&gr)[NR], int) const {
    T ss = T(0);
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      ss += th[k] * th[k];
      gr[k] = -th[k];
    }
    return T(-0.5) * warp_sum(ss);
  }
};

// Neal's funnel, v = theta[0], x = theta[1:], s = sum x^2, e = exp(-v):
//   lp = -0.5 v^2 / scale^2 - 0.5 s e - 0.5 (D - 1) v
//   dv = -v / scale^2 + 0.5 s e - 0.5 (D - 1);  dx = -x e
template <typename T, int NR>
struct Funnel {
  T inv_s2, half_d;
  __device__ __forceinline__ void init(const ModelParams<T>& p, int, int) {
    inv_s2 = p.p0;
    half_d = p.p1;
  }
  __device__ __forceinline__ T vg(const T (&th)[NR], T (&gr)[NR],
                                  int lane) const {
    const T v = __shfl_sync(0xffffffffu, th[0], 0);
    T ss = lane == 0 ? T(0) : th[0] * th[0];
#pragma unroll
    for (int k = 1; k < NR; ++k) ss += th[k] * th[k];
    const T ssq = warp_sum(ss);
    const T e = exp(-v);
    const T hse = (T(0.5) * ssq) * e;
#pragma unroll
    for (int k = 0; k < NR; ++k) gr[k] = (-th[k]) * e;
    if (lane == 0) gr[0] = ((-v) * inv_s2 + hse) - half_d;
    return (((T(-0.5) * v) * v) * inv_s2 - hse) - half_d * v;
  }
};

// Independent normal with variances d^2: grad = -inv_var theta;
// lp = 0.5 sum grad theta
template <typename T, int NR>
struct IllNormal {
  T iv[NR];
  __device__ __forceinline__ void init(const ModelParams<T>& p, int D,
                                       int lane) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int j = lane + 32 * k;
      iv[k] = j < D ? p.c0[j] : T(0);
    }
  }
  __device__ __forceinline__ T vg(const T (&th)[NR], T (&gr)[NR], int) const {
    T ss = T(0);
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      gr[k] = (-iv[k]) * th[k];
      ss += gr[k] * th[k];
    }
    return T(0.5) * warp_sum(ss);
  }
};

}  // namespace wt
