// Fused logistic-regression log density and gradient for a batch of chains.
//
// Replaces walnuts_tpu/ops/pallas_kernels.py::_logreg_kernel
// (pallas_kernels.py:31, launched by _logreg_fused_batch's pallas_call at
// pallas_kernels.py:70). For theta (B, P), design X (N, P), labels y (N,)
// in {-1, +1}:
//
//   z    = y * (theta X^T)                       (B, N), never stored
//   lp   = sum_n log sigmoid(z) - 0.5 |theta|^2
//   grad = (y * sigmoid(-z)) X - theta
//
// All in IEEE fp32 FMAs: no tensor cores, no TF32. The TPU kernel pins
// Precision.HIGHEST because low-precision passes put O(0.1-1) noise on the
// 1000-term likelihood and break the sampler's |dH| <= 0.5 test.
//
// What bounds it on the H100: arithmetic and the launch. At the main path's
// B = 4096 chains, N = 1000, P = 25 one evaluation is 2 x 4096 x 1000 x 25
// FMAs (0.4 GFLOP counting an FMA as two) plus 4M exp/log1p; X is 100 KB and
// stays in L2, theta and grad are 400 KB each. At 67 TFLOP/s of fp32 that
// is ~6 us of FMA work; memory traffic is negligible.
//
// Design: one block of 256 threads (8 warps) per tile of 32 chains (128
// blocks at 4096 chains, about one per SM). The block stages X (zero-padded
// to 32 columns, row stride 33 words so the 32 lanes of a warp, reading 32
// different rows, hit 32 different banks) and y in shared memory, whole when
// N <= 1024 rows, so the grid reads X ~128 times instead of once per chain.
// Each warp takes 4 of the tile's chains in turn: lanes stride over rows,
// each lane keeps the chain's 32 theta values and 32 gradient partials in
// registers (the logit is summed in 4 independent FMA chains for ILP), and
// the partials are reduced across the warp with shuffles at the end. The
// (B, N) logits never exist in memory, as on the TPU where the tile stayed
// in VMEM. log sigmoid(z) = -(max(0, -z) + log1p(exp(-|z|))) and
// sigmoid(-z) are evaluated in their overflow-free forms. The per-chain
// evaluation lives in logreg_chain.cuh, which the fused integrator
// (integrator.cu) runs once per leapfrog step.

#include <cuda_runtime.h>

#include "logreg_chain.cuh"

namespace {

constexpr int KP = wt::LOGREG_KP;  // padded feature width: P <= 32
constexpr int XS = wt::LOGREG_XS;  // shared-memory row stride (odd: no conflicts)
constexpr int TILE = 32;           // chains per block
constexpr int WARPS = 8;           // warps per block
constexpr int MAX_CHUNK = wt::LOGREG_MAX_ROWS;  // rows of X staged at once

__global__ void __launch_bounds__(WARPS * 32)
    logreg_kernel(const float* __restrict__ theta, const float* __restrict__ x,
                  const float* __restrict__ y, float* __restrict__ lp,
                  float* __restrict__ grad, int B, int P, int N, int chunk) {
  extern __shared__ float smem[];
  float* xs = smem;               // chunk rows x XS
  float* ys = smem + chunk * XS;  // chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool whole = chunk >= N;  // X staged once for the whole block

  for (int ci = 0; ci < TILE / WARPS; ++ci) {
    const int c = blockIdx.x * TILE + ci * WARPS + warp;
    const bool live = c < B;  // warp-uniform
    float th[KP], acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      th[k] = (live && k < P) ? theta[static_cast<size_t>(c) * P + k] : 0.f;
      acc[k] = 0.f;
    }
    float lacc = 0.f;
    for (int r0 = 0; r0 < N; r0 += chunk) {
      const int rows = min(chunk, N - r0);
      if (!whole || ci == 0) {  // block-uniform: every thread syncs
        __syncthreads();
        wt::logreg_stage(x, y, xs, ys, r0, rows, P);
        __syncthreads();
      }
      if (live) wt::logreg_accumulate(xs, ys, rows, lane, th, acc, lacc);
    }
    if (!live) continue;
    wt::logreg_reduce(acc, lacc);
    const float lp_c = wt::logreg_finish(th, acc, lacc);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < P) grad[static_cast<size_t>(c) * P + k] = acc[k];
      lp[c] = lp_c;
    }
  }
}

}  // namespace

extern "C" int wt_logreg_value_grad(const void* theta, const void* x,
                                    const void* y, void* lp, void* grad, int B,
                                    int P, int N, void* stream) {
  if (B <= 0 || N <= 0 || P <= 0 || P > KP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = N < MAX_CHUNK ? N : MAX_CHUNK;
  const size_t smem = static_cast<size_t>(chunk) * (XS + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logreg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + TILE - 1) / TILE;
  logreg_kernel<<<blocks, WARPS * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<float*>(lp),
      static_cast<float*>(grad), B, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
