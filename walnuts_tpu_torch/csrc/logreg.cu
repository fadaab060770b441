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
// What bounds it on the H100: arithmetic. At the main path's B = 4096
// chains, N = 1000, P = 25 the two products are 2 x 4096 x 1000 x 25 FMAs
// (0.4 GFLOP counting an FMA as two), ~6 us at 67 TFLOP/s of fp32, and the
// 4M log-sigmoid terms (exp, log1p, a division each) cost about as many
// instructions again; X is 100 KB and stays in L2, theta and grad are 400 KB
// each.
//
// Design: the TPU kernel's two products as tiles, the (B, N) logits kept in
// registers. A block of 16 warps takes a tile of 32 chains, one a lane, and
// holds each chain's P coefficients and P gradient partials in its lane's
// registers for the whole launch. X and y stream through shared memory in
// chunks of 256 rows, copied with cp.async into two buffers, so the copy of
// chunk i + 1 overlaps the arithmetic on chunk i (128 blocks read the 100 KB
// X once each: ~13 MB of L2 traffic). Warp w takes rows w, w + 16, ... of a
// chunk: all 32 lanes read the same row (a broadcast, 16 bytes a load), so
// every X value loaded serves 32 chains and every coefficient in a register
// serves every row. Per row and lane: the logit (P FMAs), the log-sigmoid
// term and s = y sigmoid(-z) in registers (logreg_chain.cuh's overflow-free
// forms), then grad partial += s x_r (P FMAs). At the end the 16 warps'
// partials are summed through shared memory in warp order, so a launch is
// bitwise equal to the next on the same inputs (no atomics). The features
// are padded to P rounded up to 4, a template width (4, ..., 32).
//
// What holds it back (tools/torch_logreg_sweep.py, PERF.md): every lane
// needs all P values of every row, so the shared-memory path delivers ~1
// 16-byte load per 4 FMAs, and the three transcendental-heavy functions of
// the term (exp, log1p, an IEEE division) cost about as many instructions
// as the two products.

#include <cuda_runtime.h>

#include "logreg_chain.cuh"

namespace {

// The launch's geometry: warps per block (warp w takes rows w, w + WARPS,
// ... of each chunk; tools/torch_logreg_sweep.py times other counts), 32
// chains per block, one a lane, CHUNK_PER_WARP * WARPS rows per staged
// chunk, two chunks in flight.
constexpr int WARPS = 16;
constexpr int TILE = 32;
constexpr int CHUNK_PER_WARP = 16;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));  // zero-filled when not valid
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of a block: two chunk buffers of X and y, the warps' lp
// partials; the warps' gradient partials reuse the X buffers at the end.
template <int KP, int W>
constexpr size_t smem_bytes() {
  return (2 * CHUNK_PER_WARP * W * (wt::logreg_stride(KP) + 1) + W * TILE) *
         sizeof(float);
}

// Start copying rows [r0, r0 + rows) of x (N, P) and y into a buffer,
// features zero-padded to KP at row stride XS.
template <int KP, int W>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            float* xs, float* ys, int r0,
                                            int rows, int P) {
  constexpr int XS = wt::logreg_stride(KP);
  for (int i = threadIdx.x; i < rows * KP; i += W * 32) {
    const int r = i / KP, k = i % KP;
    const bool in = k < P;
    cp_async4(xs + r * XS + k, in ? x + static_cast<size_t>(r0 + r) * P + k : x,
              in);
  }
  for (int i = threadIdx.x; i < rows; i += W * 32)
    cp_async4(ys + i, y + r0 + i, true);
  cp_async_commit();
}

// TERMS = false leaves out the log-sigmoid terms (s = the logit, lp = 0):
// the two products alone, as a yardstick for tools/torch_logreg_sweep.py.
template <int KP, int W, bool TERMS = true>
__global__ void __launch_bounds__(W * 32)
    logreg_kernel(const float* __restrict__ theta, const float* __restrict__ x,
                  const float* __restrict__ y, float* __restrict__ lp,
                  float* __restrict__ grad, int B, int P, int N) {
  constexpr int XS = wt::logreg_stride(KP);
  constexpr int CHUNK = CHUNK_PER_WARP * W;
  static_assert(W * TILE * KP <= 2 * CHUNK * XS, "partials fit the buffers");
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [2][CHUNK * XS]
  float* ys = xs + 2 * CHUNK * XS;             // [2][CHUNK]
  float* lpart = ys + 2 * CHUNK;               // [W][TILE]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * TILE + lane;
  const bool live = c < B;
  float th[KP], acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    th[k] = (live && k < P) ? theta[static_cast<size_t>(c) * P + k] : 0.f;
    acc[k] = 0.f;
  }
  float lacc = 0.f;

  const int n_chunks = (N + CHUNK - 1) / CHUNK;
  stage_chunk<KP, W>(x, y, xs, ys, 0, min(CHUNK, N), P);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * CHUNK, rows = min(CHUNK, N - r0);
    const int nb = (ch + 1) & 1;
    if (ch + 1 < n_chunks) {
      // the other buffer was released by the barrier that ended chunk ch - 1
      stage_chunk<KP, W>(x, y, xs + nb * CHUNK * XS, ys + nb * CHUNK,
                         r0 + CHUNK, min(CHUNK, N - r0 - CHUNK), P);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xb = xs + (ch & 1) * CHUNK * XS;
    const float* yb = ys + (ch & 1) * CHUNK;
    for (int r = warp; r < rows; r += W) {
      float xv[KP];
      wt::logreg_row<KP>(xb + r * XS, xv);
      const float l = wt::logreg_logit<KP>(th, xv);
      const float s = TERMS ? wt::logreg_term(l, yb[r], lacc) : l;
      wt::logreg_axpy<KP, KP>(s, xv, acc);
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // the warps' partials, feature-major so that a warp's stores hit 32 banks
  float* part = xs;  // [warp][k][lane], over both buffers
#pragma unroll
  for (int k = 0; k < KP; ++k) part[(warp * KP + k) * TILE + lane] = acc[k];
  lpart[warp * TILE + lane] = lacc;
  __syncthreads();
  const int c0 = blockIdx.x * TILE;
  const int n_live = min(TILE, B - c0);
  for (int i = threadIdx.x; i < n_live * P; i += W * 32) {
    const int cl = i / P, k = i % P;
    float g = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) g += part[(w * KP + k) * TILE + cl];
    const size_t at = static_cast<size_t>(c0) * P + i;
    grad[at] = g - theta[at];
  }
  if (warp == 0 && live) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) l += lpart[w * TILE + lane];
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) sq = fmaf(th[k], th[k], sq);
    lp[c] = fmaf(-0.5f, sq, l);
  }
}

template <int KP, int W = WARPS, bool TERMS = true>
cudaError_t launch(const float* theta, const float* x, const float* y,
                   float* lp, float* grad, int B, int P, int N,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KP, W>();
  const auto kernel = logreg_kernel<KP, W, TERMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(B + TILE - 1) / TILE, W * 32, smem, stream>>>(theta, x, y, lp, grad,
                                                          B, P, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wt_logreg_value_grad(const void* theta, const void* x,
                                    const void* y, void* lp, void* grad, int B,
                                    int P, int N, void* stream) {
  if (B <= 0 || N <= 0 || P <= 0 || P > wt::LOGREG_MAX_FEATURES)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(wt::logreg_by_width(P, [&](auto width) {
    return launch<decltype(width)::value>(
        static_cast<const float*>(theta), static_cast<const float*>(x),
        static_cast<const float*>(y), static_cast<float*>(lp),
        static_cast<float*>(grad), B, P, N, static_cast<cudaStream_t>(stream));
  }));
}
