// Fused leapfrog integrator: one attempt of every chain in one launch.
//
// Replaces walnuts_tpu/ops/integrator.py::_integrate_kernel
// (integrator.py:38, launched by _integrate_batch's pallas_call at
// integrator.py:105) with the model bodies of walnuts_tpu/models/kernels.py.
// Per chain c, n_steps[c] times (the loop is leapfrog.cuh's, shared with
// fused_transition.cu):
//
//   rho   += dt/2 * grad
//   theta += dt * inv_mass .* rho
//   lp, grad = model(theta)
//   rho   += dt/2 * grad
//
// cur (C, 3, D) packs theta, rho, grad; the outputs are the new cur and
// lp (C,). A chain with n_steps == 0 is copied through bit for bit with
// lp = -inf. dt is signed: a negative dt runs backward in time.
//
// What bounds it on the H100: operations. The cursor is read and written
// once (7 rows of D values a chain), while the work is n_steps model
// evaluations a chain; for logistic regression (N = 1000 rows, P = 25) one
// evaluation is 2 x 2 x N x P flops against 700 bytes of cursor.
//
// Design. On the TPU a tile of 256 chains loops to the tile's largest
// n_steps with masks, because its vector unit steps a tile in lock step.
// Here every chain loops its OWN n_steps: a warp that finishes early takes
// the next chain or retires, so no step is padding.
//
// - Standard normal, funnel, ill-conditioned normal (models.cuh): one warp
//   per chain, features strided over the lanes, theta / rho / grad /
//   inv_mass in registers for the whole attempt (NR registers a lane each:
//   4 for D <= 128, 32 for D <= 1024). Feature sums are shuffle sums.
//   float32 and float64.
// - Logistic regression (logreg_chain.cuh): a block of 8 warps takes 32
//   chains. X (padded to 32 columns, row stride 33) and y are staged in
//   shared memory once per launch (136 KB at N = 1000), not once per step.
//   Each warp runs its 4 chains in turn, a chain's whole attempt at a time:
//   rows strided over lanes, the chain's 32 coefficients and gradient
//   partials in registers, xor-shuffle sums that leave the full gradient in
//   every lane, so each lane updates its own copy of the cursor with no
//   further exchange. float32 only, explicit IEEE FMAs.
//
// Built with -fmad=false: the leapfrog updates and the simple bodies round
// every product and sum as the plain PyTorch version does. The dot products
// of the logistic-regression body are explicit fmaf and unaffected.

#include <cuda_runtime.h>
#include <math.h>

#include "leapfrog.cuh"

namespace {

constexpr int WARPS = 8;  // warps per block, both kernels

template <typename T, int NR, template <typename, int> class Model>
__global__ void __launch_bounds__(WARPS * 32)
    integrate_kernel(const T* __restrict__ cur, const T* __restrict__ inv_mass,
                     const T* __restrict__ dt, const int* __restrict__ n_steps,
                     wt::ModelParams<T> params, T* __restrict__ cur_out,
                     T* __restrict__ lp_out, int C, int D) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= C) return;  // warp-uniform
  const size_t row = static_cast<size_t>(c) * 3 * D;
  T th[NR], rh[NR], gr[NR], im[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int j = lane + 32 * k;
    const bool in = j < D;
    th[k] = in ? cur[row + j] : T(0);
    rh[k] = in ? cur[row + D + j] : T(0);
    gr[k] = in ? cur[row + 2 * D + j] : T(0);
    im[k] = in ? inv_mass[static_cast<size_t>(c) * D + j] : T(0);
  }
  Model<T, NR> model;
  model.init(params, D, lane);
  const T lp =
      wt::leapfrog_strided(th, rh, gr, im, model, dt[c], n_steps[c], lane);
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int j = lane + 32 * k;
    if (j < D) {
      cur_out[row + j] = th[k];
      cur_out[row + D + j] = rh[k];
      cur_out[row + 2 * D + j] = gr[k];
    }
  }
  if (lane == 0) lp_out[c] = lp;
}

constexpr int KP = wt::LOGREG_KP;
constexpr int XS = wt::LOGREG_XS;
constexpr int TILE = 32;  // chains per block of the logistic-regression kernel

__global__ void __launch_bounds__(WARPS * 32)
    integrate_logreg_kernel(const float* __restrict__ cur,
                            const float* __restrict__ inv_mass,
                            const float* __restrict__ dt,
                            const int* __restrict__ n_steps,
                            const float* __restrict__ x,
                            const float* __restrict__ y,
                            float* __restrict__ cur_out,
                            float* __restrict__ lp_out, int C, int P, int N) {
  extern __shared__ float smem[];
  float* xs = smem;           // N rows x XS
  float* ys = smem + N * XS;  // N
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  wt::logreg_stage(x, y, xs, ys, 0, N, P);
  __syncthreads();

  for (int ci = 0; ci < TILE / WARPS; ++ci) {
    const int c = blockIdx.x * TILE + ci * WARPS + warp;
    if (c >= C) break;  // warp-uniform; no block-wide sync follows
    const size_t row = static_cast<size_t>(c) * 3 * P;
    // every lane holds the chain's whole cursor (broadcast loads)
    float th[KP], rh[KP], gr[KP], im[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const bool in = k < P;
      th[k] = in ? cur[row + k] : 0.f;
      rh[k] = in ? cur[row + P + k] : 0.f;
      gr[k] = in ? cur[row + 2 * P + k] : 0.f;
      im[k] = in ? inv_mass[static_cast<size_t>(c) * P + k] : 0.f;
    }
    const float lp = wt::leapfrog_logreg(th, rh, gr, im, xs, ys, N, dt[c],
                                         n_steps[c], lane);
    // lane k stores feature k of the three rows
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (lane == k && k < P) {
        cur_out[row + k] = th[k];
        cur_out[row + P + k] = rh[k];
        cur_out[row + 2 * P + k] = gr[k];
      }
    }
    if (lane == 0) lp_out[c] = lp;
  }
}

template <typename T, int NR, template <typename, int> class Model>
cudaError_t launch(const void* cur, const void* inv_mass, const void* dt,
                   const void* n_steps, const void* c0, double p0, double p1,
                   void* cur_out, void* lp_out, int C, int D,
                   cudaStream_t stream) {
  wt::ModelParams<T> params{static_cast<const T*>(c0), static_cast<T>(p0),
                            static_cast<T>(p1)};
  const int blocks = (C + WARPS - 1) / WARPS;
  integrate_kernel<T, NR, Model><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(cur), static_cast<const T*>(inv_mass),
      static_cast<const T*>(dt), static_cast<const int*>(n_steps), params,
      static_cast<T*>(cur_out), static_cast<T*>(lp_out), C, D);
  return cudaGetLastError();
}

template <typename T, template <typename, int> class Model>
cudaError_t launch_width(const void* cur, const void* inv_mass, const void* dt,
                         const void* n_steps, const void* c0, double p0,
                         double p1, void* cur_out, void* lp_out, int C, int D,
                         cudaStream_t stream) {
  if (D <= 128)
    return launch<T, 4, Model>(cur, inv_mass, dt, n_steps, c0, p0, p1, cur_out,
                               lp_out, C, D, stream);
  return launch<T, 32, Model>(cur, inv_mass, dt, n_steps, c0, p0, p1, cur_out,
                              lp_out, C, D, stream);
}

template <template <typename, int> class Model>
cudaError_t launch_type(int is_double, const void* cur, const void* inv_mass,
                        const void* dt, const void* n_steps, const void* c0,
                        double p0, double p1, void* cur_out, void* lp_out,
                        int C, int D, cudaStream_t stream) {
  if (is_double)
    return launch_width<double, Model>(cur, inv_mass, dt, n_steps, c0, p0, p1,
                                       cur_out, lp_out, C, D, stream);
  return launch_width<float, Model>(cur, inv_mass, dt, n_steps, c0, p0, p1,
                                    cur_out, lp_out, C, D, stream);
}

}  // namespace

// body: wt::Body. c0, c1: the body's constants (ill-conditioned normal:
// inv_var (D,) in the cursor's type; logistic regression: x (N, D) and
// y (N,), float32). p0, p1: the funnel's 1 / scale^2 and 0.5 (D - 1).
extern "C" int wt_integrate(const void* cur, const void* inv_mass,
                            const void* dt, const void* n_steps,
                            const void* c0, const void* c1, void* cur_out,
                            void* lp_out, int C, int D, int body, int is_double,
                            double p0, double p1, int n_data, void* stream_ptr) {
  if (C <= 0 || D <= 0 || D > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (body) {
    case wt::BODY_STD_NORMAL:
      err = launch_type<wt::StdNormal>(is_double, cur, inv_mass, dt, n_steps, c0,
                                       p0, p1, cur_out, lp_out, C, D, stream);
      break;
    case wt::BODY_FUNNEL:
      err = launch_type<wt::Funnel>(is_double, cur, inv_mass, dt, n_steps, c0,
                                    p0, p1, cur_out, lp_out, C, D, stream);
      break;
    case wt::BODY_ILL_NORMAL:
      if (c0 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_type<wt::IllNormal>(is_double, cur, inv_mass, dt, n_steps, c0,
                                       p0, p1, cur_out, lp_out, C, D, stream);
      break;
    case wt::BODY_LOGREG: {
      if (is_double || D > KP || n_data <= 0 || n_data > wt::LOGREG_MAX_ROWS ||
          c0 == nullptr || c1 == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = static_cast<size_t>(n_data) * (XS + 1) * sizeof(float);
      err = cudaFuncSetAttribute(integrate_logreg_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = (C + TILE - 1) / TILE;
      integrate_logreg_kernel<<<blocks, WARPS * 32, smem, stream>>>(
          static_cast<const float*>(cur), static_cast<const float*>(inv_mass),
          static_cast<const float*>(dt), static_cast<const int*>(n_steps),
          static_cast<const float*>(c0), static_cast<const float*>(c1),
          static_cast<float*>(cur_out), static_cast<float*>(lp_out), C, D,
          n_data);
      err = cudaGetLastError();
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
