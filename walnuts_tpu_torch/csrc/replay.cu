// Deferred threefry key-split replay of the batched WALNUTS scheduler.
//
// Replaces walnuts_tpu/ops/prng.py::_replay_kernel (prng.py:170, launched by
// replay_split_chain's pallas_call at prng.py:226). Per chain lane: advance
// the key through n_ends sequential threefry2x32 splits, keeping subkey 0;
// at round leaf_end_at (1-based) latch subkey 1 into ku. Lanes with
// n_ends == 0 pass through. Subkey j of a split is threefry2x32(key, 0, j)
// (jax's partitionable lowering), so the arithmetic is integer ARX and the
// result is bitwise equal to the plain PyTorch version
// (walnuts_tpu_torch/ops/prng.py::replay_split_chain_plain).
//
// What bounds it on the H100: nothing of the card's. At the main path's
// 4096 lanes and at most tier2_every (6 or 12) rounds, the work is about
// 4096 x 12 x 2 hashes of ~100 integer operations, well under a
// microsecond of the card, and 64 KB of traffic. The launch (a few
// microseconds) is the whole cost.
//
// Design: one thread per lane, each looping over ITS OWN n_ends. The TPU
// kernel loops every lane to the tile-wide max(n_ends) (prng.py:193-195),
// and the XLA replay needs a host-visible max (core/batched.py:708); on the
// GPU a thread's loop count is free, so no cross-lane max is taken and no
// device-to-host read is needed. Keys stay in registers; the launch reads
// and writes each lane's 16 bytes once. The key storage is the port's int32
// bit pattern, read here as uint32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rots[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

__global__ void replay_kernel(const uint32_t* __restrict__ key,
                              const uint32_t* __restrict__ ku,
                              const int32_t* __restrict__ n_ends,
                              const int32_t* __restrict__ leaf_end_at,
                              uint32_t* __restrict__ key_out,
                              uint32_t* __restrict__ ku_out, int lanes) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= lanes) return;
  uint32_t k0 = key[2 * c], k1 = key[2 * c + 1];
  uint32_t u0 = ku[2 * c], u1 = ku[2 * c + 1];
  const int n = n_ends[c];
  const int at = leaf_end_at[c];
  for (int j = 0; j < n; ++j) {
    if (at == j + 1) threefry2x32(k0, k1, 0u, 1u, u0, u1);
    threefry2x32(k0, k1, 0u, 0u, k0, k1);
  }
  key_out[2 * c] = k0;
  key_out[2 * c + 1] = k1;
  ku_out[2 * c] = u0;
  ku_out[2 * c + 1] = u1;
}

}  // namespace

extern "C" int wt_replay_split_chain(const void* key, const void* ku,
                                     const void* n_ends,
                                     const void* leaf_end_at, void* key_out,
                                     void* ku_out, int lanes, void* stream) {
  if (lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (lanes + threads - 1) / threads;
  replay_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(ku),
      static_cast<const int32_t*>(n_ends),
      static_cast<const int32_t*>(leaf_end_at),
      static_cast<uint32_t*>(key_out), static_cast<uint32_t*>(ku_out), lanes);
  return static_cast<int>(cudaGetLastError());
}
