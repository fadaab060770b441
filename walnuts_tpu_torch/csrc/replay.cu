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
// What bounds it on the H100: one lane's chain of dependent hashes, behind
// the launch. The bytes (40 a lane, 164 KB at the main path's 4096 lanes)
// take 0.05 us at 3.35 TB/s; the hashes' operations (4096 x 12 x 2 of ~115
// integer operations) a fraction of a microsecond of the card's rate. But
// each round's split needs the key of the round before: n_ends <= 12
// hashes of ~20 dependent add / rotate / xor steps each, some 150-200 SM
// cycles a hash, ~1-1.5 us for the longest lane, on top of the launch and
// one round trip to memory. That floor (PERF.md, the kernel table) is
// what the kernel can reach, not the byte bound.
//
// Design: one thread per lane, each looping over ITS OWN n_ends. The TPU
// kernel loops every lane to the tile-wide max(n_ends) (prng.py:193-195),
// and the XLA replay needs a host-visible max (core/batched.py:708); on the
// GPU a thread's loop count is free, so no cross-lane max is taken and no
// device-to-host read is needed. A round is wt::replay_chain's (shared with
// the fused pass, csrc/fused_pass.cu): both subkeys hashed as two
// independent chains, then a select, so a warp whose lanes latch at
// different rounds runs one round's latency per round, not two. Keys stay
// in registers; the launch reads and writes each lane's 16 bytes once.
// The key storage is the port's int32 bit pattern, read here as uint32.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

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
  wt::replay_chain(k0, k1, u0, u1, n_ends[c], leaf_end_at[c]);
  key_out[2 * c] = k0;
  key_out[2 * c + 1] = k1;
  ku_out[2 * c] = u0;
  ku_out[2 * c + 1] = u1;
}

// Does nothing: its launch is the floor every small kernel sits on
// (chip_smoke.py times it as it times the replay and the fused pass).
__global__ void empty_kernel() {}

}  // namespace

extern "C" int wt_empty_kernel(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

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
