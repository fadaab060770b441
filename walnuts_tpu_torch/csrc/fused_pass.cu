// The batched WALNUTS scheduler's tier-2 pass, banking included, in one
// launch.
//
// Replaces walnuts_tpu/ops/fused_pass.py::_make_kernel (fused_pass.py:172,
// launched by fused_pass_call's pallas_call at fused_pass.py:517). It
// computes what walnuts_tpu_torch/ops/fused_pass.py::fused_pass_plain
// computes, for every chain lane c of the batch:
//
//   - the merge cascade of sub-U-turn checks against the stacked endpoints,
//   - the deferred threefry key-split replay (over the lane's own n_ends),
//   - the three leaf uniforms, the stack push, the reservoir (Barker) and
//     top-level Metropolis choices, the combined U-turn, deeper / exhausted,
//   - on completion: banking of the draw at its draw index into the block's
//     output and, unless the lane just finished the block, the trajectory
//     restart (3-way key split, momenta ~ N(0, M), the direction bit),
//   - the merged field writes,
//
// reading and writing the lane state in place (every read-write operand has
// its own storage; the wrapper checks). Rows are chain-major (C, D), the
// port's layout, and the stack is (C, n_slots, 2, D).
//
// What bounds it on the H100: bytes. Only pending lanes (active and with a
// latched leaf) touch rows: the leaf's three rows, inv_mass, up to 16 state
// rows, the stack slots the cascade reads and the U-turn endpoints are
// read, and the rows that change written; every lane reads and writes its
// keys and replay counts. At 4096 chains and D = 25 in float32, with every
// lane pending and a full cascade, that is ~20 MB, ~6 us at 3.35 TB/s
// (chip_smoke.py counts the bytes a given state needs). The threefry and
// erf_inv work of a restart is a few hundred integer and float operations
// per element, far below the card's rate.
//
// Design: one warp per chain, chains_per_block warps per block. The warp's
// threads stride over the features, so every row access is coalesced; the
// U-turn dot products and the momentum energy are warp-shuffle sums. The
// per-lane scalar logic (replay, uniforms, decisions) runs redundantly on
// all 32 threads, so the decisions are warp-uniform and need no broadcast.
// Non-pending lanes only replay their keys. The TPU kernel's tile-wide
// max(n_ends) loop bound is dropped: a lane replays its own count. The
// B-deep banking ring of the TPU kernel is not carried over: a completing
// lane writes its draw straight into the output at its draw index.
//
// Numbers: built with -fmad=false so that the normals' polynomials and
// u * (hi - lo) + lo round each step as PyTorch does, and with the IEEE
// logf/expf/log1pf/sqrtf. Integers, flags and keys equal the plain version
// lane by lane; floats that come from sums (the U-turn dot products, the
// momentum energy of a restart) differ from PyTorch's by summation order.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

// Must match walnuts_tpu_torch/ops/fused_pass.py::FusedPassArgs field by
// field (the wrapper compares sizeof).
struct FusedPassArgs {
  // read-write per-lane floats (C,)
  void *run_sel_logp, *run_logw, *ms_joint, *dt, *lp_cur, *acc_jt_bk,
      *acc_jt_fw, *acc_lp_sel, *acc_logw;
  // read-write per-lane int32 (C,)
  void *depth, *out_depth, *leaf_idx, *n_leaves, *halvings, *steps_done,
      *steps_total, *phase, *n_ends, *leaf_end_at, *n_depth_exhausted,
      *draws_done;
  // read-write per-lane bool (C,)
  void *forward, *leaf_done, *leaf_ok;
  // read-write key data (C, 2), int32 bit patterns of uint32 words
  void *key, *ku;
  // read-write rows (C, D)
  void *acc_th_bk, *acc_rho_bk, *acc_th_fw, *acc_rho_fw, *acc_th_sel,
      *acc_grad_bk, *acc_grad_sel, *acc_grad_fw, *run_sel, *run_sel_grad,
      *ms_th, *ms_rho, *ms_grad, *cur_th, *cur_rho, *cur_grad;
  // read-write merge stack (C, n_slots, 2, D)
  void* stack_e;
  // read-only rows (C, D)
  void *fwd_th, *fwd_rho, *fwd_grad, *inv_mass;
  // read-only per-lane floats and min_micro (C,)
  void *fwd_logp_pos, *fwd_joint, *step, *min_micro;
  // the block's output: draws (R, C, D), logps (R, C), depths (R, C) int32
  void *draws, *logps, *depths;
  int chains, dim, n_slots, max_depth, block_draws, cap, chains_per_block,
      is_double;
};

constexpr int kPhFwd = 0;  // core/transition.py _PH_FWD

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float wt_exp(float x) { return expf(x); }
__device__ __forceinline__ double wt_exp(double x) { return exp(x); }
__device__ __forceinline__ float wt_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double wt_log1p(double x) { return log1p(x); }

// ops/math.py::log_sum_exp: NaN in -> NaN, matched infinities -> that
// infinity, -inf is the identity
template <typename T>
__device__ __forceinline__ T log_sum_exp(T a, T b) {
  if (isnan(a) || isnan(b)) return a + b;
  const T m = a > b ? a : b;
  const T mn = a > b ? b : a;
  if (isinf(m)) return m;
  return m + wt_log1p(wt_exp(mn - m));
}

template <typename T>
__device__ __forceinline__ T leaf_uniform(uint32_t k0, uint32_t k1,
                                          uint32_t j) {
  uint32_t x0, x1;
  wt::threefry2x32(k0, k1, 0u, j, x0, x1);
  return wt::uniform_from_bits<T>(x0, x1);
}

// U-turn of the span from (old_th, old_rho) to the leaf (fth, frho): the
// sign of either endpoint's momentum along inv_mass * (fth - old_th), in
// the orbit's direction. Warp-uniform result.
template <typename T>
__device__ __forceinline__ bool uturn(const T* fth, const T* frho,
                                      const T* oth, const T* orho,
                                      const T* im, T sgn, int D, int lane) {
  T a = T(0), b = T(0);
  for (int d = lane; d < D; d += 32) {
    const T delta = (sgn * im[d]) * (fth[d] - oth[d]);
    a += frho[d] * delta;
    b += orho[d] * delta;
  }
  a = warp_sum(a);
  b = warp_sum(b);
  return a < T(0) || b < T(0);
}

template <typename T>
__global__ void fused_pass_kernel(const FusedPassArgs a) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= a.chains) return;  // warp-uniform
  const int D = a.dim, n_slots = a.n_slots, max_depth = a.max_depth;
  const size_t row = static_cast<size_t>(c) * D;

  auto fl = [&](void* p) { return static_cast<T*>(p) + c; };
  auto in = [&](void* p) { return static_cast<int32_t*>(p) + c; };
  auto bo = [&](void* p) { return static_cast<bool*>(p) + c; };
  auto rw = [&](void* p) { return static_cast<T*>(p) + row; };

  // ---- per-lane scalars (every thread of the warp holds them) ----
  const int draws_done = *in(a.draws_done);
  const bool active = draws_done < a.cap;
  const bool leaf_done = *bo(a.leaf_done);
  const bool leaf_ok_in = *bo(a.leaf_ok);
  const bool forward = *bo(a.forward);
  const bool pend = active && leaf_done;

  // ---- deferred key-split replay over this lane's own n_ends ----
  uint32_t* key = static_cast<uint32_t*>(a.key) + 2 * static_cast<size_t>(c);
  uint32_t* ku = static_cast<uint32_t*>(a.ku) + 2 * static_cast<size_t>(c);
  uint32_t k0 = key[0], k1 = key[1], u0 = ku[0], u1 = ku[1];
  const int n_ends = *in(a.n_ends), end_at = *in(a.leaf_end_at);
  for (int j = 0; j < n_ends; ++j) {
    if (end_at == j + 1) wt::threefry2x32(k0, k1, 0u, 1u, u0, u1);
    wt::threefry2x32(k0, k1, 0u, 0u, k0, k1);
  }

  if (!pend) {  // no leaf to resolve: only the replay is written
    __syncwarp();
    if (lane == 0) {
      key[0] = k0;
      key[1] = k1;
      ku[0] = u0;
      ku[1] = u1;
      *in(a.n_ends) = 0;
      *in(a.leaf_end_at) = 0;
    }
    return;
  }

  const T* fth = rw(a.fwd_th);
  const T* frho = rw(a.fwd_rho);
  const T* fgr = rw(a.fwd_grad);
  const T* im = rw(a.inv_mass);
  T* stack = static_cast<T*>(a.stack_e) + row * n_slots * 2;
  const T sgn = forward ? T(1) : T(-1);

  // ---- merge cascade: sub-U-turn checks against the stacked endpoints;
  // end_slot is the slot that becomes the merged span's endpoint (-1: the
  // leaf itself)
  const int leaf_idx = *in(a.leaf_idx);
  const int n_merges = __ffs(leaf_idx + 1) - 1;
  bool leaf_ok = leaf_ok_in, ok = true;
  int end_slot = -1;
  if (leaf_ok) {
    for (int i = 0; i < n_slots && i < n_merges && ok; ++i) {
      const T* sth = stack + static_cast<size_t>(2 * i) * D;
      ok = !uturn(fth, frho, sth, sth + D, im, sgn, D, lane);
      end_slot = i;
    }
  }
  const bool leaf_fail = !leaf_ok_in;
  const bool sub_uturn = leaf_ok && !ok;
  leaf_ok = leaf_ok && ok;

  // ---- the three leaf uniforms, from the resolving leaf's subkey ----
  const T u_res = leaf_uniform<T>(u0, u1, 0u);
  const T u_met = leaf_uniform<T>(u0, u1, 1u);
  const T u_dir = leaf_uniform<T>(u0, u1, 2u);

  const int n_leaves = *in(a.n_leaves);
  const int new_leaf_idx = leaf_idx + 1;
  const bool subtree_done = leaf_ok && new_leaf_idx >= n_leaves;
  const bool push = leaf_ok && !subtree_done;

  // reservoir (streaming Barker)
  const T fwd_joint = *fl(a.fwd_joint);
  const T run_logw = *fl(a.run_logw);
  const T run_logw_new = log_sum_exp(run_logw, fwd_joint);
  const bool upd = leaf_ok && (wt::wt_log(u_res) < fwd_joint - run_logw_new);

  // top-level Metropolis + combined U-turn on subtree completion
  T* acc_th_bk = rw(a.acc_th_bk);
  T* acc_rho_bk = rw(a.acc_rho_bk);
  T* acc_th_fw = rw(a.acc_th_fw);
  T* acc_rho_fw = rw(a.acc_rho_fw);
  const T acc_logw = *fl(a.acc_logw);
  bool ut_top = false;
  if (subtree_done)
    ut_top = forward
                 ? uturn(fth, frho, acc_th_bk, acc_rho_bk, im, sgn, D, lane)
                 : uturn(fth, frho, acc_th_fw, acc_rho_fw, im, sgn, D, lane);
  const bool take_new = wt::wt_log(u_met) < run_logw_new - acc_logw;
  const bool upd_fw = subtree_done && forward;
  const bool upd_bk = subtree_done && !forward;
  const bool take = subtree_done && take_new;
  const bool end_uturn = subtree_done && ut_top;
  const int depth = *in(a.depth);
  const int new_depth = depth + 1;
  const bool deeper = subtree_done && !ut_top && new_depth <= max_depth;
  const bool exhausted = subtree_done && !ut_top && new_depth > max_depth;

  const bool fail = leaf_fail || sub_uturn;
  const bool complete = fail || end_uturn || exhausted;
  const int out_depth =
      (fail || end_uturn) ? depth
                          : (exhausted ? max_depth + 1 : *in(a.out_depth));

  const T run_sel_logp = *fl(a.run_sel_logp);
  const T run_sel_logp_v = upd ? *fl(a.fwd_logp_pos) : run_sel_logp;
  const T sel_logp = take ? run_sel_logp_v : *fl(a.acc_lp_sel);

  const int new_draws_done = draws_done + (complete ? 1 : 0);
  const bool restart = complete && new_draws_done < a.block_draws;

  // ---- trajectory restart: 3-way split of the replayed key, momenta
  // ~ N(0, M) from subkey 1, the direction bit from subkey 2. rho0 goes
  // straight into acc_rho_bk, whose old value a restarting lane no
  // longer needs; the write loop below reads it back (same thread).
  uint32_t kn0 = k0, kn1 = k1;
  T joint0 = T(0);
  bool forward0 = false;
  if (restart) {
    uint32_t s10, s11, s20, s21;
    wt::threefry2x32(k0, k1, 0u, 0u, kn0, kn1);
    wt::threefry2x32(k0, k1, 0u, 1u, s10, s11);
    wt::threefry2x32(k0, k1, 0u, 2u, s20, s21);
    T energy = T(0);
    for (int d = lane; d < D; d += 32) {
      uint32_t x0, x1;
      wt::threefry2x32(s10, s11, 0u, static_cast<uint32_t>(d), x0, x1);
      const T rho0 = wt::normal_from_bits<T>(x0, x1) / wt::wt_sqrt(im[d]);
      acc_rho_bk[d] = rho0;
      energy += im[d] * (rho0 * rho0);
    }
    joint0 = sel_logp + T(-0.5) * warp_sum(energy);
    forward0 = leaf_uniform<T>(s20, s21, 0u) < T(0.5);
  }

  const bool cont_m = !complete;  // pending here
  const bool rc = restart || cont_m;
  const bool new_dir = restart ? forward0 : (deeper ? u_dir < T(0.5) : forward);

  // ---- rows ----
  T* acc_th_sel = rw(a.acc_th_sel);
  T* acc_grad_bk = rw(a.acc_grad_bk);
  T* acc_grad_sel = rw(a.acc_grad_sel);
  T* acc_grad_fw = rw(a.acc_grad_fw);
  T* run_sel = rw(a.run_sel);
  T* run_sel_grad = rw(a.run_sel_grad);
  T* ms_th = rw(a.ms_th);
  T* ms_rho = rw(a.ms_rho);
  T* ms_grad = rw(a.ms_grad);
  T* cur_th = rw(a.cur_th);
  T* cur_rho = rw(a.cur_rho);
  T* cur_grad = rw(a.cur_grad);
  const int bank = min(max(new_draws_done - 1, 0), a.block_draws - 1);
  T* draw = static_cast<T*>(a.draws) +
            (static_cast<size_t>(bank) * a.chains + c) * D;
  T* push_to = stack + static_cast<size_t>(2 * n_merges) * D;
  const T* push_from =
      end_slot < 0 ? nullptr : stack + static_cast<size_t>(2 * end_slot) * D;
  const bool do_push = push && n_merges < n_slots;
  for (int d = lane; d < D; d += 32) {
    const T f_th = fth[d], f_rho = frho[d], f_gr = fgr[d];
    const T rs_v = upd ? f_th : run_sel[d];
    const T rsg_v = upd ? f_gr : run_sel_grad[d];
    const T o_sel = acc_th_sel[d], o_gsel = acc_grad_sel[d];
    const T s_th = take ? rs_v : o_sel;
    const T s_gr = take ? rsg_v : o_gsel;
    const T r0 = acc_rho_bk[d];  // rho0 on a restart
    const T n_gfw = restart ? s_gr : (upd_fw ? f_gr : acc_grad_fw[d]);
    const T n_gbk = restart ? s_gr : (upd_bk ? f_gr : acc_grad_bk[d]);
    const T n_gsel = (restart || take) ? s_gr : o_gsel;
    const T n_bk_th = restart ? s_th : (upd_bk ? f_th : acc_th_bk[d]);
    const T n_bk_rho = restart ? r0 : (upd_bk ? f_rho : r0);
    const T n_fw_th = restart ? s_th : (upd_fw ? f_th : acc_th_fw[d]);
    const T n_fw_rho = restart ? r0 : (upd_fw ? f_rho : acc_rho_fw[d]);
    const T n_sel = (restart || take) ? s_th : o_sel;
    const T e_th = new_dir ? n_fw_th : n_bk_th;
    const T e_rho = new_dir ? n_fw_rho : n_bk_rho;
    const T e_gr = new_dir ? n_gfw : n_gbk;
    const T n_ms_th =
        restart ? s_th : (deeper ? e_th : (push ? f_th : ms_th[d]));
    const T n_ms_rho =
        restart ? r0 : (deeper ? e_rho : (push ? f_rho : ms_rho[d]));
    const T n_ms_gr =
        restart ? s_gr : (deeper ? e_gr : (push ? f_gr : ms_grad[d]));
    if (do_push) {
      const T end_th = push_from ? push_from[d] : f_th;
      const T end_rho = push_from ? push_from[D + d] : f_rho;
      push_to[d] = end_th;
      push_to[D + d] = end_rho;
    }
    if (complete) draw[d] = s_th;
    acc_grad_fw[d] = n_gfw;
    acc_grad_bk[d] = n_gbk;
    acc_grad_sel[d] = n_gsel;
    acc_th_bk[d] = n_bk_th;
    acc_rho_bk[d] = n_bk_rho;
    acc_th_fw[d] = n_fw_th;
    acc_rho_fw[d] = n_fw_rho;
    acc_th_sel[d] = n_sel;
    run_sel[d] = restart ? s_th : rs_v;
    run_sel_grad[d] = restart ? s_gr : rsg_v;
    ms_th[d] = n_ms_th;
    ms_rho[d] = n_ms_rho;
    ms_grad[d] = n_ms_gr;
    if (rc) {
      cur_th[d] = n_ms_th;
      cur_rho[d] = n_ms_rho;
      cur_grad[d] = n_ms_gr;
    }
  }
  __syncwarp();
  if (lane != 0) return;

  // ---- per-lane scalars ----
  const T fwd_joint_v = fwd_joint;
  const T step = *fl(a.step);
  const int min_micro = *in(a.min_micro);
  const T acc_jt_bk = restart ? joint0 : (upd_bk ? fwd_joint_v : *fl(a.acc_jt_bk));
  const T acc_jt_fw = restart ? joint0 : (upd_fw ? fwd_joint_v : *fl(a.acc_jt_fw));
  const T acc_lp_sel = (restart || take) ? sel_logp : *fl(a.acc_lp_sel);
  const T acc_logw_n =
      restart ? joint0
              : (subtree_done ? log_sum_exp(acc_logw, run_logw_new) : acc_logw);
  const T acc_end_joint = new_dir ? acc_jt_fw : acc_jt_bk;
  const T ms_joint =
      restart ? joint0
              : (deeper ? acc_end_joint : (push ? fwd_joint_v : *fl(a.ms_joint)));
  if (complete) {
    const size_t at = static_cast<size_t>(bank) * a.chains + c;
    static_cast<T*>(a.logps)[at] = sel_logp;
    static_cast<int32_t*>(a.depths)[at] = out_depth;
  }
  *fl(a.acc_jt_bk) = acc_jt_bk;
  *fl(a.acc_jt_fw) = acc_jt_fw;
  *fl(a.acc_lp_sel) = acc_lp_sel;
  *fl(a.acc_logw) = acc_logw_n;
  *fl(a.ms_joint) = ms_joint;
  *fl(a.run_sel_logp) = restart ? sel_logp : run_sel_logp_v;
  *fl(a.run_logw) = (restart || deeper)
                        ? -INFINITY
                        : (leaf_ok ? run_logw_new : run_logw);
  const T dt_cont = new_dir ? step : -step;
  if (restart)
    *fl(a.dt) = forward0 ? step : -step;
  else if (cont_m)
    *fl(a.dt) = dt_cont;
  if (restart) *fl(a.lp_cur) = sel_logp;

  *in(a.depth) = restart ? 1 : (deeper ? new_depth : depth);
  *in(a.out_depth) = restart ? max_depth + 1 : out_depth;
  *in(a.leaf_idx) =
      (restart || deeper) ? 0 : (leaf_ok ? new_leaf_idx : leaf_idx);
  *in(a.n_leaves) = restart ? 1 : (deeper ? (1 << (new_depth - 1)) : n_leaves);
  if (rc) {
    *in(a.halvings) = 0;
    *in(a.steps_done) = 0;
    *in(a.steps_total) = min_micro;
    *in(a.phase) = kPhFwd;
  }
  *in(a.n_ends) = 0;
  *in(a.leaf_end_at) = 0;
  *in(a.n_depth_exhausted) += exhausted ? 1 : 0;
  *in(a.draws_done) = new_draws_done;
  *bo(a.forward) = new_dir;
  *bo(a.leaf_done) = false;
  *bo(a.leaf_ok) = false;
  key[0] = restart ? kn0 : k0;
  key[1] = restart ? kn1 : k1;
  ku[0] = u0;
  ku[1] = u1;
}

}  // namespace

extern "C" int wt_fused_pass_args_size() {
  return static_cast<int>(sizeof(FusedPassArgs));
}

extern "C" int wt_fused_pass(const void* args, void* stream) {
  const FusedPassArgs& a = *static_cast<const FusedPassArgs*>(args);
  if (a.chains <= 0 || a.dim <= 0 || a.n_slots <= 0 || a.block_draws <= 0 ||
      a.chains_per_block < 1 || a.chains_per_block > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a.chains + a.chains_per_block - 1) / a.chains_per_block;
  const int threads = 32 * a.chains_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.is_double)
    fused_pass_kernel<double><<<blocks, threads, 0, s>>>(a);
  else
    fused_pass_kernel<float><<<blocks, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
