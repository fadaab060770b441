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
// What bounds it on the H100: not the bytes (at most ~5 MB at 4096 chains
// and D = 25 in float32, 1.5 us at 3.35 TB/s; chip_smoke.py counts the
// bytes a given state needs) but the chain of dependent steps of the
// slowest chain, and the integer pipe: the replay's n_ends <= 12 rounds of
// two threefry hashes (~70 integer instructions each, dispatched at half a
// warp instruction a cycle), the three uniforms, the restart's splits. A
// warp that runs one chain's hashes on all 32 lanes pays 32 times the
// instruction slots: at 8 warps a scheduler that, not latency, limits a
// kernel that runs a warp a chain (PERF.md, the kernel table).
//
// Design: a block of W chains (chains_per_block, one warp each), whose
// scalar work runs one chain a lane on warp 0, the block's control lanes,
// and whose rows run one chain a warp, feature d of a chunk of 32 on lane d:
//
//   1. the control lanes load their chains' replay operands into registers
//      and the other 25 per-lane scalars into shared memory (cp.async):
//      coalesced across the block's chains;
//   2. every warp loads the few scalars its chain's rows depend on, then
//      requests every row the pass may read (the leaf's three rows,
//      inv_mass, the four orbit endpoints, the nine rows the writes merge
//      with, the min(n_merges, n_slots) stack slots of the cascade) by 4- or
//      8-byte cp.async into its shared memory: 100-byte rows at D = 25 are
//      not 16-byte aligned;
//   3. the control lanes run the replay (wt::replay_chain, shared with
//      kernel 1: both subkeys hashed each round as two independent chains,
//      then a select), the three leaf uniforms, the restart's 3-way split
//      and its direction bit, while the rows are in flight;
//   4. each pending warp takes the cascade's U-turn sums of every slot it
//      reads and the top check's in one multi-value shuffle reduction; the
//      first failing slot is end_slot, as the serial early exit gives it.
//      Each sum runs per lane over d = lane, lane + 32, ..., then a fixed
//      xor tree, so the flags, and through them every integer, repeat bit
//      for bit;
//   5. (barrier) the control lanes take every chain's decisions;
//   6. (barrier) each pending warp writes its rows from shared memory, a
//      restart's normals computed feature by feature, and sums the
//      momentum energy;
//   7. (barrier) the control lanes store every chain's scalars, coalesced.
//
// At 64 registers a thread (the launch bound) all 4096 chains of the main
// path are resident at once. Widths above 32 take the rows in chunks of 32
// features: chunk 0 stays in shared memory from step 2 on, later chunks pass
// through a second buffer in steps 4 and 6, the sums carried across chunks
// in the same order. The B-deep banking ring of the TPU kernel is not
// carried over: a completing lane writes its draw straight into the output
// at its draw index.
//
// Numbers: built with -fmad=false so that the normals' polynomials and
// u * (hi - lo) + lo round each step as PyTorch does, and with the IEEE
// logf/expf/log1pf/sqrtf. Integers, flags and keys equal the plain version
// lane by lane; floats that come from sums (the U-turn dot products, the
// momentum energy of a restart) differ from PyTorch's by summation order.
//
// An optional trace (C, 11) int64 records, per chain, the card's clock at
// entry and exit, the SM, and the SM's cycle count at each mark (Mark);
// the traced kernel is its own instantiation.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

// The operands, in the order of walnuts_tpu_torch/ops/fused_pass.py's
// _POINTERS: the 28 per-lane scalars first, so that lane i of a warp loads
// scalar i (lanes 28 to 31 load the key words).
enum Ptr : int {
  // read-write per-lane floats (C,)
  kRunSelLogp, kRunLogw, kMsJoint, kDt, kLpCur, kAccJtBk, kAccJtFw,
  kAccLpSel, kAccLogw,
  // read-only per-lane floats (C,)
  kFwdLogpPos, kFwdJoint, kStep,
  // read-write per-lane int32 (C,)
  kDepth, kOutDepth, kLeafIdx, kNLeaves, kHalvings, kStepsDone, kStepsTotal,
  kPhase, kNEnds, kLeafEndAt, kNDepthExhausted, kDrawsDone,
  // read-only per-lane int32 (C,)
  kMinMicro,
  // read-write per-lane bool (C,)
  kForward, kLeafDone, kLeafOk,
  // read-write key data (C, 2), int32 bit patterns of uint32 words
  kKey, kKu,
  // read-write rows (C, D)
  kAccThBk, kAccRhoBk, kAccThFw, kAccRhoFw, kAccThSel, kAccGradBk,
  kAccGradSel, kAccGradFw, kRunSel, kRunSelGrad, kMsTh, kMsRho, kMsGrad,
  kCurTh, kCurRho, kCurGrad,
  // read-write merge stack (C, n_slots, 2, D)
  kStackE,
  // read-only rows (C, D)
  kFwdTh, kFwdRho, kFwdGrad, kInvMass,
  // the block's output: draws (R, C, D), logps (R, C), depths (R, C) int32
  kDraws, kLogps, kDepths,
  kPointers
};

// Must match walnuts_tpu_torch/ops/fused_pass.py::FusedPassArgs field by
// field (the wrapper compares sizeof).
struct FusedPassArgs {
  void* p[kPointers];
  // (C, 11) int64 or null: per chain the card's clock (ns) at entry and
  // exit, its SM, and the SM's cycle count at entry and after each phase
  long long* trace;
  int chains, dim, n_slots, max_depth, block_draws, cap, chains_per_block,
      is_double;
};

constexpr int kPhFwd = 0;  // core/transition.py _PH_FWD
constexpr unsigned kFull = 0xffffffffu;

// The rows a warp stages in shared memory, 32 features each: the leaf's,
// inv_mass, the orbit's endpoints, the rows the writes merge with, then
// the stack slots' (position, momentum) pairs.
enum Row : int {
  kRFth, kRFrho, kRFgr, kRIm, kRThBk, kRRhoBk, kRThFw, kRRhoFw, kRThSel,
  kRGrBk, kRGrSel, kRGrFw, kRRunSel, kRRunSelGr, kRMsTh, kRMsRho, kRMsGr,
  kRSlots
};

__device__ __forceinline__ constexpr int row_ptr(int r) {
  return r == kRFth ? kFwdTh : r == kRFrho ? kFwdRho : r == kRFgr ? kFwdGrad
       : r == kRIm ? kInvMass : r == kRThBk ? kAccThBk
       : r == kRRhoBk ? kAccRhoBk
       : r == kRThFw ? kAccThFw : r == kRRhoFw ? kAccRhoFw
       : r == kRThSel ? kAccThSel : r == kRGrBk ? kAccGradBk
       : r == kRGrSel ? kAccGradSel : r == kRGrFw ? kAccGradFw
       : r == kRRunSel ? kRunSel : r == kRRunSelGr ? kRunSelGrad
       : r == kRMsTh ? kMsTh : r == kRMsRho ? kMsRho : kMsGrad;
}

// Slots of the cascade summed in one reduction.
constexpr int kGroup = 4;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
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

// Copy one element into shared memory without a register: 4 or 8 bytes.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(to), "l"(src), "n"(sizeof(T)) : "memory");
}

// Wait for this thread's copies.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// The trace: per chain the card's clock (ns) at entry and exit, the SM,
// and the SM's cycle count at each mark: entry, the chain's scalars in,
// its rows' U-turn sums done, the block's replay done (its control lane),
// the decisions, the rows written, the tail.
constexpr int kTraceCols = 11;
enum Mark : int { kMEntry, kMScalars, kMCascade, kMReplay, kMDecide, kMRows,
                  kMTail, kMarks };

// The SM's cycle count into mark k of a trace row once `dep` is known: the
// branch on it makes the count wait for the step that computed it.
__device__ __forceinline__ void mark(long long* row, int k, uint32_t dep) {
  if (dep == 0x9E3779B9u) row[3 + kMarks] = -1;  // column 10: never read
  row[3 + k] = clock64();
}

// The decisions a chain's warp needs from its control lane, as bits.
enum Flag : int { kFUpd = 1, kFTake = 2, kFUpdFw = 4, kFUpdBk = 8,
                  kFDeeper = 16, kFPush = 32, kFRestart = 64,
                  kFComplete = 128, kFNewDir = 256, kFExhausted = 512,
                  kFLeafOk = 1024, kFSubtree = 2048 };

// What a block's control lanes and its chains' warps exchange, one column
// a chain.
template <typename T>
struct Ctl {
  T f[kDepth][32];                   // the float scalars, by cp.async
  int32_t i[kForward - kDepth][32];  // the int32 scalars, by cp.async
  uint32_t s1[2][32];  // control -> warp: the restart's momentum subkey
  int32_t cascade[32];  // warp -> control: first failing slot + 1, top << 16
  int32_t flags[32];    // control -> warp: the decisions (Flag)
  int32_t bank[32];     // control -> warp: the draw index banked at
  T energy[32];         // warp -> control: the restart's momentum energy
};

template <typename T>
__host__ __device__ constexpr size_t ctl_bytes() {
  return (sizeof(Ctl<T>) + 15) / 16 * 16;
}

template <typename T, bool kTrace>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 1024 : 512, 1)
    fused_pass_kernel(const __grid_constant__ FusedPassArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ctl<T>& ctl = *reinterpret_cast<Ctl<T>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;  // the block's chains
  const int c = blockIdx.x * W + warp;  // this warp's chain
  const bool live = c < a.chains;
  // lane i of warp 0 is the control lane of the block's chain i
  const int cc = blockIdx.x * W + lane;
  const bool is_ctl = warp == 0 && lane < W && cc < a.chains;
  const int D = a.dim, n_slots = a.n_slots, max_depth = a.max_depth;
  const size_t row = static_cast<size_t>(c) * D;
  long long* tr =
      kTrace && live ? a.trace + static_cast<size_t>(kTraceCols) * c : nullptr;
  long long* tr_ctl = kTrace && is_ctl
                          ? a.trace + static_cast<size_t>(kTraceCols) * cc
                          : nullptr;
  if (kTrace && live && lane == 0) {
    tr[0] = global_ns();
    tr[2] = sm_id();
    mark(tr, kMEntry, 0u);
  }

  // ---- 1. control: the block's chains' scalars, one chain a lane: the
  // replay's operands into registers, the rest into shared memory ----
  uint32_t k0 = 0u, k1 = 0u, u0 = 0u, u1 = 0u;
  int n_ends = 0, end_at = 0;
  bool c_fwd = false, c_done = false, c_ok = false;
  if (is_ctl) {
    const size_t w = 2 * static_cast<size_t>(cc);
    const uint32_t* key = static_cast<const uint32_t*>(a.p[kKey]) + w;
    const uint32_t* ku = static_cast<const uint32_t*>(a.p[kKu]) + w;
    k0 = key[0];
    k1 = key[1];
    u0 = ku[0];
    u1 = ku[1];
    n_ends = static_cast<const int32_t*>(a.p[kNEnds])[cc];
    end_at = static_cast<const int32_t*>(a.p[kLeafEndAt])[cc];
    c_fwd = static_cast<const uint8_t*>(a.p[kForward])[cc] != 0;
    c_done = static_cast<const uint8_t*>(a.p[kLeafDone])[cc] != 0;
    c_ok = static_cast<const uint8_t*>(a.p[kLeafOk])[cc] != 0;
#pragma unroll
    for (int k = 0; k < kDepth; ++k)
      cp_async(&ctl.f[k][lane], static_cast<const T*>(a.p[k]) + cc);
#pragma unroll
    for (int k = kDepth; k < kForward; ++k)
      cp_async(&ctl.i[k - kDepth][lane],
               static_cast<const int32_t*>(a.p[k]) + cc);
  }

  // ---- 2. every warp: the scalars its chain's rows depend on (each lane
  // loads the same words), then every row the pass may read, chunk 0 into
  // buffer A by cp.async ----
  bool pend = false, leaf_ok_in = false, forward = false;
  int leaf_idx = 0, n_leaves = 1;
  if (live) {
    const int draws_done = static_cast<const int32_t*>(a.p[kDrawsDone])[c];
    const bool leaf_done = static_cast<const uint8_t*>(a.p[kLeafDone])[c] != 0;
    leaf_ok_in = static_cast<const uint8_t*>(a.p[kLeafOk])[c] != 0;
    forward = static_cast<const uint8_t*>(a.p[kForward])[c] != 0;
    leaf_idx = static_cast<const int32_t*>(a.p[kLeafIdx])[c];
    n_leaves = static_cast<const int32_t*>(a.p[kNLeaves])[c];
    pend = draws_done < a.cap && leaf_done;
  }
  // the cascade's merges: the trailing-zero count of the 1-based leaf index
  const int n_merges = __ffs(leaf_idx + 1) - 1;
  const int nm = leaf_ok_in ? min(n_merges, n_slots) : 0;  // slots it reads
  // the top U-turn check runs if the cascade passes on the subtree's last
  // leaf; its sums are taken beside the cascade's
  const bool top_cand = leaf_ok_in && leaf_idx + 1 >= n_leaves;
  if (kTrace && live && lane == 0)
    mark(tr, kMScalars, pend + 2u * nm + 8u * top_cand);

  const int rows_n = kRSlots + 2 * n_slots;
  const int chunks = (D + 31) >> 5;
  T* buf_a = reinterpret_cast<T*>(smem_raw + ctl_bytes<T>()) +
             static_cast<size_t>(warp) * (chunks > 1 ? 2 : 1) * rows_n * 32;
  T* buf_b = buf_a + rows_n * 32;  // later chunks, when D > 32
  const T* stack = static_cast<const T*>(a.p[kStackE]) + row * n_slots * 2;
  auto stage = [&](T* buf, int d, bool fixed, int slot0, int slots) {
    if (fixed) {
#pragma unroll
      for (int r = 0; r < kRSlots; ++r)
        cp_async(buf + r * 32 + lane,
                 static_cast<const T*>(a.p[row_ptr(r)]) + row + d);
    }
    for (int i = 2 * slot0; i < 2 * (slot0 + slots); ++i)
      cp_async(buf + (kRSlots + i) * 32 + lane,
               stack + static_cast<size_t>(i) * D + d);
  };
  if (pend && lane < D) stage(buf_a, lane, true, 0, nm);

  // ---- 3. control: the replay (wt::replay_chain, kernel 1's), the leaf's
  // three uniforms and the restart's 3-way split and direction bit, of
  // every chain of the block, while the rows are in flight ----
  uint32_t kn0 = 0u, kn1 = 0u;
  bool forward0 = false;
  T u_res = T(0), u_met = T(0), u_dir = T(0);
  if (is_ctl) {
    wt::replay_chain(k0, k1, u0, u1, n_ends, end_at);
    u_res = leaf_uniform<T>(u0, u1, 0u);
    u_met = leaf_uniform<T>(u0, u1, 1u);
    u_dir = leaf_uniform<T>(u0, u1, 2u);
    uint32_t s20, s21;
    wt::threefry2x32(k0, k1, 0u, 0u, kn0, kn1);
    wt::threefry2x32(k0, k1, 0u, 1u, ctl.s1[0][lane], ctl.s1[1][lane]);
    wt::threefry2x32(k0, k1, 0u, 2u, s20, s21);
    forward0 = leaf_uniform<T>(s20, s21, 0u) < T(0.5);
    if (kTrace) mark(tr_ctl, kMReplay, kn0 ^ u0 ^ forward0);
  }

  // ---- 4. every pending warp: the cascade's and the top check's U-turn
  // sums, reduced together: slot i's span is checked against the leaf
  // (fth, frho), the top check against the orbit's older end: per lane
  // over d = lane, lane + 32, ..., then the xor tree ----
  cp_async_wait();  // this thread's copies: its rows, a control lane's scalars
  const T sgn = forward ? T(1) : T(-1);
  const int top_th = forward ? kRThBk : kRThFw;
  int first_fail = -1;
  bool ut_top = false;
  for (int g = 0; pend && (nm > 0 || top_cand); g += kGroup) {
    const bool top = g == 0 && top_cand;
    T sa[kGroup], sb[kGroup], ta = T(0), tb = T(0);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) sa[i] = sb[i] = T(0);
    for (int j = 0; j < chunks; ++j) {
      const int d = 32 * j + lane;
      const T* buf = buf_a;
      if (j > 0) {
        if (d < D) {
          cp_async(buf_b + kRFth * 32 + lane,
                   static_cast<const T*>(a.p[kFwdTh]) + row + d);
          cp_async(buf_b + kRFrho * 32 + lane,
                   static_cast<const T*>(a.p[kFwdRho]) + row + d);
          cp_async(buf_b + kRIm * 32 + lane,
                   static_cast<const T*>(a.p[kInvMass]) + row + d);
          if (top)
            for (int r = top_th; r < top_th + 2; ++r)
              cp_async(buf_b + r * 32 + lane,
                       static_cast<const T*>(a.p[row_ptr(r)]) + row + d);
          stage(buf_b, d, false, g, min(kGroup, nm - g));
        }
        cp_async_wait();
        buf = buf_b;
      }
      if (d < D) {
        const T fth = buf[kRFth * 32 + lane], frho = buf[kRFrho * 32 + lane];
        const T sim = sgn * buf[kRIm * 32 + lane];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (g + i < nm) {
            const T oth = buf[(kRSlots + 2 * (g + i)) * 32 + lane];
            const T orho = buf[(kRSlots + 2 * (g + i) + 1) * 32 + lane];
            const T delta = sim * (fth - oth);
            sa[i] += frho * delta;
            sb[i] += orho * delta;
          }
        }
        if (top) {
          const T oth = buf[top_th * 32 + lane];
          const T orho = buf[(top_th + 1) * 32 + lane];
          const T delta = sim * (fth - oth);
          ta += frho * delta;
          tb += orho * delta;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        sa[i] += __shfl_xor_sync(kFull, sa[i], off);
        sb[i] += __shfl_xor_sync(kFull, sb[i], off);
      }
      ta += __shfl_xor_sync(kFull, ta, off);
      tb += __shfl_xor_sync(kFull, tb, off);
    }
#pragma unroll
    for (int i = kGroup - 1; i >= 0; --i)
      if (g + i < nm && (sa[i] < T(0) || sb[i] < T(0))) first_fail = g + i;
    if (g == 0) ut_top = ta < T(0) || tb < T(0);
    if (first_fail >= 0 || g + kGroup >= nm) break;
  }
  // end_slot: the slot that becomes the merged span's endpoint (-1: the
  // leaf itself), the last one checked
  const int end_slot = nm == 0 ? -1 : (first_fail < 0 ? nm - 1 : first_fail);
  if (live && lane == 0) {
    ctl.cascade[warp] = (first_fail + 1) | (ut_top ? 1 << 16 : 0);
    if (kTrace) mark(tr, kMCascade, end_slot + 1);
  }
  __syncthreads();

  // ---- 5. control: the decisions of every pending chain, one a lane ----
  auto cf = [&](int k) { return ctl.f[k][lane]; };
  auto ci = [&](int k) { return ctl.i[k - kDepth][lane]; };
  const bool c_pend = is_ctl && ci(kDrawsDone) < a.cap && c_done;
  int flags = 0, out_depth = 0, new_draws_done = 0;
  T sel_logp = T(0), run_sel_logp_v = T(0), run_logw_new = T(0);
  if (c_pend) {
    const int casc = ctl.cascade[lane];
    const bool ok = (casc & 0xffff) == 0;
    const bool c_ut_top = (casc >> 16) != 0;
    const bool leaf_fail = !c_ok;
    const bool sub_uturn = c_ok && !ok;
    const bool leaf_ok = c_ok && ok;
    const bool subtree_done = leaf_ok && ci(kLeafIdx) + 1 >= ci(kNLeaves);
    const bool push = leaf_ok && !subtree_done;

    // reservoir (streaming Barker)
    const T fwd_joint = cf(kFwdJoint);
    run_logw_new = log_sum_exp(cf(kRunLogw), fwd_joint);
    const bool upd = leaf_ok && (wt::wt_log(u_res) < fwd_joint - run_logw_new);

    // top-level Metropolis + combined U-turn on subtree completion
    const bool take_new = wt::wt_log(u_met) < run_logw_new - cf(kAccLogw);
    const bool upd_fw = subtree_done && c_fwd;
    const bool upd_bk = subtree_done && !c_fwd;
    const bool take = subtree_done && take_new;
    const bool end_uturn = subtree_done && c_ut_top;
    const int depth = ci(kDepth);
    const bool deeper = subtree_done && !c_ut_top && depth + 1 <= max_depth;
    const bool exhausted = subtree_done && !c_ut_top && depth + 1 > max_depth;

    const bool fail = leaf_fail || sub_uturn;
    const bool complete = fail || end_uturn || exhausted;
    out_depth = (fail || end_uturn)
                    ? depth
                    : (exhausted ? max_depth + 1 : ci(kOutDepth));
    run_sel_logp_v = upd ? cf(kFwdLogpPos) : cf(kRunSelLogp);
    sel_logp = take ? run_sel_logp_v : cf(kAccLpSel);
    new_draws_done = ci(kDrawsDone) + (complete ? 1 : 0);
    const bool restart = complete && new_draws_done < a.block_draws;
    const bool new_dir =
        restart ? forward0 : (deeper ? u_dir < T(0.5) : c_fwd);
    flags = (upd ? kFUpd : 0) | (take ? kFTake : 0) | (upd_fw ? kFUpdFw : 0) |
            (upd_bk ? kFUpdBk : 0) | (deeper ? kFDeeper : 0) |
            (push ? kFPush : 0) | (restart ? kFRestart : 0) |
            (complete ? kFComplete : 0) | (new_dir ? kFNewDir : 0) |
            (exhausted ? kFExhausted : 0) | (leaf_ok ? kFLeafOk : 0) |
            (subtree_done ? kFSubtree : 0);
    ctl.flags[lane] = flags;
    ctl.bank[lane] = min(max(new_draws_done - 1, 0), a.block_draws - 1);
    if (kTrace) mark(tr_ctl, kMDecide, flags);
  }
  __syncthreads();

  // ---- 6. every pending warp: its rows, from shared memory; a restart's
  // momenta rho0 ~ N(0, M) from subkey 1, feature by feature ----
  if (pend) {
    const int fl = ctl.flags[warp];
    const bool upd = fl & kFUpd, take = fl & kFTake, upd_fw = fl & kFUpdFw,
               upd_bk = fl & kFUpdBk, deeper = fl & kFDeeper,
               push = fl & kFPush, restart = fl & kFRestart,
               complete = fl & kFComplete, new_dir = fl & kFNewDir;
    const bool rc = restart || !complete;
    const uint32_t s10 = ctl.s1[0][warp], s11 = ctl.s1[1][warp];
    auto rw = [&](int p) { return static_cast<T*>(a.p[p]) + row; };
    T* draw = static_cast<T*>(a.p[kDraws]) +
              (static_cast<size_t>(ctl.bank[warp]) * a.chains + c) * D;
    T* push_to = static_cast<T*>(a.p[kStackE]) + row * n_slots * 2 +
                 static_cast<size_t>(2 * n_merges) * D;
    const bool do_push = push && n_merges < n_slots;
    const int end_row = kRSlots + 2 * end_slot;
    T energy = T(0);
    for (int j = 0; j < chunks; ++j) {
      const int d = 32 * j + lane;
      const T* buf = buf_a;
      if (j > 0) {
        if (d < D) stage(buf_b, d, true, end_slot, do_push && end_slot >= 0);
        buf = buf_b;
      }
      T z = T(0);
      if (restart && d < D) {
        uint32_t x0, x1;
        wt::threefry2x32(s10, s11, 0u, static_cast<uint32_t>(d), x0, x1);
        z = wt::normal_from_bits<T>(x0, x1);
      }
      if (j > 0) cp_async_wait();
      if (d >= D) continue;
      auto at = [&](int r) { return buf[r * 32 + lane]; };
      T r0 = at(kRRhoBk);
      if (restart) {
        const T im = at(kRIm);
        r0 = z / wt::wt_sqrt(im);
        energy += im * (r0 * r0);
      }
      const T f_th = at(kRFth), f_rho = at(kRFrho), f_gr = at(kRFgr);
      const T rs_v = upd ? f_th : at(kRRunSel);
      const T rsg_v = upd ? f_gr : at(kRRunSelGr);
      const T o_sel = at(kRThSel), o_gsel = at(kRGrSel);
      const T s_th = take ? rs_v : o_sel;
      const T s_gr = take ? rsg_v : o_gsel;
      const T n_gfw = restart ? s_gr : (upd_fw ? f_gr : at(kRGrFw));
      const T n_gbk = restart ? s_gr : (upd_bk ? f_gr : at(kRGrBk));
      const T n_gsel = (restart || take) ? s_gr : o_gsel;
      const T n_bk_th = restart ? s_th : (upd_bk ? f_th : at(kRThBk));
      const T n_bk_rho = restart ? r0 : (upd_bk ? f_rho : r0);
      const T n_fw_th = restart ? s_th : (upd_fw ? f_th : at(kRThFw));
      const T n_fw_rho = restart ? r0 : (upd_fw ? f_rho : at(kRRhoFw));
      const T n_sel = (restart || take) ? s_th : o_sel;
      const T e_th = new_dir ? n_fw_th : n_bk_th;
      const T e_rho = new_dir ? n_fw_rho : n_bk_rho;
      const T e_gr = new_dir ? n_gfw : n_gbk;
      const T n_ms_th =
          restart ? s_th : (deeper ? e_th : (push ? f_th : at(kRMsTh)));
      const T n_ms_rho =
          restart ? r0 : (deeper ? e_rho : (push ? f_rho : at(kRMsRho)));
      const T n_ms_gr =
          restart ? s_gr : (deeper ? e_gr : (push ? f_gr : at(kRMsGr)));
      if (do_push) {
        push_to[d] = end_slot >= 0 ? at(end_row) : f_th;
        push_to[D + d] = end_slot >= 0 ? at(end_row + 1) : f_rho;
      }
      if (complete) draw[d] = s_th;
      rw(kAccGradFw)[d] = n_gfw;
      rw(kAccGradBk)[d] = n_gbk;
      rw(kAccGradSel)[d] = n_gsel;
      rw(kAccThBk)[d] = n_bk_th;
      rw(kAccRhoBk)[d] = n_bk_rho;
      rw(kAccThFw)[d] = n_fw_th;
      rw(kAccRhoFw)[d] = n_fw_rho;
      rw(kAccThSel)[d] = n_sel;
      rw(kRunSel)[d] = restart ? s_th : rs_v;
      rw(kRunSelGrad)[d] = restart ? s_gr : rsg_v;
      rw(kMsTh)[d] = n_ms_th;
      rw(kMsRho)[d] = n_ms_rho;
      rw(kMsGrad)[d] = n_ms_gr;
      if (rc) {
        rw(kCurTh)[d] = n_ms_th;
        rw(kCurRho)[d] = n_ms_rho;
        rw(kCurGrad)[d] = n_ms_gr;
      }
    }
    if (restart) energy = warp_sum(energy);
    if (lane == 0) {
      ctl.energy[warp] = energy;
      if (kTrace) mark(tr, kMRows, energy < T(0));
    }
  }
  __syncthreads();

  // ---- 7. control: every chain's scalars stored, one chain a lane ----
  if (!is_ctl) return;
  auto fst = [&](int p, T v) { static_cast<T*>(a.p[p])[cc] = v; };
  auto ist = [&](int p, int v) { static_cast<int32_t*>(a.p[p])[cc] = v; };
  const size_t w = 2 * static_cast<size_t>(cc);
  uint32_t* key = static_cast<uint32_t*>(a.p[kKey]) + w;
  uint32_t* ku = static_cast<uint32_t*>(a.p[kKu]) + w;
  ku[0] = u0;
  ku[1] = u1;
  ist(kNEnds, 0);
  ist(kLeafEndAt, 0);
  if (c_pend) {
    const bool take = flags & kFTake, upd_fw = flags & kFUpdFw,
               upd_bk = flags & kFUpdBk, deeper = flags & kFDeeper,
               push = flags & kFPush, restart = flags & kFRestart,
               complete = flags & kFComplete, new_dir = flags & kFNewDir;
    const bool leaf_ok = flags & kFLeafOk, subtree_done = flags & kFSubtree;
    const bool rc = restart || !complete;
    const T joint0 =
        restart ? sel_logp + T(-0.5) * ctl.energy[lane] : T(0);
    const T fwd_joint = cf(kFwdJoint), step = cf(kStep);
    const T acc_jt_bk = restart ? joint0 : (upd_bk ? fwd_joint : cf(kAccJtBk));
    const T acc_jt_fw = restart ? joint0 : (upd_fw ? fwd_joint : cf(kAccJtFw));
    const T acc_logw = cf(kAccLogw);
    const int depth = ci(kDepth), new_depth = depth + 1;
    const int leaf_idx_c = ci(kLeafIdx), bank = ctl.bank[lane];
    if (complete) {
      const size_t at = static_cast<size_t>(bank) * a.chains + cc;
      static_cast<T*>(a.p[kLogps])[at] = sel_logp;
      static_cast<int32_t*>(a.p[kDepths])[at] = out_depth;
    }
    fst(kAccJtBk, acc_jt_bk);
    fst(kAccJtFw, acc_jt_fw);
    fst(kAccLpSel, (restart || take) ? sel_logp : cf(kAccLpSel));
    fst(kAccLogw, restart ? joint0
                          : (subtree_done ? log_sum_exp(acc_logw, run_logw_new)
                                          : acc_logw));
    fst(kMsJoint, restart ? joint0
                          : (deeper ? (new_dir ? acc_jt_fw : acc_jt_bk)
                                    : (push ? fwd_joint : cf(kMsJoint))));
    fst(kRunSelLogp, restart ? sel_logp : run_sel_logp_v);
    fst(kRunLogw, (restart || deeper)
                      ? T(-INFINITY)
                      : (leaf_ok ? run_logw_new : cf(kRunLogw)));
    if (rc) fst(kDt, new_dir ? step : -step);
    if (restart) fst(kLpCur, sel_logp);
    ist(kDepth, restart ? 1 : (deeper ? new_depth : depth));
    ist(kOutDepth, restart ? max_depth + 1 : out_depth);
    ist(kLeafIdx,
        (restart || deeper) ? 0 : (leaf_ok ? leaf_idx_c + 1 : leaf_idx_c));
    ist(kNLeaves,
        restart ? 1 : (deeper ? (1 << (new_depth - 1)) : ci(kNLeaves)));
    if (rc) {
      ist(kHalvings, 0);
      ist(kStepsDone, 0);
      ist(kStepsTotal, ci(kMinMicro));
      ist(kPhase, kPhFwd);
    }
    ist(kNDepthExhausted,
        ci(kNDepthExhausted) + ((flags & kFExhausted) ? 1 : 0));
    ist(kDrawsDone, new_draws_done);
    static_cast<bool*>(a.p[kForward])[cc] = new_dir;
    static_cast<bool*>(a.p[kLeafDone])[cc] = false;
    static_cast<bool*>(a.p[kLeafOk])[cc] = false;
    key[0] = restart ? kn0 : k0;
    key[1] = restart ? kn1 : k1;
  } else {
    key[0] = k0;
    key[1] = k1;
  }
  if (kTrace) {
    mark(tr_ctl, kMTail, 0u);
    tr_ctl[1] = global_ns();
  }
}

}  // namespace

// The launch: blocks of chains_per_block chains (fewer where the control
// data and the staged rows would not fit a block's shared memory).
template <typename T, bool kTrace>
static cudaError_t launch_pass(const FusedPassArgs& a, cudaStream_t s) {
  constexpr size_t kSmemMax = 232448;  // 227 KB: the H100's block limit
  constexpr int kMaxTile = sizeof(T) == 4 ? 32 : 16;  // the launch bound
  const size_t per_warp = static_cast<size_t>(a.dim > 32 ? 2 : 1) *
                          (kRSlots + 2 * a.n_slots) * 32 * sizeof(T);
  int tile = a.chains_per_block < kMaxTile ? a.chains_per_block : kMaxTile;
  while (tile > 1 && ctl_bytes<T>() + per_warp * tile > kSmemMax) --tile;
  const size_t smem = ctl_bytes<T>() + per_warp * tile;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_pass_kernel<T, kTrace>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (a.chains + tile - 1) / tile;
  fused_pass_kernel<T, kTrace><<<blocks, 32 * tile, smem, s>>>(a);
  return cudaGetLastError();
}

extern "C" int wt_fused_pass_args_size() {
  return static_cast<int>(sizeof(FusedPassArgs));
}

extern "C" int wt_fused_pass(const void* args, void* stream) {
  const FusedPassArgs& a = *static_cast<const FusedPassArgs*>(args);
  if (a.chains <= 0 || a.dim <= 0 || a.n_slots <= 0 || a.block_draws <= 0 ||
      a.chains_per_block < 1 || a.chains_per_block > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.is_double)
    err = a.trace ? launch_pass<double, true>(a, s)
                  : launch_pass<double, false>(a, s);
  else
    err = a.trace ? launch_pass<float, true>(a, s)
                  : launch_pass<float, false>(a, s);
  return static_cast<int>(err);
}
