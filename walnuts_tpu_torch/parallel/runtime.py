"""Block loops of warmup and sampling.

Counterpart of ``walnuts_tpu/parallel/runtime.py``, with its keywords
and defaults, and both schedulers: the classic per-draw one
(``batched=False``, the default, as in the reference), where a block is
``n`` calls of the step function of ``core/sampler.py`` (the reference's
``lax.scan`` over the vmapped step) and an attempt integrator may replace
the inner leapfrog loop, and the batched-native one (``batched=True``).
Chains advance in blocks of ``block_size`` iterations; between blocks the
cross-chain convergence checks run (the geometric-mean test of the
adapted tuning during warmup, the log-density R-hat during sampling) and
may stop the phase early, at the same iterations as the reference
(``_next_boundary``). Sampling draws are written in place into ONE
preallocated tensor: on the device with ``device_draws=True``, else on
the host (pinned when the chains are on a card), a block's rows copied
there after the block.

The classic scheduler's options: ``chain_groups > 1`` sorts the chains
once by their adapted ``min_micro / step`` (NumPy's ``argsort`` in
float64 on the host, as the reference) and advances the groups one after
the other in every iteration, so that a slow chain stalls its group only;
``flatten=True`` runs the flattened run-ahead sampler
(``core.transition.make_flat_sample_block``). ``_BlockBudget`` caps a
phase's block length from the walls of its first two blocks
(``block_budget``, default the ``WALNUTS_BLOCK_BUDGET`` environment
variable or 45 s; 0 turns it off): the reference keeps a compiled block
under a worker's time limit with it; here it bounds a block's wall, and
so how long an interrupt or a checkpoint waits for the block to end.
Check points stay at ``_next_boundary``'s iterations, so the draws and
the early-stop decisions do not depend on the cap; but each extra block of
the batched scheduler pays one counted start gradient and a drain of its
run-ahead, so a capped run's ``n_grads``, trips and wall follow the host's
speed. ``walnuts()`` takes the default, as the reference's does; a
benchmark that compares counts passes ``block_budget=0`` (or sets the
variable to 0), as ``bench.py`` does.

``batched_groups > 1`` sorts the chains every block by their cost (the
adapted ``min_micro / step`` before the first block, the realized
gradient count of the block before after it) and runs the groups one
after the other, each on its own columns of the draws. ``thin`` keeps
the last draw of every ``thin`` and ``keep_dims`` a subset of the
dimensions; the preallocated tensor then has only those rows and
columns.

``checkpoint`` (a ``parallel.checkpoint.BlockCheckpointer``) persists the
state between blocks, and ``start_it`` resumes a phase at a checkpointed
block boundary; nothing but the ``WarmupState`` / ``SampleState`` (and
``FrozenParams``) carries over from one block to the next, so a resumed
run is the uninterrupted one bit for bit. With ``batched_groups > 1`` the
realized cost that sorts the groups is not checkpointed, as in the
reference: a resumed run sorts its first block by the adapted cost again.

``mesh`` (a one-dimensional ``torch.distributed`` ``DeviceMesh`` whose
dimension is named ``CHAIN_AXIS``) shards the chains over processes, one
rank per device, in place of the reference's single-controller
``jax.sharding.Mesh``. Every rank calls the same function with the same
WHOLE chain-batched state; it runs the contiguous shard of chains that
``chain_sharding`` names (``shard_chains``) and returns the whole result
in chain order, as the reference returns global arrays. Only the
cross-chain statistics cross ranks between blocks: the per-chain inputs
of the convergence checks are all-gathered and reduced exactly as
without a mesh (never partial sums, whose summation order would differ),
so every rank takes the same early-stop decision at the same boundary,
and a per-chain result does not depend on the mesh. At each block
boundary the ranks also agree on an interrupt (an all-reduce MAX of a
flag, ``_Interrupts``): a ``KeyboardInterrupt`` from ``progress`` on one
rank, or a SIGINT that the main thread holds while a block runs, stops
every rank at that boundary. At the end the state, the draws and the per-chain counters are
all-gathered. The host counters of ``RunInfo`` (trips, syncs, blocks,
seconds) stay each rank's own.

The collectives follow one rule under either backend: tensors on the
rank's device (CUDA under a ``"cuda"`` mesh), list-form ``all_gather``
and ``all_reduce`` only, on the mesh's group. NCCL runs them on the card;
gloo (CPU ranks, or several ranks sharing one card, which NCCL refuses)
stages CUDA tensors through host memory. A collective that fails raises;
so does the next collective of every rank when another rank has died.

Under a mesh the per-lane options work as without one: ``min_latched``
counts each rank's own lanes (scheduling only), the block budget's cap
is the smallest of the ranks' caps (one all-reduce after each of the
first two blocks), and ``chain_groups`` raises, as in the reference.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.core.adapt import (
    adam_init,
    adam_step_size,
    mass_estimator_inv_mass,
    min_micro_estimate,
)
from walnuts_tpu_torch.core.batched import (
    make_batched_sample_block,
    make_batched_warmup_block,
)
from walnuts_tpu_torch.core.sampler import (
    FrozenParams,
    SampleState,
    WarmupState,
    make_sample_step,
    make_warmup_step,
)
from walnuts_tpu_torch.core.transition import (
    FailStats,
    TripCounts,
    make_flat_sample_block,
)
from walnuts_tpu_torch.ops.math import LogpGradFn

CHAIN_AXIS = "chains"


@dataclass(frozen=True)
class ChainSharding:
    """This rank's part of a chain axis sharded over a one-dimensional
    device mesh: rank ``rank`` of ``size`` runs the contiguous chains
    ``rows(num_chains)`` on ``device`` and reaches the other ranks over
    ``group`` (see the module docstring for the collectives' rule)."""

    rank: int
    size: int
    device: torch.device
    group: object

    def rows(self, num_chains: int) -> slice:
        if num_chains % self.size:
            raise ValueError(f"num_chains ({num_chains}) must divide by the mesh "
                             f"size ({self.size})")
        n = num_chains // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def min(self, value: int) -> int:
        """The smallest of every rank's ``value``."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def chain_sharding(mesh) -> Optional[ChainSharding]:
    """The ``ChainSharding`` of this process under ``mesh`` (a
    one-dimensional ``DeviceMesh`` whose dimension is named
    ``CHAIN_AXIS``, on ``"cuda"``, the rank's current device, or
    ``"cpu"``); None for None. Anything else raises ``ValueError``."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if (not isinstance(mesh, DeviceMesh) or mesh.ndim != 1
            or mesh.mesh_dim_names != (CHAIN_AXIS,)
            or mesh.device_type not in ("cuda", "cpu")):
        raise ValueError(
            f"mesh must be a one-dimensional torch.distributed DeviceMesh on "
            f"'cuda' or 'cpu' whose dimension is named {CHAIN_AXIS!r}; got {mesh!r}")
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    group = mesh.get_group(CHAIN_AXIS)
    # the group's rank orders the gathers, so it also places the rows
    return ChainSharding(rank=dist.get_rank(group), size=mesh.size(),
                         device=device, group=group)


def _map(fn, tree):
    """``fn`` on every tensor of a tree of tuples and NamedTuples."""
    if isinstance(tree, tuple):
        parts = [_map(fn, t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree)


def _local(tree, shard: Optional[ChainSharding]):
    """The rows of ``shard`` of a chain-batched tree, on its device."""
    if shard is None:
        return tree
    return _map(lambda x: x[shard.rows(x.shape[0])].to(shard.device), tree)


def _whole(tree, shard: Optional[ChainSharding], dim: int = 0):
    """Every rank's chains of a chain-batched tree (chain axis ``dim``)."""
    if shard is None:
        return tree
    return _map(lambda x: shard.gather(x, dim), tree)


def shard_chains(tree, mesh):
    """This rank's rows of a chain-batched tree (NamedTuples of tensors
    with a leading chain axis) on its device under ``mesh``; ``tree``
    itself for None."""
    return _local(tree, chain_sharding(mesh))


@dataclass
class RunInfo:
    """Realized iteration counts and instrumentation of a run.

    The reference's fields (iterations, per-chain ``n_grads`` and failure
    counters, the R-hat trace, convergence and interrupt flags), plus what
    the eager scheduler can count on the host: batched gradient
    evaluations (``n_inner_trips``), tier-2 passes (``n_outer_trips``),
    device-to-host reads of loop conditions (``n_syncs``) and blocks run,
    each per phase, and the wall seconds of each phase (host clock, ending
    on a device synchronize). On the card the batched scheduler replays
    each tier-2 pass as a CUDA graph: ``n_pass_replays`` counts those
    replays (every pass, ``n_outer_trips``), ``n_pass_captures`` the graphs
    captured (one for each shape a phase's blocks meet); both are 0 on the
    CPU, on the classic path and with ``pallas_pass``. A run resumed from a
    checkpoint restores every counter, so they cover the whole run;
    ``seconds`` counts this process only. On the classic path
    ``n_outer_trips`` counts attempts and ``n_inner_trips`` the model
    evaluations the host asked for:
    masked leapfrog steps, or integrator calls when an integrator runs the
    attempt (``core.transition.TripCounts``).
    """

    warmup_iters: int = 0
    sampling_iters: int = 0
    n_grads: Optional[np.ndarray] = None
    n_halve_fail: Optional[np.ndarray] = None
    n_nonfinite: Optional[np.ndarray] = None
    n_depth_exhausted: Optional[np.ndarray] = None
    rhat_trace: List[float] = field(default_factory=list)
    converged_warmup: bool = False
    converged_sampling: bool = False
    interrupted: bool = False
    n_inner_trips: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_outer_trips: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_syncs: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_pass_replays: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_pass_captures: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_blocks: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    seconds: dict = field(default_factory=lambda: {"warmup": 0.0, "sampling": 0.0})

    def _count(self, phase: str, res) -> None:
        self.n_inner_trips[phase] += res.n_inner_trips
        self.n_outer_trips[phase] += res.n_outer_trips
        self.n_syncs[phase] += res.n_syncs
        self.n_pass_replays[phase] += res.n_pass_replays
        self.n_pass_captures[phase] += res.n_pass_captures
        self.n_blocks[phase] += 1

    def _fails(self, fails: FailStats) -> None:
        self.n_halve_fail = fails.n_halve_fail.cpu().numpy()
        self.n_nonfinite = fails.n_nonfinite.cpu().numpy()
        self.n_depth_exhausted = fails.n_depth_exhausted.cpu().numpy()


def _warmup_convergence_stats(state: WarmupState, shard: Optional[ChainSharding] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max relative L2 distance of the per-chain mass diagonal from the
    cross-chain geometric mean, and max signed relative difference of the
    step size from its geometric mean (adapt.hpp:203-225), over every
    rank's chains."""
    inv_mass = _whole(mass_estimator_inv_mass(state.mass), shard)  # (C, D)
    log_mass = -torch.log(inv_mass)
    geo_mass = torch.exp(torch.mean(log_mass, dim=0))
    mass = torch.exp(log_mass)
    rel_mass = torch.linalg.vector_norm((mass - geo_mass) / geo_mass, dim=1)
    log_step = _whole(state.adam.log_step, shard)
    geo_step = torch.exp(torch.mean(log_step))
    rel_step = (torch.exp(log_step) - geo_step) / geo_step
    return torch.max(rel_mass), torch.max(rel_step)


def _sampling_rhat(state: SampleState, shard: Optional[ChainSharding] = None
                   ) -> torch.Tensor:
    """Split-free R-hat of the draw log densities (sampler.hpp:142-145):
    ``sqrt(1 + var(chain means) / mean(chain vars))``, sample variances,
    over every rank's chains."""
    lp_count, lp_mean, lp_m2 = (_whole(x, shard)
                                for x in (state.lp_count, state.lp_mean, state.lp_m2))
    variances = lp_m2 / torch.clamp_min(lp_count - 1.0, 1.0)
    var_of_means = torch.var(lp_mean, correction=1)
    return torch.sqrt(1.0 + var_of_means / torch.mean(variances))


def _next_boundary(it: int, min_iter: int, block_size: int,
                   max_iter: int) -> int:
    """Next early-stop check point after iteration ``it``: ``min_iter``,
    then every ``block_size``, clamped to ``max_iter``."""
    if it < min_iter:
        b = min_iter
    else:
        b = it + block_size - ((it - min_iter) % block_size)
    return min(b, max_iter)


class _BlockBudget:
    """The block-length cap of one phase (the reference's class): the
    first two blocks are timed (a device synchronize ends each), and when
    one block's wall exceeds ``budget`` seconds, or after two the smaller
    of their per-draw walls times ``cap`` does, later blocks are capped to
    0.8 of the budget at that per-draw wall (at least 1 draw). ``budget``
    None reads ``WALNUTS_BLOCK_BUDGET`` (default 45); 0 turns the cap off.
    Under a mesh (``shard``) every rank takes the smallest rank's cap after
    each of the first two blocks, so that all ranks run the same blocks."""

    def __init__(self, budget, cap: int, device, shard: Optional[ChainSharding] = None):
        if budget is None:
            budget = float(os.environ.get("WALNUTS_BLOCK_BUDGET", 45.0))
        self.budget = float(budget)
        self.cap = int(cap)
        self.device, self.shard = device, shard
        self._timed = self._blocks = 0
        self._est = None
        self._t0 = None

    def start(self) -> None:
        self._t0 = (time.perf_counter()
                    if self.budget > 0 and self._timed < 2 else None)

    def finish(self, n: int) -> None:
        """After a block of ``n`` draws."""
        if self._t0 is not None:
            _sync(self.device)
            dt = time.perf_counter() - self._t0
            self._t0 = None
            per_draw = dt / max(int(n), 1)
            self._est = per_draw if self._est is None else min(self._est, per_draw)
            self._timed += 1
            # at once when one block blew the budget; else once both
            # timing blocks' per-draw walls are in
            if dt > self.budget or (self._timed == 2
                                    and self._est * self.cap > self.budget):
                self.cap = min(self.cap, max(1, int(self.budget / self._est * 0.8)))
        if self.shard is not None and self._blocks < 2:
            self.cap = self.shard.min(self.cap)
        self._blocks += 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _refuse_batched_integrator(batched: bool, integrator) -> None:
    if batched and integrator is not None:
        # never silently drop a user-built integrator: the batched
        # scheduler integrates inside its own trip loop
        raise ValueError(
            "batched is incompatible with a custom integrator "
            "(pass batched=False to use it)")


def _refuse_schedulers(batched: bool, flatten: bool, chain_groups: int,
                       checkpoint) -> None:
    """The reference's refusals of the classic scheduler's options."""
    if flatten and chain_groups > 1:
        raise ValueError("flatten is incompatible with chain_groups")
    if batched and (flatten or chain_groups > 1):
        raise ValueError("batched is incompatible with flatten/chain_groups")
    if checkpoint is not None and (flatten or chain_groups > 1):
        # the flat scheduler's bank and the group permutation are not part
        # of the checkpointed state
        raise ValueError("checkpoint is incompatible with flatten/chain_groups")


def _refuse_chain_groups(shard: Optional[ChainSharding], chain_groups: int,
                         num_chains: int) -> None:
    if chain_groups > 1:
        if shard is not None:
            raise ValueError("chain_groups requires mesh=None")
        if num_chains % chain_groups:
            raise ValueError(f"num_chains ({num_chains}) must divide by "
                             f"chain_groups ({chain_groups})")


def _refuse_groups(batched: bool, batched_groups: int, num_chains: int) -> None:
    if batched_groups > 1 and not batched:
        raise ValueError("batched_groups requires batched=True")
    if batched_groups > 1 and num_chains % batched_groups:
        raise ValueError(f"num_chains ({num_chains}) must divide by "
                         f"batched_groups ({batched_groups})")


def _refuse_mesh(shard: Optional[ChainSharding], batched_groups: int,
                 num_chains: int) -> None:
    if shard is None:
        return
    if batched_groups > 1:
        raise ValueError("batched_groups > 1 requires mesh=None (the per-block "
                         "cost sort runs over the whole chain axis)")
    shard.rows(num_chains)  # raises unless the mesh divides the chains


class _Interrupts:
    """A phase loop's interrupts. A ``KeyboardInterrupt`` ends the phase
    and keeps the state reached so far (``info.interrupted``): without a
    mesh wherever it lands; under a mesh at a block boundary only, where
    the ranks agree to stop (``stop_here``). There SIGINT on the main
    thread is held while a block runs, and a ``KeyboardInterrupt`` raised
    inside a block propagates: one rank stopping alone would leave the
    others waiting at their next collective."""

    def __init__(self, shard: Optional[ChainSharding], info: RunInfo):
        self.shard, self.info, self.held = shard, info, False
        self._on = (shard is not None
                    and threading.current_thread() is threading.main_thread())
        self._old = None

    def _hold(self, signum, frame) -> None:
        self.held = True

    def __enter__(self) -> "_Interrupts":
        if self._on:
            self._old = signal.signal(signal.SIGINT, self._hold)
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        if self._on:
            signal.signal(signal.SIGINT, signal.default_int_handler
                          if self._old is None else self._old)
        if (self.shard is None and kind is not None
                and issubclass(kind, KeyboardInterrupt)):
            self.info.interrupted = True
            return True
        return False

    def stop_here(self, progress, phase: str, it: int) -> bool:
        """Calls ``progress(phase, it)`` at a block boundary; whether the
        phase stops here: the call raised ``KeyboardInterrupt``, or a
        SIGINT was held, on any rank."""
        stop = False
        if progress is not None:
            try:
                progress(phase, it)
            except KeyboardInterrupt:
                stop = True
        stop = stop or self.held
        if self.shard is not None:
            stop = self.shard.any(stop)
        if stop:
            self.info.interrupted = True
        return stop


def _refuse_thin(thin: int, block_size: int) -> None:
    if thin < 1 or block_size % thin:
        raise ValueError(f"thin ({thin}) must be >= 1 and divide block_size "
                         f"({block_size})")


def _tree_take(tree, idx: torch.Tensor):
    """The chains ``idx`` of a NamedTuple of chain-batched tensors."""
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_take(t, idx) for t in tree))
    return tree.index_select(0, idx)


def _tree_put(parts, num_chains: int):
    """The chain-batched tree whose chains ``idx`` are ``sub``, for every
    ``(idx, sub)`` of ``parts`` (the groups cover every chain once)."""
    sub0 = parts[0][1]
    if isinstance(sub0, tuple):
        return type(sub0)(*(_tree_put([(i, s[k]) for i, s in parts], num_chains)
                            for k in range(len(sub0))))
    out = torch.empty((num_chains,) + sub0.shape[1:], dtype=sub0.dtype,
                      device=sub0.device)
    for idx, sub in parts:
        out.index_copy_(0, idx, sub)
    return out


def _groups(cost: torch.Tensor, batched_groups: int):
    """The chains of each group: the stable ascending sort of ``cost``
    (float64, on the device) cut into ``batched_groups`` equal parts."""
    order = torch.argsort(cost, stable=True)
    cg = order.shape[0] // batched_groups
    return [order[g * cg:(g + 1) * cg] for g in range(batched_groups)]


def _run_grouped(block, state, cost: torch.Tensor, batched_groups: int):
    """One block of the chains in ``batched_groups`` groups by ascending
    ``cost``, one group after the other: ``block(sub, idx)`` runs the
    chains ``idx`` from their state ``sub`` and returns their new state
    and the block's result. Returns the state in the caller's chain
    order, the summed counts, and the next block's cost: each chain's
    gradients in this block."""
    parts, counts = [], TripCounts()
    for idx in _groups(cost, batched_groups):
        sub, res = block(_tree_take(state, idx), idx)
        parts.append((idx, sub))
        counts += TripCounts(res.n_inner_trips, res.n_outer_trips, res.n_syncs,
                             res.n_pass_replays, res.n_pass_captures)
    new = _tree_put(parts, state.theta.shape[0])
    return new, counts, (new.n_grads - state.n_grads).double()


def _cat(trees):
    """Chain-batched trees (NamedTuples of tensors) concatenated along the
    chain axis."""
    t0 = trees[0]
    if isinstance(t0, tuple):
        parts = [_cat([t[k] for t in trees]) for k in range(len(t0))]
        return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)
    return torch.cat(trees)


def _merged_stats(state: SampleState, logps: torch.Tensor) -> dict:
    """Chan et al. merge of a block's per-lane log-density statistics
    (``logps`` (n, C)) into the running Welford of ``state`` (the classic
    per-draw statistics). The block's rows are made contiguous, so that a
    lane's sums do not depend on the chain count (a strided reduction's
    order does, on the CPU)."""
    lps = logps.T.contiguous()  # (C, n)
    cnt_b = float(lps.shape[1])
    mean_b = torch.mean(lps, dim=1)
    m2_b = torch.sum((lps - mean_b[:, None]) ** 2, dim=1)
    tot = state.lp_count + cnt_b
    delta = mean_b - state.lp_mean
    return dict(lp_count=tot, lp_mean=state.lp_mean + delta * cnt_b / tot,
                lp_m2=state.lp_m2 + m2_b + delta**2 * state.lp_count * cnt_b / tot)


class _DrawSink:
    """Where sampling draws go: ONE tensor preallocated for ``max_iter //
    thin`` rows of ``C`` chains and the kept dimensions, on the device, or
    with ``host`` on the host (pinned when ``dev`` is a card), its log
    densities (in the dtype of the model's value) made at the first
    block. With no thinning, no dimension subset, one group and the draws
    on the device, a block writes its draws in place into its rows;
    otherwise into a block buffer on the device, whose selected rows and
    columns are copied into the chains' columns (``commit``)."""

    def __init__(self, max_iter: int, C: int, D: int, dtype, dev, thin: int,
                 keep_dims, direct: bool, host: bool = False):
        self.thin, self.direct, self.C, self.D = thin, direct and not host, C, D
        self.dev, self.host = torch.device(dev), host
        self.max_rows = max_iter // thin
        self.keep = (None if keep_dims is None else
                     torch.as_tensor([int(k) for k in keep_dims], dtype=torch.long,
                                     device=dev))
        width = D if keep_dims is None else len(keep_dims)
        self.draws = self._alloc((self.max_rows, C, width), dtype)
        self.logps = None
        self.rows = 0
        self._buf = None

    def _alloc(self, shape, dtype) -> torch.Tensor:
        if self.host:
            return torch.empty(shape, dtype=dtype,
                               pin_memory=self.dev.type == "cuda")
        return torch.empty(shape, dtype=dtype, device=self.dev)

    def out(self, n: int, lanes: int, lp_dtype):
        """The ``out`` of a block of ``n`` draws of ``lanes`` chains."""
        if self.logps is None:
            self.logps = self._alloc((self.max_rows, self.C), lp_dtype)
        r = self.rows
        if self.direct:
            return self.draws[r:r + n], self.logps[r:r + n]
        if self._buf is None or self._buf[0].shape[0] < n or self._buf[0].shape[1] != lanes:
            self._buf = (torch.empty((n, lanes, self.D), dtype=self.draws.dtype,
                                     device=self.dev),
                         torch.empty((n, lanes), dtype=self.logps.dtype,
                                     device=self.dev))
        return self._buf[0][:n], self._buf[1][:n]

    def commit(self, out, idx: Optional[torch.Tensor]) -> None:
        """Copy the selected rows and columns of the block buffer ``out``
        into the columns ``idx`` (all chains for None)."""
        if self.direct:
            return
        t = self.thin
        d, lp = out[0][t - 1::t], out[1][t - 1::t]
        if self.keep is not None:
            d = d.index_select(2, self.keep)
        if self.host:
            d, lp = d.cpu(), lp.cpu()
            idx = None if idx is None else idx.cpu()
        rows = slice(self.rows, self.rows + d.shape[0])
        if idx is None:
            self.draws[rows].copy_(d)
            self.logps[rows].copy_(lp)
        else:
            self.draws[rows].index_copy_(1, idx, d)
            self.logps[rows].index_copy_(1, idx, lp)

    def advance(self, n: int) -> None:
        self.rows += n // self.thin

    def result(self):
        if self.logps is None:
            self.logps = self._alloc((self.max_rows, self.C), self.draws.dtype)
        return self.draws[:self.rows], self.logps[:self.rows]


def run_warmup(
    logp_grad: LogpGradFn,
    state: WarmupState,
    warmup_cfg: WarmupConfig,
    sampling_cfg: SamplingConfig,
    *,
    save_warmup: bool = False,
    mesh=None,
    progress=None,
    integrator=None,
    bf16_ends: bool = False,
    checkpoint=None,
    start_it: int = 0,
    unroll: int = 1,
    info: Optional[RunInfo] = None,
    batched: bool = False,
    pallas_replay: bool = False,
    runahead: int = 4,
    tier2_every: int = 6,
    batched_groups: int = 1,
    bounded_sweeps: Optional[bool] = None,
    block_budget: Optional[float] = None,
) -> Tuple[WarmupState, Optional[torch.Tensor], Optional[torch.Tensor], RunInfo]:
    """Adaptive warmup with block-synchronous early stopping.

    ``state`` is a chain-batched ``WarmupState``. Returns the final state,
    with ``save_warmup`` the warmup draws ``(iters, C, D)`` and log
    densities ``(iters, C)`` on the state's device, and the run info.
    A ``KeyboardInterrupt`` between blocks ends warmup early and keeps the
    adaptation reached so far.

    ``batched=False`` (the default) is the classic warmup: every iteration
    is one transition of all chains in lock step, adapted at the draw
    boundary; ``integrator`` (see ``ops.integrator``) may run each
    attempt's leapfrog steps, and ``bf16_ends`` / ``unroll`` go to the
    transition (``core.transition.make_transition``). ``batched=True`` is
    the asynchronous batched-native warmup (``runahead``, ``tier2_every``,
    ``pallas_replay``, ``bounded_sweeps``: see
    ``core.batched.make_batched_sample_block``); ``batched_groups > 1``
    sorts the lanes into that many cost groups every block (the adapted
    ``min_micro / step`` first, then each lane's realized gradient count of
    the block before) and runs the groups one after the other. Both are
    scheduling only: a lane's draws and adaptation do not change on models
    without a matrix product. An integrator with ``batched=True`` raises
    ``ValueError``.

    ``block_budget`` caps the block length from the first two blocks'
    walls (``_BlockBudget``; None: ``WALNUTS_BLOCK_BUDGET`` or 45 s, 0:
    off); the convergence checks stay at the uncapped run's iterations,
    and a batched block added by the cap counts one more start gradient.

    ``checkpoint`` (a ``BlockCheckpointer``) persists the state after
    blocks; ``start_it`` (a block boundary of a restored checkpoint)
    resumes there, and the returned draws cover ``[start_it, end)`` only.
    ``info`` carries the restored RunInfo, so that its counters (and
    ``converged_warmup``: a warmup that had converged must not adapt on)
    cover the whole run.

    ``mesh`` (see the module docstring): every rank passes the whole
    ``state``, runs its shard of the chains, and gets the whole state,
    draws and per-chain counters back. ``checkpoint`` then takes the
    rank's chains (``BlockCheckpointer(mesh=...)`` gathers them).
    ``batched_groups > 1`` requires ``mesh=None``.
    """
    _refuse_batched_integrator(batched, integrator)
    shard = chain_sharding(mesh)
    _refuse_mesh(shard, batched_groups, state.theta.shape[0])
    state = _local(state, shard)
    C, D = state.theta.shape
    _refuse_groups(batched, batched_groups, C)
    if batched:
        warmup_block = make_batched_warmup_block(
            logp_grad, sampling_cfg, pallas_replay=pallas_replay,
            runahead=runahead, tier2_every=tier2_every,
            bounded_sweeps=bounded_sweeps)
    else:
        warmup_step = make_warmup_step(logp_grad, sampling_cfg,
                                       integrator=integrator,
                                       bf16_ends=bf16_ends, unroll=unroll)

        def warmup_block(ws: WarmupState, n: int, out=None):
            # out: a function of the log density's dtype that returns the
            # block's (draws, logps)
            counts, buf = TripCounts(), None
            for i in range(n):
                ws, o = warmup_step(ws)
                counts += o.counts
                if out is not None:
                    buf = buf or out(o.logp.dtype)
                    buf[0][i].copy_(o.theta)
                    buf[1][i].copy_(o.logp)
            return ws, counts
    info = info or RunInfo()
    dev = state.theta.device
    sink = (_DrawSink(warmup_cfg.max_iter - start_it, C, D, state.theta.dtype, dev,
                      1, None, direct=batched_groups == 1) if save_warmup else None)

    def run_block(ws: WarmupState, n: int, idx=None):
        if sink is None:
            return warmup_block(ws, n)
        # the log densities are kept in the dtype of the model's value
        lanes = ws.theta.shape[0]
        ws, res = warmup_block(ws, n, lambda lp_dtype: sink.out(n, lanes, lp_dtype))
        sink.commit(sink.out(n, lanes, None), idx)
        if not sink.direct:  # a row of the buffer the next group writes
            ws = ws._replace(theta=ws.theta.clone())
        return ws, res

    def check() -> bool:
        mrm, mrs = _warmup_convergence_stats(state, shard)
        return bool((mrm <= warmup_cfg.mass_converge_tol)
                    & (mrs <= warmup_cfg.step_size_converge_tol))

    t0 = time.perf_counter()
    it = start_it
    converged = bool(info.converged_warmup) if start_it > 0 else False
    cost = None
    if warmup_cfg.min_iter == 0 and warmup_cfg.max_iter > 0 and it == 0:
        converged = check()
    budget = _BlockBudget(block_budget, warmup_cfg.block_size, dev, shard)
    with _Interrupts(shard, info) as interrupts:
        while it < warmup_cfg.max_iter and not converged:
            # a capped block never crosses a check point: the checks stay
            # at the iterations of the uncapped run
            next_check = _next_boundary(it, warmup_cfg.min_iter,
                                        warmup_cfg.block_size,
                                        warmup_cfg.max_iter)
            n = min(budget.cap, warmup_cfg.block_size, next_check - it)
            budget.start()
            if batched_groups > 1:
                if cost is None:  # first block: the pre-adaptation cost heuristic
                    cost = (min_micro_estimate(state.min_micro).double()
                            / adam_step_size(state.adam).double())
                state, res, cost = _run_grouped(
                    lambda sub, idx: run_block(sub, n, idx), state, cost,
                    batched_groups)
            else:
                state, res = run_block(state, n)
            budget.finish(n)
            kept = (None, None)  # the block's rows of the saved draws
            if sink is not None:
                r0 = sink.rows
                sink.advance(n)
                kept = (sink.draws[r0:sink.rows], sink.logps[r0:sink.rows])
            info._count("warmup", res)
            it += n
            if checkpoint is not None:
                info.warmup_iters = it
                checkpoint.block("warmup", it, state, info, block_start=it - n,
                                 theta=kept[0], logp=kept[1])
            if interrupts.stop_here(progress, "warmup", it):
                break
            if it == next_check and it >= warmup_cfg.min_iter:
                converged = check()
    _sync(dev)
    info.seconds["warmup"] += time.perf_counter() - t0
    info.warmup_iters = it
    info.converged_warmup = converged
    if checkpoint is not None and not info.interrupted:
        # the final convergence flag, decided after the last block's save:
        # a resumed converged warmup must not adapt on
        checkpoint.update_info("warmup", it, info)
    state = _whole(state, shard)
    info._fails(state.fails)
    draws, logps = _whole(sink.result(), shard, 1) if save_warmup else (None, None)
    return state, draws, logps, info


def run_sampling(
    logp_grad: LogpGradFn,
    state: SampleState,
    params: FrozenParams,
    sampling_cfg: SamplingConfig,
    *,
    mesh=None,
    info: Optional[RunInfo] = None,
    progress=None,
    on_r_hat=None,
    integrator=None,
    bf16_ends: bool = False,
    chain_groups: int = 1,
    device_draws: bool = False,
    flatten: bool = False,
    checkpoint=None,
    start_it: int = 0,
    thin: int = 1,
    keep_dims=None,
    unroll: int = 1,
    batched: bool = False,
    batched_groups: int = 1,
    runahead: int = 8,
    tier2_every: int = 6,
    min_latched: int = 0,
    defer_splits: bool = True,
    pallas_replay: bool = False,
    fresh_cur: bool = False,
    bounded_sweeps: Optional[bool] = None,
    pallas_pass: bool = False,
    pass_tile: Optional[int] = None,
    block_budget: Optional[float] = None,
) -> Tuple[SampleState, torch.Tensor, torch.Tensor, RunInfo]:
    """Fixed-parameter sampling with R-hat early stopping.

    Returns the final state, the draws ``(iters // thin, C, K)`` and their
    log densities ``(iters // thin, C)`` — slices of one tensor
    preallocated for ``max_iter // thin`` rows and filled block by block —
    and the run info. ``device_draws=True`` keeps that tensor on the
    state's device, where each block writes in place; ``False`` (the
    default, as in the reference) keeps it on the host, pinned when the
    chains are on a card, and each block's rows are copied there after the
    block.

    ``thin > 1`` keeps the last draw of each group of ``thin`` iterations
    (a block whose length is not a multiple gives ``floor(n / thin)``
    rows); it must divide ``block_size``. ``keep_dims`` (parameter
    indices) keeps those dimensions of each draw (``K`` of them; all for
    None). The sampler still advances every iteration in every dimension,
    and the R-hat controller sees every log density.

    ``batched=False`` (the default) is the classic sampler: every iteration
    is one transition of all chains in lock step (each pass of its attempt
    loop waits for the slowest chain), with the per-draw Welford update;
    ``integrator`` (see ``ops.integrator``) may run each attempt's leapfrog
    steps, and ``bf16_ends`` / ``unroll`` go to the transition.
    ``chain_groups > 1`` sorts the chains by their adapted ``min_micro /
    step`` (NumPy's ``argsort`` on the host, as in the reference) and
    advances the groups one after the other in every iteration, so that a
    slow chain stalls its own group only; the outputs come back in the
    caller's chain order, and every chain's results are the ungrouped
    run's. ``flatten=True`` runs the flattened run-ahead sampler
    (``core.transition.make_flat_sample_block``): the same draws per chain;
    the bank's start costs one counted gradient, and no transition
    re-evaluates its start point; the returned key is the bank's, which has
    run ahead into the next transition.

    ``batched=True`` is the batched-native scheduler: ``runahead``,
    ``tier2_every``, ``min_latched``, ``defer_splits``, ``pallas_replay``,
    ``fresh_cur``, ``bounded_sweeps`` and ``bf16_ends`` go to
    ``core.batched.make_batched_sample_block``. Per lane its draws are the
    classic path's; ``n_grads`` is one lower per draw but the first of a
    block (it caches a draw's start gradient). ``batched_groups > 1``
    re-sorts the chains every block by their realized gradient count in
    the block before (the adapted ``min_micro / step`` before the first)
    and runs the groups one after the other; the sort stays on the device.
    ``pallas_pass=True`` runs each tier-2 pass as one launch of the fused
    pass kernel (CUDA tensors; the plain version on the CPU) with
    ``pass_tile`` chains per CUDA block; the chains are the unfused pass's.

    Refused with ``ValueError``, as in the reference: ``flatten`` with
    ``chain_groups``; ``batched`` with either, or with an ``integrator``;
    ``checkpoint`` with either; ``chain_groups`` under a mesh or not
    dividing the chains; ``batched_groups`` without ``batched`` or under a
    mesh; ``pallas_pass`` with an option its kernel does not compute.

    ``block_budget``: as in :func:`run_warmup`. ``checkpoint`` (a
    ``BlockCheckpointer``) persists the state, the parameters and each
    block's kept draws; ``start_it`` resumes at a checkpointed block
    boundary, and the draws returned then cover ``[start_it, end)`` only.

    ``mesh``: as in ``run_warmup``; ``state`` and ``params`` are whole on
    every rank, and so are the returned state, draws and counters.
    """
    _refuse_schedulers(batched, flatten, chain_groups, checkpoint)
    _refuse_batched_integrator(batched, integrator)
    shard = chain_sharding(mesh)
    _refuse_mesh(shard, batched_groups, state.theta.shape[0])
    _refuse_chain_groups(shard, chain_groups, state.theta.shape[0])
    state, params = _local(state, shard), _local(params, shard)
    C, D = state.theta.shape
    _refuse_groups(batched, batched_groups, C)
    _refuse_thin(thin, sampling_cfg.block_size)
    if pallas_pass and not batched:
        raise ValueError("pallas_pass requires batched=True (the classic "
                         "path has no tier-2 pass)")
    dev = state.theta.device
    dtype = state.theta.dtype
    max_error = torch.tensor(sampling_cfg.max_hamiltonian_error, dtype=dtype,
                             device=dev)
    sink = _DrawSink(sampling_cfg.max_iter - start_it, C, D, dtype, dev, thin, keep_dims,
                     direct=thin == 1 and keep_dims is None and batched_groups == 1,
                     host=not device_draws)
    permutation = None
    if chain_groups > 1:
        # the reference's sort: NumPy's (unstable) argsort of the float64
        # adapted cost, on the host
        cost = (params.min_micro.cpu().numpy().astype(np.float64)
                / params.step_size.cpu().numpy().astype(np.float64))
        permutation = np.argsort(cost)
        perm = torch.as_tensor(permutation, device=dev)
        state, params = _tree_take(state, perm), _tree_take(params, perm)
    if batched:
        start_blk, sample_blk = make_batched_sample_block(
            logp_grad,
            sampling_cfg.max_trajectory_doublings,
            sampling_cfg.max_step_halvings,
            runahead=runahead,
            tier2_every=tier2_every,
            bf16_ends=bf16_ends,
            min_latched=min_latched,
            defer_splits=defer_splits,
            pallas_replay=pallas_replay,
            fresh_cur=fresh_cur,
            bounded_sweeps=bounded_sweeps,
            pallas_pass=pallas_pass,
            pass_tile=pass_tile,
        )

        def run_block(state: SampleState, p: FrozenParams, n: int, idx=None):
            st = start_blk(state.key, state.theta, state.n_grads, state.fails,
                           p.step_size, p.inv_mass, p.min_micro)
            out = sink.out(n, state.theta.shape[0], st.ms_joint.dtype)
            res = sample_blk(st, p.step_size, p.inv_mass, p.min_micro,
                             max_error, n, out=out)
            sink.commit(out, idx)
            state = state._replace(
                key=res.key,
                # a row of the draws, or of a block buffer the next block
                # (or group) writes
                theta=res.draws[-1] if sink.direct else res.draws[-1].clone(),
                # + 1: the block-entry gradient start_blk evaluated
                n_grads=state.n_grads + res.n_grads_delta + 1,
                fails=FailStats(*(a + b for a, b in zip(state.fails,
                                                        res.fails_delta))),
                **_merged_stats(state, res.logps),
            )
            return state, res
    elif flatten:
        start_bank, flat_block = make_flat_sample_block(
            logp_grad, sampling_cfg.max_trajectory_doublings,
            sampling_cfg.max_step_halvings, integrator=integrator,
            bf16_ends=bf16_ends)
        bank = start_bank(state.key, state.theta, params.step_size,
                          params.inv_mass, params.min_micro,
                          adam_init(params.step_size.to(dtype)))
        # the bank's start gradient is real work
        state = state._replace(n_grads=state.n_grads + 1)

        def run_block(state: SampleState, p: FrozenParams, n: int, idx=None):
            nonlocal bank
            out = sink.out(n, C, bank.acc_s.dtype)
            res = flat_block(bank, p.step_size, p.inv_mass, p.min_micro,
                             max_error, n, out=out)
            sink.commit(out, idx)
            state = state._replace(
                key=res.bank.key,
                theta=res.draws[-1] if sink.direct else res.draws[-1].clone(),
                n_grads=state.n_grads + (res.bank.n_grads - bank.n_grads),
                fails=FailStats(*(a + (b - c) for a, b, c in zip(
                    state.fails, res.bank.fails, bank.fails))),
                **_merged_stats(state, res.logps),
            )
            bank = res.bank
            return state, res.counts
    else:
        sample_step = make_sample_step(logp_grad, sampling_cfg,
                                       integrator=integrator,
                                       bf16_ends=bf16_ends, unroll=unroll)
        cg = C // chain_groups
        cols = [slice(g * cg, (g + 1) * cg) for g in range(chain_groups)]

        def run_block(state: SampleState, p: FrozenParams, n: int, idx=None):
            counts, out = TripCounts(), None
            if chain_groups > 1:
                subs = [_map(lambda x: x[c], state) for c in cols]
                subp = [_map(lambda x: x[c], p) for c in cols]
            else:
                subs, subp = [state], [p]
            for i in range(n):
                # the groups one after the other (the reference's lax.map)
                for g, c in enumerate(cols):
                    subs[g], res = sample_step(subs[g], subp[g])
                    counts += res.counts
                    if out is None:
                        out = sink.out(n, C, res.logp.dtype)
                    out[0][i, c].copy_(res.theta)
                    out[1][i, c].copy_(res.logp)
            sink.commit(out, idx)
            return (_cat(subs) if chain_groups > 1 else subs[0]), counts

    info = info or RunInfo()
    t0 = time.perf_counter()
    it = start_it
    # a resumed run that had stopped on R-hat stays stopped
    converged = bool(info.converged_sampling) if start_it > 0 else False
    cost = None
    budget = _BlockBudget(block_budget, sampling_cfg.block_size, dev, shard)
    with _Interrupts(shard, info) as interrupts:
        while it < sampling_cfg.max_iter and not converged:
            next_check = _next_boundary(it, sampling_cfg.min_iter,
                                        sampling_cfg.block_size,
                                        sampling_cfg.max_iter)
            n = min(budget.cap, sampling_cfg.block_size, next_check - it)
            budget.start()
            if batched_groups > 1:
                if cost is None:  # first block: the adapted per-draw cost
                    cost = params.min_micro.double() / params.step_size.double()
                state, res, cost = _run_grouped(
                    lambda sub, idx: run_block(sub, _tree_take(params, idx), n, idx),
                    state, cost, batched_groups)
            else:
                state, res = run_block(state, params, n)
            budget.finish(n)
            r0 = sink.rows
            sink.advance(n)
            info._count("sampling", res)
            it += n
            if checkpoint is not None:
                info.sampling_iters = it
                checkpoint.block(
                    "sampling", it, state, info, block_start=it - n,
                    theta=sink.draws[r0:sink.rows], logp=sink.logps[r0:sink.rows],
                    params=params)
            if interrupts.stop_here(progress, "sampling", it):
                break
            if it == next_check and it >= max(sampling_cfg.min_iter, 2):
                r = float(_sampling_rhat(state, shard))
                info.rhat_trace.append(r)
                if on_r_hat is not None:
                    on_r_hat(r)
                converged = r <= sampling_cfg.rhat_converge_tol
    _sync(dev)
    info.seconds["sampling"] += time.perf_counter() - t0
    info.sampling_iters = it
    info.converged_sampling = converged
    if checkpoint is not None and not info.interrupted:
        # the final R-hat flag (see run_warmup): an early-stopped run
        # called again returns the same draws
        checkpoint.update_info("sampling", it, info)
    draws, logps = sink.result()
    if permutation is not None:
        # the caller's chain order
        inverse = torch.as_tensor(np.argsort(permutation))
        state = _tree_take(state, inverse.to(dev))
        draws = draws.index_select(1, inverse.to(draws.device))
        logps = logps.index_select(1, inverse.to(logps.device))
    state = _whole(state, shard)
    info.n_grads = state.n_grads.cpu().numpy()
    info._fails(state.fails)
    if shard is not None:  # gathered on the rank's device
        home = draws.device
        draws, logps = _whole((draws.to(shard.device), logps.to(shard.device)),
                              shard, 1)
        draws, logps = draws.to(home), logps.to(home)
    return state, draws, logps, info


__all__ = [
    "CHAIN_AXIS",
    "ChainSharding",
    "RunInfo",
    "chain_sharding",
    "run_sampling",
    "run_warmup",
    "shard_chains",
]
