"""Mid-run checkpoint and resume for multi-chain runs (``torch.save``).

Counterpart of ``walnuts_tpu/parallel/checkpoint.py``, with the same
layout and semantics: the whole chain-batched sampler state
(``WarmupState`` during warmup, ``SampleState`` and ``FrozenParams``
during sampling), the ``RunInfo`` counters and every collected draw block
are persisted after every ``every``-th block, and
``walnuts(..., checkpoint_dir=...)`` resumes from the latest checkpoint:
a run killed mid-warmup re-enters warmup at the checkpointed iteration, a
run killed mid-sampling skips warmup and produces the remaining draws of
the uninterrupted run bit for bit (the state holds the keys).

Layout under ``directory`` (two alternating state slots, so a crash in the
middle of a save never corrupts the latest durable checkpoint;
``meta.json`` is written last by atomic rename and names the live slot):

    meta.json                 phase, iteration, live slot, counters
    state_a/ | state_b/       state.pt: the state (and params) as a flat
                              dict of CPU tensors keyed by field path
    blocks/<phase>_<it>.npz   per-block draws and log densities

Under a chain mesh (``BlockCheckpointer(mesh=...)``; see
``parallel/runtime.py``) the runtime hands every rank's own chains to
``block`` and ``save``; a save all-gathers them, rank 0 writes the whole
state once, with the same files and fingerprint as without a mesh, and
every rank waits for the write to finish. Every rank reads the whole
checkpoint back (``latest``, ``restore``, ``saved_blocks``), so the
directory must be one that all ranks see.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from walnuts_tpu_torch.parallel.runtime import RunInfo, _whole, chain_sharding


def _flatten(tree, prefix: str, out: dict) -> dict:
    """The tensors of a NamedTuple tree as ``{"a/b/c": tensor}``, each a
    CPU copy of its own: a view (a row of the draw tensor) must not drag
    its whole storage into the file."""
    if isinstance(tree, tuple):
        for name, sub in zip(tree._fields, tree):
            _flatten(sub, f"{prefix}/{name}", out)
    else:
        out[prefix] = tree.detach().to("cpu", copy=True)
    return out


def _unflatten(flat: dict, template, prefix: str):
    """The tree of ``template``'s type with the tensors of ``flat``, each
    on its template leaf's device."""
    if isinstance(template, tuple):
        return type(template)(*(_unflatten(flat, sub, f"{prefix}/{name}")
                                for name, sub in zip(template._fields, template)))
    t = flat[prefix]
    if t.shape != template.shape or t.dtype != template.dtype:
        raise ValueError(
            f"checkpoint field {prefix}: {tuple(t.shape)} {t.dtype} does not fit "
            f"the run's {tuple(template.shape)} {template.dtype}")
    return t.to(template.device)


def _first_device(tree) -> torch.device:
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree.device


class BlockCheckpointer:
    """Persists run state between blocks; see the module docstring.

    ``every`` counts blocks: 1 checkpoints after every block, 4 after
    every fourth. Draw blocks produced since the last state save are kept
    (as views of the run's draw tensor) and written with it, so a resumed
    run never has draws newer than its state (it makes them again, the
    same). Each written block is one device-to-host copy.

    ``keep_last_n`` bounds the block-file count per phase: when more than
    ``keep_last_n`` files exist, the older ones are COMPACTED into one
    ``.npz`` (no draw is dropped). Compaction is crash-safe: the merged
    file atomically replaces the oldest of the files it merges first, and
    :meth:`saved_blocks` skips a leftover file whose iterations the merged
    one already covers.

    ``fingerprint`` (any JSON-serialisable value) records the run
    configuration; :meth:`latest` refuses to resume (returns ``None`` with
    a warning, so the caller starts over) when the stored one differs.

    ``mesh``: the run's chain mesh (see the module docstring); ``block``
    and ``save`` then take this rank's chains.
    """

    def __init__(
        self,
        directory: str,
        every: int = 1,
        keep_last_n: Optional[int] = None,
        fingerprint=None,
        mesh=None,
    ):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1; got {every}")
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(
                f"checkpoint keep_last_n must be >= 1; got {keep_last_n}")
        self.directory = os.path.abspath(directory)
        self.every = every
        self.keep_last_n = keep_last_n
        self.fingerprint = fingerprint
        self._shard = chain_sharding(mesh)
        self._writer = self._shard is None or self._shard.rank == 0
        self._blocks_since_save = 0
        self._pending: List[Tuple[str, int, int, Any, Any]] = []
        os.makedirs(os.path.join(self.directory, "blocks"), exist_ok=True)

    def reset(self) -> None:
        """Delete any existing checkpoint state (start the run over)."""
        if self._writer:
            for name in ("meta.json", "state_a", "state_b", "blocks"):
                path = os.path.join(self.directory, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                elif os.path.exists(path):
                    os.remove(path)
            os.makedirs(os.path.join(self.directory, "blocks"), exist_ok=True)
        self._pending.clear()
        self._blocks_since_save = 0
        if self._shard is not None:
            self._shard.barrier()

    # -- write path ------------------------------------------------------

    def block(self, phase: str, it: int, state, info, block_start: int,
              theta: Optional[torch.Tensor] = None,
              logp: Optional[torch.Tensor] = None, params=None) -> None:
        """Record one finished block; checkpoint the state every ``every``.
        ``theta`` and ``logp`` must not be written again by the run."""
        if theta is not None:
            self._pending.append((phase, block_start, it, theta, logp))
        self._blocks_since_save += 1
        if self._blocks_since_save >= self.every:
            self.save(phase, it, state, info, params=params)

    def save(self, phase: str, it: int, state, info, params=None) -> None:
        """Write a durable checkpoint: draw blocks, state slot, meta."""
        shard = self._shard
        pending = [(ph, start, end, *_whole((theta, logp), shard, 1))
                   for ph, start, end, theta, logp in self._pending]
        state = _whole(state, shard)
        params = None if params is None else _whole(params, shard)
        self._pending.clear()
        self._blocks_since_save = 0
        if self._writer:
            self._write(phase, it, state, info, params, pending)
        if shard is not None:
            shard.barrier()

    def _write(self, phase: str, it: int, state, info, params, pending) -> None:
        touched_phases = set()
        for ph, start, end, theta, logp in pending:
            np.savez(os.path.join(self.directory, "blocks", f"{ph}_{start:08d}.npz"),
                     theta=theta.cpu().numpy(), logp=logp.cpu().numpy(),
                     end=np.asarray(end))
            touched_phases.add(ph)

        meta = self._read_meta()
        slot = "state_b" if meta and meta.get("slot") == "state_a" else "state_a"
        slot_path = os.path.join(self.directory, slot)
        if os.path.exists(slot_path):
            shutil.rmtree(slot_path)
        os.makedirs(slot_path)
        flat = _flatten(state, "state", {})
        if params is not None:
            _flatten(params, "params", flat)
        torch.save(flat, os.path.join(slot_path, "state.pt"))

        new_meta = {
            "phase": phase,
            "it": int(it),
            "slot": slot,
            "has_params": params is not None,
            "info": _info_to_dict(info),
        }
        if self.fingerprint is not None:
            new_meta["fingerprint"] = self.fingerprint
        self._write_meta(new_meta)

        # compaction runs strictly AFTER the meta write: a merged file must
        # never span past the durable iteration, or a crash in the middle
        # of a compaction would make resume count draws twice
        if self.keep_last_n is not None:
            for ph in touched_phases:
                self._compact(ph)

    def update_info(self, phase: str, it: int, info) -> None:
        """Rewrite the RunInfo in ``meta.json`` for an existing checkpoint.

        The convergence flags are decided AFTER the block whose save wrote
        the meta, so the runtime calls this when a phase ends: a resumed
        early-stopped run must see ``converged=True`` and stay stopped. A
        no-op unless the durable checkpoint is exactly at ``(phase, it)``
        (otherwise resume runs the tail again and decides the same flags).
        """
        meta = self._read_meta() if self._writer else None
        if meta is None or meta["phase"] != phase or meta["it"] != int(it):
            return
        meta["info"] = _info_to_dict(info)
        self._write_meta(meta)

    def _write_meta(self, meta: dict) -> None:
        tmp = os.path.join(self.directory, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.directory, "meta.json"))

    def _block_files(self, phase: str) -> List[Tuple[int, str]]:
        """Sorted ``(start_iter, filename)`` of this phase's block files."""
        bdir = os.path.join(self.directory, "blocks")
        out = []
        for n in os.listdir(bdir):
            if n.startswith(f"{phase}_") and n.endswith(".npz"):
                out.append((int(n[len(phase) + 1:-4]), n))
        return sorted(out)

    def _compact(self, phase: str) -> None:
        """Merge all but the last ``keep_last_n`` block files into one.

        Crash-safe order: the merged file atomically REPLACES the oldest
        file it merges (same name, its stored ``end`` now covering the
        whole range), then the other merged files are unlinked. A crash in
        between leaves files whose range the merged one covers;
        ``saved_blocks`` skips those.
        """
        files = self._block_files(phase)
        if len(files) <= self.keep_last_n:
            return
        merge = files[:len(files) - self.keep_last_n + 1]
        if len(merge) < 2:
            return
        bdir = os.path.join(self.directory, "blocks")
        thetas, logps, end = [], [], merge[0][0]
        for start, name in merge:
            if start < end and thetas:
                continue  # leftover of a crashed compaction, already covered
            with np.load(os.path.join(bdir, name)) as z:
                thetas.append(z["theta"])
                logps.append(z["logp"])
                end = int(z["end"]) if "end" in z else start + z["theta"].shape[0]
        tmp = os.path.join(bdir, ".compact.tmp.npz")
        np.savez(tmp, theta=np.concatenate(thetas, axis=0),
                 logp=np.concatenate(logps, axis=0), end=np.asarray(end))
        os.replace(tmp, os.path.join(bdir, merge[0][1]))
        for _, name in merge[1:]:
            os.remove(os.path.join(bdir, name))

    # -- read path -------------------------------------------------------

    def _read_meta(self) -> Optional[dict]:
        path = os.path.join(self.directory, "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest(self) -> Optional[dict]:
        """Metadata of the latest durable checkpoint, or None.

        Returns ``None`` (with a warning) when the stored run fingerprint
        differs from this checkpointer's: resuming a checkpoint written
        under other run arguments would silently replay the old run.
        """
        meta = self._read_meta()
        if (meta is not None and self.fingerprint is not None
                and meta.get("fingerprint") is not None
                and meta["fingerprint"] != self.fingerprint):
            warnings.warn(
                f"checkpoint in {self.directory} was written with different run "
                f"arguments (stored fingerprint {meta['fingerprint']!r} != "
                f"{self.fingerprint!r}); ignoring it and starting over",
                stacklevel=3)
            return None
        return meta

    def restore(self, state_template, params_template=None):
        """Restore ``(state, params, info)`` into the given templates: each
        tensor lands on its template's device, with its shape and dtype
        checked."""
        meta = self._read_meta()
        if meta is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        if meta["has_params"] and params_template is None:
            raise ValueError("checkpoint has params; template required")
        flat = torch.load(os.path.join(self.directory, meta["slot"], "state.pt"),
                          map_location=_first_device(state_template),
                          weights_only=True)
        state = _unflatten(flat, state_template, "state")
        params = (_unflatten(flat, params_template, "params")
                  if meta["has_params"] else None)
        return state, params, _info_from_dict(meta["info"])

    def saved_blocks(self, phase: str, upto_it: int
                     ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Concatenated ``(draws, logps)`` of the saved blocks of ``phase``
        that start before ``upto_it`` (the checkpointed position).

        Skips any file whose start an earlier (merged) file already covers:
        the leftover of a crash in the middle of a compaction.
        """
        bdir = os.path.join(self.directory, "blocks")
        thetas, logps = [], []
        covered_end = -1
        for start, n in self._block_files(phase):
            if start >= upto_it or start < covered_end:
                continue
            with np.load(os.path.join(bdir, n)) as z:
                theta, logp = z["theta"], z["logp"]
                end = int(z["end"]) if "end" in z else start + 1
                if end > upto_it:
                    # a merged file can span past the resume point (the
                    # resumed run compacts freely): keep the rows of
                    # iterations < upto_it, which map linearly onto
                    # [start, end) (uniform thinning)
                    k = theta.shape[0] * (upto_it - start) // (end - start)
                    theta, logp = theta[:k], logp[:k]
                thetas.append(theta)
                logps.append(logp)
                covered_end = end
        if not thetas:
            return None, None
        return np.concatenate(thetas, axis=0), np.concatenate(logps, axis=0)


_ARRAYS = ("n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted")
_PHASE_COUNTS = ("n_inner_trips", "n_outer_trips", "n_syncs", "n_pass_replays",
                 "n_pass_captures", "n_blocks")


def _info_to_dict(info) -> dict:
    d = {
        "warmup_iters": info.warmup_iters,
        "sampling_iters": info.sampling_iters,
        "rhat_trace": [float(r) for r in info.rhat_trace],
        "converged_warmup": bool(info.converged_warmup),
        "converged_sampling": bool(info.converged_sampling),
    }
    for k in _ARRAYS:
        v = getattr(info, k)
        d[k] = np.asarray(v).tolist() if v is not None else None
    for k in _PHASE_COUNTS:
        d[k] = dict(getattr(info, k))
    return d


def _info_from_dict(d: dict) -> RunInfo:
    info = RunInfo(
        warmup_iters=d["warmup_iters"],
        sampling_iters=d["sampling_iters"],
        rhat_trace=list(d["rhat_trace"]),
        converged_warmup=d["converged_warmup"],
        converged_sampling=d["converged_sampling"],
    )
    for k in _ARRAYS:
        if d.get(k) is not None:
            setattr(info, k, np.asarray(d[k]))
    for k in _PHASE_COUNTS:
        getattr(info, k).update(d.get(k, {}))  # older checkpoints lack some
    return info


__all__ = ["BlockCheckpointer"]
