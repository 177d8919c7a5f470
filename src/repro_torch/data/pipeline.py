"""Deterministic, restart-safe, sharded data pipeline (the reference's
``data/pipeline.py``; numpy, like it: the trainer moves each batch to the
device, and the train step casts the token ids to int64).

Every batch is a pure function of (seed, step, shard) — no iterator state
exists anywhere, so preemption/restart resumes mid-epoch exactly, straggler
shards can be re-assigned to backup hosts deterministically, and elastic
re-scaling just changes the (shard, n_shards) factorization.

Two sources:
  * synthetic  — hashed-counter tokens (bench/dry-run/CI),
  * memmap     — a flat int32 token file (np.memmap), strided by a hash
                 of the row index.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: str = ""


def _philox(seed: np.uint64, counter: np.ndarray) -> np.ndarray:
    """Cheap stateless hash (splitmix64) — enough for synthetic tokens."""
    x = (counter + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


class Pipeline:
    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        if cfg.global_batch % n_shards:
            raise ValueError("global_batch must divide over shards")
        self.cfg = cfg
        self.shard, self.n_shards = shard, n_shards
        self.local_batch = cfg.global_batch // n_shards
        self._mm = None
        if cfg.source == "memmap":
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of step → {"tokens", "labels"} (int32) for this
        shard."""
        cfg = self.cfg
        B, S = self.local_batch, cfg.seq
        row0 = (step * cfg.global_batch + self.shard * B)
        if self._mm is None:
            counters = (np.uint64(row0) * np.uint64(S + 1)
                        + np.arange(B * (S + 1), dtype=np.uint64).reshape(
                            B, S + 1))
            toks = (_philox(np.uint64(cfg.seed), counters)
                    % np.uint64(cfg.vocab)).astype(np.int32)
        else:
            n = self._mm.shape[0] - (S + 1)
            idx = (_philox(np.uint64(cfg.seed),
                           row0 + np.arange(B, dtype=np.uint64))
                   % np.uint64(max(n, 1))).astype(np.int64)
            toks = np.stack([self._mm[i:i + S + 1] for i in idx])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def reassign(self, dead_shard: int, step: int) -> dict[str, np.ndarray]:
        """Straggler/failure mitigation: any host can deterministically
        recompute another shard's batch (backup-worker pattern)."""
        backup = Pipeline(self.cfg, dead_shard, self.n_shards)
        return backup.batch_at(step)
