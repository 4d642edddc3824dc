"""Token data pipeline: deterministic, shardable, resumable.

Sources:
  * SyntheticLM  — structured pseudo-language (Zipfian unigrams + local
    n-gram structure) so models can actually *learn* during smoke training;
  * FileTokens   — memory-mapped .bin of int32 tokens (production path);
both emit fixed-shape {tokens, labels} batches. The iterator state is a
single integer (step), so checkpoint/restore is exact, and each data-parallel
rank can slice its shard deterministically (shard_id / num_shards).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    path: Optional[str] = None     # set -> FileTokens


class SyntheticLM:
    """Zipf unigrams mixed with a deterministic bigram chain — enough
    structure that cross-entropy drops visibly within ~100 steps."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._succ = rng.integers(0, v, size=v)          # bigram successor table
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.2
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.num_shards + cfg.shard_id
        )
        B, S = cfg.batch_size, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self._p)
        for t in range(1, S + 1):
            follow = rng.random(B) < 0.7                  # 70% bigram-determined
            toks[:, t] = np.where(
                follow, self._succ[toks[:, t - 1]], rng.choice(cfg.vocab_size, size=B, p=self._p)
            )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileTokens:
    """Flat int32 token file; deterministic strided sampling by (step, rank)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n = len(self.data) - cfg.seq_len - 1
        assert self.n > 0, "token file too small"

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.num_shards + cfg.shard_id
        )
        starts = rng.integers(0, self.n, size=cfg.batch_size)
        toks = np.stack([self.data[s : s + cfg.seq_len + 1] for s in starts]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticLM(cfg)
