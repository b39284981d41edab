"""Synthetic LM token pipeline: deterministic, host-sharded, resumable.

A copy of `repro.data.tokens`: numpy only, so its batches are the JAX
package's bit for bit. It generates Zipf-distributed token streams with
injected n-gram structure so a small model has signal to learn (the loss
falls measurably within a few hundred steps). Sharding: each
data-parallel host slice draws a disjoint counter range; the cursor is
part of the checkpoint, so a restart or an elastic resize re-shards
deterministically."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    shard: int = 0             # this host's shard index
    n_shards: int = 1
    cursor: int = 0            # resumable position (batches consumed)
    zipf_a: float = 1.2
    ngram_period: int = 8      # deterministic structure the model can learn

    def _batch_at(self, index: int) -> Dict[str, np.ndarray]:
        # Deterministic per (seed, shard, index): restart-safe.
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.shard) * 1_000_003 + index)
        z = rng.zipf(self.zipf_a, size=(self.batch_size, self.seq_len))
        tokens = (z - 1) % (self.vocab_size - 2) + 2
        # Inject learnable structure: every `ngram_period`-th token repeats
        # a function of its predecessor.
        prev = np.roll(tokens, 1, axis=1)
        mask = (np.arange(self.seq_len) % self.ngram_period) == 0
        tokens[:, mask] = (prev[:, mask] * 7 + 3) % (self.vocab_size - 2) + 2
        tokens[:, 0] = 1                          # BOS
        return {"tokens": tokens.astype(np.int32),
                "loss_mask": np.ones_like(tokens, np.float32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self._batch_at(self.cursor * self.n_shards + self.shard)
        self.cursor += 1
        return b

    # -- checkpointable state ----------------------------------------------
    def state_dict(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed,
                "shard": self.shard, "n_shards": self.n_shards}

    def load_state_dict(self, d: dict, *, new_shard: Optional[int] = None,
                        new_n_shards: Optional[int] = None):
        """Resume; on elastic resize the cursor is kept and the shard grid
        re-derived, so no sample is replayed within a shard."""
        self.cursor = int(d["cursor"])
        self.seed = int(d["seed"])
        self.shard = new_shard if new_shard is not None else int(d["shard"])
        self.n_shards = (new_n_shards if new_n_shards is not None
                         else int(d["n_shards"]))
