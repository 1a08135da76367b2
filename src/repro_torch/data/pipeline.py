"""Deterministic synthetic token pipeline, shardable across hosts: a copy
of the reference's ``data/pipeline.py`` in numpy (the reference imports
``jax`` there without using it; the port does not).

Every (seed, step, shard) triple yields the same batch on every process,
and the same arrays as the reference's: no data server, restart-safe
(resume from any step).  ``batch_at`` returns numpy arrays; the trainer
moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0          # this host's shard index
    num_shards: int = 1
    structured: bool = True  # markov-ish stream so loss can actually drop

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"a global batch of {self.global_batch} does not split "
                             f"into {self.num_shards} shards")
        self.local_batch = self.global_batch // self.num_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.uint64(self.seed) * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(9_973)
            + np.uint64(self.shard)
        )
        if self.structured:
            # tokens follow t' = (a*t + b) mod V with noise: learnable structure
            a = 31 + (step % 7)
            start = rng.integers(0, self.vocab, size=(self.local_batch, 1))
            idx = np.arange(self.seq_len + 1)
            toks = (start + idx * a) % self.vocab
            noise = rng.random((self.local_batch, self.seq_len + 1)) < 0.05
            toks = np.where(noise, rng.integers(0, self.vocab, toks.shape), toks)
        else:
            toks = rng.integers(0, self.vocab, (self.local_batch, self.seq_len + 1))
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
