"""Inputs shared by the sharding tests' processes (numpy only): the
four-rank cases, their batch, and ``psum_compressed``'s per-rank trees."""
from __future__ import annotations

import numpy as np

#: name -> (arch, mesh shape ("data", "model"), attn_strategy or None)
CASES = {
    "granite": ("granite-3-2b", (2, 2), None),
    "granite_seq_cp": ("granite-3-2b", (1, 4), "seq_cp"),
    "zamba2": ("zamba2-2.7b", (2, 2), None),
    "falcon_mamba": ("falcon-mamba-7b", (2, 2), None),
}
ARCHS = sorted({arch for arch, _, _ in CASES.values()})
#: the losses' batch (B x S) is the train step's microbatch: its global
#: batch of TRAIN_B rows splits in two (the sharding propagation of the
#: loss's shapes is cached once for both)
B, S, TRAIN_B = 2, 64, 4
#: the global batch of the two-axis ("pod", "data") row check
BATCH_ROWS = 64
#: cache sizes (bytes) at which serve_rule_overrides is held to the reference
CACHE_BYTES = (0, 10**9, 10**11, 10**13)


def batch(vocab: int) -> dict:
    """B x S tokens and their next tokens, numpy seed 0."""
    toks = np.random.default_rng(0).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def psum_inputs(n: int) -> list[tuple[dict, dict]]:
    """Rank r's (gradient tree, error tree) of an n-rank group: the ranks'
    gradients at scales that differ (r + 1, and one leaf at 10 ** r)."""
    rng = np.random.default_rng(100 + n)
    out = []
    for r in range(n):
        g = {"a": (rng.standard_normal((3, 5)) * (r + 1)).astype(np.float32),
             "b": {"c": (rng.standard_normal(7) * 10.0 ** r).astype(np.float32)}}
        e = {"a": (0.01 * rng.standard_normal((3, 5))).astype(np.float32),
             "b": {"c": (0.01 * rng.standard_normal(7)).astype(np.float32)}}
        out.append((g, e))
    return out
