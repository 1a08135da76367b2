"""Agglomerative task clustering for Cluster MHRA (paper §III-F).

Tasks are represented by their (runtime, energy) prediction vectors across
endpoints; average-linkage agglomerative merging proceeds until a cluster's
predicted energy exceeds the node-startup energy (amortization point).
Identical prediction rows (same function) are pre-bucketed so the pairwise
stage runs on bucket centroids — same result, ~O(B^2) instead of O(n^2).
A size cap keeps clusters in the 12–40-task band the paper reports.
"""
from __future__ import annotations

import numpy as np


def agglomerative_cluster(
    features: np.ndarray,       # (n, k) prediction vectors
    energies: np.ndarray,       # (n,) mean predicted energy per task
    energy_cap: float,          # node startup energy
    distance_threshold: float = 0.5,
    max_cluster_size: int = 40,
) -> list[list[int]]:
    n = len(features)
    if n == 0:
        return []
    feats = np.asarray(features, float)
    scale = feats.std(axis=0)
    scale[scale < 1e-12] = 1.0
    norm = feats / scale

    # ---- bucket identical (rounded) rows ----------------------------------
    keys = [tuple(np.round(row, 6)) for row in norm]
    buckets: dict[tuple, list[int]] = {}
    for i, key in enumerate(keys):
        buckets.setdefault(key, []).append(i)

    clusters: list[dict] = []
    for idxs in buckets.values():
        clusters.append({
            "idx": list(idxs),
            "centroid": norm[idxs].mean(axis=0),
            "energy": float(energies[idxs].sum()),
        })

    # ---- average-linkage merging on bucket centroids -----------------------
    def eligible(a, b):
        if a["energy"] + b["energy"] > energy_cap:
            return False
        if len(a["idx"]) + len(b["idx"]) > max_cluster_size:
            return False
        return True

    merged = True
    while merged and len(clusters) > 1:
        merged = False
        best = (None, None, np.inf)
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                if not eligible(clusters[i], clusters[j]):
                    continue
                d = float(np.linalg.norm(
                    clusters[i]["centroid"] - clusters[j]["centroid"]
                ))
                if d < best[2]:
                    best = (i, j, d)
        i, j, d = best
        if i is not None and d <= distance_threshold:
            a, b = clusters[i], clusters[j]
            na, nb = len(a["idx"]), len(b["idx"])
            a["centroid"] = (a["centroid"] * na + b["centroid"] * nb) / (na + nb)
            a["idx"] += b["idx"]
            a["energy"] += b["energy"]
            del clusters[j]
            merged = True

    # ---- split oversized clusters so each fits the caps ---------------------
    out: list[list[int]] = []
    for c in clusters:
        idxs = c["idx"]
        if not idxs:
            continue
        chunk: list[int] = []
        e_sum = 0.0
        for i in idxs:
            e_i = float(energies[i])
            if chunk and (e_sum + e_i > energy_cap or len(chunk) >= max_cluster_size):
                out.append(chunk)
                chunk, e_sum = [], 0.0
            chunk.append(i)
            e_sum += e_i
        if chunk:
            out.append(chunk)
    return out
