"""The placement pipeline (predict -> place -> run -> attribute -> learn),
in batches and as a stream:

- scheduler:  MHRA and Cluster MHRA (the fused window greedy, or the
              SoA engine for clustered and multi-input windows), the
              Round-Robin / single-site baselines, ``SoAState``
- carbon, dag, faults, fairness: the scoring registers' snapshots
              (grid carbon rates, DAG lookahead weights, warm-pool
              penalties, user debts) and what they are taken from
- clustering: agglomerative task clustering for Cluster MHRA
- policy:     placement policies registrable by name
- executor:   batch executor over the testbed simulator
- engine:     online engine: arrival windows over one live ``SoAState``
- region:     the region router above the endpoint fleet
- testbed:    discrete-event simulator of the paper's Table-I testbed
- database, report: the task/energy DB and its energy reports (§III-G)
- evaluate:   one workload trace replayed per policy: EDP, GPS-UP, gCO2
"""
from repro_torch.core.engine import EngineSummary, OnlineEngine, WindowResult
from repro_torch.core.region import RegionRouter, RegionSpec

__all__ = [
    "EngineSummary",
    "OnlineEngine",
    "RegionRouter",
    "RegionSpec",
    "WindowResult",
]
