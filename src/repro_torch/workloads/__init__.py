"""Reproducible workload generators for the evaluation harness.

- :mod:`repro_torch.workloads.arrivals` — Poisson / bursty / diurnal arrival
  processes (seeded, sorted arrival-time arrays).
- :mod:`repro_torch.workloads.synthetic` — the paper's synthetic EDP workload
  (mixed compute/memory/IO function classes over the Table-I testbed).
- :mod:`repro_torch.workloads.multiuser` — the multi-tenant variant: Zipf user
  populations with bursty per-user submission campaigns.
- :mod:`repro_torch.workloads.geo` — the geo-distributed variant: per-region
  fleets, WAN links, regional carbon grids, and caller locality (the
  A/B/C routing evaluation's input).
- :mod:`repro_torch.workloads.moldesign` — the molecular-design DAG workload
  (dock → simulate → train → infer with data dependencies).
- :mod:`repro_torch.workloads.carbon_traces` — per-endpoint grid
  carbon-intensity signals (seeded synthetic + real-trace JSON I/O).
- :mod:`repro_torch.workloads.faults` — seeded endpoint-churn chaos scripts
  and warm-pool fleet variants for the fault-tolerance evaluation.
- :mod:`repro_torch.workloads.wfcommons` — WfCommons/Pegasus JSON importer for
  published workflow DAGs (+ a committed Montage-shaped sample).
- :mod:`repro_torch.workloads.trace` — the :class:`WorkloadTrace` container +
  replay helper every generator returns (and the deadline-distribution
  helper :func:`~repro_torch.workloads.trace.apply_deadline_slack`).
"""
from repro_torch.workloads.arrivals import (
    ARRIVAL_PROCESSES,
    bursty_arrivals,
    diurnal_arrivals,
    make_arrivals,
    poisson_arrivals,
)
from repro_torch.workloads.carbon_traces import (
    load_carbon_signal,
    table1_carbon_signal,
    write_carbon_signal,
)
from repro_torch.workloads.faults import add_failover, churn_fault_trace, with_warm_pool
from repro_torch.workloads.geo import (
    GEO_REGIONS,
    geo_carbon_signal,
    geo_edp_workload,
    geo_region_specs,
    geo_testbed,
)
from repro_torch.workloads.moldesign import (
    MOLDESIGN_DAG_PROFILES,
    moldesign_dag_workload,
    moldesign_endpoints,
)
from repro_torch.workloads.multiuser import multiuser_edp_workload, zipf_user_ranks
from repro_torch.workloads.synthetic import FUNCTION_CLASSES, synthetic_edp_workload
from repro_torch.workloads.trace import WorkloadTrace, apply_deadline_slack
from repro_torch.workloads.wfcommons import load_wfcommons, load_wfcommons_sample

__all__ = [
    "ARRIVAL_PROCESSES",
    "FUNCTION_CLASSES",
    "GEO_REGIONS",
    "MOLDESIGN_DAG_PROFILES",
    "WorkloadTrace",
    "add_failover",
    "apply_deadline_slack",
    "bursty_arrivals",
    "churn_fault_trace",
    "diurnal_arrivals",
    "geo_carbon_signal",
    "geo_edp_workload",
    "geo_region_specs",
    "geo_testbed",
    "load_carbon_signal",
    "load_wfcommons",
    "load_wfcommons_sample",
    "make_arrivals",
    "moldesign_dag_workload",
    "moldesign_endpoints",
    "multiuser_edp_workload",
    "poisson_arrivals",
    "synthetic_edp_workload",
    "table1_carbon_signal",
    "with_warm_pool",
    "write_carbon_signal",
    "zipf_user_ranks",
]
