"""Minimal WfCommons / Pegasus workflow-trace importer.

`WfCommons <https://wfcommons.org>`_ publishes execution traces of real
scientific workflows (Montage, Epigenomics, SoyKB, ...) in a JSON "wfformat".
This module imports the subset the scheduling harness needs — task
identities, dependency edges, measured runtimes, and file payloads — into
a :class:`~repro_torch.workloads.trace.WorkloadTrace`, so the online engine's
ready-set and the lookahead policies run against *published* DAG shapes
instead of only the generated molecular-design pipeline.

Supported input (both the 1.x ``jobs`` and newer ``tasks`` spellings):

.. code-block:: json

    {"workflow": {"tasks": [
        {"name": "mProject_00000001", "category": "mProject",
         "runtimeInSeconds": 12.3, "parents": ["..."],
         "files": [{"link": "input", "sizeInBytes": 4000000,
                    "name": "region.fits"}]}
    ]}}

Import model (deliberately minimal, documented over clever):

- **function identity**: the task's ``category`` field, else its name
  with one trailing ``_<digits>``/``_ID...`` instance suffix stripped —
  instances of one workflow stage share profiles.
- **runtime profiles**: per-function mean of the recorded runtimes,
  mapped onto each endpoint as ``mean / perf_scale`` (faster machines run
  it proportionally faster) with dynamic watts ``0.5 * tdp / cores``.
- **dependency payloads**: a child's ``dep_bytes`` (bytes pulled from
  *each* parent) is the total size of its input files that appear among
  its parents' outputs, divided by the parent count; edges whose traces
  carry no file data at all (no child inputs or no parent outputs
  recorded) fall back to ``default_dep_bytes``, while recorded-but-
  unmatched file sets stay at their true zero (control-only edges are
  free).
- **submission order**: Kahn topological order, stable in file order, at
  a seeded Poisson ``submit_rate_hz`` — the whole campaign is declared up
  front and the engine's ready-set serializes the waves, exactly like the
  molecular-design generator.

A small hand-written Montage-shaped sample ships at
``repro_torch/workloads/data/wfcommons_montage_sample.json`` so the import path
is exercised offline (``load_wfcommons_sample``).
"""
from __future__ import annotations

import json
import pathlib
import re
from typing import Sequence

import numpy as np

from repro_torch.core.endpoint import EndpointSpec, table1_testbed
from repro_torch.core.scheduler import TaskSpec
from repro_torch.workloads.arrivals import poisson_arrivals
from repro_torch.workloads.trace import WorkloadTrace, apply_deadline_slack

SAMPLE_PATH = (
    pathlib.Path(__file__).parent / "data" / "wfcommons_montage_sample.json"
)

_INSTANCE_SUFFIX = re.compile(r"_(ID)?\d+$")


def _category(task: dict) -> str:
    cat = task.get("category")
    if cat:
        return cat
    return _INSTANCE_SUFFIX.sub("", task["name"]) or task["name"]


def _runtime(task: dict) -> float:
    rt = task.get("runtimeInSeconds", task.get("runtime"))
    if rt is None:
        raise ValueError(
            f"task {task.get('name')!r} has no runtime/runtimeInSeconds"
        )
    return float(rt)


def _file_size(f: dict) -> float:
    return float(f.get("sizeInBytes", f.get("size", 0.0)))


def load_wfcommons(
    path: str | pathlib.Path,
    endpoints: Sequence[EndpointSpec] | None = None,
    submit_rate_hz: float = 32.0,
    runtime_scale: float = 1.0,
    default_dep_bytes: float = 1e6,
    seed: int = 0,
    name: str | None = None,
    deadline_slack: tuple[float, float] | None = None,
) -> WorkloadTrace:
    """Import one WfCommons/Pegasus JSON trace as a replayable workload.

    ``runtime_scale`` rescales every recorded runtime (published traces
    can span hours; scale them into simulation-friendly seconds without
    changing the DAG's relative shape).  ``deadline_slack`` threads
    through :func:`~repro_torch.workloads.trace.apply_deadline_slack`.
    """
    path = pathlib.Path(path)
    data = json.loads(path.read_text())
    wf = data.get("workflow", data)
    raw = wf.get("tasks") or wf.get("jobs")
    if not raw:
        raise ValueError(f"{path}: no workflow.tasks / workflow.jobs array")
    eps = list(endpoints) if endpoints is not None else table1_testbed()

    by_name = {t["name"]: t for t in raw}
    if len(by_name) != len(raw):
        raise ValueError(f"{path}: duplicate task names")
    parents: dict[str, list[str]] = {t["name"]: [] for t in raw}
    for t in raw:
        ps = t.get("parents")
        if ps is not None:
            parents[t["name"]] = [p for p in ps if p in by_name]
    # derive missing parent lists from children (some 1.x traces only
    # record the downward edges)
    for t in raw:
        for c in t.get("children", ()):
            if c in parents and t["name"] not in parents[c]:
                parents[c].append(t["name"])

    # Kahn topological order, stable in file order
    order: list[str] = []
    indeg = {n: len(ps) for n, ps in parents.items()}
    frontier = [t["name"] for t in raw if indeg[t["name"]] == 0]
    children: dict[str, list[str]] = {n: [] for n in by_name}
    for n, ps in parents.items():
        for p in ps:
            children[p].append(n)
    head = 0
    while head < len(frontier):
        n = frontier[head]
        head += 1
        order.append(n)
        for c in children[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                frontier.append(c)
    if len(order) != len(raw):
        cyclic = sorted(n for n, d in indeg.items() if d > 0)
        raise ValueError(f"{path}: dependency cycle through {cyclic[:5]}")

    # per-function mean runtime -> per-endpoint profiles
    cat_rt: dict[str, list[float]] = {}
    for t in raw:
        cat_rt.setdefault(_category(t), []).append(_runtime(t))
    profiles = {
        fn: {
            ep.name: (
                float(np.mean(rts)) * runtime_scale / ep.perf_scale,
                0.5 * ep.tdp_w / ep.cores,
            )
            for ep in eps
        }
        for fn, rts in cat_rt.items()
    }
    signatures = {
        fn: np.array([1.0 + (i % 4), 2.0 - (i % 3) * 0.25,
                      1.0 + (i % 2) * 0.5, 1.0])
        for i, fn in enumerate(sorted(cat_rt))
    }

    tasks: list[TaskSpec] = []
    for n in order:
        t = by_name[n]
        deps = tuple(parents[n])
        dep_bytes = 0.0
        if deps:
            produced = {
                f.get("name"): _file_size(f)
                for p in deps
                for f in by_name[p].get("files", ())
                if f.get("link") == "output"
            }
            inputs = [f for f in t.get("files", ())
                      if f.get("link") == "input"]
            if not inputs or not produced:
                # trace carries no file data for this edge: fall back
                dep_bytes = default_dep_bytes
            else:
                # recorded data, possibly legitimately zero parent bytes
                # (control-only edges stay free)
                dep_bytes = sum(
                    _file_size(f) for f in inputs
                    if f.get("name") in produced
                ) / len(deps)
        tasks.append(TaskSpec(id=n, fn=_category(t), deps=deps,
                              dep_bytes=dep_bytes))

    arrivals = poisson_arrivals(len(tasks), submit_rate_hz, seed=seed)
    if deadline_slack is not None:
        tasks = apply_deadline_slack(tasks, arrivals, profiles,
                                     deadline_slack, seed=seed + 3)
    return WorkloadTrace(
        name=name or f"wfcommons_{data.get('name', path.stem)}",
        tasks=tasks,
        arrivals=arrivals,
        endpoints=eps,
        profiles=profiles,
        signatures=signatures,
        meta={
            "source": str(path),
            "schema": data.get("schemaVersion", "unknown"),
            "functions": sorted(cat_rt),
            "seed": seed,
        },
    )


def load_wfcommons_sample(**kwargs) -> WorkloadTrace:
    """The committed Montage-shaped sample trace (19 tasks, 4 stages of
    fan-out/fan-in) through :func:`load_wfcommons`."""
    return load_wfcommons(SAMPLE_PATH, **kwargs)
