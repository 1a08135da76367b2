"""The port's batch pipeline against the reference's, three successive
``run_batch`` calls on the CPU: reference ``MHRAPolicy(engine="soa")``
against the port's ``MHRAPolicy``, both default executors (Cluster MHRA),
and the Round-Robin / single-site baselines, after ``warmup`` too.  After
every batch the schedules, ``measured_energy_j``, ``attributed_energy_j``
and the profile stores must be equal (``==``).

Both run in one process, so the simulator's monitor seed (Python's
``hash`` of the endpoint name) is the same for both."""
import pytest

from _torch_common import (
    SCHEDULE_FIELDS,
    make_tasks,
    replica_profiles,
    seeded_store,
)
from repro.core.endpoint import scaled_testbed
from repro.core.executor import GreenFaaSExecutor
from repro.core.policy import MHRAPolicy
from repro.core.predictor import TaskProfileStore
from repro.core.testbed import SEBS_FUNCTIONS
from repro.core.testbed import TestbedSim as RefSim
from repro_torch import convert
from repro_torch.core.executor import GreenFaaSExecutor as PortExecutor
from repro_torch.core.policy import MHRAPolicy as PortMHRAPolicy
from repro_torch.core.testbed import TestbedSim as PortSim


def _executors(replicas, alpha):
    eps = scaled_testbed(replicas)
    peps = convert.endpoints(eps)
    if replicas > 1:
        profiles, coefs = replica_profiles(eps)
        sims = (RefSim(eps, profiles=profiles, coefs=coefs, seed=0),
                PortSim(peps, profiles=profiles, coefs=coefs, seed=0))
    else:
        sims = RefSim(eps, seed=0), PortSim(peps, seed=0)
    ref = GreenFaaSExecutor(eps, sims[0], alpha=alpha,
                            policy=MHRAPolicy(engine="soa"))
    port = PortExecutor(peps, sims[1], alpha=alpha, policy=PortMHRAPolicy(),
                        device="cpu")
    ref.store = seeded_store(eps, obs=2)
    port.store = convert.profile_store(ref.store, peps)
    return ref, port, eps


@pytest.mark.parametrize("replicas,n_tasks,shared,alpha", [
    (1, 70, True, 0.5), (2, 96, False, 0.3),
])
def test_three_batches_match_reference(replicas, n_tasks, shared, alpha):
    ref, port, eps = _executors(replicas, alpha)
    for b in range(3):
        tasks = make_tasks(n_tasks, eps[0].name if shared else None,
                           prefix=f"b{b}t")
        r = ref.run_batch(tasks)
        p = port.run_batch(convert.tasks(tasks))
        for f in SCHEDULE_FIELDS:
            assert getattr(r.schedule, f) == getattr(p.schedule, f), (b, f)
        assert r.measured_energy_j == p.measured_energy_j, b
        assert r.attributed_energy_j == p.attributed_energy_j, b
        assert r.makespan_s == p.makespan_s, b
        assert r.transfer_j == p.transfer_j, b
        assert ref.store.stats() == port.store.stats(), b
        assert ({(r.task_id, r.endpoint, r.t_start, r.t_end, r.energy_j)
                 for r in r.sim.records}
                == {(r.task_id, r.endpoint, r.t_start, r.t_end, r.energy_j)
                    for r in p.sim.records}), b
    assert len(port.db.records) == 3 * n_tasks
    assert port.db.energy_by_endpoint() == ref.db.energy_by_endpoint()


def test_unmonitored_batch_matches_reference():
    """monitoring=False learns from the simulator's truth instead."""
    ref, port, eps = _executors(1, 0.5)
    ref.monitoring = port.monitoring = False
    tasks = make_tasks(42, eps[0].name)
    r = ref.run_batch(tasks)
    p = port.run_batch(convert.tasks(tasks))
    assert r.measured_energy_j == p.measured_energy_j
    assert r.schedule.assignments == p.schedule.assignments
    assert ref.store.stats() == port.store.stats()


def test_default_strategy_is_the_reference_s_and_raises_until_ported():
    """Built with no strategy, both executors place with ``cluster_mhra``.
    Every reference policy the executor can name is ported now: the two
    that once refused (``carbon_mhra``, ``lookahead_mhra``) build, and an
    unknown name still raises ``ValueError``."""
    eps = scaled_testbed(1)
    ref = GreenFaaSExecutor(eps, RefSim(eps, seed=0))
    assert ref.strategy == "cluster_mhra" and ref.policy.name == "cluster_mhra"
    peps = convert.endpoints(eps)
    port = PortExecutor(peps, PortSim(peps, seed=0), device="cpu")
    assert port.strategy == "cluster_mhra"
    assert port.policy.name == "cluster_mhra"
    assert port.policy.max_cluster_size == ref.policy.max_cluster_size
    for name in ("carbon_mhra", "lookahead_mhra"):
        ex = PortExecutor(peps, PortSim(peps, seed=0), strategy=name,
                          device="cpu")
        assert ex.policy.name == name
        assert GreenFaaSExecutor(eps, RefSim(eps, seed=0),
                                 strategy=name).policy.name == name
    with pytest.raises(ValueError, match="unknown policy"):
        PortExecutor(peps, PortSim(peps, seed=0), strategy="no_such_policy",
                     device="cpu")
    assert PortExecutor(peps, PortSim(peps, seed=0), strategy="mhra",
                        device="cpu").policy.name == "mhra"


def _default_executors(replicas, alpha, **kw):
    """Both executors as users build them: no strategy, no policy."""
    eps = scaled_testbed(replicas)
    peps = convert.endpoints(eps)
    if replicas > 1:
        profiles, coefs = replica_profiles(eps)
        sims = (RefSim(eps, profiles=profiles, coefs=coefs, seed=0),
                PortSim(peps, profiles=profiles, coefs=coefs, seed=0))
    else:
        sims = RefSim(eps, seed=0), PortSim(peps, seed=0)
    ref = GreenFaaSExecutor(eps, sims[0], alpha=alpha, **kw)
    port = PortExecutor(peps, sims[1], alpha=alpha, device="cpu", **kw)
    ref.store = seeded_store(eps, obs=2)
    port.store = convert.profile_store(ref.store, peps)
    return ref, port, eps


def _assert_batches_equal(r, p, b):
    for f in SCHEDULE_FIELDS:
        a, c = getattr(r.schedule, f), getattr(p.schedule, f)
        if f == "objective" and a != a:     # the fixed baselines' NaN
            assert c != c, b
            continue
        assert a == c, (b, f)
    assert r.measured_energy_j == p.measured_energy_j, b
    assert r.attributed_energy_j == p.attributed_energy_j, b
    assert r.makespan_s == p.makespan_s, b
    assert r.transfer_j == p.transfer_j, b
    assert r.edp() == p.edp(), b


@pytest.mark.parametrize("replicas,n_tasks,shared,alpha", [
    (1, 150, True, 0.5), (2, 260, False, 0.3)])
def test_default_strategy_three_batches_match_reference(replicas, n_tasks,
                                                        shared, alpha):
    """The reference's default executor (Cluster MHRA) and the port's,
    three ``run_batch`` calls: schedules, measured and attributed energy,
    makespan and the profile stores equal after every batch."""
    ref, port, eps = _default_executors(replicas, alpha)
    for b in range(3):
        tasks = make_tasks(n_tasks, eps[0].name if shared else None,
                           prefix=f"b{b}t")
        r = ref.run_batch(tasks)
        p = port.run_batch(convert.tasks(tasks))
        _assert_batches_equal(r, p, b)
        assert ref.store.stats() == port.store.stats(), b
    assert port.db.energy_by_endpoint() == ref.db.energy_by_endpoint()


@pytest.mark.parametrize("kw", [{"strategy": "round_robin"},
                                {"strategy": "single_site", "site": "theta"}])
def test_baseline_executors_match_reference(kw):
    """Table V's baselines through the executor: the round-robin offset
    carries across the three batches."""
    ref, port, eps = _default_executors(1, 0.5, **kw)
    for b in range(3):
        tasks = make_tasks(45, eps[0].name, prefix=f"b{b}t")
        _assert_batches_equal(ref.run_batch(tasks),
                              port.run_batch(convert.tasks(tasks)), b)
    assert ref.store.stats() == port.store.stats()


def test_single_site_executor_refuses_unknown_site():
    eps = scaled_testbed(1)
    peps = convert.endpoints(eps)
    with pytest.raises(ValueError) as ref_err:
        GreenFaaSExecutor(eps, RefSim(eps, seed=0), strategy="single_site",
                          site="nowhere")
    with pytest.raises(ValueError) as port_err:
        PortExecutor(peps, PortSim(peps, seed=0), strategy="single_site",
                     site="nowhere", device="cpu")
    assert str(ref_err.value) == str(port_err.value)


@pytest.mark.parametrize("replicas,per_endpoint", [(1, 3), (2, 2)])
def test_warmup_then_run_batch_matches_reference(replicas, per_endpoint):
    """``warmup`` probes every function on every endpoint from an empty
    store; the stores it leaves, and the default executor's next batch,
    equal the reference's."""
    ref, port, eps = _default_executors(replicas, 0.5)
    ref.store = TaskProfileStore(eps)
    port.store = convert.profile_store(ref.store, port.endpoints)
    ref.warmup(list(SEBS_FUNCTIONS), per_endpoint)
    port.warmup(list(SEBS_FUNCTIONS), per_endpoint)
    assert ref.store.stats() == port.store.stats()
    assert sum(st.n for st in port.store._rt.values()) == \
        per_endpoint * len(SEBS_FUNCTIONS) * len(eps)
    tasks = make_tasks(120, eps[0].name, prefix="after")
    _assert_batches_equal(ref.run_batch(tasks),
                          port.run_batch(convert.tasks(tasks)), 0)
    assert ref.store.stats() == port.store.stats()
