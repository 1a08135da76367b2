"""The port's batch pipeline against the reference's, three successive
``run_batch`` calls: reference ``MHRAPolicy(engine="soa")`` against the
port on the CPU.  After every batch the schedules, ``measured_energy_j``,
``attributed_energy_j`` and the profile stores must be equal (``==``).

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
    """Built with no strategy, the reference's executor places with
    ``cluster_mhra``; the port has the same default and, until that policy
    is ported, refuses loudly instead of placing with another algorithm."""
    eps = scaled_testbed(1)
    ref = GreenFaaSExecutor(eps, RefSim(eps, seed=0))
    assert ref.strategy == "cluster_mhra" and ref.policy.name == "cluster_mhra"
    peps = convert.endpoints(eps)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 1"):
        PortExecutor(peps, PortSim(peps, seed=0), device="cpu")
    assert PortExecutor(peps, PortSim(peps, seed=0), strategy="mhra",
                        device="cpu").policy.name == "mhra"
