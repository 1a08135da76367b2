"""The port's fleet layer (``repro_torch/fleet/manager.py``) and its two
examples against the reference's ``repro/fleet/manager.py``, on the CPU.

The three fleet cases of ``tests/test_system.py`` run through both
managers on the same hand-written dry-run JSON and are held ``==``:
placements with their objective, energy, makespan and transfer bits,
``check_health`` and ``events`` (heartbeats at explicit times), the
straggler watch's answers and profile counts, and the live endpoints after
a leave and a join.  The costs and the roofline estimates are held by
bits; the examples' placements and the resumed training run are held to
the reference's manager and to an uninterrupted run.  The port's dry-run
(``repro_torch/launch/dryrun.py``) writes the cells the examples' jobs name;
both packages' ``load_dryrun_costs`` read them to equal dicts, and both
managers place the jobs from them to equal schedules (~7 s to count the four
cells).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_common import assert_schedules_equal
from _torch_eval import load_example
from repro.core.endpoint import EndpointSpec as RefEndpointSpec
from repro.core.endpoint import tpu_fleet as ref_tpu_fleet
from repro.fleet import manager as ref
from repro_torch.core.endpoint import EndpointSpec, tpu_fleet
from repro_torch.fleet import manager as port
from repro_torch.launch import dryrun
from repro_torch.launch.train import train

SCHEDULE_FLOATS = ("objective", "energy_j", "makespan_s", "transfer_j")
POD9 = dict(cores=512, idle_power_w=80 * 512, tdp_w=250 * 512, queue_delay_s=60.0,
            chips=512, peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
# the dry-run record of tests/test_system.py, and one without "extrapolated"
# (the per-device keys then give the costs)
DRYRUN = {
    "extrapolated": {"arch": "granite-3-2b", "shape": "train_4k", "n_devices": 256,
                     "extrapolated": {"flops_extrap": 1e14, "bytes_extrap": 1e12,
                                      "coll_bytes_extrap": 1e10}},
    "per_device": {"arch": "granite-3-2b", "shape": "train_4k", "n_devices": 64,
                   "flops_per_device": 3.7e13, "bytes_accessed_per_device": 2.9e12,
                   "collective_bytes_per_device": 4.1e9},
}


def dryrun_dir(tmp_path, which="extrapolated"):
    d = tmp_path / "dryrun"
    d.mkdir(exist_ok=True)
    (d / "a__train_4k__single.json").write_text(json.dumps(DRYRUN[which]))
    return d


def managers(tmp_path, d, alpha=0.5):
    """The reference's manager and the port's on the CPU, over the same
    dry-run directory (``None``: no costs; the reference then globs a
    directory that does not exist)."""
    ref_dir = d if d is not None else tmp_path / "no-dryrun"
    return (ref.FleetManager(ref_tpu_fleet(), ref_dir, alpha),
            port.FleetManager(tpu_fleet(), d, alpha, device="cpu"))


def bits(x: float) -> str:
    return float(x).hex()


def assert_placed_equal(r, p):
    assert_schedules_equal(r, p)
    assert [bits(getattr(r, f)) for f in SCHEDULE_FLOATS] == \
        [bits(getattr(p, f)) for f in SCHEDULE_FLOATS]


def jobs_of(module, jobs):
    return [module.FleetJob(**dataclasses.asdict(j)) for j in jobs]


def test_fleet_placement_and_heartbeats_match_reference(tmp_path):
    rm, pm = managers(tmp_path, dryrun_dir(tmp_path))
    jobs = [port.FleetJob(id=f"j{i}", arch="granite-3-2b", shape="train_4k")
            for i in range(6)]
    assert_placed_equal(rm.place(jobs_of(ref, jobs)), pm.place(jobs))
    t0 = 1000.0
    for mgr in (rm, pm):
        for name in mgr.endpoints:
            mgr.heartbeat(name, now=t0)
        mgr.heartbeat("pod0", now=t0)  # pod0 then goes silent
        for name in mgr.endpoints:
            if name != "pod0":
                mgr.heartbeat(name, now=t0 + port.HEARTBEAT_TIMEOUT_S + 5)
    down = [mgr.check_health(now=t0 + port.HEARTBEAT_TIMEOUT_S + 5) for mgr in (rm, pm)]
    assert down[0] == down[1] == ["pod0"]
    assert rm.events == pm.events
    assert rm.check_health(now=t0 + 100.0) == pm.check_health(now=t0 + 100.0) == []
    s_ref, s_port = rm.place(jobs_of(ref, jobs)), pm.place(jobs)
    assert_placed_equal(s_ref, s_port)
    assert "pod0" not in set(s_port.assignments.values())
    assert port.HEARTBEAT_TIMEOUT_S == ref.HEARTBEAT_TIMEOUT_S
    assert port.STRAGGLER_SIGMA == ref.STRAGGLER_SIGMA


def test_fleet_straggler_detection_matches_reference(tmp_path):
    rm, pm = managers(tmp_path, dryrun_dir(tmp_path))
    job = port.FleetJob(id="j0", arch="granite-3-2b", shape="train_4k")
    rjob = jobs_of(ref, [job])[0]
    rng = np.random.default_rng(0)
    seq = [1.0 + rng.normal(0, 0.01) for _ in range(10)] + [1.01, 5.0, 1.0, 9.0]
    answers = [[mgr.observe_step(j, "pod0", seconds=s, energy_j=100.0) for s in seq]
               for mgr, j in ((rm, rjob), (pm, job))]
    assert answers[0] == answers[1]
    assert answers[1][10:12] == [False, True]
    assert rm.events == pm.events
    assert any("straggler" in e for e in pm.events)
    for name in pm.endpoints:
        assert rm.store.n_obs(job.fn, name) == pm.store.n_obs(job.fn, name)
    assert rm.store.stats() == pm.store.stats()


def test_fleet_elastic_join_leave_matches_reference(tmp_path):
    rm, pm = managers(tmp_path, dryrun_dir(tmp_path))
    jobs = [port.FleetJob(id=f"j{i}", arch="granite-3-2b", shape="train_4k")
            for i in range(4)]
    for mgr in (rm, pm):
        mgr.endpoint_leave("pod1")
    assert [e.name for e in rm.live_endpoints()] == [e.name for e in pm.live_endpoints()]
    s_ref, s_port = rm.place(jobs_of(ref, jobs)), pm.place(jobs)
    assert_placed_equal(s_ref, s_port)
    assert "pod1" not in set(s_port.assignments.values())
    rm.endpoint_join(RefEndpointSpec("pod9", **POD9))
    pm.endpoint_join(EndpointSpec("pod9", **POD9))
    assert [e.name for e in rm.live_endpoints()] == [e.name for e in pm.live_endpoints()]
    assert "pod9" in {e.name for e in pm.live_endpoints()}
    assert rm.events == pm.events
    # the joined endpoint's profiles are seeded at the next placement
    assert_placed_equal(rm.place(jobs_of(ref, jobs)), pm.place(jobs))


@pytest.mark.parametrize("which", sorted(DRYRUN))
def test_costs_and_estimates_match_reference_bitwise(tmp_path, which):
    d = dryrun_dir(tmp_path, which)
    costs = port.load_dryrun_costs(d)
    assert costs == ref.load_dryrun_costs(d)
    cost = costs["granite-3-2b:train_4k"]
    pairs = list(zip(ref_tpu_fleet(), tpu_fleet())) + [
        (RefEndpointSpec("pod9", **POD9), EndpointSpec("pod9", **POD9))]
    for r_ep, p_ep in pairs:
        t_ref = ref.predict_step_seconds(cost, r_ep)
        t_port = port.predict_step_seconds(cost, p_ep)
        assert bits(t_ref) == bits(t_port), p_ep.name
        assert bits(ref.predict_step_energy(cost, r_ep, t_ref)) == \
            bits(port.predict_step_energy(cost, p_ep, t_port)), p_ep.name


def _waves():
    serve = load_example("torch_fleet_serve").wave()
    trained = port.FleetJob(id="lm-pretrain", arch="granite-3-2b", shape="train_4k",
                            steps=60, checkpoint_bytes=5e9)
    return {"train": ([trained], None), "train after leave": ([trained], "slice0"),
            "serve": (serve, None)}


@pytest.mark.parametrize("costs", [False, True], ids=["priors", "dryrun"])
@pytest.mark.parametrize("wave", ["train", "train after leave", "serve"])
def test_waves_match_reference(tmp_path, wave, costs):
    jobs, leave = _waves()[wave]
    rm, pm = managers(tmp_path, dryrun_dir(tmp_path) if costs else None,
                      alpha=0.3 if wave == "serve" else 0.5)
    if leave:
        for mgr in (rm, pm):
            mgr.place(jobs_of(ref, jobs) if mgr is rm else jobs)
            mgr.endpoint_leave(leave)
    assert_placed_equal(rm.place(jobs_of(ref, jobs)), pm.place(jobs))


@pytest.fixture(scope="module")
def port_dryrun(tmp_path_factory):
    """The port's dry-run files for the cells the fleet examples' jobs name
    (granite-3-2b train_4k and decode_32k, qwen3-14b prefill_32k,
    zamba2-2.7b decode_32k), written by its command line."""
    d = tmp_path_factory.mktemp("port_dryrun")
    jobs = [j for js, _ in _waves().values() for j in js]
    cells = sorted({(j.arch, j.shape) for j in jobs})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch, shape in cells:
            dryrun.main(["--arch", arch, "--shape", shape, "--out", str(d)])
    finally:
        torch.set_num_threads(n)
    return d, cells


def test_port_dryrun_files_read_as_the_reference_reads_them(port_dryrun):
    d, cells = port_dryrun
    assert sorted(p.name for p in d.glob("*__single.json")) == \
        sorted(f"{a}__{s}__single.json" for a, s in cells)
    assert len(cells) == 4
    costs = port.load_dryrun_costs(d)
    assert costs == ref.load_dryrun_costs(d)
    assert sorted(costs) == sorted(f"{a}:{s}" for a, s in cells)
    for fn, c in costs.items():
        r = json.loads((d / f"{fn.replace(':', '__')}__single.json").read_text())
        assert "extrapolated" not in r and r["mesh"] == "single_card"
        assert c == {"flops": r["flops_per_device"], "bytes": r["bytes_accessed_per_device"],
                     "coll_bytes": 0, "n_devices": 1}
        assert c["flops"] > 0 and c["bytes"] > 0


@pytest.mark.parametrize("wave", ["train", "train after leave", "serve"])
def test_waves_on_port_dryrun_match_reference(tmp_path, port_dryrun, wave):
    """The training job, its re-placement after its endpoint leaves and the
    serving wave, placed from the port's dry-run costs by the reference's
    manager and by the port's on the CPU: equal schedules, floats by bits."""
    jobs, leave = _waves()[wave]
    rm, pm = managers(tmp_path, port_dryrun[0], alpha=0.3 if wave == "serve" else 0.5)
    if leave:
        for mgr in (rm, pm):
            mgr.place(jobs_of(ref, jobs) if mgr is rm else jobs)
            mgr.endpoint_leave(leave)
    assert_placed_equal(rm.place(jobs_of(ref, jobs)), pm.place(jobs))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.FleetManager(tpu_fleet(), None)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example("torch_fleet_train").main(["--steps", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example("torch_fleet_serve").main([])


@pytest.fixture
def one_thread():
    """The examples' model runs in one intra-op thread: under pytest-xdist
    the workers share the cores, and a thread a core each oversubscribes
    them (the training case ran ~7x slower beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fleet_train_example_places_and_resumes(tmp_path, one_thread):
    """4 steps, which checkpoint every 2: placed, the endpoint leaves after
    step 2, re-placed, resumed; both placements == the reference manager's
    after the same observed steps, every loss == an uninterrupted run's."""
    out = load_example("torch_fleet_train").main(
        ["--steps", "4", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ckpt")])
    rm = ref.FleetManager(ref_tpu_fleet(), tmp_path / "no-dryrun", 0.5)
    rjob = ref.FleetJob(id="lm-pretrain", arch="granite-3-2b", shape="train_4k",
                        steps=4, checkpoint_bytes=5e9)
    first = rm.place([rjob])
    # the steps before the leave, fed to the reference's profiles as the
    # example fed them to the port's
    for o in out["observed"][:2]:
        rm.observe_step(rjob, o["endpoint"], o["seconds"], energy_j=o["seconds"] * 100.0)
    rm.endpoint_leave(first.assignments[rjob.id])
    second = rm.place([rjob])
    for r, p in zip((first, second), out["schedules"]):
        assert_placed_equal(r, p)
    assert out["targets"] == (first.assignments[rjob.id], second.assignments[rjob.id])
    assert out["events"] == rm.events
    assert [(o["endpoint"], o["step"]) for o in out["observed"]] == [
        (out["targets"][0], 0), (out["targets"][0], 1),
        (out["targets"][1], 2), (out["targets"][1], 3)]
    _, want, _ = train(arch="granite-3-2b", reduced=True, steps=4, batch=8, seq=128,
                       log_every=20, device="cpu")
    before, resumed = out["losses"]
    assert before == want[:2]
    assert resumed == want[2:]
    assert [r["step"] for r in out["run"]["steps"]] == [2, 3]


def test_fleet_serve_example_places_like_reference(tmp_path, one_thread):
    example = load_example("torch_fleet_serve")
    out = example.main(["--device", "cpu"])
    rm = ref.FleetManager(ref_tpu_fleet(), tmp_path / "no-dryrun", 0.3)
    want = rm.place(jobs_of(ref, example.wave()))
    assert_placed_equal(want, out["schedule"])
    assert sum(out["load"].values()) == 11
    assert out["served"]["job"] == "chat0"
    assert out["served"]["endpoint"] == want.assignments["chat0"]
    assert out["served"]["tokens"].shape == (4, 16)
