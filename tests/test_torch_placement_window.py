"""Port MHRA window placement (``repro_torch.core.scheduler.mhra``, the
fused window greedy) against the reference: ``==`` on assignments,
objective, energy, makespan, transfer, heuristic and timeline — against
``engine="soa"`` in process on every case, and against ``engine="jax"``
(the Pallas kernel in interpret mode) in a subprocess.  The CUDA window
kernel on the card is in ``test_torch_gpu.py``."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_common import (
    assert_schedules_equal,
    port_registers,
    reference_case,
    register_case,
    to_port,
)
from repro.core import scheduler as ref_sched
from repro.core.scheduler import SoAState
from repro_torch import convert
from repro_torch.core import scheduler as port_sched
from repro_torch.kernels.placement import kernel, ops

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _both(tasks, eps, store, tm, alpha, **kw):
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=alpha, engine="soa", **kw)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    b = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=alpha, device="cpu",
                        **kw)
    return a, b


@pytest.mark.parametrize("alpha", [0.0, 0.2, 0.5, 0.8, 1.0])
def test_matches_soa_table5_alphas(alpha):
    tasks, eps, store, tm = reference_case(84)
    a, b = _both(tasks, eps, store, tm, alpha)
    assert_schedules_equal(a, b)


@pytest.mark.parametrize("replicas,n_tasks,shared", [
    (1, 70, False), (2, 112, True), (2, 56, False), (8, 96, True),
    (8, 64, False),
])
def test_matches_soa_scaled_fleets(replicas, n_tasks, shared):
    tasks, eps, store, tm = reference_case(n_tasks, replicas, shared)
    a, b = _both(tasks, eps, store, tm, 0.3)
    assert_schedules_equal(a, b)


@pytest.mark.parametrize("replicas,dead", [(1, (1,)), (2, (0, 5)),
                                           (8, (3, 17, 30))])
def test_matches_soa_with_alive_mask(replicas, dead):
    tasks, eps, store, tm = reference_case(63, replicas, True)
    alive = tuple(i not in dead for i in range(len(eps)))
    a, b = _both(tasks, eps, store, tm, 0.4, alive=alive)
    assert_schedules_equal(a, b)
    assert not {eps[i].name for i in dead} & set(b.assignments.values())


@pytest.mark.parametrize("seed,replicas", [(1, 1), (2, 2)])
def test_matches_soa_with_not_before_floors(seed, replicas):
    tasks, eps, store, tm = reference_case(77, replicas, True, seed=seed,
                                           nb_max=40.0)
    a, b = _both(tasks, eps, store, tm, 0.5)
    assert_schedules_equal(a, b)


@pytest.mark.parametrize("n_tasks,shared", [(40, True), (24, False)])
def test_matches_soa_at_400_endpoints(n_tasks, shared):
    """scaled_testbed(100): 400 endpoints, the fleet the window kernel's
    shared-memory slot matrix once refused on the card."""
    tasks, eps, store, tm = reference_case(n_tasks, 100, shared, nb_max=10.0)
    assert len(eps) == 400
    a, b = _both(tasks, eps, store, tm, 0.5)
    assert_schedules_equal(a, b)


def test_matches_soa_on_live_state_across_windows():
    """Window 2 placed against the state window 1 left: the reference's
    SoA state is carried into the port with ``convert.soa_state``."""
    tasks, eps, store, tm = reference_case(90, 2, True)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    ref_state = SoAState(eps, tm)
    w1 = ref_sched.mhra(tasks[:50], eps, store, tm, alpha=0.5, engine="soa",
                        state=ref_state)
    port_state = convert.soa_state(ref_state, peps, ptm)
    a = ref_sched.mhra(tasks[50:], eps, store, tm, alpha=0.5, engine="soa",
                       state=ref_state)
    b = port_sched.mhra(ptasks[50:], peps, pstore, ptm, alpha=0.5,
                        state=port_state, device="cpu")
    assert w1.assignments
    assert_schedules_equal(a, b)
    assert ref_state.metrics() == port_state.metrics()
    assert ref_state.cached == port_state.cached
    np.testing.assert_array_equal(ref_state.free, port_state.free)


def test_matches_soa_heuristic_subset():
    tasks, eps, store, tm = reference_case(49, 2, True)
    hs = ("lowest_energy_first", "shortest_runtime_first")
    a, b = _both(tasks, eps, store, tm, 0.6, heuristics=hs)
    assert_schedules_equal(a, b)


def test_empty_window_matches_soa():
    _, eps, store, tm = reference_case(7)
    a, b = _both([], eps, store, tm, 0.5)
    assert_schedules_equal(a, b)


def test_multi_input_tasks_go_to_the_soa_engine():
    """A window with a multi-input task, which the fused window cannot
    express and the port once refused with ``NotImplementedError``, now
    goes to the SoA engine and equals the reference's soa result."""
    tasks, eps, store, tm = reference_case(14)
    two = ((eps[0].name, 1, 1e8, True), (eps[1].name, 1, 5e7, False))
    tasks[3] = ref_sched.TaskSpec(id="x", fn=tasks[3].fn, inputs=two)
    a, b = _both(tasks, eps, store, tm, 0.5)
    assert_schedules_equal(a, b)
    assert b.timeline["x"][0] > 0.0


def test_cpu_window_does_not_launch_kernels():
    tasks, eps, store, tm = reference_case(21)
    kernel.reset_launches()
    port_sched.mhra(*to_port(tasks, eps, store), device="cpu")
    assert kernel.LAUNCHES == {"score_fleet": 0, "greedy_window": 0}


def test_greedy_window_wrapper_runs_plain_on_cpu_without_launching():
    tasks, eps, store, tm = reference_case(33, 2, True, nb_max=10.0)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    table = port_sched.PredictionTable(ptasks, peps, pstore)
    sf1, sf2, _ = port_sched._normalizers_fast(ptasks, peps, table, ptm)
    n_ep, consts, init, xs, _ = port_sched.window_inputs(
        [[t] for t in ptasks], [[i] for i in range(len(ptasks))], peps,
        table, ptm, 0.5, port_sched.HEURISTICS, sf1, sf2,
        port_sched.SoAState(peps, ptm), None, "cpu")
    p, n_units = ops.pack(consts, init, xs, "cpu")
    kernel.reset_launches()
    got = kernel.greedy_window(p, n_ep, n_units)
    want = ops._greedy_scan_plain(p, n_ep, n_units)
    assert kernel.LAUNCHES == {"score_fleet": 0, "greedy_window": 0}
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_lane_buckets():
    assert [ops.bucket_pow2(v) for v in (0, 1, 2, 3, 9, 64, 65)] == \
        [1, 1, 2, 4, 16, 64, 128]
    assert ops.bucket_pow2(3, minimum=8) == 8
    assert [ops.lane_bucket(n, "cpu") for n in (1, 4, 12, 32, 33)] == \
        [1, 4, 16, 32, 64]
    assert [ops.lane_bucket(n, "cuda") for n in (1, 4, 32, 33, 1000)] == \
        [32, 32, 32, 64, 1024]


# ---------------------------------------------------------------------------
# the reference's fused JAX engine, in a subprocess (jax 0.9 needs a shim
# for the reference's placement ops; doing it in process would change
# what other test files in the same worker see)
# ---------------------------------------------------------------------------

#: (n_tasks, replicas, shared input, alpha, dead endpoints, not_before
#: max, profile jitter seed, register seed: None, or the seed from which
#: each side builds all four scoring snapshots with ``register_case``)
JAX_CASES = ((28, 1, True, 0.5, (), 0.0, None, None),
             (48, 2, False, 0.3, (2,), 30.0, None, None))
#: small enough to run the scan op by op (about a second per task), with
#: jittered profiles so that every register carries full-precision doubles
EAGER_CASE = (14, 2, True, 0.4, (1,), 0.0, 3, None)
#: all four registers armed, producer-aware hop vectors, floors, a dead
#: endpoint: the jitted engine, and one op by op
JAX_REGISTER_CASE = (40, 2, True, 0.4, (1,), 15.0, 6, 21)
EAGER_REGISTER_CASE = (16, 2, True, 0.4, (), 8.0, 3, 22)

_JAX_SCRIPT = r"""
import json, sys
import jax, jax.experimental
# jax 0.9 dropped jax.experimental.enable_x64, which the reference's
# placement ops import; give it the context manager it expects
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
import numpy as np
tests_dir, cases, out_dir, eager = sys.argv[1:5]
sys.path[:0] = [tests_dir]
from _torch_common import reference_case, register_case
from repro.core import scheduler as S
from repro.kernels.placement import ops as pops
_window = pops.greedy_window
captured = {}


def capture(n_ep, consts, init, xs):
    if eager == "1":
        # op by op: each jnp op rounds on its own, no fused FMAs
        with jax.disable_jit():
            carry, ys = _window(n_ep, consts, init, xs)
    else:
        carry, ys = _window(n_ep, consts, init, xs)
    flat = {"n_ep": np.asarray(n_ep)}
    flat.update({"consts." + k: v for k, v in consts.items() if k != "scalars"})
    flat.update({"scalars." + k: v for k, v in consts["scalars"].items()})
    flat.update({"init." + k: v for k, v in init.items()})
    flat.update({"xs." + k: v for k, v in xs.items()})
    flat.update({"out." + k: v for k, v in carry.items()})
    flat.update({"ys.%d" % i: v for i, v in enumerate(ys)})
    captured.update(flat)
    return carry, ys


pops.greedy_window = capture
out = []
for ci, (n, rep, shared, alpha, dead, nb, jit, rseed) in enumerate(
        json.loads(cases)):
    tasks, eps, store, tm = reference_case(n, rep, shared, nb_max=nb,
                                           jitter_seed=jit)
    kw = {}
    if rseed is not None:
        tasks, kw = register_case(tasks, eps, rseed)
    alive = tuple(i not in dead for i in range(len(eps))) if dead else None
    before = pops.COMPILE_STATS["compiles"]
    S.reset_memo_stats()
    s = S.mhra(tasks, eps, store, tm, alpha=alpha, engine="jax", alive=alive,
               **kw)
    assert pops.COMPILE_STATS["compiles"] == before + 1, "fell back to soa"
    np.savez("%s/case%d.npz" % (out_dir, ci), **captured)
    out.append({
        "assignments": s.assignments, "heuristic": s.heuristic,
        "objective": s.objective.hex(), "energy_j": s.energy_j.hex(),
        "makespan_s": s.makespan_s.hex(), "transfer_j": s.transfer_j.hex(),
        "timeline": {k: [a.hex(), b.hex()] for k, (a, b) in s.timeline.items()},
        "carbon_g": None if s.carbon_g is None else s.carbon_g.hex(),
        "memo": dict(S.MEMO_STATS),
    })
print("RESULT " + json.dumps(out))
"""


def _run_reference_jax(cases, out_dir, backend, eager):
    """The reference's ``mhra(engine="jax")`` on ``cases`` in a fresh
    interpreter; returns its schedules (floats as hex) and leaves each
    window's scan inputs and outputs in ``out_dir/case<i>.npz``."""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", REPRO_PLACEMENT_BACKEND=backend,
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), env.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(ROOT / "tests"),
         json.dumps(cases), str(out_dir), "1" if eager else "0"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("RESULT "))
    got = json.loads(line[len("RESULT "):])
    assert len(got) == len(cases)
    return got


def _port_schedule(case):
    n, rep, shared, alpha, dead, nb, jit, rseed = case
    tasks, eps, store, _ = reference_case(n, rep, shared, nb_max=nb,
                                          jitter_seed=jit)
    kw = {}
    if rseed is not None:
        tasks, kw = register_case(tasks, eps, rseed)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    alive = tuple(i not in dead for i in range(len(eps))) if dead else None
    port_sched.reset_memo_stats()
    return port_sched.mhra(ptasks, peps, pstore, ptm, alpha=alpha,
                           alive=alive, device="cpu", **port_registers(kw))


def _assert_matches_hex(b, ref):
    assert b.assignments == ref["assignments"]
    assert b.heuristic == ref["heuristic"]
    for f in ("objective", "energy_j", "makespan_s", "transfer_j"):
        assert getattr(b, f) == float.fromhex(ref[f]), f
    assert b.timeline == {
        k: (float.fromhex(a), float.fromhex(e))
        for k, (a, e) in ref["timeline"].items()
    }
    want_g = ref["carbon_g"]
    assert b.carbon_g == (None if want_g is None else float.fromhex(want_g))
    assert port_sched.MEMO_STATS == ref["memo"]


def test_matches_reference_jax_engine_pallas_interpret(tmp_path):
    """Schedules ``==`` the reference's fused JAX engine with its Pallas
    score kernel in interpret mode."""
    got = _run_reference_jax(JAX_CASES, tmp_path, "pallas", eager=False)
    for case, ref in zip(JAX_CASES, got):
        _assert_matches_hex(_port_schedule(case), ref)


def test_plain_scan_matches_eager_jax_scan_registers(tmp_path):
    """Fed the reference scan's own inputs, the port's plain window greedy
    ends with the scan's carry and per-step streams double for double.

    The reference scan runs op by op (``jax.disable_jit``): jitted,
    XLA:CPU may contract a multiply-add into one FMA and leave a run
    register one ulp off the SoA engine's NumPy arithmetic, which the
    port reproduces (no decision changes either way).
    """
    _assert_plain_scan_matches_eager(EAGER_CASE, tmp_path)


def test_matches_reference_jax_engine_with_registers(tmp_path):
    """All four registers armed, with producer-aware hop vectors (a hop
    table of many rows), ``==`` the reference's fused JAX engine with its
    Pallas score kernel in interpret mode, ``carbon_g`` and the run-memo
    counts included."""
    got = _run_reference_jax([JAX_REGISTER_CASE], tmp_path, "pallas",
                             eager=False)
    _assert_matches_hex(_port_schedule(JAX_REGISTER_CASE), got[0])


def test_plain_scan_matches_eager_jax_scan_with_registers(tmp_path):
    """The eager comparison with every register armed: the carbon, lookahead
    and fairness run registers (``g_base_r``, ``lk_r``, ``fw_r``), the
    carbon basis ``cg_sum_b`` and the rest of the carry double for
    double."""
    carry, ins = _assert_plain_scan_matches_eager(EAGER_REGISTER_CASE,
                                                  tmp_path)
    assert ins["consts"]["hv_tab"].shape[0] > 1
    assert ins["scalars"]["g1"] > 0 and ins["scalars"]["f_mu"] > 0
    for k in ("lk_r", "fw_r", "g_base_r"):
        assert np.any(carry[k] != 0.0), k
    assert np.all(carry["cg_sum_b"] > 0.0)


def _assert_plain_scan_matches_eager(case, tmp_path):
    got = _run_reference_jax([case], tmp_path, "xla", eager=True)
    _assert_matches_hex(_port_schedule(case), got[0])
    with np.load(tmp_path / "case0.npz") as npz:
        n_ep = int(npz["n_ep"])
        parts = {g: {} for g in ("consts", "scalars", "init", "xs", "out", "ys")}
        for key in npz.files:
            if key != "n_ep":
                group, name = key.split(".", 1)
                parts[group][name] = npz[key]
    parts["consts"]["scalars"] = parts["scalars"]
    carry, ys = ops.greedy_window(n_ep, parts["consts"], parts["init"],
                                  parts["xs"], device="cpu")
    n_units = int(parts["xs"]["valid"][0].sum())
    assert n_units == case[0]
    for i, y in enumerate(ys):
        np.testing.assert_array_equal(y[:, :n_units],
                                      parts["ys"][str(i)][:, :n_units])
    assert set(carry) == set(parts["out"])
    for k, v in parts["out"].items():
        np.testing.assert_array_equal(carry[k], v, err_msg=k)
    return carry, parts
