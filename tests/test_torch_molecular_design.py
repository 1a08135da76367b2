"""``examples/torch_molecular_design.py`` (the port's twin of
``examples/molecular_design.py``) against the reference on the CPU.

The surrogate loop, wave by wave: the reference's own four-wave loop
(its ``init_mlp`` from ``PRNGKey(0)``, its jitted ``train_steps``, its
``argsort`` picks) is recorded, and at each wave the twin starts from the
reference's weights (carried across as numpy) on the reference's known
set.  After 200 float32 steps of gradient descent the twin's parameters
are within 1e-6 of the reference's and its final MSE within 1e-7
(measured over the four waves: at most 6.0e-8 on the parameters and
7.5e-9 on the MSE; the two autograds round differently, and 200 steps
carry it).  Its predictions on the 4,096 candidates are within 2e-6
(measured at most 3.6e-7), and its 48 picks are held as a set wherever
the reference's predictions at ranks 48 and 49 are further apart than
twice the prediction error (every wave at this seed: the smallest gap is
1.67e-4), and as the first 47 of the picks otherwise.

The campaign: the twin's ``OnlineEngine`` (device="cpu") against the
reference's ``OnlineEngine(engine="soa")`` on the same four-wave DAG,
every window (tasks, assignments, schedule, simulator records, attributed
energy) and the summary equal, floats by bits.
"""
import dataclasses
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WAVES, SIMS, POOL = 4, 48, 4096


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


ref = _load("molecular_design")
twin = _load("torch_molecular_design")


def _np_layers(params):
    return [(np.asarray(w, np.float32), np.asarray(b, np.float32)) for w, b in params]


@pytest.fixture(scope="module")
def reference_waves():
    """The reference's surrogate loop (``main``'s ML half): per wave the
    weights it starts from, the known set, the weights and MSE after
    ``train_steps``, its predictions and its picks."""
    rng = np.random.default_rng(0)
    candidates = rng.uniform(-1, 1, size=(POOL, 8))
    X_known = candidates[:SIMS]
    y_known = ref.true_property(X_known)
    params = ref.init_mlp(jax.random.PRNGKey(0))
    out = []
    for _ in range(WAVES):
        start = _np_layers(params)
        X, y = X_known.copy(), y_known.copy()
        params, mse = ref.train_steps(params, jnp.asarray(X, jnp.float32),
                                      jnp.asarray(y, jnp.float32))
        preds = ref.mlp(params, jnp.asarray(candidates, jnp.float32))
        pick = np.asarray(jnp.argsort(-preds)[:SIMS])
        out.append({"start": start, "X": X, "y": y, "end": _np_layers(params),
                    "mse": float(mse), "preds": np.asarray(preds), "pick": pick})
        X_known = np.concatenate([X_known, candidates[pick]])
        y_known = np.concatenate([y_known, ref.true_property(candidates[pick])])
    return candidates, out


@pytest.mark.parametrize("wave", range(WAVES))
def test_train_steps_and_picks_match_reference(reference_waves, wave):
    candidates, waves = reference_waves
    w = waves[wave]
    model = twin.SurrogateMLP.from_numpy(w["start"])
    mse = twin.train_steps(model, torch.as_tensor(w["X"], dtype=torch.float32),
                           torch.as_tensor(w["y"], dtype=torch.float32))
    assert abs(float(mse) - w["mse"]) < 1e-7, (float(mse), w["mse"])
    for (gw, gb), (ww, wb) in zip(model.to_numpy(), w["end"]):
        np.testing.assert_allclose(gw, ww, atol=1e-6, rtol=0)
        np.testing.assert_allclose(gb, wb, atol=1e-6, rtol=0)
    with torch.no_grad():
        preds = model(torch.as_tensor(candidates, dtype=torch.float32))
    err = float(np.abs(preds.numpy() - w["preds"]).max())
    assert err < 2e-6, err
    picks = twin.pick(preds, SIMS)
    ranked = np.sort(w["preds"])[::-1]
    if ranked[SIMS - 1] - ranked[SIMS] > 2 * err:
        assert set(picks.tolist()) == set(w["pick"].tolist())
    else:
        assert set(picks[:SIMS - 1].tolist()) == set(w["pick"][:SIMS - 1].tolist())


def test_pick_is_a_stable_descending_sort():
    """Equal predictions are picked lower index first, as ``jnp.argsort``
    of the negated predictions orders them."""
    preds = torch.tensor([0.5, 2.0, 0.5, 2.0, 1.0, 0.5])
    want = np.asarray(jnp.argsort(-jnp.asarray(preds.numpy()))[:4])
    np.testing.assert_array_equal(twin.pick(preds, 4), want)
    np.testing.assert_array_equal(twin.pick(preds, 4), [1, 3, 4, 0])


def _reference_campaign():
    from repro.core.engine import OnlineEngine
    from repro.core.evaluate import verify_dag_order, warm_store
    from repro.core.testbed import TestbedSim
    from repro.workloads import moldesign_dag_workload

    trace = moldesign_dag_workload(waves=WAVES, docks_per_wave=SIMS,
                                   sims_per_wave=SIMS, infers_per_wave=2 * SIMS)
    sim = TestbedSim(trace.endpoints, profiles=trace.profiles,
                     signatures=trace.signatures, seed=0)
    engine = OnlineEngine(trace.endpoints, sim, policy="cluster_mhra", alpha=0.3,
                          window_s=5.0, max_batch=512, store=warm_store(sim, trace),
                          monitoring=True, engine="soa")
    for arrival, task in zip(trace.arrivals, trace.tasks):
        engine.tick(float(arrival))
        engine.submit(task, when=float(arrival))
    windows = engine.drain()
    return engine, windows, verify_dag_order(windows)


def _bits(x):
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    return x


def _window(win):
    s = win.schedule
    return _bits((win.index, win.submitted_at, [t.id for t in win.tasks],
                  [t.not_before for t in win.tasks], win.assignments, s.objective,
                  s.energy_j, s.makespan_s, s.transfer_j, s.heuristic, s.timeline,
                  win.attributed_j,
                  [(r.task_id, r.endpoint, r.worker_pid, r.t_start, r.t_end, r.energy_j,
                    r.failed) for r in win.sim.records]))


def test_campaign_matches_reference_soa_engine():
    engine, windows, edges = _reference_campaign()
    _, p_engine, p_windows, p_edges = twin.run_campaign(WAVES, SIMS, "cpu")
    assert p_edges == edges > 0
    assert len(p_windows) == len(windows)
    for a, b in zip(p_windows, windows):
        assert _window(a) == _window(b), a.index
    got = dataclasses.asdict(p_engine.summary())
    want = dataclasses.asdict(engine.summary())
    got.pop("scheduling_s")
    want.pop("scheduling_s")
    assert _bits(got) == _bits(want)


def test_main_runs_small_on_cpu(capsys):
    res = twin.main(waves=2, sims_per_wave=8, pool=256, device="cpu")
    out = capsys.readouterr().out
    assert "wave 1: surrogate mse=" in out and "DAG edges honored" in out
    assert len(res.waves) == len(res.picks) == 2 and res.edges > 0
    assert all(len(p) == len(set(p.tolist())) == 8 for p in res.picks)
    assert sum(res.placements.values()) == res.engine.summary().tasks
    assert all(np.isfinite(m) and m >= 0 for m, _, _ in res.waves)
    assert str(res.engine.device) == "cpu"


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.main(waves=1, sims_per_wave=4, pool=16)
