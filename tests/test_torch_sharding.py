"""Sharding on the CPU: the port's ``distributed/sharding.py`` and
``launch/mesh.py``, the dense, hybrid and ssm trainer under a mesh (the
kernels' plain versions on each rank's local shards), the elastic restore
and ``psum_compressed``, against the port's mesh-free path and the
reference.

Three processes start together, once for the module:

- the reference (``tests/_torch_sharding_ref.py``, 512 forced host
  devices): every leaf's spec of the ten architectures on both production
  meshes, ``ctx_for`` and ``serve_rule_overrides``, the rows each device
  holds of a ``("pod", "data")`` batch, the sharded loss of each case on an
  Auto ``jax.sharding.Mesh`` of four devices, and ``psum_compressed`` under
  ``jax.shard_map`` over 2 and 4 devices;
- the port's rules (``tests/_torch_sharding_specs.py``): ``make_host_mesh``
  on the CPU with no group, then the same records over a fake 512-rank
  process group;
- four gloo ranks (``tests/_torch_sharding_ranks.py``, one torch thread a
  rank): the cases of ``CASES`` (reduced granite under head_tp on (2, 2)
  and under seq_cp on (1, 4), reduced zamba2 and falcon-mamba on (2, 2)),
  the elastic restore and ``psum_compressed``.

The weights are the port's (seed 0, float32) in the reference's layout,
written before the processes start; the batch is numpy seed 0.  The
tolerances:

- float32 (``COMPUTE_DTYPE`` float32 on both sides), sharded against the
  port's mesh-free run in this process: the loss within 1e-5 and each
  gradient's largest error within 1e-4 of its largest element (measured:
  4.8e-7 and 1.4e-5; the partial sums over the shards add in another order);
- bf16, the port's sharded loss against the reference's sharded loss:
  the bounds of the reduced-loss parity tests (``test_torch_dense.py``
  4.2e-4 for granite, ``test_torch_zamba2.py`` 3e-3,
  ``test_torch_falcon_mamba.py`` 8e-4; measured: granite head_tp 4.6e-5,
  seq_cp 3.0e-5, zamba2 1.39e-3, falcon-mamba 2.6e-4);
- one ``train(..., mesh=...)`` step (2 microbatches, float32) against the
  mesh-free step: loss and grad norm within 1e-5 relative, each first
  moment (a tenth of the clipped gradient) within 1e-4 of its largest
  element, as the gradients are; each parameter within 1e-5 of its largest
  element plus what AdamW's first update makes of the two runs' gradients
  (``adam_first_update``): it divides a gradient by its size plus eps, so
  an element whose gradient is of the order of eps moves by up to the
  learning rate when the gradient moves by 1e-5 of the largest;
- the elastic restore and ``psum_compressed``: equal.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from _torch_sharding_common import ARCHS, CACHE_BYTES, CASES, S, TRAIN_B, batch, psum_inputs
from _torch_train_ref import flat, unflat
from repro.distributed import sharding as j_sharding
from repro.models.registry import get_config as j_get_config
from repro_torch import convert
from repro_torch.distributed import sharding as p_sharding
from repro_torch.distributed.sharding import DEFAULT_RULES, NULL_CTX, ShardCtx, at_path, ctx_for
from repro_torch.distributed.steps import train_state_axes
from repro_torch.launch import mesh as p_mesh
from repro_torch.launch import train as p_train
from repro_torch.models import lm as p_lm
from repro_torch.models.common import ParamSpec, named_leaves
from repro_torch.models.registry import ARCH_IDS, build_api, get_api, get_config
from repro_torch.optim.adamw import AdamWConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = {"granite-3-2b": 4.2e-4, "zamba2-2.7b": 3e-3, "falcon-mamba-7b": 8e-4}


def _mesh(shape, names=("data", "model")) -> DeviceMesh:
    """A mesh of names and sizes alone (no process group): what the rules
    read."""
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three processes' records, and the port's mesh-free results
    (``mesh_free_results``), computed here while the processes run."""
    d = tmp_path_factory.mktemp("sharding")
    weights = {}
    for arch in ARCHS:
        params = get_api(arch, reduced=True).init(0, "cpu", dtype=torch.float32)
        weights.update(flat(convert.lm_params_to_numpy(params), arch))
    np.savez(d / "weights.npz", **weights)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    (d / "ranks").mkdir()
    commands = {
        "ref": (["_torch_sharding_ref.py", d / "weights.npz", d / "ref.npz"],
                dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=512")),
        "specs": (["_torch_sharding_specs.py", d / "specs.json"], env),
        "ranks": (["_torch_sharding_ranks.py", d / "weights.npz", d / "ranks"], env),
    }
    procs = {}
    for name, (args, proc_env) in commands.items():
        # output to a file: a full pipe would stall the process while this
        # one computes
        with open(d / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / args[0]), *map(str, args[1:])],
                env=proc_env, stdout=log, stderr=subprocess.STDOUT)
    try:
        mesh_free = mesh_free_results(weights)
    finally:
        for name, proc in procs.items():
            proc.wait(timeout=900)
    for name, proc in procs.items():
        assert proc.returncode == 0, (name, (d / f"{name}.log").read_text()[-3000:])
    ref = dict(np.load(d / "ref.npz"))
    return {"ref": ref, "ref_rules": json.loads(str(ref["json"])),
            "specs": json.loads((d / "specs.json").read_text()),
            "ranks": [dict(np.load(d / "ranks" / f"rank{r}.npz")) for r in range(4)],
            "mesh_free": mesh_free}


# ---------------------------------------------------------------------------
# the rules (twins of the reference's tests/test_distributed.py)
# ---------------------------------------------------------------------------


def test_spec_no_axis_reuse():
    """One mesh axis may appear at most once per spec."""
    for shape, names in (((1, 1), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        ctx = ShardCtx(mesh=_mesh(shape, names))
        spec = ctx.spec(("batch", "act_seq", "mlp"))
        used = [a for part in spec if part
                for a in (part if isinstance(part, tuple) else (part,))]
        assert len(used) == len(set(used))
        assert spec == (("pod", "data") if "pod" in names else "data", "model", None)


def test_divisibility_guard_drops_uneven_axes():
    ctx = ShardCtx(mesh=_mesh((1, 1)))
    assert ctx.sharding_for_shape(("vocab", "embed"), (51865, 384)) is not None
    ctx = ShardCtx(mesh=_mesh((16, 16)))
    # 51,865 does not divide by 16: the vocab part is dropped
    assert ctx.spec_for_shape(("vocab", "embed"), (51865, 384)) == (None, "data")
    assert repr(ctx.sharding_for_shape(("vocab", "embed"), (51865, 384))) == \
        "(Shard(dim=1), Replicate())"


def test_seq_cp_overrides():
    cfg = get_config("qwen3-14b")   # 40 heads -> seq_cp on any 16-way axis
    assert cfg.resolve_attn_strategy(16) == "seq_cp"
    assert get_config("deepseek-67b").resolve_attn_strategy(16) == "head_tp"
    ctx = ctx_for(cfg, _mesh((1, 1)))
    assert isinstance(ctx, ShardCtx)
    assert ctx_for(cfg, _mesh((16, 16))).overrides == {"heads": (), "seq": ("model",)}


def test_rules_cover_all_logical_axes_used_by_models():
    needed = {"batch", "embed", "mlp", "heads", "kv_heads", "vocab", "experts",
              "ssm_inner", "state", "layers", "seq", "act_seq", "kv_seq"}
    assert needed <= set(DEFAULT_RULES)
    assert DEFAULT_RULES == j_sharding.DEFAULT_RULES
    used = {a for arch in ARCH_IDS for _, s in named_leaves(get_api(arch).specs())
            for a in s.axes if a is not None}
    assert used <= set(DEFAULT_RULES)


def test_lowering_options_and_foreign_contexts_are_refused():
    for kw in ({"remat_policy": "dots"}, {"moe_group": 4}, {"unroll_inner": True}):
        with pytest.raises(NotImplementedError, match="item 9b"):
            ShardCtx(**kw)
    api = get_api("granite-3-2b", reduced=True)
    params = api.init(0, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(TypeError, match="ShardCtx"):
        api.loss(params, {"tokens": toks, "labels": toks}, shd=j_sharding.NULL_CTX)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "internvl2-26b", "whisper-tiny"])
def test_other_families_under_a_mesh_are_item_9b(arch):
    """The MoE, VLM and enc-dec families refuse a mesh before touching a
    tensor, naming ROADMAP item 9b; their mesh-free path takes NULL_CTX."""
    api = get_api(arch, reduced=True)
    ctx = ShardCtx(mesh=_mesh((2, 2)))
    with pytest.raises(NotImplementedError, match="item 9b"):
        api.loss(None, {}, shd=ctx)
    with pytest.raises(NotImplementedError, match="item 9b"):
        api.prefill(None, {"tokens": None, "frames": None}, shd=ctx)


# ---------------------------------------------------------------------------
# spec parity on the production meshes
# ---------------------------------------------------------------------------

_LAYER = re.compile(r"^(layers|enc_layers|dec_layers)\.\d+\.")


def _ref_placements(spec, names) -> list[str]:
    """DTensor placements of a reference spec, written out independently."""
    out = ["Replicate()"] * len(names)
    for d, part in enumerate(spec):
        for a in ([] if part is None else [part] if isinstance(part, str) else part):
            out[names.index(a)] = f"Shard(dim={d})"
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference_on_production_meshes(runs, arch):
    """Every parameter leaf (the port's per-layer leaves against the
    reference's stacked ones, whose "layers" part is never sharded): the
    port's spec equals the reference's ``sharding_for_shape(...).spec`` and
    its placements are that spec's, on (16, 16) and (2, 16, 16)."""
    for mesh, names in (("single", ["data", "model"]), ("multi", ["pod", "data", "model"])):
        key = f"{arch}|{mesh}"
        want = runs["ref_rules"]["specs"][key]
        got, place = runs["specs"]["specs"][key], runs["specs"]["placements"][key]
        seen = set()
        for name, spec in got.items():
            stacked = _LAYER.match(name)
            ref_key = (_LAYER.sub(r"\1/", name) if stacked else name).replace(".", "/")
            ref = want[ref_key]
            if stacked:
                assert ref[0] is None, (key, ref_key, ref)
                ref = ref[1:]
            assert spec == ref, (key, name, spec, ref)
            assert place[name] == _ref_placements(ref, names), (key, name)
            seen.add(ref_key)
        assert seen == set(want), (key, set(want) ^ seen)


def test_ctx_for_and_serve_overrides_match_reference(runs):
    """``ctx_for`` on (16, 16) for every architecture, and
    ``serve_rule_overrides(..., budget=12e9)`` (the reference's own budget)
    on both meshes at four cache sizes."""
    ref, port = runs["ref_rules"], runs["specs"]
    assert port["overrides"] == ref["overrides"]
    assert port["serve"] == ref["serve"]
    assert {k: v for k, v in port["overrides"].items() if v} == {
        arch: {"heads": [], "seq": ["model"]}
        for arch in ("starcoder2-7b", "qwen3-14b", "llama4-scout-17b-a16e", "whisper-tiny")}
    assert len(port["serve"]) == 2 * len(ARCH_IDS) and len(CACHE_BYTES) == 4


def test_batch_rows_follow_jax_device_order(runs):
    """A ("pod", "data") batch dimension on (2, 16, 16): the rank at mesh
    coordinate (p, d, m) holds the rows JAX gives the device at (p, d, m)."""
    assert runs["specs"]["batch_placements"] == ["Shard(dim=0)", "Shard(dim=0)",
                                                 "Replicate()"]
    assert runs["specs"]["batch_rows"] == runs["ref_rules"]["batch_rows"]
    assert len(set(runs["specs"]["batch_rows"])) == 32


def test_make_host_mesh_cpu_without_a_group_and_the_card_by_default(runs):
    assert runs["specs"]["host"] == [["data", "model"], [1, 1], "gloo", 1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            p_mesh.make_host_mesh()


# ---------------------------------------------------------------------------
# the four-rank cases
# ---------------------------------------------------------------------------


def _api(case):
    arch, _, strategy = CASES[case]
    api = get_api(arch, reduced=True)
    return build_api(dataclasses.replace(api.cfg, attn_strategy=strategy)) if strategy else api


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def mesh_free_results(weights) -> dict:
    """The port's mesh-free float32 loss, gradients and train step of each
    case, in one torch thread."""
    out = {}
    saved = p_lm.COMPUTE_DTYPE
    p_lm.COMPUTE_DTYPE = torch.float32
    try:
        for case, (arch, _, strategy) in CASES.items():
            api = _api(case)

            def run():
                params = convert.lm_params_from_numpy(unflat(weights, arch), api.cfg)
                for p in params.parameters():
                    p.requires_grad_(True)
                b = {k: torch.from_numpy(v).long() for k, v in batch(api.cfg.vocab).items()}
                loss, _ = api.loss(params, b, remat=True)
                loss.backward()
                state, losses, r = p_train.train(
                    arch=arch, steps=1, batch=TRAIN_B, seq=S, microbatches=2, seed=0,
                    device="cpu", log_every=10**9,
                    model_dims={"attn_strategy": strategy} if strategy else None)
                return {"loss": float(loss.detach()),
                        "grads": {n: p.grad.numpy() for n, p in params.named_parameters()},
                        "train": (losses[0], r["steps"][0]["grad_norm"],
                                  r["steps"][0]["lr"], state)}
            out[case] = _one_thread(run)
    finally:
        p_lm.COMPUTE_DTYPE = saved
    return out


@pytest.fixture(scope="module")
def mesh_free(runs):
    return runs["mesh_free"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_and_grads_match_mesh_free_f32(runs, mesh_free, case):
    got, want = runs["ranks"][0], mesh_free[case]
    assert abs(float(got[f"f32/{case}/loss"]) - want["loss"]) < 1e-5
    assert set(want["grads"]) == {k.split("/", 3)[3] for k in got
                                  if k.startswith(f"f32/{case}/grad/")}
    for n, g in want["grads"].items():
        err = float(np.abs(got[f"f32/{case}/grad/{n}"] - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()) + 1e-7, (case, n, err)


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_matches_reference_sharded_loss(runs, case):
    arch = CASES[case][0]
    got, want = float(runs["ranks"][0][f"bf16/{case}"]), float(runs["ref"][f"loss/{case}"])
    assert np.isfinite(got) and abs(got - want) < LOSS_TOL[arch], (case, got, want)


def adam_first_update(m: np.ndarray) -> np.ndarray:
    """AdamW's first update (before weight decay) from the first moment:
    the clipped gradient g = m / (1 - b1) over |g| + eps."""
    cfg = AdamWConfig()
    g = m.astype(np.float64) / (1 - cfg.b1)
    return g / (np.abs(g) + cfg.eps)


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_mesh_free(runs, mesh_free, case):
    got = runs["ranks"][0]
    loss, gnorm, lr, state = mesh_free[case]["train"]
    assert abs(float(got[f"train/{case}/loss"]) - loss) <= 1e-5 * abs(loss)
    assert abs(float(got[f"train/{case}/grad_norm"]) - gnorm) <= 1e-5 * abs(gnorm)
    for n, p in state["params"].named_parameters():
        m_want, m_got = state["opt"]["m"][n].numpy(), got[f"train/{case}/m/{n}"]
        err = float(np.abs(m_got - m_want).max())
        assert err <= 1e-4 * float(np.abs(m_want).max()), (case, "m", n, err)
        want = p.detach().numpy()
        moved = lr * np.abs(adam_first_update(m_got) - adam_first_update(m_want))
        excess = np.abs(got[f"train/{case}/params/{n}"] - want) - moved
        assert excess.max() <= 1e-5 * float(np.abs(want).max()), (case, "params", n)


# ---------------------------------------------------------------------------
# the elastic restore and psum_compressed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["placed", "plain", "shardings"])
def test_elastic_restore_under_another_mesh_and_none(runs, how):
    """Saved under (2, 2); restored into a state placed on (4, 1), into a
    plain state, and into a plain state re-placed on (4, 1) by
    ``shardings``: every leaf equal, and placed as asked."""
    got = runs["ranks"][0]
    assert int(got[f"elastic/{how}"]) == 1
    assert int(got[f"elastic/{how}/dtensor"]) == (how != "plain")
    if how != "plain":
        assert int(got[f"elastic/{how}/mesh41"]) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_psum_compressed_equals_reference(runs, n):
    """Unequal scales on every rank: the average and the error feedback
    equal the reference's under ``jax.shard_map`` (its arithmetic: the sum
    times the largest scale over n, not the mean of the dequantized
    gradients)."""
    ref = runs["ref"]
    for rank in runs["ranks"]:
        r = int(rank[f"psum{n}/rank"])
        for what in ("avg", "err"):
            for leaf in ("a", "b/c"):
                np.testing.assert_array_equal(rank[f"psum{n}/{what}/{leaf}"],
                                              ref[f"psum{n}/{what}/{leaf}"][r])
    g = [p[0]["a"] for p in psum_inputs(n)]
    mean = np.mean(g, axis=0)
    assert not np.allclose(ref[f"psum{n}/avg/a"][0], mean, atol=1e-3)


def test_train_state_axes_are_the_parameters():
    """Every spec names one logical axis a dimension (``api.axes()``, in the
    specs' layout); the train state's moments take the parameters' axes and
    the step count none, as the reference's ``train_state_axes`` gives."""
    api = get_api("zamba2-2.7b", reduced=True)
    axes = api.axes()
    assert train_state_axes(api) == {"params": axes,
                                     "opt": {"m": axes, "v": axes, "step": ()}}
    for name, spec in named_leaves(api.specs()):
        assert at_path(axes, name) == spec.axes and len(spec.axes) == len(spec.shape)
    with pytest.raises(ValueError, match="axes"):
        ParamSpec((2, 3), axes=("embed",))


def test_null_ctx_is_the_mesh_free_path():
    """``NULL_CTX`` (and None) run the mesh-free path: the same loss."""
    api = get_api("granite-3-2b", reduced=True)
    params = api.init(0, "cpu")
    toks = torch.arange(16, dtype=torch.long)[None] % api.cfg.vocab
    b = {"tokens": toks, "labels": toks}
    assert torch.equal(api.loss(params, b, shd=NULL_CTX)[0], api.loss(params, b)[0])
    assert p_sharding.check_ctx(None) is NULL_CTX
    assert j_get_config("granite-3-2b").n_heads == get_config("granite-3-2b").n_heads
