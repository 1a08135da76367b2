"""The port's MoE family (moonshot-v1-16b-a3b, llama4-scout-17b-a16e)
against the reference on the CPU.

Module level, float32, in process: ``moe_apply`` on numpy-seeded inputs
and the reference's weights, against the reference's ``moe_apply``,
whose routing (``jax.lax.top_k``'s experts, and the ``dispatch`` and
``combine`` tensors its two one-hot einsums receive) is read by wrapping
the module's ``jax`` and ``jnp`` names for the call.  The experts, the
dispatch and every slot are bitwise the reference's; ``combine`` carries
the renormalised gates, which differ from the reference's by float32
ulps (XLA's ``exp`` and summation order are not PyTorch's), so it is held
to 1e-6 on the same support (bitwise at top-1, where each gate is 1).

Slice level: each reduced config (64 wide, 4 experts, top-2 for moonshot
and top-1 for llama4-scout) at b=2: the loss (ce and the two layers'
summed aux) over 128 tokens, a prefill at s=128 with the caches at 256,
then 4 decode steps with teacher-forced tokens (``tests/
_torch_moe_vlm_ref.py``), weights carried across in bf16.  The port (CPU,
the kernels' plain versions) is held against the JAX api (a) in process
with the xla backend and (b) in a subprocess with
``REPRO_KERNEL_BACKEND=pallas_interpret`` (flash and decode traced).

The bounds are twice the reference's own spread, xla against
pallas_interpret, measured on the JAX package on the CPU with these
weights.  The reduced routers are near-uniform (``small`` init, gates
within ~1e-3 of 1/4), so a bf16 difference in a layer's input can swap
two near-equal experts of a token; the reference's own two backends do
so too.  The mean errors and the loss and aux are held to twice the
spread at the test's tokens (seed 0); the largest error of the logits
and the caches, which one swapped token sets, to twice the largest
spread over token seeds 0-5 (at seed 0 moonshot's caches agree between
the reference's backends, while the port swaps one token of layer 0):

===========  ==========================  ==============================  =========
config       loss / aux (spread; port)   mean logits / k / v (spread)    max (over seeds 0-5)
===========  ==========================  ==============================  =========
moonshot     1.4e-3 / 1.7e-4             0.051 / 0.0133 / 0.0124         logits 0.33, k 2.05, v 1.85
             (7.16e-4 / 8.37e-5;         (0.0256 / 0.00663 / 0.00621;    (0.164, 1.02, 0.922)
             5.6e-4 / 1.06e-4)           port 0.026 / 0.0078 / 0.0073)
llama4       2.2e-3 / 2.9e-4             0.129 / 0.0152 / 0.0142         logits 5.5, k 4.15, v 3.6
             (1.11e-3 / 1.45e-4;         (0.0645 / 0.00758 / 0.0071;     (2.74, 2.07, 1.78)
             1.0e-3 / 1.66e-4)           port 0.069 / 0.0085 / 0.0081)
===========  ==========================  ==============================  =========

(the port's largest errors at seed 0: moonshot logits 0.172, k 0.781, v
0.906; llama4 0.504, 1.67, 1.74.)  This file never sets
``REPRO_KERNEL_BACKEND`` in process.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moe_vlm_ref import (
    MOE_ARCHS,
    S,
    assert_slice_close,
    port_slice,
    reference_case,
    reference_serve_loop,
    run_slice,
)
from repro.distributed.sharding import NULL_CTX
from repro.models import common as j_common
from repro.models import moe as j_moe
from repro.models.registry import build_api as j_build_api
from repro.models.registry import get_api as j_get_api
from repro.models.registry import get_config as j_get_config
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import config as p_config
from repro_torch.models import lm as p_lm
from repro_torch.models import moe as p_moe
from repro_torch.models.registry import build_api as p_build_api
from repro_torch.models.registry import get_api as p_get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: get_api(arch).n_params() of the reference at full width
FULL_PARAMS = {"moonshot-v1-16b-a3b": 28_057_995_264,
               "llama4-scout-17b-a16e": 101_732_029_440}
#: loss, aux, mean |err| of logits / k / v: twice the spread at seed 0
TOL = {"moonshot-v1-16b-a3b": (1.4e-3, 1.7e-4, (0.051, 0.0133, 0.0124)),
       "llama4-scout-17b-a16e": (2.2e-3, 2.9e-4, (0.129, 0.0152, 0.0142))}
#: max |err| of logits / k / v: twice the largest spread over seeds 0-5
MAX_TOL = {"moonshot-v1-16b-a3b": (0.33, 2.05, 1.85),
           "llama4-scout-17b-a16e": (5.5, 4.15, 3.6)}


# ---------------------------------------------------------------------------
# module level, float32
# ---------------------------------------------------------------------------


def reference_route(p, x, cfg, group_size=None) -> dict:
    """The reference's ``moe_apply`` on (p, x), with what its router
    decided: ``topi`` from its ``jax.lax.top_k``, and the ``dispatch`` and
    ``combine`` its two one-hot einsums receive."""
    rec = {}

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def einsum(self, spec, *args, **kw):
            if spec == "tsec,tsd->etcd":
                rec["dispatch"] = np.asarray(args[0])
            elif spec == "tsec,etcd->tsd":
                rec["combine"] = np.asarray(args[0])
            return jnp.einsum(spec, *args, **kw)

    class _Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        def top_k(self, g, k):
            v, i = jax.lax.top_k(g, k)
            rec["topi"] = np.asarray(i)
            return v, i

    class _Jax:
        lax = _Lax()

        def __getattr__(self, name):
            return getattr(jax, name)

    saved = j_moe.jnp, j_moe.jax
    j_moe.jnp, j_moe.jax = _Jnp(), _Jax()
    try:
        out, aux = j_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), cfg, NULL_CTX, group_size=group_size)
    finally:
        j_moe.jnp, j_moe.jax = saved
    rec.update(out=np.asarray(out), aux=float(aux))
    return rec


def _moe_case(arch, seed, s=64):
    """The reference's reduced MoE weights (float32) and x (2, s, d) from
    numpy, the router drawn at scale 1 (the ``small`` init's 0.02 leaves
    every gate within ~1e-3 of 1/4, where float32 noise decides top-k)."""
    j_cfg = j_get_api(arch, reduced=True).cfg
    p_cfg = p_get_api(arch, reduced=True).cfg
    tree = jax.tree.map(np.array, j_common.init_params(
        j_moe.moe_specs(j_cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree["router"] = rng.standard_normal(tree["router"].shape).astype(np.float32)
    x = rng.standard_normal((2, s, j_cfg.d_model)).astype(np.float32)
    return j_cfg, p_cfg, tree, x


def _assert_same_routing(got, want, top1):
    np.testing.assert_array_equal(got["topi"].numpy(), want["topi"])
    np.testing.assert_array_equal(got["dispatch"].numpy(), want["dispatch"])
    comb = got["combine"].numpy()
    np.testing.assert_array_equal(comb != 0, want["combine"] != 0)
    if top1:
        np.testing.assert_array_equal(comb, want["combine"])
    else:
        np.testing.assert_allclose(comb, want["combine"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("group_size", [None, 16, 8])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference_f32(arch, group_size):
    """Default groups (64 tokens, capacity 40 / 20) and groups of 16 and 8
    (capacity 10 / 5 and 5 / 3), where tokens are dropped: the same drops
    as the reference's, out within 1e-4 and aux within 1e-6."""
    j_cfg, p_cfg, tree, x = _moe_case(arch, 7)
    want = reference_route(tree, x, j_cfg, group_size)
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = p_moe.route(p, torch.from_numpy(x), p_cfg, group_size)
    _assert_same_routing(got, want, top1=p_cfg.top_k == 1)
    out, aux = p_moe.moe_apply(p, torch.from_numpy(x), p_cfg, group_size)
    np.testing.assert_allclose(out.numpy(), want["out"], atol=1e-4, rtol=1e-4)
    assert abs(float(aux) - want["aux"]) < 1e-6
    drops = p_moe.dropped(got)
    assert drops == want["topi"].size - int(want["dispatch"].sum())
    if group_size is not None:
        assert drops > 0, "the case was meant to fill an expert past its capacity"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_top_k_ties_go_to_the_lower_expert(arch):
    """Experts 2 and 3 with equal router columns, second behind expert 0
    (a constant feature gives expert 0 +12, the pair +4 and expert 1 -12
    over noise of ~0.8): at top-2 the tie straddles the cut and the
    reference keeps expert 2, at top-1 (the pair made to lead) it picks
    expert 2; the port picks the same experts, and routes the same."""
    j_cfg, p_cfg, tree, x = _moe_case(arch, 11)
    r = tree["router"] * 0.1
    r[0] = (3.0, -3.0, 1.0, 1.0) if p_cfg.top_k == 2 else (-3.0, -3.0, 1.0, 1.0)
    r[:, 3] = r[:, 2]
    tree["router"] = r
    x[..., 0] = 4.0
    want = reference_route(tree, x, j_cfg)
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = p_moe.route(p, torch.from_numpy(x), p_cfg)
    gates = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(r), -1)
    assert torch.equal(gates[..., 2], gates[..., 3])
    assert (want["topi"][..., -1] == 2).all()
    _assert_same_routing(got, want, top1=p_cfg.top_k == 1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_groups_never_drop(arch):
    """At s=1 (a decode step) every token is its own group of capacity
    top_k, so none is dropped, as in the reference."""
    j_cfg, p_cfg, tree, x = _moe_case(arch, 3, s=1)
    want = reference_route(tree, x, j_cfg)
    got = p_moe.route({k: torch.from_numpy(v) for k, v in tree.items()},
                      torch.from_numpy(x), p_cfg)
    assert got["g"] == 1 and got["cap"] == p_cfg.top_k and p_moe.dropped(got) == 0
    _assert_same_routing(got, want, top1=p_cfg.top_k == 1)


@pytest.mark.parametrize("arch,s,g,cap", [
    ("moonshot-v1-16b-a3b", 2048, 256, 30), ("moonshot-v1-16b-a3b", 1, 1, 6),
    ("llama4-scout-17b-a16e", 2048, 2048, 160), ("llama4-scout-17b-a16e", 100, 100, 8)])
def test_group_size_and_capacity_at_full_width(arch, s, g, cap):
    """The full configs' groups and capacities (the serving prefill at
    2,048 and a decode step), the reference's default_group_size."""
    cfg = p_get_api(arch).cfg
    assert p_moe.default_group_size(cfg, s) == j_moe.default_group_size(
        j_get_config(arch), s)
    x = torch.zeros((1, s, 8), dtype=torch.bfloat16)
    small = dataclasses.replace(cfg, d_model=8)
    p = {"router": torch.zeros((8, cfg.n_experts), dtype=torch.bfloat16)}
    r = p_moe.route(p, x, small)
    assert (r["g"], r["cap"]) == (g, cap)


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    out = {}
    for arch in MOE_ARCHS:
        api, params, tokens, _ = reference_case(arch)
        out[arch] = (api, params, jax.tree.map(np.asarray, params), tokens)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_slice_matches_reference_xla_in_process(cases, arch):
    api, params, tree, tokens = cases[arch]
    ref = run_slice(api, params, tokens)
    assert ref["aux"] > 0
    assert_slice_close(arch, port_slice(arch, tree, tokens), ref, TOL[arch],
                       MAX_TOL[arch])


@pytest.fixture(scope="module")
def pallas_ref(tmp_path_factory):
    """The reference's two MoE slices under pallas_interpret, one process."""
    out = tmp_path_factory.mktemp("moe") / "ref.npz"
    env = dict(os.environ, REPRO_KERNEL_BACKEND="pallas_interpret",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_moe_vlm_ref.py"),
                          str(out), *MOE_ARCHS], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_slice_matches_reference_pallas_interpret_subprocess(cases, pallas_ref, arch):
    _, _, tree, tokens = cases[arch]
    assert pallas_ref["traced_flash"] > 0 and pallas_ref["traced_decode"] > 0
    ref = {k.split("/", 1)[1]: v for k, v in pallas_ref.items()
           if k.startswith(arch + "/")}
    assert_slice_close(arch, port_slice(arch, tree, tokens), ref, TOL[arch],
                       MAX_TOL[arch])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_prefill_drops_tokens_as_the_reference(cases, arch, monkeypatch):
    """The slice's prefill (groups of 128, capacity 80 / 40) fills an
    expert past its capacity in some layer, so the capacity path runs on
    the model's path, not only on hand-made inputs; each layer's routing
    is the reference's on the same layer input."""
    _, params, tree, tokens = cases[arch]
    p_cfg = p_get_api(arch, reduced=True).cfg
    j_cfg = j_get_api(arch, reduced=True).cfg
    seen = []
    orig = p_moe.moe_apply

    def record(p, x, cfg, group_size=None):
        seen.append((p, x))
        return orig(p, x, cfg, group_size)

    monkeypatch.setattr(p_moe, "moe_apply", record)
    port_slice(arch, tree, tokens)
    prefill = [(p, x) for p, x in seen if x.shape[1] == S]
    assert len(prefill) == 2 * p_cfg.n_layers      # the loss, then the prefill
    drops = 0
    for li, (p, x) in enumerate(prefill[p_cfg.n_layers:]):
        got = p_moe.route(p, x, p_cfg)
        # the layer input and the router are bf16 in the model; the
        # reference gets their float32 copies, whose router product is
        # the same float32 product
        lp = {name: w.float().numpy() for name, w in p.named_parameters()}
        want = reference_route(lp, x.float().numpy(), j_cfg)
        np.testing.assert_array_equal(got["topi"].numpy(), want["topi"])
        np.testing.assert_array_equal(got["dispatch"].float().numpy(), want["dispatch"])
        drops += p_moe.dropped(got)
    assert drops > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_full_forward(arch):
    """The port's prefill + decode at position s against its own full
    forward, capacity raised to 8.0 so that no token drops (the
    reference's test_decode_matches_full_forward, bound 0.05)."""
    cfg = dataclasses.replace(p_get_api(arch, reduced=True).cfg, capacity_factor=8.0)
    api = p_build_api(cfg)
    params = api.init(1, "cpu")
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (b, s + 1)))
    full = p_lm.lm_forward(params, cfg, toks)
    _, cache = api.prefill(params, {"tokens": toks[:, :s]}, max_len=s + 4)
    got, _ = api.decode_step(params, toks[:, s:s + 1], cache, s)
    err = float((full[:, s].float() - got[:, 0].float()).abs().max())
    assert err < 0.05, err


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_is_ce_plus_a_hundredth_of_the_summed_aux(arch):
    """aux is the sum over layers of each layer's Switch loss (each ~1 at
    a near-uniform router), and loss = ce + 0.01 aux."""
    api = p_get_api(arch, reduced=True)
    params = api.init(4, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, api.cfg.vocab, (2, 33)))
    loss, parts = api.loss(params, {"tokens": toks[:, :32], "labels": toks[:, 1:]})
    assert 0.9 * api.cfg.n_layers < float(parts["aux"]) < 1.5 * api.cfg.n_layers
    assert float(loss) == float(parts["ce"] + 0.01 * parts["aux"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_batch_cpu_matches_reference_loop(arch):
    """Greedy tokens equal to the reference's serving loop on the port's
    weights and prompts (seed 1, where no row's two best logits tie; at
    seeds 3 (both) and 2 and 6 (llama4-scout) of 1-7 a near-tie, or a
    token routed to another near-equal expert, turns a greedy token)."""
    batch, prompt_len, gen_tokens, seed = 2, 32, 6, 1
    gen, t_prefill, t_decode = serve.serve_batch(
        arch, reduced=True, batch=batch, prompt_len=prompt_len,
        gen_tokens=gen_tokens, seed=seed, device="cpu")
    assert gen.shape == (batch, gen_tokens) and gen.dtype == np.int32
    assert t_prefill > 0 and t_decode > 0
    papi = p_get_api(arch, reduced=True)
    params, prompts, vision = serve.make_inputs(papi, batch, prompt_len, seed,
                                                torch.device("cpu"))
    assert vision is None
    jparams = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    want, gaps = reference_serve_loop(j_get_api(arch, reduced=True), jparams,
                                      prompts.numpy().astype(np.int32), gen_tokens)
    assert (gaps > 0).all(), gaps
    np.testing.assert_array_equal(gen, want)


# ---------------------------------------------------------------------------
# specs and scope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_count_and_layout_match_reference(arch, reduced):
    j_api = j_get_api(arch, reduced=reduced)
    p_api = p_get_api(arch, reduced=reduced)
    assert p_api.n_params() == j_api.n_params()
    if not reduced:
        assert p_api.n_params() == FULL_PARAMS[arch]
        return
    want = jax.tree.map(lambda s: s.shape, j_api.abstract())
    got = jax.tree.map(np.shape, convert.lm_params_to_numpy(p_api.init(0, "cpu")))
    assert got == want
    assert set(got["layers"]["moe"]) == {"router", "wi", "wg", "wo"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_round_trip_through_convert(arch):
    """lm_params_from_numpy carries the stacked moe subtree (router, wi,
    wg, wo) into each layer's table, and lm_params_to_numpy back."""
    tree = jax.tree.map(np.asarray, j_get_api(arch, reduced=True).init(
        jax.random.PRNGKey(2)))
    cfg = p_get_api(arch, reduced=True).cfg
    params = convert.lm_params_from_numpy(tree, cfg)
    for li in range(cfg.n_layers):
        for name in ("router", "wi", "wg", "wo"):
            np.testing.assert_array_equal(params["layers"][li]["moe"][name].numpy(),
                                          tree["layers"]["moe"][name][li])
    back = convert.lm_params_to_numpy(params)
    for name in ("router", "wi", "wg", "wo"):
        np.testing.assert_array_equal(back["layers"]["moe"][name],
                                      tree["layers"]["moe"][name])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_is_the_reference_copy(arch):
    assert dataclasses.asdict(p_get_api(arch).cfg) == dataclasses.asdict(
        j_get_config(arch))
    assert p_get_api(arch).cfg == p_config.ArchConfig(
        **dataclasses.asdict(j_get_config(arch)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_config_builds_and_counts(arch):
    """build_api takes the MoE family (it raised ``NotImplementedError``
    before the family was ported), from the port's config and from a copy
    of the reference's, and counts the reference's parameters."""
    cfg = p_config.ArchConfig(**dataclasses.asdict(j_get_config(arch)))
    api = p_build_api(cfg)
    assert api.cfg.family == "moe"
    assert api.n_params() == p_get_api(arch).n_params() == FULL_PARAMS[arch]
    assert j_build_api(j_get_config(arch)).n_params() == FULL_PARAMS[arch]
