"""The port's Mixtral-style MoE family (``models/moe.py``) against the JAX
package's, same weights.

The moe-tiny preset in f32 on the CPU; weights are drawn with numpy from
a seed and cross into both packages through ``models/convert.py``.
Tolerances: routing decisions (experts, capacity slots, keep masks,
capacity) exact, ties and capacity drops included; gate values and the
aux loss 1e-6; the dispatch and the forwards 1e-5 in f32; gradients of
``moe_loss`` 1e-5 of each leaf's largest; bf16 dispatch 2e-2 relative
L2 (both packages round the expert products to bf16, in other orders);
the slot engines and ``make_generate_fn`` token-exact; three train steps
the losses at 1e-4 and the parameters as the Llama trainer's test holds
them (tests/test_torch_train.py).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.infer import engine as jengine
from tpu_docker_api.infer import slots as jslots
from tpu_docker_api.models import moe as jm
from tpu_docker_api.parallel.mesh import single_device_mesh
from tpu_docker_api.train import optim as jopt
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch import models as tmodels
from tpu_docker_api_torch.infer import engine as tengine
from tpu_docker_api_torch.infer.slots import SlotEngine
from tpu_docker_api_torch.models import moe as tm
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops import flash
from tpu_docker_api_torch.train import optim, trainer

TOL = 1e-5


def numpy_moe_params(cfg, seed: int) -> dict:
    """A MoE param tree of numpy f32 arrays from a numpy seed (norm scales
    ones, matrices scaled by 1/sqrt(fan_in)), in the layout both packages
    share."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, fan_in, _ = spec
        if fan_in is None:
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return make(tm.moe_param_specs(cfg))


def _cfgs(**kw):
    jcfg = dataclasses.replace(jm.moe_presets()["moe-tiny"],
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tm.moe_presets()["moe-tiny"],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    tree = numpy_moe_params(tcfg, seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_numpy(tree, "cpu"), tree


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


# ----------------------------------------------------- config and init

@pytest.mark.parametrize("name", ["mixtral-8x7b", "bench-moe", "moe-tiny"])
def test_presets_fields_capacity_and_flops_as_jax(name):
    jcfg, tcfg = jm.moe_presets()[name], tm.moe_presets()[name]
    for f in dataclasses.fields(jm.MoEConfig):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert tcfg.head_dim == jcfg.head_dim
    for t in (1, 7, 64, 4096, 8 * 2048):
        assert tcfg.capacity(t) == jcfg.capacity(t)
    for seq in (None, 2048):
        assert tcfg.flops_per_token(seq) == jcfg.flops_per_token(seq)
    assert set(tm.moe_presets()) == set(jm.moe_presets())


def test_config_defaults_as_jax():
    for f in dataclasses.fields(jm.MoEConfig):
        if f.name != "dtype":
            assert getattr(tm.MoEConfig(), f.name) == getattr(
                jm.MoEConfig(), f.name), f.name


@pytest.mark.parametrize("name", ["mixtral-8x7b", "moe-tiny"])
def test_param_shapes_and_dtypes_match_jax_init(name):
    """``param_shapes``/``param_dtypes`` against the JAX ``moe_init``'s
    tree (shapes only: nothing is allocated at Mixtral size)."""
    jcfg, tcfg = jm.moe_presets()[name], tm.moe_presets()[name]
    abstract = jax.eval_shape(lambda: jm.moe_init(jcfg,
                                                  jax.random.PRNGKey(0)))
    shapes, dtypes = tmodels.param_shapes(tcfg), tmodels.param_dtypes(tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        keys = [p.key for p in path]
        s, d = shapes, dtypes
        for k in keys:
            s, d = s[k], d[k]
        assert tuple(s) == leaf.shape, keys
        assert str(d).split(".")[-1] == str(leaf.dtype), keys
    assert len(jax.tree_util.tree_leaves(abstract)) == len(
        jax.tree_util.tree_leaves(shapes, is_leaf=lambda x: isinstance(
            x, tuple)))


def test_init_tree_matches_specs_and_stays_in_range():
    """``moe_init``: every leaf of its spec's shape and dtype, norms ones,
    the router f32, each matrix a truncated normal of std ~1/sqrt(fan_in)
    clipped at two of them (drawn matrix by matrix)."""
    cfg = tm.moe_presets()["moe-tiny"]
    params = tm.moe_init(cfg, torch.Generator().manual_seed(0))
    specs = tm.moe_param_specs(cfg)

    def walk(p, spec, path=""):
        if isinstance(spec, dict):
            for k in spec:
                walk(p[k], spec[k], path + "/" + k)
            return
        shape, fan_in, dtype = spec
        assert tuple(p.shape) == shape and p.dtype == dtype, path
        x = p.float()
        if fan_in is None:
            assert bool((x == 1).all()), path
        else:
            bound = 2 / fan_in**0.5
            assert float(x.abs().max()) <= bound * (1 + 2**-7), path
            std = float(x.std()) * fan_in**0.5
            assert 0.75 < std < 1.0, (path, std)  # N(0,1) cut at 2: 0.88

    walk(params, specs)
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    # distinct draws for each layer and expert
    wg = params["layers"]["moe"]["w_gate"]
    assert not torch.equal(wg[0, 0], wg[0, 1])
    assert not torch.equal(wg[0, 0], wg[1, 0])


def test_registry_dispatches_the_moe_family():
    cfg = tm.moe_presets()["moe-tiny"]
    assert tmodels.model_fns(cfg) == (tm.moe_init, tm.moe_loss,
                                      tm.MOE_RULES)
    assert tmodels.cached_forward_fn(cfg) is tm.moe_forward_cached
    assert tmodels.resolve_preset("moe:moe-tiny") == ("moe", cfg)
    assert tmodels.resolve_preset("moe:bench-moe")[1].dim == 1024
    with pytest.raises(KeyError):
        tmodels.resolve_preset("moe:nope")


# --------------------------------------------------------------- routing

def _route_inputs(kind: str, t: int = 24, d: int = 64, E: int = 4):
    """(x_flat, router) as numpy f32. ``ties``: zero rows and repeated
    rows (every expert's probability equal, then exact duplicates);
    ``drops``: rows pulled toward one expert so its queue overflows."""
    rng = np.random.default_rng({"random": 1, "ties": 2, "drops": 3}[kind])
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    if kind == "ties":
        x[::3] = 0.0
        x[1::6] = x[1]
    if kind == "drops":
        x += 3 * router[:, 0] / np.linalg.norm(router[:, 0])
    return x, router


@pytest.mark.parametrize("drop_free", [False, True])
@pytest.mark.parametrize("kind", ["random", "ties", "drops"])
def test_route_topk_as_jax(kind, drop_free):
    jcfg, tcfg = _cfgs()
    x, router = _route_inputs(kind)
    jv, ji, jpos, jkeep, jaux, jC = jm._route_topk(
        jnp.asarray(x), jnp.asarray(router), jcfg, drop_free=drop_free)
    tv, ti, tpos, tkeep, taux, tC = tm._route_topk(
        torch.from_numpy(x), torch.from_numpy(router), tcfg,
        drop_free=drop_free)
    assert tC == jC == (24 if drop_free else tcfg.capacity(24))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    if kind == "ties":
        # every expert equally likely: lax.top_k's order, lower index first
        assert ti[0].tolist() == [0, 1] and ti[3].tolist() == [0, 1]
    if kind == "drops":
        assert bool(tkeep.all()) == drop_free


@pytest.mark.parametrize("drop_free", [False, True])
@pytest.mark.parametrize("kind", ["ties", "drops"])
def test_route_dispatch_and_combine_as_jax(kind, drop_free):
    jcfg, tcfg = _cfgs()
    x, router = _route_inputs(kind)
    jd, jc, jaux = jm._route(jnp.asarray(x), jnp.asarray(router), jcfg,
                             drop_free=drop_free)
    td, tc, taux = tm._route(torch.from_numpy(x), torch.from_numpy(router),
                             tcfg, drop_free=drop_free)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)


# -------------------------------------------------------------- dispatch

def _layer_moe(tree, i=0):
    return {k: v[i] for k, v in tree["layers"]["moe"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["gather", "einsum", "sort", "auto"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_mlp_as_jax(setup, impl, dtype, capacity_factor):
    """``_moe_mlp`` of one layer on (2, 12, d) inputs: f32 within 1e-5,
    bf16 within 2e-2 relative L2; at capacity factor 0.5 choices drop."""
    tree = setup[4]
    jcfg, tcfg = _cfgs(dispatch_impl=impl, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    layer = _layer_moe(tree)
    x = np.random.default_rng(5).standard_normal((2, 12, 64)).astype(
        np.float32)
    jlayer = {k: jnp.asarray(v, jnp.float32 if k == "router"
                             else jcfg.dtype) for k, v in layer.items()}
    tlayer = {k: params_from_numpy(v, "cpu", torch.float32 if k == "router"
                                   else tcfg.dtype)
              for k, v in layer.items()}
    jout, jaux = jm._moe_mlp(jnp.asarray(x, jcfg.dtype), jlayer, jcfg,
                             mesh=None)
    tout, taux = tm._moe_mlp(params_from_numpy(x, "cpu", tcfg.dtype),
                             tlayer, tcfg)
    assert tout.dtype == tcfg.dtype and tout.shape == (2, 12, 64)
    ref = np.asarray(jout, np.float32)
    got = tout.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    else:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-2
    if capacity_factor == 0.5:
        *_, keep, _, _ = tm._route_topk(
            params_from_numpy(x, "cpu", tcfg.dtype).reshape(24, 64),
            tlayer["router"], tcfg)
        assert not bool(keep.all())


def test_dispatch_impls_agree_and_unknown_raises(setup):
    tree = setup[4]
    layer = params_from_numpy(_layer_moe(tree), "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 8, 64)).astype(np.float32))
    outs = {}
    for impl in ("gather", "einsum", "sort", "auto"):
        _, tcfg = _cfgs(dispatch_impl=impl, capacity_factor=0.75)
        outs[impl] = tm._moe_mlp(x, layer, tcfg)[0]
    for impl in ("einsum", "sort", "auto"):
        torch.testing.assert_close(outs[impl], outs["gather"], atol=TOL,
                                   rtol=TOL)
    _, bad = _cfgs(dispatch_impl="alltoall")
    with pytest.raises(ValueError, match="unknown dispatch impl"):
        tm._moe_mlp(x, layer, bad)


# ----------------------------------------------------- forward and loss

def _close_trees(got, ref, rel):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max()) or 1.0
        np.testing.assert_allclose(np.asarray(flat_got[path]), r,
                                   atol=rel * scale, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_moe_loss_and_grads_match_jax(setup, impl, remat):
    """``moe_loss`` and its gradient with respect to every leaf (router,
    experts, attention, norms, embed, head) against ``jax.grad``, at a
    capacity factor that drops choices."""
    tree = setup[4]
    jcfg, tcfg = _cfgs(dispatch_impl=impl, capacity_factor=0.75,
                       remat=remat)
    tokens = _tokens(2, 17, seed=1)
    jloss, jgrads = jax.value_and_grad(jm.moe_loss)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    live = optim.tree_map(lambda p: p.requires_grad_(),
                          params_from_numpy(tree, "cpu"))
    loss = tm.moe_loss(live, torch.from_numpy(tokens).long(), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _close_trees(optim.tree_map(lambda p: p.grad.numpy(), live), jgrads,
                 TOL)


def test_moe_forward_logits_and_aux_as_jax(setup):
    jcfg, tcfg, jp, tp, _ = setup
    tokens = _tokens(3, 20, seed=2)
    jlog, jaux = jm.moe_forward(jp, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tlog, taux = tm.moe_forward(tp, torch.from_numpy(tokens).long(),
                                    tcfg)
    assert tlog.dtype == torch.float32 and tlog.shape == (3, 20, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("remat", [True, False])
def test_remat_keeps_flash_residuals(setup, monkeypatch, remat):
    """Under the remat policy the backward reuses the flash forward's
    (out, lse): one flash forward a layer, as without remat."""
    _, tcfg, _, tp, _ = setup
    tcfg = dataclasses.replace(tcfg, remat=remat, attention_impl="flash")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash.flash_attention_fwd_plain, flash.flash_attention_bwd_plain

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(flash, "flash_attention_fwd_plain", count_fwd)
    monkeypatch.setattr(flash, "flash_attention_bwd_plain", count_bwd)
    live = optim.tree_map(lambda p: p.detach().requires_grad_(), tp)
    tm.moe_loss(live, torch.from_numpy(_tokens(1, 17)).long(),
                tcfg).backward()
    assert calls == {"fwd": tcfg.n_layers, "bwd": tcfg.n_layers}


def test_moe_forward_cached_as_jax_and_as_the_full_forward(setup):
    """A whole-prompt prefill into a cache its length (the flash path),
    a prefill into a longer cache, then per-row decode steps (drop-free)
    against JAX's cached forward on the same caches; the prefill's
    logits against ``moe_forward``'s. Also pins the shared skeleton's
    ``rope_scaling`` read: a MoE config has no such field."""
    jcfg, tcfg, jp, tp, _ = setup
    assert not hasattr(tcfg, "rope_scaling")
    tokens = _tokens(2, 16, seed=4)
    full, _ = tm.moe_forward(tp, torch.from_numpy(tokens).long(), tcfg)
    shape = (tcfg.n_layers, 2, 16, tcfg.n_kv_heads, tcfg.head_dim)
    with torch.no_grad():
        whole, _, _ = tm.moe_forward_cached(
            tp, torch.from_numpy(tokens).long(), tcfg, torch.zeros(shape),
            torch.zeros(shape), 0)
    np.testing.assert_allclose(whole.numpy(), full.detach().numpy(),
                               atol=2e-4, rtol=2e-4)

    cap = 32
    jk = jnp.zeros((tcfg.n_layers, 2, cap, tcfg.n_kv_heads, tcfg.head_dim))
    jv = jnp.zeros_like(jk)
    tk, tv = torch.zeros(jk.shape), torch.zeros(jk.shape)
    jlog, jk, jv = jm.moe_forward_cached(jp, jnp.asarray(tokens), jcfg, jk,
                                         jv, jnp.int32(0))
    with torch.no_grad():
        tlog, tk, tv = tm.moe_forward_cached(
            tp, torch.from_numpy(tokens).long(), tcfg, tk, tv, 0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    pos = np.array([16, 16], np.int32)
    nxt = np.array([[7], [200]], np.int32)
    for _ in range(3):
        jlog, jk, jv = jm.moe_forward_cached(
            jp, jnp.asarray(nxt), jcfg, jk, jv, jnp.asarray(pos),
            kv_limit=cap)
        with torch.no_grad():
            tlog, tk, tv = tm.moe_forward_cached(
                tp, torch.from_numpy(nxt).long(), tcfg, tk, tv,
                torch.from_numpy(pos).long(), kv_limit=cap)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=TOL, rtol=TOL)
        nxt = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
        pos = pos + 1
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL,
                               rtol=TOL)


# ------------------------------------------------- generation, engines

MAX_SEQ = 96


def test_generate_greedy_tokens_as_jax(setup):
    jcfg, tcfg, jp, tp, _ = setup
    prompts = _tokens(2, 11, seed=7)
    jfn = jengine.make_generate_fn(jcfg, jengine.GenerateConfig(
        max_new_tokens=10, max_seq=MAX_SEQ, cache_dtype=jnp.float32))
    ref = jfn(jp, jnp.asarray(prompts), jax.random.PRNGKey(0))
    tfn = tengine.make_generate_fn(tcfg, tengine.GenerateConfig(
        max_new_tokens=10, max_seq=MAX_SEQ, cache_dtype=torch.float32))
    got = tfn(tp, torch.from_numpy(prompts).long())
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))


def _run_all(eng, handles, limit=900):
    for _ in range(limit):
        if all(h.done() for h in handles):
            return [h.result(0)["tokens"] for h in handles]
        eng.step()
    raise AssertionError("requests did not complete")


def _seq(n, k):
    return [((i * k) % 251) + 1 for i in range(n)]


def _script_bucket_group_with_drops(make):
    # four same-bucket prompts admitted as one 4-row prefill of 128
    # tokens (pad rows compete for capacity too), beside a running stream
    eng = make(slots=5, chunk=2)
    hs = [eng.submit([9, 8, 7], 6)]
    eng.step()
    hs += [eng.submit(_seq(n, k), 6) for n, k in ((5, 3), (20, 7), (31, 11),
                                                  (12, 5))]
    return eng, hs


def _script_segments_beside_a_stream(make):
    eng = make(chunk=2, prefill_chunk=8)
    hs = [eng.submit([3, 1, 4], 10)]
    eng.step()
    hs.append(eng.submit(_seq(40, 7), 6))
    return eng, hs


def _script_prefix_admission(make):
    eng = make(slots=3)
    prefix = _seq(40, 9)
    eng.register_prefix(prefix)
    return eng, [eng.submit(prefix + [11, 12], 6),
                 eng.submit(prefix + [13], 6), eng.submit([1, 2, 3], 6)]


def _script_bucketed_decode(make):
    # tests/test_slots.py's TestMoeFamily case: kv read buckets (128,)
    eng = make(max_seq=192, chunk=4)
    return eng, [eng.submit(p, 8) for p in ([5, 3, 1], [2, 4, 6, 8])]


SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_bucket_group_with_drops, _script_segments_beside_a_stream,
    _script_prefix_admission, _script_bucketed_decode)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_slot_engine_same_script_as_jax(setup, name, monkeypatch):
    """One submit script through the JAX ``SlotEngine`` and the port's on
    moe-tiny at capacity factor 1.0: the same tokens for every request
    and the same counters. The port's routing calls are counted so that
    the script is known to have dropped choices where it says so."""
    tree = setup[4]
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    drops = {"prefill": 0, "decode": 0}
    route = tm._route_topk

    def counting(x, router, cfg, drop_free=False):
        out = route(x, router, cfg, drop_free)
        drops["decode" if drop_free else "prefill"] += int(
            (~out[3]).sum())
        return out

    monkeypatch.setattr(tm, "_route_topk", counting)
    runs = []
    for cls, cfg, params, dtype in ((jslots.SlotEngine, jcfg, jp,
                                     jnp.float32),
                                    (SlotEngine, tcfg, tp, torch.float32)):
        def make(**kw):
            kw.setdefault("slots", 2)
            kw.setdefault("chunk", 4)
            kw.setdefault("max_seq", MAX_SEQ)
            return cls(cfg, params, cache_dtype=dtype, **kw)

        eng, hs = SCRIPTS[name](make)
        runs.append((_run_all(eng, hs), dict(eng.stats)))
    (jtoks, jstats), (ttoks, tstats) = runs
    assert ttoks == jtoks
    common = sorted(set(jstats) & set(tstats))
    assert {k: tstats[k] for k in common} == {k: jstats[k] for k in common}
    assert drops["decode"] == 0
    if name == "bucket_group_with_drops":
        assert drops["prefill"] > 0 and tstats["prefills"] == 2
    if name == "segments_beside_a_stream":
        assert tstats["segment_prefills"] > 1
    if name == "prefix_admission":
        assert tstats["prefix_hits"] == 2
    if name == "bucketed_decode":
        assert tstats["bucketed_chunks"] > 0


# -------------------------------------------------------------- training

@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_three_train_steps_match_jax(setup, optim_name):
    """Three ``make_train_step`` steps from the same params: the losses
    and gradient norms at 1e-4, the parameters as the Llama trainer's
    test holds them. adamw-int8 runs the plain version here (its kernel
    on the card), over 3-D and 4-D expert leaves and the f32 router."""
    jcfg, tcfg, _, _, _ = setup
    mesh = single_device_mesh()
    if optim_name == "adamw":
        jtx, ttx = jtrainer.default_optimizer(), trainer.default_optimizer()
    else:
        jtx, ttx = jopt.adamw_int8(impl="xla"), optim.adamw_int8()
    jstate, jtx = jtrainer.create_train_state(jcfg, mesh,
                                              jax.random.PRNGKey(0), jtx)
    host = jax.tree_util.tree_map(np.asarray, jstate.params)
    params = params_from_numpy(host, "cpu")
    tstate = trainer.TrainState(0, params, ttx.init(params))
    jstep = jtrainer.make_train_step(jcfg, mesh, jtx)
    tstep = trainer.make_train_step(tcfg, ttx)
    for i in range(3):
        tokens = _tokens(2, 17, seed=10 + i)
        jstate, jmet = jstep(jstate, tokens)
        tstate, tmet = tstep(tstate, torch.from_numpy(tokens).long())
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    assert tstate.params["layers"]["moe"]["router"].dtype == torch.float32
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tstate.params)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        diff = np.abs(got[path] - np.asarray(ref))
        assert diff.max() <= 6 * 3e-4, path
        assert (diff > 2e-6).mean() <= 1e-3, path


@pytest.mark.parametrize("remat", [False, True])
def test_route_tape_records_and_replays_every_routing_call(setup, remat):
    """``RouteTape``: a record run keeps one pick tensor a routing call
    (two a layer under remat: forward and recompute); replaying them gives
    the same loss and gradients; replaying other picks routes by them; a
    replay that consumes fewer or more calls than recorded fails, and
    tapes do not nest."""
    tcfg = dataclasses.replace(setup[1], remat=remat)
    tokens = torch.from_numpy(_tokens(2, 17, seed=2)).long()

    def run(route):
        live = optim.tree_map(lambda p: p.detach().requires_grad_(),
                              setup[3])
        with route:
            loss = tm.moe_loss(live, tokens, tcfg)
            loss.backward()
        return loss.item(), live["layers"]["moe"]["router"].grad

    tape = tm.RouteTape()
    loss, grad = run(tape.record())
    picks = tape.picks
    assert len(picks) == (2 if remat else 1) * tcfg.n_layers
    # the loss feeds tokens[:, :-1]: 2 x 16 tokens a call
    assert all(p.shape == (2 * 16, tcfg.top_k) for p in picks)
    replayed_loss, replayed_grad = run(tape.replay(picks))
    assert replayed_loss == loss and torch.equal(replayed_grad, grad)
    assert all(torch.equal(a, b) for a, b in zip(tape.picks, picks))

    # the last expert for every choice: the loss moves, and the tape
    # still records what the run would have picked itself (the first
    # call's input depends on no pick)
    other = [torch.full_like(p, tcfg.n_experts - 1) for p in picks]
    assert run(tape.replay(other))[0] != loss
    assert torch.equal(tape.picks[0], picks[0])

    with pytest.raises(AssertionError, match="recorded picks"):
        run(tape.replay(picks[:-1]))
    with pytest.raises(AssertionError, match="recorded picks"):
        run(tape.replay(picks + picks[:1]))
    with pytest.raises(RuntimeError, match="do not nest"):
        with tape.record(), tape.record():
            pass
    # a failed replay leaves routing as it was
    assert tm._route_picks is None
    assert run(contextlib.nullcontext())[0] == loss


def test_router_product_is_plain_f32():
    """The port turns no TF32 on: the router's f32 product stays f32."""
    import tpu_docker_api_torch.serve.__main__  # noqa: F401
    import tpu_docker_api_torch.train.__main__  # noqa: F401

    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


# --------------------------------------------------------------- card only

@pytest.mark.gpu
def test_moe_block_through_the_kernels_matches_the_plain_path():
    """Two bench-moe-width blocks (head_dim 128), bf16, remat on, on the
    card: the loss and the router/w_gate/wq gradients through the flash
    kernels against the dense plain path, 2e-2 relative. The dense run
    replays the kernel run's expert picks (``RouteTape``):
    free-running, a near-tie of two experts' probabilities (bf16 inputs
    that differ in the last bit) picks another expert for a token, which
    moves these gradients by more than the kernels' rounding does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

    dev = torch.device("cuda")
    cfg = dataclasses.replace(tm.moe_presets()["bench-moe"], n_layers=2,
                              vocab_size=1024)
    params = tm.moe_init(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    tape = tm.RouteTape()
    res = {}
    for impl in ("flash", "dense"):
        route = (tape.record() if impl == "flash"
                 else tape.replay(res["flash"][3]))
        flash.reset_launch_count()
        live = optim.tree_map(lambda p: p.detach().requires_grad_(), params)
        with route:
            loss = tm.moe_loss(live, tokens, dataclasses.replace(
                cfg, attention_impl=impl))
            loss.backward()
        torch.cuda.synchronize()
        res[impl] = (loss.item(), {
            "router": live["layers"]["moe"]["router"].grad.float(),
            "w_gate": live["layers"]["moe"]["w_gate"].grad.float(),
            "wq": live["layers"]["attn"]["wq"].grad.float()},
            dict(flash.launch_count), tape.picks)
    # forward and remat recompute: two routing calls a layer, each replayed
    assert len(res["flash"][3]) == len(res["dense"][3]) == 2 * cfg.n_layers
    assert res["flash"][2]["flash_fwd"] == cfg.n_layers
    assert res["flash"][2]["flash_bwd_dkv"] == cfg.n_layers
    assert res["dense"][2]["flash_fwd"] == 0
    assert abs(res["flash"][0] - res["dense"][0]) < 2e-2 * res["dense"][0]
    for name, g in res["flash"][1].items():
        ref = res["dense"][1][name]
        assert float((g - ref).norm() / ref.norm()) < 2e-2, name
