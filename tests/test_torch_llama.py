"""The port's Llama forward against the JAX package's, same weights.

Tiny f32 config; the JAX params come from ``llama_init(cfg,
PRNGKey(0))`` and cross over through models/convert.py. Logits and
caches are compared at 1e-4 (f32, two frameworks' summation orders
through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.infer.quantize import fuse_llama_projections as jfuse
from tpu_docker_api.models import llama as jl
from tpu_docker_api_torch.infer.quantize import fuse_llama_projections
from tpu_docker_api_torch.models import cached_forward_fn, resolve_preset
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops import flash

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32)
    jparams = jl.llama_init(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(host, "cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def _caches(cfg, b, cap, seed=None):
    shape = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.head_dim)
    if seed is None:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _both_cached(setup, tokens, cap, start, last_only=False, kv_limit=None,
                 fused=False, cache_seed=None):
    jcfg, tcfg, jp, tp = setup
    if fused:
        jp, tp = jfuse(jp), fuse_llama_projections(tp)
    kc, vc = _caches(jcfg, tokens.shape[0], cap, cache_seed)
    jstart = jnp.asarray(start) if isinstance(start, np.ndarray) \
        else jnp.int32(start)
    tstart = torch.from_numpy(start) if isinstance(start, np.ndarray) \
        else start
    jlast = jnp.asarray(last_only) if isinstance(last_only, np.ndarray) \
        else last_only
    tlast = torch.from_numpy(last_only) \
        if isinstance(last_only, np.ndarray) else last_only
    ref = jl.llama_forward_cached(jp, jnp.asarray(tokens), jcfg,
                                  jnp.asarray(kc), jnp.asarray(vc), jstart,
                                  last_only=jlast, kv_limit=kv_limit)
    got = tl.llama_forward_cached(tp, torch.from_numpy(tokens).long(), tcfg,
                                  torch.from_numpy(kc), torch.from_numpy(vc),
                                  tstart, last_only=tlast, kv_limit=kv_limit)
    return got, ref


def test_params_round_trip(setup):
    _, _, jp, tp = setup
    assert tl.param_count(tp) == jl.param_count(jp)
    back = params_to_numpy(tp)
    assert back["layers"]["attn"]["wq"].shape == (2, 64, 64)
    np.testing.assert_array_equal(back["lm_head"], tp["lm_head"].numpy())


def test_bf16_params_cross_over():
    p = {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))}
    t = params_from_numpy(p, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.arange(6).reshape(2, 3))


def test_forward_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(2, 24)
    ref = jl.llama_forward(jp, jnp.asarray(toks), jcfg)
    got = tl.llama_forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32
    _close(got, ref)


CACHED = {
    # whole-prompt prefill into a cache exactly as long: the flash path
    "prefill-flash": dict(s=32, cap=32, start=0),
    "prefill-longer-cache": dict(s=20, cap=48, start=0),
    "scalar-decode": dict(s=1, cap=48, start=20, cache_seed=1),
    "scalar-multi": dict(s=4, cap=48, start=9, cache_seed=2),
    "per-row-decode": dict(s=1, cap=48, start=np.array([5, 30], np.int32),
                           cache_seed=3),
    "per-row-multi": dict(s=3, cap=48, start=np.array([0, 17], np.int32),
                          cache_seed=4),
    "kv-limit": dict(s=1, cap=64, start=np.array([3, 20], np.int32),
                     kv_limit=32, cache_seed=5),
    "last-only-true": dict(s=12, cap=32, start=0, last_only=True),
    "last-only-int": dict(s=12, cap=32, start=0, last_only=7),
    "last-only-vector": dict(s=16, cap=16, start=0,
                             last_only=np.array([4, 15], np.int32)),
    "fused": dict(s=16, cap=16, start=0, fused=True),
    "fused-decode": dict(s=1, cap=32, start=np.array([4, 9], np.int32),
                         fused=True, cache_seed=6),
    # positions 46..49 in a 48-slot cache: the last two writes drop
    "per-row-past-capacity": dict(s=4, cap=48,
                                  start=np.array([46, 10], np.int32),
                                  cache_seed=7),
    # a slot parked wholly past capacity writes nothing at all
    "per-row-parked": dict(s=1, cap=48, start=np.array([60, 2], np.int32),
                           cache_seed=8),
}


@pytest.mark.parametrize("case", list(CACHED))
def test_cached_forward_matches_jax(setup, case):
    kw = dict(CACHED[case])
    toks = _tokens(2, kw.pop("s"), seed=len(case))
    (logits, kc, vc), (rl, rk, rv) = _both_cached(setup, toks, **kw)
    assert logits.shape == tuple(rl.shape)
    _close(logits, rl)
    _close(kc, rk)
    _close(vc, rv)


def test_prefill_routes_through_flash_wrapper(setup, monkeypatch):
    """The whole-prompt prefill calls the flash wrapper once per layer;
    decode and longer caches keep dense attention."""
    calls = []
    real = flash.flash_attention_fwd
    monkeypatch.setattr(flash, "flash_attention_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _both_cached(setup, _tokens(2, 16), cap=16, start=0)
    assert len(calls) == setup[1].n_layers
    _both_cached(setup, _tokens(2, 16), cap=32, start=0)
    _both_cached(setup, _tokens(2, 16), cap=16, start=0, kv_limit=8)
    assert len(calls) == setup[1].n_layers


def test_scalar_write_past_capacity_raises(setup):
    *_, tcfg, _, tp = setup
    kc = torch.zeros(tcfg.n_layers, 1, 8, tcfg.n_kv_heads, tcfg.head_dim)
    with pytest.raises(RuntimeError):
        tl.llama_forward_cached(tp, torch.zeros(1, 4, dtype=torch.long),
                                tcfg, kc, kc.clone(), 6)


def test_presets_and_dispatch():
    presets = tl.llama_presets()
    one_b = presets["llama3-1b"]
    assert (one_b.dim, one_b.n_layers, one_b.head_dim) == (2048, 16, 64)
    jref = jl.llama_presets()["llama3-1b"]
    assert one_b.flops_per_token(2048) == jref.flops_per_token(2048)
    assert resolve_preset("tiny") == ("llama", presets["tiny"])
    assert cached_forward_fn(one_b) is tl.llama_forward_cached
    for spec, family in (("vit:tiny", "vit"), ("encdec:tiny", "encdec")):
        got_family, got_cfg = resolve_preset(spec)
        assert got_family == family
        assert type(got_cfg).__name__ == ("ViTConfig" if family == "vit"
                                          else "EncDecConfig")
    family, moe_cfg = resolve_preset("moe:moe-tiny")
    assert family == "moe" and moe_cfg.n_experts == 4
    assert cached_forward_fn(moe_cfg) is not tl.llama_forward_cached
    assert cached_forward_fn(moe_cfg).__name__ == "moe_forward_cached"
