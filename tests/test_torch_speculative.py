"""The port's batch-1 speculative generator (``infer/speculative.py``)
against the JAX one, and the greedy-exactness contract.

The same weights (a numpy seed, through ``models/convert.py``) and the
same prompt go through the JAX ``make_speculative_generate_fn`` and the
port's: the tokens, ``rounds`` and ``accepted`` are equal, and the tokens
equal plain greedy decoding whatever the draft: a perfect draft (the
target itself), a draft of other weights, a draft of another
architecture, k at its extremes, a budget of 1. Tiny preset, f32 weights,
the bf16 caches both packages default to, on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged import numpy_llama_params
from tpu_docker_api.infer import speculative as jspec
from tpu_docker_api.models import llama as jl
from tpu_docker_api_torch.infer import speculative as tspec
from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                               make_generate_fn)
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import params_from_numpy
from tpu_docker_api_torch.ops import flash

MAX_SEQ = 128


def _pair(cfg_kw: dict, seed: int):
    """(jax cfg, torch cfg, jax params, torch params) of the tiny preset
    in f32 with ``cfg_kw`` replaced, weights from ``seed``."""
    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32,
                               **cfg_kw)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32, **cfg_kw)
    tree = numpy_llama_params(tcfg, seed=seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def models():
    target = _pair({}, seed=0)
    draft = _pair({}, seed=7)          # other weights
    small = _pair({"n_layers": 1}, seed=9)  # another architecture
    return target, draft, small


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, 256, (1, 16)).astype(
        np.int32)


def _greedy(tcfg, tp, prompt, n):
    fn = make_generate_fn(tcfg, GenerateConfig(max_new_tokens=n,
                                               max_seq=MAX_SEQ))
    return fn(tp, torch.from_numpy(prompt).long())["tokens"].numpy()


def _both(target, draft, prompt, n, k):
    """The JAX and the port's outputs on the same inputs, as numpy."""
    jcfg, tcfg, jtp, ttp = target
    jdcfg, tdcfg, jdp, tdp = draft
    jout = jspec.make_speculative_generate_fn(
        jcfg, jdcfg, jspec.SpeculativeConfig(
            max_new_tokens=n, n_speculative=k, max_seq=MAX_SEQ))(
        jtp, jdp, jnp.asarray(prompt))
    tout = tspec.make_speculative_generate_fn(
        tcfg, tdcfg, tspec.SpeculativeConfig(
            max_new_tokens=n, n_speculative=k, max_seq=MAX_SEQ))(
        ttp, tdp, torch.from_numpy(prompt).long())
    return ({"tokens": np.asarray(jout["tokens"]),
             "rounds": int(jout["rounds"]),
             "accepted": int(jout["accepted"])},
            {"tokens": tout["tokens"].numpy(), "rounds": tout["rounds"],
             "accepted": tout["accepted"]})


def _assert_same(jout, tout, ref):
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    np.testing.assert_array_equal(tout["tokens"], ref)
    assert (tout["rounds"], tout["accepted"]) == (jout["rounds"],
                                                  jout["accepted"])


def test_perfect_draft_accepts_everything(models, prompt):
    """draft == target: every proposal accepted, output == greedy, and
    the round count shows k+1 tokens a round."""
    target, _, _ = models
    k, n = 4, 20
    jout, tout = _both(target, target, prompt, n, k)
    _assert_same(jout, tout, _greedy(target[1], target[3], prompt, n))
    rounds = tout["rounds"]
    assert rounds <= -(-(n - 1) // (k + 1)) + 1, rounds
    assert tout["accepted"] >= (rounds - 1) * k


def test_mismatched_draft_still_exact(models, prompt):
    """A draft of other random weights: acceptance near zero, the
    emitted tokens unchanged."""
    target, draft, _ = models
    jout, tout = _both(target, draft, prompt, 20, 3)
    _assert_same(jout, tout, _greedy(target[1], target[3], prompt, 20))


def test_draft_architecture_may_differ(models, prompt):
    """The draft can be a structurally different (smaller) model."""
    target, _, small = models
    jout, tout = _both(target, small, prompt, 12, 2)
    _assert_same(jout, tout, _greedy(target[1], target[3], prompt, 12))


@pytest.mark.parametrize("k", [1, 5])
def test_k_extremes_exact(models, prompt, k):
    target, draft, _ = models
    jout, tout = _both(target, draft, prompt, 11, k)
    _assert_same(jout, tout, _greedy(target[1], target[3], prompt, 11))


def test_budget_one(models, prompt):
    target, draft, _ = models
    jout, tout = _both(target, draft, prompt, 1, 4)
    assert tout["tokens"].shape == (1, 1)
    _assert_same(jout, tout, _greedy(target[1], target[3], prompt, 1))


def test_capacity_guard(models, prompt):
    """prompt + budget + k past the cache: refused (a fully accepted
    round's verify block would write past capacity)."""
    target, draft, _ = models
    tcfg, ttp, tdp = target[1], target[3], draft[3]
    fn = tspec.make_speculative_generate_fn(
        tcfg, tcfg, tspec.SpeculativeConfig(max_new_tokens=200,
                                            n_speculative=4,
                                            max_seq=MAX_SEQ))
    with pytest.raises(ValueError, match="capacity"):
        fn(ttp, tdp, torch.from_numpy(prompt).long())
    # exactly at capacity is allowed: 16 + 108 + 4 == 128
    fn = tspec.make_speculative_generate_fn(
        tcfg, tcfg, tspec.SpeculativeConfig(max_new_tokens=108,
                                            n_speculative=4,
                                            max_seq=MAX_SEQ))
    out = fn(ttp, ttp, torch.from_numpy(prompt).long())
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  _greedy(tcfg, ttp, prompt, 108))


@pytest.mark.parametrize("kw,msg", [
    ({"n_speculative": 0}, "n_speculative must be >= 1"),
    ({"max_new_tokens": 0}, "max_new_tokens must be >= 1")])
def test_config_guards(models, kw, msg):
    tcfg = models[0][1]
    with pytest.raises(ValueError, match=msg):
        tspec.make_speculative_generate_fn(tcfg, tcfg,
                                           tspec.SpeculativeConfig(**kw))


def test_batch_one_only(models):
    _, tcfg, _, ttp = models[0]
    fn = tspec.make_speculative_generate_fn(
        tcfg, tcfg, tspec.SpeculativeConfig(max_new_tokens=4,
                                            max_seq=MAX_SEQ))
    with pytest.raises(ValueError, match="batch 1"):
        fn(ttp, ttp, torch.zeros(2, 5, dtype=torch.long))


def test_prefills_take_the_whole_prompt_flash_path(models, prompt,
                                                   monkeypatch):
    """Both prefills run the whole-prompt attention (the flash kernel on
    the card; its plain version here) though each cache is longer than
    the prompt; the draft steps and verify blocks attend at an offset."""
    target, _, small = models
    calls = []
    real = flash.flash_attention

    def counting(q, k, v, causal=True):
        calls.append(q.shape)
        return real(q, k, v, causal)

    monkeypatch.setattr(flash, "flash_attention", counting)
    tspec.make_speculative_generate_fn(
        target[1], small[1], tspec.SpeculativeConfig(
            max_new_tokens=6, n_speculative=2, max_seq=MAX_SEQ))(
        target[3], small[3], torch.from_numpy(prompt).long())
    assert len(calls) == target[1].n_layers + small[1].n_layers
    assert all(s[2] == prompt.shape[1] for s in calls)  # (b, h, s, d)
