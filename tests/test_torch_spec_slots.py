"""The port's ``SpeculativeSlotEngine`` (``infer/slots.py``) against the
JAX one, and the greedy-exactness contract.

The same submit script through the JAX engine and the port's gives the
same tokens and the same counters (``decode_chunks``, ``accepted_tokens``,
``prefills``, ...), and every stream equals its isolated greedy decode,
whatever the draft: the target itself (every proposal accepted, slots
advance n_spec + 1 a round) or a one-layer draft of other weights
(proposals mostly rejected, the rollback runs constantly). A row within
n_spec of the cache's end writes its verify block past capacity, where
the writes drop as JAX's ``mode="drop"`` does. Tiny preset, f32, on the
CPU; weights from a numpy seed through ``models/convert.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_paged import numpy_llama_params, run_all
from tpu_docker_api.infer import slots as jslots
from tpu_docker_api.models import llama as jl
from tpu_docker_api_torch.infer import engine as tengine
from tpu_docker_api_torch.infer.slots import SlotEngine, SpeculativeSlotEngine
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import params_from_numpy
from tpu_docker_api_torch.ops import flash

MAX_SEQ = 64


def _pair(seed: int, **cfg_kw):
    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32,
                               **cfg_kw)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32, **cfg_kw)
    tree = numpy_llama_params(tcfg, seed=seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def models():
    """{"target": ..., "perfect": the target itself, "garbage": one layer
    of other weights}: (jax cfg, torch cfg, jax params, torch params)."""
    target = _pair(7)
    return {"target": target, "perfect": target,
            "garbage": _pair(99, n_layers=1)}


@pytest.fixture(scope="module")
def greedy(models):
    _, tcfg, _, tp = models["target"]
    memo = {}

    def ref(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in memo:
            fn = tengine.make_generate_fn(tcfg, tengine.GenerateConfig(
                max_new_tokens=max_new, max_seq=MAX_SEQ,
                cache_dtype=torch.float32))
            memo[key] = fn(tp, torch.tensor([prompt]))["tokens"][0].tolist()
        return memo[key]

    return ref


def _engine(models, draft="perfect", **kw):
    _, tcfg, _, tp = models["target"]
    _, dcfg, _, dp = models[draft]
    kw.setdefault("n_spec", 3)
    kw.setdefault("slots", 3)
    return SpeculativeSlotEngine(tcfg, tp, draft_cfg=dcfg, draft_params=dp,
                                 max_seq=MAX_SEQ, cache_dtype=torch.float32,
                                 **kw)


# ------------------------------------------- the same script through JAX
# each script: (draft, engine kwargs, [(prompt, max_new, eos_id)]),
# submitted in order before the engine steps

def _script_perfect_draft(greedy):
    return "perfect", {}, [([3, 1, 4, 1, 5], 12, None), ([9, 8], 12, None)]


def _script_garbage_draft(greedy):
    return "garbage", {}, [([2, 7, 1], 10, None), ([5, 5, 5, 5], 10, None),
                           ([8], 10, None)]


def _script_eos_and_slot_reuse(greedy):
    # one slot: the second request waits for it and both of its caches
    return "perfect", {"slots": 1}, [
        ([3, 1, 4, 1, 5], 12, greedy([3, 1, 4, 1, 5], 12)[3]),
        ([9, 2], 6, None)]


def _script_queue_deeper_than_slots(greedy):
    return "garbage", {"slots": 2, "n_spec": 2}, [
        ([i + 1, (i * 7) % 250 + 1, 3], 5 + i, None) for i in range(5)]


def _script_rows_within_n_spec_of_capacity(greedy):
    """Prompts of 54 and 60 tokens: their last rounds write verify blocks
    (n_spec + 1 = 4 positions) past position 63, where they drop."""
    return "perfect", {}, [
        (list(range(1, 55)), 11, None),
        ([(i * 5) % 250 + 1 for i in range(60)], 5, None)]


SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_perfect_draft, _script_garbage_draft, _script_eos_and_slot_reuse,
    _script_queue_deeper_than_slots, _script_rows_within_n_spec_of_capacity)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_script_as_jax_engine(models, greedy, name):
    """One submit script through the JAX ``SpeculativeSlotEngine`` and
    the port's: the same tokens for every request, the same counters, and
    every stream its isolated greedy decode (cut at eos)."""
    draft, kw, reqs = SCRIPTS[name](greedy)
    kw = {"n_spec": 3, "slots": 3, **kw}
    runs = []
    for pkg, cls, dtype in ((0, jslots.SpeculativeSlotEngine, jnp.float32),
                            (1, SpeculativeSlotEngine, torch.float32)):
        eng = cls(models["target"][pkg], models["target"][pkg + 2],
                  draft_cfg=models[draft][pkg],
                  draft_params=models[draft][pkg + 2], max_seq=MAX_SEQ,
                  cache_dtype=dtype, **kw)
        hs = [eng.submit(p, n, eos_id=e) for p, n, e in reqs]
        runs.append((run_all(eng, hs), dict(eng.stats)))
    (jtoks, jstats), (ttoks, tstats) = runs
    assert ttoks == jtoks
    common = sorted(set(jstats) & set(tstats))
    assert {k: tstats[k] for k in common} == {k: jstats[k] for k in common}
    assert {"decode_chunks", "accepted_tokens", "prefills"} <= set(common)
    for (prompt, max_new, eos), toks in zip(reqs, ttoks):
        want = greedy(prompt, max_new)
        if eos in want:
            want = want[:want.index(eos) + 1]
        assert toks == want


# ------------------------------------------------------------- behaviour

def test_perfect_draft_advances_n_spec_plus_one_a_round(models, greedy):
    """draft == target: acceptance ~1 must PERSIST across fully accepted
    rounds (a draft-cache hole at the last proposal's position would
    collapse it): 11 new tokens at 4 a round = 3 rounds, plus at most
    pipeline + 1 rounds of lag at the tail."""
    eng = _engine(models)
    prompts = [[3, 1, 4, 1, 5], [9, 8]]
    outs = run_all(eng, [eng.submit(p, 12) for p in prompts])
    assert outs == [greedy(p, 12) for p in prompts]
    assert eng.stats["decode_chunks"] <= 3 + eng.pipeline + 1
    assert eng.stats["accepted_tokens"] == 2 * 9  # 3 rounds x 3, per row


def test_garbage_draft_still_token_exact(models, greedy):
    eng = _engine(models, draft="garbage")
    prompts = [[2, 7, 1], [5, 5, 5, 5], [8]]
    outs = run_all(eng, [eng.submit(p, 10) for p in prompts])
    assert outs == [greedy(p, 10) for p in prompts]


def test_eos_and_slot_reuse(models, greedy):
    eng = _engine(models, slots=1)
    prompt = [3, 1, 4, 1, 5]
    ref = greedy(prompt, 12)
    eos = ref[3]
    h1 = eng.submit(prompt, 12, eos_id=eos)
    assert run_all(eng, [h1]) == [ref[:ref.index(eos) + 1]]
    h2 = eng.submit([9, 2], 6)  # slot and both caches recycled
    assert run_all(eng, [h2]) == [greedy([9, 2], 6)]


def test_max_new_one_and_streaming(models, greedy):
    eng = _engine(models)
    prompt = [2, 7, 1, 8]
    assert run_all(eng, [eng.submit(prompt, 1)]) == [greedy(prompt, 1)]
    eng.start()
    try:
        h = eng.submit(prompt, 9, stream=True)
        got = list(h.stream(timeout=120))
    finally:
        eng.close()
    assert got == greedy(prompt, 9)


def test_sampling_rejected(models):
    eng = _engine(models)
    for kw in ({"temperature": 0.5}, {"top_k": 3}, {"top_p": 0.9}):
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit([1, 2], 4, **kw)


def test_prefixes_and_segments_rejected(models):
    eng = _engine(models)
    with pytest.raises(ValueError, match="prefix caching"):
        eng.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="chunked prefill"):
        _engine(models, prefill_chunk=8)
    with pytest.raises(ValueError, match="n_spec must be >= 1"):
        _engine(models, n_spec=0)


def test_both_caches_prefill_through_the_whole_prompt_path(models,
                                                           monkeypatch):
    """An admission group prefills the target and the draft, each through
    the whole-prompt attention (the flash kernel on the card), into
    bucket-long caches; rounds never take that path. The draft cache
    uses the target cache's dtype; verify reads are unbucketed."""
    calls = []
    real = flash.flash_attention

    def counting(q, k, v, causal=True):
        calls.append(q.shape[2])
        return real(q, k, v, causal)

    monkeypatch.setattr(flash, "flash_attention", counting)
    eng = _engine(models, draft="garbage")
    assert eng._dk.dtype == eng._k.dtype and eng._kv_buckets == ()
    run_all(eng, [eng.submit([2, 7, 1], 9), eng.submit([5, 5, 5, 5], 9)])
    n_layers = models["target"][1].n_layers + models["garbage"][1].n_layers
    assert eng.stats["prefills"] == 1
    assert calls == [32] * n_layers  # one R=2 group, bucket 32


def test_warmup_leaves_stats_and_tokens_alone(models, greedy):
    """warmup serves throwaway requests (first-call costs) and restores
    the counters; both engines take it."""
    for eng in (_engine(models), SlotEngine(
            models["target"][1], models["target"][3], slots=2, chunk=4,
            max_seq=MAX_SEQ, cache_dtype=torch.float32)):
        before = dict(eng.stats)
        eng.warmup(rows=(1, 2))
        assert eng.stats == before and not eng._outstanding
        assert eng.latency_stats()["n"] == 0
        assert run_all(eng, [eng.submit([4, 4, 2], 7)]) == [
            greedy([4, 4, 2], 7)]


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the flash kernel, the stream)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_self_draft_on_card_accepts_and_launches_flash(cuda_device):
    """At head_dim 64 (a flash kernel's) in bf16 on the card: both
    prefills of an admission launch flash_fwd once a layer, the rounds
    none; a self-draft accepts at least half of its proposals (bf16
    rounds a (k+1)-token verify and a 1-token step differently, so
    near-ties may reject a few); every stream completes."""
    cfg = dataclasses.replace(tl.llama_presets()["tiny"], dim=256,
                              n_heads=4, n_kv_heads=2, ffn_dim=512)
    params = params_from_numpy(numpy_llama_params(cfg, seed=3), cuda_device,
                               dtype=cfg.dtype)
    eng = SpeculativeSlotEngine(cfg, params, draft_cfg=cfg,
                                draft_params=params, n_spec=4, slots=4,
                                max_seq=128)
    prompts = [[(i * 11 + j) % 250 + 1 for j in range(5 + 9 * i)]
               for i in range(4)]
    flash.reset_launch_count()
    outs = run_all(eng, [eng.submit(p, 21) for p in prompts])
    assert [len(o) for o in outs] == [21] * 4
    assert flash.launch_count["flash_fwd"] == (
        2 * cfg.n_layers * eng.stats["prefills"])
    assert eng.stats["accepted_tokens"] >= 0.5 * (4 * 20)
