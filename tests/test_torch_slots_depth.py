"""Prefix caching and chunked prefill in the port's dense ``SlotEngine``
(``infer/slots.py``) against the JAX engine's.

Greedy streams through a registered prefix (suffix-only prefill at an
offset) and through segments interleaved with decode are token-exact
against an isolated decode of the same prompt (the port's
``make_generate_fn``, itself token-exact against the JAX one), and the
same submit script through the JAX ``SlotEngine`` gives the same tokens
and the same counters (prefix hits, segments, prefills, prefix bytes).
Tiny preset, f32, on the CPU; weights from a numpy seed, carried through
``models/convert.py``.
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
from tpu_docker_api_torch.infer.slots import SlotEngine
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import params_from_numpy

MAX_SEQ = 96
PREFIX = [7, 3, 9, 1, 4, 4, 2, 8, 6, 5] * 4  # 40 tokens → bucket 64


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32)
    tree = numpy_llama_params(tcfg, seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def ref(setup):
    _, tcfg, _, tp = setup
    memo = {}

    def greedy(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in memo:
            fn = tengine.make_generate_fn(tcfg, tengine.GenerateConfig(
                max_new_tokens=max_new, max_seq=MAX_SEQ,
                cache_dtype=torch.float32))
            memo[key] = fn(tp, torch.tensor([prompt]))["tokens"][0].tolist()
        return memo[key]

    return greedy


def _engine(setup, **kw):
    _, tcfg, _, tp = setup
    kw.setdefault("slots", 2)
    kw.setdefault("chunk", 4)
    return SlotEngine(tcfg, tp, max_seq=MAX_SEQ, cache_dtype=torch.float32,
                      **kw)


def _seq(n, k):
    return [((i * k) % 251) + 1 for i in range(n)]


# ------------------------------------------- the same script through JAX

def _script_mixed_prefix(make):
    eng = make(slots=4)
    eng.register_prefix(PREFIX)
    prompts = [PREFIX + [11, 12], PREFIX + [13], [1, 2, 3],
               PREFIX + [11, 12]]
    return eng, [eng.submit(p, 8) for p in prompts]


def _script_near_capacity_prefix(make):
    eng = make()
    prefix = [((i * 7) % 251) + 1 for i in range(90)]  # pbucket 96
    eng.register_prefix(prefix)
    return eng, [eng.submit(prefix + [11, 12, 13], 4)]  # 93+4-1 == 96


def _script_segments_beside_a_stream(make):
    eng = make(chunk=2, prefill_chunk=8)
    hs = [eng.submit([3, 1, 4], 14)]
    eng.step()
    hs.append(eng.submit(_seq(40, 7), 6))
    return eng, hs


def _script_round_robin_segments(make):
    eng = make(slots=3, chunk=2, prefill_chunk=8)
    hs = [eng.submit([2, 7], 10)]
    eng.step()
    hs += [eng.submit(_seq(33, k), 5) for k in (3, 7)]
    return eng, hs


def _script_long_suffix_segments(make):
    eng = make(prefill_chunk=8)
    eng.register_prefix([5, 6, 7, 8])
    hs = [eng.submit([5, 6, 7, 8] + _seq(24, 9), 6),
          eng.submit([5, 6, 7, 8, 11, 12], 6)]
    return eng, hs


SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_mixed_prefix, _script_near_capacity_prefix,
    _script_segments_beside_a_stream, _script_round_robin_segments,
    _script_long_suffix_segments)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_script_as_jax_engine(setup, name):
    """One submit script through the JAX ``SlotEngine`` and the port's:
    the same tokens for every request and the same counters."""
    jcfg, tcfg, jp, tp = setup
    runs = []
    for cls, cfg, params, dtype in ((jslots.SlotEngine, jcfg, jp,
                                     jnp.float32),
                                    (SlotEngine, tcfg, tp, torch.float32)):
        def make(**kw):
            kw.setdefault("slots", 2)
            kw.setdefault("chunk", 4)
            return cls(cfg, params, max_seq=MAX_SEQ, cache_dtype=dtype,
                       **kw)

        eng, hs = SCRIPTS[name](make)
        runs.append((run_all(eng, hs), dict(eng.stats)))
    (jtoks, jstats), (ttoks, tstats) = runs
    assert ttoks == jtoks
    common = sorted(set(jstats) & set(tstats))
    assert {k: tstats[k] for k in common} == {k: jstats[k] for k in common}
    assert {"prefix_hits", "segment_prefills", "prefix_bytes"} <= set(common)


# ------------------------------------------------------------- prefixes

class TestPrefixCache:
    def test_mixed_prefix_and_full_admissions_token_exact(self, setup, ref):
        eng, hs = _script_mixed_prefix(lambda **kw: _engine(setup, **kw))
        (snap,) = eng.prefixes()
        assert snap["length"] == 40
        # 2 x layers x bucket 64 x kv heads x head_dim x f32
        assert snap["bytes"] == eng.stats["prefix_bytes"] == (
            2 * 2 * 64 * 2 * 16 * 4)
        outs = run_all(eng, hs)
        assert outs == [ref(p, 8) for p in (PREFIX + [11, 12], PREFIX + [13],
                                            [1, 2, 3], PREFIX + [11, 12])]
        assert eng.stats["prefix_hits"] == 3

    def test_longest_match_and_dedup(self, setup, ref):
        eng = _engine(setup)
        short = eng.register_prefix(PREFIX[:8])
        long = eng.register_prefix(PREFIX)
        assert eng.register_prefix(PREFIX) == long
        prompt = PREFIX + [21]
        assert eng._resolve_prefix(prompt).pid == long
        assert run_all(eng, [eng.submit(prompt, 6)]) == [ref(prompt, 6)]
        assert eng.unregister_prefix(long)
        assert eng._resolve_prefix(prompt).pid == short

    def test_prompt_equal_to_prefix_takes_full_path(self, setup, ref):
        eng = _engine(setup)
        eng.register_prefix(PREFIX)
        assert run_all(eng, [eng.submit(list(PREFIX), 6)]) == [
            ref(PREFIX, 6)]
        assert eng.stats["prefix_hits"] == 0

    def test_prompt_beyond_largest_bucket_served_via_prefix(self, setup,
                                                            ref):
        eng = _engine(setup, buckets=(16, 32))
        prefix = PREFIX[:30]
        pid = eng.register_prefix(prefix)
        prompt = prefix + [11, 12, 13]   # 33 > largest bucket 32
        assert run_all(eng, [eng.submit(prompt, 6)]) == [ref(prompt, 6)]
        with pytest.raises(ValueError, match="largest prefill bucket"):
            _engine(setup, buckets=(16, 32)).submit(prompt, 6)
        # queued through the prefix, prefix gone before admission
        h2 = eng.submit(prompt, 6)
        eng.unregister_prefix(pid)
        eng.step()
        with pytest.raises(ValueError, match="covering prefix is gone"):
            h2.result(5)

    def test_near_capacity_prefix_clamped_temp_cache_exact(self, setup,
                                                           ref):
        eng, hs = _script_near_capacity_prefix(
            lambda **kw: _engine(setup, **kw))
        (out,) = run_all(eng, hs)
        assert eng.stats["prefix_hits"] == 1
        prefix = [((i * 7) % 251) + 1 for i in range(90)]
        assert out == ref(prefix + [11, 12, 13], 4)

    def test_registry_capacity_and_validation(self, setup):
        eng = _engine(setup, max_prefixes=2)
        eng.register_prefix([1, 2, 3])
        eng.register_prefix([4, 5, 6])
        with pytest.raises(ValueError, match="registry full"):
            eng.register_prefix([7, 8, 9])
        with pytest.raises(ValueError, match="non-empty"):
            eng.register_prefix([])
        with pytest.raises(ValueError, match="no room"):
            eng.register_prefix([1] * (MAX_SEQ - 1))
        assert not eng.unregister_prefix("nope")

    def test_registry_byte_budget(self, setup):
        per = 2 * 2 * 32 * 2 * 16 * 4  # a bucket-32 prefix in f32
        eng = _engine(setup, max_prefix_bytes=per)
        pid = eng.register_prefix([1, 2, 3])
        assert eng.stats["prefix_bytes"] == per
        with pytest.raises(ValueError, match="byte budget"):
            eng.register_prefix([4, 5, 6])
        assert eng.register_prefix([1, 2, 3]) == pid  # dedup: no charge
        assert eng.unregister_prefix(pid)
        assert eng.stats["prefix_bytes"] == 0
        eng.register_prefix([4, 5, 6])
        assert eng.stats["prefix_bytes"] == per

    def test_register_while_the_engine_thread_runs(self, setup, ref):
        with _engine(setup) as eng:
            eng.register_prefix(PREFIX)
            h = eng.submit(PREFIX + [9, 9], 8)
            assert h.result(60)["tokens"] == ref(PREFIX + [9, 9], 8)
            assert eng.stats["prefix_hits"] == 1


# ------------------------------------------------------------- segments

class TestChunkedPrefill:
    def test_segmented_long_prompt_token_exact(self, setup, ref):
        eng = _engine(setup, prefill_chunk=8)
        prompt = _seq(30, 5)  # 4 segments
        assert run_all(eng, [eng.submit(prompt, 8)]) == [ref(prompt, 8)]
        assert eng.stats["segment_prefills"] == 4
        assert eng.stats["prefills"] == 1

    def test_concurrent_stream_unharmed_by_segmented_admission(self, setup,
                                                               ref):
        """The parked lane's writes are dropped: the short stream beside
        the segments is exact."""
        eng, hs = _script_segments_beside_a_stream(
            lambda **kw: _engine(setup, **kw))
        assert run_all(eng, hs) == [ref([3, 1, 4], 14), ref(_seq(40, 7), 6)]
        assert eng.stats["segment_prefills"] == 5

    def test_parked_lane_leaves_the_cache_and_read_bound_alone(self, setup):
        """A non-final segment parks the slot's decode lane at max_seq: a
        decode chunk then leaves the slot's cache row bit-unchanged, and
        the slot stays out of the chunk's kv read bound."""
        eng = _engine(setup, chunk=2, prefill_chunk=8)
        eng.submit([3, 1, 4], 14)
        eng.step()
        eng.submit(_seq(40, 7), 6)
        eng._admit()
        eng._dispatch_segments()
        slot = next(i for i, s in eng._table.items()
                    if s is not None and s.pending is not None)
        assert int(eng._dpos[slot]) == MAX_SEQ
        row_k = eng._k[:, slot].clone()
        row_v = eng._v[:, slot].clone()
        eng._dispatch_chunk()
        assert torch.equal(eng._k[:, slot], row_k)
        assert torch.equal(eng._v[:, slot], row_v)
        assert slot not in eng._decoding()  # out of the read bound

    def test_concurrent_long_admissions_round_robin_exact(self, setup, ref):
        eng, hs = _script_round_robin_segments(
            lambda **kw: _engine(setup, **kw))
        assert run_all(eng, hs) == [ref([2, 7], 10), ref(_seq(33, 3), 5),
                                    ref(_seq(33, 7), 5)]
        assert eng.stats["segment_prefills"] == 10

    def test_short_prompts_keep_whole_prompt_admission(self, setup, ref):
        eng = _engine(setup, prefill_chunk=16)
        assert run_all(eng, [eng.submit([1, 2, 3], 6)]) == [
            ref([1, 2, 3], 6)]
        assert eng.stats["segment_prefills"] == 0

    def test_segmented_max_new_one_and_slot_reuse(self, setup, ref):
        eng = _engine(setup, slots=1, prefill_chunk=8)
        long_p = _seq(20, 3)
        assert run_all(eng, [eng.submit(long_p, 1)], limit=10) == [
            ref(long_p, 1)]
        assert run_all(eng, [eng.submit([9, 8], 6)]) == [ref([9, 8], 6)]

    def test_sampling_through_segments(self, setup, ref):
        """top_k=1 at temperature > 0 equals greedy: the final segment
        arms the per-slot filters."""
        eng = _engine(setup, prefill_chunk=8)
        prompt = _seq(20, 11)
        h = eng.submit(prompt, 6, temperature=0.9, top_k=1)
        assert run_all(eng, [h]) == [ref(prompt, 6)]

    def test_long_suffix_prefers_segments_over_prefix(self, setup, ref):
        eng, hs = _script_long_suffix_segments(
            lambda **kw: _engine(setup, **kw))
        outs = run_all(eng, hs)
        assert outs == [ref([5, 6, 7, 8] + _seq(24, 9), 6),
                        ref([5, 6, 7, 8, 11, 12], 6)]
        assert eng.stats["prefix_hits"] == 1
        assert eng.stats["segment_prefills"] == 4  # ceil(28/8)

    def test_prompt_beyond_largest_bucket_served_by_segments(self, setup,
                                                            ref):
        eng = _engine(setup, buckets=(16, 32), prefill_chunk=40)
        prompt = _seq(38, 13)  # > bucket 32
        assert run_all(eng, [eng.submit(prompt, 5)]) == [ref(prompt, 5)]
        assert eng.stats["segment_prefills"] == 2  # 32 + 6

    def test_negative_prefill_chunk_rejected(self, setup):
        with pytest.raises(ValueError, match="prefill_chunk"):
            _engine(setup, prefill_chunk=-1)
