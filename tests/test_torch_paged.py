"""The port's paged KV cache (``ops/paged.py``, ``models/llama.py``
``llama_forward_paged``, ``infer/paged.py``) against the JAX package's.

The primitives are bit-equal to the JAX ones on the same numpy pools and
tables. The engine carries the dense engine's contract over the page
pool: greedy streams token-exact against an isolated decode of the same
prompt (the port's ``make_generate_fn``, itself token-exact against the
JAX one) for any admission order, slot reuse, pool exhaustion, deferral,
preemption and restore, shared prefix pages and segments; and the same
submit script through the JAX ``PagedSlotEngine`` gives the same tokens
and the same pool stats. Tiny preset, f32, on the CPU; the weights come
from a numpy seed and cross through ``models/convert.py``.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.infer import paged as jpaged
from tpu_docker_api.models import llama as jl
from tpu_docker_api.ops import paged as jops
from tpu_docker_api_torch.infer import engine as tengine
from tpu_docker_api_torch.infer.paged import PagedSlotEngine
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import params_from_numpy
from tpu_docker_api_torch.ops import paged as tops

MAX_SEQ = 96
PAGE = 16


def numpy_llama_params(cfg, seed: int) -> dict:
    """A Llama param tree of numpy f32 arrays from a numpy seed (norm
    scales ones, matrices scaled by 1/sqrt(fan_in)), in the layout both
    packages share."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, fan_in = spec
        if fan_in is None:
            return np.ones(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return make(tl.llama_param_specs(cfg))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32)
    tree = numpy_llama_params(tcfg, seed=7)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def ref(setup):
    """Isolated greedy decode (the port's ``make_generate_fn``), cached."""
    _, tcfg, _, tp = setup
    memo = {}

    def greedy(prompt, max_new, eos_id=None):
        key = (tuple(prompt), max_new, eos_id)
        if key not in memo:
            fn = tengine.make_generate_fn(tcfg, tengine.GenerateConfig(
                max_new_tokens=max_new, max_seq=MAX_SEQ, eos_id=eos_id,
                cache_dtype=torch.float32))
            out = fn(tp, torch.tensor([prompt]))
            memo[key] = out["tokens"][0, :int(out["lengths"][0])].tolist()
        return memo[key]

    return greedy


def _engine(setup, **kw):
    _, tcfg, _, tp = setup
    kw.setdefault("page_size", PAGE)
    kw.setdefault("slots", 4)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("chunk", 4)
    return PagedSlotEngine(tcfg, tp, cache_dtype=torch.float32, **kw)


def run_all(eng, handles, limit=900):
    for _ in range(limit):
        if all(h.done() for h in handles):
            return [h.result(0)["tokens"] for h in handles]
        eng.step()
    raise AssertionError("requests did not complete")


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_write_and_gather_bit_equal_to_jax(dtype):
    """Same numpy pool, table, positions and values: the JAX and port
    writes leave bit-equal pools, and the gathers bit-equal views. Lanes
    0-2 write live pages, lane 3 writes beyond the table view (trash
    page) and lane 4 through a zeroed row (trash page), at offsets that
    do not collide."""
    rng = np.random.default_rng(3)
    layers, pages, page, kv, hd = 2, 9, 4, 2, 8
    pool = rng.standard_normal((layers, pages, page, kv, hd)).astype(
        np.float32)
    table = np.array([[3, 5], [1, 2], [8, 4], [6, 7], [0, 0]], np.int32)
    pos = np.array([5, 2, 7, 9, 1], np.int32)   # lane 3: col 2 >= mp 2
    new = rng.standard_normal((5, kv, hd)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jpool = jnp.asarray(pool, jdt)
    tpool = torch.from_numpy(pool.copy()).to(tdt)
    for layer in range(layers):
        jpool = jops.paged_write(jpool, jnp.int32(layer), jnp.asarray(table),
                                 jnp.asarray(pos), jnp.asarray(new, jdt))
        got = tops.paged_write(tpool, layer, torch.from_numpy(table).long(),
                               torch.from_numpy(pos).long(),
                               torch.from_numpy(new).to(tdt))
        assert got is tpool  # in place
    want = np.asarray(jpool.astype(jnp.float32))
    np.testing.assert_array_equal(tpool.float().numpy(), want)
    assert not np.array_equal(want[:, 0], pool[:, 0])  # trash was written
    for layer in range(layers):
        jg = jops.gather_pages(jpool, jnp.int32(layer), jnp.asarray(table))
        tg = tops.gather_pages(tpool, layer, torch.from_numpy(table).long())
        assert tg.shape == (5, 2 * page, kv, hd)
        np.testing.assert_array_equal(tg.float().numpy(),
                                      np.asarray(jg.astype(jnp.float32)))


@pytest.mark.parametrize("start,s,cap", [(0, 6, 4), (2, 5, 4), (1, 2, 8),
                                         (9, 3, 8), (3, 5, 8)])
def test_per_row_cache_write_drops_past_capacity(start, s, cap):
    """The per-row cache write keeps positions < capacity and drops the
    rest, as the JAX scatter's ``mode="drop"`` does — also when a row
    starts at 0 and runs past the end (a segment wider than its paged
    row), and when it starts past capacity (a parked lane)."""
    rng = np.random.default_rng(start * 31 + s)
    cache = rng.standard_normal((2, cap, 1, 2)).astype(np.float32)
    new = rng.standard_normal((2, s, 1, 2)).astype(np.float32)
    starts = np.array([start, 0])
    positions = starts[:, None] + np.arange(s)[None, :]
    jwant = jnp.asarray(cache).at[jnp.arange(2)[:, None], positions].set(
        jnp.asarray(new), mode="drop")
    got = torch.from_numpy(cache.copy())
    tl._write_cache(got, torch.from_numpy(new), torch.from_numpy(starts),
                    torch.from_numpy(positions), per_row=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_llama_forward_paged_matches_jax(setup):
    """One paged decode step of 3 slots over a shared numpy pool: logits
    and the pools after the step's writes within 1e-5 (f32, two
    frameworks' matmul orders)."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(11)
    shape = (tcfg.n_layers, 7, PAGE, tcfg.n_kv_heads, tcfg.head_dim)
    kpool = rng.standard_normal(shape).astype(np.float32)
    vpool = rng.standard_normal(shape).astype(np.float32)
    table = np.array([[2, 5], [1, 0], [6, 3]], np.int32)
    pos = np.array([20, 7, 31], np.int32)
    toks = np.array([[5], [77], [200]], np.int32)
    jl_, jk, jv = jl.llama_forward_paged(
        jp, jnp.asarray(toks), jcfg, jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(table), jnp.asarray(pos), max_pos=MAX_SEQ)
    tk, tv = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    with torch.no_grad():
        tl_, tk2, tv2 = tl.llama_forward_paged(
            tp, torch.from_numpy(toks).long(), tcfg, tk, tv,
            torch.from_numpy(table).long(), torch.from_numpy(pos).long(),
            max_pos=MAX_SEQ)
    assert tk2 is tk and tv2 is tv
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------- the same script through JAX

PX = list(range(7, 7 + 20))  # 1 shared page + a 4-token tail at PAGE 16


def _script_preemption(make):
    eng = make(slots=2, total_pages=5)
    hs = [eng.submit([9] * 30, 30), eng.submit([1] * 30, 30)]
    return eng, hs


def _script_full_fcfs(make):
    eng = make(slots=4, total_pages=4, reservation="full")
    hs = [eng.submit(p, 16) for p in ([9] * 30, [1] * 30, [5] * 30)]
    return eng, hs


def _script_stale_lanes(make):
    eng = make(slots=3, chunk=3, total_pages=6, pipeline=3)
    hs = [eng.submit([i + 2, i + 5, i + 1], 7) for i in range(9)]
    return eng, hs


def _script_prefix_growth(make):
    eng = make(slots=3, total_pages=9)
    eng.register_prefix(PX)
    hs = [eng.submit(PX + [50 + i], 24) for i in range(3)]
    return eng, hs


def _script_segment_pressure(make):
    eng = make(slots=2, prefill_chunk=8, buckets=(32,), total_pages=4)
    hs = [eng.submit([9] * 30, 20)]
    for _ in range(3):
        eng.step()
    hs.append(eng.submit(list(range(2, 42)), 8))
    return eng, hs


def _script_long_restore_rechunks(make):
    eng = make(slots=2, prefill_chunk=8, buckets=(32,), total_pages=6)
    hs = [eng.submit(list(range(3, 31)), 30)]
    for _ in range(6):
        eng.step()
    hs.append(eng.submit(list(range(2, 34)), 20))
    return eng, hs


def _script_pin_fails_pending(make):
    eng = make(slots=4, total_pages=4)
    bad = eng.submit([1] * 30, 16)
    eng.register_prefix(list(range(7, 7 + 32)))
    eng.step()
    assert bad.done()
    return eng, [eng.submit(list(range(7, 7 + 32)) + [9], 8)]


SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_preemption, _script_full_fcfs, _script_stale_lanes,
    _script_prefix_growth, _script_segment_pressure,
    _script_long_restore_rechunks, _script_pin_fails_pending)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_script_as_jax_engine(setup, name):
    """One submit script through the JAX ``PagedSlotEngine`` and the
    port's: the same tokens for every request, and the same stats — pool
    (pages_free, grown_pages, preemptions, deferred_admissions) and
    admission counters alike."""
    jcfg, tcfg, jp, tp = setup
    runs = []
    for cls, cfg, params, dtype in (
            (jpaged.PagedSlotEngine, jcfg, jp, jnp.float32),
            (PagedSlotEngine, tcfg, tp, torch.float32)):
        def make(**kw):
            kw.setdefault("page_size", PAGE)
            kw.setdefault("max_seq", MAX_SEQ)
            kw.setdefault("chunk", 4)
            return cls(cfg, params, cache_dtype=dtype, **kw)

        eng, hs = SCRIPTS[name](make)
        runs.append((run_all(eng, hs, limit=1500), dict(eng.stats)))
    (jtoks, jstats), (ttoks, tstats) = runs
    assert ttoks == jtoks
    common = sorted(set(jstats) & set(tstats))
    assert {k: tstats[k] for k in common} == {k: jstats[k] for k in common}
    assert {"pages_free", "preemptions", "deferred_admissions"} <= set(common)


# ------------------------------------------------------------- token exact

class TestTokenExact:
    def test_concurrent_mixed_lengths_token_exact(self, setup, ref):
        eng = _engine(setup)
        prompts = [[2, 7, 1], [9] * 20, [5, 5], [1, 2, 3, 4, 5, 6, 7],
                   [8, 6, 4], [11, 13]]
        max_news = [10, 6, 13, 9, 5, 16]
        outs = run_all(eng, [eng.submit(p, m)
                             for p, m in zip(prompts, max_news)])
        assert outs == [ref(p, m) for p, m in zip(prompts, max_news)]

    def test_slot_reuse_recycles_pages_exactly(self, setup, ref):
        eng = _engine(setup, slots=2, chunk=3)
        prompts = [[i + 1, i + 2, i + 3] for i in range(7)]
        handles = [eng.submit(p, 8) for p in prompts[:3]]
        for step in range(400):
            eng.step()
            if step == 2:
                handles += [eng.submit(p, 8) for p in prompts[3:]]
            if len(handles) == 7 and all(h.done() for h in handles):
                break
        assert eng.stats["completed"] == 7
        assert [h.result(0)["tokens"] for h in handles] == [
            ref(p, 8) for p in prompts]
        # frees are immediate: every page is back at the end
        assert eng.stats["pages_free"] == eng.stats["pages_total"]

    def test_sampling_paths_run(self, setup):
        eng = _engine(setup, slots=2)
        hs = [eng.submit([1, 2, 3], 6, temperature=0.8),
              eng.submit([4, 5], 6, temperature=0.9, top_k=4, top_p=0.9)]
        for toks in run_all(eng, hs):
            assert len(toks) == 6 and all(0 <= t < 256 for t in toks)

    def test_eos_and_max_new_1(self, setup, ref):
        prompt = [3, 1, 4, 1, 5]
        want = ref(prompt, 12)
        eos = want[3]
        eng = _engine(setup, slots=2)
        h = eng.submit(prompt, 12, eos_id=eos)
        h1 = eng.submit([7, 7, 7], 1)
        outs = run_all(eng, [h, h1])
        assert outs[0] == want[:want.index(eos) + 1]
        assert outs[1] == ref([7, 7, 7], 1)


class TestCapacity:
    def test_pool_smaller_than_dense_serves_short_requests(self, setup, ref):
        eng = _engine(setup, total_pages=12)
        assert eng.stats["pages_total"] == 12
        prompts = [[i + 1, i + 2] for i in range(4)]
        outs = run_all(eng, [eng.submit(p, 8) for p in prompts])
        assert outs == [ref(p, 8) for p in prompts]

    def test_exhausted_pool_defers_then_completes_fcfs(self, setup, ref):
        eng, handles = _script_full_fcfs(lambda **kw: _engine(setup, **kw))
        outs = run_all(eng, handles)
        assert eng.stats["deferred_admissions"] >= 1
        order = sorted(range(3), key=lambda i: handles[i].completed_at)
        assert order == [0, 1, 2]
        assert outs == [ref(p, 16) for p in ([9] * 30, [1] * 30, [5] * 30)]

    def test_request_larger_than_pool_rejected(self, setup):
        eng = _engine(setup, slots=2, total_pages=2)
        with pytest.raises(ValueError, match="pages"):
            eng.submit([1] * 40, 30)

    def test_stale_lanes_cannot_corrupt_reissued_pages(self, setup, ref):
        eng, handles = _script_stale_lanes(lambda **kw: _engine(setup, **kw))
        outs = run_all(eng, handles)
        assert outs == [ref([i + 2, i + 5, i + 1], 7) for i in range(9)]


class TestEdges:
    def test_capacity_boundary_request_admits(self, setup, ref):
        eng = _engine(setup, slots=2)
        prompt = [((i * 3) % 250) + 1 for i in range(65)]
        (out,) = run_all(eng, [eng.submit(prompt, 32)])  # 65+32-1 == 96
        assert out == ref(prompt, 32)

    def test_constructor_rejections(self, setup):
        with pytest.raises(ValueError, match="every prefill bucket"):
            _engine(setup, page_size=32, slots=2, max_seq=48)
        with pytest.raises(ValueError, match="power of two"):
            _engine(setup, page_size=3)
        with pytest.raises(ValueError, match="reservation"):
            _engine(setup, reservation="lazy")
        _engine(setup, prefill_chunk=8)  # segments compose

    def test_deferred_handles_fail_on_close_and_die(self, setup):
        eng = _engine(setup, total_pages=5)
        eng.submit([9] * 30, 40)
        h2 = eng.submit([1] * 30, 40)
        for _ in range(6):
            eng.step()
        assert eng._deferred and not h2.done()
        eng.close()
        with pytest.raises(RuntimeError, match="engine closed"):
            h2.result(0)
        eng2 = _engine(setup, total_pages=5)
        eng2.submit([9] * 30, 40)
        d2 = eng2.submit([1] * 30, 40)
        for _ in range(6):
            eng2.step()
        assert eng2._deferred
        eng2._die(RuntimeError("boom"))
        with pytest.raises(RuntimeError, match="engine failed"):
            d2.result(0)

    def test_deferred_counter_counts_once(self, setup):
        eng = _engine(setup, total_pages=4, reservation="full")
        hs = [eng.submit([9] * 30, 16), eng.submit([1] * 30, 16)]
        for _ in range(12):
            eng.step()
        assert eng.stats["deferred_admissions"] == 1
        run_all(eng, hs)
        assert eng.stats["deferred_admissions"] == 1

    def test_engine_thread_loop(self, setup, ref):
        with _engine(setup, slots=2) as eng:
            h = eng.submit([2, 4, 6], 8)
            assert h.result(60)["tokens"] == ref([2, 4, 6], 8)


class TestPrefixSharing:
    def test_shared_prefix_token_exact_across_slots(self, setup, ref):
        eng = _engine(setup)
        assert eng.register_prefix(PX).startswith("px-")
        prompts = [PX + [30 + i, 40 + i, 50 + i] for i in range(4)]
        outs = run_all(eng, [eng.submit(p, 10) for p in prompts])
        assert outs == [ref(p, 10) for p in prompts]
        assert eng.stats["prefix_hits"] == 4

    def test_page_aligned_sharing_and_dedupe(self, setup):
        eng = _engine(setup)
        total = eng.stats["pages_total"]
        a = eng.register_prefix(PX)
        assert eng.register_prefix(PX) == a and len(eng.prefixes()) == 1
        assert eng.stats["pages_free"] == total - 1
        ent = next(iter(eng._prefixes.values()))
        assert ent.shared_len == PAGE and len(ent.page_ids) == 1
        assert eng.prefixes()[0]["bytes"] == eng.stats["prefix_bytes"] == (
            2 * 2 * PAGE * 2 * 16 * 4)  # layers, page, kv heads, hd, f32
        with pytest.raises(ValueError, match="shorter than one page"):
            eng.register_prefix([1, 2, 3])

    def test_pool_accounting_through_lifecycle(self, setup):
        eng = _engine(setup)
        total = eng.stats["pages_total"]
        pid = eng.register_prefix(PX)
        handles = [eng.submit(PX + [60 + i], 6) for i in range(3)]
        eng.step()
        assert eng.stats["pages_free"] < total - 1
        run_all(eng, handles)
        assert eng.stats["pages_free"] == total - 1
        assert eng.unregister_prefix(pid)
        assert eng.stats["pages_free"] == total

    def test_unregister_with_live_readers_defers_reclaim(self, setup, ref):
        eng = _engine(setup)
        total = eng.stats["pages_total"]
        pid = eng.register_prefix(PX)
        h = eng.submit(PX + [33, 44], 16)
        eng.step()
        assert eng.stats["prefix_hits"] == 1
        assert eng.unregister_prefix(pid) and eng.prefixes() == []
        assert eng.stats["pages_free"] < total
        run_all(eng, [h])
        eng.step()
        assert eng.stats["pages_free"] == total
        assert h.result(0)["tokens"] == ref(PX + [33, 44], 16)

    def test_late_joiner_shares_with_active_decoders(self, setup, ref):
        eng = _engine(setup)
        eng.register_prefix(PX)
        first = eng.submit(PX + [81], 12)
        for _ in range(3):
            eng.step()
        late = eng.submit(PX + [82, 83], 12)
        assert run_all(eng, [first, late]) == [ref(PX + [81], 12),
                                               ref(PX + [82, 83], 12)]

    def test_sharing_capacity_math(self, setup, ref):
        """1 shared + 4 x 2 private pages admit all four at once; each
        request alone would need 3."""
        eng = _engine(setup, total_pages=9)
        eng.register_prefix(PX)
        prompts = [PX + [70 + i, 90 + i] for i in range(4)]
        handles = [eng.submit(p, 12) for p in prompts]
        eng.step()
        assert eng.stats["deferred_admissions"] == 0
        assert run_all(eng, handles) == [ref(p, 12) for p in prompts]

    def test_register_via_engine_thread(self, setup, ref):
        with _engine(setup) as eng:
            assert eng.register_prefix(PX).startswith("px-")
            h = eng.submit(PX + [21, 22], 8)
            assert h.result(120)["tokens"] == ref(PX + [21, 22], 8)
            assert eng.stats["prefix_hits"] == 1

    def test_prompt_past_bucket_ceiling_via_prefix(self, setup, ref):
        eng = _engine(setup, slots=2, buckets=(32,))
        px = list(range(1, 33))
        eng.register_prefix(px)
        prompt = px + [40, 41, 42, 43]
        assert run_all(eng, [eng.submit(prompt, 8)]) == [ref(prompt, 8)]
        with pytest.raises(ValueError, match="largest prefill bucket"):
            _engine(setup, slots=2, buckets=(32,)).submit(prompt, 8)


class TestGrowthPreemption:
    def test_growth_accounting(self, setup, ref):
        eng = _engine(setup, slots=2, total_pages=6)
        h = eng.submit([7, 8, 9], 40)
        eng.step()
        slot = next(i for i, s in eng._table.items() if s is not None)
        assert len(eng._slot_pages[slot]) >= 2
        assert run_all(eng, [h]) == [ref([7, 8, 9], 40)]
        assert eng.stats["grown_pages"] >= 1
        assert eng.stats["preemptions"] == 0
        assert eng.stats["pages_free"] == eng.stats["pages_total"]

    def test_admission_concurrency_beats_full_reservation(self, setup, ref):
        prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
        refs = [ref(p, 40) for p in prompts]
        eos_ids = [r[5] for r in refs]
        expected = [r[:r.index(e) + 1] for r, e in zip(refs, eos_ids)]
        results = {}
        for mode in ("full", "grow"):
            eng = _engine(setup, total_pages=8, reservation=mode)
            handles = [eng.submit(p, 40, eos_id=e)
                       for p, e in zip(prompts, eos_ids)]
            eng.step()
            admitted = sum(s is not None for s in eng._table.values())
            results[mode] = (admitted, eng.stats["deferred_admissions"],
                             run_all(eng, handles))
        assert results["full"][0] <= 2 and results["full"][1] >= 1
        assert results["grow"][:2] == (4, 0)
        assert results["full"][2] == results["grow"][2] == expected

    def test_preemption_exact_restore(self, setup, ref):
        eng, hs = _script_preemption(lambda **kw: _engine(setup, **kw))
        assert run_all(eng, hs) == [ref([9] * 30, 30), ref([1] * 30, 30)]
        assert eng.stats["preemptions"] >= 1
        assert eng.stats["pages_free"] == eng.stats["pages_total"]

    def test_preempted_stream_never_loses_or_repeats_tokens(self, setup,
                                                             ref):
        eng = _engine(setup, slots=2, total_pages=5)
        got: list[int] = []
        ha = eng.submit([9] * 30, 30, stream=True)
        t = threading.Thread(
            target=lambda: got.extend(ha.stream(timeout=300)))
        t.start()
        hb = eng.submit([1] * 30, 30)
        run_all(eng, [ha, hb])
        t.join(timeout=60)
        assert not t.is_alive()
        assert eng.stats["preemptions"] >= 1
        assert got == ref([9] * 30, 30)

    def test_growth_with_prefix_sharing(self, setup, ref):
        eng, hs = _script_prefix_growth(lambda **kw: _engine(setup, **kw))
        assert run_all(eng, hs) == [ref(PX + [50 + i], 24)
                                    for i in range(3)]
        assert eng.stats["prefix_hits"] >= 3
        assert eng.stats["pages_free"] == eng.stats["pages_total"] - 1


class TestPinnedPageValidation:
    @pytest.mark.parametrize("mode", ["grow", "full"])
    def test_request_exceeding_unpinned_pool_rejected(self, setup, ref,
                                                      mode):
        eng = _engine(setup, total_pages=4, reservation=mode)
        px = list(range(7, 7 + 32))
        eng.register_prefix(px)  # pins 2 of 4
        with pytest.raises(ValueError, match="pinned"):
            eng.submit([1] * 30, 16)
        assert run_all(eng, [eng.submit(px + [9], 8)]) == [ref(px + [9], 8)]
        assert eng.unregister_prefix(eng.prefixes()[0]["id"])
        eng.step()
        eng.validate([1] * 30, 16)

    def test_registration_fails_now_unfittable_pending_request(self, setup,
                                                               ref):
        eng = _engine(setup, total_pages=4)
        h = eng.submit([1] * 30, 16)
        eng.register_prefix(list(range(7, 7 + 32)))
        eng.step()
        with pytest.raises(ValueError, match="pinned"):
            h.result(0)
        prompt = list(range(7, 7 + 32)) + [9]
        assert run_all(eng, [eng.submit(prompt, 8)]) == [ref(prompt, 8)]

    def test_registration_evicts_now_unfittable_active_slot(self, setup,
                                                            ref):
        eng = _engine(setup, total_pages=6)
        h = eng.submit([1] * 30, 50)
        eng.step()
        assert not h.done()
        eng.register_prefix(list(range(7, 7 + 32)))  # capacity 4 < 5
        with pytest.raises(ValueError, match="pinned"):
            h.result(0)
        assert eng.stats["pages_free"] == 4
        assert run_all(eng, [eng.submit([2] * 20, 8)]) == [ref([2] * 20, 8)]


class TestPagedChunkedPrefill:
    def test_long_prompt_segments_token_exact(self, setup, ref):
        eng = _engine(setup, slots=3, prefill_chunk=8, buckets=(32,))
        long_p, short_p = list(range(3, 43)), [5, 6, 7]
        outs = run_all(eng, [eng.submit(long_p, 12),
                             eng.submit(short_p, 12)])
        assert outs == [ref(long_p, 12), ref(short_p, 12)]
        assert eng.stats["segment_prefills"] >= 5
        assert eng.stats["pages_free"] == eng.stats["pages_total"]

    def test_short_prompts_skip_segmentation(self, setup, ref):
        eng = _engine(setup, slots=2, prefill_chunk=16)
        assert run_all(eng, [eng.submit([1, 2, 3], 8)]) == [
            ref([1, 2, 3], 8)]
        assert eng.stats["segment_prefills"] == 0

    def test_segments_grow_pages_and_release(self, setup, ref):
        eng = _engine(setup, slots=2, prefill_chunk=8, buckets=(32,),
                      total_pages=5)
        p = list(range(2, 42))
        h = eng.submit(p, 8)
        eng.step()  # admission reserves nothing; the segment takes 1 page
        assert eng.stats["pages_free"] == 4
        assert run_all(eng, [h]) == [ref(p, 8)]
        assert eng.stats["grown_pages"] >= 3
        assert eng.stats["pages_free"] == 5

    def test_full_reservation_mode_chunks_too(self, setup, ref):
        eng = _engine(setup, slots=2, prefill_chunk=8, buckets=(32,),
                      reservation="full")
        p = list(range(2, 40))
        h = eng.submit(p, 10)
        eng.step()
        assert eng.stats["pages_total"] - eng.stats["pages_free"] >= 3
        assert run_all(eng, [h]) == [ref(p, 10)]

    def test_segment_pressure_preempts_decoder(self, setup, ref):
        eng, hs = _script_segment_pressure(
            lambda **kw: _engine(setup, **kw))
        assert run_all(eng, hs) == [ref([9] * 30, 20),
                                    ref(list(range(2, 42)), 8)]
        assert eng.stats["preemptions"] >= 1
        assert eng.stats["pages_free"] == eng.stats["pages_total"]

    def test_preempted_long_restore_rechunks(self, setup, ref):
        eng, hs = _script_long_restore_rechunks(
            lambda **kw: _engine(setup, **kw))
        assert run_all(eng, hs, limit=1200) == [
            ref(list(range(3, 31)), 30), ref(list(range(2, 34)), 20)]


class TestChunkedPagedReviewRegressions:
    def test_two_segmenters_tight_pool_both_complete(self, setup, ref):
        eng = _engine(setup, slots=2, prefill_chunk=8, buckets=(32,),
                      total_pages=3)
        pa, pb = list(range(3, 43)), list(range(50, 90))
        outs = run_all(eng, [eng.submit(pa, 6), eng.submit(pb, 6)],
                       limit=1500)
        assert outs == [ref(pa, 6), ref(pb, 6)]
        assert eng.stats["pages_free"] == eng.stats["pages_total"]

    def test_validate_uses_chunked_need(self, setup, ref):
        eng = _engine(setup, slots=2, prefill_chunk=8, buckets=(64,),
                      total_pages=3)
        p = list(range(2, 42))
        assert run_all(eng, [eng.submit(p, 8)]) == [ref(p, 8)]

    def test_long_suffix_prefix_hit_segments(self, setup, ref):
        eng = _engine(setup, slots=2, prefill_chunk=8, buckets=(32,))
        px = list(range(7, 7 + 16))
        eng.register_prefix(px)
        prompt = px + list(range(40, 64))
        assert run_all(eng, [eng.submit(prompt, 8)]) == [ref(prompt, 8)]
        assert eng.stats["segment_prefills"] >= 2
        assert eng.stats["prefix_hits"] == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the engine's stream ordering)")
    return torch.device("cuda")


@pytest.fixture
def card_model(setup, cuda_device):
    """The tiny preset at head_dim 64, which the flash kernel takes (the
    engines' whole-prompt prefills run it on the card), in f32."""
    _, tcfg, _, _ = setup
    cfg = dataclasses.replace(tcfg, dim=256, n_heads=4, n_kv_heads=2,
                              ffn_dim=512)
    return cfg, params_from_numpy(numpy_llama_params(cfg, seed=7),
                                  cuda_device)


@pytest.mark.gpu
def test_reissued_pages_show_no_stale_write_on_card(card_model,
                                                    cuda_device):
    """Back-to-back admissions into pages freed the moment their request
    completed, while chunks naming them are still queued on the card: a
    tiny pool, a deep pipeline and constant resubmission. Every stream
    equals its isolated decode on the card (f32)."""
    tcfg, params = card_model
    eng = PagedSlotEngine(tcfg, params, page_size=PAGE, slots=3,
                          max_seq=MAX_SEQ, chunk=3, total_pages=6,
                          pipeline=3, cache_dtype=torch.float32)
    prompts = [[i + 2, i + 5, i + 1] for i in range(12)]
    outs = run_all(eng, [eng.submit(p, 7) for p in prompts])
    fn = tengine.make_generate_fn(tcfg, tengine.GenerateConfig(
        max_new_tokens=7, max_seq=MAX_SEQ, cache_dtype=torch.float32))
    for p, got in zip(prompts, outs):
        want = fn(params, torch.tensor([p], device=cuda_device))["tokens"]
        assert got == want[0].tolist()
    assert eng.stats["pages_free"] == eng.stats["pages_total"]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_prefix_registration_racing_admissions_on_card(card_model,
                                                       cuda_device, paged):
    """Registrations from another thread while the engine thread admits
    prompts that extend them: whichever route each request takes (its
    prefix visible or not yet), its stream equals the isolated decode.
    Prefix K/V are read only after they are written."""
    from tpu_docker_api_torch.infer.slots import SlotEngine

    tcfg, params = card_model
    kw = dict(slots=4, max_seq=MAX_SEQ, chunk=4, cache_dtype=torch.float32)
    eng = (PagedSlotEngine(tcfg, params, page_size=PAGE, total_pages=64,
                           **kw) if paged
           else SlotEngine(tcfg, params, **kw))
    prefixes = [[(i * 13 + j) % 250 + 1 for j in range(48)]
                for i in range(6)]
    fn = tengine.make_generate_fn(tcfg, tengine.GenerateConfig(
        max_new_tokens=6, max_seq=MAX_SEQ, cache_dtype=torch.float32))
    errors = []

    def register():
        try:
            for px in prefixes:
                eng.register_prefix(px)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    with eng:
        reg = threading.Thread(target=register)
        reg.start()
        handles = []
        for px in prefixes:
            for k in range(3):
                handles.append((px + [k + 1], eng.submit(px + [k + 1], 6)))
                time.sleep(0.002)
        reg.join(timeout=120)
        assert not reg.is_alive() and not errors, errors
        for prompt, h in handles:
            want = fn(params, torch.tensor([prompt], device=cuda_device))
            assert h.result(120)["tokens"] == want["tokens"][0].tolist()


def test_unregister_during_a_reclaim_scan_keeps_its_pages(setup):
    """A removal that lands while the engine loop is rewriting its list of
    unregistered prefixes is kept, and its pages come back. The scan is
    held open at its end while another thread unregisters."""
    eng = _engine(setup, total_pages=8)
    a = eng.register_prefix(PX)
    b = eng.register_prefix(list(range(60, 80)))
    total = eng.stats["pages_total"]
    assert eng.stats["pages_free"] == total - 2
    eng._thread = threading.current_thread()  # removals leave reclaiming
    #                                           to the engine loop
    assert eng.unregister_prefix(a)
    late = threading.Thread(target=eng.unregister_prefix, args=(b,))

    class HeldScan(list):
        def __iter__(self):
            yield from list.__iter__(self)
            late.start()
            late.join(timeout=0.3)  # blocked on the engine's lock

    eng._px_zombies = HeldScan(eng._px_zombies)
    eng._reclaim_zombies()
    late.join(timeout=30)
    assert not late.is_alive()
    eng._reclaim_zombies()
    eng._thread = None
    assert eng.stats["pages_free"] == total
    assert eng.prefixes() == [] and eng._px_zombies == []
