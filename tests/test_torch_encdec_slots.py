"""The port's encoder-decoder slot engine (``infer/encdec_slots.py``),
held to the JAX engine's bar (tests/test_encdec_slots.py): every stream
token-exact against an isolated greedy ``encdec_generate`` of its source,
for ragged sources in one engine, any admission order and slot reuse.

The tiny preset in f32 on the CPU, weights drawn with numpy from a seed
(crossing into the JAX package through ``models/convert.py`` where the
JAX function is the reference). Tolerance: tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.models import encdec as je
from tpu_docker_api_torch.infer.encdec_slots import EncDecSlotEngine
from tpu_docker_api_torch.models import encdec as te
from tpu_docker_api_torch.models.convert import params_from_numpy


def numpy_encdec_params(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, fan_in = spec
        noise = rng.standard_normal(shape).astype(np.float32)
        if fan_in is None:
            return 1.0 + 0.1 * noise
        return noise / np.float32(np.sqrt(fan_in))

    return make(te.encdec_param_specs(cfg))


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(te.encdec_presets()["tiny"],
                              dtype=torch.float32)
    tree = numpy_encdec_params(cfg, seed=5)
    return cfg, params_from_numpy(tree, "cpu"), tree


def isolated_greedy(cfg, params, src, max_new, eos_id=None):
    out = te.encdec_generate(params, torch.tensor([src]), cfg,
                             max_new_tokens=max_new, eos_id=eos_id)
    if eos_id is None:
        return out[0].tolist()
    return out["tokens"][0, :int(out["lengths"][0])].tolist()


def engine(cfg, params, **kw):
    return EncDecSlotEngine(cfg, params, cache_dtype=torch.float32, **kw)


def run_all(eng, handles, limit=500):
    for _ in range(limit):
        if all(h.done() for h in handles):
            return
        eng.step()
    raise AssertionError("requests did not complete")


SRCS = [[2, 7, 1], [9] * 40, [5, 5], [1, 2, 3, 4, 5, 6, 7], [8, 6, 4, 2],
        [11, 13]]
MAX_NEWS = [10, 6, 13, 9, 5, 16]


@pytest.fixture(scope="module")
def refs(setup):
    cfg, params, _ = setup
    return [isolated_greedy(cfg, params, s, m)
            for s, m in zip(SRCS, MAX_NEWS)]


def test_single_request_matches_isolated(setup):
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=4, chunk=4)
    src = [3, 1, 4, 1, 5, 9, 2, 6]
    h = eng.submit(src, max_new=12)
    run_all(eng, [h])
    assert h.result(0)["tokens"] == isolated_greedy(cfg, params, src, 12)


@pytest.mark.parametrize("order", [(0, 1, 2, 3, 4, 5), (5, 3, 1, 4, 0, 2)])
def test_ragged_sources_concurrent_token_exact(setup, refs, order):
    """Mixed source lengths across buckets decode together, in any
    admission order."""
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=4, chunk=4)
    handles = {i: eng.submit(SRCS[i], MAX_NEWS[i]) for i in order}
    run_all(eng, list(handles.values()))
    for i, h in handles.items():
        assert h.result(0)["tokens"] == refs[i], i
    # the admissions grouped by source bucket, and reads were bucketed
    assert eng.stats["prefills"] < len(order)
    assert eng.stats["completed"] == len(order)


def test_streams_match_the_jax_encdec_generate(setup):
    """The engine's streams against the JAX package's isolated greedy
    ``encdec_generate`` on the same weights."""
    cfg, params, tree = setup
    jcfg = dataclasses.replace(je.encdec_presets()["tiny"], dtype=jnp.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    eng = engine(cfg, params, slots=2, chunk=3)
    srcs = [[4, 8, 15, 16, 23, 42], [7] * 20]
    handles = [eng.submit(s, 9) for s in srcs]
    run_all(eng, handles)
    for s, h in zip(srcs, handles):
        ref = je.encdec_generate(jp, jnp.asarray([s], jnp.int32), jcfg,
                                 max_new_tokens=9)
        assert h.result(0)["tokens"] == np.asarray(ref)[0].tolist()


def test_slot_reuse_and_stale_cross_kv_isolation(setup):
    """More requests than slots, some submitted mid-run: a reused slot's
    cross K/V and self-attention cache from its previous occupant never
    leak into the next request's decode."""
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=2, chunk=3)
    srcs = [[i + 1, i + 2, i + 3, i + 4] + [i + 5] * (i * 5)
            for i in range(7)]
    handles = [eng.submit(s, 8) for s in srcs[:3]]
    for step in range(400):
        eng.step()
        if step == 2:
            handles += [eng.submit(s, 8) for s in srcs[3:]]
        if len(handles) == 7 and all(h.done() for h in handles):
            break
    assert eng.stats["completed"] == 7
    for s, h in zip(srcs, handles):
        assert h.result(0)["tokens"] == isolated_greedy(cfg, params, s, 8)


def test_long_source_short_source_mix(setup):
    """A source at the largest bucket beside a tiny one: the ``kv_len``
    mask keeps both bucketed encodes exact, and the cross reads cover
    the long source."""
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=2, chunk=4)
    long_src = [((i * 7) % 250) + 1 for i in range(60)]
    hs = [eng.submit(long_src, 8), eng.submit([4, 2], 8)]
    run_all(eng, hs)
    assert hs[0].result(0)["tokens"] == isolated_greedy(cfg, params,
                                                        long_src, 8)
    assert hs[1].result(0)["tokens"] == isolated_greedy(cfg, params, [4, 2],
                                                        8)


def test_source_read_bucket_follows_the_longest_active_source(setup):
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=2, chunk=4)
    assert eng.buckets == (32, 64) and eng.src_cap == 64
    # the engine's host copy of each slot's source length, by slot
    eng._src_lens = [5, 40]
    assert eng._src_limit_for_chunk({0: None}) == 32
    assert eng._src_limit_for_chunk({0: None, 1: None}) is None  # the pool
    # an admission writes its slot's entry
    eng._src_lens = [0, 0]
    h = eng.submit([9] * 40, 2)
    run_all(eng, [h])
    assert sorted(eng._src_lens) == [0, 40]


def test_eos_and_max_new_1(setup):
    cfg, params, _ = setup
    src = [3, 1, 4, 1, 5]
    ref = isolated_greedy(cfg, params, src, 12)
    eos = ref[2]
    eng = engine(cfg, params, slots=2, chunk=4)
    h = eng.submit(src, 12, eos_id=eos)
    h1 = eng.submit([7, 7], 1)
    run_all(eng, [h, h1])
    assert h.result(0)["tokens"] == ref[:ref.index(eos) + 1]
    assert h1.result(0)["tokens"] == isolated_greedy(cfg, params, [7, 7], 1)


def test_sampling_paths_stay_in_vocab(setup):
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=2, chunk=4)
    hs = [eng.submit([1, 2, 3], 6, temperature=0.8),
          eng.submit([4, 5], 6, temperature=0.9, top_k=4, top_p=0.9)]
    run_all(eng, hs)
    for h in hs:
        toks = h.result(0)["tokens"]
        assert len(toks) == 6
        assert all(0 <= t < cfg.vocab_size for t in toks)


def test_validation_and_scope(setup):
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=2, chunk=4)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="largest source bucket"):
        eng.submit([1] * (cfg.max_src_len + 1), 4)
    with pytest.raises(ValueError, match="decoder cache capacity"):
        eng.submit([1, 2], cfg.max_tgt_len + 1)
    with pytest.raises(ValueError, match="prefix registry"):
        eng.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="chunked prefill"):
        engine(cfg, params, prefill_chunk=8)
    with pytest.raises(ValueError, match="max_src_len"):
        engine(cfg, params, buckets=(32, 128))
    llama = type("LlamaLike", (), {})()
    with pytest.raises(ValueError, match="EncDecConfig"):
        EncDecSlotEngine(llama, params)
    # the decoder cache is the target side's, the pool the source side's
    small = engine(cfg, params, slots=2, max_seq=16)
    assert small._k.shape == (cfg.dec_layers, 2, 16, cfg.n_kv_heads,
                              cfg.head_dim)
    assert small._ck.shape == (cfg.dec_layers, 2, 64, cfg.n_kv_heads,
                               cfg.head_dim)


def test_warmup_thread_loop_and_streaming(setup, refs):
    cfg, params, _ = setup
    eng = engine(cfg, params, slots=2, chunk=4)
    eng.warmup(rows=(1, 2))
    assert eng.stats["completed"] == 0  # warmup leaves the stats as they were
    with eng:
        h = eng.submit(SRCS[0], MAX_NEWS[0], stream=True)
        streamed = list(h.stream(timeout=60))
        other = eng.submit(SRCS[3], MAX_NEWS[3])
        assert other.result(60)["tokens"] == refs[3]
    assert streamed == refs[0]
    assert h.result(0) == {"tokens": refs[0], "length": len(refs[0])}


@pytest.mark.parametrize("perm", [(0, 1, 2), (2, 1, 0)])
def test_any_order_of_three_same_bucket_sources(setup, perm):
    """Three sources of one bucket admit as a row group whose rows follow
    the submission order; each stream stays its own."""
    cfg, params, _ = setup
    srcs = [[3, 3, 3], [1, 5, 9, 2], [8] * 11]
    eng = engine(cfg, params, slots=4, chunk=2)
    handles = {i: eng.submit(srcs[i], 7) for i in perm}
    run_all(eng, list(handles.values()))
    for i, h in handles.items():
        assert h.result(0)["tokens"] == isolated_greedy(cfg, params,
                                                        srcs[i], 7)


# --------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_engine_on_the_card_matches_isolated_generation_in_f32(cuda):
    """The tiny preset in f32 on the card: every stream of a ragged burst
    token-exact against ``encdec_generate``, the CPU's bar (tiny's
    head_dim 16 takes the dense attention on both routes)."""
    cfg = dataclasses.replace(te.encdec_presets()["tiny"],
                              dtype=torch.float32)
    params = te.encdec_init(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = EncDecSlotEngine(cfg, params, slots=4, chunk=4,
                           cache_dtype=torch.float32)
    handles = [eng.submit(s, m) for s, m in zip(SRCS, MAX_NEWS)]
    run_all(eng, handles)
    for s, m, h in zip(SRCS, MAX_NEWS, handles):
        ref = te.encdec_generate(params, torch.tensor([s], device=cuda), cfg,
                                 max_new_tokens=m)
        assert h.result(0)["tokens"] == ref[0].tolist()
