"""The port's serving benchmarks (``infer/servebench.py``, and
``infer/quantize.py`` ``bench_int8_serving``) against the JAX ones.

Each function runs at the ``tiny`` preset on the CPU, in the JAX package
and in the port, with the same arguments. The port's result has every
key of the JAX result (plus the card's name and memory where a device
number needs them), and the fields that do not depend on timing or on
the random weights are equal: ok flags, byte counts, token counts,
capacities, page counts, prefix hits. Times are the CPU's and are not
compared. The weights differ (each package draws its own), so tokens are
not compared across packages; each benchmark's own match counts are.
"""

import json

import pytest
import torch

from tpu_docker_api.infer import quantize as jquant
from tpu_docker_api.infer import servebench as jbench
from tpu_docker_api_torch.infer import quantize as tquant
from tpu_docker_api_torch.infer import servebench as tbench

#: function → (tiny-preset arguments, fields equal to the JAX result's)
CASES = {
    "bench_concurrent_serving": (
        dict(streams=2, prompt_len=8, new_tok=4, max_seq=64, chunk=4,
             reps=1),
        ("ok", "preset", "quantized", "streams", "prompt_len", "new_tokens",
         "chunk", "wasted_steps", "fused_projections")),
    "bench_prefix_serving": (
        dict(requests=3, prefix_len=20, suffix_len=4, new_tok=3, max_seq=64,
             slots=2, chunk=4, reps=1),
        ("ok", "preset", "quantized", "requests", "prefix_len", "suffix_len",
         "new_tokens", "prefix_hits")),
    "bench_chunked_prefill": (
        dict(prompt_len=40, stream_new=12, chunk=2, prefill_chunk=16,
             max_seq=64),
        ("preset", "quantized", "prompt_len", "prefill_chunk")),
    "bench_decode_roofline": (
        dict(batch=2, prompt_len=8, new_tok=4, max_seq=64, reps=1),
        ("ok", "preset", "batch", "prompt_len", "new_tokens", "weights_gb",
         "pct_hbm_roof", "cache_gb_at_end", "cache_dtype",
         "fused_projections")),
    "bench_decode_batch_sweep": (
        dict(batches=(1, 2), prompt_len=8, new_tok=3, max_seq=32, reps=1),
        ()),
    "bench_tail_latency": (
        dict(streams=2, n_requests=4, arrival_s=0.01, prompt_lens=(4, 12),
             new_tok=5, max_seq=64, chunk=4),
        ("ok", "preset", "quantized", "streams", "n_requests", "arrival_ms",
         "new_tokens", "chunk", "prompt_lens")),
    "bench_paged_capacity": (
        dict(streams=2, max_seq=256, page_size=16, prompt_len=8, new_tok=4,
             chunk=4, reps=1),
        ("ok", "preset", "streams", "capacity", "capacity_note",
         "page_size", "total_pages", "dense_cache_gb", "paged_pool_gb",
         "weights_gb", "deferred_admissions")),
    "bench_paged_vs_dense": (
        dict(streams=2, prompt_len=8, new_tok=4, max_seq=64, page_size=16,
             chunk=4, reps=1),
        ("ok", "match_rows", "preset", "quantized", "streams", "page_size")),
    "bench_paged_prefix": (
        dict(requests=2, slots=4, prefix_len=40, suffix_len=4, new_tok=3,
             max_seq=128, page_size=16, chunk=4, reps=1),
        ("ok", "preset", "requests", "slots", "capacity_note", "prefix_len",
         "suffix_len", "new_tokens", "page_size", "total_pages",
         "dense_cache_gb", "paged_pool_gb", "prefix_hits",
         "deferred_admissions")),
    # 8 requests promise 400 tokens and stop after 4: full reservation
    # pins 7 pages of 64 each, grow 2 (the prefill bucket's)
    "bench_paged_admission": (
        dict(streams=8, prompt_len=8, promised_new=400, actual_new=4,
             max_seq=512, page_size=64, chunk=4, total_pages=16),
        ("ok", "preset", "streams", "promised_new", "actual_new_max",
         "total_pages", "full_need_per_request", "match_rows",
         "admission_ratio")),
}

#: keys the port adds beside the JAX ones: the card's name and power
#: limit beside a roofline share, the card's memory beside a dense-fits
#: verdict
EXTRA = {"bench_decode_roofline": {"card"},
         "bench_decode_batch_sweep": {"card"},
         "bench_paged_capacity": {"device_memory_gb"},
         "bench_paged_prefix": {"device_memory_gb"}}


def _keys(tree, prefix=""):
    """Every key path of a nested result dict."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_keys_and_deterministic_fields_as_jax(name):
    kw, same = CASES[name]
    jres = getattr(jbench, name)(preset="tiny", **kw)
    tres = getattr(tbench, name)(preset="tiny", device="cpu", **kw)
    json.dumps(tres)  # every result prints as one JSON line
    assert _keys(tres) - _keys(jres) == EXTRA.get(name, set())
    assert _keys(jres) <= _keys(tres)
    assert {k: tres[k] for k in same} == {k: jres[k] for k in same}
    if name == "bench_decode_batch_sweep":
        assert [p["batch"] for p in tres["points"]] == [1, 2]
        assert [p["pct_hbm_roof"] for p in tres["points"]] == [None, None]
        assert [set(p) for p in tres["points"]] == [
            set(p) for p in jres["points"]]
    if name == "bench_chunked_prefill":
        assert len(tres["whole"]["rep_max_gaps_ms"]) == 3
    if name == "bench_tail_latency":
        assert tres["engine_latency"]["n"] == jres["engine_latency"]["n"]
    if name == "bench_paged_admission":
        assert tres["ok"]  # grow admits >= 2x full, tokens equal
        assert (tres["grow"]["admitted_first_wave"],
                tres["full"]["admitted_first_wave"]) == (
            jres["grow"]["admitted_first_wave"],
            jres["full"]["admitted_first_wave"])


def test_off_the_card_device_numbers_are_none():
    """A CPU run names its device and states no bandwidth, roofline
    share or card memory (the JAX function's dense-fits verdict on an
    unknown chip assumes 16 GB; the port says it does not know)."""
    res = tbench.bench_paged_capacity(preset="tiny", streams=1, max_seq=128,
                                      page_size=16, prompt_len=8, new_tok=2,
                                      chunk=2, reps=1, device="cpu")
    assert res["device_memory_gb"] is None
    assert res["dense_fits_with_weights"] is None
    assert tbench._hbm_bw("cpu") is None and tbench._card("cpu") == "cpu"
    assert tbench.HBM_BW["NVIDIA H100 80GB HBM3"] == 3.35e12


def test_int8_serving_same_keys_and_fields_as_jax():
    kw = dict(preset="tiny", batch=2, new_tok=3, prompt_len=4, reps=1,
              max_seq=16)
    jres = jquant.bench_int8_serving(**kw)
    tres = tquant.bench_int8_serving(**kw, device="cpu")
    assert set(tres) == set(jres)
    for k in ("ok", "weights_gb", "batch", "prompt_len", "new_tokens",
              "fused_projections"):
        assert tres[k] == jres[k], k
    assert tres["ok"] is True


@pytest.mark.parametrize("xs,p", [([3.0], 50), ([5.0, 1.0, 4.0, 2.0], 50),
                                  ([float(i) for i in range(100)], 99),
                                  ([2.0, 9.0, 4.0], 0)])
def test_percentile_and_pow2_rows_as_jax(xs, p):
    assert tbench._percentile(xs, p) == jbench._percentile(xs, p)
    n = len(xs)
    assert tbench._pow2_rows(n) == jbench._pow2_rows(n)


def test_default_device_is_the_card():
    """Without a card a benchmark asked for its default device raises;
    none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        tbench.bench_decode_roofline(preset="tiny", batch=1, prompt_len=4,
                                     new_tok=2, max_seq=16, reps=1)
