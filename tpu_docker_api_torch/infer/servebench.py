"""Serving benchmarks: concurrent slot-engine throughput, prefix caching,
chunked prefill, the decode roofline, tail latency, the paged cache and
seq2seq continuous batching (counterpart of ``tpu_docker_api/infer/servebench.py``): one place for
the metric definitions, with the JAX functions' argument names and
result keys.

Metric definitions:

- ``serialized_tok_s``: N requests decoded one after another through the
  ``--slots 0`` whole-generation engine at batch 1 (the encoder-decoder:
  ``encdec_generate``).
- ``slot_tok_s``: the same N requests submitted at once to the slot
  engine (infer/slots.py), admission and chunked decode included.
- ``decode_only_ms_per_tok``: pure decode-step cost, prefill excluded,
  from the difference of two whole-generation runs (new_tok tokens and
  1 token), which share one prefill.
- ``pct_hbm_roof``: decode tok/s as a fraction of the weight-streaming
  roof ``batch * HBM_BW / weight_bytes``: every decode step reads every
  weight byte once (KV-cache reads push the real roof lower; reported
  apart as ``cache_gb_at_end``). It sits beside ``card``, the card's
  name and power limit: a card below its maximum power runs slower.

Every function takes ``device`` (default ``cuda``). Device work is timed
on the host's clock around work that ends in ``torch.cuda.synchronize``
(or in tokens the host has read). Weights are random from a seed (or
``synth_quantized_params``) and prompts come from seeded ``torch``
generators, so the JAX functions' tokens are not reproduced; their
counts, bytes and capacities are.
"""

from __future__ import annotations

import gc
import subprocess
import time

import torch

#: HBM bandwidth in bytes/s by ``torch.cuda.get_device_name()``: the H100
#: SXM's 3.35 TB/s (NVIDIA's data sheet). Used only for the roofline
#: denominator; other devices report pct_hbm_roof=None.
HBM_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _hbm_bw(device) -> float | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return HBM_BW.get(torch.cuda.get_device_name(device))


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    device type off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    """Release a finished run's engine and buffers before the next one
    allocates."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _tokens(seed: int, n: int, vocab: int) -> list[int]:
    """``n`` uniform token ids from a seeded generator (the JAX function
    draws from ``PRNGKey(seed)``)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g).tolist()


def _model(cfg, quantize: bool, device) -> dict:
    if quantize:
        from tpu_docker_api_torch.infer.quantize import synth_quantized_params

        return synth_quantized_params(cfg, device=device)
    from tpu_docker_api_torch.models.llama import llama_init

    return llama_init(cfg, torch.Generator(device=device).manual_seed(0))


def _serve_all(eng, prompts: list, new_tok: int, **kw) -> list:
    """Submit every prompt at once and step the engine until all are
    done; returns the handles."""
    handles = [eng.submit(pr, new_tok, **kw) for pr in prompts]
    while not all(h.done() for h in handles):
        eng.step()
    return handles


def _pow2_rows(streams: int) -> tuple[int, ...]:
    """(1, 2, 4, ..., <= streams) — the admission row counts a burst can
    group into; warming all of them keeps first-call costs out of
    measured windows."""
    rows = [1]
    while rows[-1] * 2 <= streams:
        rows.append(rows[-1] * 2)
    return tuple(rows)


def bench_concurrent_serving(
    preset: str = "llama3-1b",
    streams: int = 8,
    prompt_len: int = 128,
    new_tok: int = 64,
    max_seq: int = 512,
    chunk: int = 8,
    quantize: bool = False,
    reps: int = 2,
    cfg=None,
    params=None,
    fuse: bool = False,
    diagnose_mismatch: bool = False,
    prompts: list | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """N concurrent streams through the slot engine against the same N
    one after another through the ``--slots 0`` engine at batch 1. Pass
    ``cfg``/``params`` to measure a specific model and ``prompts`` to
    override the random-token prompts.

    ``diagnose_mismatch``: on a row mismatch, re-derive the first
    diverging step's logits with a fresh forward on the serialized
    context and report the top-2 gap there, which tells a bf16 near-tie
    between batch shapes (a gap of a few bf16 ulps of the logit scale)
    from a numerics fault (a large gap, yet another argmax)."""
    import numpy as np

    from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                   make_generate_fn)
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    if cfg is None:
        cfg = llama_presets()[preset]
    if params is None:
        params = _model(cfg, quantize, device)
    if fuse:
        # what serve runs (its default): both paths get the fused tree
        from tpu_docker_api_torch.infer.quantize import fuse_llama_projections

        params = fuse_llama_projections(params)
    if prompts is None:
        prompts = [_tokens(10 + i, prompt_len, cfg.vocab_size)
                   for i in range(streams)]
    prompt_len = len(prompts[0])

    # -- serialized baseline: batch-1 whole generations, one at a time
    fn = make_generate_fn(cfg, GenerateConfig(
        max_new_tokens=new_tok, temperature=0.0, max_seq=max_seq))

    def one(pr):
        return fn(params, torch.tensor([pr], device=device))

    one(prompts[0])
    _sync(device)
    ser_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [one(pr) for pr in prompts]
        _sync(device)
        ser_times.append(time.perf_counter() - t0)
    ser_dt = min(ser_times)
    ser_tokens = [o["tokens"][0].tolist() for o in outs]

    # -- slot engine: all N submitted up front, admission + chunked
    # decode timed together (what a client pool experiences)
    eng = SlotEngine(cfg, params, slots=streams, max_seq=max_seq,
                     chunk=chunk)
    eng.warmup(rows=(1, streams))  # the burst admits as one R=streams group
    slot_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        handles = _serve_all(eng, prompts, new_tok)
        _sync(device)
        slot_times.append(time.perf_counter() - t0)
    slot_dt = min(slot_times)
    slot_tokens = [h.result(0)["tokens"] for h in handles]

    total = streams * new_tok
    # bf16 products differ between batch shapes, so argmax near-ties can
    # flip against the batch-1 reference on random weights; the f32 CPU
    # tests are the exactness proof. The match rate is reported, not
    # gated.
    matches = sum(s == r for s, r in zip(slot_tokens, ser_tokens))
    detail = None
    if diagnose_mismatch and matches < streams:
        from tpu_docker_api_torch.models.llama import llama_forward

        i, s_row, r_row = next(
            (i, s, r) for i, (s, r)
            in enumerate(zip(slot_tokens, ser_tokens)) if s != r)
        t = next(j for j, (a, b) in enumerate(zip(s_row, r_row)) if a != b)
        ctx = prompts[i] + r_row[:t]
        with torch.no_grad():
            logits = llama_forward(params, torch.tensor([ctx], device=device),
                                   cfg)[0, -1].float().cpu().numpy()
        order = np.argsort(logits)[::-1]
        top2 = [int(order[0]), int(order[1])]
        gap = float(logits[order[0]] - logits[order[1]])
        # bf16 steps near the max logit are ~|max|·2⁻⁸; the tie question
        # is whether BOTH emitted tokens sit in one noise-width cluster
        ulp = abs(float(logits[order[0]])) * 2.0 ** -8
        slot_rank = int(np.nonzero(order == s_row[t])[0][0])
        slot_gap = float(logits[order[0]] - logits[s_row[t]])
        tie_width = 32 * ulp
        detail = {
            "row": i, "step": t,
            "serialized_tok": r_row[t], "slot_tok": s_row[t],
            "top2": top2, "top2_gap": round(gap, 6),
            "bf16_ulp_at_max": round(ulp, 6),
            "gap_in_ulps": round(gap / ulp, 2) if ulp else None,
            "max_logit": round(float(logits[order[0]]), 4),
            "slot_tok_rank": slot_rank,
            "slot_tok_gap_ulps": (round(slot_gap / ulp, 2)
                                  if ulp else None),
            "cluster_within_32ulp": int((logits >= logits[order[0]]
                                         - tie_width).sum()),
            "both_in_top2": sorted((s_row[t], r_row[t])) == sorted(top2),
        }
    return {
        "ok": all(len(t) == new_tok for t in slot_tokens),
        "match_rows": f"{matches}/{streams}",
        **({"mismatch_detail": detail} if detail is not None else {}),
        "preset": preset,
        "quantized": quantize,
        "streams": streams,
        "prompt_len": prompt_len,
        "new_tokens": new_tok,
        "chunk": chunk,
        "serialized_tok_s": round(total / ser_dt, 1),
        "slot_tok_s": round(total / slot_dt, 1),
        "speedup": round(ser_dt / slot_dt, 2),
        "wasted_steps": eng.stats["wasted_steps"],
        "fused_projections": fuse,
    }


def bench_prefix_serving(
    preset: str = "llama3-1b",
    requests: int = 16,
    prefix_len: int = 448,
    suffix_len: int = 16,
    new_tok: int = 16,
    max_seq: int = 1024,
    slots: int = 8,
    chunk: int = 8,
    reps: int = 2,
    quantize: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Prefix caching under a prefill-bound load: N requests sharing a
    ``prefix_len``-token header with short suffixes and generations. The
    same request set through the slot engine with the prefix registered
    and without; with it, each request prefills O(suffix) instead of
    O(prefix + suffix)."""
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = _model(cfg, quantize, device)
    prefix = _tokens(5, prefix_len, cfg.vocab_size)
    prompts = [prefix + _tokens(20 + i, suffix_len, cfg.vocab_size)
               for i in range(requests)]

    def run_timed(register: bool):
        eng = SlotEngine(cfg, params, slots=slots, max_seq=max_seq,
                         chunk=chunk)
        if register:
            eng.register_prefix(prefix)
        times, toks = [], None
        # round 0 is the warmup: it reaches every (bucket, rows) prefill
        # and the decode chunk this load runs
        for r in range(1 + reps):
            t0 = time.perf_counter()
            handles = _serve_all(eng, prompts, new_tok)
            _sync(device)
            if r > 0:
                times.append(time.perf_counter() - t0)
            toks = [h.result(0)["tokens"] for h in handles]
        stats = dict(eng.stats)
        del eng
        _free(device)
        return min(times), toks, stats

    full_dt, full_toks, _ = run_timed(False)
    px_dt, px_toks, px_stats = run_timed(True)
    total = requests * new_tok
    matches = sum(a == b for a, b in zip(px_toks, full_toks))
    return {
        "ok": (all(len(t) == new_tok for t in px_toks)
               and px_stats["prefix_hits"] >= requests),
        "match_rows": f"{matches}/{requests}",
        "preset": preset,
        "quantized": quantize,
        "requests": requests,
        "prefix_len": prefix_len,
        "suffix_len": suffix_len,
        "new_tokens": new_tok,
        "full_tok_s": round(total / full_dt, 1),
        "prefix_tok_s": round(total / px_dt, 1),
        "speedup": round(full_dt / px_dt, 2),
        "prefix_hits": px_stats["prefix_hits"],
    }


def bench_chunked_prefill(
    preset: str = "llama3-1b",
    prompt_len: int = 960,
    stream_new: int = 96,
    chunk: int = 8,
    prefill_chunk: int = 128,
    max_seq: int = 1024,
    quantize: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """The gap between tokens that a LONG admission inflicts on an active
    stream: a short streaming request decodes while a
    ``prompt_len``-token prompt is admitted; the metric is the longest
    gap between the stream's consecutive tokens. Whole-prompt admission
    stalls decode for the whole prefill, chunked prefill for one segment.
    Both runs also report the long request's completion time (what the
    segments trade away)."""
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models.llama import llama_presets

    if stream_new < 9:
        # the long prompt is admitted after the stream's 8th token
        raise ValueError(f"stream_new must be >= 9, got {stream_new}")
    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = _model(cfg, quantize, device)
    short = _tokens(30, 16, cfg.vocab_size)
    long_p = _tokens(31, prompt_len, cfg.vocab_size)

    def run(pc: int, reps: int = 3) -> dict:
        eng = SlotEngine(cfg, params, slots=4, max_seq=max_seq,
                         chunk=chunk, prefill_chunk=pc)
        eng.start()
        try:
            for _ in range(2):  # warm every path this scenario reaches
                h = eng.submit(short, stream_new)
                h2 = eng.submit(long_p, 4)
                h.result(300)
                h2.result(300)
            max_gaps, long_dts = [], []
            for _ in range(reps):
                hs = eng.submit(short, stream_new, stream=True)
                it = hs.stream(timeout=300)
                next(it)
                arrivals = [time.perf_counter()]
                t_long0 = None
                hl = None
                for _t in it:
                    arrivals.append(time.perf_counter())
                    if hl is None and len(arrivals) >= 8:
                        hl = eng.submit(long_p, 4)   # admit mid-stream
                        t_long0 = time.perf_counter()
                hl.result(300)
                # the engine stamps completed_at at resolution
                long_dts.append(hl.completed_at - t_long0)
                gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
                # the long prompt is submitted after arrivals[7], so gap
                # 7 is the first that can hold its stall; tokens resolve
                # per processed chunk, so the floor is a chunk's time
                max_gaps.append(max(gaps[7:]))
        finally:
            eng.close()
        # noise only INFLATES a max gap: the smallest is the best estimate
        return {"max_gap_ms": round(min(max_gaps) * 1e3, 1),
                "rep_max_gaps_ms": [round(g * 1e3, 1) for g in max_gaps],
                "long_request_s": round(sorted(long_dts)[len(long_dts)
                                                         // 2], 3)}

    whole = run(0)
    _free(device)
    seg = run(prefill_chunk)
    _free(device)
    return {
        "ok": seg["max_gap_ms"] < whole["max_gap_ms"],
        "preset": preset,
        "quantized": quantize,
        "prompt_len": prompt_len,
        "prefill_chunk": prefill_chunk,
        "whole": whole,
        "chunked": seg,
        "stall_reduction": round(
            whole["max_gap_ms"] / max(seg["max_gap_ms"], 1e-6), 2),
    }


def bench_decode_roofline(
    preset: str = "llama3-8b",
    batch: int = 64,
    prompt_len: int = 128,
    new_tok: int = 64,
    max_seq: int = 512,
    reps: int = 3,
    cache_dtype: str = "bfloat16",
    fuse: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Decode-only ms/token and % of the weight-streaming HBM roof for
    the int8 model. Decode-only time is the difference of whole
    generations of new_tok tokens and of 1: both include one prefill of
    the same shape, so the difference is (new_tok - 1) decode steps."""
    from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                   make_generate_fn)
    from tpu_docker_api_torch.infer.quantize import (quantized_bytes,
                                                     synth_quantized_params)
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = synth_quantized_params(cfg, device=device)
    weight_bytes = quantized_bytes(params)
    if fuse:
        from tpu_docker_api_torch.infer.quantize import fuse_llama_projections

        params = fuse_llama_projections(params)
    dtype = getattr(torch, cache_dtype)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g).to(device)

    def timed(n):
        fn = make_generate_fn(cfg, GenerateConfig(
            max_new_tokens=n, temperature=0.0, max_seq=max_seq,
            cache_dtype=dtype))
        fn(params, prompt)
        _sync(device)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(params, prompt)
            _sync(device)
            times.append(time.perf_counter() - t0)
        return min(times)

    t_full = timed(new_tok)
    t_one = timed(1)
    decode_s_per_step = (t_full - t_one) / (new_tok - 1)
    decode_tok_s = batch / decode_s_per_step

    bw = _hbm_bw(device)
    # weight-streaming roof: every decode step reads every weight byte
    roof_tok_s = batch * bw / weight_bytes if bw else None
    # KV bytes read a step: decode attention reads the WHOLE allocated
    # buffer (make_generate_fn sizes it to prompt + new rounded up to
    # 128), not just the filled positions
    capacity = min(max_seq, (prompt_len + new_tok - 1 + 127) // 128 * 128)
    itemsize = torch.empty((), dtype=dtype).element_size()
    cache_bytes = (2 * cfg.n_layers * batch * capacity
                   * cfg.n_kv_heads * cfg.head_dim * itemsize)
    return {
        "ok": True,
        "preset": preset,
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tok,
        "weights_gb": round(weight_bytes / 2**30, 2),
        "decode_only_ms_per_tok": round(decode_s_per_step * 1e3, 3),
        "decode_tok_s": round(decode_tok_s, 1),
        "prefill_plus1_s": round(t_one, 3),
        "pct_hbm_roof": (round(100 * decode_tok_s / roof_tok_s, 1)
                         if roof_tok_s else None),
        "card": _card(device),
        "cache_gb_at_end": round(cache_bytes / 2**30, 3),
        "cache_dtype": cache_dtype,
        "fused_projections": fuse,
    }


def bench_decode_batch_sweep(
    preset: str = "llama3-8b",
    batches: tuple[int, ...] = (16, 32, 64, 128, 256),
    prompt_len: int = 128,
    new_tok: int = 32,
    max_seq: int = 256,
    reps: int = 2,
    device: str | torch.device = "cuda",
) -> dict:
    """Decode tok/s against batch at a fixed cache budget: how far
    batching amortizes the weight stream before cache reads and attention
    take over. Each batch point stands alone (an out-of-memory point is
    recorded and the sweep goes on)."""
    device = torch.device(device)
    out = {"points": [], "card": _card(device)}
    for b in batches:
        try:
            r = bench_decode_roofline(
                preset=preset, batch=b, prompt_len=prompt_len,
                new_tok=new_tok, max_seq=max_seq, reps=reps, device=device)
            out["points"].append({
                "batch": b,
                "decode_tok_s": r["decode_tok_s"],
                "decode_only_ms_per_tok": r["decode_only_ms_per_tok"],
                "pct_hbm_roof": r["pct_hbm_roof"],
            })
        except torch.OutOfMemoryError as e:
            out["points"].append({"batch": b, "error": str(e)[:120]})
        finally:
            _free(device)
    return out


def bench_moe_serving(
    preset: str = "bench-moe",
    batch: int = 8,
    prompt_len: int = 128,
    new_tok: int = 64,
    max_seq: int = 256,
    reps: int = 3,
    device: str | torch.device = "cuda",
) -> dict:
    """The ``moe:`` serving preset's decode number, by
    ``bench_decode_roofline``'s differencing: whole generations of
    new_tok tokens and of 1 share one prefill, so their difference is
    (new_tok - 1) decode steps. Random bf16 weights from seed 0."""
    from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                   make_generate_fn)
    from tpu_docker_api_torch.models.moe import moe_init, moe_presets

    device = torch.device(device)
    cfg = moe_presets()[preset]
    params = moe_init(cfg, torch.Generator(device=device).manual_seed(0))
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g).to(device)

    def timed(n):
        fn = make_generate_fn(cfg, GenerateConfig(
            max_new_tokens=n, temperature=0.0, max_seq=max_seq))
        fn(params, prompt)
        _sync(device)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(params, prompt)
            _sync(device)
            times.append(time.perf_counter() - t0)
        return min(times)

    t_full, t_one = timed(new_tok), timed(1)
    decode_s = (t_full - t_one) / (new_tok - 1)
    return {
        "preset": preset,
        "batch": batch,
        "new_tokens": new_tok,
        "decode_tok_s": round(batch / decode_s, 1),
        "decode_only_ms_per_tok": round(decode_s * 1e3, 3),
        "tok_s_incl_prefill": round(batch * new_tok / t_full, 1),
        "card": _card(device),
    }


def _percentile(xs: list[float], p: float) -> float:
    """Nearest-rank percentile (no interpolation — honest at small n)."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(p / 100 * len(s))) - 1))]


def bench_tail_latency(
    preset: str = "llama3-1b",
    streams: int = 8,
    n_requests: int = 32,
    arrival_s: float = 0.05,
    prompt_lens: tuple[int, ...] = (32, 128, 384),
    new_tok: int = 48,
    max_seq: int = 512,
    chunk: int = 8,
    quantize: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Tail-latency SLOs under a mixed OPEN-LOOP load: ``n_requests``
    streaming requests with cycled prompt lengths arrive at a fixed
    inter-arrival time; per request the consumer records TTFT (submit →
    first token) and the gaps between tokens. Reports p50/p99 of both.
    ITL is chunk-granular by design (the engine resolves tokens per
    processed chunk at the pipeline lag), so the chunk size is part of
    the operating point and is reported."""
    import threading

    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = _model(cfg, quantize, device)
    prompts = [_tokens(40 + i, prompt_lens[i % len(prompt_lens)],
                       cfg.vocab_size) for i in range(n_requests)]
    eng = SlotEngine(cfg, params, slots=streams, max_seq=max_seq,
                     chunk=chunk, max_pending=n_requests)
    # every power-of-two admission row count: queued requests admit as
    # R > 1 groups once slots free in bursts
    eng.warmup(rows=_pow2_rows(streams))
    eng.start()
    try:
        # one real-length prompt per distinct length
        for i in range(len(prompt_lens)):
            eng.submit(prompts[i], 4).result(300)
        eng.reset_latency_stats()  # the warmup stays out of the engine's

        ttfts: list[float] = []
        mean_itls: list[float] = []
        max_itls: list[float] = []
        lock = threading.Lock()

        def consume(handle, t_submit):
            arrivals = [time.perf_counter()
                        for _ in handle.stream(timeout=600)]
            with lock:
                ttfts.append(arrivals[0] - t_submit)
                # tokens resolve per processed chunk, so raw gaps are
                # bursty; the per-request MEAN gap is the cadence a
                # client sees, the MAX gap its worst stall
                gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
                if gaps:
                    mean_itls.append(sum(gaps) / len(gaps))
                    max_itls.append(max(gaps))

        threads = []
        t_bench0 = time.perf_counter()
        for i, pr in enumerate(prompts):
            target = t_bench0 + i * arrival_s
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            h = eng.submit(pr, new_tok, stream=True)
            th = threading.Thread(target=consume,
                                  args=(h, time.perf_counter()))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t_bench0
        engine_lat = eng.latency_stats()
    finally:
        eng.close()
    return {
        "ok": len(ttfts) == n_requests,
        # the engine's own percentiles over the same load: the SLO
        # export's numbers beside this client-side measurement
        "engine_latency": engine_lat,
        "preset": preset,
        "quantized": quantize,
        "streams": streams,
        "n_requests": n_requests,
        "arrival_ms": round(arrival_s * 1e3, 1),
        "new_tokens": new_tok,
        "chunk": chunk,
        "prompt_lens": list(prompt_lens),
        "ttft_p50_ms": round(_percentile(ttfts, 50) * 1e3, 1),
        "ttft_p99_ms": round(_percentile(ttfts, 99) * 1e3, 1),
        "itl_p50_ms": round(_percentile(mean_itls, 50) * 1e3, 1),
        "itl_p99_ms": round(_percentile(mean_itls, 99) * 1e3, 1),
        "itl_max_p99_ms": round(_percentile(max_itls, 99) * 1e3, 1),
        "aggregate_tok_s": round(n_requests * new_tok / wall, 1),
    }


def _device_memory_gb(device) -> float | None:
    """The card's memory (None off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory / 2**30


def bench_paged_capacity(
    preset: str = "llama3-8b",
    streams: int = 32,
    max_seq: int = 3072,
    page_size: int = 64,
    prompt_len: int = 128,
    new_tok: int = 64,
    chunk: int = 8,
    reps: int = 2,
    device: str | torch.device = "cuda",
) -> dict:
    """A serving point the dense cache cannot reach: ``streams`` slots at
    ``max_seq`` capacity on the int8 model. The dense allocation is
    reported ARITHMETICALLY (slots × max_seq × bytes a position) against
    the card's memory, not attempted, while the paged pool, sized to the
    live tokens of the requests, runs the load and reports throughput."""
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine, _ceil_div
    from tpu_docker_api_torch.infer.quantize import (quantized_bytes,
                                                     synth_quantized_params)
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = synth_quantized_params(cfg, device=device)
    pos_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    dense_gb = streams * max_seq * pos_bytes / 2**30
    # pool: exactly the pages this load needs + one slot of headroom
    per_req = _ceil_div(max(256, prompt_len + new_tok), page_size)
    total_pages = streams * per_req + _ceil_div(max_seq, page_size)
    pool_gb = (total_pages + 1) * page_size * pos_bytes / 2**30

    prompts = [_tokens(60 + i, prompt_len, cfg.vocab_size)
               for i in range(streams)]
    # explicit bucket list: every bucket must divide by the page size
    buckets = tuple(b for b in (128, 256, 512, 1024)
                    if b % page_size == 0 and b >= prompt_len
                    and b <= max_seq) or (max_seq,)
    eng = PagedSlotEngine(cfg, params, page_size=page_size,
                          total_pages=total_pages, slots=streams,
                          max_seq=max_seq, chunk=chunk, buckets=buckets)
    eng.warmup(buckets=buckets[:1], rows=(1, min(streams, 8)))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        handles = _serve_all(eng, prompts, new_tok)
        _sync(device)
        times.append(time.perf_counter() - t0)
    ok = all(h.result(0)["length"] == new_tok for h in handles)
    dt = min(times)
    hbm_gb = _device_memory_gb(device)
    weights_gb = quantized_bytes(params) / 2**30
    return {
        "ok": ok and eng.stats["completed"] >= streams,
        "preset": preset,
        "streams": streams,
        "capacity": max_seq,
        # per-slot ADDRESSABLE reach, not streams × capacity resident
        # tokens: the pool follows live tokens, which is the point
        "capacity_note": (f"{streams} streams x {max_seq} addressable "
                          "per slot; pool sized to live tokens"),
        "page_size": page_size,
        "total_pages": total_pages,
        "dense_cache_gb": round(dense_gb, 2),
        "paged_pool_gb": round(pool_gb, 2),
        "weights_gb": round(weights_gb, 2),
        "device_memory_gb": hbm_gb,
        "dense_fits_with_weights": ((dense_gb + weights_gb) < hbm_gb
                                    if hbm_gb else None),
        "aggregate_tok_s": round(streams * new_tok / dt, 1),
        "deferred_admissions": eng.stats["deferred_admissions"],
    }


def bench_encdec_slot_serving(
    preset: str = "encdec-base",
    streams: int = 8,
    requests: int = 16,
    src_len: int = 128,
    new_tok: int = 96,
    chunk: int = 8,
    reps: int = 2,
    cfg=None,
    params=None,
    src_vocab: int = 0,
    srcs: list | None = None,
    return_tokens: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Seq2seq continuous batching against the serialized path:
    ``requests`` sources submitted at once flow through ``streams`` slots
    of the encoder-decoder slot engine, against the same sources one
    after another through batch-1 ``encdec_generate`` (the ``--slots 0``
    path). ``requests > streams`` and a long generation make it the
    sustained-load shape. ``src_vocab`` draws the sources from ``[1,
    src_vocab)`` (a trained model's data distribution; 0 is BOS); the
    token match per row is reported, not gated (bf16 near-ties, as in
    ``bench_concurrent_serving``)."""
    from tpu_docker_api_torch.infer.encdec_slots import EncDecSlotEngine
    from tpu_docker_api_torch.models.encdec import (encdec_generate,
                                                    encdec_init,
                                                    encdec_presets)

    device = torch.device(device)
    if cfg is None:
        cfg = encdec_presets()[preset]
    if params is None:
        params = encdec_init(cfg,
                             torch.Generator(device=device).manual_seed(0))
    if srcs is None:
        hi = src_vocab or cfg.vocab_size
        lo = 1 if src_vocab else 0
        srcs = [[lo + t for t in _tokens(50 + i, src_len, hi - lo)]
                for i in range(requests)]
    src_len = len(srcs[0])

    def one(src):
        return encdec_generate(params, torch.tensor([src], device=device),
                               cfg, max_new_tokens=new_tok)

    one(srcs[0])
    _sync(device)
    ser_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [one(src) for src in srcs]
        _sync(device)
        ser_times.append(time.perf_counter() - t0)
    ser_dt = min(ser_times)
    ser_tokens = [o[0].tolist() for o in outs]

    eng = EncDecSlotEngine(cfg, params, slots=streams, chunk=chunk,
                           cache_dtype=cfg.dtype)
    eng.warmup(rows=_pow2_rows(streams))
    slot_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        handles = _serve_all(eng, srcs, new_tok)
        _sync(device)
        slot_times.append(time.perf_counter() - t0)
    slot_dt = min(slot_times)
    slot_tokens = [h.result(0)["tokens"] for h in handles]

    total = requests * new_tok
    matches = sum(a == b for a, b in zip(slot_tokens, ser_tokens))
    return {
        "ok": all(len(t) == new_tok for t in slot_tokens),
        "match_rows": f"{matches}/{requests}",
        **({"slot_tokens": slot_tokens} if return_tokens else {}),
        "preset": preset,
        "streams": streams,
        "requests": requests,
        "src_len": src_len,
        "new_tokens": new_tok,
        "serialized_tok_s": round(total / ser_dt, 1),
        "slot_tok_s": round(total / slot_dt, 1),
        "speedup": round(ser_dt / slot_dt, 2),
        "card": _card(device),
    }


def bench_paged_vs_dense(
    preset: str = "llama3-1b",
    streams: int = 8,
    prompt_len: int = 128,
    new_tok: int = 64,
    max_seq: int = 512,
    page_size: int = 64,
    chunk: int = 8,
    quantize: bool = False,
    reps: int = 2,
    device: str | torch.device = "cuda",
) -> dict:
    """The same load through the dense slot engine and the paged engine
    at an operating point both can run: the cost of paging (the page
    gather is an extra round trip of the live bytes a layer; capacity,
    not speed, is its gain). Reports both throughputs and the token
    match rate between them."""
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = _model(cfg, quantize, device)
    prompts = [_tokens(70 + i, prompt_len, cfg.vocab_size)
               for i in range(streams)]

    def run(eng):
        eng.warmup(rows=(1, streams))
        times, toks = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            handles = _serve_all(eng, prompts, new_tok)
            _sync(device)
            times.append(time.perf_counter() - t0)
            toks = [h.result(0)["tokens"] for h in handles]
        del eng
        _free(device)
        return min(times), toks

    # explicit buckets, every one divisible by the page size; both
    # engines use the same list, so the prefill work is identical
    buckets = tuple(b for b in (64, 128, 256, 512, 1024)
                    if b % page_size == 0 and b <= max_seq
                    and b >= min(page_size, prompt_len))
    dense_dt, dense_toks = run(SlotEngine(
        cfg, params, slots=streams, max_seq=max_seq, chunk=chunk,
        buckets=buckets))
    paged_dt, paged_toks = run(PagedSlotEngine(
        cfg, params, page_size=page_size, slots=streams,
        max_seq=max_seq, chunk=chunk, buckets=buckets))
    total = streams * new_tok
    matches = sum(a == b for a, b in zip(paged_toks, dense_toks))
    return {
        "ok": all(len(t) == new_tok for t in paged_toks),
        "match_rows": f"{matches}/{streams}",
        "preset": preset,
        "quantized": quantize,
        "streams": streams,
        "page_size": page_size,
        "dense_tok_s": round(total / dense_dt, 1),
        "paged_tok_s": round(total / paged_dt, 1),
        "paged_over_dense": round(dense_dt / paged_dt, 2),
    }


def bench_paged_prefix(
    preset: str = "llama3-8b",
    requests: int = 16,
    slots: int = 32,
    prefix_len: int = 960,
    suffix_len: int = 16,
    new_tok: int = 8,
    max_seq: int = 3072,
    page_size: int = 64,
    chunk: int = 8,
    reps: int = 2,
    device: str | torch.device = "cuda",
) -> dict:
    """Paged × prefix caching at a capacity point the dense engine
    cannot allocate: ``requests`` streams sharing a ``prefix_len`` header
    on the int8 model, at ``slots × max_seq`` ADDRESSABLE reach whose
    dense cache is reported, not attempted. The same requests through
    the paged engine with the prefix registered and without; with it,
    each request prefills O(suffix) against refcounted shared pages and
    reserves only private pages."""
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine, _ceil_div
    from tpu_docker_api_torch.infer.quantize import (quantized_bytes,
                                                     synth_quantized_params)
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = synth_quantized_params(cfg, device=device)
    pos_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    dense_gb = slots * max_seq * pos_bytes / 2**30
    prefix = _tokens(8, prefix_len, cfg.vocab_size)
    prompts = [prefix + _tokens(30 + i, suffix_len, cfg.vocab_size)
               for i in range(requests)]
    buckets = tuple(b for b in (32, 64, 128, 256, 512, 1024)
                    if b % page_size == 0 and b <= max_seq)
    if not buckets or buckets[-1] < prefix_len + suffix_len:
        # a bucket must cover the whole prompt (page-aligned)
        cover = -(-(prefix_len + suffix_len) // page_size) * page_size
        buckets = tuple(b for b in buckets if b < cover) + (cover,)
    # pool: the run WITHOUT the prefix is the hungrier one (a full
    # bucket a request); sized to it plus headroom, so neither run's
    # admissions defer and the comparison is pure prefill cost
    full_bucket = next(b for b in buckets
                       if b >= prefix_len + suffix_len)
    per_req = _ceil_div(
        max(full_bucket, prefix_len + suffix_len + new_tok - 1),
        page_size)
    total_pages = requests * per_req + per_req
    pool_gb = (total_pages + 1) * page_size * pos_bytes / 2**30

    def run_timed(register: bool):
        eng = PagedSlotEngine(cfg, params, page_size=page_size,
                              total_pages=total_pages, slots=slots,
                              max_seq=max_seq, chunk=chunk,
                              buckets=buckets)
        if register:
            eng.register_prefix(prefix)
        times, toks = [], None
        # round 0 is the warmup of every path this load reaches
        for r in range(1 + reps):
            t0 = time.perf_counter()
            handles = _serve_all(eng, prompts, new_tok)
            _sync(device)
            if r > 0:
                times.append(time.perf_counter() - t0)
            toks = [h.result(0)["tokens"] for h in handles]
        stats = dict(eng.stats)
        eng.close()
        del eng
        _free(device)
        return min(times), toks, stats

    full_dt, full_toks, full_stats = run_timed(False)
    px_dt, px_toks, px_stats = run_timed(True)
    total = requests * new_tok
    matches = sum(a == b for a, b in zip(px_toks, full_toks))
    hbm_gb = _device_memory_gb(device)
    weights_gb = quantized_bytes(params) / 2**30
    return {
        "ok": (all(len(t) == new_tok for t in px_toks)
               and px_stats["prefix_hits"] >= requests),
        "match_rows": f"{matches}/{requests}",
        "preset": preset,
        "requests": requests,
        "slots": slots,
        "capacity_note": (f"{slots} streams x {max_seq} addressable "
                          "per slot; pool sized to live tokens"),
        "prefix_len": prefix_len,
        "suffix_len": suffix_len,
        "new_tokens": new_tok,
        "page_size": page_size,
        "total_pages": total_pages,
        "dense_cache_gb": round(dense_gb, 2),
        "paged_pool_gb": round(pool_gb, 2),
        "device_memory_gb": hbm_gb,
        "dense_fits_with_weights": ((dense_gb + weights_gb) < hbm_gb
                                    if hbm_gb else None),
        "full_tok_s": round(total / full_dt, 1),
        "prefix_tok_s": round(total / px_dt, 1),
        "speedup": round(full_dt / px_dt, 2),
        "prefix_hits": px_stats["prefix_hits"],
        "deferred_admissions": (full_stats["deferred_admissions"],
                                px_stats["deferred_admissions"]),
    }


def bench_paged_admission(
    preset: str = "llama3-8b",
    streams: int = 32,
    prompt_len: int = 128,
    promised_new: int = 1024,
    actual_new: int = 16,
    max_seq: int = 2048,
    page_size: int = 64,
    chunk: int = 8,
    total_pages: int = 104,
    device: str | torch.device = "cuda",
) -> dict:
    """Grow against full reservation: ``streams`` requests each PROMISE
    ``promised_new`` tokens but hit eos after ~``actual_new`` (clients
    over-ask; generations stop early). Full reservation pins
    ``ceil((prompt + promised) / page)`` pages a request and serializes
    admissions on the pool; grow admits on prefill pages alone and claims
    only what decode reaches. Same pool, same requests, both policies;
    the admission ratio is the point and throughput rides along."""
    from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                   make_generate_fn)
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine, _ceil_div
    from tpu_docker_api_torch.infer.quantize import synth_quantized_params
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = synth_quantized_params(cfg, device=device)
    prompts = [_tokens(90 + i, prompt_len, cfg.vocab_size)
               for i in range(streams)]
    # a request's eos is the token greedy emits at step actual_new - 1,
    # so every stream stops within actual_new tokens of its promise
    fn = make_generate_fn(cfg, GenerateConfig(
        max_new_tokens=actual_new, temperature=0.0, max_seq=max_seq))
    out = fn(params, torch.tensor(prompts, device=device))
    eos_ids = out["tokens"][:, actual_new - 1].tolist()
    del fn, out
    _free(device)

    buckets = tuple(b for b in (128, 256, 512, 1024)
                    if b % page_size == 0 and b <= max_seq)
    full_need = _ceil_div(prompt_len + promised_new - 1, page_size)
    results = {}
    for mode in ("full", "grow"):
        eng = PagedSlotEngine(cfg, params, page_size=page_size,
                              total_pages=total_pages, slots=streams,
                              max_seq=max_seq, chunk=chunk,
                              buckets=buckets, reservation=mode)
        eng.warmup(buckets=buckets[:1],
                   rows=(1, min(streams, 8), min(streams, 32)))
        t0 = time.perf_counter()
        handles = [eng.submit(p, promised_new, eos_id=e)
                   for p, e in zip(prompts, eos_ids)]
        eng.step()
        admitted = sum(s is not None for s in eng._table.values())
        while not all(h.done() for h in handles):
            eng.step()
        _sync(device)
        dt = time.perf_counter() - t0
        toks = [h.result(0)["tokens"] for h in handles]
        results[mode] = {
            "admitted_first_wave": admitted,
            "deferred_admissions": eng.stats["deferred_admissions"],
            "preemptions": eng.stats.get("preemptions", 0),
            "grown_pages": eng.stats.get("grown_pages", 0),
            "wall_s": round(dt, 2),
            "tokens": toks,
        }
        eng.close()
        del eng
        _free(device)
    match = sum(a == b for a, b in zip(results["grow"].pop("tokens"),
                                       results["full"].pop("tokens")))
    g, f = results["grow"], results["full"]
    return {
        "ok": (g["admitted_first_wave"]
               >= 2 * max(1, f["admitted_first_wave"])
               and match == streams),
        "preset": preset,
        "streams": streams,
        "promised_new": promised_new,
        "actual_new_max": actual_new,
        "total_pages": total_pages,
        "full_need_per_request": full_need,
        "match_rows": f"{match}/{streams}",
        "grow": g,
        "full": f,
        "admission_ratio": round(
            g["admitted_first_wave"]
            / max(1, f["admitted_first_wave"]), 2),
        "speedup": round(f["wall_s"] / g["wall_s"], 2),
    }
