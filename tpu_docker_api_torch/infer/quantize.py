"""Serving-time weight transforms (counterpart of
``tpu_docker_api/infer/quantize.py``): int8 quantization of a Llama tree,
projection fusion, the serving footprint, int8 weights made straight
from a formula, and the int8-serving benchmark (``bench_int8_serving``).

``quantize_llama_params`` rewrites every projection (attention q/k/v/o,
MLP gate/up/down, stacked per layer and quantized along their in axis
with per-(layer, out-channel) scales, and the lm_head) into
``ops.quant.QuantizedLinear`` leaves; the embedding and the norm scales
stay in the float dtype. The model needs no int8 variant: every
projection goes through ``ops.quant.linear``, which dispatches on the
leaf type.
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.ops.quant import (LoraLinear, QuantizedLinear,
                                            quantize_weight)


def quantize_llama_params(params: dict) -> dict:
    """New param tree with projection weights as QuantizedLinear leaves."""
    layers = params["layers"]
    return {
        "embed": params["embed"],
        "layers": {
            "attn_norm": layers["attn_norm"],
            "mlp_norm": layers["mlp_norm"],
            "attn": {k: quantize_weight(w) for k, w in layers["attn"].items()},
            "mlp": {k: quantize_weight(w) for k, w in layers["mlp"].items()},
        },
        "final_norm": params["final_norm"],
        "lm_head": quantize_weight(params["lm_head"]),
    }


def _cat_out(leaves: list):
    """Concatenate projections along their OUT axis; int8 leaves
    concatenate their weights and their per-out-channel scales."""
    if isinstance(leaves[0], QuantizedLinear):
        return QuantizedLinear(torch.cat([q.w_int8 for q in leaves], dim=-1),
                               torch.cat([q.scale for q in leaves], dim=-1))
    return torch.cat(leaves, dim=-1)


def fuse_llama_projections(params: dict) -> dict:
    """Concatenate wq|wk|wv into one ``w_qkv`` and w_gate|w_up into one
    ``w_gu`` along their OUT axis (models/llama.py dispatches on the
    fused leaf names). Two matmuls replace five, and every output column
    is the same dot product as before. On an int8 tree the result is
    bit-identical to the unfused one: the scales concatenate, the shared
    input quantizes to the same per-row scale once, and each column's
    int32 sum is unchanged. Returns a new tree; the unfused leaves are
    not kept."""
    layers = params["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    return {
        "embed": params["embed"],
        "layers": {
            "attn_norm": layers["attn_norm"],
            "mlp_norm": layers["mlp_norm"],
            "attn": {
                "w_qkv": _cat_out([attn["wq"], attn["wk"], attn["wv"]]),
                "wo": attn["wo"],
            },
            "mlp": {
                "w_gu": _cat_out([mlp["w_gate"], mlp["w_up"]]),
                "w_down": mlp["w_down"],
            },
        },
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
    }


def quantized_bytes(params) -> int:
    """Serving-weight footprint in bytes (int8 + f32 scales + float rest;
    a LoRA leaf's base plus its A and B at their own dtypes)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, LoraLinear):
        return quantized_bytes(params.base) + sum(
            t.numel() * t.element_size() for t in (params.a, params.b))
    if isinstance(params, QuantizedLinear):
        return params.w_int8.numel() + params.scale.numel() * 4
    return params.numel() * params.element_size()


def synth_quantized_params(cfg, seed: int = 0,
                           device: str | torch.device = "cuda") -> dict:
    """An int8-serving param tree made on ``device`` straight from an
    integer formula, without a float tree first: the JAX function's iota
    arithmetic, so both packages make the same weights bit for bit.
    Scales give the dequantized weights a std of ~fan_in^-0.5 (uniform
    [-127, 127] has std ~73.3), so activations stay finite through any
    depth. Every layer of a stacked leaf holds the same weights, as in
    the JAX function."""
    def pattern(rows: int, cols: int, salt: int) -> torch.Tensor:
        i = torch.arange(cols, dtype=torch.int32, device=device)[None, :]
        j = torch.arange(rows, dtype=torch.int32, device=device)[:, None]
        return ((i * 131 + j * 31 + (salt + 9 * seed) * 2017) % 255) - 127

    def qweight(shape, fan_in, salt):
        w8 = pattern(shape[-2], shape[-1], salt).to(torch.int8)
        w8 = w8.expand(*shape)
        scale = torch.full(shape[:-2] + (shape[-1],), (fan_in ** -0.5) / 73.3,
                           dtype=torch.float32, device=device)
        return QuantizedLinear(w8, scale)

    def fweight(shape, fan_in, salt):
        w = pattern(shape[0], shape[1], salt)
        return (w.float() * ((fan_in ** -0.5) / 73.3)).to(cfg.dtype)

    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers
    return {
        "embed": {"tokens": fweight((cfg.vocab_size, d), d, 1)},
        "layers": {
            "attn_norm": torch.ones((L, d), dtype=cfg.dtype, device=device),
            "mlp_norm": torch.ones((L, d), dtype=cfg.dtype, device=device),
            "attn": {
                "wq": qweight((L, d, cfg.n_heads * hd), d, 2),
                "wk": qweight((L, d, cfg.n_kv_heads * hd), d, 3),
                "wv": qweight((L, d, cfg.n_kv_heads * hd), d, 4),
                "wo": qweight((L, cfg.n_heads * hd, d), cfg.n_heads * hd, 5),
            },
            "mlp": {
                "w_gate": qweight((L, d, cfg.ffn_dim), d, 6),
                "w_up": qweight((L, d, cfg.ffn_dim), d, 7),
                "w_down": qweight((L, cfg.ffn_dim, d), cfg.ffn_dim, 8),
            },
        },
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
        "lm_head": qweight((d, cfg.vocab_size), d, 9),
    }


def bench_int8_serving(preset: str = "llama3-8b", batch: int = 64,
                       new_tok: int = 64, prompt_len: int = 128,
                       reps: int = 2, max_seq: int = 512,
                       fuse: bool = False,
                       device: str | torch.device = "cuda") -> dict:
    """int8-serving throughput harness (the JAX function's keys and
    definitions). Makes the preset's int8 weights on ``device``
    (``synth_quantized_params``), runs one untimed and ``reps`` timed
    greedy generations, and reports:

    - ``new_tok_s_incl_prefill``: generated tokens / wall time of a whole
      generation, prefill included, as the name says;
    - ``ms_per_new_tok_incl_prefill``: its inverse per token. NOT a pure
      decode-step latency: the (batch, prompt_len) prefill is a
      comparable share of the wall time.

    The wall time ends in a device synchronise."""
    import time

    from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                   make_generate_fn)
    from tpu_docker_api_torch.models.llama import llama_presets

    device = torch.device(device)
    cfg = llama_presets()[preset]
    params = synth_quantized_params(cfg, device=device)
    if fuse:
        params = fuse_llama_projections(params)
    fn = make_generate_fn(cfg, GenerateConfig(
        max_new_tokens=new_tok, temperature=0.0, max_seq=max_seq))
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g).to(device)

    def run():
        t0 = time.perf_counter()
        out = fn(params, prompt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    out, _ = run()  # first-call costs, untimed
    times = []
    for _ in range(reps):
        out, dt = run()
        times.append(dt)
    dt = min(times)
    return {
        "ok": bool((out["tokens"] >= 0).all())
        and tuple(out["tokens"].shape) == (batch, new_tok),
        "weights_gb": round(quantized_bytes(params) / 2**30, 2),
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tok,
        "new_tok_s_incl_prefill": round(batch * new_tok / dt, 1),
        "ms_per_new_tok_incl_prefill": round(dt / new_tok * 1e3, 2),
        "fused_projections": fuse,
    }
