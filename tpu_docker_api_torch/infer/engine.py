"""Inference engine of the decoder families (Llama, MoE): KV-cached
prefill + decode (counterpart of ``tpu_docker_api/infer/engine.py``),
through ``models.cached_forward_fn``.

The serve path's ``--slots 0`` generator, and the exactness reference of
the slot engine (infer/slots.py): one prompt batch, one prefill, then one
decode step per token in a Python loop over a fixed-capacity cache. Every
prefill here is a whole-prompt one, through the flash kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpu_docker_api_torch.infer.sampling import make_sampler
from tpu_docker_api_torch.models import cached_forward_fn
from tpu_docker_api_torch.models.llama import LlamaConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (n_layers, batch, max_seq, n_kv_heads, head_dim)
    v: torch.Tensor


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int | None = None,
                  dtype: Any = torch.bfloat16,
                  device: torch.device | str | None = None,
                  kv_heads: int | None = None) -> KVCache:
    """Zero-filled cache (of ``kv_heads``, a tp rank's part, if given)."""
    max_seq = max_seq or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_seq, kv_heads or cfg.n_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int | None = None
    pad_id: int = 0
    max_seq: int | None = None  # cache capacity; default model max_seq_len
    cache_dtype: Any = torch.bfloat16


def make_generate_fn(cfg: LlamaConfig, gen: GenerateConfig) -> Callable:
    """Build ``(params, prompt (b, s) int tensor, generator=None) → dict``.

    Returns {"tokens": (b, max_new_tokens), "lengths": (b,)} where lengths
    counts emitted tokens up to and including eos (rows that never hit eos
    have length == max_new_tokens). Positions after eos hold pad_id.
    Prompts are dense (b, s); runs on the prompt's device."""
    if gen.max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {gen.max_new_tokens}")
    sampler = make_sampler(gen.temperature, gen.top_k, gen.top_p)
    fwd = cached_forward_fn(cfg)

    def _sample_step(logits_last, generator, done):
        tok = sampler(logits_last, generator)
        tok = torch.where(done, gen.pad_id, tok)
        if gen.eos_id is not None:
            done = done | (tok == gen.eos_id)
        return tok, done

    @torch.no_grad()
    def generate(params: dict, prompt: torch.Tensor,
                 generator: torch.Generator | None = None) -> dict:
        b, prompt_len = prompt.shape
        dev = prompt.device
        max_seq = gen.max_seq or cfg.max_seq_len
        # the last written cache slot is prompt_len + max_new_tokens - 2
        if prompt_len + gen.max_new_tokens - 1 > max_seq:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({gen.max_new_tokens}) exceeds cache capacity {max_seq}")
        # right-size the cache to this generation (decode reads the whole
        # buffer every step), rounded to 128 like the JAX engine
        need = prompt_len + gen.max_new_tokens - 1
        max_seq = min(max_seq, (need + 127) // 128 * 128)
        cache = init_kv_cache(cfg, b, max_seq, dtype=gen.cache_dtype,
                              device=dev)
        k_cache, v_cache = cache.k, cache.v
        logits = _prefill(fwd, params, prompt, cfg, k_cache, v_cache)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        tok, done = _sample_step(logits[:, -1], generator, done)
        toks = [tok]
        for pos in range(prompt_len, prompt_len + gen.max_new_tokens - 1):
            logits, k_cache, v_cache = fwd(params, tok[:, None], cfg,
                                           k_cache, v_cache, pos)
            tok, done = _sample_step(logits[:, -1], generator, done)
            toks.append(tok)
        tokens = torch.stack(toks, dim=1)
        if gen.eos_id is not None:
            is_eos = tokens == gen.eos_id
            first_eos = torch.argmax(is_eos.int(), dim=1)
            lengths = torch.where(is_eos.any(dim=1), first_eos + 1,
                                  tokens.shape[1])
        else:
            lengths = torch.full((b,), tokens.shape[1], device=dev)
        return {"tokens": tokens, "lengths": lengths}

    return generate


def _prefill(fwd, params: dict, prompt: torch.Tensor, cfg: LlamaConfig,
             k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The prompt's prefill into a cache exactly its length — the
    whole-prompt path that runs the flash kernel (models/llama.py) — whose
    k/v then fill the first positions of ``k``/``v`` (in place). Returns
    the last position's logits (b, 1, vocab)."""
    s = prompt.shape[1]
    if k.shape[2] == s:
        kc, vc = k, v
    else:
        shape = k.shape[:2] + (s,) + k.shape[3:]
        kc = torch.zeros(shape, dtype=k.dtype, device=k.device)
        vc = torch.zeros(shape, dtype=v.dtype, device=v.device)
    logits, kc, vc = fwd(params, prompt, cfg, kc, vc, 0, last_only=True)
    if kc is not k:
        k[:, :, :s] = kc
        v[:, :, :s] = vc
    return logits


@torch.no_grad()
def prefill_and_first_token(params: dict, prompt: torch.Tensor,
                            cfg: LlamaConfig,
                            cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Standalone prefill for callers that drive decode themselves:
    greedy first token + filled cache (the whole-prompt flash path)."""
    logits = _prefill(cached_forward_fn(cfg), params, prompt, cfg, cache.k,
                      cache.v)
    return torch.argmax(logits[:, -1], dim=-1), cache


@torch.no_grad()
def decode_one(params: dict, tok: torch.Tensor, pos: int, cache: KVCache,
               cfg: LlamaConfig) -> tuple[torch.Tensor, KVCache]:
    """Single decode step: last-position logits + the updated cache."""
    logits, k, v = cached_forward_fn(cfg)(params, tok[:, None], cfg,
                                          cache.k, cache.v, pos)
    return logits[:, -1], KVCache(k=k, v=v)
