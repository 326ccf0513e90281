"""Llama-family decoder (counterpart of ``tpu_docker_api/models/llama.py``).

Parameters keep the JAX package's pytree: a nested dict whose per-layer
leaves are stacked along a leading ``n_layers`` dim, named as there, so
weights cross over 1:1 (models/convert.py). The forward is plain
functions on tensors with a Python loop over layers in place of
``lax.scan``; norms, softmax, the cached-path rope rotation and the
logits run in f32.

The KV cache is updated IN PLACE: ``llama_forward_cached`` writes each
layer's new k/v into the buffers it is given and returns the same
tensors, where the JAX version returns updated copies. A decode step
then moves only the new slots and the attended prefix, and never a
fresh cache.

A whole-prompt prefill into a cache exactly as long as the prompt
(``start_pos`` the Python int 0, ``seq == cache length``, no
``kv_limit``) is causal self-attention over the prompt's own k/v; it
runs through the flash kernel. Every other cached call keeps
``dense_attention`` with its position mask, as the JAX path does: decode,
a suffix after a cached prefix and a prefill segment, which attend at an
offset. ``llama_forward_paged`` is the decode step over a page pool
(ops/paged.py): its write scatters into each slot's page and its read
gathers the slot's pages into a contiguous view.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpu_docker_api_torch.models.common import remat_call, trunc_normal_init
from tpu_docker_api_torch.ops.attention import (dense_attention,
                                                multihead_attention)
from tpu_docker_api_torch.ops.norms import rms_norm
from tpu_docker_api_torch.ops.paged import (PagedRef, gather_pages,
                                            paged_write)
from tpu_docker_api_torch.ops.quant import (LoraLinear, QuantizedLinear,
                                            dequantize_weight, linear)
from tpu_docker_api_torch.ops.rope import (RopeScaling, apply_rope,
                                           rope_frequencies)
from tpu_docker_api_torch.ops.xent import chunked_cross_entropy


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: Any = None  # ops.rope.RopeScaling or None
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # checkpoint each block under a policy that keeps only the flash
    # forward's (out, lse) (llama_hidden, models.common.remat_policy)
    remat: bool = True
    attention_impl: str = "auto"  # ops.attention impls: auto/dense/flash
    # >0: the training loss runs ops.xent.chunked_cross_entropy with this
    # row-chunk size instead of making (batch, seq, vocab) logits
    loss_chunk_rows: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self, seq_len: int | None = None) -> float:
        """Training FLOPs/token (fwd+bwd ≈ 3× forward matmul FLOPs)."""
        seq = seq_len or self.max_seq_len
        d, h = self.dim, self.head_dim
        per_layer = (
            2 * d * (self.n_heads * h)          # wq
            + 2 * 2 * d * (self.n_kv_heads * h)  # wk, wv
            + 2 * (self.n_heads * h) * d        # wo
            + 3 * 2 * d * self.ffn_dim          # gate, up, down
        )
        embed = 2 * d * self.vocab_size         # lm_head matmul
        fwd = self.n_layers * per_layer + embed
        # attention score+value matmuls, causal ⇒ half the k positions
        attn = self.n_layers * 2 * 2 * seq * (self.n_heads * h) / 2
        return 3.0 * (fwd + attn)  # fwd + 2x bwd


def llama_presets() -> dict[str, LlamaConfig]:
    return {
        "llama3-8b": LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, max_seq_len=8192,
        ),
        "llama3-1b": LlamaConfig(
            vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
            n_kv_heads=8, ffn_dim=8192, max_seq_len=8192,
        ),
        "llama31-8b": LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, max_seq_len=131072,
            rope_scaling=RopeScaling(
                factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                original_max_position_embeddings=8192),
        ),
        "bench-350m": LlamaConfig(
            vocab_size=32000, dim=1024, n_layers=24, n_heads=8,
            n_kv_heads=8, ffn_dim=2816, max_seq_len=2048,
            rope_theta=10000.0,
        ),
        # CPU-fast config for tests
        "tiny": LlamaConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=128, rope_theta=10000.0, remat=False,
        ),
    }


def llama_param_specs(cfg: LlamaConfig) -> dict:
    """The param tree's leaves as ``(shape, fan_in)``, in the order
    ``llama_init`` draws them; ``fan_in`` None is a norm scale of ones."""
    d, hd = cfg.dim, cfg.head_dim
    L = cfg.n_layers
    return {
        "embed": {"tokens": ((cfg.vocab_size, d), d)},
        "layers": {
            "attn_norm": ((L, d), None),
            "mlp_norm": ((L, d), None),
            "attn": {
                "wq": ((L, d, cfg.n_heads * hd), d),
                "wk": ((L, d, cfg.n_kv_heads * hd), d),
                "wv": ((L, d, cfg.n_kv_heads * hd), d),
                "wo": ((L, cfg.n_heads * hd, d), cfg.n_heads * hd),
            },
            "mlp": {
                "w_gate": ((L, d, cfg.ffn_dim), d),
                "w_up": ((L, d, cfg.ffn_dim), d),
                "w_down": ((L, cfg.ffn_dim, d), cfg.ffn_dim),
            },
        },
        "final_norm": ((d,), None),
        "lm_head": ((d, cfg.vocab_size), d),
    }


def llama_init(cfg: LlamaConfig, generator: torch.Generator) -> dict:
    """Random parameters (truncated-normal fan-in scaling) on the
    generator's device, in the JAX package's pytree layout."""
    def init(spec):
        if isinstance(spec, dict):
            return {k: init(v) for k, v in spec.items()}
        shape, fan_in = spec
        if fan_in is None:
            return torch.ones(shape, dtype=cfg.dtype, device=generator.device)
        return trunc_normal_init(generator, shape, fan_in, cfg.dtype)

    return init(llama_param_specs(cfg))


def unstack_layers(layers: dict, n_layers: int) -> list[dict]:
    """Every layer's slice of the stacked per-layer tree (views), by one
    ``unbind`` per leaf: under autograd its backward stacks the layers'
    gradients in one pass, where indexing layer by layer would make a
    full-size gradient of the stacked leaf for every layer. A
    ``QuantizedLinear`` leaf unbinds its int8 weight and its scales
    together, a ``LoraLinear`` its base, A and B."""
    out = [{} for _ in range(n_layers)]
    for name, leaf in layers.items():
        parts = (unstack_layers(leaf, n_layers) if isinstance(leaf, dict)
                 else leaf.unbind(0))
        for tree, part in zip(out, parts):
            tree[name] = part
    return out


def _write_cache(kc: torch.Tensor, new: torch.Tensor,
                 start_pos, positions: torch.Tensor, per_row: bool) -> None:
    """Write ``new`` (b, s, kv, hd) into one layer's cache ``kc``
    (b, max_seq, kv, hd) at ``positions``, in place.

    Per-row writes past capacity are no-ops (the JAX scatter's
    ``mode="drop"``), never clamped into bounds. Without a host sync
    (a boolean mask would need one): each dropped entry is redirected to
    the row's last slot carrying the value that slot ends up with — the
    new entry written there when the row reaches it, else the slot's
    current value — so duplicate indices all agree and the scatter's
    order does not matter. A row parked wholly past capacity rewrites
    its last slot unchanged."""
    b, s = positions.shape
    cap = kc.shape[1]
    new = new.to(kc.dtype)
    if not per_row:
        kc[:, start_pos:start_pos + s] = new
        return
    last = cap - 1
    brow = torch.arange(b, device=kc.device)
    col = (last - start_pos).clamp(0, s - 1)      # column writing ``last``
    fill = torch.where((start_pos <= last)[:, None, None], new[brow, col],
                       kc[brow, last])
    keep = positions < cap
    idx = torch.where(keep, positions, last)
    kc[brow[:, None].expand(b, s), idx] = torch.where(
        keep[..., None, None], new, fill[:, None])


def _attention(x, layer, cfg: LlamaConfig, rope_cos, rope_sin,
               cache=None, start_pos=None, kv_limit=None):
    """Self-attention. With ``cache=(k_all, v_all, layer_idx)`` — the
    full (n_layers, batch, max_seq, n_kv_heads, head_dim) buffers and
    this layer's index — writes the new k/v into the layer's slots at
    ``start_pos`` (an int or 0-d tensor for the whole batch, or a
    (batch,) tensor per row) and attends against the layer's buffer.
    Returns (out, (k_all, v_all)) instead of out."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    if "w_qkv" in layer["attn"]:
        # serving-fused projections (infer/quantize.py)
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        qkv = linear(x, layer["attn"]["w_qkv"])
        q = qkv[..., :nq].reshape(b, s, cfg.n_heads, hd)
        k = qkv[..., nq:nq + nkv].reshape(b, s, cfg.n_kv_heads, hd)
        v = qkv[..., nq + nkv:].reshape(b, s, cfg.n_kv_heads, hd)
    else:
        q = linear(x, layer["attn"]["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = linear(x, layer["attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = linear(x, layer["attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if isinstance(cache, PagedRef):
        # paged decode (ops/paged.py; infer/paged.py drives it): s == 1,
        # per-row positions; the write goes into the slot's current
        # page, the read gathers its pages into a view element-identical
        # to the dense cache prefix
        positions = start_pos[:, None].long() + torch.arange(
            s, device=x.device)[None, :]
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)
        k_pool = paged_write(cache.k_pool, cache.layer_idx, cache.table,
                             start_pos, k[:, 0])
        v_pool = paged_write(cache.v_pool, cache.layer_idx, cache.table,
                             start_pos, v[:, 0])
        k_cache = gather_pages(k_pool, cache.layer_idx, cache.table)
        v_cache = gather_pages(v_pool, cache.layer_idx, cache.table)
        out = dense_attention(q, k_cache, v_cache, causal=True,
                              q_offset=start_pos)
        return linear(out.reshape(b, s, cfg.n_heads * hd),
                      layer["attn"]["wo"]), (k_pool, v_pool)
    if cache is not None:
        k_all, v_all, layer_idx = cache
        per_row = torch.is_tensor(start_pos) and start_pos.ndim == 1
        whole_prompt = (type(start_pos) is int and start_pos == 0
                        and s == k_all.shape[2] and kv_limit is None)
        ar = torch.arange(s, device=x.device)
        if per_row:
            positions = start_pos[:, None].long() + ar[None, :]
        else:
            if torch.is_tensor(start_pos):
                start_pos = int(start_pos)
            positions = (start_pos + ar)[None, :].expand(b, s)
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)
        k_cache, v_cache = k_all[layer_idx], v_all[layer_idx]
        _write_cache(k_cache, k, start_pos, positions, per_row)
        _write_cache(v_cache, v, start_pos, positions, per_row)
        if whole_prompt:
            # causal self-attention over the prompt's own k/v: the
            # flash kernel's function exactly (positions are 0..s-1)
            out = multihead_attention(q, k_cache.to(q.dtype),
                                      v_cache.to(q.dtype), causal=True,
                                      impl="flash")
        else:
            if kv_limit is not None and kv_limit < k_cache.shape[1]:
                # static length bucket: read only the prefix any query
                # of this call can reach (a view; writes above went to
                # the full buffer)
                k_cache = k_cache[:, :kv_limit]
                v_cache = v_cache[:, :kv_limit]
            out = dense_attention(q, k_cache, v_cache, causal=True,
                                  q_offset=start_pos)
        return linear(out.reshape(b, s, cfg.n_heads * hd),
                      layer["attn"]["wo"]), (k_all, v_all)
    q = apply_rope(q, rope_cos, rope_sin)
    k = apply_rope(k, rope_cos, rope_sin)
    out = multihead_attention(q, k, v, causal=True, impl=cfg.attention_impl)
    return linear(out.reshape(b, s, cfg.n_heads * hd), layer["attn"]["wo"])


def _mlp(x, layer):
    if "w_gu" in layer["mlp"]:
        gu = linear(x, layer["mlp"]["w_gu"])  # serving-fused gate|up
        gate, up = gu.chunk(2, dim=-1)
        return linear(F.silu(gate) * up, layer["mlp"]["w_down"])
    gate = F.silu(linear(x, layer["mlp"]["w_gate"]))
    up = linear(x, layer["mlp"]["w_up"])
    return linear(gate * up, layer["mlp"]["w_down"])


def _block(x, layer, cfg: LlamaConfig, rope_cos, rope_sin,
           cache=None, start_pos=None, kv_limit=None):
    """One transformer block: the residual/norm wiring of both the
    uncached forward and the KV-cached path (returns (x, cache))."""
    attn_out = _attention(
        rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
        rope_cos, rope_sin, cache=cache, start_pos=start_pos,
        kv_limit=kv_limit,
    )
    new_cache = None
    if cache is not None:
        attn_out, new_cache = attn_out
    x = x + attn_out
    x = x + _mlp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), layer)
    return x if cache is None else (x, new_cache)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather (the JAX function's single-device branch)."""
    return F.embedding(tokens, table)


def llama_hidden(params: dict, tokens: torch.Tensor,
                 cfg: LlamaConfig) -> torch.Tensor:
    """The trunk: embed → blocks → final hidden (batch, seq, dim),
    before the final norm. With ``cfg.remat`` and autograd on, each block
    is checkpointed under ``models.common.remat_policy``."""
    seq = tokens.shape[1]
    x = embed_lookup(params["embed"]["tokens"], tokens)
    rope_cos, rope_sin = rope_frequencies(cfg.head_dim, seq, cfg.rope_theta,
                                          getattr(cfg, "rope_scaling", None),
                                          device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in unstack_layers(params["layers"], cfg.n_layers):
        if remat:
            x = remat_call(_block, x, layer, cfg, rope_cos, rope_sin)
        else:
            x = _block(x, layer, cfg, rope_cos, rope_sin)
    return x


def llama_forward(params: dict, tokens: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """Next-token logits (batch, seq, vocab) in f32."""
    return lm_head(params, llama_hidden(params, tokens, cfg), cfg)


def llama_forward_cached(
    params: dict,
    tokens: torch.Tensor,     # (batch, seq) — the NEW tokens only
    cfg: LlamaConfig,
    k_cache: torch.Tensor,    # (n_layers, batch, max_seq, n_kv_heads, head_dim)
    v_cache: torch.Tensor,
    start_pos,                # absolute position of tokens[:, 0]: int,
    #                           0-d tensor, or (batch,) tensor per row
    last_only=False,          # True: final position; int/0-d tensor: that
    #                           position; (batch,) tensor: one per row
    kv_limit: int | None = None,  # attend cache[:kv_limit] only
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KV-cached forward: logits for the new tokens + the caches (updated
    in place and returned)."""
    def block_fn(x, layer, cache, rope_cos, rope_sin):
        return _block(x, layer, cfg, rope_cos, rope_sin, cache=cache,
                      start_pos=start_pos, kv_limit=kv_limit)

    return decoder_forward_cached(params, tokens, cfg, k_cache, v_cache,
                                  last_only, block_fn)


def llama_forward_paged(
    params: dict,
    tokens: torch.Tensor,     # (S, 1) — one decode token per slot
    cfg: LlamaConfig,
    k_pool: torch.Tensor,     # (n_layers, P, page, n_kv_heads, head_dim)
    v_pool: torch.Tensor,
    table: torch.Tensor,      # (S, mp) long page ids; 0 = trash
    pos: torch.Tensor,        # (S,) per-slot positions
    max_pos: int,             # position capacity (sizes the rope tables)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged-KV decode step: logits (S, 1, vocab) + the pools (updated in
    place and returned). Block math is ``_block`` through the shared
    skeleton; only the cache write (page scatter) and read (page gather,
    ops/paged.py) differ from ``llama_forward_cached``."""
    def block_fn(x, layer, cache, rope_cos, rope_sin):
        kc, vc, layer_idx = cache
        ref = PagedRef(k_pool=kc, v_pool=vc, layer_idx=layer_idx,
                       table=table)
        return _block(x, layer, cfg, rope_cos, rope_sin, cache=ref,
                      start_pos=pos)

    return decoder_forward_cached(params, tokens, cfg, k_pool, v_pool,
                                  False, block_fn, max_pos=max_pos)


def decoder_forward_cached(params, tokens, cfg, k_cache, v_cache,
                           last_only, block_fn, max_pos=None):
    """The shared KV-cached decoder skeleton: embed → cache-threading
    layer loop → lm_head. ``block_fn(x, layer, (kc, vc, layer_idx),
    rope_cos, rope_sin) -> (x, (kc, vc))`` supplies the block body.
    ``max_pos`` sizes the rope tables (default: the cache length).
    ``cfg`` may be another family's (models/moe.py): one without a
    ``rope_scaling`` field runs unscaled rope."""
    max_seq = max_pos or k_cache.shape[2]
    x = embed_lookup(params["embed"]["tokens"], tokens)
    rope_cos, rope_sin = rope_frequencies(cfg.head_dim, max_seq,
                                          cfg.rope_theta,
                                          getattr(cfg, "rope_scaling", None),
                                          device=x.device)
    kc, vc = k_cache, v_cache
    layers = unstack_layers(params["layers"], cfg.n_layers)
    for i, layer in enumerate(layers):
        x, (kc, vc) = block_fn(x, layer, (kc, vc, i), rope_cos, rope_sin)
    if last_only is True:
        x = x[:, -1:]
    elif last_only is not False and last_only is not None:
        # logits for position ``last_only`` only — a right-padded
        # prompt's real last token (infer/slots.py); a (batch,) vector
        # gives every row its own position
        if torch.is_tensor(last_only) and last_only.ndim == 1:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_only.to(x.device)][:, None]
        else:
            idx = torch.as_tensor(last_only, device=x.device).reshape(1)
            x = x.index_select(1, idx)
    return lm_head(params, x, cfg), kc, vc


def lm_head(params: dict, h: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Final norm + logits projection: operands in the storage dtype,
    f32 result."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return linear(h.to(cfg.dtype), params["lm_head"],
                  out_dtype=torch.float32)


def cross_entropy(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, in logsumexp form: reduces straight
    off the logits instead of making the (batch, seq, vocab) log-softmax."""
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - target_logit).mean()


def llama_loss(params: dict, tokens: torch.Tensor,
               cfg: LlamaConfig) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]. With
    ``cfg.loss_chunk_rows`` set, the logits projection and the loss fuse
    into ``ops.xent.chunked_cross_entropy``, which never makes the
    (batch, seq, vocab) logits. An int8 head (QLoRA's frozen base) is
    dequantized to ``cfg.dtype`` once a call for it, as in the JAX
    function."""
    if cfg.loss_chunk_rows:
        x = llama_hidden(params, tokens[:, :-1], cfg)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps).to(cfg.dtype)
        head = params["lm_head"]
        if isinstance(head, QuantizedLinear):
            head = dequantize_weight(head, cfg.dtype)
        return chunked_cross_entropy(h, head, tokens[:, 1:],
                                     cfg.loss_chunk_rows)
    logits = llama_forward(params, tokens[:, :-1], cfg)
    return cross_entropy(logits, tokens[:, 1:])


def param_count(params: dict) -> int:
    """Elements in the tree; an int8 leaf counts its weights and its
    scales, a LoRA leaf its base, A and B, as the JAX count over the
    pytree's leaves does."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, LoraLinear):
            return count(tree.base) + tree.a.numel() + tree.b.numel()
        if isinstance(tree, QuantizedLinear):
            return tree.w_int8.numel() + tree.scale.numel()
        return tree.numel()

    return count(params)
