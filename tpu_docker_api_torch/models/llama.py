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

from tpu_docker_api_torch.models.common import (init_tree, remat_call,
                                                trunc_normal_init)
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
from tpu_docker_api_torch.parallel import comm
from tpu_docker_api_torch.parallel.sharding import (LLAMA_RULES, P,
                                                    spec_for, unshard)


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


def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               place=None) -> dict:
    """Random parameters (truncated-normal fan-in scaling) on the
    generator's device, in the JAX package's pytree layout. ``place(path,
    leaf)``, if given, replaces each leaf as soon as it is drawn (the
    sharded init keeps a rank's slice: models/common.py ``init_tree``)."""
    def draw(spec):
        shape, fan_in = spec
        if fan_in is None:
            return torch.ones(shape, dtype=cfg.dtype, device=generator.device)
        return trunc_normal_init(generator, shape, fan_in, cfg.dtype)

    return init_tree(llama_param_specs(cfg), draw, place)


def layer_specs(layer: dict, rules, prefix: str = "layers") -> dict:
    """The spec of every leaf of one layer's slice of the stacked tree
    (the stacked leaf's rule without its leading layer entry). A
    ``LoraLinear`` leaf gets (base, A, B) specs: A keeps the base's input
    axis, B its output axis (train/lora.py ``lora_specs``)."""
    out = {}
    for k, v in layer.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out[k] = layer_specs(v, rules, path)
            continue
        spec = tuple(spec_for(path, rules))[1:]
        if isinstance(v, LoraLinear):
            nd = v.a.ndim
            spec = (None,) * (nd - len(spec)) + spec
            out[k] = (spec, P(*spec[:-1], None), P(*spec[:-2], None, spec[-1]))
        else:
            out[k] = spec
    return out


def gather_layer(layer: dict, specs: dict, mesh) -> dict:
    """One layer's local shards gathered whole over every axis but tp and
    ep (the ZeRO-3 all-gather of fsdp; parallel/sharding.py
    ``unshard``)."""
    out = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            out[k] = gather_layer(v, specs[k], mesh)
        elif isinstance(v, LoraLinear):
            sb, sa, sbb = specs[k]
            out[k] = LoraLinear(unshard(v.base, sb, mesh),
                                unshard(v.a, sa, mesh),
                                unshard(v.b, sbb, mesh), v.scale)
        elif isinstance(v, QuantizedLinear):
            raise ValueError("int8 weights do not run on a mesh")
        else:
            out[k] = unshard(v, specs[k], mesh)
    return out


def _tp(mesh):
    return None if mesh is None else mesh.group("tp")


def _local_heads(cfg, mesh) -> tuple[int, int]:
    """(q heads, kv heads) this rank holds: the tp-th part of each."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp = {tp} must divide n_heads {cfg.n_heads} and "
                         f"n_kv_heads {cfg.n_kv_heads}")
    return cfg.n_heads // tp, cfg.n_kv_heads // tp


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
               cache=None, start_pos=None, kv_limit=None, mesh=None):
    """Self-attention. With ``cache=(k_all, v_all, layer_idx)`` — the
    full (n_layers, batch, max_seq, n_kv_heads, head_dim) buffers and
    this layer's index — writes the new k/v into the layer's slots at
    ``start_pos`` (an int or 0-d tensor for the whole batch, or a
    (batch,) tensor per row) and attends against the layer's buffer.
    Returns (out, (k_all, v_all)) instead of out.

    On a ``mesh`` (parallel/mesh.py), ``layer`` holds this rank's tp
    columns of wq/wk/wv and rows of wo (Megatron): ``x`` enters through
    ``comm.copy_to`` and the output leaves through ``comm.reduce_from``
    over tp; the heads, the cache's kv heads and the attention are the
    rank's own. A sequence sharded on sp (training) attends by ring or
    Ulysses attention, or by a gathered k/v."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    nh, nkv_h = _local_heads(cfg, mesh)
    x = comm.copy_to(x, _tp(mesh))
    if "w_qkv" in layer["attn"]:
        # serving-fused projections (infer/quantize.py)
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        qkv = linear(x, layer["attn"]["w_qkv"])
        q = qkv[..., :nq].reshape(b, s, cfg.n_heads, hd)
        k = qkv[..., nq:nq + nkv].reshape(b, s, cfg.n_kv_heads, hd)
        v = qkv[..., nq + nkv:].reshape(b, s, cfg.n_kv_heads, hd)
    else:
        q = linear(x, layer["attn"]["wq"]).reshape(b, s, nh, hd)
        k = linear(x, layer["attn"]["wk"]).reshape(b, s, nkv_h, hd)
        v = linear(x, layer["attn"]["wv"]).reshape(b, s, nkv_h, hd)
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
        return _out_proj(out, layer, mesh), (k_pool, v_pool)
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
        return _out_proj(out, layer, mesh), (k_all, v_all)
    q = apply_rope(q, rope_cos, rope_sin)
    k = apply_rope(k, rope_cos, rope_sin)
    out = _self_attention(q, k, v, cfg.attention_impl, mesh)
    return _out_proj(out, layer, mesh)


def _out_proj(out, layer, mesh):
    b, s, h, hd = out.shape
    return comm.reduce_from(linear(out.reshape(b, s, h * hd),
                                   layer["attn"]["wo"]), _tp(mesh))


def _self_attention(q, k, v, impl: str, mesh):
    """Causal training attention on this rank's heads and rows. On a real
    sp axis ``auto`` is ring-zigzag, the JAX rule: ring keeps the sharded
    sequence local, zigzag evens out the causal work. ``dense`` and
    ``flash`` there gather q, k and v along sp, attend over the whole
    sequence with that implementation (the JAX package's GSPMD gathers it
    so) and keep this rank's rows."""
    sp = 1 if mesh is None else mesh.shape["sp"]
    if impl == "auto" and sp > 1:
        impl = "ring-zigzag"
    if impl in ("ring", "ring-zigzag"):
        from tpu_docker_api_torch.parallel.ring import ring_attention

        return ring_attention(
            q, k, v, mesh, causal=True,
            placement="zigzag" if impl == "ring-zigzag" else "contiguous")
    if impl == "ulysses":
        from tpu_docker_api_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, mesh, causal=True)
    if sp == 1:
        return multihead_attention(q, k, v, causal=True, impl=impl)
    # every rank's rows attend here, so the gathers' backward sums the
    # ranks' gradients (a reduce-scatter)
    grp, s = mesh.group("sp"), q.shape[1]
    qf, kf, vf = (comm.all_gather(t, 1, grp, bwd="sum") for t in (q, k, v))
    out = multihead_attention(qf, kf, vf, causal=True, impl=impl)
    return out[:, mesh.coords["sp"] * s:(mesh.coords["sp"] + 1) * s]


def _mlp(x, layer, mesh=None):
    """SwiGLU; on a mesh the gate/up columns and down rows are this
    rank's tp part (``copy_to`` in, ``reduce_from`` out)."""
    x = comm.copy_to(x, _tp(mesh))
    if "w_gu" in layer["mlp"]:
        gu = linear(x, layer["mlp"]["w_gu"])  # serving-fused gate|up
        gate, up = gu.chunk(2, dim=-1)
        return linear(F.silu(gate) * up, layer["mlp"]["w_down"])
    gate = F.silu(linear(x, layer["mlp"]["w_gate"]))
    up = linear(x, layer["mlp"]["w_up"])
    return comm.reduce_from(linear(gate * up, layer["mlp"]["w_down"]),
                            _tp(mesh))


def _block(x, layer, cfg: LlamaConfig, rope_cos, rope_sin,
           cache=None, start_pos=None, kv_limit=None, mesh=None,
           rules=None):
    """One transformer block: the residual/norm wiring of both the
    uncached forward and the KV-cached path (returns (x, cache)). On a
    mesh the layer's local shards are gathered over fsdp here, inside the
    remat region, so the backward gathers them again (ZeRO-3)."""
    if mesh is not None:
        layer = gather_layer(layer, layer_specs(layer, rules or LLAMA_RULES),
                             mesh)
    attn_out = _attention(
        rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
        rope_cos, rope_sin, cache=cache, start_pos=start_pos,
        kv_limit=kv_limit, mesh=mesh,
    )
    new_cache = None
    if cache is not None:
        attn_out, new_cache = attn_out
    x = x + attn_out
    x = x + _mlp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), layer, mesh)
    return x if cache is None else (x, new_cache)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Token-embedding gather. On a mesh ``table`` is this rank's
    (vocab/tp, d/fsdp) shard (``LLAMA_RULES``): gathered over fsdp, then
    a masked local gather of the rows this rank owns, summed over tp —
    the JAX function's one-hot × table product, whose partial sums over
    the vocab shards are these rows and zeros."""
    if mesh is None:
        return F.embedding(tokens, table)
    table = unshard(table, spec_for("embed/tokens"), mesh)
    rows = table.shape[0]
    idx = tokens - mesh.index("tp") * rows
    own = (idx >= 0) & (idx < rows)
    out = F.embedding(torch.where(own, idx, 0), table)
    out = out * own[..., None].to(out.dtype)
    return comm.reduce_from(out, _tp(mesh))


def rope_slice(cfg, seq: int, device, mesh=None):
    """(cos, sin) rows of this rank's positions: the whole ``seq`` off a
    mesh; on sp the rows of its contiguous chunk of the sequence, so rope
    rotates in the activations' dtype as on one device."""
    sp = 1 if mesh is None else mesh.shape["sp"]
    cos, sin = rope_frequencies(cfg.head_dim, seq * sp, cfg.rope_theta,
                                getattr(cfg, "rope_scaling", None),
                                device=device)
    if sp == 1:
        return cos, sin
    start = mesh.coords["sp"] * seq
    return cos[start:start + seq], sin[start:start + seq]


def llama_hidden(params: dict, tokens: torch.Tensor,
                 cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """The trunk: embed → blocks → final hidden (batch, seq, dim),
    before the final norm. With ``cfg.remat`` and autograd on, each block
    is checkpointed under ``models.common.remat_policy``. On a ``mesh``
    the params are this rank's local shards, ``tokens`` its rows and its
    sp chunk of the sequence, and the result its rows of the hidden."""
    seq = tokens.shape[1]
    x = embed_lookup(params["embed"]["tokens"], tokens, mesh)
    rope_cos, rope_sin = rope_slice(cfg, seq, x.device, mesh)
    return run_layers(x, params["layers"], cfg.n_layers, cfg, rope_cos,
                      rope_sin, mesh,
                      remat=cfg.remat and torch.is_grad_enabled())


def run_layers(x, layers: dict, n_layers: int, cfg: LlamaConfig, rope_cos,
               rope_sin, mesh=None, remat: bool = False):
    """``_block`` over each of the ``n_layers`` layers of the stacked
    ``layers`` tree in turn: the whole trunk (``llama_hidden``) or one
    pipeline stage's block of it (parallel/pipeline.py). ``remat``
    checkpoints each block under ``models.common.remat_policy``."""
    for layer in unstack_layers(layers, n_layers):
        if remat:
            x = remat_call(_block, x, layer, cfg, rope_cos, rope_sin,
                           None, None, None, mesh)
        else:
            x = _block(x, layer, cfg, rope_cos, rope_sin, mesh=mesh)
    return x


def llama_forward(params: dict, tokens: torch.Tensor,
                  cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """Next-token logits (batch, seq, vocab) in f32 (on a mesh: this
    rank's rows and sp chunk, the whole vocabulary)."""
    return lm_head(params, llama_hidden(params, tokens, cfg, mesh), cfg,
                   mesh)


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
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KV-cached forward: logits for the new tokens + the caches (updated
    in place and returned). On a tp ``mesh`` the params are this rank's
    shards and the caches hold its kv heads; the logits are whole."""
    def block_fn(x, layer, cache, rope_cos, rope_sin):
        return _block(x, layer, cfg, rope_cos, rope_sin, cache=cache,
                      start_pos=start_pos, kv_limit=kv_limit, mesh=mesh)

    return decoder_forward_cached(params, tokens, cfg, k_cache, v_cache,
                                  last_only, block_fn, mesh=mesh)


def llama_forward_paged(
    params: dict,
    tokens: torch.Tensor,     # (S, 1) — one decode token per slot
    cfg: LlamaConfig,
    k_pool: torch.Tensor,     # (n_layers, P, page, n_kv_heads, head_dim)
    v_pool: torch.Tensor,
    table: torch.Tensor,      # (S, mp) long page ids; 0 = trash
    pos: torch.Tensor,        # (S,) per-slot positions
    max_pos: int,             # position capacity (sizes the rope tables)
    mesh=None,
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
                      start_pos=pos, mesh=mesh)

    return decoder_forward_cached(params, tokens, cfg, k_pool, v_pool,
                                  False, block_fn, max_pos=max_pos,
                                  mesh=mesh)


def decoder_forward_cached(params, tokens, cfg, k_cache, v_cache,
                           last_only, block_fn, max_pos=None, mesh=None):
    """The shared KV-cached decoder skeleton: embed → cache-threading
    layer loop → lm_head. ``block_fn(x, layer, (kc, vc, layer_idx),
    rope_cos, rope_sin) -> (x, (kc, vc))`` supplies the block body.
    ``max_pos`` sizes the rope tables (default: the cache length).
    ``cfg`` may be another family's (models/moe.py): one without a
    ``rope_scaling`` field runs unscaled rope."""
    max_seq = max_pos or k_cache.shape[2]
    x = embed_lookup(params["embed"]["tokens"], tokens, mesh)
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
    return lm_head(params, x, cfg, mesh), kc, vc


def lm_head(params: dict, h: torch.Tensor, cfg: LlamaConfig,
            mesh=None, whole: bool = True) -> torch.Tensor:
    """Final norm + logits projection: operands in the storage dtype,
    f32 result. On a mesh the head is this rank's (d/fsdp, vocab/tp)
    shard: gathered over fsdp, the product is the rank's vocab columns,
    gathered over tp unless ``whole`` is False (the loss reduces them
    where they are)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if mesh is None:
        return linear(h.to(cfg.dtype), params["lm_head"],
                      out_dtype=torch.float32)
    head = unshard(params["lm_head"], spec_for("lm_head"), mesh)
    logits = linear(comm.copy_to(h.to(cfg.dtype), _tp(mesh)), head,
                    out_dtype=torch.float32)
    if not whole:
        return logits
    return comm.all_gather(logits, logits.ndim - 1, _tp(mesh), bwd="slice")


def loss_denominator(targets: torch.Tensor, mesh) -> int:
    """Token positions of the GLOBAL batch: this rank's count times the
    ranks that split rows (dp, fsdp) and the sequence (sp)."""
    n = targets.numel()
    if mesh is not None:
        n *= mesh.size_of(("dp", "fsdp", "sp"))
    return n


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        mesh, denom: int) -> torch.Tensor:
    """Sum of next-token cross-entropy over this rank's positions,
    divided by ``denom``, from this rank's tp columns of the logits: the
    max and the sum of exponentials reduce over tp, and the target's
    logit comes from the rank that owns its column. The full vocabulary
    is never gathered. Off a mesh (no tp group) it is the mean
    cross-entropy in logsumexp form, shifted by the detached row max."""
    grp = _tp(mesh)
    cols = logits.shape[-1]
    m = comm.all_reduce_max(logits.amax(dim=-1), grp)
    sumexp = comm.reduce_from(torch.exp(logits - m[..., None]).sum(-1), grp)
    lse = torch.log(sumexp) + m
    idx = targets.long() - (0 if mesh is None else mesh.index("tp")) * cols
    own = (idx >= 0) & (idx < cols)
    tl = logits.gather(-1, torch.where(own, idx, 0)[..., None])[..., 0]
    tl = comm.reduce_from(torch.where(own, tl, 0.0), grp)
    return (lse - tl).sum() / denom


def seq_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous sp chunk of ``x``'s seq dim (dim 1)."""
    sp = 1 if mesh is None else mesh.shape["sp"]
    if sp == 1:
        return x
    if x.shape[1] % sp:
        raise ValueError(f"seq {x.shape[1]} is not divisible by sp = {sp}")
    n = x.shape[1] // sp
    return x[:, mesh.coords["sp"] * n:(mesh.coords["sp"] + 1) * n]


def cross_entropy(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (the JAX function): the one-device
    case of ``vocab_parallel_xent``."""
    return vocab_parallel_xent(logits, targets, None, targets.numel())


def llama_loss(params: dict, tokens: torch.Tensor,
               cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]. With
    ``cfg.loss_chunk_rows`` set, the logits projection and the loss fuse
    into ``ops.xent.chunked_cross_entropy``, which never makes the
    (batch, seq, vocab) logits; without it the logits go through
    ``vocab_parallel_xent``. An int8 head (QLoRA's frozen base) is
    dequantized to ``cfg.dtype`` once a call for it, as in the JAX
    function.

    On a ``mesh`` ``params`` are this rank's local shards and ``tokens``
    its rows (parallel/sharding.py ``split_batch``); the sequence splits
    over sp here, and the result is this rank's share of the GLOBAL mean
    (its positions' sum over the global count), so the sum over ranks
    is the loss and the sum of their gradients the gradient."""
    inputs = seq_slice(tokens[:, :-1], mesh)
    targets = seq_slice(tokens[:, 1:], mesh)
    x = llama_hidden(params, inputs, cfg, mesh)
    return head_loss(params, x, targets, cfg, mesh)


def head_loss(params: dict, x: torch.Tensor, targets: torch.Tensor,
              cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """Final norm, head and cross-entropy of the final hidden ``x`` (this
    rank's rows and sp chunk) against ``targets``: this rank's share of
    the global mean (``loss_denominator``). ``params`` needs only
    ``final_norm`` and ``lm_head``: ``llama_loss``'s tail, and the last
    pipeline stage's (parallel/pipeline.py)."""
    denom = loss_denominator(targets, mesh)
    if cfg.loss_chunk_rows:
        h = rms_norm(x, params["final_norm"], cfg.norm_eps).to(cfg.dtype)
        head = unshard(params["lm_head"], spec_for("lm_head"), mesh)
        if isinstance(head, QuantizedLinear):
            head = dequantize_weight(head, cfg.dtype)
        return chunked_cross_entropy(h, head, targets, cfg.loss_chunk_rows,
                                     mesh=mesh, denom=denom)
    return vocab_parallel_xent(lm_head(params, x, cfg, mesh, whole=False),
                               targets, mesh, denom)


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
