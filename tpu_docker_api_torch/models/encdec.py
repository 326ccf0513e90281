"""Encoder-decoder (T5-class) seq2seq transformer, the cross-attention
family (counterpart of ``tpu_docker_api/models/encdec.py``).

A bidirectional encoder feeds a causal decoder through
cross-attention: decoder queries against encoder keys and values, no
causal mask and no rope on the cross path (positions live in each
side's self-attention). The parameters keep the JAX package's pytree
(``enc_layers`` and ``dec_layers`` stacked along a leading layer dim, a
shared src/tgt embedding), so weights cross over 1:1
(models/convert.py). bf16 storage with f32 norms, softmax and logits;
a Python loop over layers in place of ``lax.scan``; with ``cfg.remat``
each block is checkpointed under the shared selective policy
(models/common.py).

Attention goes through ``multihead_attention``: the encoder's
self-attention (non-causal) and the decoder's (causal) take the flash
kernel on the card, and so does cross-attention when the source and
target have one length. Cross-attention of another length, the
encoder's ``kv_len`` mask and the slot decode step stay on
``dense_attention``, as in JAX. On a mesh the weights shard by
``ENCDEC_RULES``, gather over fsdp a layer at a time, and tp splits the
heads and MLP columns as llama's blocks do. On a real sp axis each rank
holds a contiguous chunk of the source and of the target, rope rotates
it at its global positions, the encoder's self-attention rides the
non-causal contiguous ring and the decoder's the causal zigzag ring
(parallel/ring.py), and the encoder output is gathered over sp once a
forward, so every decoder layer's cross-attention reads the whole
encoder k/v with this rank's query chunk (lengths differ: the dense
path, as JAX's ``auto`` takes it). The slot engine and the server stay
off sp: JAX's server has no ``--sp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpu_docker_api_torch.models.common import (draw_stacked, init_tree,
                                                remat_call,
                                                seeded_generator)
from tpu_docker_api_torch.models.llama import (_write_cache, embed_lookup,
                                               gather_layer, layer_specs,
                                               loss_denominator, rope_slice,
                                               seq_slice, unstack_layers,
                                               vocab_parallel_xent)
from tpu_docker_api_torch.ops.attention import (dense_attention,
                                                multihead_attention)
from tpu_docker_api_torch.ops.norms import rms_norm
from tpu_docker_api_torch.ops.quant import linear
from tpu_docker_api_torch.parallel import comm
from tpu_docker_api_torch.parallel.ring import ring_attention
from tpu_docker_api_torch.parallel.sharding import P, spec_for, unshard
from tpu_docker_api_torch.ops.rope import apply_rope, rope_frequencies
from tpu_docker_api_torch.ops.xent import chunked_cross_entropy


#: param-path sharding rules, first match wins (the JAX ENCDEC_RULES). On
#: a mesh the batch splits over dp and fsdp; the layers gather over fsdp
#: one at a time and their column-/row-parallel products split over tp;
#: the embedding and the head are vocab-parallel, as llama's
ENCDEC_RULES: list = [
    ("embed/tokens",            P("tp", "fsdp")),
    ("enc_layers/attn/wo",      P(None, "tp", "fsdp")),
    ("enc_layers/attn/w*",      P(None, "fsdp", "tp")),
    ("enc_layers/mlp/w_down",   P(None, "tp", "fsdp")),
    ("enc_layers/mlp/w*",       P(None, "fsdp", "tp")),
    ("dec_layers/*attn/wo",     P(None, "tp", "fsdp")),
    ("dec_layers/*attn/w*",     P(None, "fsdp", "tp")),
    ("dec_layers/mlp/w_down",   P(None, "tp", "fsdp")),
    ("dec_layers/mlp/w*",       P(None, "fsdp", "tp")),
    ("*norm*",                  P()),
    ("lm_head",                 P("fsdp", "tp")),
    ("*",                       P()),
]


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    vocab_size: int = 32000
    dim: int = 768
    enc_layers: int = 12
    dec_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 12
    ffn_dim: int = 3072
    max_src_len: int = 512
    max_tgt_len: int = 512
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True
    # >0: encdec_loss fuses the head into ops.xent.chunked_cross_entropy
    # with this row-chunk size instead of making (b, T, vocab) logits
    loss_chunk_rows: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_pair(self, src_len: int, tgt_len: int) -> float:
        """Training FLOPs per (src, tgt) sequence pair (fwd+bwd ≈ 3×).
        q and o act on the query-side rows, k and v on the key-side rows
        (tgt and src on the cross path); one MLP a layer on both sides."""
        d, hd = self.dim, self.head_dim
        qo = 2 * 2 * d * (self.n_heads * hd)       # q + o per row
        kv = 2 * 2 * d * (self.n_kv_heads * hd)    # k + v per row
        mlp = 3 * 2 * d * self.ffn_dim
        enc = self.enc_layers * (
            src_len * (qo + kv + mlp)
            + 2 * 2 * src_len * src_len * (self.n_heads * hd))  # full attn
        dec = self.dec_layers * (
            tgt_len * (qo + kv + mlp)              # self-attention + MLP
            + 2 * 2 * tgt_len * tgt_len * (self.n_heads * hd) / 2  # causal
            + tgt_len * qo + src_len * kv          # cross projections
            + 2 * 2 * tgt_len * src_len * (self.n_heads * hd))     # cross
        head = tgt_len * 2 * d * self.vocab_size
        return 3.0 * (enc + dec + head)


def encdec_presets() -> dict[str, EncDecConfig]:
    return {
        # T5-base-class geometry (~250M params), rope positions
        "encdec-base": EncDecConfig(),
        # CPU-fast config for tests
        "tiny": EncDecConfig(
            vocab_size=256, dim=64, enc_layers=2, dec_layers=2, n_heads=4,
            n_kv_heads=2, ffn_dim=128, max_src_len=64, max_tgt_len=64,
            remat=False),
    }


def encdec_param_specs(cfg: EncDecConfig) -> dict:
    """The param tree's leaves as ``(shape, fan_in)``; ``fan_in`` None is
    a norm scale of ones."""
    d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn_dim
    Le, Ld = cfg.enc_layers, cfg.dec_layers

    def attn(L):
        return {"wq": ((L, d, cfg.n_heads * hd), d),
                "wk": ((L, d, cfg.n_kv_heads * hd), d),
                "wv": ((L, d, cfg.n_kv_heads * hd), d),
                "wo": ((L, cfg.n_heads * hd, d), cfg.n_heads * hd)}

    def mlp(L):
        return {"w_gate": ((L, d, f), d), "w_up": ((L, d, f), d),
                "w_down": ((L, f, d), f)}

    return {
        "embed": {"tokens": ((cfg.vocab_size, d), d)},
        "enc_layers": {"attn_norm": ((Le, d), None),
                       "mlp_norm": ((Le, d), None),
                       "attn": attn(Le), "mlp": mlp(Le)},
        "dec_layers": {"self_norm": ((Ld, d), None),
                       "cross_norm": ((Ld, d), None),
                       "mlp_norm": ((Ld, d), None),
                       "self_attn": attn(Ld), "cross_attn": attn(Ld),
                       "mlp": mlp(Ld)},
        "enc_final_norm": ((d,), None),
        "final_norm": ((d,), None),
        "lm_head": ((d, cfg.vocab_size), d),
    }


def encdec_init(cfg: EncDecConfig, generator: torch.Generator,
                place=None) -> dict:
    """Random parameters (truncated-normal fan-in scaling) on the
    generator's device, stacked leaves drawn matrix by matrix. ``place``:
    models/common.py ``init_tree``."""
    def init(spec):
        shape, fan_in = spec
        if fan_in is None:
            return torch.ones(shape, dtype=cfg.dtype,
                              device=generator.device)
        return draw_stacked(generator, shape, fan_in, cfg.dtype)

    return init_tree(encdec_param_specs(cfg), init, place)


def _project_qkv(x, weights, cfg: EncDecConfig, kv_from=None):
    """q from ``x``, k/v from ``kv_from`` (defaults to x: self-attention)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    src = x if kv_from is None else kv_from
    sk = src.shape[1]
    q = linear(x, weights["wq"]).reshape(b, s, -1, hd)
    k = linear(src, weights["wk"]).reshape(b, sk, -1, hd)
    v = linear(src, weights["wv"]).reshape(b, sk, -1, hd)
    return q, k, v


def _mlp(x, mlp, tp=None):
    """SwiGLU; ``tp``: the gate/up columns and down rows are this rank's
    part (``copy_to`` in, ``reduce_from`` out)."""
    x = comm.copy_to(x, tp)
    gate = F.silu(linear(x, mlp["w_gate"]))
    return comm.reduce_from(linear(gate * linear(x, mlp["w_up"]),
                                   mlp["w_down"]), tp)


def _layer_on(layer, prefix: str, mesh):
    """(the layer gathered over fsdp, the tp group): inside the remat
    region, as llama's ``_block``; (layer, None) off a mesh."""
    if mesh is None:
        return layer, None
    return (gather_layer(layer, layer_specs(layer, ENCDEC_RULES, prefix),
                         mesh), mesh.group("tp"))


def _has_sp(mesh) -> bool:
    return mesh is not None and mesh.shape["sp"] > 1


def _enc_block(x, layer, cfg: EncDecConfig, rope_cos, rope_sin,
               kv_len=None, mesh=None):
    """Bidirectional self-attention + SwiGLU, pre-norm residuals.
    ``kv_len`` ((b,)) masks right-pad positions out of the attention, so
    a bucketed admission encodes exactly like the unpadded source. On a
    ``mesh``: this rank's tp heads and MLP columns; on sp its chunk of
    the source, attending by the non-causal ring."""
    layer, tp = _layer_on(layer, "enc_layers", mesh)
    b, s, _ = x.shape
    y = comm.copy_to(rms_norm(x, layer["attn_norm"], cfg.norm_eps), tp)
    q, k, v = _project_qkv(y, layer["attn"], cfg)
    q = apply_rope(q, rope_cos, rope_sin)
    k = apply_rope(k, rope_cos, rope_sin)
    if _has_sp(mesh):
        if kv_len is not None:
            # the ring has no length mask; dropping it would corrupt
            # every real position's softmax (JAX's refusal)
            raise NotImplementedError(
                "kv_len masking is not supported on sp-mesh encodes "
                "(ring attention path)")
        out = ring_attention(q, k, v, mesh, causal=False)
    else:
        out = multihead_attention(q, k, v, causal=False,
                                  probs_dtype=cfg.dtype, kv_len=kv_len)
    x = x + comm.reduce_from(linear(out.reshape(b, s, -1),
                                    layer["attn"]["wo"]), tp)
    return x + _mlp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                    layer["mlp"], tp)


def _dec_block(x, enc_out, layer, cfg: EncDecConfig, rope_cos, rope_sin,
               mesh=None):
    """Causal self-attention → cross-attention over ``enc_out`` (no
    rope: the cross path is pure content lookup) → SwiGLU. On a
    ``mesh``: this rank's tp heads and MLP columns; on sp its chunk of
    the target, self-attending by the causal zigzag ring, its queries
    against the whole (gathered) ``enc_out``."""
    layer, tp = _layer_on(layer, "dec_layers", mesh)
    b, s, _ = x.shape
    y = comm.copy_to(rms_norm(x, layer["self_norm"], cfg.norm_eps), tp)
    q, k, v = _project_qkv(y, layer["self_attn"], cfg)
    q = apply_rope(q, rope_cos, rope_sin)
    k = apply_rope(k, rope_cos, rope_sin)
    if _has_sp(mesh):
        out = ring_attention(q, k, v, mesh, causal=True, placement="zigzag")
    else:
        out = multihead_attention(q, k, v, causal=True)
    x = x + comm.reduce_from(linear(out.reshape(b, s, -1),
                                    layer["self_attn"]["wo"]), tp)
    y = comm.copy_to(rms_norm(x, layer["cross_norm"], cfg.norm_eps), tp)
    q, k, v = _project_qkv(y, layer["cross_attn"], cfg,
                           kv_from=comm.copy_to(enc_out, tp))
    # auto dispatch: q_seq != kv_seq stays dense; equal lengths may take
    # the flash kernel
    out = multihead_attention(q, k, v, causal=False, probs_dtype=cfg.dtype)
    x = x + comm.reduce_from(linear(out.reshape(b, s, -1),
                                    layer["cross_attn"]["wo"]), tp)
    return x + _mlp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                    layer["mlp"], tp)


def encdec_encode(params, src, cfg: EncDecConfig, kv_len=None, mesh=None):
    """(b, S) source tokens → (b, S, d) encoder output (final-normed, in
    ``cfg.dtype``). ``kv_len`` ((b,)): row b's positions >= kv_len[b] are
    right-padding, excluded from every layer's attention. On a ``mesh``
    the params are this rank's local shards and ``src`` its rows (on sp,
    its contiguous chunk of them); the output is whole along the
    sequence, gathered over sp once (its backward a reduce-scatter)."""
    x = embed_lookup(params["embed"]["tokens"], src, mesh)
    rope_cos, rope_sin = rope_slice(cfg, src.shape[1], x.device, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in unstack_layers(params["enc_layers"], cfg.enc_layers):
        args = (x, layer, cfg, rope_cos, rope_sin, kv_len, mesh)
        x = remat_call(_enc_block, *args) if remat else _enc_block(*args)
    out = rms_norm(x, params["enc_final_norm"], cfg.norm_eps).to(cfg.dtype)
    if _has_sp(mesh):
        out = comm.all_gather(out, 1, mesh.group("sp"), bwd="sum")
    return out


def encdec_hidden(params, batch, cfg: EncDecConfig, mesh=None):
    """((b, S) src, (b, T) tgt-input) → final decoder hidden (b, T, d),
    before the final norm."""
    src, tgt = batch
    enc_out = encdec_encode(params, src, cfg, mesh=mesh)
    x = embed_lookup(params["embed"]["tokens"], tgt, mesh)
    rope_cos, rope_sin = rope_slice(cfg, tgt.shape[1], x.device, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in unstack_layers(params["dec_layers"], cfg.dec_layers):
        args = (x, enc_out, layer, cfg, rope_cos, rope_sin, mesh)
        x = remat_call(_dec_block, *args) if remat else _dec_block(*args)
    return x


def _head(params, x, cfg: EncDecConfig, mesh=None):
    """Final norm + logits in f32; on a ``mesh`` this rank's tp columns
    of the vocabulary (the head gathered over fsdp)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = unshard(params["lm_head"], spec_for("lm_head", ENCDEC_RULES),
                   mesh)
    tp = None if mesh is None else mesh.group("tp")
    return linear(comm.copy_to(x.to(cfg.dtype), tp), head,
                  out_dtype=torch.float32)


def encdec_forward(params, batch, cfg: EncDecConfig):
    """((b, S) src, (b, T) tgt-input) → next-token logits (b, T, vocab)
    in f32."""
    return _head(params, encdec_hidden(params, batch, cfg), cfg)


def encdec_loss(params, batch, cfg: EncDecConfig, mesh=None):
    """Teacher-forced seq2seq cross-entropy: batch = (src (b, S), tgt
    (b, T+1)); the decoder reads tgt[:, :-1] and predicts tgt[:, 1:].
    With ``cfg.loss_chunk_rows`` the head fuses into
    ``ops.xent.chunked_cross_entropy``, as ``llama_loss``'s does. On a
    ``mesh``: this rank's share of the global mean from its rows, its
    contiguous sp chunk of the source and of the target, and its tp
    columns of the vocabulary."""
    src, tgt = batch
    targets = seq_slice(tgt[:, 1:], mesh)
    denom = loss_denominator(targets, mesh)
    x = encdec_hidden(params, (seq_slice(src, mesh),
                               seq_slice(tgt[:, :-1], mesh)), cfg, mesh)
    if cfg.loss_chunk_rows:
        h = rms_norm(x, params["final_norm"], cfg.norm_eps).to(cfg.dtype)
        head = unshard(params["lm_head"], spec_for("lm_head", ENCDEC_RULES),
                       mesh)
        return chunked_cross_entropy(h, head, targets, cfg.loss_chunk_rows,
                                     mesh=mesh, denom=denom)
    return vocab_parallel_xent(_head(params, x, cfg, mesh), targets, mesh,
                               denom)


def encdec_synthetic_batch(seed, batch: int, src_len: int, tgt_len: int,
                           cfg: EncDecConfig, row_offset: int = 0,
                           device="cpu"):
    """(src (B, src_len), tgt (B, tgt_len + 1)) int64 token pairs on
    ``device``, each GLOBAL row drawn from ``(*seed, r)`` alone, as
    ``vit_synthetic_batch``'s rows (models/vit.py)."""
    key = (seed,) if isinstance(seed, int) else tuple(seed)
    src = torch.empty((batch, src_len), dtype=torch.long, device=device)
    tgt = torch.empty((batch, tgt_len + 1), dtype=torch.long, device=device)
    for i in range(batch):
        g = seeded_generator(device, *key, row_offset + i)
        src[i] = torch.randint(0, cfg.vocab_size, (src_len,), generator=g,
                               device=device)
        tgt[i] = torch.randint(0, cfg.vocab_size, (tgt_len + 1,),
                               generator=g, device=device)
    return src, tgt


def _cross_kv(params, enc_out, cfg: EncDecConfig):
    """Every decoder layer's cross-attention k/v from the encoder output,
    fixed for the whole decode and so computed once, outside the token
    loop: (Ld, b, S, kvh, hd) each."""
    b, S, _ = enc_out.shape
    hd = cfg.head_dim
    ks, vs = [], []
    for w in unstack_layers(params["dec_layers"]["cross_attn"],
                            cfg.dec_layers):
        ks.append(linear(enc_out, w["wk"]).reshape(b, S, cfg.n_kv_heads, hd))
        vs.append(linear(enc_out, w["wv"]).reshape(b, S, cfg.n_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


def _decode_layers(params, x, cfg: EncDecConfig, self_attend, cross_k,
                   cross_v, src_lens=None):
    """The decoder stack at one position for every row:
    ``self_attend(q, k, v, layer_idx)`` writes the new k/v into the
    self-attention cache and attends it; cross-attention reads the
    precomputed ``cross_k``/``cross_v`` (masked at ``src_lens``)."""
    b, d, hd = x.shape[0], cfg.dim, cfg.head_dim
    layers = unstack_layers(params["dec_layers"], cfg.dec_layers)
    for i, layer in enumerate(layers):
        y = rms_norm(x, layer["self_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(y, layer["self_attn"], cfg)
        out = self_attend(q, k, v, i)
        x = x + linear(out.reshape(b, 1, d), layer["self_attn"]["wo"])
        y = rms_norm(x, layer["cross_norm"], cfg.norm_eps)
        # q only: the cross k/v were computed once by _cross_kv
        q = linear(y, layer["cross_attn"]["wq"]).reshape(
            b, 1, cfg.n_heads, hd)
        out = dense_attention(q, cross_k[i], cross_v[i], causal=False,
                              kv_len=src_lens)
        x = x + linear(out.reshape(b, 1, d), layer["cross_attn"]["wo"])
        x = x + _mlp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                     layer["mlp"])
    return _head(params, x, cfg)[:, 0]


@torch.no_grad()
def encdec_slot_decode_step(
    params: dict,
    tok: torch.Tensor,       # (S,) current token per slot
    pos: torch.Tensor,       # (S,) per-slot decode position
    cfg: EncDecConfig,
    k_cache: torch.Tensor,   # (Ld, S, max_tgt, kvh, hd) self-attn cache
    v_cache: torch.Tensor,
    cross_k: torch.Tensor,   # (Ld, S, src_cap, kvh, hd) per-slot static
    cross_v: torch.Tensor,
    src_lens: torch.Tensor,  # (S,) true source length per slot
    rope_cos, rope_sin,
    kv_limit: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE decoder position for S independent slot rows, the decode body
    of the encdec slot engine (infer/encdec_slots.py): per-row positions
    (cache writes past capacity dropped, per-row causal ``q_offset``), a
    ``kv_limit`` read bucket on the self-attention cache, and per-row
    ``src_lens`` masking the cross path. The caches are updated IN PLACE
    and returned. Returns (logits (S, vocab) f32, k_cache, v_cache)."""
    x = embed_lookup(params["embed"]["tokens"], tok[:, None])
    positions = pos[:, None].long()

    def self_attend(q, k, v, i):
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)
        kc, vc = k_cache[i], v_cache[i]
        _write_cache(kc, k, pos, positions, per_row=True)
        _write_cache(vc, v, pos, positions, per_row=True)
        if kv_limit is not None and kv_limit < kc.shape[1]:
            kc, vc = kc[:, :kv_limit], vc[:, :kv_limit]
        return dense_attention(q, kc, vc, causal=True, q_offset=pos)

    logits = _decode_layers(params, x, cfg, self_attend, cross_k, cross_v,
                            src_lens)
    return logits, k_cache, v_cache


@torch.no_grad()
def encdec_generate(
    params: dict,
    src: torch.Tensor,       # (b, S) source tokens
    cfg: EncDecConfig,
    max_new_tokens: int = 32,
    bos_id: int = 0,
    eos_id: int | None = None,
    pad_id: int = 0,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,
):
    """Seq2seq generation: encode once, then a KV-cached decoder loop
    (self-attention against a (Ld, b, max_new_tokens, kvh, hd) cache
    written one position a step, cross-attention against the
    precomputed encoder k/v). Returns (b, max_new_tokens) int64; with
    ``eos_id`` set, {"tokens", "lengths"} with the llama engine's
    contract (length = first eos + 1, later positions ``pad_id``).
    Sampling is ``infer.sampling.make_sampler``'s, drawing from
    ``generator``."""
    from tpu_docker_api_torch.infer.sampling import make_sampler

    sampler = make_sampler(temperature, top_k=top_k, top_p=top_p)
    b = src.shape[0]
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    enc_out = encdec_encode(params, src, cfg)
    cross_k, cross_v = _cross_kv(params, enc_out, cfg)
    rope_cos, rope_sin = rope_frequencies(hd, max_new_tokens, cfg.rope_theta,
                                          device=src.device)
    k_cache = torch.zeros((cfg.dec_layers, b, max_new_tokens, kvh, hd),
                          dtype=cfg.dtype, device=src.device)
    v_cache = torch.zeros_like(k_cache)
    tok = torch.full((b,), bos_id, dtype=torch.long, device=src.device)
    toks = []
    for step in range(max_new_tokens):
        positions = torch.full((b, 1), step, dtype=torch.long,
                               device=src.device)

        def self_attend(q, k, v, i, step=step, positions=positions):
            q = apply_rope(q, rope_cos, rope_sin, positions)
            k = apply_rope(k, rope_cos, rope_sin, positions)
            k_cache[i, :, step] = k[:, 0].to(k_cache.dtype)
            v_cache[i, :, step] = v[:, 0].to(v_cache.dtype)
            return dense_attention(q, k_cache[i], v_cache[i], causal=True,
                                   q_offset=step)

        x = embed_lookup(params["embed"]["tokens"], tok[:, None])
        logits = _decode_layers(params, x, cfg, self_attend, cross_k,
                                cross_v)
        tok = sampler(logits, generator)
        toks.append(tok)
    toks = torch.stack(toks, dim=1)  # (b, max_new_tokens)
    if eos_id is None:
        return toks
    is_eos = toks == eos_id
    first_eos = torch.argmax(is_eos.int(), dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos + 1, toks.shape[1])
    past = torch.arange(toks.shape[1], device=toks.device)[None, :] >= \
        lengths[:, None]
    return {"tokens": torch.where(past, pad_id, toks), "lengths": lengths}
