"""Multi-head attention dispatcher (counterpart of
``tpu_docker_api/ops/attention.py``).

Two implementations behind one call:

- ``dense``: einsum attention with f32 scores, softmax and PV — the
  correctness reference, and the path of every cached call that is not
  a whole-prompt prefill (decode, per-row positions, ``kv_limit``);
- ``flash``: the hand-written CUDA forward kernel (ops/flash.py) for
  self-attention where ``q_seq == kv_seq``.

``impl="auto"`` asks :func:`auto_impl`: flash on CUDA when q and k
share one sequence and the kernel takes the head_dim and dtype, causal
or not, else dense. Inputs are (batch, seq, heads, head_dim) — the
model's layout; the flash path hands the kernel (batch, heads, seq,
head_dim) VIEWS, whose strides the kernel reads, so nothing is copied.

The JAX dispatcher also sends short non-causal sequences (<= 256 tokens,
vit-b16's 256 patches) to dense, a rule measured on a TPU v5e. The port
has no such rule: on an H100 the flash kernels took a vit-b16 attention
forward and backward (batch 128, 256 tokens, 12/12 heads, d 64, bf16)
in about 1/14 of ``dense_attention``'s time, 1/15 at the encdec-base
encoder's (32, 512), and a whole vit-b16 train step ran faster with them
(``chip_smoke.py`` ``phase_vit`` measures all three; the numbers are in
PERF.md).
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.ops import flash

_NEG = -1e30


def dense_attention(
    q: torch.Tensor,  # (batch, q_seq, num_heads, head_dim)
    k: torch.Tensor,  # (batch, kv_seq, num_kv_heads, head_dim)
    v: torch.Tensor,
    causal: bool,
    q_offset: torch.Tensor | int | None = None,
    probs_dtype: torch.dtype | None = None,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Einsum attention with GQA folding.

    ``q_offset`` gives query i the absolute position ``q_offset + i``:
    key slot j is attended iff ``j <= q_offset + i``, which also masks
    cache slots not yet written. A (batch,) ``q_offset`` gives every row
    its own position (continuous-batching decode). ``kv_len`` ((batch,))
    masks key positions ``>= kv_len[row]`` regardless of causality.
    Masked scores are -1e30, so they contribute exp(-1e30 - max) == 0
    exactly. ``probs_dtype`` rounds the probabilities before the PV
    product (training callers); the default keeps them f32.

    Scores and PV run in f32 on upcast operands: products of bf16 values
    are exact in f32, so this is the JAX path's storage-dtype operands
    with f32 accumulation."""
    batch, seq, num_heads, head_dim = q.shape
    kv_seq, num_kv = k.shape[1], k.shape[2]
    group = num_heads // num_kv
    qg = q.reshape(batch, seq, num_kv, group, head_dim).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    scores = scores * (1.0 / head_dim**0.5)
    if kv_len is not None:
        k_pos = torch.arange(kv_seq, device=q.device)
        lmask = k_pos[None, :] < kv_len[:, None]             # (batch, k)
        scores = torch.where(lmask[:, None, None, None, :], scores, _NEG)
    if causal:
        q_pos = torch.arange(seq, device=q.device)
        k_pos = torch.arange(kv_seq, device=q.device)
        if torch.is_tensor(q_offset) and q_offset.ndim == 1:
            q_pos = q_pos[None, :] + q_offset[:, None]         # (batch, q)
            mask = k_pos[None, None, :] <= q_pos[:, :, None]   # (b, q, k)
            scores = torch.where(mask[:, None, None], scores, _NEG)
        else:
            if q_offset is not None:
                q_pos = q_pos + q_offset
            mask = k_pos[None, :] <= q_pos[:, None]            # (q, k)
            scores = torch.where(mask[None, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    if probs_dtype is not None:
        probs = probs.to(probs_dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(batch, seq, num_heads, head_dim).to(q.dtype)


def auto_impl(q_shape, k_shape, causal: bool, is_cuda: bool,
              dtype: torch.dtype) -> str:
    """The ``impl="auto"`` choice for (batch, seq, heads, head_dim) q and
    k shapes: "flash" on CUDA for self-attention shapes (q_seq ==
    kv_seq: the kernel has one sequence length) that the kernel takes,
    whatever ``causal`` and the length; else "dense"."""
    del causal  # no short non-causal rule on the card (module docstring)
    if (is_cuda and q_shape[1] == k_shape[1]
            and flash.supports(q_shape[-1], dtype)):
        return "flash"
    return "dense"


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    impl: str = "auto",
    probs_dtype: torch.dtype | None = None,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """(batch, seq, heads, head_dim) attention with GQA support.
    ``kv_len`` forces the dense path (the kernel has no length mask)."""
    if kv_len is not None:
        return dense_attention(q, k, v, causal, probs_dtype=probs_dtype,
                               kv_len=kv_len)
    if impl == "auto":
        impl = auto_impl(q.shape, k.shape, causal, q.is_cuda, q.dtype)
    if impl == "dense":
        return dense_attention(q, k, v, causal, probs_dtype=probs_dtype)
    if impl == "flash":
        out = flash.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal)
        return out.transpose(1, 2)
    raise ValueError(f"unknown attention impl {impl!r}")
