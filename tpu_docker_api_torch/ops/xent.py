"""Chunked softmax cross-entropy fused with the logits projection
(counterpart of ``tpu_docker_api/ops/xent.py``).

The dense loss tail (``lm_head`` + ``cross_entropy``) keeps the full f32
logits — (batch, seq, vocab), 4.2 GB at llama3-1b's batch 4 × 2048 — for
the backward, and the backward makes a dlogits buffer as large. This op
makes neither: rows go through in chunks; the forward keeps only the
per-row logsumexp, and the backward rebuilds each chunk's logits from
(h, w):

    fwd:  per chunk   logits = h_c·w;  lse_c = logsumexp(logits)
          saved = (h, w, targets, lse)              # no (rows, vocab)
    bwd:  per chunk   p = exp(h_c·w − lse_c)
          dlogits = (p − onehot(t_c)) · g/N         # one chunk at a time
          dh_c = dlogits·wᵀ ;  dw += h_cᵀ·dlogits

There is no Pallas kernel here: the JAX package leaves these products to
XLA, and the port to ``torch.matmul`` (bf16 operands, f32 accumulation
through ``ops.quant.linear``). A Python loop over chunks replaces
``lax.scan``; the last chunk may be short, so no padding rows are made.
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.ops.quant import linear


def _chunk_logits(hc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return linear(hc, w.to(hc.dtype), out_dtype=torch.float32)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, targets, row_chunk):
        t = h.shape[0]
        loss = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for r0 in range(0, t, row_chunk):
            hc, tc = h[r0:r0 + row_chunk], targets[r0:r0 + row_chunk]
            logits = _chunk_logits(hc, w)                  # (rows, vocab)
            lse = torch.logsumexp(logits, dim=-1)
            tl = logits.gather(-1, tc[:, None])[:, 0]
            loss = loss + ((lse - tl) * (1.0 / t)).sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, targets, torch.cat(lses))
        ctx.row_chunk = row_chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lses = ctx.saved_tensors
        t = h.shape[0]
        scale = g.float() * (1.0 / t)
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for r0 in range(0, t, ctx.row_chunk):
            r1 = min(r0 + ctx.row_chunk, t)
            hc, tc = h[r0:r1], targets[r0:r1]
            p = torch.exp(_chunk_logits(hc, w) - lses[r0:r1, None])
            p[torch.arange(r1 - r0, device=p.device), tc] -= 1.0
            dlogits = (p * scale).to(hc.dtype)
            dh[r0:r1] = linear(dlogits, w.t().to(hc.dtype),
                               out_dtype=torch.float32).to(h.dtype)
            dw += linear(hc.t(), dlogits, out_dtype=torch.float32)
        return dh, dw.to(w.dtype), None, None


def chunked_cross_entropy(
    h: torch.Tensor,        # (batch, seq, d) — normed final hidden
    w: torch.Tensor,        # (d, vocab) lm head
    targets: torch.Tensor,  # (batch, seq) integer
    row_chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token cross-entropy over all (batch, seq) positions,
    matching ``cross_entropy(lm_head(h), targets)`` within f32
    reduction-order tolerance: the per-row math is the same, but the mean
    is accumulated as per-chunk sums rather than one global mean."""
    b, s, d = h.shape
    return _ChunkedXent.apply(h.reshape(b * s, d), w,
                              targets.reshape(b * s).long(), row_chunk)
