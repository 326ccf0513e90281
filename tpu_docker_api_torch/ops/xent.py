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

On a mesh (models/llama.py's sharded loss) ``w`` is this rank's
(d, vocab/tp) columns: each chunk's max and sum of exponentials reduce
over tp, the target's logit comes from the rank that owns its column,
and the backward sums dh over tp. The full vocabulary is never gathered.
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.ops.quant import linear
from tpu_docker_api_torch.parallel import comm


def _chunk_logits(hc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return linear(hc, w.to(hc.dtype), out_dtype=torch.float32)


def _owned(tc: torch.Tensor, col0: int, cols: int):
    """(column of each target in this rank's vocab part, owned mask)."""
    idx = tc - col0
    own = (idx >= 0) & (idx < cols)
    return torch.where(own, idx, 0), own


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, targets, row_chunk, denom, group, col0):
        t = h.shape[0]
        loss = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for r0 in range(0, t, row_chunk):
            hc, tc = h[r0:r0 + row_chunk], targets[r0:r0 + row_chunk]
            logits = _chunk_logits(hc, w)                  # (rows, vocab)
            if group is None:
                lse = torch.logsumexp(logits, dim=-1)
                tl = logits.gather(-1, tc[:, None])[:, 0]
            else:
                m = comm.all_reduce_max(logits.amax(dim=-1), group)
                se = comm._all_reduce(
                    torch.exp(logits - m[:, None]).sum(-1), group)
                lse = torch.log(se) + m
                col, own = _owned(tc, col0, logits.shape[-1])
                tl = logits.gather(-1, col[:, None])[:, 0]
                tl = comm._all_reduce(torch.where(own, tl, 0.0), group)
            loss = loss + ((lse - tl) * (1.0 / denom)).sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, targets, torch.cat(lses))
        ctx.row_chunk, ctx.denom, ctx.group, ctx.col0 = (row_chunk, denom,
                                                         group, col0)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lses = ctx.saved_tensors
        t = h.shape[0]
        scale = g.float() * (1.0 / ctx.denom)
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for r0 in range(0, t, ctx.row_chunk):
            r1 = min(r0 + ctx.row_chunk, t)
            hc, tc = h[r0:r1], targets[r0:r1]
            p = torch.exp(_chunk_logits(hc, w) - lses[r0:r1, None])
            rows = torch.arange(r1 - r0, device=p.device)
            if ctx.group is None:
                p[rows, tc] -= 1.0
            else:
                col, own = _owned(tc, ctx.col0, p.shape[-1])
                p[rows, col] -= own.to(p.dtype)
            dlogits = (p * scale).to(hc.dtype)
            dhc = linear(dlogits, w.t().to(hc.dtype), out_dtype=torch.float32)
            if ctx.group is not None:
                # h is replicated over tp: its gradient sums the ranks'
                # vocab parts
                dhc = comm._all_reduce(dhc, ctx.group)
            dh[r0:r1] = dhc.to(h.dtype)
            dw += linear(hc.t(), dlogits, out_dtype=torch.float32)
        return dh, dw.to(w.dtype), None, None, None, None, None


def chunked_cross_entropy(
    h: torch.Tensor,        # (batch, seq, d) — normed final hidden
    w: torch.Tensor,        # (d, vocab) lm head
    targets: torch.Tensor,  # (batch, seq) integer
    row_chunk: int = 512,
    mesh=None,
    denom: int | None = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy over all (batch, seq) positions,
    matching ``cross_entropy(lm_head(h), targets)`` within f32
    reduction-order tolerance: the per-row math is the same, but the mean
    is accumulated as per-chunk sums rather than one global mean. On a
    ``mesh`` ``w`` is this rank's vocab columns and the sum is divided by
    ``denom`` (the global batch's positions) instead of this rank's."""
    b, s, d = h.shape
    group = None if mesh is None else mesh.group("tp")
    col0 = 0 if mesh is None else mesh.index("tp") * w.shape[-1]
    return _ChunkedXent.apply(h.reshape(b * s, d), w,
                              targets.reshape(b * s).long(), row_chunk,
                              denom or b * s, group, col0)
