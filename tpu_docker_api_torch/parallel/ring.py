"""Ring attention: exact causal attention over sequence-parallel shards
(counterpart of ``tpu_docker_api/parallel/ring.py``).

The sequence axis is sharded over the ``sp`` ranks; each rank holds a q
chunk and rotates the k/v chunks round the ring (``comm.ppermute``),
keeping online-softmax statistics, so the result is exact while no rank
ever holds more than seq/sp of k/v. The block math is the JAX module's
``_osm_update`` in ``torch.matmul`` form (JAX does it in ``jnp`` too):
f32 scores and statistics, the probabilities rounded to the storage
dtype before the PV product as the flash kernels do.

Causal efficiency: a k/v chunk that lies wholly after the q chunk is
never attended, so its block is skipped by a Python ``if`` (the ring
still rotates: it is a collective). Rank i computes i+1 of the n blocks
on the contiguous placement. ``placement="zigzag"`` gives every rank a
head stripe and a tail stripe of the 2n stripes (two ``ppermute``s in
and out), so each computes exactly 2n+1 half-stripe pairs.

The backward is autograd through the same loop: ``ppermute``'s backward
sends the k/v gradients the other way round the ring. Every rank must
run the same collectives in the same order in the backward too, whatever
blocks it skipped, so k and v travel as one tensor (one chain of
``ppermute``s a call, each step's depending on the next), q, k and v
are exchanged as one, and the last chunk a rank holds always joins its
output (times zero), so no rank prunes the tail of the chain.
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.parallel import comm

_NEG_INF = -1e30


def _osm_update(carry, qg, k_blk, v_blk, scale, row_base, col_base, masked):
    """One online-softmax accumulation of q-block × kv-block; carry is
    (acc, m, l, n_blocks). ``row_base``/``col_base`` are absolute token
    offsets for the causal mask."""
    acc, m_prev, l_prev, nblk = carry
    nq, nk = qg.shape[1], k_blk.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_blk.float()) * scale
    if masked:
        rows = row_base + torch.arange(nq, device=qg.device)[:, None]
        cols = col_base + torch.arange(nk, device=qg.device)[None, :]
        s = torch.where(rows >= cols, s, _NEG_INF)
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(v_blk.dtype).float(), v_blk.float())
    return acc_new, m_new, l_new, nblk + 1


def _fresh(b, h_kv, group, sq, d, device):
    return (torch.zeros((b, h_kv, group, sq, d), dtype=torch.float32,
                        device=device),
            torch.full((b, h_kv, group, sq, 1), _NEG_INF,
                       dtype=torch.float32, device=device),
            torch.zeros((b, h_kv, group, sq, 1), dtype=torch.float32,
                        device=device),
            0)


def _finish(carry, b, sq, h, d):
    acc, _m, l, nblk = carry
    out = acc / l.clamp_min(1e-30)                 # (b, h_kv, g, sq, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d), nblk


def _ring(n, me):
    return [(i, (i + 1) % n) for i in range(n)]


def _keep_chain(out: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """``out`` with the last k/v chunk joined at weight zero: its
    ``ppermute`` chain then reaches the loss on every rank."""
    return out + (kv.sum() * 0).to(out.dtype)


def _ring_contiguous(q, k, v, group, causal: bool, scale: float):
    n, me = comm._size(group), comm._rank(group)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, h_kv, h // h_kv, d)
    carry = _fresh(b, h_kv, h // h_kv, sq, d, q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        # the chunk held now originated on rank (me - step) mod n
        src = (me - step) % n
        if not causal or src <= me:
            carry = _osm_update(carry, qg, kv[0], kv[1], scale, me * sq,
                                src * sk, masked=causal)
        if step < n - 1:  # the last chunk's rotation would be wasted
            kv = comm.ppermute(kv, _ring(n, me), group)
    out, nblk = _finish(carry, b, sq, h, d)
    if group is not None:
        out = _keep_chain(out, kv)
    return out.to(q.dtype), nblk


def _zigzag_exchange(x, group, n: int, me: int, inverse: bool = False):
    """Contiguous chunks ↔ zigzag stripes. Of the 2n stripes, contiguous
    rank a holds (2a, 2a+1) and zigzag rank r holds (r, 2n-1-r); two
    ``ppermute``s (one per local half) move them. Rope is applied before
    the ring, so a stripe carries its positions with it."""
    half = x.shape[1] // 2

    def t(s: int) -> int:  # zigzag owner of global stripe s
        return s if s < n else 2 * n - 1 - s

    perm_lo = [(a, t(2 * a)) for a in range(n)]
    perm_hi = [(a, t(2 * a + 1)) for a in range(n)]
    even = me % 2 == 0
    if not inverse:
        r_lo = comm.ppermute(x[:, :half], perm_lo, group)
        r_hi = comm.ppermute(x[:, half:], perm_hi, group)
        first, second = (r_lo, r_hi) if even else (r_hi, r_lo)
        return torch.cat([first, second], dim=1)
    first, second = x[:, :half], x[:, half:]
    r_lo, r_hi = (first, second) if even else (second, first)
    lo = comm.ppermute(r_lo, [(d, a) for a, d in perm_lo], group)
    hi = comm.ppermute(r_hi, [(d, a) for a, d in perm_hi], group)
    return torch.cat([lo, hi], dim=1)


def _ring_zigzag(q, k, v, group, scale: float):
    """Causal ring attention on zigzag stripes: of the four (q stripe,
    kv stripe) pairs of a step, head×head runs iff i ≥ j (diagonal
    masked), tail×head always runs unmasked, tail×tail iff j ≥ i, and
    head×tail never attends."""
    n, me = comm._size(group), comm._rank(group)
    b, sq, h, d = q.shape
    if sq % 2:
        raise ValueError(f"zigzag needs an even local seq, got {sq}")
    if k.shape[1] != sq:
        raise ValueError(
            f"zigzag needs equal q/kv seq (stripe boundaries are shared), "
            f"got q={sq} kv={k.shape[1]}; use placement='contiguous'")
    half, h_kv = sq // 2, k.shape[2]
    g = h // h_kv
    qkv = _zigzag_exchange(torch.cat([q, k, v], dim=2), group, n, me)
    q, k, v = qkv.split([h, h_kv, h_kv], dim=2)
    qg = q.reshape(b, sq, h_kv, g, d)
    q1, q2 = qg[:, :half], qg[:, half:]          # stripes me, 2n-1-me
    c1 = _fresh(b, h_kv, g, half, d, q.device)
    c2 = _fresh(b, h_kv, g, half, d, q.device)
    tail = 2 * n - 1 - me
    kv = torch.stack([k, v])
    for step in range(n):
        src = (me - step) % n
        k, v = kv[0], kv[1]
        k1, k2, v1, v2 = k[:, :half], k[:, half:], v[:, :half], v[:, half:]
        if me >= src:
            c1 = _osm_update(c1, q1, k1, v1, scale, me * half, src * half,
                             True)
        c2 = _osm_update(c2, q2, k1, v1, scale, tail * half, src * half,
                         False)
        if src >= me:
            c2 = _osm_update(c2, q2, k2, v2, scale, tail * half,
                             (2 * n - 1 - src) * half, True)
        if step < n - 1:
            kv = comm.ppermute(kv, _ring(n, me), group)
    o1, n1 = _finish(c1, b, half, h, d)
    o2, n2 = _finish(c2, b, half, h, d)
    out = torch.cat([o1, o2], dim=1)
    if group is not None:
        out = _keep_chain(out, kv)
    out = out.to(q.dtype)
    return _zigzag_exchange(out, group, n, me, inverse=True), n1 + n2


def ring_attention(
    q: torch.Tensor,  # (batch, seq/sp, heads, head_dim): this rank's chunk
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    causal: bool = True,
    axis_name: str = "sp",
    with_block_counts: bool = False,
    placement: str = "contiguous",
):
    """Exact attention with the sequence axis sharded over ``axis_name``
    (``mesh`` a parallel.mesh.Mesh, or None for one rank). Batch and
    heads are whatever this rank holds (its dp/fsdp rows, its tp heads).

    ``with_block_counts=True`` also returns the (sp,) tensor of (q, k)
    blocks each ring position computed (zigzag counts half-stripe
    pairs)."""
    if placement not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown placement {placement!r}")
    group = None if mesh is None else mesh.group(axis_name)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if placement == "zigzag":
        if not causal:
            raise ValueError("zigzag placement is for causal attention; "
                             "non-causal has no skew to fix")
        out, nblk = _ring_zigzag(q, k, v, group, scale)
    else:
        out, nblk = _ring_contiguous(q, k, v, group, causal, scale)
    if not with_block_counts:
        return out
    counts = torch.tensor([nblk], dtype=torch.int32, device=q.device)
    return out, comm.gather_nograd(counts, 0, group)
