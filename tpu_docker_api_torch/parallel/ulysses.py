"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding
(counterpart of ``tpu_docker_api/parallel/ulysses.py``).

Activations arrive sequence-sharded on ``sp``. An all-to-all trades the
sequence shards for head shards (each rank gets the whole sequence for
h/sp of its heads), the port's ``multihead_attention`` runs locally, so
on the card it is the flash kernel, and a second all-to-all restores
the sequence sharding. ``comm.all_to_all``'s backward is the inverse
exchange, so gradients flow through both.

Ulysses caps sp at the head count (n_kv_heads/tp for GQA); ring
attention (parallel/ring.py) has no such cap.
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.ops.attention import multihead_attention
from tpu_docker_api_torch.parallel import comm


def ulysses_attention(
    q: torch.Tensor,  # (batch, seq/sp, heads/tp, head_dim): this rank's
    k: torch.Tensor,  # (batch, seq/sp, kv_heads/tp, head_dim)
    v: torch.Tensor,
    mesh,
    causal: bool = True,
    axis_name: str = "sp",
    impl: str = "auto",
) -> torch.Tensor:
    """Exact attention with seq sharded on ``axis_name`` by two
    all-to-alls. The per-rank head counts (after tp) of q AND k/v must
    divide by sp."""
    sp = 1 if mesh is None else mesh.shape[axis_name]
    tp = 1 if mesh is None else mesh.shape["tp"]
    for name, local in (("q", q.shape[2]), ("kv", k.shape[2])):
        if local % sp:
            raise ValueError(
                f"ulysses needs {name} heads/tp divisible by sp: "
                f"heads={local * tp} tp={tp} sp={sp}")
    group = None if mesh is None else mesh.group(axis_name)
    # heads → sequence: each rank then holds every position of h/sp heads.
    # q, k and v go as one tensor, each split in sp head groups, so one
    # all-to-all (and one in the backward) moves all three
    b, s, h, d = q.shape
    h_kv = k.shape[2]

    def groups(x):
        return x.reshape(b, s, sp, x.shape[2] // sp, d)

    qkv = torch.cat([groups(q), groups(k), groups(v)], dim=3)
    qkv = comm.all_to_all(qkv, 2, 1, group)   # (b, s·sp, 1, ·, d)
    qg, kg, vg = qkv[:, :, 0].split([h // sp, h_kv // sp, h_kv // sp],
                                    dim=2)
    out = multihead_attention(qg, kg, vg, causal=causal, impl=impl)
    # sequence → heads: restore the sp-sharded layout
    return comm.all_to_all(out, 1, 2, group)
