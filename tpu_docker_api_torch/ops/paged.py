"""Paged KV-cache primitives (counterpart of ``tpu_docker_api/ops/paged.py``).

The dense slot cache holds ``slots × max_seq`` positions a layer whether
or not a request uses them. Paging replaces it with a POOL of fixed-size
pages ``(layers, P, page, kv, head_dim)`` and a per-slot page table
``(S, mp)`` of page ids, so the cache's memory follows the pool (sized to
the live tokens), not slots × capacity.

- **Reads gather pages into a contiguous (S, mp·page, kv, hd) view and
  run the same ``dense_attention`` as the dense cache.** Page j of a slot
  covers positions [j·page, (j+1)·page), so the view is element-identical
  to the dense cache prefix of that length.
- **Page 0 is the trash page.** Unassigned table entries point at it, and
  a write whose column is beyond the table view goes there too: lanes of
  completed requests (decoding garbage until the host processes their
  chunk) and parked chunked-prefill lanes write there harmlessly. Nothing
  reads it unmasked.

The pool is updated IN PLACE (``paged_write`` returns the tensor it was
given), as the dense cache is (models/llama.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class PagedRef:
    """One layer's view of the paged cache: the full pools, this layer's
    index and the dispatch's page table. Routes models/llama.py
    ``_attention`` onto the paged write/read path."""

    k_pool: Any     # (layers, P, page, n_kv_heads, head_dim)
    v_pool: Any
    layer_idx: int
    table: Any      # (S, mp) long page ids; 0 = trash page


def paged_write(pool: torch.Tensor, layer_idx: int, table: torch.Tensor,
                pos: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Scatter one new position per slot into the pool, in place:
    ``pool[layer_idx, table[s, pos[s]//page], pos[s]%page] = new[s]``.
    A position beyond the table view (``pos // page >= mp``) goes to the
    trash page whatever the row holds."""
    page = pool.shape[2]
    mp = table.shape[1]
    col = pos // page
    pid = table.gather(1, col.clamp(0, mp - 1)[:, None])[:, 0]
    pid = torch.where(col < mp, pid, torch.zeros_like(pid))
    pool[layer_idx, pid, pos % page] = new.to(pool.dtype)
    return pool


def gather_pages(pool: torch.Tensor, layer_idx: int,
                 table: torch.Tensor) -> torch.Tensor:
    """(S, mp·page, kv, hd) contiguous copy of each slot's pages for this
    layer — element-identical to the dense cache prefix of length mp·page
    (trash-page content shows only at positions the causal q_offset mask
    excludes)."""
    s, mp = table.shape
    g = pool[layer_idx].index_select(0, table.reshape(-1))
    return g.reshape(s, mp * pool.shape[2], *pool.shape[3:])
