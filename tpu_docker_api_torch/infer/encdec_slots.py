"""Continuous batching for seq2seq: the slot engine of the
encoder-decoder family (counterpart of
``tpu_docker_api/infer/encdec_slots.py``).

A request's encoder-derived cross K/V are computed once at admission
and stay static for its whole decode, so the decoder side reuses the
base engine's slot machinery (per-row positions, K-step chunks, the
pipeline lag, sampling, length-bucketed reads) unchanged; only
admission and the decode body differ:

- **Admission = encode, not prefill.** The sources of a same-bucket row
  group encode at the bucket length with a per-row ``kv_len`` mask
  through every encoder layer (bidirectional attention: unmasked pad
  keys would shift every real position's output), so a bucketed
  admission equals encoding the unpadded source. Each decoder layer's
  cross K/V then drop into the pooled (Ld, S, src_cap, kvh, hd)
  buffers at the slot's row. No token is sampled at admission: decode
  starts from BOS at position 0 (``encdec_generate``'s contract), so a
  ``max_new == 1`` request takes one decode chunk too.
- **Decode** runs ``models.encdec.encdec_slot_decode_step`` each step:
  per-row cache writes (dropped past capacity), per-row causal
  ``q_offset``, the base engine's ``kv_limit`` read buckets (reach is
  chunk-count driven: ``base_len == 0``), and cross-attention against
  the slot's static K/V, masked at its true source length and read only
  up to the smallest source bucket covering every active slot.
- **Prompt buckets are SOURCE buckets**, capped by ``cfg.max_src_len``;
  the decoder cache's capacity (``max_seq``) is ``cfg.max_tgt_len``.

Exactness contract (tests/test_torch_encdec_slots.py): each stream's
tokens equal an isolated greedy ``encdec_generate`` of its source, for
any admission order and slot reuse, in f32 on the CPU.

Scope, as the JAX engine's v1: one device, greedy and temperature /
top-k / top-p sampling, no prefix registry (the cross K/V are each
request's prefix), no chunked prefill, no speculative composition.
"""

from __future__ import annotations

import torch

from tpu_docker_api_torch.infer.slots import (SlotEngine, _default_buckets,
                                              _Slot)
from tpu_docker_api_torch.models.encdec import (EncDecConfig, _cross_kv,
                                                encdec_encode,
                                                encdec_slot_decode_step)
from tpu_docker_api_torch.ops.rope import rope_frequencies


class EncDecSlotEngine(SlotEngine):
    """Slot engine whose requests are (source tokens → generated target):
    ``submit(src_tokens, max_new)``; generation starts from ``bos_id``."""

    def __init__(self, cfg, params, *, bos_id: int = 0, **kwargs):
        if not isinstance(cfg, EncDecConfig):
            raise ValueError(
                "EncDecSlotEngine serves EncDecConfig models; llama/moe "
                "use SlotEngine")
        if kwargs.get("prefill_chunk"):
            raise ValueError(
                "chunked prefill does not apply to seq2seq admission "
                "(sources are bounded by max_src_len)")
        self.bos_id = bos_id
        if not kwargs.get("max_seq"):
            kwargs["max_seq"] = cfg.max_tgt_len
        super().__init__(cfg, params, **kwargs)
        # per-slot true source length, device-resident like _dtemp: the
        # decode step masks the cross reads with it
        self._dsrc = torch.zeros((self.slots,), dtype=torch.long,
                                 device=self.device)
        # and its host copy, which picks each chunk's source read bucket
        self._src_lens = [0] * self.slots
        self._rope = rope_frequencies(cfg.head_dim, self.max_seq,
                                      cfg.rope_theta, device=self.device)
        self._src_view: int | None = None

    # ---- capacity ----------------------------------------------------------

    def _cached_forward(self):
        return None  # decode body: models.encdec.encdec_slot_decode_step

    def _default_buckets(self) -> tuple[int, ...]:
        # prompt buckets bucket the SOURCE, not the decode cache
        return _default_buckets(self.cfg.max_src_len)

    def _check_buckets(self) -> None:
        if self.buckets[-1] > self.cfg.max_src_len:
            raise ValueError(
                f"largest source bucket {self.buckets[-1]} exceeds "
                f"max_src_len {self.cfg.max_src_len}")

    @property
    def src_cap(self) -> int:
        return self.buckets[-1]

    def _alloc_cache(self, cache_dtype):
        """The decoder's self-attention cache (Ld, S, max_seq, kvh, hd),
        and the pooled cross K/V (Ld, S, src_cap, kvh, hd), written once
        an admission."""
        cfg = self.cfg
        Ld, kvh, hd = cfg.dec_layers, cfg.n_kv_heads, cfg.head_dim

        def zeros(length):
            return torch.zeros((Ld, self.slots, length, kvh, hd),
                               dtype=cache_dtype, device=self.device)

        self._ck, self._cv = zeros(self.buckets[-1]), zeros(self.buckets[-1])
        return zeros(self.max_seq), zeros(self.max_seq)

    # ---- request API -------------------------------------------------------

    def validate(self, prompt, max_new, top_k: int = 0,
                 top_p: float = 1.0) -> None:
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if not prompt:
            raise ValueError("source must be non-empty")
        if len(prompt) > self.buckets[-1]:
            raise ValueError(
                f"source ({len(prompt)}) exceeds the largest source "
                f"bucket ({self.buckets[-1]})")
        if max_new > self.max_seq:
            raise ValueError(
                f"max_new ({max_new}) exceeds decoder cache capacity "
                f"{self.max_seq}")

    def register_prefix(self, tokens):
        raise ValueError(
            "the encdec engine has no prefix registry — a request's "
            "cross K/V already fill that role (encoded once, static "
            "for its whole decode)")

    # ---- device programs ---------------------------------------------------

    @torch.no_grad()
    def _prefill(self, bucket, prompts_np, lens, slots_v, temps, topks,
                 topps):
        """Admission of an R-row same-bucket source group: masked encode
        → every decoder layer's cross K/V → the slots' rows of the pooled
        buffers; arms the decode state at (BOS, position 0). Samples no
        token: returns None."""
        lens_t = self._to_device(lens)
        enc_out = encdec_encode(self.params, self._to_device(prompts_np),
                                self.cfg, kv_len=lens_t)
        ck, cv = _cross_kv(self.params, enc_out, self.cfg)
        slots_t = self._to_device(slots_v)
        self._ck[:, slots_t, :bucket] = ck.to(self._ck.dtype)
        self._cv[:, slots_t, :bucket] = cv.to(self._cv.dtype)
        self._arm(slots_t, torch.full_like(slots_t, self.bos_id),
                  torch.zeros_like(slots_t), self._to_device(temps),
                  self._to_device(topks), self._to_device(topps))
        self._dsrc[slots_t] = lens_t
        for slot, n in zip(slots_v, lens):
            self._src_lens[int(slot)] = int(n)
        return None

    def _src_limit_for_chunk(self, snap) -> int | None:
        """Smallest source bucket covering every active slot's true
        source length, or None (the whole pool): every decode step
        re-reads the cross K/V, and positions past each slot's source
        are masked anyway."""
        if not snap:
            return None
        longest = max(self._src_lens[i] for i in snap)
        b = next(b for b in self.buckets if b >= longest)
        return b if b < self.src_cap else None

    def _dispatch_chunk(self) -> None:
        snap = self._decoding()
        self._src_view = self._src_limit_for_chunk(snap)
        limit = self._kv_limit_for_chunk(snap)
        self._launch_chunk(snap, limit, limit is not None)

    def _forward_step(self, tok, pos, view):
        ck, cv = self._ck, self._cv
        if self._src_view is not None:
            ck, cv = ck[:, :, :self._src_view], cv[:, :, :self._src_view]
        logits, self._k, self._v = encdec_slot_decode_step(
            self.params, tok, pos, self.cfg, self._k, self._v, ck, cv,
            self._dsrc, *self._rope, kv_limit=view)
        return logits[:, None]

    # ---- admission seams ---------------------------------------------------

    def _new_slot(self, prompt, max_new, temp, eos_id, tk, tp, handle):
        # base_len 0: decode positions start at 0, so the read-bucket
        # reach bound is chunk-count driven; fresh False: the chunk's
        # column 0 is BOS, never an emitted token
        return _Slot(handle=handle, tokens=[], max_new=max_new, pos=0,
                     temperature=temp, eos_id=eos_id, top_k=tk, top_p=tp,
                     base_len=0, fresh=False)

    def _finish_admission_only(self, slot, st, toks, r) -> None:
        pass  # max_new == 1 still takes one decode chunk (BOS → token)
