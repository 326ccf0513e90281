"""Paged-KV continuous batching: the slot engine over a page pool
(counterpart of ``tpu_docker_api/infer/paged.py``).

The dense :class:`~tpu_docker_api_torch.infer.slots.SlotEngine` holds
``slots × max_seq`` cache positions. This engine replaces them with a
POOL of fixed-size pages (ops/paged.py) and per-slot page lists, so the
cache's memory follows the pool, sized to the live tokens. Everything
else — chunked decode, pipeline lag, admission batching, sampling,
drain — is inherited.

- **Grow-as-you-decode reservation** (default): an admission holds only
  its prefill's pages; each chunk dispatch claims the pages its write
  reach needs (``_ensure_coverage``). When the pool runs dry, the
  lowest-progress slot JUNIOR to the requester (by submit time) is
  preempted with exact restore: its host-resolved tokens go back to the
  deferred queue, in submit order, as ``prompt + carry`` and re-prefill,
  so a greedy continuation is token-identical and the client never sees
  the swap. Seniority is what makes preemption terminate: a junior never
  takes a senior's pages, so the oldest request always progresses.
  ``reservation="full"`` reserves each request's worst case up front.
  Admission is strict FCFS either way: the deferred queue goes first.
- **The page table is a per-dispatch host array**, never device state:
  repaging between dispatches is free. It crosses to the card once a
  dispatch through a fresh pinned buffer (the host allocator keeps a
  buffer until its copy has run), so a later host rewrite of the table
  never reaches a dispatched chunk. Tables are (S, mp) with mp a
  geometric page-count bucket, so decode reads follow the live pages.
- **Frees are immediate; one CUDA stream makes them safe.** A completed
  slot's lane keeps decoding garbage until the host processes that
  chunk, and chunks already dispatched carry tables naming its pages.
  Every pool read and write — prefills, decode chunks, segments and
  prefix builds — is enqueued on the engine's stream (registration goes
  through the engine thread's command queue), so whatever writes a
  reissued page runs after every stale chunk that wrote it. Chunks
  dispatched after the free see the zeroed table row (the trash page).
- **Prefill is unchanged**: the bucket forward runs on a fresh dense temp
  cache as in the dense engine (the flash path), and only the drop into
  the engine's cache becomes a page scatter.

Prefix caching shares REFCOUNTED READ-ONLY PAGES: ``register_prefix``
prefills the prefix once and scatters its first ``floor(P/page)·page``
positions into pool pages that are never written again; an admission
whose prompt extends the prefix gets those page ids at the front of its
table and prefills its unaligned tail and suffix. ``unregister_prefix``
removes the entry at once; its pages return to the pool when the last
reader completes.

Chunked prefill: a segment gathers the slot's pages into a dense temp
row, prefills at its offset and scatters every covered page back; parked
lanes write to the trash page through ``paged_write``'s beyond-view
bound.

Single device, Llama family. Token-exactness carries over from the dense
engine because reads gather pages into a view element-identical to the
dense cache prefix (tests/test_torch_paged.py).
"""

from __future__ import annotations

import bisect
import queue
from typing import Any

import numpy as np
import torch

from tpu_docker_api_torch.infer.engine import init_kv_cache
from tpu_docker_api_torch.infer.slots import ADMIT_RANGE, SlotEngine, _Slot
from tpu_docker_api_torch.models.llama import LlamaConfig, llama_forward_paged
from tpu_docker_api_torch.telemetry.profile import span


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _PagedPrefix:
    """A registered prefix whose aligned K/V lives in shared pool pages.
    ``refs`` counts live reader slots and ``dead`` marks an unregistered
    entry awaiting reclamation (both engine-thread only)."""

    __slots__ = ("pid", "tokens", "length", "shared_len", "page_ids",
                 "refs", "dead", "nbytes")

    def __init__(self, pid, tokens, length, shared_len, page_ids, nbytes):
        self.pid = pid
        self.tokens = tokens          # tuple[int, ...]
        self.length = length          # true token count
        self.shared_len = shared_len  # floor(length/page)*page
        self.page_ids = page_ids      # tuple[int, ...] shared pool pages
        self.nbytes = nbytes          # pool bytes the shared pages pin
        self.refs = 0
        self.dead = False


class PagedSlotEngine(SlotEngine):
    """Slot engine whose KV cache is a page pool. ``total_pages`` sizes
    the pool in usable pages (page 0 is the trash page); the default is
    the dense engine's capacity."""

    def __init__(self, cfg, params, *, page_size: int = 64,
                 total_pages: int | None = None,
                 reservation: str = "grow", **kwargs):
        if not isinstance(cfg, LlamaConfig):
            raise ValueError("the paged engine serves llama-family configs "
                             "only")
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError(
                f"page_size must be a power of two, got {page_size}")
        if reservation not in ("grow", "full"):
            raise ValueError(
                f"reservation must be 'grow' or 'full', got "
                f"{reservation!r}")
        self.page_size = page_size
        self.reservation = reservation
        self._total_pages = total_pages
        super().__init__(cfg, params, **kwargs)
        bad = [b for b in self.buckets if b % page_size]
        if bad:
            # prefill reshapes each row's bucket into bucket//page pages
            raise ValueError(
                f"page_size {page_size} must divide every prefill "
                f"bucket; {bad} are not divisible")
        # bookkeeping (engine-thread only, like the base's _table values)
        self._slot_pages: dict[int, list[int]] = {}
        self._deferred: list = []
        #: the registered prefix each active slot reads (refcount)
        self._slot_prefix: dict[int, _PagedPrefix] = {}
        #: registrations routed to the engine thread: (tokens, reply)
        self._px_cmds: queue.SimpleQueue = queue.SimpleQueue()
        #: unregistered prefixes with live readers
        self._px_zombies: list[_PagedPrefix] = []
        #: original prompt per active slot, a preemption's restore context
        self._slot_prompt: dict[int, list[int]] = {}
        self.stats["pages_total"] = self._usable_pages
        self.stats["pages_free"] = len(self._free)
        self.stats["deferred_admissions"] = 0
        self.stats["grown_pages"] = 0
        self.stats["preemptions"] = 0

    # ---- pool ---------------------------------------------------------------

    @property
    def _max_pages_per_slot(self) -> int:
        return _ceil_div(self.max_seq, self.page_size)

    def _alloc_cache(self, cache_dtype):
        usable = (self._total_pages if self._total_pages is not None
                  else self.slots * self._max_pages_per_slot)
        if usable < 1:
            raise ValueError(f"total_pages must be >= 1, got {usable}")
        self._usable_pages = usable
        # page 0 = trash; the free list pops from the low end
        self._free = list(range(usable, 0, -1))
        self._ptable = np.zeros((self.slots, self._max_pages_per_slot),
                                np.int64)
        # pool rows are pages (usable + trash page 0); page_size is the
        # position dim
        cache = init_kv_cache(self.cfg, usable + 1, self.page_size,
                              dtype=cache_dtype, device=self.device,
                              kv_heads=self._kv_heads)
        return cache.k, cache.v

    def _pages_needed(self, prompt_len: int, max_new: int,
                      bucket: int) -> int:
        # prefill writes [0, bucket); live decode writes up to
        # prompt+max_new-2, and pages cover one position past that (never
        # more than validate()'s prompt+max_new-1 <= max_seq)
        return _ceil_div(max(bucket, prompt_len + max_new - 1),
                         self.page_size)

    def _table_to_device(self, table: np.ndarray) -> torch.Tensor:
        """A page table for one dispatch: on the card through a pinned
        buffer of its own, copied without blocking the host."""
        t = torch.from_numpy(np.array(table, np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ---- request API --------------------------------------------------------

    def validate(self, prompt, max_new, top_k=0, top_p=1.0):
        super().validate(prompt, max_new, top_k=top_k, top_p=top_p)
        prompt = list(prompt)
        # pages pinned by registered prefixes never return while they are
        # registered: a request needing more than usable-minus-pinned can
        # never admit, and (strict FCFS) would hang everything behind it
        pinned = self._pinned_pages()
        plan = self._px_plan(prompt)
        if (plan is None and self._prompt_bucket(prompt) is None
                and not self.prefill_chunk):
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the largest "
                f"prefill bucket ({self.buckets[-1]}) and no "
                f"registered prefix covers it")
        need = self._worst_case_need(prompt, max_new, plan=plan)
        if need > self._usable_pages - pinned:
            raise ValueError(
                f"request needs {need} pages "
                f"({len(prompt)}+{max_new} tokens at page size "
                f"{self.page_size}); the pool has {self._usable_pages}"
                f" with {pinned} pinned by registered prefixes")

    def _prompt_bucket(self, prompt: list[int]) -> int | None:
        return next((b for b in self.buckets if b >= len(prompt)), None)

    _PLAN_UNSET = object()

    def _worst_case_need(self, prompt: list[int], max_new: int,
                         plan=_PLAN_UNSET) -> int:
        """Pool pages the request needs at its worst moment: the one
        can-never-fit criterion of validate(), the post-pin re-check and
        the admission re-check. ``plan`` (None: no prefix applies) skips
        a second registry scan."""
        if plan is PagedSlotEngine._PLAN_UNSET:
            plan = self._px_plan(prompt)
        sfx_len = (len(prompt) - plan[0].shared_len
                   if plan is not None else len(prompt))
        chunked_route = self.prefill_chunk and (
            sfx_len > self.prefill_chunk
            or len(prompt) > self.buckets[-1])
        if chunked_route:
            # segments: no bucket-rounding term
            return _ceil_div(len(prompt) + max_new - 1, self.page_size)
        if plan is not None:
            ent, sbucket = plan
            return self._px_pages_needed(len(prompt), max_new, ent,
                                         sbucket)
        bucket = self._prompt_bucket(prompt)
        if bucket is None:
            return _ceil_div(len(prompt) + max_new - 1, self.page_size)
        return self._pages_needed(len(prompt), max_new, bucket)

    # ---- prefix cache (shared pages) ----------------------------------------

    def register_prefix(self, tokens) -> str:
        """Prefill ``tokens`` once into SHARED pool pages. With the engine
        thread running, the work goes through its command queue, so the
        pool writes are ordered with every other pool program; directly
        otherwise (before :meth:`start`, or when the caller steps). A
        mirrored engine registers on every rank at its next step."""
        tokens = list(tokens)
        if self._mirror is not None:
            return self._mirror.call(self, "register", tokens)
        if self._thread is None:
            return self._do_register_prefix(tokens)
        reply: queue.SimpleQueue = queue.SimpleQueue()
        with self._lock:
            if self._closed or self._draining:
                raise RuntimeError("engine is closed")
            if self._dead is not None:
                raise RuntimeError(f"engine failed: {self._dead!r}")
            self._px_cmds.put((tokens, reply))
        self._wake.set()
        ok, val = reply.get(timeout=600)
        if not ok:
            raise val
        return val

    def _op_register(self, tokens: list[int]) -> str:
        return self._do_register_prefix(tokens)

    def _do_register_prefix(self, tokens: list[int]) -> str:
        """Engine-thread half of registration: registry checks, page
        allocation, one prefill and the aligned-page scatter."""
        with self._px_lock, self._on_stream():
            return self._do_register_prefix_locked(tokens)

    def _do_register_prefix_locked(self, tokens: list[int]) -> str:
        page = self.page_size
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if len(tokens) < page:
            raise ValueError(
                f"prefix ({len(tokens)} tokens) is shorter than one page "
                f"({page}) — nothing can be shared read-only; lower "
                f"page_size or use the dense SlotEngine")
        if len(tokens) + 2 > self.max_seq:
            raise ValueError(
                f"prefix ({len(tokens)}) leaves no room for a suffix and "
                f"a generated token in cache capacity {self.max_seq}")
        bucket = next((b for b in self.buckets if b >= len(tokens)), None)
        if bucket is None:
            raise ValueError(
                f"prefix ({len(tokens)}) exceeds the largest prefill "
                f"bucket ({self.buckets[-1]})")
        npx = len(tokens) // page
        key = tuple(tokens)
        with self._lock:
            for ent in self._prefixes.values():
                if ent.tokens == key:
                    return ent.pid
            if len(self._prefixes) >= self.max_prefixes:
                raise ValueError(
                    f"prefix registry full ({self.max_prefixes}) — "
                    f"unregister one first")
            nbytes = (2 * self.cfg.n_layers * npx * page
                      * self.cfg.n_kv_heads * self.cfg.head_dim
                      * self._k.element_size())
            if (self.max_prefix_bytes
                    and self.stats["prefix_bytes"] + nbytes
                    > self.max_prefix_bytes):
                raise ValueError(
                    f"prefix pages ({nbytes} B) would exceed the "
                    f"registry byte budget ({self.max_prefix_bytes} B; "
                    f"{self.stats['prefix_bytes']} B registered) — "
                    f"unregister one first")
            self._px_seq += 1
            pid = f"px-{self._px_seq}"
        if npx > len(self._free):
            raise ValueError(
                f"prefix needs {npx} pages; only {len(self._free)} free "
                f"in the pool")
        pages = [self._free.pop() for _ in range(npx)]
        prompt = np.full((1, bucket), self.pad_id, np.int64)
        prompt[0, :len(tokens)] = tokens
        self._px_build(bucket, prompt, pages)
        ent = _PagedPrefix(pid=pid, tokens=key, length=len(tokens),
                           shared_len=npx * page, page_ids=tuple(pages),
                           nbytes=nbytes)
        with self._lock:
            self._prefixes[pid] = ent
            self.stats["prefix_bytes"] += nbytes
        self.stats["pages_free"] = len(self._free)
        # pinning shrank the pool for as long as the prefix is registered:
        # a live request whose worst-case need no longer fits can never
        # complete (grow mode would self-preempt forever, strict FCFS
        # would wedge behind it), so it fails now, as submit() would
        self._fail_unfittable_after_pin()
        return pid

    def _pin_err(self, need: int, capacity: int, pinned: int) -> ValueError:
        return ValueError(
            f"registered prefixes pinned pool pages: this request "
            f"needs {need} pages but at most {capacity} can ever be "
            f"free ({pinned} pinned by registered prefixes) — it could "
            f"never be scheduled again")

    def _pinned_pages(self) -> int:
        with self._lock:
            return sum(len(e.page_ids) for e in self._prefixes.values())

    def _release_slot(self, slot: int) -> list[int]:
        """Tear one active slot down (table row cleared, private pages
        back to the pool, prefix ref dropped) and return its ORIGINAL
        prompt; the caller decides the request's fate."""
        with self._lock:
            self._table[slot] = None
        self._free.extend(self._slot_pages.pop(slot, []))
        self._ptable[slot, :] = 0
        ent = self._slot_prefix.pop(slot, None)
        if ent is not None:
            ent.refs -= 1
        self.stats["pages_free"] = len(self._free)
        return self._slot_prompt.pop(slot, [])

    def _fail_unfittable_after_pin(self) -> None:
        page = self.page_size
        pinned = self._pinned_pages()
        capacity = self._usable_pages - pinned
        for i in sorted(list(self._table)):
            st = self._table.get(i)
            if st is None:
                continue
            shared = (len(self._slot_prefix[i].page_ids)
                      if i in self._slot_prefix else 0)
            # the slot's decode peak (_ensure_coverage's cap), less its
            # read-only shared pages
            peak = st.base_len + (st.max_new - st.preseed) - 1
            need = _ceil_div(max(peak, 1), page) - shared
            if need > capacity:
                self._release_slot(i)
                st.handle._fail(self._pin_err(need, capacity, pinned))
        kept = []
        for req in self._deferred:
            prompt, max_new = req[0], req[1]
            carry = req[7] if len(req) == 8 else []
            need = self._worst_case_need(list(prompt),
                                         max_new - len(carry))
            if need > capacity:
                req[6]._fail(self._pin_err(need, capacity, pinned))
            else:
                kept.append(req)
        self._deferred = kept

    def _op_unregister(self, pid: str) -> bool:
        """Remove from the registry (no new admission attaches); the
        shared pages return once the last live reader completes."""
        with self._px_lock, self._lock:
            ent = self._prefixes.pop(pid, None)
            if ent is None:
                return False
            ent.dead = True
            self.stats["prefix_bytes"] -= ent.nbytes
            self._px_zombies.append(ent)
        if self._thread is None:
            self._reclaim_zombies()
        return True

    def _reclaim_zombies(self) -> None:
        """Free dead prefixes' pages once refs == 0 (engine thread). Under
        ``_lock``, which ``unregister_prefix`` holds while it appends: a
        zombie added between this scan and its write-back would be lost,
        its pages with it."""
        with self._lock:
            live = []
            for ent in self._px_zombies:
                if ent.refs == 0:
                    self._free.extend(ent.page_ids)
                    self.stats["pages_free"] = len(self._free)
                else:
                    live.append(ent)
            self._px_zombies = live

    def _drain_px_cmds(self, err: Exception | None = None) -> None:
        """Run (or fail, if ``err``) queued registrations."""
        while True:
            try:
                tokens, reply = self._px_cmds.get_nowait()
            except queue.Empty:
                return
            if err is not None:
                reply.put((False, RuntimeError(f"engine failed: {err!r}")
                           if not isinstance(err, RuntimeError) else err))
                continue
            try:
                reply.put((True, self._do_register_prefix(tokens)))
            except Exception as e:  # noqa: BLE001 — registry and pool
                reply.put((False, e))  # errors belong to the caller

    def _px_plan(self, prompt: list[int]):
        """(prefix, suffix_bucket) when a registered prefix applies. The
        suffix starts at the ALIGNED shared length: the unaligned tail
        re-prefills with the suffix (read-only sharing's price)."""
        ent = self._resolve_prefix(prompt)
        if ent is None:
            return None
        sbucket = next((b for b in self.buckets
                        if b >= len(prompt) - ent.shared_len), None)
        if sbucket is None:
            return None
        return ent, sbucket

    def _sfx_pages(self, npx: int, sbucket: int) -> int:
        """Scatter pages of a suffix prefill: the bucket's pages, cut to
        the table row (the cut region is pad past capacity)."""
        return min(sbucket // self.page_size,
                   self._max_pages_per_slot - npx)

    def _px_pages_needed(self, prompt_len: int, max_new: int,
                         ent: _PagedPrefix, sbucket: int) -> int:
        """PRIVATE pages an admission against ``ent`` must reserve: the
        suffix scatter and the decode reach past the shared region."""
        npx = len(ent.page_ids)
        reach_pages = _ceil_div(prompt_len + max_new - 1, self.page_size)
        return max(self._sfx_pages(npx, sbucket), reach_pages - npx)

    def _admit_need(self, prompt_len: int, max_new: int, bucket: int,
                    ent: _PagedPrefix | None) -> int:
        """Pages an admission holds before its prefill: the worst case
        (``full``), or only the prefill's scatter destinations (``grow``:
        decode pages are claimed a chunk at a time)."""
        if ent is not None:
            if self.reservation == "full":
                return self._px_pages_needed(prompt_len, max_new, ent,
                                             bucket)
            return self._sfx_pages(len(ent.page_ids), bucket)
        if self.reservation == "full":
            return self._pages_needed(prompt_len, max_new, bucket)
        return bucket // self.page_size

    # ---- growth + preemption ------------------------------------------------

    def _ensure_coverage(self, snap: dict) -> None:
        """Grow mode: before a chunk dispatches, every active slot's
        pages must cover the chunk's write reach (capped at the request's
        own need). When the pool runs dry, a junior slot is preempted
        (host-known tokens are the exact restore context), or the
        requester itself when it is the junior-most. Preempted entries of
        ``snap`` become None in place."""
        if self.reservation != "grow":
            return
        page = self.page_size
        for i in sorted(snap):
            st = snap.get(i)
            if st is None or self._table.get(i) is not st:
                continue  # preempted by an earlier slot's growth
            shared = (len(self._slot_prefix[i].page_ids)
                      if i in self._slot_prefix else 0)
            target = min(
                st.base_len + (st.dispatched + 1) * self.chunk,
                st.base_len + (st.max_new - st.preseed) - 1)
            need = (_ceil_div(target, page) - shared
                    - len(self._slot_pages[i]))
            while need > len(self._free):
                victim = self._pick_victim(snap, st)  # junior decoders
                if victim is None:
                    victim = self._junior_prefiller(st)
                    if victim is not None:
                        self._preempt(victim, self._table[victim])
                        continue
                    # no junior holds pages: self-preempt (an ungrowable
                    # slot must not dispatch — its writes past its pages
                    # would land in the trash page) and wait at the
                    # deferred queue for a senior to finish
                    self._preempt(i, st)
                    snap[i] = None
                    break
                self._preempt(victim, snap[victim])
                snap[victim] = None
            if snap.get(i) is None or need <= 0:
                continue
            pages = [self._free.pop() for _ in range(need)]
            row = self._ptable[i]
            start = shared + len(self._slot_pages[i])
            row[start:start + need] = pages
            self._slot_pages[i].extend(pages)
            self.stats["grown_pages"] += need
            self.stats["pages_free"] = len(self._free)

    def _junior_prefiller(self, st) -> int | None:
        """The most junior PREFILLING slot younger than ``st``'s request
        that holds pages, or None (nothing emitted: its restore is the
        admission request)."""
        mine = st.handle.submitted_at or 0.0
        cands = {j: s for j, s in self._table.items()
                 if s is not None and s.pending is not None
                 and s is not st
                 and (s.handle.submitted_at or 0.0) > mine
                 and self._slot_pages.get(j)}
        if not cands:
            return None
        return max(cands,
                   key=lambda j: cands[j].handle.submitted_at or 0.0)

    def _pick_victim(self, snap: dict, requester=None) -> int | None:
        """Preemption victim: among slots junior to the requester, the
        lowest host-known progress (cheapest restore), preferring slots
        whose restored prompt still fits a prefill bucket. None when no
        junior exists."""
        mine = (0.0 if requester is None
                else requester.handle.submitted_at or 0.0)
        live = [j for j, s in snap.items()
                if s is not None and self._table.get(j) is s
                and (requester is None
                     or (s.handle.submitted_at or 0.0) > mine)]
        if not live:
            return None
        big = self.buckets[-1]

        def restorable(j):
            return (self.prefill_chunk
                    or len(self._slot_prompt[j]) + len(snap[j].tokens)
                    <= big)

        fits = [j for j in live if restorable(j)]
        pool = fits or live
        return min(pool, key=lambda j: (len(snap[j].tokens), -j))

    def _preempt(self, slot: int, st) -> None:
        """Exact-restore preemption: free the slot's private pages and
        put the request back into the deferred queue IN SUBMIT ORDER with
        its host-resolved tokens carried (restore context = prompt +
        carry). Outstanding chunks naming this slot are skipped by the
        processing loop's identity check."""
        orig = self._release_slot(slot)
        carry = list(st.tokens)
        key = st.handle.submitted_at or 0.0
        idx = bisect.bisect_left(
            [r[6].submitted_at or 0.0 for r in self._deferred], key)
        self._deferred.insert(
            idx, (orig + carry, st.max_new, st.temperature, st.eos_id,
                  st.top_k, st.top_p, st.handle, carry))
        self.stats["preemptions"] += 1

    # ---- device programs ----------------------------------------------------

    def _scatter_pages(self, page_ids, kc, vc) -> None:
        """Write (layers, n·page, kv, hd)-shaped rows of a temp cache into
        pool pages ``page_ids`` (n distinct ids, row-major)."""
        cfg, page = self.cfg, self.page_size
        ids = self._to_device(np.asarray(page_ids, np.int64).reshape(-1))
        shape = (cfg.n_layers, ids.numel(), page, self._kv_heads,
                 cfg.head_dim)
        self._k[:, ids] = kc.reshape(shape)
        self._v[:, ids] = vc.reshape(shape)

    def _gather_row(self, page_ids) -> tuple:
        """Pool pages ``page_ids`` as one dense (layers, 1, n·page, kv,
        hd) row pair."""
        cfg = self.cfg
        ids = self._to_device(np.asarray(page_ids, np.int64))
        shape = (cfg.n_layers, 1, ids.numel() * self.page_size,
                 self._kv_heads, cfg.head_dim)
        return self._k[:, ids].reshape(shape), self._v[:, ids].reshape(shape)

    @torch.no_grad()
    def _prefill_paged(self, bucket, prompts_np, lens, slots_v, page_ids,
                       temps, topks, topps) -> torch.Tensor:
        """Batched prefill: the dense engine's forward on a fresh temp
        cache, then a page SCATTER of each row's bucket into the
        host-assigned ``page_ids`` (rows, bucket//page)."""
        kc, vc = self._temp_cache(len(slots_v), bucket)
        toks, lens_t, *samp = self._first_tokens(prompts_np, lens, temps,
                                                 topks, topps, kc, vc, 0)
        self._scatter_pages(page_ids, kc, vc)
        self._arm(self._to_device(slots_v), toks, lens_t, *samp)
        return toks

    @torch.no_grad()
    def _px_build(self, bucket: int, prompt_np, pages: list[int]) -> None:
        """Registration: one-row prefill on a dense temp cache, then the
        first ``len(pages)`` ALIGNED pages scattered into the pool. The
        unaligned tail and pad are not stored: admissions re-prefill
        them."""
        k, v = self._build_prefix(bucket, prompt_np)
        n = len(pages) * self.page_size
        self._scatter_pages(pages, k[:, :n], v[:, :n])

    @torch.no_grad()
    def _px_prefill_paged(self, ent: _PagedPrefix, sbucket, prompts_np,
                          lens, slots_v, page_ids, temps, topks,
                          topps) -> torch.Tensor:
        """Suffix-only prefill against shared pages: the prefix's aligned
        K/V are gathered from the pool into the temp cache, the suffix
        forward runs at position ``shared_len``, and ONLY the suffix's
        pages are scattered (into the admission's private pages)."""
        R = len(slots_v)
        P_ = ent.shared_len
        nsp = self._sfx_pages(len(ent.page_ids), sbucket)
        kc, vc = self._temp_cache(R, P_ + sbucket)
        pk, pv = self._gather_row(ent.page_ids)
        kc[:, :, :P_] = pk
        vc[:, :, :P_] = pv
        starts = torch.full((R,), P_, dtype=torch.long, device=self.device)
        toks, lens_t, *samp = self._first_tokens(prompts_np, lens, temps,
                                                 topks, topps, kc, vc, starts)
        span = slice(P_, P_ + nsp * self.page_size)
        self._scatter_pages(page_ids, kc[:, :, span], vc[:, :, span])
        self._arm(self._to_device(slots_v), toks, P_ + lens_t, *samp)
        return toks

    def _forward_step(self, tok, pos, view):
        logits, self._k, self._v = llama_forward_paged(
            self.params, tok[:, None], self.cfg, self._k, self._v, view,
            pos, max_pos=self.max_seq, mesh=self.mesh)
        return logits

    # ---- engine loop --------------------------------------------------------

    def _mp_bucket(self, pages: int) -> int:
        """Geometric (power-of-two) page-count bucket covering ``pages``,
        capped at the per-slot maximum."""
        cap = self._max_pages_per_slot
        b = 1
        while b < pages and b < cap:
            b *= 2
        return min(b, cap)

    def _dispatch_segments(self) -> bool:
        """The base engine's one-segment-per-step rotation, with page
        coverage claimed before each segment. A dry pool preempts a
        junior decoder, else a junior prefiller; when only seniors hold
        pages the segment waits, stalling only its own stream."""
        nxt = self._next_segment()
        if nxt is None:
            return False
        i, st, seg, final, bucket = nxt
        page = self.page_size
        p_need = _ceil_div(st.prefill_pos + len(seg), page)
        missing = p_need - len(self._slot_pages[i])
        while missing > len(self._free):
            decoding = self._decoding()
            victim = self._pick_victim(decoding, st)
            if victim is not None:
                self._preempt(victim, decoding[victim])
                continue
            victim = self._junior_prefiller(st)
            if victim is None:
                return True  # seniors hold the pool: wait my turn
            self._preempt(victim, self._table[victim])
        if missing > 0:
            pages = [self._free.pop() for _ in range(missing)]
            row = self._ptable[i]
            start = len(self._slot_pages[i])
            row[start:start + missing] = pages
            self._slot_pages[i].extend(pages)
            self.stats["grown_pages"] += missing
            self.stats["pages_free"] = len(self._free)
        mp = self._mp_bucket(p_need)
        row = self._ptable[i, :mp].copy()
        tokens_np = np.full((1, bucket), self.pad_id, np.int64)
        tokens_np[0, :len(seg)] = seg
        kr, vr = self._gather_row(row)
        # park past any dispatch view: interleaved decode chunks' writes
        # for this lane go to the trash page (max_seq itself is not safe
        # when it is not page-aligned)
        toks = self._seg_prefill(kr, vr, i, st, tokens_np, len(seg), final,
                                 None, self._max_pages_per_slot * page)
        self._scatter_pages(row, kr, vr)
        self._segment_done(i, st, seg, final, toks)
        return True

    def _admit(self) -> bool:
        """Admission with page reservation, strict FCFS: the deferred
        queue (requests the pool could not cover, preemption restores)
        goes first, and one blocked request blocks everything behind it.
        Prompts extending a registered prefix reserve only private pages
        and group per (prefix, suffix bucket)."""
        free_slots = [i for i, s in self._table.items() if s is None]
        batch = self._deferred
        self._deferred = []
        n_redeferred = len(batch)  # re-attempts don't re-count in stats
        while len(batch) < len(free_slots):
            try:
                batch.append(self._take_request())
            except queue.Empty:
                break
        if not batch:
            return False
        # 8-tuples: preemption restores carry their emitted tokens
        batch = [r if len(r) == 8 else (*r, []) for r in batch]
        ok: list[tuple[Any, Any, int, list[int]]] = []
        blocked = False
        chunked_admitted = False
        pinned = self._pinned_pages()
        capacity = self._usable_pages - pinned
        for idx, req in enumerate(batch):
            prompt, max_new = req[0], req[1]
            plan = self._px_plan(prompt)
            # can-never-fit re-check: a prefix registered after submit
            # may have pinned this request's headroom away
            need = self._worst_case_need(list(prompt),
                                         max_new - len(req[7]), plan=plan)
            if need > capacity:
                req[6]._fail(self._pin_err(need, capacity, pinned))
                continue
            if plan is not None and self.prefill_chunk and (
                    len(prompt) - plan[0].shared_len
                    > self.prefill_chunk):
                plan = None  # a long suffix segments (the base's rule)
            if plan is None and self.prefill_chunk and (
                    len(prompt) > self.prefill_chunk
                    or len(prompt) > self.buckets[-1]):
                # chunked prefill: the slot is reserved now; segments
                # claim pages as they dispatch (full mode pins the whole
                # need here)
                need = (0 if self.reservation == "grow" else _ceil_div(
                    len(prompt) + max_new - 1, self.page_size))
                if blocked or not free_slots or need > len(self._free):
                    if idx >= n_redeferred:
                        self.stats["deferred_admissions"] += 1
                    blocked = True
                    self._deferred.append(req)
                    continue
                pages = [self._free.pop() for _ in range(need)]
                (prompt, max_new, temp, eos_id, tk, tp, handle,
                 carry) = req
                handle._admitted()
                slot = free_slots.pop()
                st = _Slot(handle=handle, tokens=list(carry),
                           max_new=max_new, pos=len(prompt),
                           temperature=temp, eos_id=eos_id, top_k=tk,
                           top_p=tp, base_len=len(prompt),
                           preseed=len(carry), pending=list(prompt))
                self._slot_pages[slot] = pages
                self._ptable[slot, :len(pages)] = pages
                self._slot_prompt[slot] = (
                    prompt[:len(prompt) - len(carry)] if carry
                    else prompt)
                self.stats["pages_free"] = len(self._free)
                with self._lock:
                    self._table[slot] = st
                chunked_admitted = True
                continue
            if plan is not None:
                ent, bucket = plan
            else:
                ent = None
                bucket = self._prompt_bucket(prompt)
                if bucket is None:
                    # past validate() through a prefix unregistered since,
                    # or a restore whose prompt+progress outgrew the
                    # buckets: fail the handle, not the engine loop
                    req[6]._fail(ValueError(
                        f"prompt ({len(prompt)}) exceeds the largest "
                        f"prefill bucket and no registered prefix "
                        f"covers it"))
                    continue
            need = self._admit_need(len(prompt), max_new, bucket, ent)
            if (not blocked and len(ok) < len(free_slots)
                    and need <= len(self._free)):
                pages = [self._free.pop() for _ in range(need)]
                ok.append((req, ent, bucket, pages))
            else:
                if idx >= n_redeferred:
                    self.stats["deferred_admissions"] += 1
                blocked = True
                self._deferred.append(req)
        self.stats["pages_free"] = len(self._free)
        if not ok:
            return chunked_admitted
        groups: dict[tuple, list] = {}
        for req, ent, bucket, pages in ok:
            # the entry itself rides the key (identity hash): hits on
            # different prefixes never merge
            groups.setdefault((ent, bucket), []).append((req, pages))
        for (ent, bucket), items in groups.items():
            shared = len(ent.page_ids) if ent is not None else 0
            plen = ent.shared_len if ent is not None else 0
            npg = (self._sfx_pages(shared, bucket) if ent is not None
                   else bucket // self.page_size)
            while items:
                R = 1
                while R * 2 <= len(items) and R * 2 <= self.slots:
                    R *= 2
                grp, items = items[:R], items[R:]
                slots_v = [free_slots.pop() for _ in grp]
                prompts_np = np.full((R, bucket), self.pad_id, np.int64)
                lens = np.empty((R,), np.int64)
                temps = np.empty((R,), np.float32)
                topks = np.empty((R,), np.int64)
                topps = np.empty((R,), np.float32)
                page_ids = np.zeros((R, npg), np.int64)
                for r, ((prompt, _mn, temp, _eos, tk, tp, _h, _c),
                        pages) in enumerate(grp):
                    sfx = prompt[plen:]
                    prompts_np[r, :len(sfx)] = sfx
                    lens[r] = len(sfx)
                    temps[r], topks[r], topps[r] = temp, tk, tp
                    page_ids[r] = pages[:npg]
                    row = self._ptable[slots_v[r]]
                    row[:] = 0
                    if ent is not None:
                        row[:shared] = ent.page_ids
                    row[shared:shared + len(pages)] = pages
                slots_np = np.asarray(slots_v, np.int64)
                for req, _pages in grp:
                    req[6]._admitted()
                if ent is None:
                    toks = self._prefill_paged(bucket, prompts_np, lens,
                                               slots_np, page_ids, temps,
                                               topks, topps)
                else:
                    toks = self._px_prefill_paged(ent, bucket, prompts_np,
                                                  lens, slots_np, page_ids,
                                                  temps, topks, topps)
                    self.stats["prefix_hits"] += R
                self.stats["prefills"] += 1
                for r, ((prompt, max_new, temp, eos_id, tk, tp,
                         handle, carry), pages) in enumerate(grp):
                    # a restore re-seeds its emitted tokens directly (NOT
                    # through emit: the client has them already)
                    st = _Slot(handle=handle, tokens=list(carry),
                               max_new=max_new,
                               pos=len(prompt), temperature=temp,
                               eos_id=eos_id, top_k=tk, top_p=tp,
                               base_len=len(prompt), preseed=len(carry))
                    self._slot_pages[slots_v[r]] = pages
                    self._slot_prompt[slots_v[r]] = (
                        prompt[:len(prompt) - len(carry)] if carry
                        else prompt)
                    if ent is not None:
                        ent.refs += 1
                        self._slot_prefix[slots_v[r]] = ent
                    with self._lock:
                        self._table[slots_v[r]] = st
                    if max_new - len(carry) <= 1:
                        self._emit_first(slots_v[r], st, toks[r])
        return True

    def _dispatch_chunk(self) -> None:
        snap = self._decoding()
        # grow mode: claim this chunk's pages (fresh admissions too); may
        # preempt, so preempted entries drop out before the dispatch
        self._ensure_coverage(snap)
        snap = {i: s for i, s in snap.items()
                if s is not None and self._table.get(i) is s}
        if not snap:
            return
        bound = self._reach_bound(snap, self.chunk)
        mp = self._mp_bucket(_ceil_div(bound, self.page_size))
        self._launch_chunk(snap, self._table_to_device(self._ptable[:, :mp]),
                           mp < self._max_pages_per_slot)

    def _finish_if_done(self, slot: int, st) -> bool:
        done = super()._finish_if_done(slot, st)
        if done:
            # immediate reuse is safe: one stream orders every pool
            # program (module docstring)
            self._free.extend(self._slot_pages.pop(slot, []))
            self._ptable[slot, :] = 0
            self._slot_prompt.pop(slot, None)
            ent = self._slot_prefix.pop(slot, None)
            if ent is not None:
                ent.refs -= 1  # a dead entry's pages reclaim in step()
            self.stats["pages_free"] = len(self._free)
        return done

    def step(self) -> bool:
        # registrations from other threads run here, on the engine's
        # stream, in order with every other pool program
        self._drain_px_cmds()
        # grow mode: existing slots' next-chunk pages outrank the new
        # admissions the base step is about to make
        if self.reservation == "grow":
            self._ensure_coverage(self._decoding())
        did = super().step()
        if self._px_zombies:
            self._reclaim_zombies()
        # deferred requests are invisible to the base loop's pending
        # check; completions processed above may have freed pages
        if self._deferred and not self._closed:
            with span(ADMIT_RANGE):
                did = self._admit() or did
        return did

    def _fail_deferred(self, err: Exception) -> None:
        """Deferred handles are invisible to the base engine's _die and
        close drains: they fail with everything else."""
        deferred, self._deferred = self._deferred, []
        for req in deferred:
            req[6]._fail(err)  # the handle is index 6 in 7- and 8-tuples

    def _die(self, err: Exception) -> None:
        super()._die(err)
        self._fail_deferred(RuntimeError(f"engine failed: {err!r}"))
        self._drain_px_cmds(err)

    def close(self, drain: float = 0.0) -> None:
        super().close(drain)
        self._fail_deferred(RuntimeError("engine closed"))
        self._drain_px_cmds(RuntimeError("engine closed"))
