"""Continuous-batching ("slot") serving engine (counterpart of
``tpu_docker_api/infer/slots.py``), and its speculative variant
(:class:`SpeculativeSlotEngine`).

N request streams share one card through a fixed-capacity KV cache of
S slots ``(layers, S, max_seq, kv, head_dim)``, allocated once. A request
is admitted into a free slot and the slot is recycled when it completes.

- **Per-slot positions**: each slot sits at its own sequence length, so
  decode runs the per-row cached forward (per-row cache write, per-row
  causal mask) and the whole batch decodes in lockstep.
- **Right-padded, batched prefill**: same-bucket admissions run as
  power-of-two row groups through ONE forward into a fresh cache exactly
  one bucket long, starting at position 0 — causal self-attention over
  the prompts' own k/v, which runs through the flash kernel
  (models/llama.py). Garbage k/v at padded positions sits at FUTURE
  positions of the slot; the causal mask never attends a position
  ``> pos``, and decode overwrites position p before any query can see
  it. The first token is sampled at each row's ``actual_len - 1``.
- **Prefix caching**: :meth:`register_prefix` prefills a shared prompt
  prefix once (the flash path) into a (layers, pbucket, kv, head_dim)
  pair; admission matches the longest registered strict prefix of each
  prompt and prefills only the suffix, at the prefix's length, through
  ``dense_attention``'s offset mask.
- **Chunked prefill** (``prefill_chunk``): a long prompt admits in
  segments, one per engine step between decode chunks, so a long
  admission stalls the streams already decoding by one segment's
  compute at a time. A segment writes the slot's own cache row at its
  offset; until the final one the slot's decode lane is parked at
  position ``max_seq``, where its writes are dropped.
- **Device-resident chunk chaining**: per-slot decode inputs (token,
  position, temperature, top-k, top-p) are device tensors that each
  K-step decode chunk consumes and updates, so chunks are enqueued back
  to back with no host round-trip. The host reads a chunk's tokens
  ``pipeline`` chunks later: the chunk's output is copied into pinned
  host memory without blocking and a CUDA event marks its arrival.
- **RNG on the device**: one device ``torch.Generator``, reseeded from a
  host counter at every dispatch — deterministic in the engine seed.
  Greedy rows are a plain argmax; temperature rows are Gumbel-argmax
  (an exact categorical draw), so mixed rows share one chunk. The
  top-k/top-p variant (a per-step (S, vocab) sort) runs only while a
  filtered slot is active.
- **Length-bucketed decode reads**: each chunk attends only the cache
  prefix (``kv_limit``) that any active slot can reach, derived from
  dispatch counts so the pipeline lag never under-reads.
- **One CUDA stream orders all device work**: the engine thread
  (:meth:`start`) or the caller of :meth:`step` dispatches on the
  engine's stream, and so does a prefix registration made from another
  thread (:meth:`register_prefix`): its K/V are enqueued before the
  entry is visible, so an admission that reads them runs after they are
  written. ``submit`` only queues.

Correctness contract (tests/test_torch_engine.py,
tests/test_torch_slots_depth.py): per-stream greedy outputs are
token-exact against ``make_generate_fn`` on the same prompt, for any
admission order and slot reuse, through prefixes and segments, in f32 on
the CPU.

A slot that completes mid-chunk keeps decoding garbage until the host
processes that chunk; its writes land in its own row, and positions past
capacity are dropped (models/llama.py ``_write_cache``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from tpu_docker_api_torch.infer.engine import init_kv_cache
from tpu_docker_api_torch.infer.sampling import gumbel
from tpu_docker_api_torch.models import cached_forward_fn
from tpu_docker_api_torch.telemetry.profile import span

#: profiler ranges of an engine iteration (:meth:`SlotEngine.step`):
#: admission with its prefills and segments, one decode chunk's dispatch
#: (the kv-limit choice through its kernels to the pinned copy and its
#: event), and one chunk's hand-off (the event wait, then its tokens to
#: the streams)
ADMIT_RANGE = "SlotEngine.admit"
DECODE_LAUNCH_RANGE = "SlotEngine.decode_launch"
PROCESS_RANGE = "SlotEngine.process"


def _default_buckets(max_seq: int) -> tuple[int, ...]:
    """Power-of-two prefill buckets from 32 up to max_seq (inclusive)."""
    out = []
    b = 32
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


@dataclasses.dataclass
class Handle:
    """Per-request future. ``result()`` blocks until the request completes
    and returns {"tokens": [...], "length": n} (tokens truncated at eos,
    inclusive). Streaming requests (``submit(stream=True)``) also expose
    :meth:`stream`, an iterator of tokens as the engine resolves them."""

    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    _result: dict | None = None
    _error: Exception | None = None
    _stream: queue.SimpleQueue | None = None
    #: perf_counter() at completion, at submit, at the first admission
    #: into a slot (before its prefill is dispatched), and at the first
    #: host-resolved token (what a streaming client sees as TTFT)
    completed_at: float | None = None
    submitted_at: float | None = None
    admitted_at: float | None = None
    first_token_at: float | None = None

    def result(self, timeout: float | None = None) -> dict:
        if not self._done.wait(timeout):
            raise TimeoutError("request not complete")
        if self._error is not None:
            raise self._error
        return self._result

    def done(self) -> bool:
        return self._done.is_set()

    def stream(self, timeout: float | None = None):
        """Yield tokens as they resolve; raises the engine error (if any)
        at the end, and TimeoutError if ``timeout`` seconds pass without
        a new token."""
        if self._stream is None:
            raise RuntimeError("not a streaming request")
        while True:
            try:
                item = self._stream.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"no token within {timeout}s") from None
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def _complete(self, result: dict) -> None:
        # _done BEFORE the stream sentinel: a consumer unblocking from
        # stream() may immediately call result(0)
        self._result = result
        self.completed_at = time.perf_counter()
        self._done.set()
        if self._stream is not None:
            self._stream.put(None)

    def _admitted(self) -> None:
        """Stamp the first admission: a preempted request that comes back
        keeps it."""
        if self.admitted_at is None:
            self.admitted_at = time.perf_counter()

    def _fail(self, err: Exception) -> None:
        self._error = err
        self._done.set()
        if self._stream is not None:
            self._stream.put(None)


@dataclasses.dataclass
class _Slot:
    handle: Handle
    tokens: list[int]          # emitted so far, host-resolved
    max_new: int
    pos: int                   # host mirror of the cache write position
    temperature: float
    eos_id: int | None = None  # host-side check only
    top_k: int = 0
    top_p: float = 1.0
    fresh: bool = True         # no chunk processed yet: the first chunk's
    #                            column 0 is this slot's prefill token
    base_len: int = 0          # prompt length at admission
    dispatched: int = 0        # chunks dispatched since admission; bounds
    #                            this slot's reachable cache position
    pending: list[int] | None = None  # chunked prefill: prompt tokens not
    #                            prefilled yet; the slot joins decode once
    #                            this drains (None = fully prefilled)
    prefill_pos: int = 0       # next segment's absolute write offset
    preseed: int = 0           # tokens already in ``tokens`` at admission
    #                            (a paged preemption's restore carries them)

    def emit(self, t: int) -> None:
        self.tokens.append(t)
        if self.handle.first_token_at is None:
            self.handle.first_token_at = time.perf_counter()
        if self.handle._stream is not None:
            self.handle._stream.put(t)


class QueueFull(Exception):
    """Admission queue at capacity — callers should shed load (HTTP 503)."""


@dataclasses.dataclass(frozen=True, eq=False)
class _Prefix:
    """A registered prompt prefix with its device-resident K/V pair
    (identity semantics: tensors are never compared elementwise)."""

    pid: str
    tokens: tuple[int, ...]
    length: int                # actual token count
    bucket: int                # padded device length
    k: Any                     # (layers, bucket, n_kv_heads, head_dim)
    v: Any
    nbytes: int = 0            # device bytes both tensors pin


class _Stopped(Exception):
    """Rank 0 stopped a mirrored engine."""


class SlotEngine:
    """Slot-based continuous-batching engine for the decoder families
    (Llama, MoE) on one device (the device of ``params``). For MoE the
    row groups, buckets and segments are the JAX engine's: capacity is
    shared by every token of one forward, pad tokens included. ``submit()`` is thread-safe; the
    engine loop runs on the caller's thread via :meth:`step` or on a
    background thread via :meth:`start`."""

    def __init__(
        self,
        cfg,
        params,
        *,
        slots: int = 8,
        max_seq: int | None = None,
        chunk: int = 8,
        pipeline: int = 2,
        buckets: tuple[int, ...] | None = None,
        eos_id: int | None = None,
        pad_id: int = 0,
        cache_dtype: Any = torch.bfloat16,
        seed: int = 0,
        max_pending: int = 0,
        max_prefixes: int = 8,
        max_prefix_bytes: int = 0,
        prefill_chunk: int = 0,
        mesh=None,
        mirror=None,
    ):
        if mesh is not None:
            bad = {ax: n for ax, n in mesh.shape.items()
                   if ax not in ("tp", "fsdp") and n > 1}
            if bad:
                raise ValueError(
                    f"slot engine meshes are tp/fsdp-only (slots stay "
                    f"replicated; decode seq is 1): got {bad}")
        #: a tp/fsdp mesh (parallel/mesh.py): ``params`` are this rank's
        #: local shards and the caches hold its kv heads; ``mirror``
        #: (infer/mirror.py) keeps the ranks' engines in step
        self.mesh = mesh
        self._mirror = mirror
        self._admitq: collections.deque = collections.deque()
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if pipeline < 0:
            raise ValueError(f"pipeline must be >= 0, got {pipeline}")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["tokens"].device
        self.slots = slots
        self.max_seq = max_seq or cfg.max_seq_len
        self.chunk = chunk
        self.pipeline = pipeline
        self.buckets = tuple(sorted(buckets or self._default_buckets()))
        self._check_buckets()
        self.eos_id = eos_id
        self.pad_id = pad_id
        #: admission-queue bound (0 = unbounded), checked approximately
        self.max_pending = max_pending
        #: > 0: prompts longer than this prefill in segments of this many
        #: tokens, one per engine step, between decode chunks
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self._fwd = self._cached_forward()
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._k, self._v = self._alloc_cache(cache_dtype)
        self._seed = seed
        self._dispatches = 0
        self._gen = torch.Generator(device=self.device)

        # device-resident per-slot decode inputs, consumed and updated by
        # every chunk and prefill
        def vec(fill, dtype):
            return torch.full((slots,), fill, dtype=dtype, device=self.device)

        self._dtok = vec(0, torch.long)
        self._dpos = vec(0, torch.long)
        self._dtemp = vec(0.0, torch.float32)
        self._dtopk = vec(0, torch.long)
        self._dtopp = vec(1.0, torch.float32)

        self._pending: queue.SimpleQueue = queue.SimpleQueue()
        self._table: dict[int, _Slot | None] = {i: None for i in range(slots)}
        #: dispatched-but-unprocessed chunks: (slot snapshot, host
        #: tokens, CUDA event marking their arrival or None)
        self._outstanding: collections.deque = collections.deque()
        self._lock = threading.Lock()      # guards _table mutation vs stats
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._draining = False
        self._drained = threading.Event()
        self._dead: Exception | None = None
        self._kv_buckets = tuple(
            b for b in (128, 256, 512, 1024, 2048, 4096, 8192)
            if b < self.max_seq)
        #: prefix registry: pid → _Prefix. ``_px_lock`` serializes whole
        #: registrations (device work included); ``_lock`` guards the
        #: dict for the engine thread's reads
        self.max_prefixes = max_prefixes
        #: byte ceiling for registered prefix K/V (0 = unbounded): each
        #: prefix pins memory the cache sizing never counted
        self.max_prefix_bytes = max_prefix_bytes
        self._prefixes: dict[str, _Prefix] = {}
        self._px_lock = threading.Lock()
        self._px_seq = 0
        self._seg_rr = -1          # last slot served a prefill segment
        # ALL keys pre-seeded: /healthz unpacks this dict from other
        # threads. decode_launch_s: host seconds dispatching decode chunks
        self.stats = {"completed": 0, "decode_chunks": 0, "prefills": 0,
                      "wasted_steps": 0, "emitted_tokens": 0,
                      "bucketed_chunks": 0, "prefix_hits": 0,
                      "segment_prefills": 0, "prefix_bytes": 0,
                      "accepted_tokens": 0, "decode_launch_s": 0.0}
        #: per-request (ttft, mean_itl) ring for latency_stats(); serve
        #: points ``metrics_hook`` at its metrics registry
        self._lat_samples: collections.deque = collections.deque(maxlen=512)
        self.metrics_hook = None

    def _cached_forward(self):
        """The family's KV-cached forward (the encdec engine decodes
        through its own step and has none), bound to the mesh."""
        fwd = cached_forward_fn(self.cfg)
        if self.mesh is None:
            return fwd
        return functools.partial(fwd, mesh=self.mesh)

    @property
    def _kv_heads(self) -> int:
        """The kv heads this rank's caches hold (its tp part)."""
        tp = 1 if self.mesh is None else self.mesh.shape["tp"]
        return self.cfg.n_kv_heads // tp

    def _default_buckets(self) -> tuple[int, ...]:
        return _default_buckets(self.max_seq)

    def _check_buckets(self) -> None:
        if self.buckets[-1] > self.max_seq:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} exceeds cache "
                f"capacity {self.max_seq}")

    def _alloc_cache(self, cache_dtype):
        """The per-slot KV buffers: dense (slots, max_seq) here; the paged
        engine (infer/paged.py) allocates a page pool instead."""
        cache = init_kv_cache(self.cfg, self.slots, self.max_seq,
                              dtype=cache_dtype, device=self.device,
                              kv_heads=self._kv_heads)
        return cache.k, cache.v

    def _on_stream(self):
        """Context that puts this thread's device work on the engine's
        stream (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ---- device programs ---------------------------------------------------

    def _seeded(self, seed: int) -> torch.Generator:
        return self._gen.manual_seed(seed)

    @staticmethod
    def _sample(logits, temp, generator):
        """(S, vocab) f32 logits + per-slot temperature → (S,) tokens.
        Gumbel-argmax at temperature T; T == 0 rows take the argmax."""
        g = gumbel(logits.shape, generator, logits.device)
        z = torch.where(temp[:, None] > 0,
                        logits / temp.clamp(min=1e-6)[:, None] + g, logits)
        return torch.argmax(z, dim=-1)

    @staticmethod
    def _sample_filtered(logits, temp, topk, topp, generator):
        """Per-slot top-k/top-p sampling with per-row k and p: temperature
        scale, value-based top-k mask, nucleus filtering of the k-masked
        sorted distribution, then Gumbel-argmax (infer/sampling.py's
        semantics). temp == 0 rows stay plain argmax."""
        neg = -1e30
        V = logits.shape[-1]
        z = logits.float() / temp.clamp(min=1e-6)[:, None]
        zs = torch.sort(z, dim=-1, descending=True).values
        has_k = (topk > 0)[:, None]
        kth = zs.gather(1, (topk[:, None] - 1).clamp(0, V - 1))
        z1 = torch.where(has_k & (z < kth), neg, z)
        zs1 = torch.where(has_k & (zs < kth), neg, zs)    # same multiset
        probs = torch.softmax(zs1, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < topp[:, None]              # first always kept
        threshold = torch.where(keep, zs1, torch.inf).amin(dim=-1,
                                                           keepdim=True)
        z2 = torch.where(z1 < threshold, neg, z1)
        g = gumbel(z2.shape, generator, z2.device)
        return torch.where(temp > 0, torch.argmax(z2 + g, dim=-1),
                           torch.argmax(logits, dim=-1))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _temp_cache(self, rows: int, length: int):
        """A zeroed (layers, rows, length, kv, head_dim) k/v pair in the
        cache dtype: the cache a prefill forward writes before its rows
        move into the engine's cache."""
        cfg = self.cfg
        shape = (cfg.n_layers, rows, length, self._kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=self._k.dtype, device=self.device),
                torch.zeros(shape, dtype=self._k.dtype, device=self.device))

    def _first_tokens(self, prompts_np, lens, temps, topks, topps, kc, vc,
                      start, kv_limit=None):
        """The prefill forward of R rows into ``kc``/``vc`` at ``start``
        and each row's sampled first token. Returns (toks, lens, temps,
        topks, topps) as device tensors."""
        lens_t = self._to_device(lens)
        temps_t = self._to_device(temps)
        topks_t = self._to_device(topks)
        topps_t = self._to_device(topps)
        logits, _, _ = self._fwd(self.params, self._to_device(prompts_np),
                                 self.cfg, kc, vc, start,
                                 last_only=lens_t - 1, kv_limit=kv_limit)
        toks = self._sample_filtered(logits[:, 0], temps_t, topks_t, topps_t,
                                     self._seeded(self._next_seed()))
        return toks, lens_t, temps_t, topks_t, topps_t

    def _arm(self, slots_t, toks, pos_t, temps_t, topks_t, topps_t) -> None:
        """Set the per-slot decode state of freshly prefilled slots."""
        self._dtok[slots_t] = toks
        self._dpos[slots_t] = pos_t
        self._dtemp[slots_t] = temps_t
        self._dtopk[slots_t] = topks_t
        self._dtopp[slots_t] = topps_t

    @torch.no_grad()
    def _prefill(self, bucket, prompts_np, lens, slots_v, temps, topks,
                 topps) -> torch.Tensor:
        """ONE prefill for an R-row same-bucket group: forward into a fresh
        bucket-length cache, sample each row's first token, drop the rows
        into their slots and arm the per-slot device state. Returns the
        device vector of first tokens."""
        kc, vc = self._temp_cache(len(slots_v), bucket)
        toks, lens_t, *samp = self._first_tokens(prompts_np, lens, temps,
                                                 topks, topps, kc, vc, 0)
        slots_t = self._to_device(slots_v)
        self._k[:, slots_t, :bucket] = kc
        self._v[:, slots_t, :bucket] = vc
        self._arm(slots_t, toks, lens_t, *samp)
        return toks

    @torch.no_grad()
    def _build_prefix(self, bucket: int, prompt_np) -> tuple:
        """One prefix row prefilled into a fresh bucket-length cache (the
        whole-prompt flash path): its (layers, bucket, kv, head_dim)
        k/v pair."""
        kc, vc = self._temp_cache(1, bucket)
        self._fwd(self.params, self._to_device(prompt_np), self.cfg, kc, vc,
                  0, last_only=True)
        return kc[:, 0], vc[:, 0]

    @torch.no_grad()
    def _px_prefill(self, prefix: _Prefix, sbucket, prompts_np, lens,
                    slots_v, temps, topks, topps) -> torch.Tensor:
        """Suffix-only prefill against a registered prefix: the prefix
        k/v land in a temp cache first, then the suffix forward runs at
        the per-row position ``prefix.length`` (rope phases and the causal
        offset mask are position-derived, so this is the math of a full
        prefill with the prefix's work skipped). The temp cache is clamped
        to capacity; pad-tail writes past it are dropped. Prefix-pad
        garbage in (length, bucket) sits at future positions."""
        R = len(slots_v)
        tsize = min(prefix.bucket + sbucket, self.max_seq)
        kc, vc = self._temp_cache(R, tsize)
        kc[:, :, :prefix.bucket] = prefix.k[:, None]
        vc[:, :, :prefix.bucket] = prefix.v[:, None]
        starts = torch.full((R,), prefix.length, dtype=torch.long,
                            device=self.device)
        toks, lens_t, *samp = self._first_tokens(prompts_np, lens, temps,
                                                 topks, topps, kc, vc, starts)
        slots_t = self._to_device(slots_v)
        self._k[:, slots_t, :tsize] = kc
        self._v[:, slots_t, :tsize] = vc
        self._arm(slots_t, toks, prefix.length + lens_t, *samp)
        return toks

    @torch.no_grad()
    def _seg_prefill(self, kr, vr, slot: int, st: _Slot, tokens_np, n: int,
                     final: bool, kv_limit: int | None, park: int):
        """One chunked-prefill segment of ``n`` real tokens for one slot,
        written into the slot's one-row cache ``kr``/``vr`` (views of the
        engine's cache here, a gathered page row in the paged engine) at
        ``st.prefill_pos``: a per-row start, so pad-tail writes past the
        row are dropped. ``kv_limit`` bounds the attended prefix to the
        segment's reach. A non-final segment parks the slot's decode lane
        at position ``park``, whose writes are dropped; the final one
        samples the first token and arms the decode state. Returns the
        (1,) first-token vector, or None."""
        start = torch.tensor([st.prefill_pos], device=self.device)
        slot_t = torch.tensor([slot], device=self.device)
        if not final:
            self._fwd(self.params, self._to_device(tokens_np), self.cfg, kr,
                      vr, start, last_only=torch.tensor([n - 1]),
                      kv_limit=kv_limit)
            self._dpos[slot_t] = park
            return None
        toks, lens_t, *samp = self._first_tokens(
            tokens_np, np.array([n]), np.array([st.temperature], np.float32),
            np.array([st.top_k]), np.array([st.top_p], np.float32), kr, vr,
            start, kv_limit)
        self._arm(slot_t, toks, start + lens_t, *samp)
        return toks

    def _forward_step(self, tok, pos, view):
        """One decode step of every slot; ``view`` is the chunk's kv read
        limit (the paged engine: its page table)."""
        logits, self._k, self._v = self._fwd(
            self.params, tok[:, None], self.cfg, self._k, self._v, pos,
            kv_limit=view)
        return logits

    @torch.no_grad()
    def _decode_chunk(self, view, filtered: bool) -> torch.Tensor:
        """K decode steps for every slot; returns (S, K+1) tokens whose
        column 0 is each slot's INPUT token (a fresh slot's prefill token,
        so the host needs no separate fetch for it)."""
        gen = self._seeded(self._next_seed())
        tok, pos = self._dtok, self._dpos
        cols = [tok]
        for _ in range(self.chunk):
            logits = self._forward_step(tok, pos, view)
            if filtered:
                tok = self._sample_filtered(logits[:, -1], self._dtemp,
                                            self._dtopk, self._dtopp, gen)
            else:
                tok = self._sample(logits[:, -1], self._dtemp, gen)
            pos = pos + 1
            cols.append(tok)
        self._dtok, self._dpos = tok, pos
        return torch.stack(cols, dim=1)

    @staticmethod
    def _reach_bound(active, chunk: int) -> int:
        """Highest cache position the NEXT chunk can touch across
        ``active`` slots — from dispatch counts, not processed state (the
        host lags by the pipeline depth)."""
        return max(st.base_len + (st.dispatched + 1) * chunk
                   for st in active.values())

    def _kv_limit_for_chunk(self, active) -> int | None:
        """Smallest geometric bucket covering every position the NEXT
        chunk can touch, or None (full buffer)."""
        if not self._kv_buckets or not active:
            return None
        bound = self._reach_bound(active, self.chunk)
        for b in self._kv_buckets:
            if b >= bound:
                return b
        return None

    # ---- prefix cache ------------------------------------------------------

    def register_prefix(self, tokens: list[int]) -> str:
        """Prefill ``tokens`` once and register them as a shared prompt
        prefix; returns its id. Later submits whose prompt STRICTLY starts
        with these tokens prefill only the suffix. Registering a sequence
        again returns the existing id. Callable from any thread: the
        build runs on the engine's stream before the entry is visible.
        A mirrored engine registers on every rank at its next step."""
        if self._mirror is not None:
            return self._mirror.call(self, "register", list(tokens))
        return self._op_register(list(tokens))

    def _op_register(self, tokens: list[int]) -> str:
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if len(tokens) + 2 > self.max_seq:
            # a usable prefix needs >= 1 suffix token + >= 1 generated
            raise ValueError(
                f"prefix ({len(tokens)}) leaves no room for a suffix and "
                f"a generated token in cache capacity {self.max_seq}")
        bucket = next((b for b in self.buckets if b >= len(tokens)), None)
        if bucket is None:
            raise ValueError(
                f"prefix ({len(tokens)}) exceeds the largest prefill "
                f"bucket ({self.buckets[-1]})")
        with self._px_lock:
            key = tuple(tokens)
            with self._lock:
                if self._closed:
                    raise RuntimeError("engine is closed")
                if self._dead is not None:
                    raise RuntimeError(f"engine failed: {self._dead!r}")
                for ent in self._prefixes.values():
                    if ent.tokens == key:
                        return ent.pid
                if len(self._prefixes) >= self.max_prefixes:
                    raise ValueError(
                        f"prefix registry full ({self.max_prefixes}) — "
                        f"unregister one first")
                nbytes = (2 * self.cfg.n_layers * bucket
                          * self.cfg.n_kv_heads * self.cfg.head_dim
                          * self._k.element_size())
                if (self.max_prefix_bytes
                        and self.stats["prefix_bytes"] + nbytes
                        > self.max_prefix_bytes):
                    raise ValueError(
                        f"prefix K/V ({nbytes} B) would exceed the "
                        f"registry byte budget ({self.max_prefix_bytes} B;"
                        f" {self.stats['prefix_bytes']} B registered) — "
                        f"unregister one first")
                self._px_seq += 1
                pid = f"px-{self._px_seq}"
            prompt = np.full((1, bucket), self.pad_id, np.int64)
            prompt[0, :len(tokens)] = tokens
            with self._on_stream():
                k, v = self._build_prefix(bucket, prompt)
            ent = _Prefix(pid=pid, tokens=key, length=len(tokens),
                          bucket=bucket, k=k, v=v, nbytes=nbytes)
            with self._lock:
                self._prefixes[pid] = ent
                self.stats["prefix_bytes"] += nbytes
            return pid

    def unregister_prefix(self, pid: str) -> bool:
        if self._mirror is not None:
            return self._mirror.call(self, "unregister", pid)
        return self._op_unregister(pid)

    def _op_unregister(self, pid: str) -> bool:
        with self._px_lock, self._lock:
            ent = self._prefixes.pop(pid, None)
            if ent is not None:
                self.stats["prefix_bytes"] -= ent.nbytes
            return ent is not None

    def prefixes(self) -> list[dict]:
        """Snapshot of the registry (serve's GET /prefixes)."""
        with self._lock:
            return [{"id": p.pid, "length": p.length, "bytes": p.nbytes}
                    for p in self._prefixes.values()]

    def _resolve_prefix(self, prompt: list[int]):
        """Longest registered STRICT prefix of ``prompt``, or None."""
        best = None
        with self._lock:
            for ent in self._prefixes.values():
                if (ent.length < len(prompt)
                        and (best is None or ent.length > best.length)
                        and tuple(prompt[:ent.length]) == ent.tokens):
                    best = ent
        return best

    def _px_plan(self, prompt: list[int]) -> tuple[_Prefix, int] | None:
        """(prefix, suffix_bucket) if a registered prefix applies to this
        prompt: the suffix must fit a prefill bucket (capacity is
        validate()'s job)."""
        ent = self._resolve_prefix(prompt)
        if ent is None:
            return None
        sbucket = next((b for b in self.buckets
                        if b >= len(prompt) - ent.length), None)
        if sbucket is None:
            return None
        return ent, sbucket

    # ---- request API -------------------------------------------------------

    def validate(self, prompt: list[int], max_new: int,
                 top_k: int = 0, top_p: float = 1.0) -> None:
        """The submit-time request checks, without queueing."""
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        n = len(prompt)
        if n < 1:
            raise ValueError("prompt must be non-empty")
        if (n > self.buckets[-1] and not self.prefill_chunk
                and self._px_plan(prompt) is None):
            # two ways past the bucket ceiling: a registered prefix
            # covering the overflow, or chunked prefill (segments clamp
            # to the largest bucket). The admission re-resolves the
            # prefix and fails the handle if it is gone by then
            raise ValueError(
                f"prompt ({n}) exceeds the largest prefill bucket "
                f"({self.buckets[-1]}) and no registered prefix covers it")
        if n + max_new - 1 > self.max_seq:
            raise ValueError(
                f"prompt ({n}) + max_new ({max_new}) exceeds cache "
                f"capacity {self.max_seq}")

    def has_room(self, n_requests: int = 1) -> bool:
        """Approximate admission-queue room for a batch of requests."""
        if not self.max_pending:
            return True
        return self._pending.qsize() + n_requests <= self.max_pending

    def submit(self, prompt: list[int], max_new: int,
               temperature: float = 0.0, eos_id: int | None = None,
               stream: bool = False, top_k: int = 0,
               top_p: float = 1.0) -> Handle:
        """Queue a request; returns a Handle resolving to
        {"tokens": [...], "length": n}. ``eos_id`` overrides the engine
        default per request. Raises ValueError for requests that can
        never fit, QueueFull when the queue is at capacity."""
        handle = Handle(_stream=queue.SimpleQueue() if stream else None)
        handle.submitted_at = time.perf_counter()
        self.validate(prompt, max_new, top_k=top_k, top_p=top_p)
        # state check + put are ONE atomic section vs close()/_die()
        with self._lock:
            if self._closed or self._draining:
                raise RuntimeError("engine is closed")
            if self._dead is not None:
                raise RuntimeError(f"engine failed: {self._dead!r}")
            if (self.max_pending
                    and self._pending.qsize() >= self.max_pending):
                raise QueueFull(
                    f"admission queue at capacity ({self.max_pending})")
            self._pending.put((list(prompt), max_new, float(temperature),
                               self.eos_id if eos_id is None else eos_id,
                               int(top_k), float(top_p), handle))
        self._wake.set()
        return handle

    def warmup(self, buckets=None, rows=(1,)) -> None:
        """Serve one throwaway group of ``R`` bucket-long prompts in every
        prefill bucket for each ``R`` in ``rows`` (with a decode chunk
        where the bucket leaves room), so that a measured window pays no
        first-call costs: allocator growth, library handles, kernel
        loads. The JAX method compiles the same programs. The stats are
        left as they were. Runs before :meth:`start`."""
        if self._thread is not None:
            raise RuntimeError("warmup must run before start()")
        saved = dict(self.stats)
        for b in (self.buckets if buckets is None else buckets):
            for r in sorted({min(r, self.slots) for r in rows}):
                max_new = 2 if b < self.max_seq else 1
                hs = [self.submit([self.pad_id] * b, max_new)
                      for _ in range(r)]
                while not all(h.done() for h in hs):
                    self.step()
        while self._outstanding:
            self._process_oldest()
        with self._lock:
            self.stats.update(saved)
        self.reset_latency_stats()

    # ---- engine loop -------------------------------------------------------

    def _next_seed(self) -> int:
        """Per-dispatch RNG stream id: deterministic in the engine seed,
        derived on the host."""
        self._dispatches += 1
        return (self._seed * 1000003 + self._dispatches) % (2 ** 31)

    def _admit(self) -> bool:
        """Move pending requests into free slots. Same-bucket requests
        admit as power-of-two row groups through ONE prefill each;
        prompts matching a registered prefix group per (prefix, suffix
        bucket) and prefill only the suffix; with ``prefill_chunk`` a long
        prompt reserves its slot here and prefills in segments
        (:meth:`_dispatch_segments`). Returns True if anything was
        admitted."""
        admitted = False
        free = [i for i, s in self._table.items() if s is None]
        batch = []
        while len(batch) < len(free):
            try:
                batch.append(self._take_request())
            except queue.Empty:
                break
        if not batch:
            return False
        # group key: (prefix or None, bucket); for a prefix group the
        # bucket is the SUFFIX bucket, and the _Prefix object rides the
        # key so a concurrent unregister cannot drop it mid-dispatch
        groups: dict[tuple, list] = {}
        for req in batch:
            prompt = req[0]
            plan = self._px_plan(prompt)
            if plan is not None and (
                    not self.prefill_chunk
                    or len(prompt) - plan[0].length <= self.prefill_chunk):
                # a long suffix would break --prefill-chunk's bounded
                # stall as one dispatch: it falls through to segments
                groups.setdefault(plan, []).append(req)
                continue
            if self.prefill_chunk and (
                    len(prompt) > self.prefill_chunk
                    or len(prompt) > self.buckets[-1]):
                prompt, max_new, temp, eos_id, tk, tp, handle = req
                st = _Slot(handle=handle, tokens=[], max_new=max_new,
                           pos=len(prompt), temperature=temp,
                           eos_id=eos_id, top_k=tk, top_p=tp,
                           base_len=len(prompt), pending=list(prompt))
                handle._admitted()
                with self._lock:
                    self._table[free.pop()] = st
                admitted = True
                continue
            bucket = next((b for b in self.buckets if b >= len(prompt)),
                          None)
            if bucket is None:
                # admitted past validate() through a prefix unregistered
                # since: fail the handle, not the engine loop
                req[-1]._fail(ValueError(
                    f"prompt ({len(prompt)}) exceeds the largest prefill "
                    f"bucket and its covering prefix is gone"))
                continue
            groups.setdefault((None, bucket), []).append(req)
        for (prefix, bucket), reqs in groups.items():
            plen = prefix.length if prefix is not None else 0
            while reqs:
                R = 1
                while R * 2 <= len(reqs) and R * 2 <= self.slots:
                    R *= 2
                group, reqs = reqs[:R], reqs[R:]
                slots_v = [free.pop() for _ in group]
                prompts_np = np.full((R, bucket), self.pad_id, np.int64)
                lens = np.empty((R,), np.int64)
                temps = np.empty((R,), np.float32)
                topks = np.empty((R,), np.int64)
                topps = np.empty((R,), np.float32)
                for r, (prompt, _mn, temp, _eos, tk, tp, _h) in enumerate(
                        group):
                    sfx = prompt[plen:]
                    prompts_np[r, :len(sfx)] = sfx
                    lens[r] = len(sfx)
                    temps[r], topks[r], topps[r] = temp, tk, tp
                slots_np = np.asarray(slots_v, np.int64)
                for req in group:
                    req[-1]._admitted()
                if prefix is not None:
                    toks = self._px_prefill(prefix, bucket, prompts_np, lens,
                                            slots_np, temps, topks, topps)
                    self.stats["prefix_hits"] += R
                else:
                    toks = self._prefill(bucket, prompts_np, lens, slots_np,
                                         temps, topks, topps)
                self.stats["prefills"] += 1
                for r, (prompt, max_new, temp, eos_id, tk, tp,
                        handle) in enumerate(group):
                    st = self._new_slot(prompt, max_new, temp, eos_id, tk,
                                        tp, handle)
                    with self._lock:
                        self._table[slots_v[r]] = st
                    self._finish_admission_only(slots_v[r], st, toks, r)
                admitted = True
        return admitted

    def _new_slot(self, prompt, max_new, temp, eos_id, tk, tp,
                  handle) -> _Slot:
        """The state of a request admitted by a whole prefill."""
        return _Slot(handle=handle, tokens=[], max_new=max_new,
                     pos=len(prompt), temperature=temp, eos_id=eos_id,
                     top_k=tk, top_p=tp, base_len=len(prompt))

    def _finish_admission_only(self, slot: int, st: _Slot, toks,
                               r: int) -> None:
        """A request whose only token its prefill sampled completes at
        admission."""
        if st.max_new == 1:
            self._emit_first(slot, st, toks[r])

    def _emit_first(self, slot: int, st: _Slot, tok) -> None:
        """The admission produced a request's only token: resolve it now
        (the one admission path that syncs)."""
        st.emit(int(tok))
        st.fresh = False
        self._finish_if_done(slot, st)

    def _next_segment(self):
        """(slot, state, segment tokens, final, bucket) of the prefilling
        slot whose turn it is (round-robin past the last one served), or
        None. The rotation advances here, so a slot that then stalls is
        not picked again while others wait."""
        filling = [(i, st) for i, st in self._table.items()
                   if st is not None and st.pending is not None]
        if not filling:
            return None
        filling.sort(key=lambda p: (p[0] <= self._seg_rr, p[0]))
        i, st = filling[0]
        self._seg_rr = i
        seg = st.pending[:min(self.prefill_chunk, self.buckets[-1])]
        bucket = next(b for b in self.buckets if b >= len(seg))
        return i, st, seg, len(seg) == len(st.pending), bucket

    def _segment_done(self, i: int, st: _Slot, seg, final: bool,
                      toks) -> None:
        st.prefill_pos += len(seg)
        st.pending = None if final else st.pending[len(seg):]
        self.stats["segment_prefills"] += 1
        if final:
            self.stats["prefills"] += 1
            if st.max_new - st.preseed <= 1:
                self._emit_first(i, st, toks[0])

    def _dispatch_segments(self) -> bool:
        """ONE prefill segment per engine step, round-robin across
        prefilling slots, so active streams wait at most one segment's
        compute per step however many long admissions are in flight.
        Segments clamp to the largest prefill bucket."""
        nxt = self._next_segment()
        if nxt is None:
            return False
        i, st, seg, final, bucket = nxt
        # read only the cache prefix this segment can attend
        reach = st.prefill_pos + bucket
        kvl = next((b for b in self._kv_buckets if b >= reach), None)
        tokens_np = np.full((1, bucket), self.pad_id, np.int64)
        tokens_np[0, :len(seg)] = seg
        toks = self._seg_prefill(self._k[:, i:i + 1], self._v[:, i:i + 1],
                                 i, st, tokens_np, len(seg), final, kvl,
                                 self.max_seq)
        self._segment_done(i, st, seg, final, toks)
        return True

    def _finish_if_done(self, slot: int, st: _Slot) -> bool:
        hit_eos = st.eos_id is not None and st.tokens and (
            st.tokens[-1] == st.eos_id)
        if hit_eos or len(st.tokens) >= st.max_new:
            # stats + table BEFORE resolving the handle: the HTTP worker
            # it wakes may immediately read /healthz counters
            with self._lock:
                self._table[slot] = None
                self.stats["completed"] += 1
                self.stats["emitted_tokens"] += len(st.tokens)
            st.handle._complete(
                {"tokens": st.tokens, "length": len(st.tokens)})
            self._record_latency(st.handle, len(st.tokens))
            return True
        return False

    def _record_latency(self, handle: Handle, n_tokens: int) -> None:
        """Per-request SLO sample on completion: TTFT = submit → first
        host-resolved token; ITL = mean gap over the remaining tokens.
        Lands in a bounded ring and fans out to ``metrics_hook``."""
        if handle.submitted_at is None or handle.first_token_at is None:
            return
        ttft = handle.first_token_at - handle.submitted_at
        itl = ((handle.completed_at - handle.first_token_at)
               / (n_tokens - 1)) if n_tokens > 1 else None
        with self._lock:
            self._lat_samples.append((ttft, itl))
        hook = self.metrics_hook
        if hook is not None:
            try:
                hook(ttft, itl, n_tokens)
            except Exception:  # noqa: BLE001 — a metrics sink must never
                pass           # kill serving

    def reset_latency_stats(self) -> None:
        with self._lock:
            self._lat_samples.clear()

    def latency_stats(self) -> dict:
        """Engine-side percentiles over the last completed requests."""
        with self._lock:
            samples = list(self._lat_samples)
        ttfts = sorted(s[0] for s in samples)
        itls = sorted(s[1] for s in samples if s[1] is not None)

        def pct(xs, q):
            if not xs:
                return None
            i = min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))
            return round(xs[i] * 1e3, 1)

        return {
            "n": len(samples),
            "ttft_p50_ms": pct(ttfts, 50), "ttft_p99_ms": pct(ttfts, 99),
            "itl_p50_ms": pct(itls, 50), "itl_p99_ms": pct(itls, 99),
        }

    def _decoding(self) -> dict:
        """Active slots past their prefill: a prefilling slot's decode
        lane computes garbage (its writes are dropped at the parked
        position) and its tokens are never processed."""
        return {i: s for i, s in self._table.items()
                if s is not None and s.pending is None}

    def _dispatch_chunk(self) -> None:
        snap = self._decoding()
        limit = self._kv_limit_for_chunk(snap)
        self._launch_chunk(snap, limit, limit is not None)

    def _launch_chunk(self, snap: dict, view, bucketed: bool) -> None:
        """Dispatch one decode chunk over ``view`` for the slots of
        ``snap`` and queue its tokens for the host."""
        filtered = any(s.top_k > 0 or s.top_p < 1.0 for s in snap.values())
        self._enqueue(snap, self._decode_chunk(view, filtered))
        if bucketed:
            self.stats["bucketed_chunks"] += 1

    def _enqueue(self, snap: dict, out: torch.Tensor) -> None:
        """Queue one dispatched chunk's (S, cols) device output for the
        host: the device→host copy starts now, and the host reads it
        ``pipeline`` chunks later, after waiting on its event."""
        for st in snap.values():
            st.dispatched += 1
        event = None
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            out = host
        self._outstanding.append((snap, out, event))
        self.stats["decode_chunks"] += 1

    def _process_oldest(self) -> None:
        """Host-side half of one chunk: wait for its output and hand each
        row to the slot that was active at its dispatch (:meth:`_emit_row`).
        Slots freed by an EARLIER chunk are skipped by identity (the
        snapshot holds the _Slot object)."""
        snap, out, event = self._outstanding.popleft()
        if event is not None:
            event.synchronize()
        out = out.numpy()  # (S, cols); column 0 is the chunk's input
        for i, st in snap.items():
            if self._table.get(i) is not st:
                continue  # completed in an earlier chunk; this is garbage
            start = 0 if st.fresh else 1  # col 0: prefill token, once
            st.fresh = False
            self._emit_row(i, st, out[i], start)

    def _emit_row(self, i: int, st: _Slot, row, start: int) -> None:
        """Emit one slot's tokens of a processed chunk from column
        ``start``; complete the slot at eos or max_new."""
        st.pos += self.chunk
        for j in range(start, self.chunk + 1):
            st.emit(int(row[j]))
            if self._finish_if_done(i, st):
                self.stats["wasted_steps"] += self.chunk - j
                break

    def step(self) -> bool:
        """One engine iteration: admit pending requests, dispatch one
        decode chunk if any slot is active, and process chunk outputs at
        the pipeline lag (drain fully when idle). Returns True if any
        work was done."""
        if self._mirror is not None:
            self._mirror_sync()
        did = False
        # a waiting request with no free slot: process ONE outstanding
        # chunk (completions hide in them), but only one per step
        if self._has_request() and not any(
                s is None for s in self._table.values()):
            if self._outstanding:
                with span(PROCESS_RANGE):
                    self._process_oldest()
                did = True
        with span(ADMIT_RANGE):
            did = self._admit() or did
            did = self._dispatch_segments() or did
        active = bool(self._decoding())
        if active:
            with span(DECODE_LAUNCH_RANGE):
                t0 = time.perf_counter()
                self._dispatch_chunk()
                self.stats["decode_launch_s"] += time.perf_counter() - t0
            did = True
        lag = self.pipeline if active else 0
        while len(self._outstanding) > lag:
            with span(PROCESS_RANGE):
                self._process_oldest()
            did = True
        return did

    def _take_request(self):
        """The next request to admit; raises queue.Empty."""
        if self._mirror is None:
            return self._pending.get_nowait()
        if not self._admitq:
            raise queue.Empty
        return self._admitq.popleft()

    def _has_request(self) -> bool:
        if self._mirror is None:
            return not self._pending.empty()
        return bool(self._admitq)

    def _mirror_sync(self) -> None:
        """The top of a mirrored step (infer/mirror.py): rank 0 sends the
        requests and prefix ops that came in since the last step, every
        rank queues the requests and runs the ops in order."""
        m = self._mirror
        ops, reqs = [], []
        if m.leads:
            ops = m.drain_ops()
            while True:
                try:
                    reqs.append(self._pending.get_nowait())
                except queue.Empty:
                    break
            m.broadcast({"reqs": [r[:-1] for r in reqs],
                         "ops": [(name, args) for name, args, _ in ops]})
        else:
            msg = m.broadcast(None)
            if msg.get("stop"):
                raise _Stopped()
            reqs = [(*r, Handle()) for r in msg["reqs"]]
            ops = [(name, args, None) for name, args in msg["ops"]]
        self._admitq.extend(reqs)
        for name, args, reply in ops:
            try:
                val = (True, getattr(self, "_op_" + name)(*args))
            except Exception as e:  # noqa: BLE001 — the caller's error
                val = (False, e)
            if reply is not None:
                reply.put(val)

    def follow(self) -> None:
        """A rank other than 0: run rank 0's steps until it stops."""
        with self._on_stream():
            while True:
                try:
                    self.step()
                except _Stopped:
                    return

    def _loop(self) -> None:
        try:
            with self._on_stream():
                self._run()
        finally:
            self._drained.set()

    def _run(self) -> None:
        while not self._closed:
            try:
                if not self.step():
                    if (self._draining and self._pending.empty()
                            and not self._has_request()):
                        return
                    self._wake.clear()
                    self._wake.wait(timeout=0.05)
            except Exception as e:  # noqa: BLE001 — a dead engine
                # thread must not leave clients hanging: fail every
                # in-flight and queued handle, reject new submits
                self._die(e)
                return

    def _die(self, err: Exception) -> None:
        with self._lock:
            self._dead = err
            for i, s in self._table.items():
                if s is not None:
                    s.handle._fail(RuntimeError(f"engine failed: {err!r}"))
                    self._table[i] = None
        while self._admitq:
            self._admitq.popleft()[-1]._fail(
                RuntimeError(f"engine failed: {err!r}"))
        while True:
            try:
                *_, handle = self._pending.get_nowait()
            except queue.Empty:
                break
            handle._fail(RuntimeError(f"engine failed: {err!r}"))

    @property
    def dead(self) -> str | None:
        """repr of the error that killed the engine loop, or None."""
        return repr(self._dead) if self._dead is not None else None

    def start(self) -> "SlotEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="slot-engine")
            self._thread.start()
        return self

    def close(self, drain: float = 0.0) -> None:
        """Stop the engine. ``drain`` seconds > 0: reject new submits but
        keep decoding until in-flight requests complete (or the deadline
        passes); 0: fail everything in flight immediately."""
        if drain > 0 and self._thread is not None and self._dead is None:
            with self._lock:
                self._draining = True
            self._wake.set()
            self._drained.wait(timeout=drain)
        with self._lock:
            self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._mirror is not None and self._dead is None:
            self._mirror.stop()
        while True:
            try:
                *_, handle = self._pending.get_nowait()
            except queue.Empty:
                break
            handle._fail(RuntimeError("engine closed"))
        while self._admitq:
            self._admitq.popleft()[-1]._fail(RuntimeError("engine closed"))
        for i, s in list(self._table.items()):
            if s is not None:
                s.handle._fail(RuntimeError("engine closed"))
                self._table[i] = None
        self._outstanding.clear()

    def __enter__(self) -> "SlotEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class SpeculativeSlotEngine(SlotEngine):
    """Continuous batching x speculative decoding (greedy): every engine
    round a small DRAFT model proposes ``n_spec`` tokens per slot by
    single-token steps, and the TARGET verifies all of them in ONE
    ``(slots, n_spec + 1)`` cached forward with per-row positions. The
    accepted prefix plus the target's own correction token emit per
    round, so a slot advances 1..n_spec+1 positions per dispatch.

    Exactness: greedy verification gives plain greedy decoding's tokens
    whatever the draft proposes (a bad draft only costs speed); on the
    CPU in f32 that is token-exact (tests/test_torch_spec_slots.py).
    Rejected positions' k/v, in both caches, are rewritten by the round
    that legitimately crosses them before the causal mask lets anything
    attend them; per-row writes past capacity are dropped.

    A round's outputs (tokens, counts, the next input token and position)
    stay on the device and chain into the next round with no host
    round-trip; the host reads a round ``pipeline`` rounds later, as the
    base engine's chunks. Every draft and target forward runs on the
    engine's one stream. Greedy-only, no prefix caching, no chunked
    prefill; decode reads are unbucketed (verify reads scale with
    n_spec, not chunk)."""

    def __init__(self, cfg, params, *, draft_cfg, draft_params,
                 n_spec: int = 4, **kwargs):
        if kwargs.get("mesh") is not None:
            raise ValueError("speculative slots are single-device for now")
        if kwargs.get("prefill_chunk"):
            raise ValueError(
                "chunked prefill is not supported on the speculative "
                "engine (segments fill the target cache only)")
        if n_spec < 1:
            raise ValueError(f"n_spec must be >= 1, got {n_spec}")
        kwargs.pop("mesh", None)
        # chunk drives the position-bound math (a round advances at most
        # n_spec+1) and the base engine's column count
        kwargs["chunk"] = n_spec + 1
        super().__init__(cfg, params, **kwargs)
        self.n_spec = n_spec
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self._dfwd = cached_forward_fn(draft_cfg)
        dcache = init_kv_cache(draft_cfg, self.slots, self.max_seq,
                               dtype=self._k.dtype, device=self.device)
        self._dk, self._dv = dcache.k, dcache.v
        self._kv_buckets = ()  # verify reads stay unbucketed

    def submit(self, prompt, max_new, temperature=0.0, eos_id=None,
               stream=False, top_k=0, top_p=1.0):
        if temperature != 0.0 or top_k != 0 or top_p != 1.0:
            raise ValueError(
                "speculative slots are greedy-only (temperature 0, no "
                "top-k/top-p)")
        return super().submit(prompt, max_new, 0.0, eos_id=eos_id,
                              stream=stream)

    def register_prefix(self, tokens):
        # the suffix-only prefill fills the TARGET cache only; a draft
        # cache left unfilled would silently collapse acceptance
        raise ValueError(
            "prefix caching is not supported on the speculative engine")

    @torch.no_grad()
    def _prefill(self, bucket, prompts_np, lens, slots_v, temps, topks,
                 topps) -> torch.Tensor:
        """The base prefill (target cache, first tokens, decode state),
        then the draft's prefill of the same rows into its own cache —
        the draft's next round must attend the whole prompt. Both run
        the whole-prompt flash path."""
        toks = super()._prefill(bucket, prompts_np, lens, slots_v, temps,
                                topks, topps)
        dcfg = self.draft_cfg
        shape = (dcfg.n_layers, len(slots_v), bucket, dcfg.n_kv_heads,
                 dcfg.head_dim)
        dkc = torch.zeros(shape, dtype=self._dk.dtype, device=self.device)
        dvc = torch.zeros(shape, dtype=self._dk.dtype, device=self.device)
        self._dfwd(self.draft_params, self._to_device(prompts_np), dcfg,
                   dkc, dvc, 0, last_only=True)
        slots_t = self._to_device(slots_v)
        self._dk[:, slots_t, :bucket] = dkc
        self._dv[:, slots_t, :bucket] = dvc
        return toks

    @torch.no_grad()
    def _spec_round(self) -> torch.Tensor:
        """One round for every slot. Returns (S, n_spec + 3) on the
        device: column 0 the round's input token, columns 1..n_spec+1
        the accepted proposals, the correction and pad, the last column
        the count of new tokens (accepted + 1)."""
        K, dcfg = self.n_spec, self.draft_cfg
        dtok, dpos = self._dtok, self._dpos
        # 1. the draft proposes K tokens per slot (its cache fills
        # dpos..dpos+K-1 with [dtok, p0..p_{K-2}])
        tok, props = dtok, []
        for i in range(K):
            logits, self._dk, self._dv = self._dfwd(
                self.draft_params, tok[:, None], dcfg, self._dk, self._dv,
                dpos + i)
            tok = torch.argmax(logits[:, -1], dim=-1)
            props.append(tok)
        props_t = torch.stack(props, dim=1)                  # (S, K)
        # feed the FINAL proposal once more so its k/v lands in the draft
        # cache at dpos+K: on a fully accepted round the next round starts
        # PAST that position and would never rewrite it, leaving a
        # garbage hole the draft attends forever (acceptance collapses
        # even for a perfect draft). On partial acceptance this write
        # sits at a future position and is rewritten just in time.
        _, self._dk, self._dv = self._dfwd(
            self.draft_params, tok[:, None], dcfg, self._dk, self._dv,
            dpos + K)

        # 2. the target verifies all K+1 positions in ONE forward
        seq_in = torch.cat([dtok[:, None], props_t], dim=1)
        logits, self._k, self._v = self._fwd(self.params, seq_in, self.cfg,
                                             self._k, self._v, dpos)
        greedy = torch.argmax(logits, dim=-1)                # (S, K+1)

        # 3. accepted prefix length + the target's correction token
        match = (props_t == greedy[:, :K]).long()
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)       # (S,)
        corr = greedy.gather(1, n_acc[:, None])[:, 0]
        idx = torch.arange(K + 1, device=self.device)[None, :]
        props_ext = torch.cat([props_t, props_t.new_zeros(props_t.shape[0],
                                                          1)], dim=1)
        newt = torch.where(
            idx < n_acc[:, None], props_ext,
            torch.where(idx == n_acc[:, None], corr[:, None], self.pad_id))
        counts = n_acc + 1
        self._dtok, self._dpos = corr, dpos + counts
        return torch.cat([dtok[:, None], newt, counts[:, None]], dim=1)

    def _dispatch_chunk(self) -> None:
        self._enqueue(self._decoding(), self._spec_round())

    def _emit_row(self, i: int, st, row, start: int) -> None:
        n = int(row[-1])             # new tokens this round
        st.pos += n
        self.stats["accepted_tokens"] += n - 1
        for j in range(start, 1 + n):
            st.emit(int(row[j]))
            if self._finish_if_done(i, st):
                break
