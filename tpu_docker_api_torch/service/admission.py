"""Capacity market: priority classes, gang preemption, backfill admission.

Admission used to be first-fit-or-refuse: a full pool hard-failed
``POST /jobs`` with ``ChipNotEnough`` and scarce slices had no notion of
who matters more. This subsystem turns capacity refusal into scheduling
policy (the Borg/EASY shape):

- **priority classes** — every job carries a ``priority_class`` (default
  ladder ``system > production > batch > preemptible``; weights are config,
  resolved at decision time so operators can retune live);
- **a durable admission queue** — when a job cannot place and admission is
  enabled, it is parked as phase ``queued``: a ``JobState`` with no members
  plus an admission record under ``keys.ADMISSION_PREFIX``, written in ONE
  atomic ``KV.apply`` so queued intent survives restarts and leader
  failover (the declarative-record pattern);
- **preemption** — when a queued job outranks running gangs, victims are
  selected strictly lowest-priority-first then youngest-first (the
  ``infer/paged.py`` seniority rule: juniors can never displace seniors,
  which is what makes preemption terminate), quiesced through the
  gang stop path (workers first, coordinator last — checkpoint binds
  intact), their claims released in one atomic batch, and parked as
  phase ``preempted`` for automatic re-admission ahead of equal-priority
  queued work;
- **partial preemption** (docs/robustness.md "Elastic gangs") — before
  condemning any whole gang, the victim loop takes SPARE MEMBERS (down to
  ``minMembers``) from elastic strictly-lower-class gangs, lowest class
  first, youngest first, one member at a time until the ask fits: a
  preemptible training gang donates capacity in units of hosts, not jobs.
  Each donation is a crash-consistent ``JobService.resize_gang`` shrink,
  and the shrunken gang journals a durable **grow-back** record
  (``kind == "growback"``) that re-admits the lost members with
  preempted-grade precedence once pressure lifts. With no elastic victim
  in range the plan degenerates to the whole-gang selection
  byte-for-byte;
- **backfill** — the queue drains out of strict precedence order only when
  a job further back fits a hole the blocked head cannot use (EASY
  backfill), bounded by ``admission_max_skips`` so the head always
  eventually places (starvation bound);
- **defragmentation** — when a whole-host gang cannot place but aggregate
  capacity suffices, sub-host gangs are migrated off nearly-free hosts via
  the ``migrate_gang`` machinery (allocate-first, loud-fail — a live
  gang is never released before its new placement exists) to compact
  fragments.

Every durable transition is bracketed by labeled crash points
(``admission.enqueue`` / ``select_victims`` / ``preempt`` / ``readmit``)
and the chaos matrix proves a daemon kill at any of them converges: one
live version, zero leaks, the victim either fully preempted or fully
running — never half-quiesced — and the journal replays exactly-once.

The port's copy of ``tpu_docker_api/service/admission.py``, whole: the
classes, the journal, victim selection, preemption, partial preemption and
grow-back, backfill, defragmentation, journal adoption, the views and the
loop, with the sharded writer plane's ``shard_fn`` and ``owned_shards``.
With the serving gateway on, the job service's ``drain_coordinator``
makes a preemption wait (deadline-bounded) for every live gateway's drain
ack before the victim's first member stop.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.schemas.job import JobState
from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.state.keys import Resource, versioned_name
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY

log = logging.getLogger(__name__)

#: the default priority ladder — weights are strictly ordered so "higher
#: class" is unambiguous; config ``priority_class_weights`` replaces it
DEFAULT_PRIORITY_CLASSES: dict[str, int] = {
    "system": 1000, "production": 100, "batch": 10, "preemptible": 1,
}
DEFAULT_CLASS = "batch"
#: how many backfill admissions may pass over a blocked head entry before
#: the queue stalls behind it (config admission_max_skips)
DEFAULT_MAX_SKIPS = 4

#: admission_wait_ms histogram buckets (milliseconds)
_WAIT_BUCKETS = (5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
                 30000, 60000)

#: phases a gang must be in to be preemptible (an in-flight restart is
#: still holding its grant; migrating gangs are left to finish first)
_PREEMPTIBLE_PHASES = ("running", "restarting")


class AdmissionRecord:
    """One unit of queued intent — everything the NEXT daemon needs to
    place this job: the family base (the spec itself lives on the queued/
    preempted ``JobState``, resolved at admission time — the declarative-
    record pattern), the priority class, the submit seq (precedence +
    seniority), and the durable skip counter for the starvation bound."""

    __slots__ = ("seq", "base", "kind", "klass", "skips", "ts", "accel",
                 "trace_id", "shard")

    def __init__(self, seq: int, base: str, kind: str, klass: str,
                 skips: int = 0, ts: float = 0.0, accel: str = "",
                 trace_id: str = "", shard: int = 0) -> None:
        self.seq = seq
        self.base = base
        self.kind = kind          # "queued" | "preempted"
        self.klass = klass
        self.skips = skips
        self.ts = ts
        self.accel = accel
        #: originating trace (the enqueueing request, or the admission
        #: pass that preempted): a later placement — possibly by another
        #: daemon after a failover — LINKS back to it
        self.trace_id = trace_id
        #: owning writer-plane shard: the record lives under that shard's
        #: sub-prefix and only that shard's leader drains it (legacy
        #: records parse to shard 0 — the flat prefix)
        self.shard = shard

    def to_json(self) -> str:
        d = {
            "seq": self.seq, "base": self.base, "kind": self.kind,
            "class": self.klass, "skips": self.skips, "ts": self.ts,
            "accel": self.accel, "traceId": self.trace_id,
        }
        if self.shard:
            d["shard"] = self.shard
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "AdmissionRecord":
        d = json.loads(raw)
        return cls(seq=int(d["seq"]), base=d["base"], kind=d["kind"],
                   klass=d["class"], skips=int(d.get("skips", 0)),
                   ts=float(d.get("ts", 0.0)), accel=d.get("accel", ""),
                   trace_id=d.get("traceId", ""), shard=int(d.get("shard", 0)))

    def key(self) -> str:
        return keys.admission_record_key(self.seq, self.shard)


class AdmissionController:
    """The admission loop + queue bookkeeping. Constructed unconditionally
    by the daemon (class validation and seniority stamping are useful even
    without the market); ``enabled`` gates the policy itself — when False,
    capacity refusal keeps today's hard-fail byte-for-byte."""

    def __init__(self, job_svc, store: StateStore, versions, slices, kv,
                 enabled: bool = False,
                 classes: dict[str, int] | None = None,
                 default_class: str = DEFAULT_CLASS,
                 max_skips: int = DEFAULT_MAX_SKIPS,
                 interval_s: float = 1.0,
                 registry: MetricsRegistry | None = None,
                 max_events: int = 256,
                 tracer=None,
                 shard_fn=None,
                 owned_shards=None,
                 store_gate=None) -> None:
        self._svc = job_svc
        #: trace sink for self-rooted per-pass spans (idle passes trimmed)
        self._tracer = tracer
        self._store = store
        self._versions = versions
        self._slices = slices
        self._kv = kv
        self.enabled = enabled
        self.classes = dict(classes) if classes else dict(
            DEFAULT_PRIORITY_CLASSES)
        self.default_class = default_class
        self.max_skips = max_skips
        self._interval = interval_s
        self._registry = registry if registry is not None else REGISTRY
        #: sharded writer plane (daemon wiring): base → owning shard for
        #: new records, and the shards THIS process leads — the drain and
        #: the journal adoption touch only those (None ⇒ single-writer,
        #: exactly today's behavior)
        self._shard_fn = shard_fn
        self._owned_shards = owned_shards
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._mu = threading.Lock()
        #: serializes admission passes (the loop vs an inline test/route
        #: trigger): two passes adopting the same record would double-place
        self._pass_mu = threading.Lock()
        #: submit sequence; None until the first journal scan (lazy, like
        #: the work queue's, so a store outage degrades instead of failing
        #: construction)
        self._seq: int | None = None
        #: anti-churn guard: head base → the grant-set snapshot a
        #: preemption round was decided on that then FAILED to place the
        #: head (the fits() heuristic lost to fragmentation). While the
        #: grant set is unchanged, re-preempting would replay the exact
        #: same futile eviction — victims re-admit, pool returns to this
        #: snapshot, loop forever. Any real change (a placement, a
        #: release, a delete) produces a new snapshot and re-arms.
        self._preempt_futile: dict[str, frozenset] = {}
        #: store-outage hold (service/store_health.py): an admission or
        #: preemption decided while its journal write cannot land would
        #: place/evict gangs with no durable record — the exactly-once
        #: ledger breaks. None ⇒ ungated (pre-brownout behavior).
        self._store_gate = store_gate
        self.store_skips = 0
        self._store_held = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    # -- classes ------------------------------------------------------------------

    def resolve_class(self, name: str) -> str:
        """Validated class name ("" ⇒ the configured default)."""
        pc = name or self.default_class
        if pc not in self.classes:
            raise errors.BadRequest(
                f"unknown priorityClass {pc!r}: configured classes are "
                f"{sorted(self.classes, key=self.classes.get, reverse=True)}")
        return pc

    def weight(self, name: str) -> int:
        return self.classes.get(name, 0)

    # -- seq / records ------------------------------------------------------------

    def next_seq(self) -> int:
        """Monotonic submit sequence — also stamped on immediately-placed
        jobs, so victim selection's youngest-first rule has one total
        order across queued and running work."""
        with self._mu:
            if self._seq is None:
                top = -1
                for k in self._kv.range_prefix(keys.ADMISSION_PREFIX):
                    tail = k.rsplit("/", 1)[-1]
                    if tail.isdigit():
                        top = max(top, int(tail))
                # running jobs carry their submit seq too — resume past it
                for base in self._versions.snapshot():
                    latest = self._versions.get(base)
                    if latest is None:
                        continue
                    try:
                        st = self._store.get_job(versioned_name(base, latest))
                    except errors.NotExistInStore:
                        continue
                    top = max(top, st.submitted_seq)
                self._seq = top + 1
            out = self._seq
            self._seq += 1
            return out

    def _shard_for(self, base: str) -> int:
        if self._shard_fn is None:
            return 0
        try:
            return int(self._shard_fn(base))
        except Exception:  # noqa: BLE001 — must not lose the record
            log.exception("admission: shard classification failed for %s; "
                          "routing to shard 0", base)
            return 0

    def _owned(self) -> frozenset | None:
        return (self._owned_shards() if self._owned_shards is not None
                else None)

    def reset_seq_cache(self) -> None:
        """Shard-takeover invalidation (daemon's on-acquire hook): the
        previous holder allocated sequence numbers this process never
        observed — re-seed from the journal before the next submit."""
        with self._mu:
            self._seq = None

    def records(self) -> list[AdmissionRecord]:
        out = []
        for key, raw in sorted(
                self._kv.range_prefix(keys.ADMISSION_PREFIX).items()):
            try:
                out.append(AdmissionRecord.from_json(raw))
            except (ValueError, KeyError, TypeError):
                log.warning("admission: unreadable record at %s", key)
        return out

    def _ordered(self, records: list[AdmissionRecord] | None = None
                 ) -> list[AdmissionRecord]:
        """Precedence order: class weight desc, preempted — and grow-back,
        which is the partial-preemption victim's re-admission — before
        queued within a class (both already held the capacity once; they
        re-admit ahead of equal-priority newcomers), then submit order."""
        if records is None:
            records = self.records()
        return sorted(records, key=lambda r: (
            -self.weight(r.klass),
            0 if r.kind in ("preempted", "growback") else 1, r.seq))

    def position(self, base: str) -> int | None:
        """1-based queue position of a family, or None when not queued."""
        for i, rec in enumerate(self._ordered()):
            if rec.base == base:
                return i + 1
        return None

    # -- enqueue (called by JobService.run_job under the family lock) -------------

    def enqueue(self, base: str, req, want: int, priority_class: str) -> dict:
        """Park a capacity-refused job as phase ``queued``: version 0
        ``JobState`` (the spec, resolved at admission time) + the admission
        record, ONE atomic apply — queued intent and the record can never
        disagree, and both survive any crash after the commit."""
        seq = self.next_seq()
        version = self._versions.next_version(base)
        per_host = self._svc.pod.chips_per_host
        st = JobState(
            job_name=versioned_name(base, version), version=version,
            image=req.image_name, cmd=list(req.cmd), env=list(req.env),
            binds=list(req.binds), chip_count=want, coordinator_port=0,
            placements=[], num_slices=req.num_slices, phase="queued",
            priority_class=priority_class, submitted_seq=seq,
            # the elastic contract is resolved at submit time like the
            # rest of the spec, so an admission after any number of
            # failovers still places an elastic gang
            elastic=req.elastic,
            min_members=(req.min_members or 1) if req.elastic else 0,
            members_desired=want // per_host if req.elastic else 0,
        )
        rec = AdmissionRecord(seq=seq, base=base, kind="queued",
                              klass=priority_class, ts=time.time(),
                              accel=req.accelerator_type,
                              trace_id=trace.current_trace_id(),
                              shard=self._shard_for(base))
        try:
            self._kv.apply(
                StateStore._put_ops(Resource.JOBS, base, version,
                                    st.to_dict())
                + [("put", rec.key(), rec.to_json())])
        except Exception:
            # nothing durable landed (the apply is atomic): drop the
            # version bump so the family does not exist half-made
            self._versions.rollback(base, None)
            raise
        crash_point("admission.enqueue")
        pos = self.position(base) or 1
        self._record("job-queued", base, klass=priority_class, seq=seq,
                     position=pos)
        self._update_gauges()
        self._wake.set()
        log.info("admission: queued %s (%s, seq %d, position %d): pool "
                 "full", base, priority_class, seq, pos)
        return {
            "name": st.job_name, "version": version, "image": st.image,
            "chipCount": want, "coordinatorPort": 0, "desiredRunning": True,
            "phase": "queued", "restarts": 0, "numSlices": st.num_slices,
            "processes": [], "priorityClass": priority_class,
            "queueable": True, "queuePosition": pos,
        }

    def discard(self, base: str) -> bool:
        """Drop a family's admission record (stop dequeues, delete purges).
        Caller holds the family lock; returns True when a record existed."""
        doomed = [rec for rec in self.records() if rec.base == base]
        for rec in doomed:
            self._kv.delete(rec.key())
            self._record("job-dequeued", base, klass=rec.klass, seq=rec.seq)
        if doomed:
            self._update_gauges()
        return bool(doomed)

    def enqueue_growback(self, base: str, klass: str) -> int:
        """Journal the durable grow-back intent of a shrunken elastic
        gang (called by ``JobService.resize_gang`` after a shrink lands):
        a ``kind == "growback"`` record at the job's own class,
        re-admitted with preempted-grade precedence — the victim of a
        partial preemption restores capacity it already held, exactly
        like a whole-gang victim does. One pending grow-back per family:
        a re-shrink replaces the record (the newest target governs; the
        job's ``members_desired`` is the declarative truth either way).
        Returns the 1-based queue position."""
        for r in self.records():
            if r.base == base and r.kind == "growback":
                self._kv.delete(r.key())
        seq = self.next_seq()
        rec = AdmissionRecord(seq=seq, base=base, kind="growback",
                              klass=klass, ts=time.time(),
                              trace_id=trace.current_trace_id(),
                              shard=self._shard_for(base))
        self._kv.put(rec.key(), rec.to_json())
        pos = self.position(base) or 1
        self._record("job-growback-queued", base, klass=klass, seq=seq,
                     position=pos)
        self._update_gauges()
        self._wake.set()
        log.info("admission: grow-back of %s queued (%s, seq %d, "
                 "position %d)", base, klass, seq, pos)
        return pos

    def _await_gateway_drain(self, base: str, st: JobState) -> None:
        """Drain-aware preemption (service/gateway.py): the atomic
        phase→preempted flip just applied IS the gateway's drain signal
        — the routing table folds the phase and stops picking the
        replica immediately. For service-owned replicas behind a
        gateway, give every live gateway instance a deadline-bounded
        window to finish in-flight streams before the first member stop
        so a preemption drops zero requests. Plain gangs and
        gateway-less deployments skip this entirely (no store reads, no
        sleeps — preemption latency is unchanged)."""
        coord = getattr(self._svc, "drain_coordinator", None)
        if coord is None:
            return
        from tpu_docker_api_torch.schemas.service import owner_from_env

        if owner_from_env(st.env) is None:
            return
        deadline_s = getattr(self._svc, "drain_deadline_s", 0.0)
        version = keys.split_versioned_name(st.job_name)[1]
        acked = coord.wait_drained(base, deadline_s, version=version)
        self._record("job-drain-acked" if acked else "job-drain-deadline",
                     base, klass=st.priority_class)

    def park_preempted(self, base: str, reason: str = "") -> JobState | None:
        """Park a gang as ``preempted`` outside the victim-selection path
        — the resize-exhaustion fallback (service/job.py): an elastic gang
        that cannot place at ANY legal size right now must not die when a
        market exists to re-admit it. Same crash contract as
        ``_preempt_one`` steps 2-4: ONE atomic apply (phase flip +
        re-admission record), gang-ordered quiesce, bulk release — all
        no-ops where the failed resize already got that far. Returns the
        parked state, or None when the job raced away."""
        with self._svc.family_lock(base):
            latest = self._versions.get(base)
            if latest is None:
                return None
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                return None
            if (not st.desired_running
                    or st.phase in ("failed", "stopped", "queued",
                                    "preempted")):
                return None
            seq = self.next_seq()
            parked = JobState.from_dict({
                **st.to_dict(), "phase": "preempted",
                "preemptions": st.preemptions + 1,
            })
            rec = AdmissionRecord(seq=seq, base=base, kind="preempted",
                                  klass=st.priority_class, ts=time.time(),
                                  trace_id=trace.current_trace_id(),
                                  shard=self._shard_for(base))
            self._kv.apply(
                StateStore._put_ops(Resource.JOBS, base, st.version,
                                    parked.to_dict())
                + [("put", rec.key(), rec.to_json())])
            self._await_gateway_drain(base, st)
            self._svc._stop_members(st, reverse=True)
            self._svc._release_version_resources(st)
            self._registry.counter_inc(
                "preemptions_total", {"victim_class": st.priority_class},
                help="Gangs preempted by higher-priority admissions")
            self._record("job-preempted", base, klass=st.priority_class,
                         reason=reason, seq=seq,
                         preemptions=parked.preemptions)
            self._update_gauges()
            self._wake.set()
            log.info("admission: parked %s preempted: %s", base,
                     reason or "resize exhausted")
            return parked

    # -- the admission pass -------------------------------------------------------

    def admit_once(self) -> list[dict]:
        """One pass over the queue in precedence order:

        1. every entry gets a plain placement attempt (holes are filled
           without any preemption — backfill proven, not asserted);
        2. the FIRST blocked entry (the effective head) may additionally
           preempt strictly-lower-priority gangs, then defragment;
        3. QUEUED entries admitted PAST a blocked one bump the blocked
           entry's durable ``skips`` counter; once any blocked entry has
           exhausted ``admission_max_skips``, queued work stops
           overtaking it until it places (the starvation bound).

        PREEMPTED records — and GROW-BACK records, the partial-preemption
        victims' re-admissions — are exempt from the starvation gate on
        both sides: re-admitting a victim restores capacity it already
        held — that neither charges the head a skip nor may be stalled by
        it (a max-skipped head that preempted victims it then failed to
        place onto must never strand them dormant on idle capacity).
        Grow-backs additionally never preempt or defragment: a gang grows
        back when pressure LIFTS, it does not create pressure of its own.
        """
        if self._store_gate is not None and not self._store_gate():
            # store outage: hold the pass — every admission/preemption
            # must journal before it acts. Edge-triggered event.
            self.store_skips += 1
            if not self._store_held:
                self._store_held = True
                self._record("store-outage-hold", "*")
            return []
        if self._store_held:
            self._store_held = False
            self._record("store-outage-over", "*")
        outcomes: list[dict] = []
        owned = self._owned()
        with trace.pass_span(self._tracer, "admission.pass") as span, \
                self._pass_mu:
            if span is not None and owned is not None:
                # bounded cardinality: shard ids, never family names
                span.attrs["shard"] = ",".join(map(str, sorted(owned)))
            blocked: list[AdmissionRecord] = []

            def gated() -> bool:
                return any(b.skips >= self.max_skips for b in blocked)

            records = self._ordered()
            if owned is not None:
                # sharded plane: drain ONLY the shards this process leads.
                # Precedence within each shard is exact; cross-shard
                # precedence is arbitrated by capacity itself — every
                # placement's claim serializes through the coordination
                # record (docs/robustness.md "Sharded writer plane")
                records = [r for r in records if r.shard in owned]
            for rec in records:
                if rec.kind == "queued" and gated():
                    # starvation bound: queued work stalls behind a
                    # maximally-skipped head until it places
                    continue
                placed = self._try_admit(rec)
                if placed is False and not blocked \
                        and rec.kind != "growback":
                    # the effective head: preemption, then defragmentation
                    snap = frozenset(self._slices.grants_view())
                    if self._preempt_for(rec, snap):
                        placed = self._try_admit(rec)
                        if placed is False:
                            # victims quiesced yet the head STILL lost to
                            # the scheduler (fits() is a count heuristic):
                            # remember the decision-time snapshot so the
                            # identical state is never evicted for again
                            self._preempt_futile[rec.base] = snap
                    if placed is False and self._defragment_for(rec):
                        placed = self._try_admit(rec)
                if placed is None:
                    continue  # stale record, settled — never 'blocked'
                if placed:
                    outcomes.append({"job": rec.base, "result": "placed",
                                     "class": rec.klass})
                    if blocked and rec.kind == "queued":
                        self._bump_skips(blocked)
                else:
                    blocked.append(rec)
            if span is not None:
                span.attrs["placed"] = len(outcomes)
                span.attrs["blocked"] = len(blocked)
        if outcomes:
            self._update_gauges()
        return outcomes

    def _try_admit(self, rec: AdmissionRecord) -> bool | None:
        """Place one queued/preempted job if capacity allows. Returns True
        (placed), False (no capacity), or None (record was stale and has
        been settled). The spec is read from the stored ``JobState`` at
        execution time, under the family lock."""
        base = rec.base
        # the placement span LINKS the record's originating trace: after a
        # failover the journal is all that connects the user's enqueue to
        # the daemon that finally placed it
        with trace.child(f"admission.place:{base}", seq=rec.seq) as span:
            if span is not None and rec.trace_id:
                span.links = (rec.trace_id,)
            if rec.kind == "growback":
                return self._try_growback_locked(rec, base)
            return self._try_admit_locked(rec, base)

    def _try_admit_locked(self, rec: AdmissionRecord,
                          base: str) -> bool | None:
        with self._svc.family_lock(base):
            latest = self._versions.get(base)
            if latest is None:
                # family deleted out from under the record
                self._kv.delete(rec.key())
                self._preempt_futile.pop(base, None)
                return None
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                return None  # half-made version; the reconciler's case
            if st.phase not in ("queued", "preempted"):
                # already placed (a readmit-crash replay) or stopped/
                # failed/deleted-keep-spec: settle the record exactly-once
                self._kv.delete(rec.key())
                self._preempt_futile.pop(base, None)
                self._record("admission-record-settled", base,
                             phase=st.phase, seq=rec.seq)
                return None
            carry = self._svc._carry_identity(st)
            try:
                new_st = self._svc._run_version(
                    base, st.image, st.cmd, st.env, st.binds, st.chip_count,
                    rec.accel, num_slices=st.num_slices, carry=carry)
            except (errors.ChipNotEnough, errors.PortNotEnough):
                return False
            crash_point("admission.readmit")
            self._kv.delete(rec.key())
            self._preempt_futile.pop(base, None)
            wait_ms = max(0.0, (time.time() - rec.ts) * 1e3) if rec.ts else 0.0
            self._registry.observe(
                "admission_wait_ms", wait_ms, {"class": rec.klass},
                buckets=_WAIT_BUCKETS,
                help="Queue wait from enqueue/preemption to placement (ms)")
            self._registry.counter_inc(
                "admissions_total", {"class": rec.klass, "kind": rec.kind},
                help="Queued/preempted jobs placed by the admission loop")
            self._record("job-admitted", base, klass=rec.klass,
                         via=rec.kind, version=new_st.version,
                         wait_ms=round(wait_ms, 1), skips=rec.skips)
            log.info("admission: placed %s (%s, %s) as %s after %.0f ms",
                     base, rec.klass, rec.kind, new_st.job_name, wait_ms)
            return True

    def _try_growback_locked(self, rec: AdmissionRecord,
                             base: str) -> bool | None:
        """Grow a shrunken elastic gang back toward ``members_desired``.
        Returns True (grown), False (no capacity yet, or the gang is
        dormant/mid-repair — the record keeps waiting), or None (stale —
        the gang already grew back, stopped, failed or vanished; the
        record is settled exactly-once). Growth only happens when the
        count heuristic says the FULL size fits with the gang's own grant
        re-used — pressure must actually have lifted."""
        with self._svc.family_lock(base):
            latest = self._versions.get(base)
            if latest is None:
                self._kv.delete(rec.key())
                return None
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                return None  # half-made version; the reconciler's case
            desired = st.members_desired or 0
            cur = len(st.placements)
            if (not st.elastic or not st.desired_running
                    or st.phase in ("failed", "stopped")
                    or (st.phase == "running" and cur >= desired)):
                # grown back already (or a rescale restored it), stopped,
                # failed, or no longer elastic: settle exactly-once
                self._kv.delete(rec.key())
                self._record("admission-record-settled", base,
                             phase=st.phase, seq=rec.seq)
                return None
            if st.phase != "running":
                # queued/preempted/restarting/migrating/scaling: the gang
                # grows back after its current transition settles
                return False
            if not getattr(self._svc, "resize_enabled", True):
                # job_resize_enabled=false disables EVERY automatic
                # resize decision — the record parks (not settled:
                # re-enabling the gate resumes the grow-back)
                return False
            per_host = self._svc.pod.chips_per_host
            if not self._slices.fits(desired * per_host, 1,
                                     assume_freed={st.job_name}):
                return False
            try:
                new_st = self._svc.resize_gang(base, desired,
                                               reason="growback")
            except (errors.ChipNotEnough, errors.PortNotEnough):
                return False
            except errors.ApiError as e:
                log.info("admission: grow-back of %s declined: %s", base, e)
                return False
            if len(new_st.placements) < desired:
                # the grow fell back to a smaller size (fragmentation):
                # resize_gang re-journaled a fresh grow-back record — this
                # one is superseded, keep waiting
                return False
            crash_point("admission.readmit")
            self._kv.delete(rec.key())
            wait_ms = max(0.0, (time.time() - rec.ts) * 1e3) if rec.ts else 0.0
            self._registry.observe(
                "admission_wait_ms", wait_ms, {"class": rec.klass},
                buckets=_WAIT_BUCKETS,
                help="Queue wait from enqueue/preemption to placement (ms)")
            self._registry.counter_inc(
                "admissions_total", {"class": rec.klass, "kind": "growback"},
                help="Queued/preempted jobs placed by the admission loop")
            self._record("job-admitted", base, klass=rec.klass,
                         via="growback", version=new_st.version,
                         members=len(new_st.placements),
                         wait_ms=round(wait_ms, 1))
            log.info("admission: grew %s back to %d members (%s) after "
                     "%.0f ms", base, len(new_st.placements), rec.klass,
                     wait_ms)
            return True

    def _bump_skips(self, blocked: list[AdmissionRecord]) -> None:
        """A later entry was admitted past these blocked ones: charge each
        of them one skip, durably — the starvation bound must survive a
        daemon restart mid-backfill. Grow-back records are never charged:
        they wait for pressure to lift by design (possibly forever on a
        busy pool), and a max-skipped grow-back would trip the gate and
        freeze every queued admission for a gang that is already
        RUNNING — the opposite of 'a grow-back creates no pressure of
        its own'."""
        for b in blocked:
            if b.kind == "growback":
                continue
            b.skips += 1
            try:
                if self._kv.get_or(b.key()) is None:
                    # settled/purged since this pass scanned it (a racing
                    # delete_job): re-putting would resurrect a ghost
                    continue
                self._kv.put(b.key(), b.to_json())
            except Exception as e:  # noqa: BLE001 — bookkeeping, not policy
                log.warning("admission: skip bump for %s failed: %s",
                            b.base, e)

    # -- preemption ---------------------------------------------------------------

    def _eligible(self, weight: int,
                  requester: str) -> list[tuple[int, int, str, JobState]]:
        """Preemptible gangs strictly below ``weight``, in victim order:
        lowest-priority first, then YOUNGEST first (largest submitted_seq;
        the paged.py seniority rule — juniors can never displace seniors,
        so preemption terminates), base name as the deterministic
        tie-break."""
        eligible: list[tuple[int, int, str, JobState]] = []
        for base in self._versions.snapshot():
            if base == requester:
                continue
            latest = self._versions.get(base)
            if latest is None:
                continue
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                continue
            w = self.weight(st.priority_class)
            if (w < weight and st.desired_running
                    and st.phase in _PREEMPTIBLE_PHASES):
                eligible.append((w, -st.submitted_seq, base, st))
        eligible.sort(key=lambda e: (e[0], e[1], e[2]))
        return eligible

    def _victims_for(self, weight: int, want: int, num_slices: int,
                     requester: str,
                     eligible: list | None = None) -> list[str]:
        """WHOLE-gang victims whose release would (by the count heuristic)
        make the ask placeable — the minimal prefix of the eligibility
        order. Empty ⇒ no feasible combination (nothing is quiesced on a
        hunch). Whole-gang semantics, byte-for-byte: the partial-preemption
        planner falls back to exactly this when no elastic donor exists
        (passing its already-computed ``eligible`` scan — one store walk
        per planning round, not two)."""
        chosen: list[str] = []
        freed: set[str] = set()
        if eligible is None:
            eligible = self._eligible(weight, requester)
        for _, _, base, st in eligible:
            chosen.append(base)
            vname = versioned_name(base, st.version)
            freed.add(vname)
            freed.update(f"{vname}#s{k}" for k in range(st.num_slices))
            if self._slices.fits(want, num_slices, assume_freed=freed):
                return chosen
        return []

    @staticmethod
    def _is_donor(st: JobState) -> bool:
        """An elastic gang with spare members to donate: running (an
        in-flight restart is not shrunk under), single-slice, and above
        its ``min_members`` floor."""
        return (st.elastic and st.num_slices == 1
                and st.phase == "running" and st.desired_running
                and len(st.placements) > max(st.min_members, 1))

    def _preempt_plan(self, weight: int, want: int, num_slices: int,
                      requester: str) -> list[tuple[str, str, int]]:
        """The victim plan: ``("shrink", base, keep_members)`` entries
        (spare members taken from elastic gangs) followed by
        ``("full", base, 0)`` entries (whole-gang preemptions). Phase 1
        walks the eligibility order donating ONE member at a time from
        each elastic gang (minimal feasible set — lowest class first,
        youngest first) and stops the moment the count heuristic says the
        ask fits: when shrink suffices, NO whole gang dies. Phase 2 — only
        if every spare member together still cannot make room — condemns
        whole gangs in the same order, upgrading an already-planned shrink
        to a full preemption (its floor members are capacity too). Empty
        plan ⇒ no feasible combination, nothing is touched on a hunch.

        With no elastic donor in range (or resizing disabled) the plan is
        exactly ``_victims_for`` — the whole-gang selection,
        byte-for-byte."""
        eligible = self._eligible(weight, requester)
        donors = [e for e in eligible if self._is_donor(e[3])]
        if not donors or not getattr(self._svc, "resize_enabled", True):
            return [("full", b, 0)
                    for b in self._victims_for(weight, want, num_slices,
                                               requester,
                                               eligible=eligible)]
        base_free = self._slices.free_view()
        shrink: dict[str, int] = {}   # base → members kept (insertion order)
        full: list[str] = []

        def grant_hosts(st: JobState) -> list[tuple[str, list[int]]]:
            vname = versioned_name(
                keys.split_versioned_name(st.job_name)[0], st.version)
            owners = ([vname] if st.num_slices == 1
                      else [f"{vname}#s{k}" for k in range(st.num_slices)])
            hosts: list[tuple[str, list[int]]] = []
            for o in owners:
                g = self._slices.get_grant(o)
                if g is not None:
                    hosts.extend(g.hosts)
            return hosts

        # grants are stable for the duration of the plan: fetch each
        # victim's host list once, not once per simulation step
        hosts_of = {base: grant_hosts(st) for _, _, base, st in eligible}

        def feasible() -> bool:
            # simulate the frees: a shrink keeps its first ``kept`` member
            # hosts (grant order == process order) and frees the rest; a
            # full preemption frees everything
            free = dict(base_free)
            for b in list(shrink) + full:
                kept = 0 if b in full else shrink[b]
                for hid, chips in hosts_of[b][kept:]:
                    if hid in free:
                        free[hid] += len(chips)
            return self._slices.fits_counts(want, num_slices, free)

        # phase 1 — spare members only, one host at a time
        for _, _, b, st in eligible:
            if not self._is_donor(st):
                continue
            floor = max(st.min_members, 1)
            for kept in range(len(st.placements) - 1, floor - 1, -1):
                shrink[b] = kept
                if feasible():
                    return [("shrink", x, k) for x, k in shrink.items()]
        # phase 2 — whole gangs (shrink plans upgrade to full)
        for _, _, b, st in eligible:
            full.append(b)
            shrink.pop(b, None)
            if feasible():
                return ([("shrink", x, k) for x, k in shrink.items()]
                        + [("full", x, 0) for x in full])
        return []

    def _preempt_for(self, rec: AdmissionRecord,
                     snap: frozenset | None = None) -> bool:
        """Select and preempt (or partially preempt) victims for a blocked
        entry. Returns True when at least one victim donated capacity —
        spare members from an elastic shrink, or a whole gang — so the
        caller retries placement. ``snap`` is the caller's decision-time
        grant-set snapshot: when it matches a round already proven futile
        for this head, nothing is evicted again."""
        if snap is not None and self._preempt_futile.get(rec.base) == snap:
            return False
        latest = self._versions.get(rec.base)
        if latest is None:
            return False
        try:
            st = self._store.get_job(versioned_name(rec.base, latest))
        except errors.NotExistInStore:
            return False
        weight = self.weight(rec.klass)
        plan = self._preempt_plan(weight, st.chip_count, st.num_slices,
                                  rec.base)
        if not plan:
            return False
        acted = 0
        for kind, victim, kept in plan:
            if kind == "shrink":
                if self._shrink_one(victim, kept, for_base=rec.base,
                                    requester_weight=weight):
                    acted += 1
            elif self._preempt_one(victim, for_base=rec.base,
                                   requester_weight=weight):
                acted += 1
        return acted > 0

    def _shrink_one(self, base: str, keep_members: int, for_base: str,
                    requester_weight: int) -> bool:
        """Partially preempt one elastic gang: shrink it to
        ``keep_members`` hosts through ``JobService.resize_gang`` (intent
        persisted first, gang-ordered quiesce, ONE-apply release+claim
        delta, grow-back record journaled) — the gang keeps training at
        reduced batch size instead of dying. Eligibility (still running,
        still strictly lower class, still above its floor) re-validates
        under the victim's family lock inside resize_gang; a user stop or
        priority retune that raced in wins."""
        crash_point("admission.partial_preempt")
        try:
            st = self._svc.resize_gang(
                base, keep_members, reason="partial-preemption",
                require_weight_below=requester_weight)
        except errors.ApiError as e:
            log.info("admission: partial preemption of %s declined: %s",
                     base, e)
            return False
        self._registry.counter_inc(
            "preemptions_partial_total",
            {"victim_class": st.priority_class},
            help="Elastic gangs shrunk by partial preemption (spare "
                 "members donated instead of whole-gang eviction)")
        self._record("job-partially-preempted", base,
                     klass=st.priority_class, for_job=for_base,
                     keptMembers=len(st.placements))
        log.info("admission: partially preempted %s (kept %d members) "
                 "for %s", base, len(st.placements), for_base)
        return True

    def _preempt_one(self, base: str, for_base: str,
                     requester_weight: int) -> bool:
        """Fully preempt one gang, crash-consistently:

        1. re-validate under the victim's family lock (a user stop or a
           priority retune that raced in wins — never condemn on a stale
           snapshot);
        2. ONE atomic apply: ``JobState`` phase → ``preempted`` + the
           re-admission record — intent and record can never disagree;
        3. quiesce through the gang stop path (workers first, coordinator
           LAST; checkpoint binds intact, so re-admission resumes from the
           step the victim flushed at);
        4. release every slice and port in one atomic batch (bulk
           release).

        A crash before step 2 leaves the victim fully running; after it,
        the reconciler's dormant-phase repair finishes the quiesce and
        release — never half-quiesced either way."""
        with self._svc.family_lock(base):
            latest = self._versions.get(base)
            if latest is None:
                return False
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                return False
            if (not st.desired_running
                    or st.phase not in _PREEMPTIBLE_PHASES
                    or self.weight(st.priority_class) >= requester_weight):
                return False
            crash_point("admission.select_victims")
            seq = self.next_seq()
            parked = JobState.from_dict({
                **st.to_dict(), "phase": "preempted",
                "preemptions": st.preemptions + 1,
            })
            rec = AdmissionRecord(seq=seq, base=base, kind="preempted",
                                  klass=st.priority_class, ts=time.time(),
                                  trace_id=trace.current_trace_id(),
                                  shard=self._shard_for(base))
            self._kv.apply(
                StateStore._put_ops(Resource.JOBS, base, st.version,
                                    parked.to_dict())
                + [("put", rec.key(), rec.to_json())])
            crash_point("admission.preempt")
            self._await_gateway_drain(base, st)
            self._svc._stop_members(st, reverse=True)
            crash_point("admission.preempt")
            self._svc._release_version_resources(st)
            self._registry.counter_inc(
                "preemptions_total", {"victim_class": st.priority_class},
                help="Gangs preempted by higher-priority admissions")
            self._record("job-preempted", base, klass=st.priority_class,
                         for_job=for_base, seq=seq,
                         preemptions=parked.preemptions)
            log.info("admission: preempted %s (%s) for %s", base,
                     st.priority_class, for_base)
            return True

    # -- defragmentation ----------------------------------------------------------

    def _defragment_for(self, rec: AdmissionRecord) -> bool:
        """Whole-host asks blocked by fragmentation, not scarcity: migrate
        sub-host gangs off nearly-free hosts (fewest-used first) via
        ``migrate_gang``'s allocate-first path — loud-fail, so a live gang
        is never released before its new placement exists — until enough
        fully-free hosts exist. Only gangs at-or-below the requester's
        weight are moved, and a single failed migration aborts the pass
        (the gang keeps running where it is)."""
        latest = self._versions.get(rec.base)
        if latest is None:
            return False
        try:
            st = self._store.get_job(versioned_name(rec.base, latest))
        except errors.NotExistInStore:
            return False
        per_host = self._svc.pod.chips_per_host
        per_slice = st.chip_count // max(st.num_slices, 1)
        if per_slice < per_host or len(self._svc.pod.hosts) == 1:
            return False  # sub-host asks never need whole-host compaction
        free_total = sum(len(h.chips.free_chips)
                         for h in self._svc.pod.hosts.values())
        if free_total < st.chip_count:
            return False  # scarcity, not fragmentation
        hosts_needed = (per_slice // per_host) * st.num_slices
        weight = self.weight(rec.klass)
        moved = False
        for _ in range(hosts_needed):
            fully_free = sum(
                1 for h in self._svc.pod.hosts.values()
                if len(h.chips.free_chips) == h.topology.n_chips)
            if fully_free >= hosts_needed:
                break
            target = self._pick_defrag_host(weight)
            if target is None:
                break
            for victim_base in self._host_gangs(target):
                try:
                    self._svc.migrate_gang(
                        victim_base, exclude_hosts={target},
                        reason=f"defragment for {rec.base}",
                        count_migration=False, release_first_ok=False)
                    moved = True
                    self._record("job-defrag-migrated", victim_base,
                                 host=target, for_job=rec.base)
                except errors.ApiError as e:
                    log.info("admission: defrag migration of %s off %s "
                             "failed: %s", victim_base, target, e)
                    return moved
        return moved

    def _pick_defrag_host(self, max_weight: int) -> str | None:
        """The cheapest host to vacate: fewest used chips, every chip
        owned by a migratable gang at-or-below the requester's weight."""
        best: tuple[int, str] | None = None
        for hid, host in sorted(self._svc.pod.hosts.items()):
            used = host.topology.n_chips - len(host.chips.free_chips)
            if used == 0 or used == host.topology.n_chips:
                continue
            gangs = self._host_gangs(hid)
            if not gangs:
                continue
            movable = True
            for base in gangs:
                latest = self._versions.get(base)
                if latest is None:
                    movable = False
                    break
                try:
                    st = self._store.get_job(versioned_name(base, latest))
                except errors.NotExistInStore:
                    movable = False
                    break
                if (st.phase not in _PREEMPTIBLE_PHASES
                        or self.weight(st.priority_class) > max_weight
                        or any(len(c) >= self._svc.pod.chips_per_host
                               for h, c in self._iter_grant_hosts(st)
                               if h == hid)):
                    movable = False
                    break
            if movable and (best is None or used < best[0]):
                best = (used, hid)
        return best[1] if best else None

    def _iter_grant_hosts(self, st: JobState):
        vname = versioned_name(
            keys.split_versioned_name(st.job_name)[0], st.version)
        owners = ([vname] if st.num_slices == 1
                  else [f"{vname}#s{k}" for k in range(st.num_slices)])
        for owner in owners:
            grant = self._slices.get_grant(owner)
            if grant is not None:
                yield from grant.hosts

    def _host_gangs(self, host_id: str) -> list[str]:
        """Job families holding a grant that touches ``host_id``."""
        out = []
        for owner, grant in sorted(self._slices.grants_view().items()):
            if any(h == host_id for h, _ in grant.hosts):
                base = keys.job_owner_base(owner)
                if base not in out and self._versions.get(base) is not None:
                    out.append(base)
        return out

    # -- reconciliation (journal adoption; driven by the reconciler) --------------

    def reconcile_records(self, dry_run: bool = False) -> list[dict]:
        """Exactly-once journal adoption after a crash or failover:

        - a record whose family is gone is purged;
        - a record whose job already left the queue (placed by a
          readmit-crash run, stopped, failed) is settled — the replay
          never double-places; a grow-back record settles once the gang
          is back at full size (or stopped being elastic/running);
        - a queued/preempted job that somehow lost its record (defensive:
          the enqueue/preempt applies are atomic, so this means manual
          store surgery) is re-journaled so it cannot be stranded — and
          so is a shrunken elastic gang with no grow-back record (the
          resize-to-grow-back window is two applies; a daemon death
          between them must not orphan the shrink).

        Returns the actions (performed, or planned under ``dry_run``)."""
        actions: list[dict] = []
        owned = self._owned()
        seen_bases: set[str] = set()
        growback_bases: set[str] = set()
        for rec in self.records():
            if owned is not None and rec.shard not in owned:
                # another shard's leader adopts its own journal
                seen_bases.add(rec.base)
                continue
            seen_bases.add(rec.base)
            latest = self._versions.get(rec.base)
            st = None
            if latest is not None:
                try:
                    st = self._store.get_job(
                        versioned_name(rec.base, latest))
                except errors.NotExistInStore:
                    st = None
            if st is None:
                actions.append({"action": "purge-admission-record",
                                "target": rec.base, "seq": rec.seq})
                if not dry_run:
                    self._kv.delete(rec.key())
                continue
            if rec.kind == "growback":
                if self._growback_stale(st):
                    actions.append({"action": "settle-admission-record",
                                    "target": rec.base, "phase": st.phase,
                                    "seq": rec.seq})
                    if not dry_run:
                        self._kv.delete(rec.key())
                else:
                    growback_bases.add(rec.base)
                continue
            if st.phase not in ("queued", "preempted"):
                actions.append({"action": "settle-admission-record",
                                "target": rec.base, "phase": st.phase,
                                "seq": rec.seq})
                if not dry_run:
                    self._kv.delete(rec.key())
        for base in self._versions.snapshot():
            if owned is not None and self._shard_for(base) not in owned:
                continue  # that shard's leader re-journals its own
            latest = self._versions.get(base)
            if latest is None:
                continue
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                continue
            if base not in seen_bases and st.phase in ("queued", "preempted"):
                actions.append({"action": "rejournal-admission-record",
                                "target": base, "phase": st.phase})
                if not dry_run:
                    rec = AdmissionRecord(
                        seq=self.next_seq(), base=base, kind=st.phase,
                        klass=st.priority_class, ts=time.time(),
                        shard=self._shard_for(base))
                    self._kv.put(rec.key(), rec.to_json())
            elif base not in growback_bases and self._growback_wanted(st):
                actions.append({"action": "rejournal-growback-record",
                                "target": base,
                                "members": len(st.placements),
                                "want": st.members_desired})
                if not dry_run:
                    rec = AdmissionRecord(
                        seq=self.next_seq(), base=base, kind="growback",
                        klass=st.priority_class, ts=time.time(),
                        shard=self._shard_for(base))
                    self._kv.put(rec.key(), rec.to_json())
        if actions and not dry_run:
            self._update_gauges()
        return actions

    @staticmethod
    def _growback_stale(st: JobState) -> bool:
        """A grow-back record is stale once the gang no longer needs (or
        can never use) a grow-back: back at full size, stopped, failed,
        or not elastic. Dormant/mid-repair phases keep the record — the
        gang still wants its members back after it settles."""
        if not st.elastic or not st.desired_running or st.phase == "failed":
            return True
        return (st.phase == "running"
                and len(st.placements) >= (st.members_desired or 0))

    def _growback_wanted(self, st: JobState) -> bool:
        """A running elastic gang below its desired member count wants a
        grow-back record in the journal — but only while the market (and
        resizing) is on: a record nothing will ever admit is a lie in
        the queue gauges."""
        return (self.enabled and st.elastic and st.desired_running
                and st.phase == "running"
                and 0 < len(st.placements) < (st.members_desired or 0)
                and getattr(self._svc, "resize_enabled", True))

    # -- loop lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Launch the admission loop (a WRITER: under leader election it
        runs on the lease holder only; restartable on re-acquire)."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="admission", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=self._interval + 5)
            self._thread = None

    def wake(self) -> None:
        """Cut the interval short — a delete/stop/fail just freed capacity
        the head of the queue may be waiting for."""
        self._wake.set()

    def _loop(self) -> None:
        while True:
            self._wake.wait(self._interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.admit_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("admission pass failed")

    # -- views / telemetry --------------------------------------------------------

    def _record(self, kind: str, job: str, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "job": job, "event": kind,
                           **extra})
        with self._mu:
            self._events.append(evt)

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    def _update_gauges(self) -> None:
        counts = {c: 0 for c in self.classes}
        try:
            for rec in self.records():
                counts[rec.klass] = counts.get(rec.klass, 0) + 1
        except Exception as e:  # noqa: BLE001 — telemetry must not raise
            log.warning("admission: depth gauge refresh skipped: %s", e)
            return
        for klass, n in counts.items():
            self._registry.gauge_set(
                "admission_queue_depth", n, {"class": klass},
                help="Jobs waiting in the admission queue, by class")

    def status_view(self) -> dict:
        """GET /api/v1/admission — the operator's queue view."""
        ordered = self._ordered()
        per_class: dict[str, int] = {c: 0 for c in self.classes}
        now = time.time()
        entries = []
        for i, rec in enumerate(ordered):
            per_class[rec.klass] = per_class.get(rec.klass, 0) + 1
            entries.append({
                "name": rec.base, "class": rec.klass, "state": rec.kind,
                "position": i + 1, "skips": rec.skips,
                "maxSkips": self.max_skips,
                "waitingS": round(max(0.0, now - rec.ts), 1) if rec.ts else 0,
            })
        return {
            "enabled": self.enabled,
            "classes": dict(self.classes),
            "defaultClass": self.default_class,
            "maxSkips": self.max_skips,
            "depth": len(ordered),
            "perClass": per_class,
            "entries": entries,
            # one set of books: the same counters /metrics exports
            "preemptionsTotal": self._preemptions_total(),
            "partialPreemptionsTotal": self._partial_preemptions_total(),
            "admissionsTotal": self._admissions_total(),
        }

    def _preemptions_total(self) -> int:
        return int(sum(self._registry.counter_value(
            "preemptions_total", {"victim_class": c})
            for c in self.classes))

    def _admissions_total(self) -> int:
        return int(sum(self._registry.counter_value(
            "admissions_total", {"class": c, "kind": k})
            for c in self.classes
            for k in ("queued", "preempted", "growback")))

    def _partial_preemptions_total(self) -> int:
        return int(sum(self._registry.counter_value(
            "preemptions_partial_total", {"victim_class": c})
            for c in self.classes))

    def health_view(self) -> dict:
        """Compact /healthz rider (registry read-back, never a store
        scan failure surface)."""
        try:
            depth = len(self.records())
        except Exception:  # noqa: BLE001
            depth = -1  # store unreachable; liveness must still render
        return {"enabled": self.enabled, "depth": depth,
                "preemptionsTotal": self._preemptions_total(),
                "partialPreemptionsTotal": self._partial_preemptions_total(),
                "admissionsTotal": self._admissions_total()}
