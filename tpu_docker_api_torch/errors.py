"""Error taxonomy for the control plane.

Parity: the reference's string-sentinel errors + ``Is*`` predicates
(``internal/xerrors/{common,container,volume,etcd,scheduler}.go``). Here each
sentinel is a distinct exception class so callers use ``except``/``isinstance``
instead of string matching, and every class carries the API error code it maps
to, so the HTTP layer needs no lookup table.

The port's own copy of ``tpu_docker_api/errors.py``: the same classes with
the same codes (``tests/test_torch_control_state.py`` holds every one).
"""

from __future__ import annotations


class ApiError(Exception):
    """Base class: every control-plane error maps to one API response code."""

    #: numeric API response code (filled per subclass)
    code: int = 500
    #: HTTP status the envelope rides on. The reference answers everything
    #: with 200 + app code; backpressure errors are the one exception —
    #: intermediaries and clients must see queue saturation as a retryable
    #: transport-level condition (429), not a success
    http_status: int = 200
    #: optional structured payload for the envelope's ``data`` field —
    #: normally None (the legacy error shape, byte-for-byte); a raiser may
    #: set it on the INSTANCE to attach machine-readable context (e.g. the
    #: capacity market's ``{"queueable": false}`` on a ChipNotEnough)
    data = None

    def __init__(self, msg: str = ""):
        super().__init__(msg or self.__class__.__doc__ or self.__class__.__name__)


def as_int(value, field: str) -> int:
    """Coerce a user-supplied request field to int, mapping malformed input
    to :class:`BadRequest` (code 10001) instead of letting ``ValueError``
    escape the handler as a 500 SERVER_ERROR. For request DTO ``from_dict``
    sites; internal state parsing should keep plain ``int()`` so corruption
    surfaces as a server error.

    Rejects bool (JSON ``true`` would coerce to 1), non-integral numbers
    (``3.9`` would silently truncate to 3), and digit strings (JSON callers
    must send numbers, not ``"3"``)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise BadRequest(f"{field} must be an integer")
    try:
        coerced = int(value)
        if coerced != value:
            raise ValueError
    except (TypeError, ValueError, OverflowError):  # nan/inf raise here too
        raise BadRequest(f"{field} must be an integer") from None
    return coerced


def as_float(value, field: str) -> float:
    """The float analog of :func:`as_int`: coerce a user-supplied request
    field, mapping malformed input to :class:`BadRequest` instead of a
    500. Rejects bool and NON-FINITE values — JSON's lax ``NaN`` /
    ``Infinity`` would otherwise slide through every ``< 0`` validation
    (NaN compares False against everything) and silently wedge or
    saturate whatever policy consumes the number."""
    import math

    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise BadRequest(f"{field} must be a number")
    coerced = float(value)
    if not math.isfinite(coerced):
        raise BadRequest(f"{field} must be a finite number")
    return coerced


# --- common (xerrors/common.go:7-10) ------------------------------------------

class NoPatchRequired(ApiError):
    """The patch requests the state the resource is already in."""
    code = 10201


class VersionNotMatch(ApiError):
    """Optimistic-concurrency failure: request names version N but latest is M."""
    code = 10202


class BadRequest(ApiError):
    """Request validation failure (missing field, malformed name, bad unit)."""
    code = 10001


# --- container (xerrors/container.go:7) ---------------------------------------

class ContainerExisted(ApiError):
    """A container family with this base name already exists."""
    code = 10301


class ContainerNotExist(ApiError):
    """No such container (neither running nor in the state store)."""
    code = 10302


# --- volume (xerrors/volume.go:8-10) ------------------------------------------

class VolumeExisted(ApiError):
    """A volume family with this base name already exists."""
    code = 10401


class VolumeNotExist(ApiError):
    """No such volume."""
    code = 10402


class VolumeSizeUsedGreaterThanReduced(ApiError):
    """Shrink guard: bytes in use exceed the requested new size."""
    code = 10403


# --- state store (xerrors/etcd.go:8) ------------------------------------------

class NotExistInStore(ApiError):
    """Key not found in the state store."""
    code = 10501


class StoreUnavailable(ApiError):
    """The state-store backend cannot be reached (connection refused/reset,
    timeout). Distinct from NotExistInStore: the KEY's presence is unknown,
    only the path to the store failed — the KV analog of HostUnreachable.
    EtcdKV normalizes every connection-class failure to this type (bounded
    retry+backoff on idempotent reads first); the work queue's journal
    writes catch it and degrade loudly instead of wedging the sync loop."""
    code = 10502


class GuardFailed(ApiError):
    """A guarded KV write (``KV.apply(..., guards=...)`` / ``KV.cas``) lost
    its compare: the store's current value no longer matches what the
    writer asserted. This is the typed contention-loser signal — a lease
    CAS that raced another elector, or an epoch-fenced write from a leader
    that was deposed mid-flight. NEVER blind-retried at the KV layer: the
    caller must re-read and re-decide (an elector demotes; a fenced writer
    abandons the flow for the new leader to own)."""
    code = 10503


class WatchLost(ApiError):
    """A ``KV.watch`` stream can no longer deliver a gapless event
    sequence: the changelog was compacted past the watcher's revision, a
    slow consumer overflowed its buffer, or the server canceled the
    stream. The continuation contract is broken — the ONLY correct
    recovery is a full relist (``range_prefix_with_rev``) and a fresh
    watch from the new revision, which is exactly what the informer
    (state/informer.py) does. Never silently swallowed: a cache that kept
    serving across a gap would hide deletes forever."""
    code = 10504


class ContinueExpired(ApiError):
    """A paginated list's ``continue`` token can no longer be honored: the
    page sequence is rev-anchored (every page serves the SAME store
    revision the first page did, so a walk never duplicates or skips a
    key), and either the prefix was mutated past that revision or the
    backend compacted the history needed to prove it wasn't. The
    Kubernetes analog is the list API's 410 Gone — surfaced with a real
    HTTP 410 so clients restart the walk from a fresh first page instead
    of treating a broken snapshot as data."""
    code = 10505
    http_status = 410


class StoreDegraded(ApiError):
    """The control plane is riding through a store outage (StoreHealth mode
    ``outage``, service/store_health.py): mutations are refused up front —
    typed, bounded, and with zero store round trips — because an intent
    that cannot be journaled must never half-apply. HTTP 503 with a
    ``Retry-After`` hint (``retry_after_s``, surfaced as the response
    header) so retry-aware clients back off until the store heals instead
    of burning their budget against a brownout. Reads are NOT gated: they
    serve from the informer mirror with explicit staleness, or pay the
    deadline-bounded store attempt."""
    code = 10506
    http_status = 503

    def __init__(self, msg: str = "", retry_after_s: float = 1.0,
                 data=None) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        if data is not None:
            self.data = data


# --- schedulers (xerrors/scheduler.go:8-10) -----------------------------------

class ChipNotEnough(ApiError):
    """Not enough free GPUs (or no contiguous block of them) to satisfy the ask."""
    code = 10601


class PortNotEnough(ApiError):
    """Host-port pool exhausted."""
    code = 10602


class TopologyUnknown(ApiError):
    """The requested shape or accelerator type is not a known topology, or
    the host's GPUs cannot be granted whole (MIG is on)."""
    code = 10603


# --- work queue (state/workqueue.py) ------------------------------------------

class QueueSaturated(ApiError):
    """The work queue is full and the bounded submit timed out — the daemon
    is falling behind its async backlog. Surfaced as HTTP 429 so callers
    (and proxies) treat it as retryable backpressure, never as success."""
    code = 10801
    http_status = 429


class QueueClosed(ApiError):
    """Submit raced shutdown: the sync loop is gone, so enqueueing would
    silently strand the task in a consumerless queue. Callers see a typed
    error instead; journaled records are replayed by the next daemon.
    HTTP 503 for the same reason QueueSaturated is 429: the identical
    request succeeds against the next daemon, so retry-aware clients and
    proxies must see transient backpressure, not a final app error."""
    code = 10802
    http_status = 503


# --- leader election (service/leader.py) --------------------------------------

class NotLeader(ApiError):
    """This replica is a standby: it serves reads, but mutations belong to
    the lease holder. HTTP 503 (like QueueClosed) so retry-aware clients
    and proxies treat it as transient routing, not a final app error — the
    message carries the current leader's identity as the redirect hint."""
    code = 10901
    http_status = 503


# --- host failure domains (service/host_health.py) ----------------------------

class ServiceExisted(ApiError):
    """POST /services of a name that already has a service family."""
    code = 11001


class ServiceNotExist(ApiError):
    """A /services/{name} op on an unknown service family."""
    code = 11002


class GatewayShed(ApiError):
    """The serving gateway refused admission under load — the global
    in-flight cap is reached or every candidate endpoint is saturated.
    Surfaced as HTTP 429 with Retry-After so callers treat it as
    retryable backpressure (shed, don't collapse), never as a
    connection-level failure."""
    code = 11201
    http_status = 429


class GatewayNoEndpoints(ApiError):
    """The serving gateway has no routable replica for the service —
    every endpoint is draining, ejected, or breaker-open (or the service
    has no ready replicas at all). Surfaced as HTTP 503 with Retry-After:
    the condition is transient by construction (drains finish, breakers
    half-open, the autoscaler reacts)."""
    code = 11202
    http_status = 503


class WorkflowExisted(ApiError):
    """POST /workflows of a name that already has a workflow family."""
    code = 11301


class WorkflowNotExist(ApiError):
    """A /workflows/{name} op on an unknown workflow family."""
    code = 11302


class RetryBudgetExhausted(ApiError):
    """POST /api/v1/dead-letters/retry refused for a record whose durable
    operator-retry count reached the cap — a permanently-poisoned task
    must not be re-driven forever. HTTP 409: the refusal is final for
    this record until it is deleted or the cap is raised, not transient
    backpressure."""
    code = 10803
    http_status = 409


class HostUnreachable(ApiError):
    """A pod host's container engine cannot be reached — connection refused,
    socket timeout, or the host's circuit breaker is open and fast-failing.
    Distinct from ContainerNotExist: the CONTAINER's state is unknown, only
    the path to the engine failed."""
    code = 10701


#: everything that means "the path to a host's engine is broken": the
#: normalized HostUnreachable a circuit breaker raises, plus the raw
#: socket errors (ConnectionRefused/Reset, timeouts — OSError subclasses)
#: that docker_http surfaces when a runtime is NOT breaker-wrapped (the
#: local pod host always; every host when breaker_threshold = 0). Every
#: scanner that classifies member state (supervisor, reconciler,
#: invariants, job service) must catch THIS tuple, not HostUnreachable
#: alone, or an unwrapped engine's outage reads as a scan crash instead
#: of an unreachable host.
HOST_PATH_ERRORS = (HostUnreachable, OSError)
