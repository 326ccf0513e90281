"""The port's serving gateway (``service/gateway.py`` with its
``RoutingTable``, ``rendezvous_order`` and ``DrainCoordinator``, and
``api/gateway_app.py``) against the JAX package's on the CPU: every case
of ``tests/test_gateway.py`` runs one script through each package, each
over its own set of JAX's ``StubReplica`` endpoints, and what each left
behind must be JAX's: statuses, bodies, picks, attempts, upstream hits,
the counters and routing table of ``status_view``, the events, the drain
acks and, for the cases over a ``Program``, the service, job and
container books and oracles. Stub ports read as the stubs' names; clocks
(``ewmaMs``), instance ids and hedge winners are left out, as neither
package fixes them. JAX's own assertions then hold on the port's side.
``TestGatewayChaos`` kills each package at every ``gateway.drain.*``
crash point and boots a fresh ``Program`` over the wreck."""

import http.client
import json
import threading
import time
from types import SimpleNamespace

import pytest

import test_gateway as jgw
import torch_control as tc

#: JAX's stub replica: the serve protocol's shapes over the standard
#: library, with hold and mid-stream death injection
StubReplica = jgw.StubReplica
#: generous: JAX's timing cases already flake under the loaded whole run
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def mk_gw(pkg, kv=None, **kw):
    """test_gateway.py's ``mk_gw`` in either package."""
    kw.setdefault("retry_limit", 2)
    kw.setdefault("backoff_base_s", 0.001)
    kw.setdefault("backoff_max_s", 0.005)
    kw.setdefault("breaker_cooldown_s", 0.05)
    kw.setdefault("heartbeat_s", 0.05)
    return pkg.gateway.Gateway(
        kv if kv is not None else pkg.kv.MemoryKV(),
        resolve_addr=lambda hid: "127.0.0.1", tracer=pkg.trace.Tracer(),
        **kw)


def feed(pkg, gw, base, port, version=1, service="web", **over):
    """One replica's version record and latest pointer, pushed through the
    routing table as the informer would."""
    d = {"env": [f"{pkg.ss.SERVICE_OWNER_ENV}={service}"],
         "phase": "running", "desired_running": True,
         "placements": [["h0", f"{base}-c0"]], "coordinator_port": port,
         **over}
    gw.table._observe_job(SimpleNamespace(
        op="put", key=f"{pkg.keys.PREFIX}/jobs/{base}/v/{version:010d}",
        value=json.dumps(d)))
    gw.table._observe_job(SimpleNamespace(
        op="put", key=f"{pkg.keys.PREFIX}/jobs/{base}/latest",
        value=str(version)))


def wait_for(cond, what="condition"):
    jgw.wait_for(cond, timeout=WAIT_S, what=what)


class Stubs:
    """One package's run's stub replicas, by name."""

    def __init__(self, **specs):
        self.by = {name: StubReplica(**kw) for name, kw in specs.items()}
        for name, spec in specs.items():
            if spec.get("mode") in ("hang", "held_stream",
                                    "fail_then_held_stream"):
                self.by[name].release.clear()

    def __getitem__(self, name):
        return self.by[name]

    def hits(self) -> dict:
        return {n: s.hits for n, s in sorted(self.by.items())}

    def named(self, obj):
        """``obj`` with every stub port (an int, or ``host:port``) read as
        the stub's name."""
        ports = {s.port: n for n, s in self.by.items()}
        if isinstance(obj, dict):
            return {k: self.named(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.named(v) for v in obj)
        if isinstance(obj, int) and not isinstance(obj, bool):
            return ports.get(obj, obj)
        if isinstance(obj, str) and obj.startswith("127.0.0.1:"):
            port = int(obj.rsplit(":", 1)[1])
            return ports.get(port, obj)
        return obj

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for s in self.by.values():
            s.close()


def reply(resp, stubs=None) -> dict:
    """A ``GatewayResponse`` in comparable form (a stream is drained)."""
    if resp.stream is not None:
        body = b"".join(resp.stream).decode()
    else:
        body = (resp.body or b"").decode()
        try:
            body = json.loads(body)
        except ValueError:
            pass
    out = {"status": resp.status, "body": body, "endpoint": resp.endpoint,
           "attempts": resp.attempts, "hedged": resp.hedged,
           "stream": resp.stream is not None}
    return stubs.named(out) if stubs is not None else out


def shed(fn, *args, **kwargs):
    """The typed refusal a call raises: class, status and code."""
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return (type(e).__name__, getattr(e, "http_status", None),
                getattr(e, "code", None))
    raise AssertionError(f"{fn.__name__} did not raise")


def _unclocked_view(view):
    return [{k: v for k, v in ep.items() if k != "ewmaMs"} for ep in view]


def books(gw, stubs=None) -> dict:
    """What a gateway holds: its status view without its identity and
    clocks, and the kinds of its events."""
    sv = gw.status_view()
    sv.pop("instanceId")
    sv.pop("advertise")
    sv["services"] = {svc: _unclocked_view(eps)
                      for svc, eps in sv["services"].items()}
    sv["events"] = [e["event"] for e in gw.events_view(1000)]
    return stubs.named(sv) if stubs is not None else sv


# -- the routing table ---------------------------------------------------------


class TestRoutingTable:
    def test_running_replica_is_routable(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "web.r0", 40001)
            return {"eps": [ep.view() for ep in gw.table.endpoints("web")],
                    "books": books(gw)}

        got = tc.both(case)
        [ep] = got["eps"]
        assert ep["routable"] and ep["address"] == "127.0.0.1:40001"

    def test_draining_marker_and_preempted_phase_unroutable(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "web.r0", 40001, draining=True)
            feed(pkg, gw, "web.r1", 40002, phase="preempted")
            feed(pkg, gw, "web.r2", 40003)
            return {"routable": [ep.family for ep in gw.table.endpoints("web")
                                 if ep.routable],
                    "draining": gw.table.draining_families(),
                    "owed": gw.table.ack_pending_families(),
                    "books": books(gw)}

        got = tc.both(case)
        assert got["routable"] == ["web.r2"]
        assert got["draining"] == ["web.r0", "web.r1"]

    def test_latest_pointer_wins_over_max_version(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "web.r0", 40001, version=1)
            feed(pkg, gw, "web.r0", 40002, version=2, phase="queued")
            gw.table._observe_job(SimpleNamespace(
                op="put", key=f"{pkg.keys.PREFIX}/jobs/web.r0/latest",
                value="1"))
            return gw.table.endpoint("web.r0").view()

        ep = tc.both(case)
        assert ep["version"] == 1 and ep["routable"]
        assert ep["address"] == "127.0.0.1:40001"

    def test_plain_gang_never_enters_table(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "train", 40001, env=[])
            return {"web": gw.table.endpoints("web"),
                    "train": gw.table.endpoint("train"),
                    "services": gw.table.services()}

        assert tc.both(case) == {"web": [], "train": None, "services": []}

    def test_delete_drops_endpoint(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "web.r0", 40001)
            before = gw.table.view()
            for tail in ("v/0000000001", "latest"):
                gw.table._observe_job(SimpleNamespace(
                    op="delete",
                    key=f"{pkg.keys.PREFIX}/jobs/web.r0/{tail}", value=None))
            return {"before": before, "after": gw.table.view(),
                    "gone": gw.table.endpoint("web.r0") is None}

        got = tc.both(case)
        assert got["gone"] and got["after"] == {}

    def test_new_version_resets_breaker_state(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "web.r0", 40001)
            ep = gw.table.endpoint("web.r0")
            ep.consecutive_failures = 5
            ep.breaker_open_since = 1.0
            feed(pkg, gw, "web.r0", 40002, version=2)
            return gw.table.endpoint("web.r0").view()

        ep = tc.both(case)
        assert ep["consecutiveFailures"] == 0 and ep["breaker"] == "closed"
        assert ep["generation"] == 1 and ep["lameInFlight"] == 0


# -- rendezvous hashing --------------------------------------------------------


class TestRendezvousStability:
    def test_drain_moves_only_the_drained_keys(self):
        fams = [f"web.r{i}" for i in range(4)]
        keys_ = [f"prefix-{i}" for i in range(200)]

        def case(pkg):
            order = pkg.gateway.rendezvous_order
            return {"full": {k: order(fams, k) for k in keys_},
                    "drained": {k: order([f for f in fams if f != "web.r2"],
                                         k) for k in keys_}}

        got = tc.both(case)
        before = {k: o[0] for k, o in got["full"].items()}
        after = {k: o[0] for k, o in got["drained"].items()}
        moved = [k for k in keys_ if before[k] != after[k]]
        assert set(moved) == {k for k in keys_ if before[k] == "web.r2"}
        for k in moved:
            assert after[k] == got["full"][k][1]

    def test_prefix_key_is_affine_and_falls_through_on_drain(self):
        key = "prompt-prefix-7"

        def case(pkg):
            with Stubs(a={}, b={}) as st:
                gw = mk_gw(pkg)
                feed(pkg, gw, "web.r0", st["a"].port)
                feed(pkg, gw, "web.r1", st["b"].port)
                first = pkg.gateway.rendezvous_order(
                    ["web.r0", "web.r1"], key)[0]
                replies = [reply(gw.request("web", "GET", "/metrics", {},
                                            b"", prefix_key=key), st)
                           for _ in range(3)]
                hits = st.hits()
                feed(pkg, gw, first,
                     st["a" if first == "web.r0" else "b"].port,
                     draining=True)
                replies.append(reply(gw.request(
                    "web", "GET", "/metrics", {}, b"", prefix_key=key), st))
                return {"first": first, "replies": replies,
                        "hits_before_drain": hits, "hits": st.hits(),
                        "books": books(gw, st)}

        got = tc.both(case)
        first = got["first"]
        assert [r["endpoint"] for r in got["replies"][:3]] == [first] * 3
        target = "a" if first == "web.r0" else "b"
        assert got["hits_before_drain"][target] == 3
        assert got["replies"][3]["endpoint"] != first
        assert sum(got["hits"].values()) == 4


# -- retries -------------------------------------------------------------------


class TestRetryBudget:
    def test_exhaustion_returns_last_upstream_error_verbatim(self):
        def case(pkg):
            with Stubs(s={"mode": "error", "status": 503}) as st:
                gw = mk_gw(pkg, retry_limit=2)
                feed(pkg, gw, "web.r0", st["s"].port)
                r = reply(gw.request("web", "GET", "/healthz", {}, b""), st)
                return {"reply": r, "hits": st.hits(), "books": books(gw, st)}

        got = tc.both(case)
        assert got["hits"] == {"s": 3}
        assert got["reply"]["status"] == 503
        assert got["reply"]["body"] == {"boom": 3}
        assert got["reply"]["attempts"] == 3

    def test_non_idempotent_never_retried(self):
        def case(pkg):
            with Stubs(s={"mode": "error", "status": 500}) as st:
                gw = mk_gw(pkg, retry_limit=2)
                feed(pkg, gw, "web.r0", st["s"].port)
                r = reply(gw.request("web", "POST", "/generate", {}, b"{}"),
                          st)
                return {"reply": r, "hits": st.hits(), "books": books(gw, st)}

        got = tc.both(case)
        assert got["hits"] == {"s": 1} and got["reply"]["status"] == 500

    def test_idempotency_key_opts_posts_in(self):
        def case(pkg):
            with Stubs(s={"mode": "error", "status": 500}) as st:
                gw = mk_gw(pkg, retry_limit=2)
                feed(pkg, gw, "web.r0", st["s"].port)
                r = reply(gw.request("web", "POST", "/generate",
                                     {"Idempotency-Key": "abc"}, b"{}"), st)
                return {"reply": r, "hits": st.hits(), "books": books(gw, st)}

        got = tc.both(case)
        assert got["hits"] == {"s": 3} and got["reply"]["status"] == 500

    def test_token_budget_bounds_retry_amplification(self):
        def case(pkg):
            with Stubs(s={"mode": "error", "status": 503}) as st:
                gw = mk_gw(pkg, retry_limit=2, retry_budget_ratio=0.0,
                           breaker_threshold=0)
                feed(pkg, gw, "web.r0", st["s"].port)
                out = {"a": reply(gw.request("web", "GET", "/a", {}, b""),
                                  st),
                       "hits_a": st.hits()}
                out["b"] = reply(gw.request("web", "GET", "/b", {}, b""), st)
                out["hits_b"] = st.hits()
                out["exhausted"] = gw.registry.counter_sum(
                    "gateway_retry_budget_exhausted_total")
                out["books"] = books(gw, st)
                return out

        got = tc.both(case)
        assert got["hits_a"] == {"s": 3} and got["hits_b"] == {"s": 4}
        assert got["exhausted"] >= 1

    def test_connect_error_fails_over_to_peer(self):
        def case(pkg):
            with Stubs(s={}) as st:
                gw = mk_gw(pkg, retry_limit=2, connect_timeout_s=0.3)
                feed(pkg, gw, "web.r0", 1)  # nothing listens on port 1
                feed(pkg, gw, "web.r1", st["s"].port)
                r = reply(gw.request("web", "GET", "/healthz", {}, b""), st)
                return {"reply": r, "hits": st.hits(), "books": books(gw, st)}

        got = tc.both(case)
        assert got["reply"]["status"] == 200
        assert got["reply"]["endpoint"] == "web.r1"
        assert got["reply"]["attempts"] == 2


# -- the breaker ---------------------------------------------------------------


class TestBreaker:
    def test_consecutive_failures_open_then_typed_503(self):
        def case(pkg):
            with Stubs(s={"mode": "error", "status": 500}) as st:
                gw = mk_gw(pkg, retry_limit=0, breaker_threshold=2,
                           breaker_cooldown_s=60)
                feed(pkg, gw, "web.r0", st["s"].port)
                replies = [reply(gw.request("web", "GET", "/a", {}, b""), st)
                           for _ in range(2)]
                opened = gw.table.endpoint("web.r0").breaker_open_since \
                    is not None
                refused = shed(gw.request, "web", "GET", "/a", {}, b"")
                return {"replies": replies, "opened": opened,
                        "refused": refused, "hits": st.hits(),
                        "books": books(gw, st)}

        got = tc.both(case)
        assert got["opened"]
        assert got["refused"][0] == "GatewayNoEndpoints"
        assert got["hits"] == {"s": 2}
        assert got["books"]["counters"]["breakerOpens"] == 1

    def test_half_open_probe_is_single_flight_under_streaming(self):
        def case(pkg):
            with Stubs(s={"mode": "fail_then_held_stream", "status": 500,
                          "fail_times": 1}) as st:
                stub = st["s"]
                gw = mk_gw(pkg, retry_limit=0, breaker_threshold=1,
                           breaker_cooldown_s=0.03)
                feed(pkg, gw, "web.r0", stub.port)
                first = reply(gw.request("web", "GET", "/a", {}, b""), st)
                time.sleep(0.05)                          # past cooldown
                results = []

                def probe():
                    r = gw.request("web", "GET", "/stream", {}, b"")
                    results.append(b"".join(r.stream))

                t = threading.Thread(target=probe, daemon=True)
                t.start()
                wait_for(lambda: stub.hits == 2, what="probe to reach stub")
                refused = [shed(gw.request, "web", "GET", "/a", {}, b"")
                           for _ in range(4)]
                held_hits = stub.hits
                stub.release.set()
                t.join(timeout=WAIT_S)
                after = reply(gw.request("web", "GET", "/a", {}, b""), st)
                return {"first": first, "refused": refused,
                        "held_hits": held_hits, "probe": results,
                        "after": after, "hits": st.hits(),
                        "books": books(gw, st)}

        got = tc.both(case)
        assert [r[0] for r in got["refused"]] == ["GatewayNoEndpoints"] * 4
        assert got["held_hits"] == 2
        assert got["probe"] and b'{"t": 0}' in got["probe"][0]
        assert got["after"]["status"] == 200 and got["hits"] == {"s": 3}


# -- hedging -------------------------------------------------------------------


class TestHedging:
    def test_hedge_cancels_loser_on_first_byte_win(self):
        def case(pkg):
            with Stubs(slow={"mode": "json", "delay_s": 0.5},
                       fast={"mode": "json"}) as st:
                gw = mk_gw(pkg, retry_limit=0, hedge_ms=40)
                feed(pkg, gw, "web.r0", st["slow"].port)
                feed(pkg, gw, "web.r1", st["fast"].port)
                r = reply(gw.request("web", "GET", "/gen", {}, b""), st)
                wait_for(lambda: gw.registry.counter_sum(
                    "gateway_hedge_cancelled_total") == 1,
                    what="hedge loser cancellation")
                # the winner is a race in either package: its reply is
                # held to JAX's assertions below, not across packages
                out = {"status": r["status"], "hedged": r["hedged"],
                       "hits": st.hits(), "books": books(gw, st)}
                return out, r

        got = [case(pkg) for pkg in tc.PKGS]
        assert got[1][0] == got[0][0]
        r = got[1][1]
        assert r["status"] == 200 and r["hedged"]
        assert r["endpoint"] == "web.r1" and r["body"]["server"] == "fast"
        assert got[1][0]["hits"] == {"fast": 1, "slow": 1}

    def test_no_hedge_for_non_idempotent(self):
        def case(pkg):
            with Stubs(slow={"mode": "json", "delay_s": 0.2},
                       fast={"mode": "json"}) as st:
                gw = mk_gw(pkg, retry_limit=0, hedge_ms=20)
                feed(pkg, gw, "web.r0", st["slow"].port)
                feed(pkg, gw, "web.r1", st["fast"].port)
                r = reply(gw.request("web", "POST", "/gen", {}, b"{}"), st)
                return {"reply": r, "hits": st.hits(), "books": books(gw, st)}

        got = tc.both(case)
        assert got["reply"]["status"] == 200 and not got["reply"]["hedged"]
        assert got["hits"]["fast"] == 0


# -- load shedding -------------------------------------------------------------


class TestLoadShedding:
    def test_global_cap_sheds_typed_429(self):
        def case(pkg):
            with Stubs(s={"mode": "hang"}) as st:
                stub = st["s"]
                gw = mk_gw(pkg, max_inflight=1, retry_limit=0)
                feed(pkg, gw, "web.r0", stub.port)
                done = []
                t = threading.Thread(target=lambda: done.append(
                    gw.request("web", "GET", "/a", {}, b"")), daemon=True)
                t.start()
                wait_for(lambda: stub.hits == 1, what="first request upstream")
                refused = shed(gw.request, "web", "GET", "/a", {}, b"")
                stub.release.set()
                t.join(timeout=WAIT_S)
                again = reply(gw.request("web", "GET", "/a", {}, b""), st)
                return {"refused": refused,
                        "held": [reply(r, st) for r in done],
                        "again": again, "books": books(gw, st)}

        got = tc.both(case)
        assert got["refused"][:2] == ("GatewayShed", 429)
        assert got["held"][0]["status"] == 200
        assert got["again"]["status"] == 200

    def test_no_routable_endpoint_is_typed_503(self):
        def case(pkg):
            gw = mk_gw(pkg)
            feed(pkg, gw, "web.r0", 40001, draining=True)
            return {"refused": shed(gw.request, "web", "GET", "/a", {}, b""),
                    "books": books(gw)}

        got = tc.both(case)
        assert got["refused"][:2] == ("GatewayNoEndpoints", 503)
        assert got["books"]["counters"]["shed"] == 1

    def test_saturated_endpoint_skipped_even_for_affine_key(self):
        def case(pkg):
            with Stubs(hang={"mode": "hang"}, ok={}) as st:
                gw = mk_gw(pkg, max_inflight_per_endpoint=1, retry_limit=0)
                feed(pkg, gw, "web.r0", st["hang"].port)
                feed(pkg, gw, "web.r1", st["ok"].port)
                key = next(k for k in (f"k{i}" for i in range(64))
                           if pkg.gateway.rendezvous_order(
                               ["web.r0", "web.r1"], k)[0] == "web.r0")
                t = threading.Thread(
                    target=lambda: gw.request("web", "GET", "/a", {}, b""),
                    daemon=True)
                t.start()
                wait_for(lambda: st["hang"].hits == 1, what="r0 saturated")
                r = reply(gw.request("web", "GET", "/a", {}, b"",
                                     prefix_key=key), st)
                st["hang"].release.set()
                t.join(timeout=WAIT_S)
                return {"key": key, "reply": r, "hits": st.hits(),
                        "books": books(gw, st)}

        got = tc.both(case)
        assert got["reply"]["endpoint"] == "web.r1"


# -- streaming -----------------------------------------------------------------


class TestStreaming:
    def test_chunked_passthrough(self):
        def case(pkg):
            with Stubs(s={"mode": "stream"}) as st:
                gw = mk_gw(pkg)
                feed(pkg, gw, "web.r0", st["s"].port)
                r = reply(gw.request("web", "POST", "/generate", {}, b"{}"),
                          st)
                return {"reply": r, "books": books(gw, st)}

        got = tc.both(case)
        assert got["reply"]["stream"]
        assert got["reply"]["body"] == '{"t": 0}\n{"t": 1}\n{"t": 2}\n'
        assert got["books"]["inFlight"] == 0

    def test_mid_stream_death_yields_typed_truncation(self):
        def case(pkg):
            with Stubs(s={"mode": "die_mid_stream"}) as st:
                gw = mk_gw(pkg)
                feed(pkg, gw, "web.r0", st["s"].port)
                r = gw.request("web", "POST", "/generate", {}, b"{}")
                lines = b"".join(r.stream).splitlines()
                final = json.loads(lines[-1])
                return {"first": lines[0], "final": sorted(final),
                        "truncated": final["gatewayTruncated"],
                        "endpoint": final["endpoint"],
                        "reason": bool(final["reason"]),
                        "books": books(gw, st)}

        got = tc.both(case)
        assert got["first"] == b'{"t": 0}'
        assert got["truncated"] is True and got["endpoint"] == "web.r0"
        assert got["reason"]
        assert got["books"]["counters"]["truncatedStreams"] == 1
        assert "gateway-stream-truncated" in got["books"]["events"]
        [ep] = got["books"]["services"]["web"]
        assert ep["pool"]["idle"] == 0 and got["books"]["inFlight"] == 0


# -- the drain handshake -------------------------------------------------------


def _acks(coord, base, version=None):
    """How many instances acked: the ids are random in both packages."""
    return len(coord.acks(base, version))


class TestDrainHandshake:
    def test_vacuous_with_zero_live_gateways(self):
        def case(pkg):
            coord = pkg.gateway.DrainCoordinator(pkg.kv.MemoryKV(),
                                                 heartbeat_s=0.05)
            return coord.wait_drained("web.r0", 0.2)

        assert tc.both(case) is True

    def test_stale_heartbeat_not_waited_on(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            kv.put(pkg.keys.gateway_instance_key("gw-dead"),
                   json.dumps({"id": "gw-dead", "ts": time.time() - 3600}))
            coord = pkg.gateway.DrainCoordinator(kv, heartbeat_s=0.05)
            return {"live": coord.live_instances(),
                    "drained": coord.wait_drained("web.r0", 0.2)}

        assert tc.both(case) == {"live": [], "drained": True}

    def test_idle_gateway_acks_promptly(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            gw = mk_gw(pkg, kv=kv)
            gw.start()
            try:
                feed(pkg, gw, "web.r0", 40001)
                coord = pkg.gateway.DrainCoordinator(
                    kv, heartbeat_s=gw.heartbeat_s)
                wait_for(lambda: coord.live_instances(), what="heartbeat")
                feed(pkg, gw, "web.r0", 40001, draining=True)
                return {"drained": coord.wait_drained("web.r0", WAIT_S),
                        "left": _acks(coord, "web.r0"),
                        "acks": gw.status_view()["counters"]["drainAcks"]}
            finally:
                gw.close()

        assert tc.both(case) == {"drained": True, "left": 0, "acks": 1}

    def test_ack_waits_for_inflight_stream_then_lands(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            with Stubs(s={"mode": "hang"}) as st:
                stub = st["s"]
                gw = mk_gw(pkg, kv=kv, retry_limit=0)
                gw.start()
                try:
                    feed(pkg, gw, "web.r0", stub.port)
                    coord = pkg.gateway.DrainCoordinator(
                        kv, heartbeat_s=gw.heartbeat_s)
                    wait_for(lambda: coord.live_instances(), what="heartbeat")
                    done = []
                    t = threading.Thread(target=lambda: done.append(
                        gw.request("web", "GET", "/a", {}, b"")), daemon=True)
                    t.start()
                    wait_for(lambda: stub.hits == 1, what="in-flight request")
                    feed(pkg, gw, "web.r0", stub.port, draining=True)
                    early = coord.wait_drained("web.r0", 0.3)
                    stub.release.set()
                    t.join(timeout=WAIT_S)
                    late = coord.wait_drained("web.r0", WAIT_S)
                    return {"early": early, "late": late,
                            "reply": [reply(r, st) for r in done],
                            "acks": gw.registry.counter_sum(
                                "gateway_drain_acks_total")}
                finally:
                    gw.close()

        got = tc.both(case)
        assert got["early"] is False and got["late"] is True
        assert got["reply"][0]["status"] == 200 and got["acks"] >= 1

    def test_roll_acks_promptly_without_visible_marker(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            gw = mk_gw(pkg, kv=kv)
            gw.start()
            try:
                feed(pkg, gw, "web.r0", 40001, version=1)
                coord = pkg.gateway.DrainCoordinator(
                    kv, heartbeat_s=gw.heartbeat_s)
                wait_for(lambda: coord.live_instances(), what="heartbeat")
                feed(pkg, gw, "web.r0", 40002, version=2)
                t0 = time.monotonic()
                drained = coord.wait_drained("web.r0", WAIT_S, version=1)
                return {"drained": drained,
                        "prompt": time.monotonic() - t0 < 2.0,
                        "rollAcks": gw.status_view()["counters"]["rollAcks"]
                        >= 1}
            finally:
                gw.close()

        assert tc.both(case) == {"drained": True, "prompt": True,
                              "rollAcks": True}

    def test_roll_ack_waits_for_lame_inflight(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            with Stubs(s={"mode": "hang"}) as st:
                stub = st["s"]
                gw = mk_gw(pkg, kv=kv, retry_limit=0)
                gw.start()
                try:
                    feed(pkg, gw, "web.r0", stub.port, version=1)
                    coord = pkg.gateway.DrainCoordinator(
                        kv, heartbeat_s=gw.heartbeat_s)
                    wait_for(lambda: coord.live_instances(), what="heartbeat")
                    t = threading.Thread(
                        target=lambda: gw.request("web", "GET", "/a", {}, b""),
                        daemon=True)
                    t.start()
                    wait_for(lambda: stub.hits == 1, what="in-flight request")
                    feed(pkg, gw, "web.r0", stub.port, version=2)
                    lame = gw.table.endpoint("web.r0").lame_inflight()
                    early = coord.wait_drained("web.r0", 0.3, version=1)
                    stub.release.set()
                    t.join(timeout=WAIT_S)
                    late = coord.wait_drained("web.r0", WAIT_S, version=1)
                    return {"lame": lame, "early": early, "late": late}
                finally:
                    gw.close()

        assert tc.both(case) == {"lame": 1, "early": False, "late": True}

    def test_stale_roll_ack_cannot_satisfy_newer_drain(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            kv.put(pkg.keys.gateway_instance_key("gw-1"),
                   json.dumps({"id": "gw-1", "ts": time.time()}))
            kv.put(pkg.keys.gateway_ack_key("web.r0", "gw-1"),
                   json.dumps({"id": "gw-1", "ts": time.time(),
                               "rolledTo": 1}))
            coord = pkg.gateway.DrainCoordinator(kv, heartbeat_s=10.0)
            return {"any": coord.acks("web.r0"),
                    "v1": coord.acks("web.r0", version=1),
                    "v0": coord.acks("web.r0", version=0),
                    "drained": coord.wait_drained("web.r0", 0.2, version=1),
                    "left": kv.range_prefix(
                        pkg.keys.gateway_acks_prefix("web.r0"))}

        assert tc.both(case) == {"any": {"gw-1"}, "v1": set(), "v0": {"gw-1"},
                              "drained": False, "left": {}}

    def test_dead_gateway_stops_blocking_drains(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            gw = mk_gw(pkg, kv=kv)
            gw.start()
            coord = pkg.gateway.DrainCoordinator(kv, heartbeat_s=gw.heartbeat_s)
            wait_for(lambda: coord.live_instances(), what="heartbeat")
            live = len(coord.live_instances())
            gw.close()
            return {"live": live, "after": coord.live_instances(),
                    "drained": coord.wait_drained("web.r0", 0.2)}

        assert tc.both(case) == {"live": 1, "after": [], "drained": True}


# -- the listener --------------------------------------------------------------


def _call(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    c.request(method, path, body=body, headers=headers or {})
    resp = c.getresponse()
    data = resp.read()
    c.close()
    return resp, data


class TestGatewayAppHTTP:
    def test_proxy_affinity_shed_and_trace(self):
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"

        def case(pkg):
            with Stubs(s={}) as st:
                gw = mk_gw(pkg)
                feed(pkg, gw, "web.r0", st["s"].port)
                srv = pkg.gwapp.GatewayServer(gw, port=0)
                srv.start()
                try:
                    out = {}
                    resp, body = _call(srv.port, "GET", "/v1/web/healthz",
                                       headers={"traceparent": tp,
                                                "X-Prefix-Key": "p1"})
                    up_tp = st["s"].headers_seen[0].get("traceparent", "")
                    out["proxied"] = (resp.status, st.named(json.loads(body)),
                                      resp.getheader("X-Gateway-Endpoint"),
                                      resp.getheader("X-Gateway-Attempts"),
                                      up_tp.split("-")[1], up_tp != tp)
                    resp, body = _call(srv.port, "GET", "/v1/nosuch/healthz")
                    shed_body = json.loads(body)
                    out["shed"] = (resp.status,
                                   resp.getheader("Retry-After"),
                                   shed_body["code"], shed_body["msg"])
                    resp, body = _call(srv.port, "GET", "/wrong")
                    out["wrong"] = (resp.status, json.loads(body))
                    resp, body = _call(srv.port, "GET", "/healthz")
                    health = json.loads(body)
                    out["health_is_own"] = (
                        health["gateway"]["instanceId"] == gw.instance_id)
                    out["health"] = sorted(health), sorted(health["gateway"])
                    resp, body = _call(srv.port, "GET", "/metrics")
                    text = body.decode()
                    out["metrics"] = [name for name in (
                        "gateway_requests_total", "gateway_request_ms",
                        "gateway_upstream_ttfb_ms", "gateway_shed_total",
                        "gateway_inflight") if name in text]
                    out["books"] = books(gw, st)
                    return out
                finally:
                    srv.close()

        got = tc.both(case)
        assert got["proxied"] == (200, {"server": "s", "hit": 1}, "web.r0",
                                  "1", "ab" * 16, True)
        assert got["shed"][0] == 503 and got["shed"][1]
        assert got["shed"][2] == tc.PORT.errors.GatewayNoEndpoints.code
        assert got["wrong"][0] == 404
        assert got["health_is_own"]
        assert {"gateway_requests_total",
                "gateway_request_ms"} <= set(got["metrics"])

    def test_streaming_relay_over_the_wire(self):
        def case(pkg):
            with Stubs(s={"mode": "stream"}) as st:
                gw = mk_gw(pkg)
                feed(pkg, gw, "web.r0", st["s"].port)
                srv = pkg.gwapp.GatewayServer(gw, port=0)
                srv.start()
                try:
                    resp, body = _call(srv.port, "POST", "/v1/web/generate",
                                       body=b"{}")
                    return (resp.status, resp.getheader("Transfer-Encoding"),
                            body)
                finally:
                    srv.close()

        assert tc.both(case) == (200, "chunked",
                              b'{"t": 0}\n{"t": 1}\n{"t": 2}\n')


# -- the quiesce paths over a Program ------------------------------------------


def boot(pkg, kv=None, rt=None):
    """test_gateway.py's boot: the market on, both loops off."""
    return tc.pod_program(
        pkg, 1, kv=kv, rts={"h0": rt} if rt is not None else None,
        admission_enabled=True, admission_interval_s=0,
        autoscale_interval_s=0, autoscale_up_cooldown_s=0,
        autoscale_down_cooldown_s=0)


def create(pkg, prg, name="web", chips=2, replicas=1, max_replicas=3):
    return prg.serving.create_service(pkg.ss.ServiceCreate(
        service_name=name, image_name="serve", chips_per_replica=chips,
        replicas=replicas, max_replicas=max_replicas))


def stop_spy(pkg):
    """test_gateway.py's ``_StopSpyRuntime`` over either package's fake:
    what the store says of a family at each of its member stops."""

    class StopSpy(pkg.fake.FakeRuntime):
        def __init__(self):
            super().__init__()
            self.prg = None
            self.observed = []

        def container_stop(self, name, timeout_s=10):
            if self.prg is not None:
                for fam, latest in self.prg.job_versions.snapshot().items():
                    if name.startswith(fam):
                        st = self.prg.store.get_job(f"{fam}-{latest}")
                        self.observed.append(
                            (name, fam, st.draining, st.phase))
                        break
            super().container_stop(name, timeout_s)

    return StopSpy()


def _settle(prg):
    for _ in range(3):
        if not prg.reconciler.reconcile()["actions"]:
            break
    for _ in range(4):
        if not prg.admission.admit_once():
            break


class TestMarkBeforeStop:
    def test_service_replica_stop_marks_before_first_stop(self):
        def case(pkg):
            rt = stop_spy(pkg)
            prg = boot(pkg, rt=rt)
            create(pkg, prg)
            rt.prg = prg
            prg.job_svc.stop_job("web.r0")
            st = prg.store.get_job(
                f"web.r0-{prg.job_versions.get('web.r0')}")
            return {"observed": rt.observed, "final": (st.phase, st.draining),
                    "books": tc.market_books(pkg, prg)}

        got = tc.both(case)
        assert got["observed"]
        assert all(d is True for _, _, d, _ in got["observed"])
        assert got["final"] == ("stopped", False)

    def test_plain_gang_stop_never_marked(self):
        def case(pkg):
            rt = stop_spy(pkg)
            prg = boot(pkg, rt=rt)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=2))
            rt.prg = prg
            prg.job_svc.stop_job("train")
            return {"observed": rt.observed,
                    "books": tc.market_books(pkg, prg)}

        got = tc.both(case)
        assert got["observed"]
        assert all(d is False for _, _, d, _ in got["observed"])

    def test_quiesce_waits_on_coordinator_before_stopping(self):
        def case(pkg):
            seq = []

            class Coord:
                def wait_drained(self, base, deadline_s, version=None):
                    seq.append(("wait", base, deadline_s, version))
                    return True

            class SeqRuntime(pkg.fake.FakeRuntime):
                def container_stop(self, name, timeout_s=10):
                    seq.append(("stop", name))
                    super().container_stop(name, timeout_s)

            prg = boot(pkg, rt=SeqRuntime())
            create(pkg, prg)
            prg.job_svc.drain_coordinator = Coord()
            prg.job_svc.drain_deadline_s = 7.5
            prg.job_svc.stop_job("web.r0")
            return {"seq": seq, "books": tc.market_books(pkg, prg)}

        seq = tc.both(case)["seq"]
        assert seq[0][:3] == ("wait", "web.r0", 7.5)
        assert all(step[0] == "stop" for step in seq[1:]) and len(seq) > 1


class TestReconcileAdoption:
    def test_draining_at_rest_is_invariant_violation_and_adopted(self):
        def case(pkg):
            kv, rt = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
            prg = boot(pkg, kv, rt)
            create(pkg, prg)
            with pkg.crash.armed("gateway.drain.after_mark"):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.stop_job("web.r0")
            prg2 = boot(pkg, kv, rt)
            at_rest = tc.market_oracle(pkg, prg2)
            _settle(prg2)
            return {"at_rest": at_rest, "books": tc.market_books(pkg, prg2),
                    "again": prg2.reconciler.reconcile()["actions"]}

        got = tc.both(case)
        assert any("draining marker at rest" in p for p in got["at_rest"])
        assert got["books"]["oracle"] == [] and got["again"] == []


class TestGatewayChaos:
    def test_port_knows_jax_gateway_crash_points(self):
        assert tc.PORT.crash.GATEWAY_CRASH_POINTS \
            == tc.JAX.crash.GATEWAY_CRASH_POINTS
        assert tc.PORT.crash.KNOWN_CRASH_POINTS \
            == tc.JAX.crash.KNOWN_CRASH_POINTS

    @pytest.mark.parametrize("point", tc.PORT.crash.GATEWAY_CRASH_POINTS)
    def test_crash_converges(self, point):
        def case(pkg):
            kv, rt = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
            prg = boot(pkg, kv, rt)
            create(pkg, prg)
            with pkg.crash.armed(point):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.stop_job("web.r0")
            prg2 = boot(pkg, kv, rt)
            _settle(prg2)
            half = [fam for fam, latest in prg2.job_versions.snapshot().items()
                    for st in [prg2.store.get_job(f"{fam}-{latest}")]
                    if st.draining and st.phase == "running"]
            return {"books": tc.market_books(pkg, prg2), "half": half,
                    "again": prg2.reconciler.reconcile()["actions"]}

        got = tc.both(case)
        assert got["books"]["oracle"] == [], point
        assert got["half"] == [] and got["again"] == [], point


class TestDrainEndToEnd:
    """A daemon with ``gateway_enabled``: its own listener, informer-fed
    table and drain coordinator, a Service whose replica's coordinator
    port is a held stub stream. The service's DELETE waits for the stream
    in flight through the gateway: the replica's member keeps running
    until the stream ends, the drain is acked (never the deadline), the
    stream arrives whole, and the next request is the typed 503."""

    def test_service_delete_finishes_the_stream_in_flight(self):
        def case(pkg):
            with Stubs(s={"mode": "held_stream"}) as st:
                stub = st["s"]
                # the replica's coordinator port is its second booked port
                conf = pkg.config.Config(
                    store_backend="memory", runtime_backend="fake",
                    accelerator_type="h100-8", health_watch_interval=0,
                    port=0, start_port=stub.port - 1,
                    end_port=stub.port + 14, admission_enabled=True,
                    admission_interval_s=0, autoscale_interval_s=0,
                    gateway_enabled=True, gateway_port=0,
                    gateway_heartbeat_s=0.05, gateway_drain_deadline_s=WAIT_S)
                rt = pkg.fake.FakeRuntime()
                prg = pkg.daemon.Program(conf, host="127.0.0.1",
                                         kv=pkg.kv.MemoryKV(), runtime=rt)
                prg._discover_topology = lambda: tc.topology(pkg)
                prg.init()
                prg.start()
                try:
                    create(pkg, prg)
                    job = prg.store.get_job(
                        f"web.r0-{prg.job_versions.get('web.r0')}")
                    assert job.coordinator_port == stub.port
                    gw = prg.gateway
                    wait_for(lambda: [ep.routable for ep in
                                      gw.table.endpoints("web")] == [True],
                             what="replica routable")
                    streamed = []
                    reader = threading.Thread(target=lambda: streamed.append(
                        _call(prg.gateway_server.port, "POST",
                              "/v1/web/generate", body=b"{}")), daemon=True)
                    reader.start()
                    wait_for(lambda: stub.hits == 1, what="stream upstream")
                    deleted = []
                    deleter = threading.Thread(target=lambda: deleted.append(
                        prg.serving.delete_service("web")), daemon=True)
                    deleter.start()
                    wait_for(lambda: gw.table.draining_families()
                             == ["web.r0"], what="draining marker folded")
                    time.sleep(0.3)
                    held = {"deleting": deleter.is_alive(),
                            "members": sorted(
                                n for n in rt.container_list()
                                if rt.container_inspect(n).running)}
                    stub.release.set()
                    reader.join(timeout=WAIT_S)
                    deleter.join(timeout=WAIT_S)
                    resp, body = streamed[0]
                    after = _call(prg.gateway_server.port, "POST",
                                  "/v1/web/generate", body=b"{}")
                    drains = [e["event"] for e in
                              prg.job_supervisor.events_view(1000)
                              if "drain" in e["event"]]
                    return {
                        "held": held, "deleted": deleted,
                        "stream": (resp.status, body),
                        "after": (after[0].status,
                                  json.loads(after[1])["code"]),
                        "drains": drains,
                        "services": prg.service_versions.snapshot(),
                        "books": books(gw, st)}
                finally:
                    stub.release.set()
                    prg.stop()

        got = tc.both(case)
        assert got["held"]["deleting"] and got["held"]["members"]
        assert got["deleted"] == [None]
        assert got["stream"] == (200, b'{"t": 0}\n')
        assert got["drains"] == ["job-draining", "job-drain-acked"]
        assert got["after"] == (503, tc.PORT.errors.GatewayNoEndpoints.code)
        assert got["services"] == {} and got["books"]["services"] == {}
        counters = got["books"]["counters"]
        assert counters["drainAcks"] == 1 and counters["truncatedStreams"] == 0

    def test_preemption_of_a_replica_waits_for_the_drain(self):
        """The admission path's drain-aware preemption: the victim
        replica's phase flips to ``preempted`` (the routing table's drain
        signal), then the market waits on the coordinator, version-scoped,
        before the first member stop, and records the verdict."""
        def case(pkg):
            seq = []

            class Coord:
                def wait_drained(self, base, deadline_s, version=None):
                    seq.append(("wait", base, deadline_s, version))
                    return True

            class SeqRuntime(pkg.fake.FakeRuntime):
                def container_stop(self, name, timeout_s=10):
                    seq.append(("stop", name))
                    super().container_stop(name, timeout_s)

            prg = boot(pkg, rt=SeqRuntime())
            prg.serving.create_service(pkg.ss.ServiceCreate(
                service_name="web", image_name="serve", chips_per_replica=8,
                replicas=1, max_replicas=1, priority_class="batch"))
            prg.job_svc.drain_coordinator = Coord()
            prg.job_svc.drain_deadline_s = 7.5
            prg.job_svc.run_job(pkg.js.JobRun(
                image_name="jax", job_name="urgent", chip_count=8,
                priority_class="system"))
            placed = prg.admission.admit_once()
            return {"seq": seq, "placed": tc.unclocked(placed),
                    "books": tc.market_books(pkg, prg)}

        got = tc.both(case)
        assert got["seq"][0] == ("wait", "web.r0", 7.5, 0)
        assert [s[0] for s in got["seq"][1:]] == ["stop"] * (
            len(got["seq"]) - 1) and len(got["seq"]) > 1
        events = [e["event"] for e in got["books"]["admission_events"]]
        assert "job-drain-acked" in events and "job-preempted" in events
        assert got["books"]["oracle"] == []
