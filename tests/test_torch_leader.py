"""The port's leader election (``service/leader.py``), its role-split daemon
and the standby HTTP contract against the JAX package's on the CPU: every
case of ``tests/test_leader.py`` runs one script through each package. The
elector cases drive ``LeaderElector.step`` with an injected clock (never a
TTL sleep) and compare the lease records, epochs, role views and callback
traces each package left; the daemon cases boot two real ``Program``s of
each package over one shared store and compare what the HTTP surface
answered. JAX's own assertions then hold on the port's side."""

import json
import time
import urllib.error
import urllib.request

import pytest

import torch_control as tc


def lease(pkg, kv) -> dict | None:
    raw = kv.get_or(pkg.keys.LEADER_LEASE_KEY)
    return None if raw is None else json.loads(raw)


def pair(pkg, kv=None, ttl=10.0, **kwargs):
    kv = kv or pkg.kv.MemoryKV()
    clock = {"now": 1000.0}
    mk = lambda name: pkg.leader.LeaderElector(
        kv, name, ttl_s=ttl, clock=lambda: clock["now"], **kwargs)
    return kv, clock, mk("a"), mk("b")


def state(pkg, kv, *electors) -> dict:
    """The lease record, the epoch key and each elector's role view."""
    return {"lease": lease(pkg, kv),
            "epoch": kv.get_or(pkg.keys.LEADER_EPOCH_KEY),
            "views": [e.status_view() for e in electors]}


class TestLeaderElector:
    def test_acquire_on_empty_store_epoch_one(self):
        def case(pkg):
            kv, clock, a, _ = pair(pkg)
            a.step()
            assert a.is_leader and a.epoch == 1
            return state(pkg, kv, a)

        out = tc.both(case)
        rec = out["lease"]
        assert rec["holderId"] == "a" and rec["epoch"] == 1
        assert rec["deadline"] == pytest.approx(1000.0 + 10.0)
        assert out["epoch"] == "1"
        assert out["views"][0]["role"] == "leader"
        assert out["views"][0]["fencingEpoch"] == 1

    def test_standby_defers_to_live_lease_then_steals_expired(self):
        def case(pkg):
            kv, clock, a, b = pair(pkg)
            a.step()
            b.step()
            seen = [b.is_leader, b.status_view()]
            clock["now"] += 10.001  # a went silent past its TTL
            b.step()
            return {"standby": seen, "after": (b.is_leader, b.epoch),
                    **state(pkg, kv, a, b)}

        out = tc.both(case)
        assert out["standby"][0] is False  # live lease: no steal
        assert out["standby"][1]["role"] == "standby"
        assert out["standby"][1]["holderId"] == "a"
        assert out["after"] == (True, 2)
        assert out["lease"]["holderId"] == "b"

    def test_renew_extends_deadline_within_ttl(self):
        def case(pkg):
            kv, clock, a, b = pair(pkg)
            a.step()
            clock["now"] += 6.0
            a.step()  # renew at t+6: deadline pushed to t+16
            deadline = lease(pkg, kv)["deadline"]
            clock["now"] += 6.0  # t+12: original deadline passed
            b.step()
            return {"deadline": deadline, "roles": (a.is_leader,
                                                     b.is_leader)}

        out = tc.both(case)
        assert out["deadline"] == pytest.approx(1006.0 + 10.0)
        assert out["roles"] == (True, False)

    def test_deposed_leader_demotes_on_renew_and_fires_on_loss(self):
        def case(pkg):
            losses = []
            kv = pkg.kv.MemoryKV()
            clock = {"now": 0.0}
            a = pkg.leader.LeaderElector(
                kv, "a", ttl_s=5.0, clock=lambda: clock["now"],
                on_loss=lambda reason: losses.append(reason))
            b = pkg.leader.LeaderElector(kv, "b", ttl_s=5.0,
                                         clock=lambda: clock["now"])
            a.step()
            clock["now"] += 6.0
            b.step()  # steals the expired lease
            a.step()  # a's renew CAS loses against b's record
            return {"roles": (a.is_leader, b.is_leader), "losses": losses,
                    "epoch": a.epoch, "guards": a.fence_guards()}

        out = tc.both(case)
        assert out["roles"] == (False, True)
        assert len(out["losses"]) == 1 and "stolen" in out["losses"][0]
        # the fencing epoch survives demotion: in-flight writes keep failing
        assert out["epoch"] == 1
        assert out["guards"] == [("value", tc.PORT.keys.LEADER_EPOCH_KEY,
                                  "1")]

    def test_on_acquire_fires_with_epoch(self):
        def case(pkg):
            acquired = []
            a = pkg.leader.LeaderElector(
                pkg.kv.MemoryKV(), "a", ttl_s=5.0, clock=lambda: 0.0,
                on_acquire=lambda epoch: acquired.append(epoch))
            a.step()
            a.step()  # renewals must NOT re-fire the callback
            return acquired

        assert tc.both(case) == [1]

    def test_losing_contender_stays_standby_without_callbacks(self):
        def case(pkg):
            kv, clock, a, b = pair(pkg)
            a.step()
            clock["now"] += 10.001
            a.step()  # a renews late but first
            b.step()  # b read the OLD record... a's renew already landed
            return {"roles": (a.is_leader, b.is_leader),
                    "epochs": (a.epoch, b.epoch),
                    "lease": lease(pkg, kv)["epoch"]}

        out = tc.both(case)
        assert out["roles"] != (True, True)  # exactly one leader
        assert out["lease"] == max(out["epochs"])

    def test_fence_guards_empty_before_first_acquire(self):
        def case(pkg):
            kv, _, a, _ = pair(pkg)
            guards = a.fence_guards()
            fenced = pkg.leader.FencedKV(kv, a.fence_guards)
            fenced.put("/boot", "ok")  # pre-acquire writes pass unfenced
            return guards, kv.get("/boot")

        assert tc.both(case) == ([], "ok")

    def test_unreadable_lease_record_is_treated_as_expired(self):
        def case(pkg):
            kv, clock, a, _ = pair(pkg)
            kv.put(pkg.keys.LEADER_LEASE_KEY, "not json {")
            a.step()
            return a.is_leader, a.epoch

        assert tc.both(case) == (True, 1)

    def test_epoch_outgrows_tampered_epoch_key(self):
        """The epoch key may outrun the lease record (a release keeps it);
        acquisition takes the max of both before bumping."""
        def case(pkg):
            kv, clock, a, _ = pair(pkg)
            kv.put(pkg.keys.LEADER_EPOCH_KEY, "41")
            a.step()
            return a.epoch

        assert tc.both(case) == 42

    def test_hard_close_keeps_lease_for_ttl(self):
        def case(pkg):
            kv, clock, a, b = pair(pkg)
            a.step()
            a.close(release=False)  # the hard-kill model
            b.step()
            before = b.is_leader  # lease still held until expiry
            clock["now"] += 10.001
            b.step()
            return before, b.is_leader

        assert tc.both(case) == (False, True)

    def test_mutation_gate_closed_until_on_acquire_completes(self):
        """accepts_mutations opens only AFTER on_acquire returns, and
        closes before on_loss fires."""
        def case(pkg):
            seen = {}
            kv = pkg.kv.MemoryKV()
            clock = {"now": 1000.0}
            a = pkg.leader.LeaderElector(
                kv, "a", ttl_s=10.0, clock=lambda: clock["now"],
                on_acquire=lambda e: seen.update(
                    during_acquire=a.accepts_mutations),
                on_loss=lambda r: seen.update(
                    during_loss=a.accepts_mutations))
            seen["before"] = a.accepts_mutations
            a.step()
            seen["after_acquire"] = a.accepts_mutations
            b = pkg.leader.LeaderElector(kv, "b", ttl_s=10.0,
                                         clock=lambda: clock["now"])
            clock["now"] += 10.001
            b.step()
            a.step()  # renew loses its CAS → demote
            seen["end"] = (a.accepts_mutations, a.is_leader)
            return seen

        assert tc.both(case) == {
            "before": False, "during_acquire": False, "after_acquire": True,
            "during_loss": False, "end": (False, False)}

    def test_leader_hint_served_without_store_reads(self):
        """The 503 path answers from memory: zero store reads per hint."""
        def case(pkg):
            reads = {"n": 0}

            class _CountingReads(pkg.kv.MemoryKV):
                def get(self, key):
                    reads["n"] += 1
                    return super().get(key)

            kv = _CountingReads()
            clock = {"now": 1000.0}
            mk = lambda n: pkg.leader.LeaderElector(
                kv, n, ttl_s=10.0, clock=lambda: clock["now"])
            a, b = mk("a"), mk("b")
            a.step()
            b.step()  # standby heartbeat: observes a's lease
            before = reads["n"]
            hints = [(b.standby_message(), b.leader_hint()["holderId"])
                     for _ in range(50)]
            standby_reads = reads["n"] - before
            before = reads["n"]
            own = a.leader_hint()["holderId"]
            leader_reads = reads["n"] - before
            clock["now"] += 10.001
            b.step()
            return {"hints": hints[-1], "reads": (standby_reads,
                                                  leader_reads),
                    "own": own, "after": (b.is_leader,
                                          b.leader_hint()["holderId"])}

        out = tc.both(case)
        assert "a" in out["hints"][0] and out["hints"][1] == "a"
        assert out["reads"] == (0, 0)
        assert out["own"] == "a" and out["after"] == (True, "b")


def ha_config(pkg, **over):
    base = dict(
        port=0, store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8",
        start_port=41000, end_port=41099, health_watch_interval=0,
        host_probe_interval_s=0, job_supervise_interval=0,
        reconcile_interval=0, workflow_interval_s=0,
        leader_election=True, leader_ttl_s=5.0,
        leader_renew_interval_s=0.05,
    )
    base.update(over)
    return pkg.config.Config(**base)


def call(port, method, path, body=None):
    """(http_status, envelope): a 503 is the standby's answer, not an
    error, so both arms funnel to one return shape."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_until(fn, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out waiting for {what}")


def program(pkg, cfg, **kw):
    prg = pkg.daemon.Program(cfg, host="127.0.0.1", **kw)
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    return prg


def fleet(pkg, script):
    """Two daemons of one package over one shared store and engine, a
    frozen lease clock (the heartbeat threads are real; the clock pins who
    may steal): alpha leads, beta stands by. ``script(alpha, beta)``'s
    result is returned."""
    kv, runtime = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
    clock = {"now": 0.0}
    progs = [program(pkg, ha_config(pkg, leader_id=name), kv=kv,
                     runtime=runtime, leader_clock=lambda: clock["now"])
             for name in ("alpha", "beta")]
    try:
        progs[0].start()
        wait_until(lambda: progs[0].leader_elector.accepts_mutations,
                   what="alpha lease")
        progs[1].start()
        return script(*progs)
    finally:
        for prg in progs:
            try:
                prg.stop()
            except Exception:  # noqa: BLE001 — a stopped daemon
                pass


def envelope(reply):
    """A reply without its request id."""
    status, out = reply
    return status, {k: v for k, v in out.items() if k != "requestId"}


class TestDaemonRoleSplit:
    def test_standby_serves_reads_and_503s_mutations_with_hint(self):
        def script(alpha, beta):
            a, b = alpha.api_server.port, beta.api_server.port
            out = {"beta_leads": beta.leader_elector.is_leader}
            out["create"] = envelope(call(a, "POST", "/api/v1/containers", {
                "imageName": "jax", "containerName": "web",
                "chipCount": 0}))
            wait_until(lambda: call(b, "GET", "/api/v1/containers/web-0")[1][
                "code"] == 200, what="standby observing web-0")
            out["read"] = call(b, "GET", "/api/v1/containers/web-0")[0]
            health = call(b, "GET", "/healthz")[1]["data"]
            out["health"] = (health["role"], health["informer"]["synced"],
                             health["informer"]["cacheHits"] >= 1)
            out["refused"] = [
                envelope(call(b, "POST", "/api/v1/containers", {
                    "imageName": "jax", "containerName": "nope",
                    "chipCount": 0})),
                envelope(call(b, "DELETE", "/api/v1/containers/web"))]
            out["nope"] = beta.container_versions.get("nope")
            views = [call(p, "GET", "/api/v1/leader")[1]["data"]
                     for p in (a, b)]
            out["leader"] = [(v["role"], v["holderId"], v["epoch"])
                             for v in views]
            out["alpha_role"] = call(a, "GET", "/healthz")[1]["data"]["role"]
            out["writers"] = (alpha.wq.closed, beta.wq._thread is None)
            return out

        with tc.jax_knows_h100():
            out = tc.both(lambda pkg: fleet(pkg, script))
        assert out["beta_leads"] is False
        assert out["create"][0] == 200 and out["create"][1]["code"] == 200
        assert out["read"] == 200
        assert out["health"] == ("standby", True, True)
        (s1, r1), (s2, r2) = out["refused"]
        assert (s1, r1["code"]) == (503, tc.PORT.errors.NotLeader.code)
        assert "alpha" in r1["msg"]
        assert (s2, r2["code"]) == (503, tc.PORT.errors.NotLeader.code)
        assert out["nope"] is None
        assert out["leader"] == [("leader", "alpha", 1),
                                 ("standby", "alpha", 1)]
        assert out["alpha_role"] == "leader"
        assert out["writers"] == (False, True)

    def test_standby_reads_track_leader_rolls_and_deletes(self):
        """A standby's staleness is bounded by watch lag: the leader's
        rolls and deletes after the standby booted become visible."""
        def script(alpha, beta):
            a, b = alpha.api_server.port, beta.api_server.port
            out = [envelope(call(a, "POST", "/api/v1/containers", {
                "imageName": "jax", "containerName": "web",
                "chipCount": 2}))[0]]
            wait_until(lambda: beta.container_versions.get("web") == 0,
                       what="standby observing web-0")
            # JAX's path; the port's own is /gpu, with /tpu its alias
            out.append(envelope(call(a, "PATCH",
                                     "/api/v1/containers/web-0/tpu",
                                     {"chipCount": 4}))[1]["code"])
            wait_until(lambda: beta.container_versions.get("web") == 1,
                       what="standby observing the roll")
            out.append(call(b, "GET", "/api/v1/containers/web-1")[1]["code"])
            out.append(envelope(call(a, "DELETE", "/api/v1/containers/web", {
                "force": True, "delEtcdInfoAndVersionRecord": True}))[1][
                "code"])
            wait_until(lambda: beta.container_versions.get("web") is None,
                       what="standby observing the delete")
            out.append("web" in beta.container_versions.snapshot())
            return out

        with tc.jax_knows_h100():
            assert tc.both(lambda pkg: fleet(pkg, script)) == [
                200, 200, 200, 200, False]

    def test_graceful_stop_hands_over_without_ttl_wait(self):
        def script(alpha, beta):
            b = beta.api_server.port
            alpha.stop()  # releases the lease (clock frozen: no expiry)
            wait_until(lambda: beta.leader_elector.accepts_mutations,
                       what="beta lease")
            create = envelope(call(b, "POST", "/api/v1/containers", {
                "imageName": "jax", "containerName": "after",
                "chipCount": 0}))
            view = call(b, "GET", "/api/v1/leader")[1]["data"]
            return create[0], create[1]["code"], view["role"], view["epoch"]

        with tc.jax_knows_h100():
            # epochs only ever go up
            assert tc.both(lambda pkg: fleet(pkg, script)) == (
                200, 200, "leader", 2)

    def test_election_disabled_default_single_process_behavior(self):
        def case(pkg):
            cfg = pkg.config.Config(
                port=0, store_backend="memory", runtime_backend="fake",
                accelerator_type="h100-8",
                start_port=41100, end_port=41199, health_watch_interval=0)
            assert cfg.leader_election is False
            prg = program(pkg, cfg, kv=pkg.kv.MemoryKV(),
                          runtime=pkg.fake.FakeRuntime())
            out = {"elector": prg.leader_elector,
                   "unfenced": prg.kv is prg._raw_kv}
            prg.start()
            try:
                port = prg.api_server.port
                out["writers"] = prg.wq._thread is not None
                out["create"] = envelope(call(
                    port, "POST", "/api/v1/containers", {
                        "imageName": "jax", "containerName": "solo",
                        "chipCount": 0}))[1]["code"]
                out["role"] = call(port, "GET", "/healthz")[1]["data"]["role"]
                view = call(port, "GET", "/api/v1/leader")[1]["data"]
                out["store_mode"] = view.pop("storeHealth")["mode"]
                out["view"] = view
            finally:
                prg.stop()
            return out

        with tc.jax_knows_h100():
            out = tc.both(case)
        assert out["elector"] is None and out["unfenced"] is True
        assert out["writers"] is True and out["create"] == 200
        assert out["role"] == "single" and out["store_mode"] == "healthy"
        assert out["view"] == {
            "election": False, "role": "single", "accepting": True,
            "selfId": None, "holderId": None, "epoch": None,
            "deadline": None, "advertise": "", "ttlS": None,
            "fencingEpoch": 0}


class TestProgramStopPartialInit:
    """stop() tolerates a partially-completed init, so a failed boot
    surfaces its root cause instead of an AttributeError from cleanup."""

    def test_stop_before_init_is_safe(self):
        for pkg in tc.PKGS:
            pkg.daemon.Program(pkg.config.Config(
                store_backend="memory", runtime_backend="fake")).stop()

    def test_stop_after_failed_store_open_is_safe(self):
        def case(pkg):
            cfg = pkg.config.Config(store_backend="etcd",
                                    etcd_addr="http://127.0.0.1:9",
                                    runtime_backend="fake",
                                    store_retry_attempts=1)
            prg = pkg.daemon.Program(cfg)
            out = tc.outcome(prg.init)
            prg.stop()  # kv/wq/pod never materialized
            return out

        assert tc.both(case) == ("raise", "StoreUnavailable")

    def test_stop_after_mid_init_failure_closes_what_exists(self):
        """Die between the work queue and the pod (the detect sidecar is
        unreachable): stop() closes the live subsystems and skips the
        missing ones. JAX's probe needs ``requests``; the port's is the
        standard library's."""
        cfg = tc.PORT.config.Config(
            store_backend="memory", runtime_backend="fake",
            detect_tpu_addr="http://127.0.0.1:9")
        prg = tc.PORT.daemon.Program(cfg, kv=tc.PORT.kv.MemoryKV(),
                                     runtime=tc.PORT.fake.FakeRuntime())
        with pytest.raises(OSError):
            prg.init()
        assert hasattr(prg, "wq") and not hasattr(prg, "pod")
        prg.stop()
        assert prg.wq.closed
