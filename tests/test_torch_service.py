"""The port's Service resource (``service/serving.py``,
``schemas/service.py``, ``check_service_invariants``) against the JAX
package's on the CPU: every case of ``tests/test_service.py`` runs one
script through each package's ``Program`` (the capacity market on, the
admission and autoscale loops off so passes and ticks run inline), and
what each left behind must be JAX's: the service and job records, the
admission journal, the pod (containers, GPU and port owners, slices), the
serving and market event rings, the replies and the oracles. The HTTP
scrape answers from a stub endpoint on the replica's coordinator port;
``TestServiceChaos`` kills each package at every ``service.*`` crash point
and boots a fresh ``Program`` over the wreck; the HTTP surface is driven
through each package's own server. JAX's own assertions then hold on the
port's side."""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import torch_control as tc


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def boot(pkg, n_hosts=1, kv=None, rts=None, **scale):
    """test_service.py's boot: the market on, both loops off, zero
    cooldowns unless given."""
    return tc.pod_program(
        pkg, n_hosts, kv=kv, rts=rts, admission_enabled=True,
        admission_interval_s=0, autoscale_interval_s=0,
        autoscale_up_cooldown_s=scale.pop("up_cooldown", 0),
        autoscale_down_cooldown_s=scale.pop("down_cooldown", 0),
        autoscale_down_watermark=scale.pop("watermark", 0.5), **scale)


def create(pkg, prg, name="web", chips=2, replicas=1, max_replicas=3, **kw):
    return prg.serving.create_service(pkg.ss.ServiceCreate(
        service_name=name, image_name="serve", chips_per_replica=chips,
        replicas=replicas, max_replicas=max_replicas, **kw))


def patch(pkg, prg, name="web", **kw):
    return prg.serving.patch_service(name, pkg.ss.ServicePatch(**kw))


def job_phase(prg, base):
    return prg.store.get_job(f"{base}-{prg.job_versions.get(base)}").phase


def run(pkg, prg, name, chips, klass="batch"):
    return prg.job_svc.run_job(pkg.js.JobRun(
        image_name="jax", job_name=name, chip_count=chips,
        priority_class=klass))


def refusal(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return type(e).__name__
    raise AssertionError(f"{fn.__name__} did not raise")


def books(pkg, prg, **extra) -> dict:
    return {**tc.market_books(pkg, prg), **tc.unclocked(extra)}


def info(prg, name="web"):
    return prg.serving.service_info(name)


class TestNaming:
    def test_replica_base_round_trips(self):
        for pkg in tc.PKGS:
            s = pkg.serving
            assert s.replica_base("web", 2) == "web.r2"
            assert s.split_replica_base("web.r2") == ("web", 2)
            assert s.split_replica_base("a.b.r10") == ("a.b", 10)
            for bad in ("web", "web.rx", ".r1"):
                assert s.split_replica_base(bad) is None

    def test_schema_and_marker_are_jax_s(self):
        """The stored keys, the DTOs' JSON keys and the owner env marker
        are JAX's: the oracles of both packages count replicas by them."""
        j, t = tc.JAX.ss, tc.PORT.ss
        assert (t.SERVICE_PHASES, t.SERVICE_OWNER_ENV) == (
            j.SERVICE_PHASES, j.SERVICE_OWNER_ENV)
        assert t.owner_from_env(["A=1", "TPU_DOCKER_API_SERVICE=web"]) == \
            j.owner_from_env(["A=1", "TPU_DOCKER_API_SERVICE=web"]) == "web"
        body = {"serviceName": "s", "imageName": "i", "chipsPerReplica": 2,
                "acceleratorType": "h100-8", "replicas": 2, "minReplicas": 0,
                "maxReplicas": 5, "priorityClass": "batch", "binds": ["/a"],
                "env": ["X=1"], "cmd": ["serve"], "ttftP95TargetMs": 150.0,
                "queueDepthTarget": 3, "replicaCapacityRps": 80.0,
                "metricsPath": "/slo"}
        assert vars(t.ServiceCreate.from_dict(body)) == vars(
            j.ServiceCreate.from_dict(body))
        patch_body = {"replicas": 3, "imageName": "v2",
                      "ttftP95TargetMs": 90.0}
        assert vars(t.ServicePatch.from_dict(patch_body)) == vars(
            j.ServicePatch.from_dict(patch_body))
        st = j.ServiceState(service_name="s-1", version=1, image="i", cmd=[],
                            env=[], binds=[], chips_per_replica=8,
                            last_scale={"to": 2}, auto_scales=3)
        assert t.ServiceState.from_dict(st.to_dict()).to_dict() == \
            st.to_dict()


class TestServiceLifecycle:
    def test_create_owns_exactly_n_replica_gangs(self):
        def case(pkg):
            prg = boot(pkg)
            return books(pkg, prg, out=create(pkg, prg, replicas=2))

        got = tc.both(case)
        out = got["out"]
        assert out["phase"] == "active" and out["readyReplicas"] == 2
        assert [r["family"] for r in out["replicaStatus"]] == [
            "web.r0", "web.r1"]
        st = got["jobs"]["web.r0"]
        assert st["priority_class"] == "production"
        assert "TPU_DOCKER_API_SERVICE=web" in st["env"]
        assert got["oracle"] == []

    def test_duplicate_and_bad_requests_reject(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg)
            return books(pkg, prg, refusals=[
                refusal(create, pkg, prg),
                refusal(create, pkg, prg, name="bad", replicas=9),
                refusal(prg.serving.create_service, pkg.ss.ServiceCreate(
                    service_name="x", image_name="serve")),
                refusal(info, prg, "ghost")])

        assert tc.both(case)["refusals"] == [
            "ServiceExisted", "BadRequest", "BadRequest", "ServiceNotExist"]

    def test_delete_tears_down_all_replicas(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=3, max_replicas=3)
            n = len(prg.job_versions.snapshot())
            prg.serving.delete_service("web")
            return books(pkg, prg, n=n,
                         slices=prg.pod_scheduler.status()["slices"])

        got = tc.both(case)
        assert got["n"] == 3 and got["services"] == {} and got["jobs"] == {}
        assert got["slices"] == {} and got["oracle"] == []
        kinds = [e["event"] for e in got["service_events"]]
        assert "service-created" in kinds and "service-deleted" in kinds

    def test_manual_scale_is_counted_and_audited(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=1)
            out = patch(pkg, prg, replicas=3)
            return books(pkg, prg, out=out,
                         bad=refusal(patch, pkg, prg, replicas=9))

        got = tc.both(case)
        out = got["out"]
        assert out["replicas"] == 3 and out["readyReplicas"] == 3
        assert out["manualScaleTotal"] == 1
        assert out["lastScale"]["trigger"] == "manual"
        assert (out["lastScale"]["from"], out["lastScale"]["to"]) == (1, 3)
        assert got["bad"] == "BadRequest" and got["oracle"] == []

    def test_rolling_spec_update_rolls_every_replica(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=2)
            return books(pkg, prg, out=patch(pkg, prg, image_name="serve:v2"))

        got = tc.both(case)
        assert (got["out"]["version"], got["out"]["image"]) == (1, "serve:v2")
        for rb in ("web.r0", "web.r1"):
            assert got["jobs"][rb]["image"] == "serve:v2"
            assert got["jobs"][rb]["phase"] == "running"
        assert got["oracle"] == []

    def test_orphan_replica_gangs_gc_marker_verified(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=2)
            prg.job_svc.run_job(pkg.js.JobRun(
                image_name="jax", job_name="user.r1", chip_count=2))
            prg.store.delete_family(pkg.keys.Resource.SERVICES, "web")
            prg.service_versions.remove("web")
            report = prg.reconciler.reconcile()
            return books(pkg, prg, acts=[(a["action"], a["target"])
                                         for a in report["actions"]])

        got = tc.both(case)
        gcd = {t for a, t in got["acts"] if a == "gc-orphan-replica"}
        assert gcd == {"web.r0", "web.r1"}
        assert "web.r0" not in got["jobs"]
        assert got["jobs"]["user.r1"]["phase"] == "running"
        assert got["oracle"] == []


class TestAutoscalePolicy:
    def test_scale_up_admits_at_service_class_and_preempts(self):
        def case(pkg):
            prg = boot(pkg)
            run(pkg, prg, "train", 4, "batch")
            create(pkg, prg, replicas=1, max_replicas=3)
            prg.serving.set_offered_load("web", 280)
            prg.serving.tick()
            up = info(prg)
            r2 = job_phase(prg, "web.r2")
            first = prg.admission.admit_once()
            mid = books(pkg, prg)
            prg.serving.set_offered_load("web", 10)
            prg.serving.tick()
            down = info(prg)["replicas"]
            second = prg.admission.admit_once()
            return books(pkg, prg, up=up, r2=r2, passes=[first, second],
                         mid=mid, down=down)

        got = tc.both(case)
        assert got["up"]["replicas"] == 3
        assert got["up"]["lastScale"]["trigger"] == "autoscale"
        assert got["r2"] == "queued" and got["passes"][0]
        mid = got["mid"]
        assert mid["jobs"]["web.r2"]["phase"] == "running"
        assert mid["jobs"]["train"]["phase"] == "preempted"
        assert mid["jobs"]["web.r2"]["priority_class"] == "production"
        assert mid["oracle"] == []
        assert got["down"] == 1 and got["passes"][1]
        assert got["jobs"]["train"]["phase"] == "running"
        assert got["oracle"] == []

    def test_scale_up_never_preempts_equal_or_higher(self):
        def case(pkg):
            prg = boot(pkg)
            run(pkg, prg, "prod", 6, "production")
            create(pkg, prg, replicas=1, max_replicas=2)
            prg.serving.set_offered_load("web", 150)
            prg.serving.tick()
            replicas = info(prg)["replicas"]
            prg.admission.admit_once()
            return books(pkg, prg, replicas=replicas)

        got = tc.both(case)
        assert got["replicas"] == 2
        assert got["jobs"]["web.r1"]["phase"] == "queued"
        assert got["jobs"]["prod"]["phase"] == "running"

    def test_scale_down_quiesces_workers_first(self):
        def case(pkg):
            prg = boot(pkg, n_hosts=2)
            create(pkg, prg, chips=16, replicas=1, max_replicas=1,
                   min_replicas=0)
            stops: list[str] = []
            for host in prg.pod.hosts.values():
                orig = host.runtime.container_stop

                def spy(name, *a, _orig=orig, **kw):
                    stops.append(name)
                    return _orig(name, *a, **kw)

                host.runtime.container_stop = spy
            patch(pkg, prg, replicas=0)
            return books(pkg, prg, stops=stops,
                         slices=prg.pod_scheduler.status()["slices"])

        got = tc.both(case)
        assert got["stops"] == ["web.r0-0-p1", "web.r0-0-p0"]
        assert got["jobs"] == {} and got["slices"] == {}
        assert got["oracle"] == []

    def test_oscillating_signal_never_flaps(self):
        def case(pkg):
            prg = boot(pkg, up_cooldown=5.0, down_cooldown=10.0,
                       watermark=0.5)
            now = [0.0]
            prg.serving._clock = lambda: now[0]
            create(pkg, prg, replicas=1, max_replicas=3)
            prg.serving.set_offered_load("web", 150)
            prg.serving.tick()
            trail = [info(prg)["replicas"]]
            for t in range(1, 10):
                now[0] = float(t)
                prg.serving.set_offered_load("web", 150 if t % 2 else 90)
                prg.serving.tick()
                trail.append(info(prg)["replicas"])
            mid_total = info(prg)["autoscaleTotal"]
            now[0] = 20.0
            prg.serving.set_offered_load("web", 40)
            prg.serving.tick()
            end = info(prg)
            return books(pkg, prg, trail=trail, mid_total=mid_total,
                         end=(end["replicas"], end["autoscaleTotal"]))

        got = tc.both(case)
        assert got["trail"] == [2] * 10 and got["mid_total"] == 1
        assert got["end"] == (1, 2) and got["oracle"] == []

    def test_scale_from_zero_recovers(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=1, min_replicas=0, max_replicas=2)
            prg.serving.set_offered_load("web", 0)
            prg.serving.tick()
            zero = (info(prg)["replicas"], dict(prg.job_versions.snapshot()))
            prg.serving.set_offered_load("web", 150)
            prg.serving.tick()
            return books(pkg, prg, zero=zero, out=info(prg))

        got = tc.both(case)
        assert got["zero"] == (0, {})
        assert got["out"]["replicas"] >= 1
        assert got["out"]["readyReplicas"] >= 1 and got["oracle"] == []

    def test_patch_rejects_nonpositive_targets_and_nan_load(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg)
            load = prg.serving.set_offered_load
            dto = pkg.ss.ServiceCreate.from_dict
            return books(pkg, prg, refusals=[
                refusal(patch, pkg, prg, queue_depth_target=0),
                refusal(patch, pkg, prg, ttft_p95_target_ms=-1.0),
                refusal(load, "web", float("nan")),
                refusal(load, "web", float("inf")),
                refusal(dto, {"serviceName": "x", "imageName": "i",
                              "ttftP95TargetMs": "200ms"}),
                refusal(dto, {"serviceName": "x", "imageName": "i",
                              "replicaCapacityRps": float("nan")})])

        assert tc.both(case)["refusals"] == ["BadRequest"] * 6

    def test_min_max_retune_clamp_is_audited_as_manual(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=3, max_replicas=3)
            return books(pkg, prg, out=patch(pkg, prg, max_replicas=1))

        got = tc.both(case)
        out = got["out"]
        assert out["replicas"] == 1 and out["manualScaleTotal"] == 1
        assert out["lastScale"]["trigger"] == "manual"
        assert sorted(got["jobs"]) == ["web.r0"] and got["oracle"] == []

    def test_no_signal_means_no_action(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=2)
            prg.serving.tick()
            return books(pkg, prg, out=info(prg))

        got = tc.both(case)
        assert got["out"]["replicas"] == 2
        assert got["out"]["lastScale"] is None

    def test_http_scrape_drives_scale_up(self):
        seen = []

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                seen.append(self.path)
                body = json.dumps({"ttftP95Ms": 900.0, "itlP95Ms": 42.0,
                                   "queueDepth": 1}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=1, max_replicas=2, metrics_path="/slo")
            jst = prg.store.get_job("web.r0-0")
            httpd = HTTPServer(("127.0.0.1", jst.coordinator_port), Handler)
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                prg.serving.tick()
            finally:
                httpd.shutdown()
                httpd.server_close()
                t.join(timeout=10)
            return books(pkg, prg, out=info(prg),
                         signal=prg.serving.replica_signal("web.r0"))

        got = tc.both(case)
        out = got["out"]
        assert out["replicas"] == 2
        assert out["slo"]["lastObserved"]["ttftP95Ms"] == 900.0
        assert "slo breach" in out["lastScale"]["reason"]
        assert got["signal"] == {"ttftP95Ms": 900.0, "itlP95Ms": 42.0,
                                 "queueDepth": 1.0}
        assert seen == ["/slo", "/slo"]

    def test_unreachable_scrape_is_no_signal(self):
        """The scrape is best-effort: an endpoint that does not answer is
        no signal (never a synthesized one), so nothing scales."""
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=1, max_replicas=2, metrics_path="/slo")
            prg.serving._scrape_timeout = 0.2
            prg.serving.set_offered_load("web", 1000)
            prg.serving.tick()
            return books(pkg, prg, out=info(prg))

        got = tc.both(case)
        assert got["out"]["replicas"] == 1
        assert got["out"]["slo"]["lastObserved"] is None


class TestFailedReplicaHealing:
    def test_failed_replica_is_replaced(self):
        def case(pkg):
            prg = boot(pkg)
            create(pkg, prg, replicas=2)
            prg.job_svc.fail_job("web.r1", "crash loop (test)")
            mid = job_phase(prg, "web.r1")
            prg.serving.tick()
            return books(pkg, prg, mid=mid)

        got = tc.both(case)
        assert got["mid"] == "failed"
        assert got["jobs"]["web.r1"]["phase"] == "running"
        assert got["oracle"] == []


#: JAX's SERVICE_CRASH_POINTS, each with the flow that traverses it
def _drive(pkg, prg, point):
    if point == "service.create.after_record":
        create(pkg, prg, replicas=2)
    elif point == "service.scale_up.after_mark":
        create(pkg, prg, replicas=1)
        prg.serving.set_offered_load("web", 250)
        prg.serving.tick()
    elif point in ("service.scale_down.after_mark",
                   "service.scale_down.after_quiesce"):
        create(pkg, prg, replicas=2)
        patch(pkg, prg, replicas=1)
    elif point == "service.roll.after_version":
        create(pkg, prg, replicas=2)
        patch(pkg, prg, image_name="serve:v2")
    elif point == "service.delete.after_mark":
        create(pkg, prg, replicas=2)
        prg.serving.delete_service("web")
    else:  # pragma: no cover — keep the matrix exhaustive
        raise AssertionError(f"unmapped crash point {point}")


def _drain(prg) -> int:
    for n in range(4):
        if not prg.admission.admit_once():
            return n
    return 4


@pytest.mark.chaos
class TestServiceChaos:
    """A kill at every service.* crash point: a fresh Program over the
    same store and engines reconciles to exactly one fully-owned replica
    set, zero leaks, a fixpoint second sweep, in each package alike."""

    def test_matrix_covers_every_service_label(self):
        assert tc.PORT.crash.SERVICE_CRASH_POINTS == \
            tc.JAX.crash.SERVICE_CRASH_POINTS

    @pytest.mark.parametrize("point", tc.PORT.crash.SERVICE_CRASH_POINTS)
    def test_crash_converges_to_one_owned_replica_set(self, point):
        def case(pkg):
            kv, rts = pkg.kv.MemoryKV(), {"h0": pkg.fake.FakeRuntime()}
            prg = boot(pkg, kv=kv, rts=rts)
            with pkg.crash.armed(point):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    _drive(pkg, prg, point)
            prg2 = boot(pkg, kv=kv, rts=rts)
            report = prg2.reconciler.reconcile()
            drained = _drain(prg2)
            out = books(pkg, prg2, drained=drained, acts=[
                (a["action"], a["target"]) for a in report["actions"]])
            out["info"] = (tc.unclocked(info(prg2))
                           if prg2.service_versions.snapshot() else None)
            out["fixpoint"] = prg2.reconciler.reconcile()["actions"]
            return out

        got = tc.both(case)
        assert got["oracle"] == [], f"{point}: {got['oracle']}"
        if point == "service.delete.after_mark":
            assert got["services"] == {} and got["jobs"] == {}
            assert got["world"]["slices"] == {}
        else:
            want = got["info"]["replicas"]
            assert sorted(got["jobs"]) == [f"web.r{i}" for i in range(want)]
            assert got["info"]["readyReplicas"] == want
            if point == "service.roll.after_version":
                assert {st["image"] for st in got["jobs"].values()} == {
                    "serve:v2"}
        assert got["fixpoint"] == [], point

    def test_scale_up_crash_with_full_pool_queues_through_market(self):
        def case(pkg):
            kv, rts = pkg.kv.MemoryKV(), {"h0": pkg.fake.FakeRuntime()}
            prg = boot(pkg, kv=kv, rts=rts)
            run(pkg, prg, "train", 4, "batch")
            create(pkg, prg, replicas=1, max_replicas=3)
            prg.serving.set_offered_load("web", 280)
            with pkg.crash.armed("service.scale_up.after_mark"):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.serving.tick()
            prg2 = boot(pkg, kv=kv, rts=rts)
            prg2.reconciler.reconcile()
            _drain(prg2)
            return books(pkg, prg2, ready=info(prg2)["readyReplicas"],
                         fixpoint=prg2.reconciler.reconcile()["actions"])

        got = tc.both(case)
        assert got["ready"] == 3
        assert got["jobs"]["train"]["phase"] == "preempted"
        assert got["oracle"] == [] and got["fixpoint"] == []


class TestConfigValidation:
    def test_load_validates_service_keys(self, tmp_path):
        def case(pkg):
            good = tmp_path / f"good-{pkg.name}.toml"
            good.write_text('service_default_class = "system"\n'
                            "autoscale_down_watermark = 0.8\n")
            out = [pkg.config.load(str(good)).service_default_class]
            for bad in ('service_default_class = "gold"\n',
                        "autoscale_down_watermark = 1.5\n",
                        "autoscale_down_watermark = 0.0\n",
                        "autoscale_interval_s = -1\n",
                        "autoscale_up_cooldown_s = -1\n"):
                p = tmp_path / f"bad-{pkg.name}.toml"
                p.write_text(bad)
                out.append(refusal(pkg.config.load, str(p)))
            return out

        assert tc.both(case) == ["system"] + ["ValueError"] * 5


class TestHttpSurface:
    def test_service_routes_and_events(self):
        def case(pkg):
            prg = boot(pkg, port=0)
            prg.start()
            port = prg.api_server.port

            def call(method, path, body=None):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}", method=method,
                    data=(json.dumps(body).encode() if body is not None
                          else None),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as resp:
                    return json.loads(resp.read())

            try:
                replies = [
                    call("POST", "/api/v1/services", {
                        "serviceName": "llm", "imageName": "serve",
                        "chipsPerReplica": 2, "replicas": 1,
                        "maxReplicas": 2}),
                    call("GET", "/api/v1/services"),
                    call("GET", "/api/v1/services?limit=1"),
                    call("POST", "/api/v1/services/llm/load", {"rps": 50}),
                    call("POST", "/api/v1/services/llm/load", {}),
                    call("PATCH", "/api/v1/services/llm", {"replicas": 2}),
                    call("GET", "/api/v1/services/llm"),
                    call("GET", "/api/v1/admission"),
                ]
                kinds = [sorted({e.get("event") for e in call(
                    "GET", "/api/v1/events?limit=100")["data"]})]
                replies.append(call("DELETE", "/api/v1/services/llm"))
                kinds.append(sorted({e.get("event") for e in call(
                    "GET", "/api/v1/events?limit=100")["data"]}))
                replies.append(call("GET", "/api/v1/services/llm"))
                health = call("GET", "/healthz")["data"]["admission"]
            finally:
                prg.stop()
            for r in replies:
                if isinstance(r.get("data"), dict):
                    # a page's store revision and its token (which holds
                    # it) count the store's writes, not the reply
                    r["data"].pop("rev", None)
                    r["data"].pop("continue", None)
            return tc.scrub(tc.unclocked({"replies": replies,
                                          "kinds": kinds, "health": health}))

        got = tc.both(case)
        r = got["replies"]
        assert r[0]["code"] == 200
        assert r[0]["data"]["priorityClass"] == "production"
        assert r[1]["data"][0]["name"] == "llm-0"
        assert r[3]["data"]["offeredRps"] == 50.0
        assert r[4]["code"] != 200
        assert r[5]["data"]["replicas"] == 2
        assert r[5]["data"]["manualScaleTotal"] == 1
        assert r[6]["data"]["lastScale"]["trigger"] == "manual"
        assert r[7]["data"]["enabled"] is True
        assert {"service-created", "service-scaled"} <= set(got["kinds"][0])
        assert r[8]["code"] == 200
        assert "service-deleted" in got["kinds"][1]
        assert r[9]["code"] == tc.PORT.errors.ServiceNotExist.code
        assert got["health"]["enabled"] is True
