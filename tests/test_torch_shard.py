"""The port's sharded writer plane (``service/shard.py``,
``state/version.py`` ``ShardedVersionMap``, the daemon's shard callbacks
and the API's per-shard gate) against the JAX package's on the CPU: every
case of ``tests/test_shard.py`` runs one script through each package —
the shard map's assignment, movement and key classification, the
mutation router, the cross-shard coordination record, the unsharded
compatibility pins and the shard chaos matrix (a portfolio leader killed
at every ``leader.*`` and ``shard.coord.*`` crash point, with injected
lease clocks) — and what each left behind must be JAX's. JAX's own
assertions then hold on the port's side."""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import torch_control as tc
from tpu_docker_api.api import app as japp
from tpu_docker_api_torch.api import app as tapp

SHARD_CHAOS_POINTS = (tc.PORT.crash.LEADER_CRASH_POINTS
                      + tc.PORT.crash.SHARD_CRASH_POINTS)


def app(pkg):
    return japp if pkg is tc.JAX else tapp


def base_for_shard(smap, shard: int, tag: str = "f") -> str:
    """A family base name owned by ``shard`` under ``smap``."""
    for i in range(10_000):
        name = f"{tag}{i}"
        if smap.shard_of(name) == shard:
            return name
    raise AssertionError(f"no base found for shard {shard}")


class TestShardMap:
    def test_assignment_is_stable_total_and_single_shard_degenerate(self):
        def case(pkg):
            m3a, m3b = pkg.shard.ShardMap(3), pkg.shard.ShardMap(3)
            got = [m3a.shard_of(f"fam{i}") for i in range(300)]
            assert got == [m3b.shard_of(f"fam{i}") for i in range(300)]
            m1 = pkg.shard.ShardMap(1)
            return got, {m1.shard_of(f"fam{i}") for i in range(300)}

        got, single = tc.both(case)
        assert set(got) == {0, 1, 2} and single == {0}

    def test_service_and_replica_gangs_colocate(self):
        def case(pkg):
            m = pkg.shard.ShardMap(5)
            return {svc: [m.shard_of(svc)] + [m.shard_of(f"{svc}.r{r}")
                                              for r in range(8)]
                    for svc in ("api", "frontend", "ranker7")}

        for homes in tc.both(case).values():
            assert len(set(homes)) == 1

    def test_count_change_moves_only_the_minimal_family_set(self):
        roots = [f"fam{i}" for i in range(400)]

        def case(pkg):
            m3, m4 = pkg.shard.ShardMap(3), pkg.shard.ShardMap(4)
            moved = m3.moved_families(roots, 4)
            return {"moved": sorted(moved),
                    "to": {m4.shard_of(r) for r in moved},
                    "stayed": all(m4.shard_of(r) == m3.shard_of(r)
                                  for r in set(roots) - set(moved)),
                    "back": sorted(m4.moved_families(roots, 3))}

        out = tc.both(case)
        assert len(out["moved"]) / len(roots) < 0.45
        assert out["to"] == {3} and out["stayed"]
        assert out["back"] == out["moved"]

    def test_key_classification_round_trips_the_layout(self):
        def case(pkg):
            keys, m = pkg.keys, pkg.shard.ShardMap(3)
            probes = [
                "/apis/v1/containers/train/latest",
                "/apis/v1/containers/train/v/0000000001",
                "/apis/v1/jobs/train/latest",
                keys.queue_task_key(7), keys.queue_task_key(7, 2),
                keys.queue_marker_key("t1", 1),
                keys.admission_record_key(3),
                keys.admission_record_key(3, 2),
                keys.VERSIONS_CONTAINER_KEY,
                keys.versions_shard_key(keys.Resource.JOBS, 2),
                keys.SCHEDULER_CHIPS_KEY, keys.SCHEDULER_PORTS_KEY,
                keys.HOSTS_CORDONED_KEY, keys.LEADER_LEASE_KEY,
                keys.shard_lease_key(1), keys.SHARD_COORD_KEY]
            return m.shard_of("train"), [m.shard_of_key(k) for k in probes]

        train, got = tc.both(case)
        assert got[:3] == [train] * 3
        assert got[3:10] == [0, 2, 1, 0, 2, 0, 2]
        assert got[10:] == [None] * 6

    def test_shard_zero_owns_every_legacy_key(self):
        for pkg in tc.PKGS:
            keys = pkg.keys
            assert keys.shard_lease_key(0) == keys.LEADER_LEASE_KEY
            assert keys.shard_epoch_key(0) == keys.LEADER_EPOCH_KEY
            assert keys.queue_tasks_prefix(0) == keys.QUEUE_TASKS_PREFIX
            assert keys.queue_markers_prefix(0) == keys.QUEUE_MARKERS_PREFIX
            assert keys.admission_prefix(0) == keys.ADMISSION_PREFIX
            assert (keys.versions_shard_key(keys.Resource.CONTAINERS, 0)
                    == keys.VERSIONS_CONTAINER_KEY)


class TestMutationRouting:
    def test_family_mutations_route_by_name(self):
        def case(pkg):
            plane = types.SimpleNamespace(map=pkg.shard.ShardMap(3))
            route = app(pkg)._shard_for_request
            out = {}
            for res, field in (("containers", "containerName"),
                               ("volumes", "volumeName"),
                               ("jobs", "jobName"),
                               ("services", "serviceName"),
                               ("workflows", "workflowName")):
                raw = json.dumps({field: "webapp"}).encode()
                out[res] = (
                    route(plane, f"/api/v1/{res}/train-3/stop", b""),
                    route(plane, f"/api/v1/{res}/train", b""),
                    route(plane, f"/api/v1/{res}", raw))
            return out, plane.map.shard_of("train"), plane.map.shard_of(
                "webapp")

        out, train, webapp = tc.both(case)
        assert set(out.values()) == {(train, train, webapp)}

    def test_non_family_mutations_belong_to_shard_zero(self):
        def case(pkg):
            plane = types.SimpleNamespace(map=pkg.shard.ShardMap(3))
            route = app(pkg)._shard_for_request
            return [route(plane, path, raw) for path, raw in (
                ("/api/v1/hosts/h1/cordon", b""),
                ("/api/v1/hosts/h1/drain", b""),
                ("/api/v1/reconcile", b""),
                ("/api/v1/dead-letters/retry", b""),
                ("/api/v1/compact", b""),
                ("/api/v1/containers", b"{nope"),
                ("/api/v1/containers", b"{}"))]

        assert tc.both(case) == [0] * 7

    def test_reads_are_never_gated_and_wrong_shard_mutations_503(self):
        """A process holding only some shards serves every read, owns its
        shards' mutations and 503s the rest with the owning shard named —
        zero store reads on the 503 path."""
        def case(pkg):
            kv, rt = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
            clock = {"now": 100.0}
            smap = pkg.shard.ShardMap(3)
            alpha = boot_shard(pkg, kv, rt, "alpha", clock, preferred=(0, 1))
            beta = boot_shard(pkg, kv, rt, "beta", clock, preferred=(2,))
            out = {}
            try:
                alpha.start()
                beta.start()
                wait_until(lambda: sorted(alpha.shard_plane.held) == [0, 1],
                           what="alpha holding shards 0,1")
                wait_until(lambda: sorted(beta.shard_plane.held) == [2],
                           what="beta holding shard 2")
                mine, theirs = base_for_shard(smap, 0), base_for_shard(smap, 2)
                out["mine"] = http_call(alpha, "POST", "/api/v1/containers", {
                    "imageName": "jax", "containerName": mine,
                    "chipCount": 0})[1]["code"]
                wait_until(lambda: alpha.shard_plane.electors[2]
                           .leader_hint()["holderId"] == "beta",
                           what="alpha observing beta's shard-2 lease")
                reads = count_reads(kv)
                status, reply = http_call(
                    alpha, "POST", "/api/v1/containers",
                    {"imageName": "jax", "containerName": theirs,
                     "chipCount": 0})
                out["theirs"] = (status, reply["code"],
                                 "shard 2" in reply["msg"],
                                 "beta" in reply["msg"], reads(),
                                 alpha.container_versions.get(theirs))
                out["read"] = http_call(
                    beta, "GET", f"/api/v1/containers/{mine}-0")[1]["code"]
                view = http_call(alpha, "GET", "/api/v1/shards")[1]["data"]
                out["view"] = (view["sharded"], view["shardCount"],
                               view["held"],
                               {s["shard"]: s["holderId"]
                                for s in view["shards"]})
                health = http_call(alpha, "GET", "/healthz")[1]["data"]
                out["health"] = (health["role"], health["shards"])
                events = http_call(alpha, "GET", "/api/v1/events")[1]["data"]
                out["acquired"] = sorted({e["shard"] for e in events
                                          if e.get("event")
                                          == "shard-acquired"})
            finally:
                alpha.stop()
                beta.stop()
            return out

        with tc.jax_knows_h100():
            out = tc.both(case)
        assert out["mine"] == 200 and out["read"] == 200
        assert out["theirs"] == (503, tc.PORT.errors.NotLeader.code, True,
                                 True, 0, None)
        assert out["view"] == (True, 3, [0, 1],
                               {0: "alpha", 1: "alpha", 2: "beta"})
        assert out["health"] == ("leader", {"count": 3, "held": [0, 1]})
        assert out["acquired"] == [0, 1]


def stale_coord_kv(pkg, stale_reads: int):
    """A MemoryKV whose get_or returns a stale coordination seq the first
    ``stale_reads`` times: another shard leader winning the CAS between
    our read and our apply."""
    class _StaleCoordKV(pkg.kv.MemoryKV):
        def __init__(self) -> None:
            super().__init__()
            self.stale_left = stale_reads

        def get_or(self, key, default=None):
            val = super().get_or(key, default)
            if key == pkg.keys.SHARD_COORD_KEY and self.stale_left > 0:
                self.stale_left -= 1
                return None if val is None else json.dumps({"seq": -1})
            return val

    return _StaleCoordKV()


def real_seq(pkg, kv) -> int:
    raw = pkg.kv.MemoryKV.get_or(kv, pkg.keys.SHARD_COORD_KEY)
    return json.loads(raw)["seq"] if raw else 0


def full_plane(pkg, kv, count=3):
    plane = pkg.shard.ShardPlane(kv, pkg.shard.ShardMap(count), "me",
                                 ttl_s=30.0, clock=lambda: 100.0)
    plane.step_all()
    assert plane.held == frozenset(range(count))
    return plane


def two_shard_ops(pkg, smap):
    a, b = base_for_shard(smap, 0), base_for_shard(smap, 1)
    return [("put", pkg.keys.latest_key(pkg.keys.Resource.CONTAINERS, a), "1"),
            ("put", pkg.keys.latest_key(pkg.keys.Resource.CONTAINERS, b), "1")]


class TestCoordinationRecord:
    def test_cross_shard_batches_bump_the_seq_single_shard_do_not(self):
        def case(pkg):
            keys = pkg.keys
            kv = pkg.kv.MemoryKV()
            plane = full_plane(pkg, kv)
            skv = pkg.shard.ShardedKV(kv, plane)
            seqs = [pkg.shard.coord_seq(kv)]
            a = keys.latest_key(keys.Resource.CONTAINERS,
                                base_for_shard(plane.map, 0))
            for ops in ([("put", a, "0")], two_shard_ops(pkg, plane.map),
                        [("put", a, "0"),
                         ("put", keys.SCHEDULER_CHIPS_KEY, "{}")],
                        [("put", keys.SCHEDULER_CHIPS_KEY, "{}")]):
                skv.apply(ops)
                seqs.append(pkg.shard.coord_seq(kv))
            return seqs, kv.range_prefix("/")

        seqs, _ = tc.both(case)
        assert seqs == [0, 0, 1, 2, 3]

    def test_benign_cas_loss_is_retried_to_success(self):
        def case(pkg):
            kv = stale_coord_kv(pkg, 3)
            kv.put(pkg.keys.SHARD_COORD_KEY,
                   json.dumps({"seq": 5}, sort_keys=True))
            plane = full_plane(pkg, kv)
            ops = two_shard_ops(pkg, plane.map)
            pkg.shard.ShardedKV(kv, plane).apply(ops)
            return kv.stale_left, real_seq(pkg, kv), kv.get(ops[0][1])

        assert tc.both(case) == (0, 6, "1")

    def test_contended_past_budget_is_a_typed_guard_failed(self):
        def case(pkg):
            kv = stale_coord_kv(pkg, 10_000)
            kv.put(pkg.keys.SHARD_COORD_KEY,
                   json.dumps({"seq": 5}, sort_keys=True))
            plane = full_plane(pkg, kv)
            ops = two_shard_ops(pkg, plane.map)
            with pytest.raises(pkg.errors.GuardFailed) as ei:
                pkg.shard.ShardedKV(kv, plane).apply(ops)
            return ("coordination record" in str(ei.value),
                    kv.get_or(ops[0][1]), real_seq(pkg, kv))

        assert tc.both(case) == (True, None, 5)

    def test_fence_loss_is_never_retried_as_contention(self):
        """A deposed shard leader's cross-shard batch surfaces the FENCE
        failure and leaves the seq unbumped."""
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            clock = {"now": 100.0}
            mk = lambda holder: pkg.shard.ShardPlane(
                kv, pkg.shard.ShardMap(3), holder, ttl_s=30.0,
                clock=lambda: clock["now"])
            plane_a = mk("a")
            plane_a.step_all()
            clock["now"] += 31.0
            plane_b = mk("b")
            plane_b.step_all()
            ops = two_shard_ops(pkg, plane_a.map)
            with pytest.raises(pkg.errors.GuardFailed) as ei:
                pkg.shard.ShardedKV(kv, plane_a).apply(ops)
            out = [sorted(plane_b.held),
                   pkg.keys.SHARD_COORD_KEY in str(ei.value),
                   pkg.shard.coord_seq(kv), kv.get_or(ops[0][1])]
            pkg.shard.ShardedKV(kv, plane_b).apply(ops)
            return out + [pkg.shard.coord_seq(kv)]

        assert tc.both(case) == [[0, 1, 2], False, 0, None, 1]


class TestSingleShardCompat:
    def test_task_and_admission_records_omit_shard_zero(self):
        """Shard-0 (every unsharded) record serializes exactly as before
        the sharded plane existed, in both packages."""
        def case(pkg):
            rec = pkg.wq.TaskRecord(task_id="t", kind="put_kv", params={},
                                    seq=1)
            rec2 = pkg.wq.TaskRecord(task_id="t", kind="put_kv", params={},
                                     seq=1, shard=2)
            adm = pkg.adm.AdmissionRecord(seq=1, base="b", kind="queued",
                                          klass="batch")
            return (rec.to_json(), pkg.wq.TaskRecord.from_json(
                rec.to_json()).shard, rec2.to_json(), adm.to_json(),
                pkg.adm.AdmissionRecord.from_json(adm.to_json()).shard)

        rec, shard, rec2, adm, adm_shard = tc.both(case)
        assert "shard" not in json.loads(rec) and shard == 0
        assert json.loads(rec2)["shard"] == 2
        assert "shard" not in json.loads(adm) and adm_shard == 0

    def test_unsharded_store_carries_no_shard_artifacts(self, tmp_path):
        """leader_election=false: the store a workload produces has no
        shard leases, no coordination record, no sub-prefixed journal
        keys."""
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            rt = pkg.fake.FakeRuntime(root=str(tmp_path / pkg.name / "rt"))
            prg = tc.boot(pkg, kv, rt, host_probe_interval_s=0,
                          job_supervise_interval=0, reconcile_interval=0)
            out = [prg.shard_plane, prg.shard_map]
            prg.container_svc.run_container(pkg.c.ContainerRun(
                image_name="jax", container_name="web", chip_count=2,
                container_ports=[pkg.c.ContainerPort(8080)]))
            store = kv.range_prefix("/")
            out.append(sorted(store))
            out.append([json.loads(v) for k, v in sorted(store.items())
                        if k.startswith(pkg.keys.QUEUE_TASKS_PREFIX)])
            return tc.scrub(out)

        with tc.jax_knows_h100():
            plane, smap, store, tasks = tc.both(case)
        assert plane is None and smap is None
        assert not any("/leader/" in k for k in store)
        assert not any("/queue/tasks/s" in k or "/queue/markers/s" in k
                       or "/admission/s" in k or "/versions/shards/" in k
                       for k in store)
        assert all("shard" not in t for t in tasks)


def boot_shard(pkg, kv, runtime, holder, clock, preferred=(),
               shard_count=3):
    """A sharded fleet member over the shared store and engine: three
    leases, writer loops follow the shard portfolio, the injected clock
    drives TTL expiry. Elector threads run only after ``start()``."""
    cfg = pkg.config.Config(
        port=0, store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8",
        health_watch_interval=0, end_port=40099, host_probe_interval_s=0,
        job_supervise_interval=0, reconcile_interval=0,
        workflow_interval_s=0,
        leader_election=True, leader_ttl_s=30.0, leader_id=holder,
        leader_renew_interval_s=0.05,
        shard_count=shard_count, shard_preferred=list(preferred),
        shard_standby_delay_s=50.0,
    )
    prg = pkg.daemon.Program(cfg, host="127.0.0.1", kv=kv, runtime=runtime,
                             leader_clock=lambda: clock["now"])
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    return prg


def step_fleet(*progs):
    for p in progs:
        p.shard_plane.step_all()


def http_call(prg, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{prg.api_server.port}{path}", method=method,
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


def count_reads(kv):
    """A closure reporting how many get/range calls the HTTP server's
    request threads made on ``kv`` since (the electors' heartbeats read
    the store on their own threads all along)."""
    calls = {"n": 0}
    real_get, real_range = kv.get_or, kv.range_prefix

    def count():
        if "process_request" in threading.current_thread().name:
            calls["n"] += 1

    def get_or(key, default=None):
        count()
        return real_get(key, default)

    def range_prefix(prefix):
        count()
        return real_range(prefix)

    kv.get_or, kv.range_prefix = get_or, range_prefix
    return lambda: calls["n"]


def unsharded_seed(pkg, kv, runtime, tmp_path) -> str:
    """An interrupted rolling replace of family ``train`` left by a plain
    unsharded Program whose queue never ran: the copy+start record stays
    pending in shard 0's (the flat) journal."""
    prg = tc.boot(pkg, kv, runtime, host_probe_interval_s=0,
                  job_supervise_interval=0, reconcile_interval=0)
    (tmp_path / "v1").mkdir(parents=True, exist_ok=True)
    prg.container_svc.run_container(pkg.c.ContainerRun(
        image_name="jax", container_name="train", chip_count=2,
        container_ports=[pkg.c.ContainerPort(8080)],
        binds=[pkg.c.Bind(str(tmp_path / "v1"), "/data")]))
    with open(f"{runtime.container_data_dir('train-0')}/ckpt.txt", "w") as f:
        f.write("step=100")
    prg.container_svc.patch_container_chips(
        "train", pkg.c.ContainerPatchChips(chip_count=4))
    assert kv.range_prefix(pkg.keys.QUEUE_TASKS_PREFIX)
    return "train"


def shard_chaos(pkg, point, tmp_path):
    """Kill a shard-portfolio leader at ``point``: the surviving shard's
    writes never block, the victim shards recover within one lease TTL,
    journal replay is exactly-once and the deposed leader is fenced out
    of everything it no longer holds."""
    errors, keys, crash = pkg.errors, pkg.keys, pkg.crash
    kv = pkg.kv.MemoryKV()
    runtime = pkg.fake.FakeRuntime(root=str(tmp_path / "rt"))
    clock = {"now": 1000.0}
    smap = pkg.shard.ShardMap(3)
    beta = boot_shard(pkg, kv, runtime, "beta", clock, preferred=(2,))
    step_fleet(beta)
    out = {"beta": sorted(beta.shard_plane.held)}
    seed = unsharded_seed(pkg, kv, runtime, tmp_path)
    alpha = boot_shard(pkg, kv, runtime, "alpha", clock, preferred=(0, 1))
    if point == "leader.after_renew":
        step_fleet(alpha)
        out["alpha"] = sorted(alpha.shard_plane.held)
        clock["now"] += 10.0
        with crash.armed(point):
            with pytest.raises(crash.SimulatedCrash):
                alpha.shard_plane.step_all()
    elif point.startswith("leader."):
        with crash.armed(point):
            with pytest.raises(crash.SimulatedCrash):
                alpha.shard_plane.step_all()
        out["alpha"] = alpha.shard_plane.electors[0].epoch >= 1
    else:
        step_fleet(alpha)
        out["alpha"] = sorted(alpha.shard_plane.held)
        with crash.armed(point):
            with pytest.raises(crash.SimulatedCrash):
                alpha.container_svc.run_container(pkg.c.ContainerRun(
                    image_name="jax",
                    container_name=base_for_shard(smap, 1, tag="coordfam"),
                    chip_count=2))
    # the survivor's shard never blocks while alpha's leases are live
    survivor = base_for_shard(smap, 2, tag="live")
    out["survivor"] = beta.container_svc.run_container(pkg.c.ContainerRun(
        image_name="jax", container_name=survivor, chip_count=0))["name"]
    deadlines = [json.loads(kv.get(keys.shard_lease_key(i)))["deadline"]
                 for i in range(2) if kv.get_or(keys.shard_lease_key(i))]
    out["within_ttl"] = bool(deadlines) and (
        max(deadlines) - clock["now"] <= beta.cfg.leader_ttl_s)
    clock["now"] = max(deadlines + [clock["now"] + 50.0]) + 0.001
    step_fleet(beta)
    out["takeover"] = sorted(beta.shard_plane.held)
    out["oracle"] = tc.invariants(pkg, beta)
    out["seed_version"] = beta.container_versions.get(seed)
    out["running"] = [n for n in runtime.container_list()
                      if runtime.container_inspect(n).running
                      and n.startswith(seed)]
    with open(f"{runtime.container_data_dir(seed + '-1')}/ckpt.txt") as f:
        out["ckpt"] = f.read()
    stats = beta.wq.stats()["journal"]
    out["journal"] = (stats["pending"], stats["inflight"])
    out["fixpoint"] = beta.reconciler.reconcile()["actions"]
    store_before = dict(kv.range_prefix("/"))
    fams = [keys.latest_key(keys.Resource.CONTAINERS,
                            base_for_shard(smap, i, tag="probe"))
            for i in range(3)]
    fenced = []
    for ops in ([("put", fams[0], "stale")],
                [("put", fams[1], "stale"), ("put", fams[0], "stale")],
                [("put", fams[2], "stale")]):
        fenced.append(tc.outcome(alpha.kv.apply, ops))
    out["fenced"] = fenced
    out["untouched"] = dict(kv.range_prefix("/")) == store_before
    beta.kv.apply([("put", fams[0], "fresh"), ("put", fams[1], "fresh")])
    out["fresh"] = kv.get(fams[0])
    out["world"] = tc.prg_world(beta)
    alpha.stop()
    beta.stop()
    return out


class TestShardChaos:
    @pytest.mark.parametrize("point", SHARD_CHAOS_POINTS)
    def test_shard_leader_killed_survivors_unblocked_victim_recovers(
            self, tmp_path, point):
        with tc.jax_knows_h100():
            out = tc.both(lambda pkg: shard_chaos(pkg, point,
                                                  tmp_path / pkg.name))
        assert out["beta"] == [2]
        assert out["alpha"] in ([0, 1], True)
        assert out["survivor"].endswith("-0")
        assert out["within_ttl"] is True
        assert out["takeover"] == [0, 1, 2]
        assert out["oracle"] == [], point
        assert out["seed_version"] == 1
        assert out["running"] == ["train-1"]
        assert out["ckpt"] == "step=100"
        assert out["journal"] == (0, 0)
        assert out["fixpoint"] == []
        assert out["fenced"] == [("raise", "GuardFailed")] * 3
        assert out["untouched"] is True and out["fresh"] == "fresh"
