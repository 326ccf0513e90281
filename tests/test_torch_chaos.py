"""The port's crash-consistency chaos matrix against the JAX package's on
the CPU (modeled on ``tests/test_chaos.py``): each case arms one labeled
crash point in each package, drives the same flow into it — the
``SimulatedCrash`` is a BaseException, so no in-process rollback runs,
exactly like ``kill -9`` — then boots a FRESH ``Program`` of that package
over the same store and runtime and lets its reconciler repair the
wreckage. Covered: the 13 container cases (grow, shrink and volume
flows × the replace and patch points), the three queue points during a
volume-resize copy and a rolling-replace copy, the ``KV.apply`` boundary
on both sides of every commit of a create and a rolling replace, a
daemon killed inside a fan-out batch, ``reconcile.dirty_drained``, a
leader killed at each ``leader.*`` point mid-handoff of an interrupted
rolling replace (JAX's ``TestFailoverChaos``), and the history compactor
killed before and in the middle of a trim (JAX's ``COMPACTOR_CASES``).
The dry run's and the repair's reports, the end state (version maps,
running containers, GPU and port ownership) and the data must be JAX's,
``check_invariants`` must be empty, and a second pass must find nothing.
The matrix covers every crash label the port knows."""

import json
import time

import pytest

import chip_smoke
import torch_control as tc

pytestmark = pytest.mark.chaos


def _setup_family(pkg, prg, root):
    """train-0: 2 GPUs, 1 scheduled port, one bind, with checkpoint data."""
    c = pkg.c
    for d in ("v1", "v2"):
        (root / d).mkdir(parents=True, exist_ok=True)
    prg.container_svc.run_container(c.ContainerRun(
        image_name="jax", container_name="train", chip_count=2,
        container_ports=[c.ContainerPort(8080)],
        binds=[c.Bind(str(root / "v1"), "/data")]))
    with open(f"{prg.runtime.container_data_dir('train-0')}/ckpt.txt",
              "w") as f:
        f.write("step=100")


def _flow(pkg, prg, flow, root):
    c, svc = pkg.c, prg.container_svc
    if flow == "grow":
        svc.patch_container_chips("train", c.ContainerPatchChips(chip_count=4))
    elif flow == "shrink":
        svc.patch_container_chips("train", c.ContainerPatchChips(chip_count=1))
    else:
        svc.patch_container_volume("train", c.ContainerPatchVolume(
            old_bind=c.Bind(str(root / "v1"), "/data"),
            new_bind=c.Bind(str(root / "v2"), "/data")))


def _mutations(runtime) -> list:
    return [x for x in runtime.calls
            if x[0] in ("create", "start", "stop", "restart", "remove",
                        "crash")]


def _end_state(pkg, prg) -> dict:
    rt = prg.runtime
    running = [n for n in rt.container_list()
               if rt.container_inspect(n).running]
    data = {}
    for n in running:
        try:
            with open(f"{rt.container_data_dir(n)}/ckpt.txt") as f:
                data[n] = f.read()
        except FileNotFoundError:
            data[n] = None
    return {"world": tc.prg_world(prg), "data": data,
            "invariants": tc.invariants(pkg, prg),
            "fixpoint": prg.reconciler.reconcile()["actions"]}


_REPLACE_POINTS = ("replace.after_version_bump", "replace.after_create_new",
                   "replace.after_quiesce_old")
_PATCH_POINTS = ("patch.after_alloc", "patch.after_replace")
#: every (flow, crash point) pair that the flow actually traverses
CASES = ([("grow", p) for p in _REPLACE_POINTS + _PATCH_POINTS]
         + [("shrink", p) for p in _REPLACE_POINTS + _PATCH_POINTS]
         + [("volume", p) for p in _REPLACE_POINTS])
QUEUE_POINTS = ("queue.claim", "queue.exec", "queue.ack")
QUEUE_FLOWS = ("volume-resize", "container-replace")
TXN_FLOWS = ("container-create", "rolling-replace")
TXN_POINTS = ("txn.before_apply", "txn.after_apply")
FANOUT_CASES = (("serial", 1), ("parallel", 4))
RECONCILE_DIRTY_POINT = "reconcile.dirty_drained"


def test_case_matrix_covers_every_crash_point():
    from tpu_docker_api_torch.service import crashpoints as c

    assert {p for _, p in CASES} == set(c.CONTAINER_CRASH_POINTS)
    assert set(QUEUE_POINTS) == set(c.QUEUE_CRASH_POINTS)
    assert set(TXN_POINTS) == set(c.TXN_CRASH_POINTS)
    assert set(c.FANOUT_CRASH_POINTS) == {"fanout.mid_batch"}
    assert set(c.RECONCILE_CRASH_POINTS) == {RECONCILE_DIRTY_POINT}
    # the job, resize and admission labels are test_torch_job_chaos.py's
    # matrix, the service labels test_torch_service.py's, the workflow,
    # leader, shard and compactor labels those of test_torch_workflow.py,
    # test_torch_leader.py, test_torch_shard.py and test_torch_compactor.py,
    # the gateway's drain labels test_torch_gateway.py's
    assert (set(p for _, p in CASES) | set(QUEUE_POINTS) | set(TXN_POINTS)
            | {"fanout.mid_batch", RECONCILE_DIRTY_POINT}
            | set(c.JOB_CRASH_POINTS) | set(c.RESIZE_CRASH_POINTS)
            | set(c.ADMISSION_CRASH_POINTS) | set(c.SERVICE_CRASH_POINTS)
            | set(c.WORKFLOW_CRASH_POINTS) | set(c.LEADER_CRASH_POINTS)
            | set(c.SHARD_CRASH_POINTS) | set(c.COMPACTOR_CRASH_POINTS)
            | set(c.GATEWAY_CRASH_POINTS)
            == set(c.KNOWN_CRASH_POINTS))
    # every label the port knows is one JAX knows, under the same group
    for group in ("CONTAINER", "JOB", "QUEUE", "TXN", "FANOUT", "RECONCILE",
                  "ADMISSION", "RESIZE", "SERVICE", "WORKFLOW", "LEADER",
                  "SHARD", "COMPACTOR", "GATEWAY"):
        name = f"{group}_CRASH_POINTS"
        assert getattr(c, name) == getattr(tc.JAX.crash, name)


def _container_case(pkg, flow, point, root):
    kv = pkg.kv.MemoryKV()
    runtime = pkg.fake.FakeRuntime(root=str(root / "rt"))
    prg = tc.boot(pkg, kv, runtime)
    _setup_family(pkg, prg, root)
    with pkg.crash.armed(point):
        with pytest.raises(pkg.crash.SimulatedCrash):
            _flow(pkg, prg, flow, root)
    prg2 = tc.boot(pkg, kv, runtime)
    kv_before = dict(kv.range_prefix("/"))
    mutations_before = _mutations(runtime)
    dry = prg2.reconciler.reconcile(dry_run=True)
    assert dict(kv.range_prefix("/")) == kv_before
    assert _mutations(runtime) == mutations_before
    report = prg2.reconciler.reconcile()
    return {"dry": tc.shape(dry), "report": tc.shape(report),
            **_end_state(pkg, prg2)}


@pytest.mark.parametrize("flow,point", CASES,
                         ids=[f"{f}@{p}" for f, p in CASES])
def test_crash_restart_reconcile_converges_as_jax(flow, point, tmp_path):
    got = _container_case(tc.PORT, flow, point, tmp_path / "port")
    want = _container_case(tc.JAX, flow, point, tmp_path / "jax")
    assert got == want
    assert got["invariants"] == [] and got["fixpoint"] == []
    # exactly one live version, the latest, with the checkpoint
    latest = got["world"]["versions"]["train"]
    assert got["data"] == {f"train-{latest}": "step=100"}
    if (flow, point) != ("shrink", "patch.after_alloc"):  # the benign one
        assert got["dry"]["actions"] and got["report"]["actions"]


def _queue_case(pkg, flow, point, root):
    kv = pkg.kv.MemoryKV()
    runtime = pkg.fake.FakeRuntime(root=str(root / "rt"))
    prg = tc.boot(pkg, kv, runtime)
    if flow == "volume-resize":
        prg.volume_svc.create_volume(pkg.v.VolumeCreate(volume_name="data",
                                                        size="1GB"))
        src = runtime.volume_data_dir("data-0")
        with open(f"{src}/ckpt.txt", "w") as f:
            f.write("step=100")
        prg.volume_svc.patch_volume_size("data", pkg.v.VolumeSize(size="2GB"))
    else:
        _setup_family(pkg, prg, root)
        _flow(pkg, prg, "grow", root)  # journals the copy+start record
    with pkg.crash.armed(point):
        with pytest.raises(pkg.crash.SimulatedCrash):
            # the sync loop's code path, inline, into the armed point
            prg.wq.replay_journal(include_local=True)
    if point in ("queue.exec", "queue.ack"):
        # the copy landed before the crash: a replayed copy would drag
        # this tampered source into the new version
        src = (runtime.volume_data_dir("data-0") if flow == "volume-resize"
               else runtime.container_data_dir("train-0"))
        with open(f"{src}/ckpt.txt", "w") as f:
            f.write("tampered-after-crash")
    prg2 = tc.boot(pkg, kv, runtime)
    report = prg2.reconciler.reconcile()
    out = {"report": [tc.scrub((a["action"], a["target"], a.get("result")))
                      for a in report["actions"]],
           "journal": prg2.wq.stats()["journal"], **_end_state(pkg, prg2)}
    if flow == "volume-resize":
        with open(f"{runtime.volume_data_dir('data-1')}/ckpt.txt") as f:
            out["volume"] = (prg2.volume_versions.get("data"), f.read())
    return out


@pytest.mark.parametrize("flow,point",
                         [(f, p) for f in QUEUE_FLOWS for p in QUEUE_POINTS])
def test_queue_crash_replays_once_as_jax(flow, point, tmp_path):
    got = _queue_case(tc.PORT, flow, point, tmp_path / "port")
    want = _queue_case(tc.JAX, flow, point, tmp_path / "jax")
    assert got == want
    assert got["invariants"] == [] and got["fixpoint"] == []
    if point != "queue.ack":  # ack crashed AFTER the journal was clean
        assert "replay-task" in [a for a, _, _ in got["report"]]
    assert (got["journal"]["pending"], got["journal"]["inflight"],
            got["journal"]["dead"]) == (0, 0, 0)
    if flow == "volume-resize":
        assert got["volume"] == (1, "step=100")  # applied exactly once
    else:
        assert list(got["data"].values()) == ["step=100"]


def _txn_case(pkg, flow, point, root):
    """Walk the crash across the flow's k-th apply until the flow
    completes crash-free; one end state per k."""
    ends = []
    for k in range(16):
        kv = pkg.kv.MemoryKV()
        runtime = pkg.fake.FakeRuntime(root=str(root / f"rt-{k}"))
        prg = tc.boot(pkg, kv, runtime)
        if flow == "rolling-replace":
            _setup_family(pkg, prg, root)

            def mutate():
                _flow(pkg, prg, "grow", root)
        else:
            def mutate():
                prg.container_svc.run_container(pkg.c.ContainerRun(
                    image_name="jax", container_name="web", chip_count=2))
        try:
            with pkg.crash.armed(point, skip=k):
                mutate()
            return ends  # k is past the flow's last apply
        except pkg.crash.SimulatedCrash:
            pass
        prg2 = tc.boot(pkg, kv, runtime)
        report = prg2.reconciler.reconcile()
        ends.append({"k": k, "report": tc.shape(report),
                     **_end_state(pkg, prg2)})
    raise AssertionError(f"{flow} never completed within 16 applies")


@pytest.mark.parametrize("flow,point",
                         [(f, p) for f in TXN_FLOWS for p in TXN_POINTS])
def test_txn_boundary_crash_converges_as_jax(flow, point, tmp_path):
    got = _txn_case(tc.PORT, flow, point, tmp_path / "port")
    want = _txn_case(tc.JAX, flow, point, tmp_path / "jax")
    assert got == want
    assert got, f"{flow} performed no KV.apply at all"
    for end in got:
        assert end["invariants"] == [] and end["fixpoint"] == [], end


def _fanout_case(pkg, workers, root):
    """Three families whose containers died; a concurrent batch of
    restarts through the daemon's fan-out is killed after its first call
    settles. The fresh daemon restarts whatever the batch did not."""
    kv = pkg.kv.MemoryKV()
    runtime = pkg.fake.FakeRuntime(root=str(root / "rt"))
    prg = tc.boot(pkg, kv, runtime, fanout_workers=workers)
    names = [f"f{i}" for i in range(3)]
    for n in names:
        prg.container_svc.run_container(pkg.c.ContainerRun(
            image_name="jax", container_name=n, chip_count=1))
        runtime.crash_container(f"{n}-0")
    with pkg.crash.armed("fanout.mid_batch"):
        with pytest.raises(pkg.crash.SimulatedCrash):
            prg.fanout.run([(f"{n}-0", "container_restart",
                             lambda c=f"{n}-0": runtime.container_restart(c))
                            for n in names])
    prg.fanout.close()
    # in parallel mode the in-flight restarts settle before the raise
    settled = sorted(n for n in runtime.container_list()
                     if runtime.container_inspect(n).running)
    prg2 = tc.boot(pkg, kv, runtime, fanout_workers=workers)
    report = prg2.reconciler.reconcile()
    end = _end_state(pkg, prg2)
    prg2.fanout.close()
    return {"settled": settled, "report": tc.shape(report), **end}


@pytest.mark.parametrize("mode,workers", FANOUT_CASES)
def test_fanout_mid_batch_crash_converges_as_jax(mode, workers, tmp_path):
    got = _fanout_case(tc.PORT, workers, tmp_path / "port")
    want = _fanout_case(tc.JAX, workers, tmp_path / "jax")
    assert got["world"] == want["world"]
    assert got["invariants"] == want["invariants"] == []
    assert got["fixpoint"] == []
    assert set(got["world"]["runtime"]) == {"f0-0", "f1-0", "f2-0"}
    assert all(r for r, _ in got["world"]["runtime"].values())
    if mode == "serial":
        # the first restart landed, the rest were never dispatched
        assert got == want
        assert got["settled"] == ["f0-0"]
        assert [a["target"] for a in got["report"]["actions"]] == [
            "f1-0", "f2-0"]


def _dirty_case(pkg, root):
    kv = pkg.kv.MemoryKV()
    runtime = pkg.fake.FakeRuntime(root=str(root / "rt"))
    prg = tc.boot(pkg, kv, runtime)
    prg.container_svc.run_container(pkg.c.ContainerRun(
        image_name="jax", container_name="t", chip_count=2))
    informer = pkg.informer.Informer(kv, pkg.keys.PREFIX + "/")
    rec = pkg.rec.Reconciler(
        prg.runtime, prg.store, prg.chip_scheduler, prg.port_scheduler,
        prg.container_versions, container_svc=prg.container_svc,
        full_interval_s=3600)
    rec.attach_dirty_feed(informer)
    informer.start()
    deadline = time.monotonic() + 5
    while not informer.synced and time.monotonic() < deadline:
        time.sleep(0.02)
    rec.reconcile(mode="full")  # consume the startup full
    # drift the watch stream sees: member died, state re-touched
    runtime.crash_container("t-0")
    prg.store.put_container(prg.store.get_container("t-0"))
    with pkg.crash.armed(RECONCILE_DIRTY_POINT):
        with pytest.raises(pkg.crash.SimulatedCrash):
            rec.reconcile(mode="dirty")
    informer.close()  # the process "dies": every mark is gone
    prg2 = tc.boot(pkg, kv, runtime)
    report = prg2.reconciler.reconcile()
    return {"report": tc.shape(report), **_end_state(pkg, prg2)}


def test_dirty_pass_crash_replays_as_full_on_reboot_as_jax(tmp_path):
    got = _dirty_case(tc.PORT, tmp_path / "port")
    want = _dirty_case(tc.JAX, tmp_path / "jax")
    assert got == want
    assert [a["action"] for a in got["report"]["actions"]] == ["restart-dead"]
    assert got["invariants"] == [] and got["fixpoint"] == []


def test_crashed_flow_without_reconcile_violates_invariants(tmp_path):
    """The oracle is not vacuous: the crash DOES corrupt state, in both
    packages alike."""
    seen = {}
    for pkg in tc.PKGS:
        root = tmp_path / pkg.name
        kv = pkg.kv.MemoryKV()
        runtime = pkg.fake.FakeRuntime(root=str(root / "rt"))
        prg = tc.boot(pkg, kv, runtime)
        _setup_family(pkg, prg, root)
        with pkg.crash.armed("replace.after_quiesce_old"):
            with pytest.raises(pkg.crash.SimulatedCrash):
                _flow(pkg, prg, "grow", root)
        seen[pkg.name] = tc.invariants(pkg, tc.boot(pkg, kv, runtime))
    assert seen["port"] == seen["jax"] != []


def test_unknown_crash_label_is_refused():
    """A label that no service fires is not armed silently, in either
    package; every label of JAX's matrix, the gateway's drain handshake's
    included, is armed by both."""
    for pkg in tc.PKGS:
        with pytest.raises(ValueError, match="unknown crash points"):
            with pkg.crash.armed("gateway.drain.nowhere"):
                pass
    for label in ("gateway.drain.after_mark", "gateway.drain.after_ack",
                  "admission.enqueue", "service.create.after_record",
                  "workflow.create.after_record", "compact.before_trim",
                  "leader.after_acquire", "shard.coord.before_apply"):
        for pkg in tc.PKGS:
            with pkg.crash.armed(label):
                pass


#: election-lifecycle crash points: the failover matrix kills the leader at
#: each and proves the standby takes over within the lease TTL
LEADER_POINTS = ("leader.after_acquire", "leader.after_start_writers",
                 "leader.after_renew")


def _boot_ha(pkg, kv, runtime, holder, clock):
    """An HA fleet member over the shared store and engine: election on,
    writers follow the lease, the injected clock drives TTL expiry; the
    heartbeat thread never starts — the case steps the elector by hand."""
    prg = tc.boot(pkg, kv, runtime, host_probe_interval_s=0,
                  job_supervise_interval=0, reconcile_interval=0,
                  workflow_interval_s=0, leader_election=True,
                  leader_ttl_s=30.0, leader_id=holder)
    prg.leader_elector._clock = lambda: clock["now"]
    return prg


def _failover_case(pkg, point, root):
    """Two daemons over one store; the leader dies at ``point`` mid-handoff
    of an interrupted rolling replace. The standby stays hands-off while
    the lease lives, acquires at the first step past the deadline, replays
    the dead leader's journal and converges, while every epoch-fenced
    write of the deposed leader is rejected by the store."""
    kv = pkg.kv.MemoryKV()
    runtime = pkg.fake.FakeRuntime(root=str(root / "rt"))
    prg0 = tc.boot(pkg, kv, runtime)
    _setup_family(pkg, prg0, root)
    _flow(pkg, prg0, "grow", root)
    a, b, clock, out = chip_smoke.leader_takeover(
        pkg, point, kv,
        lambda holder, clock: _boot_ha(pkg, kv, runtime, holder, clock))
    del out["acquire_ms"]  # the card run's number, a wall time
    out.update(_end_state(pkg, b))
    stats = b.wq.stats()["journal"]
    out["journal"] = (stats["pending"], stats["inflight"])
    store_before = dict(kv.range_prefix("/"))
    txn = pkg.txn.StoreTxn(a.kv)
    txn.add_op(("put", "/apis/v1/fence-probe", "via-txn"))
    out["fenced"] = [
        a.leader_elector.is_leader,
        tc.outcome(a.kv.put, "/apis/v1/fence-probe", "stale"),
        tc.outcome(a.kv.apply, [("delete", pkg.keys.LEADER_EPOCH_KEY)]),
        tc.outcome(txn.commit),
        dict(kv.range_prefix("/")) == store_before]
    b.kv.put("/apis/v1/fence-probe", "fresh")
    clock["now"] += 5.0
    b.leader_elector.step()
    out["fresh"] = (kv.get("/apis/v1/fence-probe"), b.leader_elector.is_leader)
    return out


@pytest.mark.parametrize("point", LEADER_POINTS)
def test_leader_killed_standby_acquires_and_converges(point, tmp_path):
    out = tc.both(lambda pkg: _failover_case(pkg, point, tmp_path / pkg.name))
    assert out["a_epoch"] == 1  # the fencing token it died with
    assert out["hands_off"] == (False, True)  # stole no live lease
    assert out["within_ttl"] is True and out["b"] == (True, 2)
    assert out["invariants"] == [] and out["fixpoint"] == []
    assert out["world"]["versions"] == {"train": 1}
    assert out["data"] == {"train-1": "step=100"}
    assert out["journal"] == (0, 0)
    assert out["fenced"] == [True] + [("raise", "GuardFailed")] * 3 + [True]
    assert out["fresh"] == ("fresh", True)


#: (crash point, chunk index to die at): before_trim dies with nothing
#: deleted; mid_trim dies with exactly one chunk durable
COMPACTOR_CASES = (("compact.before_trim", 0), ("compact.mid_trim", 0))


def _compactor_case(pkg, point, skip):
    """``chip_smoke.compactor_crash`` on one fake host: a family whose
    old versions' members are gone, the compactor killed at ``point``; a
    fresh daemon reads the latest, finds no drift, and a re-run finishes
    the trim exactly once."""
    rt = pkg.fake.FakeRuntime()
    out, _, _ = chip_smoke.compactor_crash(
        pkg, point, lambda kv: tc.boot(pkg, kv, rt),
        lambda spec: rt.seed_running(["t-7"], spec), image="jax", skip=skip)
    return out


@pytest.mark.parametrize("point,skip", COMPACTOR_CASES)
def test_compactor_crash_converges(point, skip):
    out = tc.both(lambda pkg: _compactor_case(pkg, point, skip))
    assert out["latest"] == 7
    assert out["repair"] == [], f"{point}: trim read as drift"
    assert out["oracle"] == [] and out["fixpoint"] == []
    assert out["history"] == [6, 7] and out["running"] is True
