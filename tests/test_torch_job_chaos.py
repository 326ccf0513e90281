"""The port's job crash matrix against the JAX package's on the CPU (modeled
on ``tests/test_chaos.py``): each case arms one labeled crash point in each
package, drives the same job flow into it (``SimulatedCrash`` is a
BaseException, so no in-process rollback runs, exactly like ``kill -9``),
then boots a FRESH ``Program`` of that package over the same store and
engines and lets its reconciler (or supervisor) repair the wreckage.
Covered: ``JOB_CASES`` (run, rescale and gang-restart points), the gang
fan-out cases (a daemon killed inside a concurrent create or quiesce
batch), the ``KV.apply`` boundary of a gang create, the crash loop, host
failures (blip vs dead, every feasible migrate point, the release-first
path, the supervisor's adoption, a drain against a full pool), an
elastic gang's host-death shrink through every ``job.resize.*`` point,
and the capacity market: JAX's ``ADMISSION_CASES`` (a preemption killed
at every ``admission.*`` label, the readmit window alone) and its
partial-preemption ``RESIZE_CASES``.
The reports' ``(action, target)`` lists, the end state (versions, slices,
GPU and port owners per host, each engine's containers and states) and
the events must be JAX's; ``check_job_invariants`` and
``check_invariants`` must be empty and a second pass must find nothing.
The matrix covers every job, resize and admission label the port knows."""

import time

import pytest

import torch_control as tc

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def pod_cfg(pkg, n_hosts=2, **cfg):
    """An n-host row of 8-GPU hosts; h0 is the daemon-local host sharing
    the injected runtime and schedulers, the others remote fake engines."""
    return pkg.config.Config(
        store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8", health_watch_interval=0, end_port=40099,
        pod_hosts=[{"host_id": f"h{i}", "address": f"10.0.0.{i + 1}",
                    "grid_coord": [i, 0, 0],
                    **({"local": True} if i == 0
                       else {"runtime_backend": "fake"})}
                   for i in range(n_hosts)], **cfg)


def boot(pkg, kv, rts, **cfg):
    """A Program over injected state (``rts``: host id → engine), init
    only: the work queue is not started (the crash model)."""
    prg = pkg.daemon.Program(pod_cfg(pkg, len(rts), **cfg), kv=kv,
                             runtime=rts["h0"],
                             pod_runtimes={h: r for h, r in rts.items()
                                           if h != "h0"})
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    return prg


def engines(pkg, n=2, faulty=()):
    """Host id → engine; hosts in ``faulty`` get a FaultyRuntime (its
    inner engine is ``.inner``)."""
    out = {}
    for i in range(n):
        rt = pkg.fake.FakeRuntime()
        if f"h{i}" in faulty:
            rt = pkg.faulty.FaultyRuntime(rt, pkg.faulty.FaultPlan())
        out[f"h{i}"] = rt
    return out


def oracle(pkg, prg) -> list:
    return tc.job_invariants(pkg, prg) + pkg.inv.check_invariants(
        prg.runtime, prg.store, prg.container_versions, prg.chip_scheduler,
        prg.port_scheduler, job_versions=prg.job_versions)


def mutations(rts) -> list:
    out = []
    for hid in sorted(rts):
        rt = getattr(rts[hid], "inner", rts[hid])
        out += [(hid, *x) for x in rt.calls
                if x[0] in ("create", "start", "stop", "restart", "remove",
                            "crash")]
    return out


def acts(report) -> list:
    return [(a["action"], a["target"]) for a in report["actions"]]


def end_state(pkg, prg) -> dict:
    latest = prg.job_versions.get("train")
    st = (prg.store.get_job(f"train-{latest}").to_dict()
          if latest is not None else None)
    if st is not None:
        st.pop("last_resize", None)  # stamped with the wall clock
    return {"world": tc.job_world(prg), "state": st,
            "oracle": oracle(pkg, prg),
            "fixpoint": prg.reconciler.reconcile()["actions"]}


_JOB_RUN_POINTS = ("job.run.after_version_bump", "job.run.after_create")
_JOB_PATCH_POINTS = ("job.patch.after_quiesce_old",
                     "job.patch.after_start_new")
_JOB_GANG_POINTS = ("job.gang.after_mark_restarting",
                    "job.gang.after_stop_all")
#: JAX's JOB_CASES: job flows × the crash points each traverses
JOB_CASES = ([("run", p) for p in _JOB_RUN_POINTS]
             + [("rescale", p) for p in _JOB_RUN_POINTS + _JOB_PATCH_POINTS]
             + [("gang", p) for p in _JOB_GANG_POINTS])
#: migrate_gang points of the feasible (allocate-first) flow
MIGRATE_POINTS = ("job.migrate.after_mark", "job.migrate.after_create_new",
                  "job.migrate.after_quiesce_old",
                  "job.migrate.after_start_new")
INFEASIBLE_MIGRATE_POINT = "job.migrate.after_release"
FANOUT_CASES = (("run", "fanout.mid_batch"),
                ("rescale-quiesce", "fanout.mid_batch"))
#: an elastic gang's host-death shrink, killed at each resize point
RESIZE_POINTS = ("job.resize.after_mark", "job.resize.after_quiesce",
                 "job.resize.after_create_new", "job.resize.after_start_new")
#: JAX's ADMISSION_CASES (tests/test_chaos.py): every capacity-market
#: label; skip=k picks admission.preempt's firing (0: after the
#: preempted-intent apply, the gang still running; 1: after its quiesce,
#: before its release)
ADMISSION_CASES = (("admission.enqueue", 0), ("admission.select_victims", 0),
                   ("admission.preempt", 0), ("admission.preempt", 1),
                   ("admission.readmit", 0))
#: JAX's RESIZE_CASES: a partial preemption killed at each resize label;
#: job.resize.after_start_new fires twice on a shrink (0: before the
#: grow-back record, 1: with it durable)
MARKET_RESIZE_CASES = (("admission.partial_preempt", 0),
                       ("job.resize.after_mark", 0),
                       ("job.resize.after_quiesce", 0),
                       ("job.resize.after_create_new", 0),
                       ("job.resize.after_start_new", 0),
                       ("job.resize.after_start_new", 1))


def test_case_matrix_covers_every_job_and_resize_label():
    c = tc.tcrash
    assert ({p for _, p in JOB_CASES} | set(MIGRATE_POINTS)
            | {INFEASIBLE_MIGRATE_POINT} == set(c.JOB_CRASH_POINTS))
    # the resize group holds the capacity market's partial-preempt label,
    # which the partial-preemption matrix below reaches with the others
    assert set(RESIZE_POINTS) | {"admission.partial_preempt"} == set(
        c.RESIZE_CRASH_POINTS) == {p for p, _ in MARKET_RESIZE_CASES}
    assert {p for p, _ in ADMISSION_CASES} == set(c.ADMISSION_CRASH_POINTS)
    for group in ("JOB", "RESIZE", "ADMISSION"):
        name = f"{group}_CRASH_POINTS"
        assert getattr(c, name) == getattr(tc.JAX.crash, name)


@pytest.mark.parametrize("flow,point", JOB_CASES,
                         ids=[f"{f}@{p}" for f, p in JOB_CASES])
def test_job_crash_restart_reconcile_converges(flow, point):
    def case(pkg):
        kv, rts = pkg.kv.MemoryKV(), engines(pkg)
        prg = boot(pkg, kv, rts)
        run = pkg.js.JobRun
        if flow == "rescale":
            prg.job_svc.run_job(run(image_name="jax", job_name="train",
                                    chip_count=4))
        elif flow == "gang":
            prg.job_svc.run_job(run(image_name="jax", job_name="train",
                                    chip_count=16))
        with pkg.crash.armed(point):
            with pytest.raises(pkg.crash.SimulatedCrash):
                if flow == "run":
                    prg.job_svc.run_job(run(image_name="jax",
                                            job_name="train", chip_count=16))
                elif flow == "rescale":
                    prg.job_svc.patch_job_chips(
                        "train", pkg.js.JobPatchChips(chip_count=8))
                else:
                    rts["h1"].crash_container("train-0-p1")
                    prg.job_supervisor.poll_once()
        prg2 = boot(pkg, kv, rts)
        kv_before, muts = dict(kv.range_prefix("/")), mutations(rts)
        dry = prg2.reconciler.reconcile(dry_run=True)
        assert dict(kv.range_prefix("/")) == kv_before
        assert mutations(rts) == muts
        report = prg2.reconciler.reconcile()
        return acts(dry), acts(report), end_state(pkg, prg2)
    dry, repaired, end = tc.both(case)
    assert dry and repaired, f"no drift at {flow}@{point}"
    assert end["oracle"] == [] and end["fixpoint"] == []
    if flow == "run":
        assert end["state"] is None
    else:
        assert end["state"]["phase"] == "running"


def test_job_crash_without_reconcile_violates_invariants():
    def case(pkg):
        kv, rts = pkg.kv.MemoryKV(), engines(pkg)
        prg = boot(pkg, kv, rts)
        prg.job_svc.run_job(pkg.js.JobRun(image_name="jax", job_name="train",
                                          chip_count=4))
        with pkg.crash.armed("job.patch.after_quiesce_old"):
            with pytest.raises(pkg.crash.SimulatedCrash):
                prg.job_svc.patch_job_chips(
                    "train", pkg.js.JobPatchChips(chip_count=8))
        return oracle(pkg, boot(pkg, kv, rts))
    assert tc.both(case) != []


@pytest.mark.parametrize("flow,point", FANOUT_CASES,
                         ids=[f"{f}@{p}" for f, p in FANOUT_CASES])
def test_fanout_mid_batch_crash_reconcile_converges(flow, point):
    """A daemon killed inside a concurrent gang batch (4 workers): the
    half-landed create, or the half-stopped quiesce of a rescale. Which
    calls of a parallel batch landed is a race, so the packages' repairs
    are held to the same end state, not the same action list."""
    def case(pkg):
        kv, rts = pkg.kv.MemoryKV(), engines(pkg, 4)
        prg = boot(pkg, kv, rts, fanout_workers=4)
        if flow == "rescale-quiesce":
            prg.job_svc.run_job(pkg.js.JobRun(
                image_name="jax", job_name="train", chip_count=16))
            with pkg.crash.armed(point, skip=1):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.patch_job_chips(
                        "train", pkg.js.JobPatchChips(chip_count=8))
        else:
            with pkg.crash.armed(point):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.run_job(pkg.js.JobRun(
                        image_name="jax", job_name="train", chip_count=32))
        prg2 = boot(pkg, kv, rts, fanout_workers=4)
        assert prg2.reconciler.reconcile(dry_run=True)["actions"]
        assert prg2.reconciler.reconcile()["actions"]
        try:
            return end_state(pkg, prg2)
        finally:
            prg.fanout.close()
            prg2.fanout.close()
    end = tc.both(case)
    assert end["oracle"] == [] and end["fixpoint"] == []
    if flow == "run":
        assert end["state"] is None
        assert all(h["runtime"] == {} for h in end["world"]["hosts"].values())
    else:
        assert end["state"]["phase"] == "running"


def test_gang_create_txn_boundary_crash_converges():
    """Both halves of the batch contract at every commit of a gang create:
    a crash before the apply leaves the batch unwritten, after it fully
    written; the reconciler converges either way."""
    for point in ("txn.before_apply", "txn.after_apply"):
        def case(pkg):
            out = []
            for k in range(16):
                kv, rts = pkg.kv.MemoryKV(), engines(pkg)
                prg = boot(pkg, kv, rts)
                try:
                    with pkg.crash.armed(point, skip=k):
                        prg.job_svc.run_job(pkg.js.JobRun(
                            image_name="jax", job_name="train",
                            chip_count=16))
                    return out
                except pkg.crash.SimulatedCrash:
                    pass
                prg2 = boot(pkg, kv, rts)
                report = prg2.reconciler.reconcile()
                out.append((acts(report), end_state(pkg, prg2)))
            pytest.fail("the gang create never completed")
        runs = tc.both(case)
        assert runs, point
        for _, end in runs:
            assert end["oracle"] == [] and end["fixpoint"] == []


class TestJobCrashLoop:
    def test_backoff_then_failed_then_capacity_reusable(self):
        def case(pkg):
            rts = {"h0": pkg.fake.FakeRuntime(),
                   "h1": pkg.faulty.FaultyRuntime(
                       pkg.fake.FakeRuntime(),
                       pkg.faulty.FaultPlan(rules=[], seed=7))}
            prg = boot(pkg, pkg.kv.MemoryKV(), rts)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            clock = {"now": 0.0}
            sup = pkg.sup.JobSupervisor(
                prg.pod, prg.job_svc, prg.store, prg.job_versions,
                max_restarts=3, backoff_base_s=1.0, backoff_max_s=4.0,
                backoff_jitter=0.0, seed=7, clock=lambda: clock["now"])
            rts["h1"].add_rules([pkg.faulty.FaultRule(
                op="container_start", times=-1, mode="fail")])
            rts["h1"].crash_container("train-0-p1")
            for _ in range(10):
                sup.poll_once()
                if prg.store.get_job("train-0").phase == "failed":
                    break
                clock["now"] += 100.0
            delays = [e["backoff_s"] for e in sup.events_view(limit=500)
                      if e["event"] == "gang-restarting"]
            st = prg.store.get_job("train-0").to_dict()
            failed = (oracle(pkg, prg), prg.pod_scheduler.get_grant("train-0"))
            rts["h1"].clear_rules()
            out = prg.job_svc.run_job(pkg.js.JobRun(
                image_name="jax", job_name="train2", chip_count=16))
            return (delays, st, failed, out, prg.job_svc.get_job_info(
                "train-0"), tc.job_world(prg))
        delays, st, (inv, grant), out, info, _ = tc.both(case)
        assert st["phase"] == "failed" and "crash loop" in st["failure_reason"]
        assert st["restarts"] == 3 and delays == [1.0, 2.0, 4.0]
        assert inv == [] and grant is None
        assert out["phase"] == "running" and len(out["processes"]) == 2
        assert info["phase"] == "failed"

    def test_reconciler_respects_exhausted_budget(self):
        def case(pkg):
            kv, rts = pkg.kv.MemoryKV(), engines(pkg)
            prg = boot(pkg, kv, rts)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            for _ in range(3):
                rts["h1"].crash_container("train-0-p1")
                prg.job_svc.restart_gang("train", reason="test")
            rts["h1"].crash_container("train-0-p1")
            prg2 = boot(pkg, kv, rts)
            return acts(prg2.reconciler.reconcile()), end_state(pkg, prg2)
        repaired, end = tc.both(case)
        assert ("fail-job-crash-loop", "train-0") in repaired
        assert end["state"]["phase"] == "failed"
        assert end["state"]["restarts"] == 3
        assert end["oracle"] == [] and end["fixpoint"] == []

    def test_deferred_restart_respects_backoff_window(self):
        def case(pkg):
            rts = engines(pkg)
            prg = boot(pkg, pkg.kv.MemoryKV(), rts)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            clock = {"now": 0.0}
            sup = pkg.sup.JobSupervisor(
                prg.pod, prg.job_svc, prg.store, prg.job_versions,
                max_restarts=5, backoff_base_s=10.0, backoff_max_s=60.0,
                backoff_jitter=0.0, clock=lambda: clock["now"])
            seen = []
            rts["h1"].crash_container("train-0-p1")
            sup.poll_once()
            seen.append(prg.store.get_job("train-0").restarts)
            rts["h1"].crash_container("train-0-p1")
            clock["now"] = 5.0
            sup.poll_once()
            seen += [prg.store.get_job("train-0").restarts,
                     rts["h1"].container_inspect("train-0-p1").running]
            clock["now"] = 11.0
            sup.poll_once()
            seen += [prg.store.get_job("train-0").restarts,
                     rts["h1"].container_inspect("train-0-p1").running]
            return seen, [e["event"] for e in sup.events_view()]
        seen, events = tc.both(case)
        assert seen == [1, 1, False, 2, True]
        assert "gang-restart-deferred" in events


class TestHostFailureChaos:
    """Blip vs dead, separate budgets, crash mid-migration, and a drain
    against a full pool, on a 4-host row (h1-h3 behind FaultyRuntimes)."""

    @staticmethod
    def pod4(pkg):
        kv = pkg.kv.MemoryKV()
        rts = engines(pkg, 4, faulty=("h1", "h2", "h3"))
        # the breaker's cooldown rides the probe interval: 0.01 s keeps the
        # half-open probe from waiting 5 s
        return boot(pkg, kv, rts, host_probe_interval_s=0.01), kv, rts

    @staticmethod
    def supervision(pkg, prg, grace=15.0):
        clock = {"now": 0.0}
        mon = pkg.hh.HostMonitor(prg.pod, prg.pod_scheduler,
                                 down_grace_s=grace,
                                 clock=lambda: clock["now"])
        sup = pkg.sup.JobSupervisor(
            prg.pod, prg.job_svc, prg.store, prg.job_versions,
            max_restarts=3, max_migrations=3, backoff_jitter=0.0,
            clock=lambda: clock["now"], host_monitor=mon)
        return mon, sup, clock

    def test_blip_then_dead_host_migrates_without_restart_budget(self):
        def case(pkg):
            prg, kv, rts = self.pod4(pkg)
            mon, sup, clock = self.supervision(pkg, prg)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            rts["h1"].set_unreachable(True)
            mon.probe_once()
            sup.poll_once()
            clock["now"] = 5.0
            mon.probe_once()
            sup.poll_once()
            blip = (prg.store.get_job("train-0").to_dict(),
                    [e["event"] for e in sup.events_view(limit=100)])
            rts["h1"].set_unreachable(False)
            time.sleep(0.03)
            clock["now"] = 6.0
            mon.probe_once()
            rts["h1"].set_unreachable(True)
            clock["now"] = 10.0
            mon.probe_once()
            clock["now"] = 25.0
            mon.probe_once()
            mon.probe_once()
            breaker = prg.pod.hosts["h1"].runtime.view()["state"]
            sup.poll_once()
            latest = prg.job_versions.get("train")
            st = prg.store.get_job(f"train-{latest}").to_dict()
            migrated = (st, oracle(pkg, prg), tc.job_world(prg))
            mon.cordon("h1")
            rts["h1"].set_unreachable(False)
            time.sleep(0.03)
            clock["now"] = 30.0
            mon.probe_once()
            g = prg.pod_scheduler.apply_slice(n_chips=8, owner="x")
            with pytest.raises(Exception, match="cordoned"):
                prg.pod_scheduler.apply_slice(n_chips=8, owner="y")
            mon.uncordon("h1")
            g2 = prg.pod_scheduler.apply_slice(n_chips=8, owner="y")
            return blip, breaker, migrated, g.to_dict(), g2.to_dict()
        (blip_st, blip_ev), breaker, (st, inv, _), g, g2 = tc.both(case)
        assert blip_st["phase"] == "running" and blip_st["restarts"] == 0
        assert "host-blip" in blip_ev and "gang-migrating" not in blip_ev
        assert breaker == "open"
        assert (st["phase"], st["migrations"], st["restarts"]) == (
            "running", 1, 0)
        assert sorted({p[0] for p in st["placements"]}) == ["h2", "h3"]
        assert inv == []
        assert [h for h, _ in g["hosts"]] == ["h0"]
        assert [h for h, _ in g2["hosts"]] == ["h1"]

    @pytest.mark.parametrize("point", MIGRATE_POINTS)
    def test_crash_mid_migration_reconcile_converges(self, point):
        def case(pkg):
            prg, kv, rts = self.pod4(pkg)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            rts["h1"].set_unreachable(True)
            with pkg.crash.armed(point):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.migrate_gang("train", {"h1"},
                                             reason="host down")
            prg2 = boot(pkg, kv, rts, host_probe_interval_s=0.01)
            kv_before, muts = dict(kv.range_prefix("/")), mutations(rts)
            dry = prg2.reconciler.reconcile(dry_run=True)
            assert dict(kv.range_prefix("/")) == kv_before
            assert mutations(rts) == muts
            report = prg2.reconciler.reconcile()
            return acts(dry), acts(report), end_state(pkg, prg2)
        dry, repaired, end = tc.both(case)
        assert dry and repaired
        st = end["state"]
        assert st["phase"] == "running" and st["restarts"] <= 1
        assert "h1" not in {p[0] for p in st["placements"]}
        assert end["oracle"] == [] and end["fixpoint"] == []

    def test_supervisor_adoption_excludes_observed_unreachable(self):
        def case(pkg):
            prg, kv, rts = self.pod4(pkg)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            rts["h1"].set_unreachable(True)
            with pkg.crash.armed("job.migrate.after_mark"):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.migrate_gang("train", {"h1"},
                                             reason="host down")
            prg2 = boot(pkg, kv, rts, host_probe_interval_s=0.01)
            _, sup, _ = self.supervision(pkg, prg2)
            sup.poll_once()
            st = prg2.store.get_job(
                f"train-{prg2.job_versions.get('train')}").to_dict()
            return st, tc.job_world(prg2)
        st, _ = tc.both(case)
        assert st["phase"] == "running" and st["migrations"] == 1
        assert "h1" not in {p[0] for p in st["placements"]}

    def test_crash_mid_release_first_migration_converges_to_failed(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            rts = engines(pkg, 2, faulty=("h1",))
            prg = boot(pkg, kv, rts)
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            rts["h1"].set_unreachable(True)
            with pkg.crash.armed(INFEASIBLE_MIGRATE_POINT):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    prg.job_svc.migrate_gang("train", {"h1"},
                                             reason="host down")
            prg2 = boot(pkg, kv, rts)
            reports = []
            for _ in range(8):
                reports.append(acts(prg2.reconciler.reconcile()))
                if prg2.store.get_job("train-0").phase == "failed":
                    break
            return reports, end_state(pkg, prg2)
        _, end = tc.both(case)
        st = end["state"]
        assert st["phase"] == "failed"
        assert "migrations exhausted" in st["failure_reason"]
        assert end["oracle"] == [] and end["fixpoint"] == []
        assert all(h["gpus"] == [] for h in end["world"]["hosts"].values())

    def test_drain_without_spare_capacity_fails_loudly_frees_nothing(self):
        def case(pkg):
            prg = boot(pkg, pkg.kv.MemoryKV(), engines(pkg))
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=16))
            mon = pkg.hh.HostMonitor(prg.pod, prg.pod_scheduler,
                                     job_svc=prg.job_svc,
                                     job_versions=prg.job_versions,
                                     work_queue=prg.wq)
            out = mon.drain("h1")
            prg.wq.start()
            prg.wq.drain()
            prg.wq.close()
            letters = [("ChipNotEnough" in d["error"])
                       for d in prg.wq.dead_letter_view()]
            return (out, letters,
                    [e["event"] for e in mon.events_view()],
                    prg.store.get_job("train-0").to_dict(),
                    tc.job_world(prg), oracle(pkg, prg))
        out, letters, events, st, world, inv = tc.both(case)
        assert out["drainingJobs"] == ["train"] and letters == [True]
        assert "host-drain-failed" in events
        assert st["phase"] == "running" and st["desired_running"]
        assert world["cordoned"] == ["h1"] and inv == []
        assert "train-0" in world["slices"]


@pytest.mark.parametrize("point", RESIZE_POINTS)
def test_host_death_mid_shrink_converges(point):
    """A host dies under an elastic gang, the supervisor starts the shrink
    off it, and the daemon is killed at a resize point while the host is
    STILL dead: adoption finishes the shrink forward, excluding the dead
    host, with no restart or migration budget burned. JAX's matrix runs
    this with the capacity market on; without it (the port has none yet)
    no grow-back record is journaled."""
    def case(pkg):
        kv = pkg.kv.MemoryKV()
        rts = engines(pkg, 4, faulty=("h1", "h2", "h3"))
        prg = boot(pkg, kv, rts)
        clock = {"now": 0.0}
        mon = pkg.hh.HostMonitor(prg.pod, prg.pod_scheduler, down_grace_s=10.0,
                                 clock=lambda: clock["now"])
        sup = pkg.sup.JobSupervisor(prg.pod, prg.job_svc, prg.store,
                                    prg.job_versions, backoff_jitter=0.0,
                                    clock=lambda: clock["now"],
                                    host_monitor=mon)
        prg.job_svc.run_job(pkg.js.JobRun(
            image_name="jax", job_name="train", chip_count=32, elastic=True,
            min_members=1))
        rts["h3"].set_unreachable(True)
        mon.probe_once()
        clock["now"] = 30.0
        mon.probe_once()
        with pkg.crash.armed(point):
            with pytest.raises(pkg.crash.SimulatedCrash):
                sup.poll_once()
        mid = prg.store.get_job(
            f"train-{prg.job_versions.get('train')}").phase
        prg2 = boot(pkg, kv, rts)
        report = prg2.reconciler.reconcile()
        end = end_state(pkg, prg2)
        end["oracle"] = [p for p in end["oracle"] if "unreachable" not in p]
        return mid, acts(report), end
    mid, _, end = tc.both(case)
    st = end["state"]
    assert st["phase"] == "running" and len(st["placements"]) == 3
    assert all(p[0] != "h3" for p in st["placements"])
    # as in JAX's migrate matrix, a crash that leaves the resized version
    # created but never started is finished through restart-gang: at most
    # one restart, and never a migration
    assert st["restarts"] <= 1 and st["migrations"] == 0
    assert end["oracle"] == [] and end["fixpoint"] == []
    if point in ("job.resize.after_mark", "job.resize.after_quiesce"):
        assert mid == "scaling_down"  # the crash window under test


# -- the capacity market (JAX's TestAdmissionChaos and TestResizeChaos) ------


def market_boot(pkg, kv, rts):
    """A pod of ``len(rts)`` hosts with the capacity market on and its loop
    off (passes run inline, under armed crash points)."""
    return boot(pkg, kv, rts, admission_enabled=True, admission_interval_s=0)


def market_end(pkg, prg, rts, families) -> dict:
    """The books after a repair: each family's stored state (the resize's
    clock left out), the journal, the pod, the oracles, the fixpoint."""
    states = {}
    for base in families:
        v = prg.job_versions.get(base)
        st = prg.store.get_job(f"{base}-{v}").to_dict() if v is not None \
            else None
        states[base] = tc.unclocked(st)
    return {"states": states, "world": tc.job_world(prg),
            "records": [(r.base, r.kind, r.klass, r.skips)
                        for r in prg.admission._ordered()],
            "placed_versions": sorted({
                n.split("-p")[0] for rt in rts.values()
                for n in rt.container_list()}),
            "oracle": oracle(pkg, prg),
            "fixpoint": prg.reconciler.reconcile()["actions"]}


def _running(prg, st) -> list:
    return [c for h, c, *_ in st["placements"]
            if prg.pod.hosts[h].runtime.container_inspect(c).running]


@pytest.mark.parametrize("point,skip", ADMISSION_CASES,
                         ids=[f"{p}@skip{s}" for p, s in ADMISSION_CASES])
def test_preemption_crash_converges(point, skip):
    """A daemon killed mid-preemption: a fresh Program reconciles to one
    live version with zero leaks, the victim FULLY preempted (members
    stopped, nothing held, a re-admission record) or FULLY running, and
    the journal replays exactly once."""
    def case(pkg):
        kv, rts = pkg.kv.MemoryKV(), engines(pkg)
        prg = market_boot(pkg, kv, rts)
        run = pkg.js.JobRun
        prg.job_svc.run_job(run(image_name="jax", job_name="low",
                                chip_count=16, priority_class="preemptible"))
        with pkg.crash.armed(point, skip=skip):
            with pytest.raises(pkg.crash.SimulatedCrash):
                prg.job_svc.run_job(run(image_name="jax", job_name="high",
                                        chip_count=16,
                                        priority_class="production"))
                prg.admission.admit_once()
        prg2 = market_boot(pkg, kv, rts)
        report = prg2.reconciler.reconcile()
        repaired = market_end(pkg, prg2, rts, ("low", "high"))
        low = repaired["states"]["low"]
        victim = (low["phase"], len(_running(prg2, low)),
                  len(low["placements"]))
        for _ in range(4):
            if not prg2.admission.admit_once():
                break
        return acts(report), repaired, victim, market_end(
            pkg, prg2, rts, ("low", "high"))

    _, repaired, victim, end = tc.both(case)
    assert repaired["oracle"] == [], f"{point}@skip{skip}"
    recs = {r[0]: r[1] for r in repaired["records"]}
    if victim[0] == "preempted":
        assert victim[1] == 0 and recs["low"] == "preempted"
    else:
        assert victim[0] == "running" and victim[1] == victim[2]
    high = end["states"]["high"]
    assert high["phase"] == "running"
    assert all(r[0] != "high" for r in end["records"])
    assert len([v for v in end["placed_versions"]
                if v.startswith("high-")]) == 1
    assert end["oracle"] == [] and end["fixpoint"] == []


def test_readmit_crash_settles_record_without_double_place():
    """The job PLACED but its record survived the crash: the next
    daemon's reconcile settles the record, never re-places it."""
    def case(pkg):
        kv, rts = pkg.kv.MemoryKV(), engines(pkg)
        prg = market_boot(pkg, kv, rts)
        run = pkg.js.JobRun
        prg.job_svc.run_job(run(image_name="jax", job_name="low",
                                chip_count=16, priority_class="preemptible"))
        prg.job_svc.run_job(run(image_name="jax", job_name="high",
                                chip_count=16, priority_class="production"))
        prg.job_svc.delete_job("low", pkg.js.JobDelete(
            force=True, del_state_and_version_record=True))
        with pkg.crash.armed("admission.readmit"):
            with pytest.raises(pkg.crash.SimulatedCrash):
                prg.admission.admit_once()
        window = [r.base for r in prg.admission.records()]
        prg2 = market_boot(pkg, kv, rts)
        report = prg2.reconciler.reconcile()
        return (window, acts(report), prg2.admission.admit_once(),
                prg2.job_versions.get("high"),
                market_end(pkg, prg2, rts, ("high",)))

    window, report, again, version, end = tc.both(case)
    assert "high" in window
    assert ("settle-admission-record", "high") in report
    assert again == [] and version == 1 and end["records"] == []
    assert end["states"]["high"]["phase"] == "running"
    assert end["oracle"] == [] and end["fixpoint"] == []


@pytest.mark.parametrize("point,skip", MARKET_RESIZE_CASES,
                         ids=[f"{p}@skip{s}" for p, s in MARKET_RESIZE_CASES])
def test_partial_preemption_crash_converges(point, skip):
    """A partial preemption (an elastic preemptible gang over 4 hosts
    donates one to a production ask) killed at each resize label: the
    donor runs at the old or the new size, never half-resized, the ask
    places exactly once, the grow-back record survives (or is
    re-journaled) and the gang grows back once pressure lifts."""
    def case(pkg):
        kv, rts = pkg.kv.MemoryKV(), engines(pkg, 4)
        prg = market_boot(pkg, kv, rts)
        run = pkg.js.JobRun
        prg.job_svc.run_job(run(image_name="jax", job_name="don",
                                chip_count=32, priority_class="preemptible",
                                elastic=True, min_members=1))
        prg.job_svc.run_job(run(image_name="jax", job_name="prod",
                                chip_count=8, priority_class="production"))
        with pkg.crash.armed(point, skip=skip):
            with pytest.raises(pkg.crash.SimulatedCrash):
                prg.admission.admit_once()
        prg2 = market_boot(pkg, kv, rts)
        report = prg2.reconciler.reconcile()
        repaired = market_end(pkg, prg2, rts, ("don", "prod"))
        don = repaired["states"]["don"]
        donor = (don["phase"], len(don["placements"]),
                 len(_running(prg2, don)))
        for _ in range(4):
            if not prg2.admission.admit_once():
                break
        pressed = market_end(pkg, prg2, rts, ("don", "prod"))
        prg2.job_svc.delete_job("prod", pkg.js.JobDelete(
            force=True, del_state_and_version_record=True))
        for _ in range(4):
            if not prg2.admission.admit_once():
                break
        return (acts(report), repaired["oracle"], donor, pressed,
                market_end(pkg, prg2, rts, ("don",)))

    _, problems, donor, pressed, lifted = tc.both(case)
    assert problems == [], f"{point}@skip{skip}: {problems}"
    assert donor[0] == "running" and donor[1] in (3, 4)
    assert donor[2] == donor[1]
    assert pressed["states"]["prod"]["phase"] == "running"
    assert len(pressed["states"]["don"]["placements"]) == 3
    assert {r[0]: r[1] for r in pressed["records"]}.get("don") == "growback"
    assert len([v for v in pressed["placed_versions"]
                if v.startswith("prod-")]) == 1
    don = lifted["states"]["don"]
    assert (don["phase"], len(don["placements"])) == ("running", 4)
    assert lifted["records"] == []
    assert lifted["oracle"] == [] and lifted["fixpoint"] == []
