"""The port's Workflow resource (``schemas/workflow.py``,
``service/workflow.py``, the reconciler's workflow adoption and
``check_workflow_invariants``) against the JAX package's on the CPU: every
case of ``tests/test_workflow.py`` runs one script through each package's
``Program`` (the capacity market on, its loop off, an injected workflow
clock so retries and cron run without sleeps), and what each left behind
must be JAX's: the workflow and job records, the pod (containers, GPU and
port owners, slices, versions), the workflow event ring, the replies and
the oracles. ``TestWorkflowChaos`` kills each package at every
``workflow.*`` crash point (JAX's ``WORKFLOW_CASES``) and boots a fresh
``Program`` over the wreck; the HTTP surface is driven through each
package's own server. JAX's own assertions then hold on the port's side."""

import json
import urllib.request

import pytest

import torch_control as tc


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def boot(pkg, kv=None, runtime=None, clock=None, **cfg):
    """A Program with inline-driven loops over one 8-GPU host: the work
    queue is NOT started (a case replays its journal by hand, under armed
    crash points) and the engine is ticked explicitly."""
    prg = tc.pod_program(
        pkg, 1, kv=kv, rts={"h0": runtime or pkg.fake.FakeRuntime()},
        admission_enabled=True, admission_interval_s=0, **cfg)
    clock = clock if clock is not None else {"now": 1000.0}
    prg.workflow._clock = lambda: clock["now"]
    return prg


def step(pkg, name, image="jax", chips=1, **kw):
    return pkg.wfs.WorkflowStep(name=name, image=image, chip_count=chips,
                                **kw)


def two_steps(pkg, chips: int = 1):
    return [step(pkg, "train", "jax:train", chips),
            step(pkg, "evaluate", "jax:eval", chips, deps=["train"])]


def create_wf(pkg, prg, name="pipe", steps=None, **kw):
    return prg.workflow.create_workflow(pkg.wfs.WorkflowCreate(
        workflow_name=name,
        steps=steps if steps is not None else two_steps(pkg), **kw))


def oracle(pkg, prg) -> list[str]:
    return (pkg.inv.check_workflow_invariants(
        prg.store, prg.workflow_versions, prg.job_versions)
        + tc.market_oracle(pkg, prg))


def drive(prg, name, rounds: int = 24) -> dict:
    """Run a workflow's DAG to a terminal phase: replay journaled step
    records inline, drain the admission queue, complete running gangs
    (fake members never exit on their own), tick the engine."""
    info = prg.workflow.workflow_info(name)
    for _ in range(rounds):
        if info["phase"] in ("succeeded", "failed"):
            return info
        prg.wq.replay_journal(include_local=True)
        for _ in range(4):
            if not prg.admission.admit_once():
                break
        info = prg.workflow.workflow_info(name)
        for s in info["steps"]:
            if s["state"] == "running" and s.get("jobPhase") == "running":
                prg.job_svc.mark_gang_completed(s["job"])
        prg.workflow.tick()
        prg.wq.replay_journal(include_local=True)
        info = prg.workflow.workflow_info(name)
    return info


def pump(prg, n: int = 2) -> None:
    """Replay + tick without completing anything (steps reach running)."""
    for _ in range(n):
        prg.wq.replay_journal(include_local=True)
        prg.workflow.tick()


def created_names(rt) -> list[str]:
    return [c[1] for c in rt.calls if c[0] == "create"]


def books(pkg, prg, **extra) -> dict:
    """The workflow records, the market's books and ``extra``, without
    clock stamps and random ids."""
    wfs = {}
    for base, v in sorted(prg.workflow_versions.snapshot().items()):
        try:
            wfs[base] = prg.store.get_workflow(f"{base}-{v}").to_dict()
        except Exception as e:  # noqa: BLE001 — a half-made version
            wfs[base] = type(e).__name__
    return tc.scrub(tc.unclocked({
        **tc.market_books(pkg, prg), "workflows": wfs,
        "workflow_events": prg.workflow.events_view(1000),
        "workflow_oracle": oracle(pkg, prg), **extra}))


def refusal(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return type(e).__name__
    raise AssertionError(f"{fn.__name__} did not raise")


class TestNaming:
    def test_step_base_round_trips(self):
        for pkg in tc.PKGS:
            wf = pkg.wf
            assert wf.step_base("pipe", 2, 1) == "pipe.s2_1"
            assert wf.split_step_base("pipe.s2_1") == ("pipe", 2, 1)
            assert wf.split_step_base("a.b.s10_3") == ("a.b", 10, 3)
            for bad in ("pipe", "pipe.s2", "pipe.sx_1", ".s1_0"):
                assert wf.split_step_base(bad) is None
        t, j = tc.PORT.wfs, tc.JAX.wfs
        assert (t.WORKFLOW_OWNER_ENV, t.WORKFLOW_RUN_ENV, t.WORKFLOW_PHASES,
                t.STEP_STATES, t.CRON_CATCHUP_POLICIES) == (
            j.WORKFLOW_OWNER_ENV, j.WORKFLOW_RUN_ENV, j.WORKFLOW_PHASES,
            j.STEP_STATES, j.CRON_CATCHUP_POLICIES)
        body = {"workflowName": "w", "priorityClass": "batch",
                "binds": ["/a:/a"], "cronIntervalS": 60,
                "cronCatchup": "fire_once",
                "steps": [{"name": "a", "image": "i", "chipCount": 2,
                           "env": ["X=1"], "cmd": ["run"], "maxRetries": 1},
                          {"name": "p", "kind": "promote", "service": "web",
                           "image": "m:v2", "deps": ["a"]}]}
        assert vars(t.WorkflowCreate.from_dict(body))["workflow_name"] == "w"
        assert [vars(s) for s in t.WorkflowCreate.from_dict(body).steps] == [
            vars(s) for s in j.WorkflowCreate.from_dict(body).steps]


class TestValidation:
    def test_create_rejects_bad_dags(self):
        def case(pkg):
            prg = boot(pkg)
            s = lambda name, **kw: pkg.wfs.WorkflowStep(name=name, **kw)
            bad = [
                [],  # empty
                [s("a", image="i", chip_count=1),
                 s("a", image="i", chip_count=1)],  # dup names
                [s("a", image="i", chip_count=1, deps=["ghost"])],
                [s("a", image="i", chip_count=1, deps=["b"]),
                 s("b", image="i", chip_count=1, deps=["a"])],  # cycle
                [s("a", image="", chip_count=1)],  # no image
                [s("a", image="i")],  # no GPUs/accelerator
                [s("a", image="i", kind="promote")],  # no service
                [s("a", image="i", kind="teleport", chip_count=1)],
            ]
            out = [refusal(create_wf, pkg, prg, steps=steps)
                   for steps in bad]
            out.append(refusal(create_wf, pkg, prg, priority_class="gold"))
            out.append(refusal(create_wf, pkg, prg, cron_catchup="rewind"))
            return books(pkg, prg, refusals=out)

        out = tc.both(case)
        assert out["refusals"] == ["BadRequest"] * 10
        assert out["workflows"] == {}

    def test_double_create_and_missing_lookup_are_typed(self):
        def case(pkg):
            prg = boot(pkg)
            create_wf(pkg, prg)
            return books(pkg, prg, refusals=[
                refusal(create_wf, pkg, prg),
                refusal(prg.workflow.workflow_info, "ghost"),
                refusal(prg.workflow.delete_workflow, "ghost")])

        assert tc.both(case)["refusals"] == [
            "WorkflowExisted", "WorkflowNotExist", "WorkflowNotExist"]


class TestWorkflowFamily:
    def test_linear_dag_runs_to_success(self):
        def case(pkg):
            prg = boot(pkg)
            out = create_wf(pkg, prg, binds=["/mnt/artifacts:/artifacts"])
            prg.wq.replay_journal(include_local=True)
            jb = pkg.wf.step_base("pipe", 0, 0)
            jst = prg.store.get_job(f"{jb}-{prg.job_versions.get(jb)}")
            mid = prg.workflow.workflow_info("pipe")
            info = drive(prg, "pipe")
            return books(pkg, prg, created=out, train=(jst.binds, jst.env),
                         mid=mid, info=info,
                         listed=prg.workflow.list_workflows())

        out = tc.both(case)
        assert out["created"]["phase"] == "running"
        assert [s["state"] for s in out["created"]["steps"]] == [
            "launching", "pending"]
        binds, env = out["train"]
        # the train gang is a real job at the workflow's class, with the
        # shared artifact bind and the durable owner/run markers
        assert binds == ["/mnt/artifacts:/artifacts"]
        assert f"{tc.PORT.wfs.WORKFLOW_OWNER_ENV}=pipe" in env
        assert f"{tc.PORT.wfs.WORKFLOW_RUN_ENV}=0" in env
        assert out["mid"]["steps"][0]["state"] == "running"
        assert out["mid"]["steps"][0]["jobPhase"] == "running"
        assert out["mid"]["steps"][1]["state"] == "pending"
        info = out["info"]
        assert info["phase"] == "succeeded"
        assert all(s["state"] == "succeeded" for s in info["steps"])
        assert info["lastTransition"]["to"] == "succeeded"
        assert out["world"]["versions"] == {}  # finished gangs are GC'd
        assert out["oracle"] == [] and out["workflow_oracle"] == []
        kinds = {e["event"] for e in out["workflow_events"]}
        assert {"workflow-created", "workflow-step-succeeded"} <= kinds
        assert [s["name"] for s in out["listed"]] == ["pipe-0"]
        assert out["listed"][0]["steps"] == {"train": "succeeded",
                                             "evaluate": "succeeded"}

    def test_failed_step_retries_with_fresh_idempotency_key(self):
        def case(pkg):
            prg = boot(pkg, workflow_backoff_base_s=0.0,
                       workflow_backoff_max_s=0.0)
            create_wf(pkg, prg, steps=[step(pkg, "solo")])
            pump(prg, 1)
            prg.job_svc.fail_job(pkg.wf.step_base("pipe", 0, 0),
                                 "injected boom")
            prg.workflow.tick()  # verdict: failed → retry (attempt 1)
            retry = prg.workflow.workflow_info("pipe")
            info = drive(prg, "pipe")
            return books(pkg, prg, retry=retry, info=info,
                         retries=prg.metrics.counter_value(
                             "workflow_step_retries_total",
                             {"workflow": "pipe"}))

        out = tc.both(case)
        assert out["retry"]["phase"] == "running"
        assert out["retry"]["steps"][0]["attempts"] == 1
        assert "injected boom" in out["retry"]["steps"][0]["error"]
        assert out["info"]["phase"] == "succeeded"
        assert out["info"]["steps"][0]["attempts"] == 1
        assert out["retries"] == 1.0
        assert out["workflow_oracle"] == []

    def test_past_budget_settles_terminal_failed_and_frees_everything(self):
        def case(pkg):
            prg = boot(pkg, workflow_backoff_base_s=0.0,
                       workflow_backoff_max_s=0.0)
            create_wf(pkg, prg, steps=[
                step(pkg, "doomed", max_retries=0),
                step(pkg, "never", deps=["doomed"])])
            pump(prg, 1)
            prg.job_svc.fail_job(pkg.wf.step_base("pipe", 0, 0), "oom")
            prg.workflow.tick()
            info = prg.workflow.workflow_info("pipe")
            completed = prg.metrics.counter_value(
                "workflow_runs_completed_total",
                {"workflow": "pipe", "result": "failed"})
            prg.workflow.tick()  # terminal is terminal
            return books(pkg, prg, info=info, completed=completed,
                         after=prg.workflow.workflow_info("pipe")["phase"])

        out = tc.both(case)
        info = out["info"]
        assert info["phase"] == "failed"
        assert info["steps"][0]["state"] == "failed"
        assert info["steps"][1]["state"] == "pending"  # never launched
        assert "doomed" in info["lastTransition"]["reason"]
        assert out["world"]["versions"] == {}  # never pins GPUs
        assert out["completed"] == 1.0
        assert out["workflow_oracle"] == [] and out["after"] == "failed"

    def test_promote_rolls_service_through_update_machinery(self):
        def case(pkg):
            prg = boot(pkg)
            prg.serving.create_service(pkg.ss.ServiceCreate(
                service_name="web", image_name="serve", chips_per_replica=1,
                replicas=1, max_replicas=2))
            create_wf(pkg, prg, steps=[
                step(pkg, "train", "jax:train"),
                pkg.wfs.WorkflowStep(name="promote", kind="promote",
                                     deps=["train"], service="web",
                                     image="model:v2")])
            info = drive(prg, "pipe")
            return books(pkg, prg, info=info,
                         image=prg.serving.service_info("web")["image"])

        out = tc.both(case)
        assert out["info"]["phase"] == "succeeded"
        assert out["image"] == "model:v2"
        # the replica rolled exactly once (version 0 → 1)
        assert out["world"]["versions"] == {"web.r0": 1}
        assert out["workflow_oracle"] == []

    def test_delete_tears_down_mid_flight(self):
        def case(pkg):
            prg = boot(pkg)
            create_wf(pkg, prg)
            pump(prg, 1)  # train gang up
            gangs = sorted(prg.job_versions.snapshot())
            prg.workflow.delete_workflow("pipe")
            return books(pkg, prg, gangs=gangs, history=prg.store.history(
                pkg.keys.Resource.WORKFLOWS, "pipe"),
                info=refusal(prg.workflow.workflow_info, "pipe"))

        out = tc.both(case)
        assert out["gangs"] == ["pipe.s0_0"]
        assert out["workflows"] == {} and out["world"]["versions"] == {}
        assert out["history"] == [] and out["workflow_oracle"] == []
        assert out["info"] == "WorkflowNotExist"


def boot_cron(pkg, catchup="skip", **cfg):
    clock = {"now": 1000.0}
    prg = boot(pkg, clock=clock, **cfg)
    create_wf(pkg, prg, "cronwf", steps=[step(pkg, "pulse")],
              cron_interval_s=100.0, cron_catchup=catchup)
    return prg, clock


def cron_view(prg):
    info = prg.workflow.workflow_info("cronwf")
    return info["run"], info["phase"], info["cron"]


class TestCronSemantics:
    """Injected clock only — no sleeps. Interval 100s throughout."""

    def test_overlapping_run_suppressed_and_schedule_realigned(self):
        def case(pkg):
            prg, clock = boot_cron(pkg)
            pump(prg, 1)  # run 0 in flight
            clock["now"] += 250.0  # two boundaries elapse mid-run
            prg.workflow.tick()
            views = [cron_view(prg)]
            info = drive(prg, "cronwf")
            views.append((info["run"], info["phase"]))
            clock["now"] = 1299.0
            prg.workflow.tick()
            views.append(cron_view(prg)[0])
            clock["now"] = 1301.0  # next boundary: an on-time fire
            prg.workflow.tick()
            views.append(cron_view(prg))
            return books(pkg, prg, views=views)

        v = tc.both(case)["views"]
        assert v[0][:2] == (0, "running")
        assert v[0][2]["suppressedTicks"] == 2
        assert v[0][2]["lastFireTs"] == 1200.0  # realigned
        assert v[1] == (0, "succeeded")  # the backlog never bursts
        assert v[2] == 0
        assert v[3][:2] == (1, "running") and v[3][2]["firedRuns"] == 1

    def test_missed_ticks_skip_policy_fires_nothing(self):
        def case(pkg):
            prg, clock = boot_cron(pkg, catchup="skip")
            phase = drive(prg, "cronwf")["phase"]
            clock["now"] += 350.0  # daemon "down" across 3 boundaries
            prg.workflow.tick()
            view = cron_view(prg)
            clock["now"] += 100.0
            prg.workflow.tick()
            return books(pkg, prg, phase=phase, view=view,
                         run=cron_view(prg)[0])

        out = tc.both(case)
        assert out["phase"] == "succeeded"
        run, phase, cron = out["view"]
        assert (run, phase) == (0, "succeeded")
        assert cron["skippedTicks"] == 3
        assert cron["lastFireTs"] == 1300.0  # next future boundary
        assert out["run"] == 1

    def test_missed_ticks_fire_once_catches_up_across_restart(self):
        def case(pkg):
            kv, rt = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
            clock = {"now": 1000.0}
            prg = boot(pkg, kv, rt, clock)
            create_wf(pkg, prg, "cronwf", steps=[step(pkg, "pulse")],
                      cron_interval_s=100.0, cron_catchup="fire_once")
            first = drive(prg, "cronwf")["phase"]
            # the daemon dies for 3.5 intervals; a fresh one catches up
            # with exactly ONE run covering every missed boundary
            clock["now"] += 350.0
            prg2 = boot(pkg, kv, rt, clock)
            prg2.workflow.tick()
            view = cron_view(prg2)
            prg2.workflow.tick()  # no double fire on the same boundaries
            again = cron_view(prg2)[0]
            info = drive(prg2, "cronwf")
            return books(pkg, prg2, first=first, view=view, again=again,
                         end=(info["phase"], info["run"]))

        out = tc.both(case)
        assert out["first"] == "succeeded"
        run, phase, cron = out["view"]
        assert (run, phase) == (1, "running")
        assert cron["firedRuns"] == 1
        assert cron["skippedTicks"] == 2  # folded into the one run
        assert out["again"] == 1
        assert out["end"] == ("succeeded", 1)
        assert out["workflow_oracle"] == []

    def test_disable_mid_flight_finishes_run_fires_nothing(self):
        def case(pkg):
            prg, clock = boot_cron(pkg)
            pump(prg, 1)  # run 0 in flight
            prg.workflow.patch_workflow(
                "cronwf", pkg.wfs.WorkflowPatch(cron_enabled=False))
            phase = drive(prg, "cronwf")["phase"]  # the run finishes
            clock["now"] += 1000.0
            prg.workflow.tick()
            disabled = cron_view(prg)
            prg.workflow.patch_workflow(
                "cronwf", pkg.wfs.WorkflowPatch(cron_enabled=True))
            prg.workflow.tick()  # skip: realigns, fires nothing
            enabled = cron_view(prg)
            clock["now"] += 100.0
            prg.workflow.tick()
            return books(pkg, prg, phase=phase, disabled=disabled,
                         enabled=enabled, run=cron_view(prg)[0])

        out = tc.both(case)
        assert out["phase"] == "succeeded"
        assert out["disabled"][0] == 0
        assert out["disabled"][2]["firedRuns"] == 0
        assert out["enabled"][0] == 0
        assert out["enabled"][2]["skippedTicks"] >= 10
        assert out["run"] == 1

    def test_patch_validates_and_fences_versions(self):
        def case(pkg):
            prg, _ = boot_cron(pkg)
            patch = pkg.wfs.WorkflowPatch
            return books(pkg, prg, refusals=[
                refusal(prg.workflow.patch_workflow, "cronwf",
                        patch(cron_catchup="rewind")),
                refusal(prg.workflow.patch_workflow, "cronwf",
                        patch(cron_interval_s=-5.0)),
                refusal(prg.workflow.patch_workflow, "cronwf-7",
                        patch(cron_enabled=False))])

        assert tc.both(case)["refusals"] == [
            "BadRequest", "BadRequest", "VersionNotMatch"]


#: every workflow.* crash point and the flow that traverses it
WORKFLOW_CASES = (
    ("workflow.create.after_record", "create"),
    ("workflow.enqueue_step", "create"),
    ("workflow.after_launch", "launch"),
    ("workflow.after_complete_marker", "complete"),
    ("workflow.after_promote", "promote"),
    ("workflow.cron_fire", "cron"),
    ("workflow.delete.after_mark", "delete"),
)


def drive_to_crash(pkg, prg, flow, clock):
    if flow == "create":
        create_wf(pkg, prg)
    elif flow == "launch":
        create_wf(pkg, prg)
        prg.wq.replay_journal(include_local=True)
    elif flow == "complete":
        create_wf(pkg, prg)
        prg.wq.replay_journal(include_local=True)
        prg.job_svc.mark_gang_completed(pkg.wf.step_base("pipe", 0, 0))
        prg.workflow.tick()  # journals the completion record
        prg.wq.replay_journal(include_local=True)
    elif flow == "promote":
        prg.serving.create_service(pkg.ss.ServiceCreate(
            service_name="web", image_name="serve", chips_per_replica=1,
            replicas=1, max_replicas=2))
        create_wf(pkg, prg, steps=[pkg.wfs.WorkflowStep(
            name="promote", kind="promote", service="web",
            image="model:v2")])
        prg.wq.replay_journal(include_local=True)
    elif flow == "cron":
        create_wf(pkg, prg, steps=[step(pkg, "pulse")],
                  cron_interval_s=100.0, cron_catchup="fire_once")
        assert drive(prg, "pipe")["phase"] == "succeeded"
        clock["now"] += 250.0
        prg.workflow.tick()
    elif flow == "delete":
        create_wf(pkg, prg)
        prg.wq.replay_journal(include_local=True)
        prg.workflow.delete_workflow("pipe")
    else:  # pragma: no cover — keep the matrix exhaustive
        raise AssertionError(f"unmapped flow {flow}")


def workflow_chaos(pkg, point, flow):
    kv, rt = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
    clock = {"now": 1000.0}
    prg = boot(pkg, kv, rt, clock)
    with pkg.crash.armed(point):
        with pytest.raises(pkg.crash.SimulatedCrash):
            drive_to_crash(pkg, prg, flow, clock)
    # the daemon is dead; a fresh control plane boots over the same state
    prg2 = boot(pkg, kv, rt, clock)
    repair = prg2.reconciler.reconcile()
    info = None if flow == "delete" else drive(prg2, "pipe")
    stats = prg2.wq.stats()["journal"]
    return books(pkg, prg2, repair=tc.shape(repair), info=info,
                 image=(prg2.serving.service_info("web")["image"]
                        if flow == "promote" else None),
                 creates=created_names(rt),
                 journal=(stats["pending"], stats["inflight"]),
                 fixpoint=prg2.reconciler.reconcile()["actions"])


class TestWorkflowChaos:
    """Kill the daemon at every workflow.* crash point; a fresh Program
    over the same store and engine reconciles the DAG forward to
    completion (or finishes the delete), every step effect applied exactly
    once, zero orphan gangs, and a fixpoint second sweep."""

    def test_case_matrix_covers_every_workflow_crash_point(self):
        assert {p for p, _ in WORKFLOW_CASES} == set(
            tc.PORT.crash.WORKFLOW_CRASH_POINTS)

    @pytest.mark.parametrize("point,flow", WORKFLOW_CASES)
    def test_crash_converges_dag_to_completion(self, point, flow):
        out = tc.both(lambda pkg: workflow_chaos(pkg, point, flow))
        if flow == "delete":
            assert out["workflows"] == {} and out["world"]["versions"] == {}
        else:
            assert out["info"]["phase"] == "succeeded", point
            if flow == "promote":
                # the roll happened exactly once (v0 → v1)
                assert out["image"] == "model:v2"
                assert out["world"]["versions"] == {"web.r0": 1}
            else:
                assert out["world"]["versions"] == {}
            if flow == "cron":
                assert out["info"]["run"] == 1
                assert out["info"]["cron"]["firedRuns"] == 1
        creates = out["creates"]
        assert len(creates) == len(set(creates)), f"{point}: {creates}"
        assert out["workflow_oracle"] == [] and out["oracle"] == [], point
        assert out["journal"] == (0, 0) and out["fixpoint"] == [], point


def boot_ha(pkg, kv, runtime, holder, clock):
    """An HA fleet member over the shared store and engine: election on,
    writers follow the lease, the injected clock drives TTL expiry; the
    engine loop interval is 0 so writers stay inline-driven."""
    prg = boot(pkg, kv, runtime, host_probe_interval_s=0,
               job_supervise_interval=0, reconcile_interval=0,
               workflow_interval_s=0, leader_election=True,
               leader_ttl_s=30.0, leader_id=holder)
    prg.leader_elector._clock = lambda: clock["now"]
    return prg


class TestWorkflowFailover:
    def test_leader_failover_mid_workflow_converges(self):
        """A previous daemon journaled a step-launch record it never ran;
        leader A acquires (replaying it — the gang launches), then dies;
        standby B waits out the lease, acquires with a fresh epoch and
        drives the DAG to completion — every step effect exactly once."""
        def case(pkg):
            kv, rt = pkg.kv.MemoryKV(), pkg.fake.FakeRuntime()
            prg0 = boot(pkg, kv, rt)
            create_wf(pkg, prg0)  # step 0 durably "launching"
            clock = {"now": 1000.0}
            a = boot_ha(pkg, kv, rt, "daemon-a", clock)
            with pkg.crash.armed("leader.after_start_writers"):
                with pytest.raises(pkg.crash.SimulatedCrash):
                    a.leader_elector.step()
            a._stop_writers()  # the dead daemon's threads die with it
            launched = a.job_versions.get(pkg.wf.step_base("pipe", 0, 0))
            b = boot_ha(pkg, kv, rt, "daemon-b", clock)
            b.leader_elector.step()
            stole = b.leader_elector.is_leader
            deadline = json.loads(kv.get(pkg.keys.LEADER_LEASE_KEY))[
                "deadline"]
            clock["now"] = deadline + 0.001
            b.leader_elector.step()
            roles = (b.leader_elector.is_leader, b.leader_elector.epoch)
            info = drive(b, "pipe")
            b.wq.drain()  # b's own queue thread runs beside the replays
            out = books(pkg, b, launched=launched, stole=stole, roles=roles,
                        info=info, creates=created_names(rt),
                        fixpoint=b.reconciler.reconcile()["actions"],
                        fenced=tc.outcome(a.kv.put, "/apis/v1/fence-probe",
                                          "stale"))
            for prg in (a, b):
                prg.leader_elector.close(release=False)
            return out

        out = tc.both(case)
        assert out["launched"] is not None  # the train gang exists once
        assert out["stole"] is False and out["roles"] == (True, 2)
        assert out["info"]["phase"] == "succeeded"
        assert out["world"]["versions"] == {}
        assert len(out["creates"]) == len(set(out["creates"]))
        assert out["workflow_oracle"] == [] and out["fixpoint"] == []
        # split-brain proof: the deposed leader's writes are fenced out
        assert out["fenced"] == ("raise", "GuardFailed")


class TestPoisonQuarantine:
    """A corrupt stored record quarantines its OWN family — loudly — while
    every other family (and the whole sweep) converges."""

    def test_corrupt_container_record_skips_family_not_sweep(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            prg = boot(pkg, kv)
            create_wf(pkg, prg, "pipe")
            prg.container_svc.run_container(pkg.c.ContainerRun(
                image_name="jax", container_name="bad", chip_count=1))
            kv.put(pkg.keys.version_key(pkg.keys.Resource.CONTAINERS,
                                        "bad", 0), "{corrupt json")
            rep = prg.reconciler.reconcile()
            q = [(a["target"], a.get("resource")) for a in rep["actions"]
                 if a["action"] == "quarantine-poison-record"]
            quarantined = prg.metrics.counter_value(
                "reconcile_quarantined_total", {"resource": "containers"})
            info = drive(prg, "pipe")
            acts = [a["action"] for a in prg.reconciler.reconcile()[
                "actions"]]
            # the container oracle would read the poison: JAX's case
            # holds the workflow and job oracles
            return {"q": q, "quarantined": quarantined,
                    "phase": info["phase"], "acts": acts,
                    "workflow_oracle": pkg.inv.check_workflow_invariants(
                        prg.store, prg.workflow_versions, prg.job_versions),
                    "jobs_oracle": tc.job_invariants(pkg, prg),
                    "world": tc.job_world(prg)}

        out = tc.both(case)
        assert out["q"] == [("bad-0", "containers")]
        assert out["quarantined"] == 1.0
        # the sweep kept going past the poison: the DAG still converges
        assert out["phase"] == "succeeded"
        assert out["workflow_oracle"] == [] and out["jobs_oracle"] == []
        # steady state: the poison is skipped every sweep, never wedging
        assert out["acts"] == ["quarantine-poison-record"]

    def test_corrupt_workflow_record_quarantined_others_advance(self):
        def case(pkg):
            kv = pkg.kv.MemoryKV()
            prg = boot(pkg, kv)
            create_wf(pkg, prg, "good")
            create_wf(pkg, prg, "bad", steps=[step(pkg, "solo")])
            settled = drive(prg, "bad")["phase"]
            kv.put(pkg.keys.version_key(pkg.keys.Resource.WORKFLOWS,
                                        "bad", 0), "not json{")
            acts = prg.workflow.reconcile_workflows()
            q = [a["target"] for a in acts
                 if a["action"] == "quarantine-poison-record"]
            quarantined = prg.metrics.counter_value(
                "reconcile_quarantined_total", {"resource": "workflows"})
            return {"settled": settled, "q": q, "quarantined": quarantined,
                    "good": drive(prg, "good")["phase"]}

        assert tc.both(case) == {"settled": "succeeded", "q": ["bad-0"],
                                 "quarantined": 1.0, "good": "succeeded"}


class TestDeadLetterRetryBudget:
    """POST /dead-letters/retry is budgeted: each revival bumps a DURABLE
    per-record attempt count; past budget the retry is a typed refusal."""

    def test_budget_exhausts_with_typed_refusal_and_survives_restart(self):
        def boom(rec):
            raise RuntimeError("still broken")

        def case(pkg):
            kv = pkg.kv.MemoryKV()
            prg = boot(pkg, kv, queue_dead_letter_retry_budget=2)
            prg.wq.register("always_fail", boom)
            prg.wq.submit_record("always_fail", {})
            prg.wq.start()
            prg.wq.drain()
            seen = []

            def letters(p):
                return [(d["opRetries"], d["retryable"])
                        for d in p.wq.dead_letter_view()]

            seen.append(letters(prg))
            for _ in range(2):
                seen.append(prg.wq.retry_dead_letters())
                prg.wq.drain()
                seen.append(letters(prg))
            seen.append(refusal(prg.wq.retry_dead_letters))
            prg.wq.close()
            prg2 = boot(pkg, kv, queue_dead_letter_retry_budget=2)
            seen.append(letters(prg2))
            prg2.wq.start()
            seen.append(refusal(prg2.wq.retry_dead_letters))
            prg2.wq.close()
            seen.append(len(prg2.wq.dead_letter_view()))
            return seen

        assert tc.both(case) == [
            [(0, True)], 1, [(1, True)], 1, [(2, False)],
            "RetryBudgetExhausted", [(2, False)], "RetryBudgetExhausted", 1]

    def test_mixed_set_retries_fresh_skips_exhausted(self):
        def boom(rec):
            raise RuntimeError("boom")

        def case(pkg):
            prg = boot(pkg, queue_dead_letter_retry_budget=1)
            prg.wq.register("always_fail", boom)
            prg.wq.submit_record("always_fail", {"which": "a"})
            prg.wq.start()
            prg.wq.drain()
            first = prg.wq.retry_dead_letters()  # a: budget now spent
            prg.wq.drain()
            prg.wq.submit_record("always_fail", {"which": "b"})
            prg.wq.drain()
            # a is past budget (skipped), b is fresh (requeued)
            second = prg.wq.retry_dead_letters()
            prg.wq.drain()
            prg.wq.close()
            return first, second, sorted(
                r["opRetries"] for r in prg.wq.dead_letter_view())

        assert tc.both(case) == (1, 1, [1, 1])


def http(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        out = json.loads(resp.read())
    out.pop("requestId", None)
    return out


class TestHttpSurface:
    def test_workflow_routes_and_events(self):
        def case(pkg):
            prg = boot(pkg, port=0, workflow_interval_s=0,
                       reconcile_interval=0, job_supervise_interval=0,
                       host_probe_interval_s=0)
            prg.start()
            port = prg.api_server.port
            out = {}
            try:
                out["create"] = http(port, "POST", "/api/v1/workflows", {
                    "workflowName": "pipe",
                    "binds": ["/mnt/artifacts:/artifacts"],
                    "steps": [
                        {"name": "train", "image": "jax:train",
                         "chipCount": 1},
                        {"name": "evaluate", "image": "jax:eval",
                         "chipCount": 1, "deps": ["train"]}]})
                # names only: the step states race the live queue consumer
                out["list"] = [w["name"] for w in http(
                    port, "GET", "/api/v1/workflows")["data"]]
                out["patch"] = http(port, "PATCH", "/api/v1/workflows/pipe", {
                    "cronIntervalS": 3600, "cronEnabled": True,
                    "cronCatchup": "fire_once"})
                out["bad"] = http(port, "POST", "/api/v1/workflows", {
                    "workflowName": "loop",
                    "steps": [{"name": "a", "image": "i", "chipCount": 1,
                               "deps": ["a"]}]})["code"]
                # drive the DAG over the live queue consumer
                for _ in range(8):
                    prg.wq.drain()
                    info = prg.workflow.workflow_info("pipe")
                    if info["phase"] != "running":
                        break
                    for s in info["steps"]:
                        if s["state"] == "running" \
                                and s.get("jobPhase") == "running":
                            prg.job_svc.mark_gang_completed(s["job"])
                    prg.workflow.tick()
                prg.wq.drain()
                out["info"] = http(port, "GET",
                                   "/api/v1/workflows/pipe")["data"]
                events = http(port, "GET", "/api/v1/events?limit=200")["data"]
                out["kinds"] = sorted({e.get("event") for e in events
                                       if e.get("event", "").startswith(
                                           "workflow-")})
                out["delete"] = http(port, "DELETE",
                                     "/api/v1/workflows/pipe")["code"]
                out["gone"] = http(port, "GET",
                                   "/api/v1/workflows/pipe")["code"]
            finally:
                prg.stop()
            return tc.scrub(tc.unclocked(out))

        out = tc.both(case)
        assert out["create"]["code"] == 200
        assert out["create"]["data"]["phase"] == "running"
        assert out["create"]["data"]["priorityClass"] == "batch"
        assert out["list"] == ["pipe-0"]
        assert out["patch"]["data"]["cron"]["intervalS"] == 3600.0
        assert out["bad"] == tc.PORT.errors.BadRequest.code
        assert out["info"]["phase"] == "succeeded"
        assert {s["name"]: s["state"] for s in out["info"]["steps"]} == {
            "train": "succeeded", "evaluate": "succeeded"}
        assert {"workflow-created", "workflow-step-succeeded"} <= set(
            out["kinds"])
        assert out["delete"] == 200
        assert out["gone"] == tc.PORT.errors.WorkflowNotExist.code


class TestConfigValidation:
    def test_load_validates_workflow_keys(self, tmp_path):
        good = tmp_path / "good.toml"
        good.write_text('workflow_default_class = "production"\n'
                        "workflow_max_step_retries = 5\n"
                        "queue_dead_letter_retry_budget = 7\n")
        for pkg in tc.PKGS:
            cfg = pkg.config.load(str(good))
            assert cfg.workflow_default_class == "production"
            assert cfg.workflow_max_step_retries == 5
            assert cfg.queue_dead_letter_retry_budget == 7
            assert cfg.workflow_interval_s == 2.0  # JAX's default, on
        for i, bad in enumerate((
                'workflow_default_class = "gold"\n',
                "workflow_interval_s = -1\n",
                "workflow_max_step_retries = -1\n",
                "workflow_max_step_retries = true\n",
                "workflow_backoff_base_s = -0.5\n",
                "workflow_backoff_base_s = 10.0\n"
                "workflow_backoff_max_s = 1.0\n",
                "queue_dead_letter_retry_budget = 0\n")):
            p = tmp_path / f"bad{i}.toml"
            p.write_text(bad)
            msgs = []
            for pkg in tc.PKGS:
                with pytest.raises(ValueError) as exc:
                    pkg.config.load(str(p))
                msgs.append(str(exc.value))
            assert msgs[1] == msgs[0]
