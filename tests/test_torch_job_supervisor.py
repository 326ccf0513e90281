"""The port's gang supervision against the JAX package's on the CPU
(``tests/test_job_supervisor.py``): each test runs one script through both
packages' daemons, booted over a 2-host pod of 8-GPU hosts (one local, one
remote fake engine), and compares what each returned and left behind: the
job versions, slice and port owners per host, each engine's containers,
states and gang-ordering calls, the supervisor's and the watcher's event
kinds, and the invariant oracles. The watcher's restart backoff runs on an
injected clock."""

import types

import pytest

import torch_control as tc


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def boot_pod(pkg, kv=None, local_rt=None, remote_rt=None):
    cfg = pkg.config.Config(
        store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8", health_watch_interval=0, end_port=40099,
        pod_hosts=[
            {"host_id": "h0", "address": "10.0.0.1", "grid_coord": [0, 0, 0],
             "local": True},
            {"host_id": "h1", "address": "10.0.0.2", "grid_coord": [1, 0, 0],
             "runtime_backend": "fake"},
        ],
    )
    prg = pkg.daemon.Program(
        cfg, kv=kv or pkg.kv.MemoryKV(),
        runtime=local_rt or pkg.fake.FakeRuntime(),
        pod_runtimes={"h1": remote_rt or pkg.fake.FakeRuntime()})
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    return prg


def gang_calls(rt) -> list:
    return [c for c in rt.calls if c[0] in ("stop", "start", "restart")]


def kinds(src) -> list:
    return [e["event"] for e in src.events_view()]


def world(pkg):
    """A booted 2-host pod with ``train`` running over 16 GPUs."""
    rt0, rt1 = pkg.fake.FakeRuntime(), pkg.fake.FakeRuntime()
    prg = boot_pod(pkg, local_rt=rt0, remote_rt=rt1)
    prg.job_svc.run_job(pkg.js.JobRun(image_name="jax", job_name="train",
                                      chip_count=16))
    rt0.calls.clear()
    rt1.calls.clear()
    return types.SimpleNamespace(pkg=pkg, prg=prg, rt0=rt0, rt1=rt1,
                                 svc=prg.job_svc, sup=prg.job_supervisor,
                                 js=pkg.js, e=pkg.errors)


def both(script):
    """``script(w)`` on each package's fresh world: results, end states,
    both oracles and the supervisor's events must be equal; returns the
    port's world and result."""
    got = []
    for pkg in tc.PKGS:
        w = world(pkg)
        res = script(w)
        got.append((w, res, tc.job_world(w.prg),
                    tc.job_invariants(pkg, w.prg), kinds(w.sup)))
    (_, *jax), (pw, *port) = got
    assert port == jax
    return pw, port[0]


class TestWatcherJobInteraction:
    def test_watcher_delegates_job_member_to_supervisor(self):
        def script(w):
            watcher = w.pkg.watch.HealthWatcher(
                w.rt0, interval_s=3600, restart_policy="on-failure",
                crash_handler=w.prg.container_svc.handle_crash,
                job_crash_handler=w.sup.handle_member_death)
            watcher.poll_once()
            w.rt0.crash_container("train-0-p0", exit_code=137)
            watcher.poll_once()
            seen = (kinds(watcher), watcher.status_view()["restarts"],
                    w.rt0.container_inspect("train-0-p0").running,
                    kinds(w.sup))
            w.sup.poll_once()
            return seen, w.rt0.container_inspect("train-0-p0").running, \
                w.prg.store.get_job("train-0").restarts
        _, ((wk, restarts, up, sk), after, n) = both(script)
        assert "delegated-to-job-supervisor" in wk and "restarted" not in wk
        assert restarts == {} and not up
        assert "member-died-delegated" in sk
        assert after and n == 1

    def test_whole_gang_restarts_not_single_member(self):
        def script(w):
            w.rt1.crash_container("train-0-p1")
            w.sup.poll_once()
            return gang_calls(w.rt0), gang_calls(w.rt1)
        _, (c0, c1) = both(script)
        assert c0 == [("stop", "train-0-p0"), ("start", "train-0-p0")]
        assert c1 == [("stop", "train-0-p1"), ("start", "train-0-p1")]

    def test_handle_member_death_declines_non_members(self):
        _, res = both(lambda w: (w.sup.handle_member_death("plain-0"),
                                 w.svc.owns_member("plain-0"),
                                 w.svc.owns_member("other-0-p0")))
        assert res == (False, None, None)

    def test_container_service_crash_handler_refuses_job_members(self):
        def script(w):
            w.rt0.crash_container("train-0-p0")
            return (w.prg.container_svc.handle_crash("train-0-p0"),
                    w.rt0.container_inspect("train-0-p0").running)
        _, res = both(script)
        assert res == (False, False)


class TestGangOrdering:
    def test_restart_job_coordinator_first(self):
        def script(w):
            out = w.svc.restart_job("train")
            return out["phase"], gang_calls(w.rt0), gang_calls(w.rt1)
        pw, (phase, c0, c1) = both(script)
        assert phase == "running"
        assert c1[0] == ("stop", "train-0-p1")
        assert c0 == [("stop", "train-0-p0"), ("start", "train-0-p0")]
        assert "job-restarted" in kinds(pw.sup)

    def test_restart_job_resets_budget(self):
        def script(w):
            w.rt1.crash_container("train-0-p1")
            w.sup.poll_once()
            n = w.prg.store.get_job("train-0").restarts
            w.svc.restart_job("train")
            return n, w.prg.store.get_job("train-0").restarts
        _, res = both(script)
        assert res == (1, 0)

    def test_manual_restart_clears_backoff_window(self):
        def script(w):
            clock = {"now": 0.0}
            sup = w.pkg.sup.JobSupervisor(
                w.prg.pod, w.svc, w.prg.store, w.prg.job_versions,
                max_restarts=5, backoff_base_s=50.0, backoff_max_s=60.0,
                backoff_jitter=0.0, clock=lambda: clock["now"])
            w.rt1.crash_container("train-0-p1")
            sup.poll_once()
            w.svc.restart_job("train")
            n0 = w.prg.store.get_job("train-0").restarts
            w.rt1.crash_container("train-0-p1")
            clock["now"] = 1.0
            sup.poll_once()
            return (n0, w.rt1.container_inspect("train-0-p1").running,
                    w.prg.store.get_job("train-0").restarts, kinds(sup))
        _, (n0, up, n, _) = both(script)
        assert (n0, up, n) == (0, True, 1)

    def test_restart_gang_declines_healthy_gang(self):
        def script(w):
            st = w.svc.restart_gang("train", reason="stale observation")
            return st.restarts, gang_calls(w.rt1)
        _, res = both(script)
        assert res == (0, [])

    def test_fail_job_declines_stopped_job(self):
        def script(w):
            w.svc.stop_job("train")
            st = w.svc.fail_job("train", "stale verdict")
            return st.phase, w.prg.store.get_job("train-0").phase
        _, res = both(script)
        assert res == ("stopped", "stopped")

    def test_restart_of_failed_job_rejected(self):
        def script(w):
            w.svc.fail_job("train", "test says so")
            with pytest.raises(w.e.BadRequest, match="failed"):
                w.svc.restart_job("train")
        both(script)

    def test_stop_job_reverse_order(self):
        def script(w):
            w.svc.stop_job("train")
            st = w.prg.store.get_job("train-0")
            return gang_calls(w.rt1), gang_calls(w.rt0), st.phase, \
                st.desired_running
        _, res = both(script)
        assert res == ([("stop", "train-0-p1")], [("stop", "train-0-p0")],
                       "stopped", False)

    def test_clean_whole_gang_exit_is_completion_not_crash(self):
        def script(w):
            w.rt0.crash_container("train-0-p0", exit_code=0)
            w.rt1.crash_container("train-0-p1", exit_code=0)
            w.rt0.calls.clear()
            w.rt1.calls.clear()
            w.sup.poll_once()
            st = w.prg.store.get_job("train-0")
            return (st.phase, st.desired_running, st.restarts,
                    gang_calls(w.rt0), gang_calls(w.rt1),
                    w.prg.reconciler.reconcile()["actions"])
        pw, res = both(script)
        assert res == ("stopped", False, 0, [], [], [])
        assert "job-completed" in kinds(pw.sup)
        assert "gang-restarting" not in kinds(pw.sup)

    def test_partial_clean_exit_leaves_gang_alone(self):
        def script(w):
            w.rt1.crash_container("train-0-p1", exit_code=0)
            w.sup.poll_once()
            st = w.prg.store.get_job("train-0")
            return st.phase, st.restarts, \
                w.rt1.container_inspect("train-0-p1").running
        _, res = both(script)
        assert res == ("running", 0, False)

    def test_reconciler_settles_completed_job(self):
        def script(w):
            w.rt0.crash_container("train-0-p0", exit_code=0)
            w.rt1.crash_container("train-0-p1", exit_code=0)
            report = w.prg.reconciler.reconcile()
            st = w.prg.store.get_job("train-0")
            return ([a["action"] for a in report["actions"]], st.phase,
                    st.restarts, w.prg.reconciler.reconcile()["actions"])
        _, (acts, phase, n, again) = both(script)
        assert "settle-completed-job" in acts
        assert (phase, n, again) == ("stopped", 0, [])

    def test_missing_member_fails_job_terminally(self):
        def script(w):
            w.rt1.container_remove("train-0-p1", force=True)
            w.sup.poll_once()
            st = w.prg.store.get_job("train-0")
            return st.phase, st.failure_reason, [
                len(h.chips.free_chips) for h in w.prg.pod.hosts.values()]
        _, (phase, reason, free) = both(script)
        assert phase == "failed" and "train-0-p1" in reason
        assert free == [8, 8]


class TestDeletedJobLeftAlone:
    def test_delete_keeping_spec_quiesces_record(self):
        def script(w):
            w.svc.delete_job("train", w.js.JobDelete(force=True))
            w.sup.poll_once()
            st = w.prg.store.get_job("train-0")
            return st.phase, st.desired_running, \
                w.prg.reconciler.reconcile()["actions"]
        pw, res = both(script)
        assert res == ("stopped", False, [])
        assert tc.job_invariants(tc.PORT, pw.prg) == []


class TestSupervisorStatusApi:
    def test_status_view_and_health_route(self):
        _, view = both(lambda w: w.sup.status_view())
        assert view["jobs"]["train"]["phase"] == "running"
        assert view["jobs"]["train"]["restarts"] == 0
        assert view["jobs"]["train"]["deadMembers"] == []

    def test_job_info_surfaces_phase_and_reason(self):
        def script(w):
            before = w.svc.get_job_info("train")
            w.svc.fail_job("train", "oom loop")
            return before, w.svc.get_job_info("train")
        _, (before, after) = both(script)
        assert (before["phase"], before["restarts"]) == ("running", 0)
        assert (after["phase"], after["failureReason"]) == ("failed",
                                                            "oom loop")


class TestWatcherRestartBackoff:
    """``_try_restart`` paces attempts: a tight crash loop must not burn
    the whole budget in consecutive polls."""

    @staticmethod
    def watched(pkg, clock, backoff=2.0, cap=8.0, max_restarts=5):
        rt = pkg.fake.FakeRuntime()
        w = pkg.watch.HealthWatcher(
            rt, interval_s=3600, restart_policy="on-failure",
            max_restarts=max_restarts, restart_backoff_s=backoff,
            restart_backoff_max_s=cap, clock=clock)
        rt.container_create(pkg.spec.ContainerSpec(image="i", name="c-0"))
        rt.container_start("c-0")
        w.poll_once()
        return rt, w

    def both(self, script, **kw):
        got = []
        for pkg in tc.PKGS:
            clock = {"now": 0.0}
            rt, w = self.watched(pkg, lambda c=clock: c["now"], **kw)
            got.append((script(rt, w, clock), kinds(w),
                        w.status_view()["restarts"]))
        assert got[1] == got[0]
        return got[1]

    def test_restart_deferred_inside_backoff_window(self):
        def script(rt, w, clock):
            rt.crash_container("c-0", exit_code=1)
            w.poll_once()
            first = rt.container_inspect("c-0").running
            rt.crash_container("c-0", exit_code=1)
            clock["now"] = 1.0
            w.poll_once()
            return first, rt.container_inspect("c-0").running
        res, k, restarts = self.both(script)
        assert res == (True, False)
        assert "restart-deferred" in k and k.count("restarted") == 1
        assert restarts["c-0"] == 1

    def test_deferred_restart_retries_after_deadline(self):
        def script(rt, w, clock):
            rt.crash_container("c-0", exit_code=1)
            w.poll_once()
            rt.crash_container("c-0", exit_code=1)
            for t in (0.5, 1.0):
                clock["now"] = t
                w.poll_once()
            held = rt.container_inspect("c-0").running
            clock["now"] = 2.5
            w.poll_once()
            return held, rt.container_inspect("c-0").running
        res, k, _ = self.both(script)
        assert res == (False, True) and k.count("restarted") == 2

    def test_backoff_doubles_and_clamps(self):
        def script(rt, w, clock):
            gaps = []
            for _ in range(4):
                rt.crash_container("c-0", exit_code=1)
                before = clock["now"]
                w.poll_once()
                while not rt.container_inspect("c-0").running:
                    clock["now"] += 0.5
                    w.poll_once()
                gaps.append(clock["now"] - before)
            return gaps
        gaps, _, _ = self.both(script, backoff=2.0, cap=5.0)
        assert gaps[0] == 0.0
        assert 2.0 <= gaps[1] <= 2.5
        assert 4.0 <= gaps[2] <= 4.5
        assert 5.0 <= gaps[3] <= 5.5

    def test_clean_stop_after_crash_restart_not_resurrected(self):
        def script(rt, w, clock):
            rt.crash_container("c-0", exit_code=1)
            w.poll_once()
            up = rt.container_inspect("c-0").running
            rt.crash_container("c-0", exit_code=0)
            clock["now"] = 100.0
            w.poll_once()
            w.poll_once()
            return up, rt.container_inspect("c-0").running
        res, k, _ = self.both(script)
        assert res == (True, False) and k.count("restarted") == 1

    def test_zero_backoff_preserves_legacy_behavior(self):
        def script(rt, w, clock):
            for _ in range(4):
                rt.crash_container("c-0", exit_code=1)
                w.poll_once()
        _, k, _ = self.both(script, backoff=0.0, max_restarts=2)
        assert k.count("restarted") == 2
        assert "restart-budget-exhausted" in k
        assert "restart-deferred" not in k
