"""The port's host failure domains against the JAX package's on the CPU
(``tests/test_host_health.py``): the circuit breaker's transitions, the
healthy → suspect → down machine and its grace window on an injected
clock, cordon persistence across daemon restarts, the scheduler's refusal
to place on cordoned or down hosts, the operator routes, and the drain (a
whole-gang migration, or an elastic gang's shrink). Each script runs
through both packages over the same 2- or 4-host pod of 8-GPU hosts; what
each returned, the breaker and host views, the monitor's events, the pod's
end state and the oracles must be equal. JAX's drain-shrink tests run with
the capacity market on; the port has none yet (ROADMAP Queue 1 item 10
part v), so both packages run them with it off: the gang shrinks the same
way and no grow-back record is kept."""

import json
import types
import urllib.request

import pytest

import torch_control as tc

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def boot_pod(pkg, kv, local_rt, remote_rt, **cfg):
    """2-host pod; h1 remote (breaker-wrapped by the daemon)."""
    conf = pkg.config.Config(
        store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8", health_watch_interval=0, end_port=40099,
        pod_hosts=[
            {"host_id": "h0", "address": "10.0.0.1", "grid_coord": [0, 0, 0],
             "local": True},
            {"host_id": "h1", "address": "10.0.0.2", "grid_coord": [1, 0, 0],
             "runtime_backend": "fake"},
        ], **cfg)
    prg = pkg.daemon.Program(conf, kv=kv, runtime=local_rt,
                             pod_runtimes={"h1": remote_rt})
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    return prg


def faulty(pkg):
    return pkg.faulty.FaultyRuntime(pkg.fake.FakeRuntime(),
                                    pkg.faulty.FaultPlan())


def kinds(src, limit=100) -> list:
    return [e.get("event") for e in src.events_view(limit=limit)]


def raised(pkg, exc, fn, *a, match=None, **kw):
    with pytest.raises(getattr(pkg.errors, exc), match=match):
        fn(*a, **kw)
    return exc


class TestBreaker:
    @staticmethod
    def breaker(pkg, threshold=3, cooldown=5.0):
        clock = {"now": 0.0}
        inner = faulty(pkg)
        br = pkg.hh.BreakerRuntime(inner, host_id="h1", threshold=threshold,
                                   cooldown_s=cooldown,
                                   clock=lambda: clock["now"])
        return br, inner, clock

    def test_opens_after_threshold_and_fast_fails(self):
        def script(pkg):
            br, inner, _ = self.breaker(pkg, threshold=3)
            inner.set_unreachable(True)
            for _ in range(3):
                raised(pkg, "HostUnreachable", br.container_list)
            state = br.view()["state"]
            n = len(inner.calls)
            raised(pkg, "HostUnreachable", br.container_list,
                   match="circuit open")
            return state, len(inner.calls) - n, br.view()
        state, extra, _ = tc.both(script)
        assert state == "open" and extra == 0

    def test_half_open_probe_closes_on_success(self):
        def script(pkg):
            br, inner, clock = self.breaker(pkg, threshold=2)
            inner.set_unreachable(True)
            for _ in range(2):
                raised(pkg, "HostUnreachable", br.container_list)
            inner.set_unreachable(False)
            clock["now"] = 4.0
            raised(pkg, "HostUnreachable", br.container_list,
                   match="circuit open")
            clock["now"] = 6.0
            return br.container_list(), br.view()
        listed, view = tc.both(script)
        assert listed == [] and view["state"] == "closed"
        assert view["consecutiveFailures"] == 0

    def test_half_open_probe_failure_reopens(self):
        def script(pkg):
            br, inner, clock = self.breaker(pkg, threshold=2)
            inner.set_unreachable(True)
            for _ in range(2):
                raised(pkg, "HostUnreachable", br.container_list)
            clock["now"] = 6.0
            raised(pkg, "HostUnreachable", br.container_list)
            state = br.view()["state"]
            clock["now"] = 7.0
            raised(pkg, "HostUnreachable", br.container_list,
                   match="circuit open")
            return state
        assert tc.both(script) == "open"

    def test_application_errors_prove_the_host_alive(self):
        def script(pkg):
            br, inner, _ = self.breaker(pkg, threshold=2)
            inner.set_unreachable(True)
            raised(pkg, "HostUnreachable", br.container_list)
            inner.set_unreachable(False)
            raised(pkg, "ContainerNotExist", br.container_inspect, "nope")
            streak = br.view()["consecutiveFailures"]
            inner.set_unreachable(True)
            raised(pkg, "HostUnreachable", br.container_list)
            return streak, br.view()["state"]
        assert tc.both(script) == (0, "closed")

    def test_normalizes_connection_errors(self):
        def script(pkg):
            class Sock(pkg.fake.FakeRuntime):
                def container_list(self):
                    raise ConnectionRefusedError("boom")

            br = pkg.hh.BreakerRuntime(Sock(), host_id="h9", threshold=3)
            return raised(pkg, "HostUnreachable", br.container_list,
                          match="h9")
        tc.both(script)


class TestHostStateMachine:
    @staticmethod
    def monitor(pkg, grace=15.0):
        rt1 = faulty(pkg)
        prg = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(), rt1)
        clock = {"now": 0.0}
        mon = pkg.hh.HostMonitor(prg.pod, prg.pod_scheduler,
                                 down_grace_s=grace,
                                 clock=lambda: clock["now"])
        return prg, rt1, mon, clock

    def test_blip_inside_grace_never_goes_down(self):
        def script(pkg):
            prg, rt1, mon, clock = self.monitor(pkg)
            seen = []
            mon.probe_once()
            seen.append(mon.host_state("h1"))
            rt1.set_unreachable(True)
            mon.probe_once()
            seen.append(mon.host_state("h1"))
            clock["now"] = 10.0
            mon.probe_once()
            seen += [mon.host_state("h1"), mon.is_down("h1"),
                     prg.pod_scheduler.down_hosts()]
            rt1.set_unreachable(False)
            clock["now"] = 12.0
            mon.probe_once()
            seen.append(mon.host_state("h1"))
            return seen, kinds(mon), mon.status_view()
        seen, ev, _ = tc.both(script)
        assert seen == ["healthy", "suspect", "suspect", False, set(),
                        "healthy"]
        assert "host-suspect" in ev and "host-blip-over" in ev
        assert "host-down" not in ev

    def test_grace_elapsed_marks_down_and_unschedulable(self):
        def script(pkg):
            prg, rt1, mon, clock = self.monitor(pkg)
            rt1.set_unreachable(True)
            hook = []
            mon._on_down = hook.append
            mon.probe_once()
            clock["now"] = 15.0
            mon.probe_once()
            down = (mon.is_down("h1"), prg.pod_scheduler.down_hosts(),
                    prg.pod_scheduler.host_schedulable("h1"), list(hook))
            rt1.set_unreachable(False)
            clock["now"] = 30.0
            mon.probe_once()
            return down, mon.host_state("h1"), \
                prg.pod_scheduler.down_hosts(), kinds(mon)
        down, state, after, ev = tc.both(script)
        assert down == (True, {"h1"}, False, ["h1"])
        assert state == "healthy" and after == set()
        assert "host-down" in ev and "host-recovered" in ev

    def test_status_view_reports_breaker_and_schedulability(self):
        def script(pkg):
            rt1 = faulty(pkg)
            prg = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
                           rt1)
            mon = pkg.hh.HostMonitor(prg.pod, prg.pod_scheduler)
            before = mon.status_view()
            rt1.set_unreachable(True)
            for _ in range(4):
                mon.probe_once()
            return before, mon.status_view()

        def stable(view):
            # the seconds since a host's last transition are the wall
            # clock's
            return {h: {k: v for k, v in d.items()
                        if k != "sinceS"}
                    for h, d in view["hosts"].items()}
        got = [script(pkg) for pkg in tc.PKGS]
        assert [stable(v) for v in got[1]] == [stable(v) for v in got[0]]
        before, after = got[1]
        assert set(before["hosts"]) == {"h0", "h1"}
        assert before["hosts"]["h1"]["state"] == "healthy"
        assert before["hosts"]["h1"]["schedulable"]
        assert before["hosts"]["h1"]["breaker"]["state"] == "closed"
        assert after["hosts"]["h1"]["state"] == "suspect"
        assert after["hosts"]["h1"]["breaker"]["state"] == "open"


class TestCordon:
    def test_cordoned_host_receives_no_placements_until_uncordon(self):
        def script(pkg):
            prg = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
                           pkg.fake.FakeRuntime())
            s = prg.pod_scheduler
            s.cordon_host("h1")
            g1 = s.apply_slice(n_chips=8, owner="a")
            errs = [raised(pkg, "ChipNotEnough", s.apply_slice, n_chips=8,
                           owner="b", match="cordoned"),
                    raised(pkg, "ChipNotEnough", s.apply_slice, n_chips=4,
                           owner="c")]
            view = s.host_view("h1")
            s.uncordon_host("h1")
            g2 = s.apply_slice(n_chips=8, owner="b")
            return g1.to_dict(), errs, view, g2.to_dict(), tc.job_world(prg)
        g1, _, view, g2, _ = tc.both(script)
        assert [h for h, _ in g1["hosts"]] == ["h0"]
        assert view["cordoned"] and not view["schedulable"]
        assert [h for h, _ in g2["hosts"]] == ["h1"]

    def test_cordon_survives_daemon_restart(self):
        def script(pkg):
            kv = pkg.kv.MemoryKV()
            rt0, rt1 = pkg.fake.FakeRuntime(), pkg.fake.FakeRuntime()
            boot_pod(pkg, kv, rt0, rt1).pod_scheduler.cordon_host("h1")
            s2 = boot_pod(pkg, kv, rt0, rt1).pod_scheduler
            seen = (s2.cordoned_hosts(), s2.host_schedulable("h1"),
                    raised(pkg, "ChipNotEnough", s2.apply_slice, n_chips=16,
                           owner="big"))
            s2.uncordon_host("h1")
            return seen, boot_pod(pkg, kv, rt0, rt1) \
                .pod_scheduler.cordoned_hosts()
        seen, after = tc.both(script)
        assert seen[:2] == ({"h1"}, False) and after == set()

    def test_reload_caches_rereads_cordons_grants_and_versions(self):
        """A daemon's ``_reload_caches`` (JAX's leadership-handoff refresh)
        re-reads what another daemon on the same store wrote: the job
        version, the slice grant, the per-host GPU claims and a cordon."""
        def script(pkg):
            kv = pkg.kv.MemoryKV()
            rt0, rt1 = pkg.fake.FakeRuntime(), pkg.fake.FakeRuntime()
            stale = boot_pod(pkg, kv, rt0, rt1)
            live = boot_pod(pkg, kv, rt0, rt1)
            live.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                               job_name="train",
                                               chip_count=16))
            live.pod_scheduler.cordon_host("h1")
            before = tc.job_world(stale)
            stale._reload_caches()
            return before, tc.job_world(stale), tc.job_world(live)
        before, after, live = tc.both(script)
        assert before["versions"] == {} and before["slices"] == {}
        assert after == live and after["cordoned"] == ["h1"]

    def test_cordon_unknown_host_rejected(self):
        tc.both(lambda pkg: raised(pkg, "ContainerNotExist", boot_pod(
            pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
            pkg.fake.FakeRuntime()).pod_scheduler.cordon_host, "nope"))

    def test_capacity_accounting_excludes_unschedulable(self):
        def script(pkg):
            s = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
                         pkg.fake.FakeRuntime()).pod_scheduler
            views = [s.status()]
            s.cordon_host("h1")
            views.append(s.status())
            s.set_host_down("h0", True)
            views.append(s.status())
            return views
        a, b, c = tc.both(script)
        assert (a["freeHosts"], a["schedulableChips"]) == (2, 16)
        assert (b["freeHosts"], b["schedulableChips"],
                b["freeSchedulableChips"], b["cordonedHosts"]) == (
            1, 8, 8, ["h1"])
        assert (c["freeHosts"], c["downHosts"]) == (0, ["h0"])

    def test_exclude_hosts_param_bans_for_one_grant(self):
        def script(pkg):
            s = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
                         pkg.fake.FakeRuntime()).pod_scheduler
            g = s.apply_slice(n_chips=8, owner="a", exclude_hosts={"h0"})
            return g.to_dict(), s.apply_slice(n_chips=8,
                                              owner="b").to_dict()
        g, g2 = tc.both(script)
        assert [h for h, _ in g["hosts"]] == ["h1"]
        assert [h for h, _ in g2["hosts"]] == ["h0"]


class TestOperatorSurface:
    def test_cordon_drain_health_routes(self):
        def script(pkg):
            prg = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
                           pkg.fake.FakeRuntime())
            prg.cfg.port = 0
            prg.cfg.reconcile_on_start = False
            prg.cfg.job_supervise_interval = 0
            prg.host_monitor._interval = 3600
            try:
                prg.start()

                def call(method, path):
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{prg.api_server.port}{path}",
                        method=method,
                        data=b"{}" if method == "POST" else None,
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req) as resp:
                        return json.loads(resp.read())

                out = [call("POST", "/api/v1/hosts/h1/cordon")]
                health = call("GET", "/api/v1/health/hosts")
                out.append(health["data"]["hosts"]["h1"]["cordoned"])
                out.append(health["data"]["hosts"]["h1"]["schedulable"])
                out.append(call("POST", "/api/v1/hosts/h1/uncordon"))
                out.append(call("POST", "/api/v1/hosts/h1/drain"))
                events = call("GET", "/api/v1/events")["data"]
                out.append(sorted({e.get("event") for e in events
                                   if e.get("event", "").startswith(
                                       "host-")}))
                return out
            finally:
                prg.stop()
        cordon, cordoned, sched, uncordon, drain, ev = tc.both(script)
        assert cordon["code"] == 200 and cordon["data"]["cordoned"]
        assert cordoned and not sched
        assert not uncordon["data"]["cordoned"]
        assert drain["data"]["cordoned"]
        assert drain["data"]["drainingJobs"] == []
        assert "host-cordoned" in ev and "host-drain-queued" in ev

    def test_drain_queues_migration_for_placed_jobs(self):
        def script(pkg):
            prg = boot_pod(pkg, pkg.kv.MemoryKV(), pkg.fake.FakeRuntime(),
                           pkg.fake.FakeRuntime())
            prg.job_svc.run_job(pkg.js.JobRun(image_name="jax",
                                              job_name="train", chip_count=4))
            out = prg.host_monitor.drain("h0")
            cordoned = prg.pod_scheduler.cordoned_hosts()
            prg.wq.start()
            prg.wq.drain()
            prg.wq.close()
            st = prg.store.get_job("train-1")
            return (out, cordoned, st.phase, [p[0] for p in st.placements],
                    st.migrations, tc.job_world(prg),
                    tc.job_invariants(pkg, prg))
        out, cordoned, phase, hosts, migrations, _, inv = tc.both(script)
        assert out["drainingJobs"] == ["train"] and cordoned == {"h0"}
        assert phase == "running" and hosts == ["h1"]
        assert migrations == 0 and inv == []


class TestDrainShrink:
    """Elastic gangs drain by SHRINKING: the drained host's members are
    dropped (never below minMembers) instead of re-placing the whole
    gang."""

    @staticmethod
    def pod4(pkg):
        rts = {f"h{i}": pkg.fake.FakeRuntime() for i in range(4)}
        cfg = pkg.config.Config(
            store_backend="memory", runtime_backend="fake",
            accelerator_type="h100-8", health_watch_interval=0,
            end_port=40099, pod_hosts=[
                {"host_id": f"h{i}", "address": f"10.0.0.{i + 1}",
                 "grid_coord": [i, 0, 0],
                 **({"local": True} if i == 0
                    else {"runtime_backend": "fake"})}
                for i in range(4)])
        prg = pkg.daemon.Program(cfg, kv=pkg.kv.MemoryKV(), runtime=rts["h0"],
                                 pod_runtimes={h: r for h, r in rts.items()
                                               if h != "h0"})
        prg._discover_topology = lambda: tc.topology(pkg)
        prg.init()
        return prg

    @staticmethod
    def drained(pkg, prg, host):
        out = prg.host_monitor.drain(host)
        prg.wq.start()
        prg.wq.drain()
        prg.wq.close()
        st = prg.store.get_job(f"train-{prg.job_versions.get('train')}")
        return types.SimpleNamespace(
            out=out, st=st.to_dict(), events=kinds(prg.host_monitor),
            world=tc.job_world(prg), inv=tc.job_invariants(pkg, prg))

    def test_drain_offers_shrink_before_migration(self):
        def script(pkg):
            prg = self.pod4(pkg)
            prg.job_svc.run_job(pkg.js.JobRun(
                image_name="jax", job_name="train", chip_count=32,
                elastic=True, min_members=1))
            r = self.drained(pkg, prg, "h3")
            r.st.pop("last_resize")  # stamped with the wall clock
            return vars(r)
        r = tc.both(script)
        assert r["out"]["drainingJobs"] == ["train"]
        st = r["st"]
        assert st["phase"] == "running" and len(st["placements"]) == 3
        assert all(p[0] != "h3" for p in st["placements"])
        assert (st["migrations"], st["restarts"], st["resizes"]) == (0, 0, 1)
        assert "job-drain-shrunk" in r["events"] and r["inv"] == []

    def test_drain_below_floor_falls_back_to_migration(self):
        def script(pkg):
            prg = self.pod4(pkg)
            prg.job_svc.run_job(pkg.js.JobRun(
                image_name="jax", job_name="train", chip_count=16,
                elastic=True, min_members=2))
            host = prg.store.get_job("train-0").placements[0][0]
            return host, vars(self.drained(pkg, prg, host))
        host, r = tc.both(script)
        st = r["st"]
        assert st["phase"] == "running" and len(st["placements"]) == 2
        assert all(p[0] != host for p in st["placements"])
        assert st["resizes"] == 0
        assert "job-drained" in r["events"] and r["inv"] == []
