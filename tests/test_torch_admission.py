"""The port's capacity market (``service/admission.py``) against the JAX
package's on the CPU: every case of ``tests/test_admission.py`` runs one
script through each package's ``Program`` over a row of 8-GPU hosts, and what
each left behind must be JAX's: phases, queue positions and skips, the
victims and their order, the stored job states and admission journal,
the pod (containers, GPU and port owners, slices), the market's event
ring, the counters and the oracles. JAX's own assertions then hold on
the port's side."""

import dataclasses
import json
import re

import pytest

import torch_control as tc
from tpu_docker_api.api import app as japp
from tpu_docker_api.api import response as jresponse
from tpu_docker_api_torch.api import app as tapp
from tpu_docker_api_torch.api import response as tresponse

#: each package's API modules
API = {"jax": (japp, jresponse), "port": (tapp, tresponse)}


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def boot(pkg, n_hosts=1, admission_enabled=True, max_skips=4, **cfg):
    """test_admission.py's boot: the market on, its loop off (interval 0:
    passes run inline)."""
    return tc.pod_program(pkg, n_hosts, admission_enabled=admission_enabled,
                          admission_interval_s=0,
                          admission_max_skips=max_skips, **cfg)


def run(pkg, prg, name, chips, klass="batch", **kw):
    return prg.job_svc.run_job(pkg.js.JobRun(
        image_name="jax", job_name=name, chip_count=chips,
        priority_class=klass, **kw))


def delete(pkg, prg, name):
    prg.job_svc.delete_job(name, pkg.js.JobDelete(
        force=True, del_state_and_version_record=True))


def phase(prg, base):
    return prg.store.get_job(f"{base}-{prg.job_versions.get(base)}").phase


def members(prg, base) -> int:
    return len(prg.store.get_job(
        f"{base}-{prg.job_versions.get(base)}").placements)


def placed(prg) -> list:
    return [o["job"] for o in prg.admission.admit_once()]


def refusal(fn, *args, **kwargs):
    """``(error class, message, data)`` of a call that must raise."""
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return type(e).__name__, str(e), getattr(e, "data", None)
    raise AssertionError(f"{fn.__name__} did not raise")


def same_refusal(got: tuple, cls: str, pattern: str) -> None:
    assert got[0] == cls and re.search(pattern, got[1]), got


def books(pkg, prg, **extra) -> dict:
    return {**tc.market_books(pkg, prg), **tc.unclocked({
        "status": prg.admission.status_view(),
        "health": prg.admission.health_view(), **extra})}


# -- ordering invariants ------------------------------------------------------


def test_victim_selection_lowest_priority_then_youngest():
    def case(pkg):
        prg = boot(pkg, n_hosts=2)
        run(pkg, prg, "a", 4, "batch")
        run(pkg, prg, "b", 4, "preemptible")
        run(pkg, prg, "c", 4, "preemptible")
        adm = prg.admission
        prod, low = adm.weight("production"), adm.weight("preemptible")
        return books(pkg, prg, victims=[
            adm._victims_for(prod, 16, 1, "req"),
            adm._victims_for(prod, 6, 1, "req"),
            adm._victims_for(low, 4, 1, "req")])

    out = tc.both(case)
    assert out["victims"] == [["c", "b", "a"], ["c"], []]
    assert out["oracle"] == []


def test_preempted_readmits_before_equal_priority_queued():
    def case(pkg):
        prg = boot(pkg, n_hosts=2)
        run(pkg, prg, "a", 16, "batch")
        q = [run(pkg, prg, "b", 16, "batch")["phase"],
             run(pkg, prg, "c", 16, "production")["phase"]]
        first = placed(prg)
        mid = {b: phase(prg, b) for b in ("a", "b")}
        delete(pkg, prg, "c")
        second = placed(prg)
        return books(pkg, prg, q=q, passes=[first, second], mid=mid,
                     end={b: phase(prg, b) for b in ("a", "b")})

    out = tc.both(case)
    assert out["q"] == ["queued", "queued"]
    assert out["passes"] == [["c"], ["a"]]
    assert out["mid"] == {"a": "preempted", "b": "queued"}
    assert out["end"] == {"a": "running", "b": "queued"}
    assert out["oracle"] == []


def test_backfill_never_starves_past_max_skips():
    def case(pkg):
        prg = boot(pkg, n_hosts=1, max_skips=2)
        run(pkg, prg, "base0", 4, "production")
        run(pkg, prg, "blockA", 4, "production")
        q = [run(pkg, prg, "bigjob", 8, "production")["phase"]]
        q += [run(pkg, prg, f"f{i}", 4, "batch")["phase"] for i in range(3)]
        passes = []
        delete(pkg, prg, "blockA")
        passes.append(placed(prg))
        delete(pkg, prg, "f0")
        passes.append(placed(prg))
        head = next(e for e in prg.admission.status_view()["entries"]
                    if e["name"] == "bigjob")
        delete(pkg, prg, "f1")
        passes.append(placed(prg))
        stalled = phase(prg, "f2")
        delete(pkg, prg, "base0")
        passes.append(placed(prg))
        big = phase(prg, "bigjob")
        delete(pkg, prg, "bigjob")
        passes.append(placed(prg))
        return books(pkg, prg, q=q, passes=passes, stalled=stalled, big=big,
                     head=(head["skips"], head["position"]))

    out = tc.both(case)
    assert out["q"] == ["queued"] * 4
    assert out["passes"] == [["f0"], ["f1"], [], ["bigjob"], ["f2"]]
    assert out["head"] == (2, 1)
    assert out["stalled"] == "queued" and out["big"] == "running"
    assert out["oracle"] == []


def test_preempted_records_exempt_from_starvation_gate():
    def case(pkg):
        prg = boot(pkg, n_hosts=1, max_skips=2)
        run(pkg, prg, "base", 4, "production")
        run(pkg, prg, "low", 4, "preemptible")
        preempted = prg.admission._preempt_one(
            "low", for_base="big",
            requester_weight=prg.admission.weight("production"))
        mid = phase(prg, "low")
        q = run(pkg, prg, "big", 8, "production")["phase"]
        rec = next(r for r in prg.admission.records() if r.base == "big")
        rec.skips = 2
        prg.kv.put(rec.key(), rec.to_json())
        return books(pkg, prg, preempted=preempted, mid=mid, q=q,
                     passed=placed(prg), low=phase(prg, "low"))

    out = tc.both(case)
    assert out["preempted"] is True and out["mid"] == "preempted"
    assert out["q"] == "queued"
    assert "low" in out["passed"] and out["low"] == "running"
    assert out["oracle"] == []


def test_zero_preemptions_when_holes_suffice():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "low1", 4, "preemptible")
        run(pkg, prg, "low2", 4, "preemptible")
        q = run(pkg, prg, "hi", 4, "production")["phase"]
        delete(pkg, prg, "low2")
        return books(pkg, prg, q=q, passed=placed(prg),
                     phases=[phase(prg, "hi"), phase(prg, "low1")])

    out = tc.both(case)
    assert out["q"] == "queued" and out["passed"] == ["hi"]
    assert out["phases"] == ["running", "running"]
    assert out["status"]["preemptionsTotal"] == 0


# -- phase operations ---------------------------------------------------------


def test_stop_dequeues_queued_job():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "fill", 8, "batch")
        q = run(pkg, prg, "waiting", 4, "batch")["phase"]
        prg.job_svc.stop_job("waiting")
        mid = (len(prg.admission.records()), phase(prg, "waiting"))
        delete(pkg, prg, "fill")
        return books(pkg, prg, q=q, mid=mid, passed=placed(prg),
                     end=phase(prg, "waiting"))

    out = tc.both(case)
    assert out["q"] == "queued" and out["mid"] == (0, "stopped")
    assert out["passed"] == [] and out["end"] == "stopped"


def test_stop_dequeues_preempted_job():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "low", 8, "preemptible")
        run(pkg, prg, "hi", 8, "production")
        prg.admission.admit_once()
        mid = phase(prg, "low")
        prg.job_svc.stop_job("low")
        return books(pkg, prg, mid=mid, end=phase(prg, "low"))

    out = tc.both(case)
    assert out["mid"] == "preempted" and out["end"] == "stopped"
    assert out["records"] == [] and out["oracle"] == []


def test_delete_purges_admission_record():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "fill", 8, "batch")
        run(pkg, prg, "waiting", 4, "batch")
        delete(pkg, prg, "waiting")
        return books(pkg, prg, left=prg.kv.range_prefix(
            pkg.keys.family_prefix(pkg.keys.Resource.JOBS, "waiting")))

    out = tc.both(case)
    assert out["records"] == [] and out["left"] == {}
    assert "waiting" not in out["jobs"]


def test_restart_and_rescale_reject_dormant_phases():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "fill", 8, "preemptible")
        run(pkg, prg, "waiting", 4, "batch")
        got = [refusal(prg.job_svc.restart_job, "waiting"),
               refusal(prg.job_svc.patch_job_chips, "waiting",
                       pkg.js.JobPatchChips(chip_count=2))]
        run(pkg, prg, "hi", 8, "production")
        prg.admission.admit_once()
        mid = phase(prg, "fill")
        got.append(refusal(prg.job_svc.restart_job, "fill"))
        return books(pkg, prg, refusals=got, mid=mid)

    out = tc.both(case)
    same_refusal(out["refusals"][0], "BadRequest", "queued")
    same_refusal(out["refusals"][1], "BadRequest", "queued")
    assert out["mid"] == "preempted"
    same_refusal(out["refusals"][2], "BadRequest", "preempted")


def test_restart_rejected_after_stop_of_grantless_job():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "low", 8, "preemptible")
        run(pkg, prg, "hi", 8, "production")
        prg.admission.admit_once()
        mid = [phase(prg, "low")]
        prg.job_svc.stop_job("low")
        got = [refusal(prg.job_svc.restart_job, "low")]
        run(pkg, prg, "ghost", 4, "batch")
        mid.append(phase(prg, "ghost"))
        prg.job_svc.stop_job("ghost")
        got.append(refusal(prg.job_svc.restart_job, "ghost"))
        return books(pkg, prg, refusals=got, mid=mid)

    out = tc.both(case)
    assert out["mid"] == ["preempted", "queued"]
    same_refusal(out["refusals"][0], "BadRequest", "slice grant")
    same_refusal(out["refusals"][1], "BadRequest", "never placed")
    assert out["oracle"] == []


def test_priority_and_seniority_survive_rescale():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "svc", 2, "production")
        seq0 = prg.store.get_job("svc-0").submitted_seq
        prg.job_svc.patch_job_chips("svc", pkg.js.JobPatchChips(chip_count=4))
        st = prg.store.get_job(f"svc-{prg.job_versions.get('svc')}")
        return books(pkg, prg, seq0=seq0, after=(
            st.version, st.priority_class, st.submitted_seq))

    out = tc.both(case)
    assert out["after"] == (1, "production", out["seq0"])


def test_supervisor_leaves_dormant_gangs_alone():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "low", 8, "preemptible")
        run(pkg, prg, "hi", 8, "production")
        prg.admission.admit_once()
        mid = phase(prg, "low")
        prg.job_supervisor.poll_once()
        low = prg.store.get_job(f"low-{prg.job_versions.get('low')}")
        return books(pkg, prg, mid=mid, end=low.phase, running=[
            prg.runtime.container_inspect(c).running
            for _, c, *_ in low.placements])

    out = tc.both(case)
    assert out["mid"] == out["end"] == "preempted"
    assert not any(out["running"]) and out["oracle"] == []


# -- refusal ergonomics -------------------------------------------------------


def test_disabled_keeps_legacy_hard_fail():
    def case(pkg):
        response = API[pkg.name][1]
        prg = boot(pkg, n_hosts=1, admission_enabled=False)
        run(pkg, prg, "fill", 8)
        try:
            run(pkg, prg, "more", 4)
            raise AssertionError("no refusal")
        except pkg.errors.ChipNotEnough as e:
            env = response.error(e.code, str(e), data=e.data)
        return books(pkg, prg, envelope=env,
                     journal=prg.kv.range_prefix(pkg.keys.ADMISSION_PREFIX))

    out = tc.both(case)
    env = json.loads(out["envelope"])
    assert env["code"] == 10601 and env["data"] is None
    assert out["journal"] == {} and "more" not in out["jobs"]


def test_enabled_returns_queue_position():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "fill", 8)
        outs = [run(pkg, prg, "q1", 4, "batch"), run(pkg, prg, "q2", 4,
                                                     "batch")]
        return books(pkg, prg, outs=outs,
                     info=prg.job_svc.get_job_info("q2"))

    out = tc.both(case)
    q1, q2 = out["outs"]
    assert (q1["phase"], q1["queueable"], q1["queuePosition"]) == (
        "queued", True, 1)
    assert q2["queuePosition"] == 2
    info = out["info"]
    assert (info["phase"], info["queuePosition"], info["priorityClass"]) == (
        "queued", 2, "batch")


def test_never_placeable_ask_flags_queueable_false():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        return books(pkg, prg, refused=refusal(run, pkg, prg, "huge", 64),
                     journal=prg.kv.range_prefix(pkg.keys.ADMISSION_PREFIX))

    out = tc.both(case)
    assert out["refused"][0] == "ChipNotEnough"
    assert out["refused"][2] == {"queueable": False}
    assert out["journal"] == {}


def test_unknown_priority_class_rejected():
    out = tc.both(lambda pkg: refusal(run, pkg, boot(pkg), "x", 2,
                                      "platinum"))
    same_refusal(out, "BadRequest", "priorityClass")


# -- defragmentation ----------------------------------------------------------


def test_whole_host_ask_defragments_via_migration():
    def case(pkg):
        prg = boot(pkg, n_hosts=3)
        run(pkg, prg, "a", 4, "production")
        run(pkg, prg, "b", 8, "production")
        run(pkg, prg, "c", 4, "production")
        run(pkg, prg, "d", 4, "production")
        delete(pkg, prg, "c")
        q = run(pkg, prg, "big", 8, "production")["phase"]
        return books(pkg, prg, q=q, passed=placed(prg), phases={
            b: phase(prg, b) for b in ("a", "b", "d", "big")})

    out = tc.both(case)
    assert out["q"] == "queued" and out["passed"] == ["big"]
    assert set(out["phases"].values()) == {"running"}
    assert out["status"]["preemptionsTotal"] == 0
    assert out["oracle"] == []
    assert any(e["event"] == "job-defrag-migrated"
               for e in out["admission_events"])


# -- operator surface ---------------------------------------------------------


def test_admission_route_events_and_health():
    def case(pkg):
        app = API[pkg.name][0]
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "low", 8, "preemptible")
        run(pkg, prg, "hi", 8, "production")
        router = app.build_router(
            prg.container_svc, prg.volume_svc, prg.chip_scheduler,
            prg.port_scheduler, work_queue=prg.wq, metrics=prg.metrics,
            job_svc=prg.job_svc, pod_scheduler=prg.pod_scheduler,
            job_supervisor=prg.job_supervisor, admission=prg.admission)

        def get(path):
            handler, params, _ = router.match("GET", path)
            return handler(body={}, **params)

        before = get("/api/v1/admission")
        prg.admission.admit_once()
        after = get("/api/v1/admission")
        kinds = sorted({e["event"] for e in get("/api/v1/events")
                        if "event" in e})
        health = get("/healthz")["admission"]
        jobs = get("/api/v1/health/jobs")["jobs"]["low"]
        return tc.unclocked({"before": before, "after": after,
                             "kinds": kinds, "health": health,
                             "low": (jobs["priorityClass"], jobs["phase"])})

    out = tc.both(case)
    before, after = out["before"], out["after"]
    assert before["enabled"] is True and before["depth"] == 1
    assert before["perClass"]["production"] == 1
    assert before["entries"][0]["name"] == "hi"
    assert before["classes"]["system"] > before["classes"]["production"]
    assert after["depth"] == 1
    assert after["entries"][0]["state"] == "preempted"
    assert (after["preemptionsTotal"], after["admissionsTotal"]) == (1, 1)
    assert {"job-queued", "job-preempted", "job-admitted"} <= set(
        out["kinds"])
    assert out["health"]["enabled"] is True
    assert out["health"]["preemptionsTotal"] == 1
    assert out["low"] == ("preemptible", "preempted")


_SERIES = re.compile(r"^(admission_queue_depth|preemptions_total|"
                     r"admissions_total|admission_wait_ms_count)\b.*$", re.M)


def test_metrics_series():
    def case(pkg):
        prg = boot(pkg, n_hosts=1)
        run(pkg, prg, "low", 8, "preemptible")
        run(pkg, prg, "hi", 8, "production")
        prg.admission.admit_once()
        return sorted(_SERIES.findall(prg.metrics.render()))

    tc.both(case)
    prg = boot(tc.PORT, n_hosts=1)
    run(tc.PORT, prg, "low", 8, "preemptible")
    run(tc.PORT, prg, "hi", 8, "production")
    prg.admission.admit_once()
    text = prg.metrics.render()
    assert 'admission_queue_depth{class="preemptible"} 1' in text
    assert 'preemptions_total{victim_class="preemptible"} 1' in text
    assert "admission_wait_ms" in text


def test_admission_loop_runs_with_the_writers_only_when_enabled():
    """The daemon half of JAX's leader-standby case (leader election is
    not ported): with the loop interval 0 the writer role starts no
    admission thread; with an interval it starts one and stops it."""
    for interval, want in ((0, False), (0.05, True)):
        prg = boot(tc.PORT, n_hosts=1)
        prg.cfg.admission_interval_s = interval
        assert prg.admission._thread is None
        prg._start_writers()
        try:
            assert (prg.admission._thread is not None) is want
        finally:
            prg._stop_writers()
        assert prg.admission._thread is None


def test_leader_standby_does_not_run_admission_loop():
    """The admission loop is a writer: with leader election on it starts
    and stops with the lease — the leader runs it, the standby does not
    until it acquires — and with the loop interval 0 it never starts."""
    def case(pkg):
        out = []
        for interval in (0, 0.05):
            kv, clock = pkg.kv.MemoryKV(), {"now": 1000.0}
            rts = {"h0": pkg.fake.FakeRuntime()}
            progs = [tc.pod_program(
                pkg, kv=kv, rts=rts, admission_enabled=True,
                admission_interval_s=interval, leader_election=True,
                leader_ttl_s=30.0, leader_id=name, reconcile_interval=0,
                job_supervise_interval=0, host_probe_interval_s=0,
                workflow_interval_s=0) for name in ("alpha", "beta")]
            for prg in progs:
                prg.leader_elector._clock = lambda: clock["now"]
            try:
                seen = [prg.admission._thread is not None for prg in progs]
                for prg in progs:
                    prg.leader_elector.step()
                seen += [prg.admission._thread is not None for prg in progs]
                progs[0].stop()  # releases the lease, stops its writers
                progs[1].leader_elector.step()
                seen += [prg.admission._thread is not None for prg in progs]
                out.append(seen)
            finally:
                progs[1].stop()
        return out

    with tc.jax_knows_h100():
        assert tc.both(case) == [
            [False] * 6,
            [False, False, True, False, False, True]]


# -- config validation --------------------------------------------------------


def test_load_validates_admission_keys(tmp_path):
    def case(pkg):
        out = []
        bad = tmp_path / f"bad-{pkg.name}.toml"
        for text in ('priority_class_default = "gold"\n',
                     "admission_max_skips = -1\n",
                     "[priority_class_weights]\ngold = 1.5\n"):
            bad.write_text(text)
            out.append(refusal(pkg.config.load, str(bad))[:2])
        good = tmp_path / f"good-{pkg.name}.toml"
        good.write_text(
            'admission_enabled = true\nadmission_max_skips = 7\n'
            'priority_class_default = "gold"\n'
            "[priority_class_weights]\ngold = 10\nbronze = 1\n")
        cfg = pkg.config.load(str(good))
        return out, (cfg.priority_class_weights, cfg.admission_max_skips,
                     cfg.admission_enabled)

    errs, good = tc.both(case)
    for (cls, msg), pat in zip(errs, ("priority_class_default",
                                      "admission_max_skips", "integer")):
        assert cls == "ValueError" and re.search(pat, msg)
    assert good == ({"gold": 10, "bronze": 1}, 7, True)


def test_custom_ladder_drives_admission():
    def case(pkg):
        prg = boot(pkg, n_hosts=1,
                   priority_class_weights={"gold": 10, "bronze": 1},
                   priority_class_default="bronze")
        run(pkg, prg, "cheap", 8, "")
        bad = refusal(run, pkg, prg, "x", 2, "batch")
        q = run(pkg, prg, "vip", 8, "gold")["phase"]
        prg.admission.admit_once()
        return books(pkg, prg, bad=bad, q=q, phases=(
            phase(prg, "vip"), phase(prg, "cheap")))

    out = tc.both(case)
    same_refusal(out["bad"], "BadRequest", "priorityClass")
    assert out["q"] == "queued"
    assert out["phases"] == ("running", "preempted")


# -- partial preemption (elastic gangs) ---------------------------------------


def test_spare_members_taken_before_any_whole_gang_dies():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        run(pkg, prg, "don", 32, "preemptible", elastic=True, min_members=1)
        q = run(pkg, prg, "prod", 8, "production")["phase"]
        return books(pkg, prg, q=q, passed=placed(prg),
                     info=prg.job_svc.get_job_info("don"))

    out = tc.both(case)
    assert out["q"] == "queued" and out["passed"] == ["prod"]
    don, prod = out["jobs"]["don"], out["jobs"]["prod"]
    assert (don["phase"], len(don["placements"])) == ("running", 3)
    assert prod["phase"] == "running"
    assert out["status"]["preemptionsTotal"] == 0
    assert out["status"]["partialPreemptionsTotal"] == 1
    assert ("don", "growback") in [r[:2] for r in out["records"]]
    info = out["info"]
    assert (info["membersDesired"], info["membersActual"]) == (4, 3)
    assert info["growbackQueuePosition"] == 1
    assert info["lastResize"]["direction"] == "down"
    assert out["oracle"] == []


def test_growback_lands_through_the_queue_after_pressure_lifts():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        run(pkg, prg, "don", 32, "preemptible", elastic=True, min_members=1)
        run(pkg, prg, "prod", 8, "production")
        trail = [placed(prg), members(prg, "don"), placed(prg),
                 members(prg, "don")]
        delete(pkg, prg, "prod")
        trail += [placed(prg), members(prg, "don"), phase(prg, "don"),
                  len(prg.admission.records()), placed(prg)]
        fixpoint = prg.reconciler.reconcile()["actions"]
        prg.job_svc.resize_max = 2
        resizes = prg.store.get_job(
            f"don-{prg.job_versions.get('don')}").resizes
        run(pkg, prg, "prod2", 8, "production")
        prg.admission.admit_once()
        trail.append(members(prg, "don"))
        delete(pkg, prg, "prod2")
        prg.admission.admit_once()
        trail += [members(prg, "don"), phase(prg, "don")]
        return books(pkg, prg, trail=trail, fixpoint=fixpoint,
                     resizes=resizes)

    out = tc.both(case)
    assert out["trail"] == [["prod"], 3, [], 3, ["don"], 4, "running", 0, [],
                            3, 4, "running"]
    assert out["fixpoint"] == [] and out["resizes"] == 2


def test_growback_parks_while_resize_disabled():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        run(pkg, prg, "don", 32, "preemptible", elastic=True, min_members=1)
        run(pkg, prg, "prod", 8, "production")
        prg.admission.admit_once()
        delete(pkg, prg, "prod")
        prg.job_svc.resize_enabled = False
        parked = [placed(prg), members(prg, "don"),
                  sorted({r.kind for r in prg.admission.records()
                          if r.base == "don"})]
        prg.job_svc.resize_enabled = True
        return books(pkg, prg, parked=parked, resumed=placed(prg),
                     after=members(prg, "don"))

    out = tc.both(case)
    assert out["parked"] == [[], 3, ["growback"]]
    assert out["resumed"] == ["don"] and out["after"] == 4


def test_never_below_min_members_whole_gang_condemned_instead():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        run(pkg, prg, "don", 32, "preemptible", elastic=True, min_members=3)
        q = run(pkg, prg, "prod", 16, "production")["phase"]
        return books(pkg, prg, q=q, passed=placed(prg))

    out = tc.both(case)
    assert out["q"] == "queued" and out["passed"] == ["prod"]
    assert out["jobs"]["prod"]["phase"] == "running"
    assert out["jobs"]["don"]["phase"] == "preempted"
    assert out["status"]["preemptionsTotal"] == 1
    assert {r[0]: r[1] for r in out["records"]}["don"] == "preempted"
    assert out["oracle"] == []


def test_strictly_lower_class_only():
    def case(pkg):
        prg = boot(pkg, n_hosts=2)
        run(pkg, prg, "peer", 16, "production", elastic=True, min_members=1)
        q = run(pkg, prg, "prod", 8, "production")["phase"]
        return books(pkg, prg, q=q, passed=placed(prg),
                     peer=members(prg, "peer"))

    out = tc.both(case)
    assert out["q"] == "queued" and out["passed"] == []
    assert out["peer"] == 2 and out["jobs"]["prod"]["phase"] == "queued"
    assert out["oracle"] == []


def test_youngest_elastic_donor_first():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        run(pkg, prg, "old", 16, "preemptible", elastic=True, min_members=1)
        run(pkg, prg, "young", 16, "preemptible", elastic=True,
            min_members=1)
        q = run(pkg, prg, "prod", 8, "production")["phase"]
        return books(pkg, prg, q=q, passed=placed(prg),
                     sizes=(members(prg, "young"), members(prg, "old")))

    out = tc.both(case)
    assert out["q"] == "queued" and out["passed"] == ["prod"]
    assert out["sizes"] == (1, 2) and out["oracle"] == []


def test_plan_is_whole_gang_victims_byte_for_byte_without_elastic_donors():
    def case(pkg):
        prg = boot(pkg, n_hosts=2)
        run(pkg, prg, "a", 4, "batch")
        run(pkg, prg, "b", 4, "preemptible")
        run(pkg, prg, "c", 4, "preemptible")
        adm = prg.admission
        w = adm.weight("production")
        return [(adm._preempt_plan(w, want, 1, "req"),
                 adm._victims_for(w, want, 1, "req")) for want in (16, 6, 4)]

    for plan, victims in tc.both(case):
        assert plan == [("full", b, 0) for b in victims]


def test_resize_disabled_keeps_whole_gang_preemption():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        prg.job_svc.resize_enabled = False
        run(pkg, prg, "don", 32, "preemptible", elastic=True, min_members=1)
        run(pkg, prg, "prod", 8, "production")
        prg.admission.admit_once()
        return books(pkg, prg)

    out = tc.both(case)
    assert out["jobs"]["don"]["phase"] == "preempted"
    assert out["jobs"]["prod"]["phase"] == "running"
    assert out["status"]["partialPreemptionsTotal"] == 0
    assert out["oracle"] == []


def test_elastic_validation():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        got = [refusal(run, pkg, prg, "x", 32, "batch", elastic=True,
                       num_slices=2),
               refusal(run, pkg, prg, "x", 4, "batch", elastic=True),
               refusal(run, pkg, prg, "x", 16, "batch", elastic=True,
                       min_members=5),
               refusal(run, pkg, prg, "x", 16, "batch", min_members=1)]
        run(pkg, prg, "fill", 32, "production")
        q = run(pkg, prg, "el", 16, "batch", elastic=True,
                min_members=2)["phase"]
        return books(pkg, prg, refusals=got, q=q)

    out = tc.both(case)
    for got, pat in zip(out["refusals"], ("single-slice", ">= 2 whole hosts",
                                          "minMembers", "elastic")):
        same_refusal(got, "BadRequest", pat)
    el = out["jobs"]["el"]
    assert out["q"] == "queued"
    assert (el["elastic"], el["min_members"], el["members_desired"]) == (
        True, 2, 2)


def test_rescale_updates_elastic_contract():
    def case(pkg):
        prg = boot(pkg, n_hosts=4)
        run(pkg, prg, "el", 32, "batch", elastic=True, min_members=3)
        patch = prg.job_svc.patch_job_chips
        got = [refusal(patch, "el", pkg.js.JobPatchChips(chip_count=4)),
               refusal(patch, "el", pkg.js.JobPatchChips(chip_count=16))]
        patch("el", pkg.js.JobPatchChips(chip_count=24))
        return books(pkg, prg, refusals=got)

    out = tc.both(case)
    same_refusal(out["refusals"][0], "BadRequest", "whole-host")
    same_refusal(out["refusals"][1], "BadRequest", "minMembers")
    el = out["jobs"]["el"]
    assert el["members_desired"] == 3 and el["elastic"]
    assert out["oracle"] == []


def test_blocked_growback_never_freezes_queued_admissions():
    def case(pkg):
        prg = boot(pkg, n_hosts=4, max_skips=2)
        run(pkg, prg, "halfpin", 4, "batch")
        run(pkg, prg, "don", 24, "batch", elastic=True, min_members=1)
        q = [run(pkg, prg, "prod", 8, "production")["phase"]]
        prg.admission.admit_once()
        mid = (members(prg, "don"), phase(prg, "prod"))
        run(pkg, prg, "g0", 4, "batch")
        prev, passes = "g0", []
        for i in range(3):
            q.append(run(pkg, prg, f"f{i}", 4, "batch")["phase"])
            delete(pkg, prg, prev)
            passes.append(placed(prg))
            prev = f"f{i}"
        rec = next(r for r in prg.admission.records() if r.base == "don")
        return books(pkg, prg, q=q, mid=mid, passes=passes,
                     rec=(rec.kind, rec.skips), don=members(prg, "don"))

    out = tc.both(case)
    assert out["q"] == ["queued"] * 4
    assert out["mid"] == (2, "running")
    assert out["passes"] == [["f0"], ["f1"], ["f2"]]
    assert out["rec"] == ("growback", 0) and out["don"] == 2
    assert out["oracle"] == []


# -- the port's own refusals ---------------------------------------------------


@pytest.mark.parametrize("arg", ["shard_fn", "owned_shards"])
def test_sharded_plane_is_refused_by_name(arg):
    """The sharded writer plane's arguments are ported: ``shard_fn``
    journals a queued gang under its family's shard, ``owned_shards``
    leaves another shard's records to that shard's leader — the journal
    keys, the records and the admission passes are JAX's."""
    def case(pkg):
        prg = tc.pod_program(pkg, admission_enabled=True,
                             admission_interval_s=0)
        kw = {"shard_fn": lambda base: 2 if base == "late" else 0}
        if arg == "owned_shards":
            kw["owned_shards"] = lambda: frozenset({0})
        ctl = pkg.adm.AdmissionController(
            prg.job_svc, prg.store, prg.job_versions, prg.pod_scheduler,
            prg.kv, enabled=True, **kw)
        prg.job_svc.admission = ctl
        run = [prg.job_svc.run_job(pkg.js.JobRun(
            image_name="jax", job_name=name, chip_count=8,
            priority_class="batch"))["phase"] for name in ("big", "late")]
        prg.job_svc.delete_job("big", pkg.js.JobDelete(force=True))
        passes = [ctl.admit_once() for _ in range(2)]
        return tc.unclocked({
            "run": run, "passes": passes,
            "keys": sorted(prg.kv.range_prefix(pkg.keys.ADMISSION_PREFIX)),
            "records": [(r.base, r.kind, r.shard) for r in ctl._ordered()],
            "world": tc.job_world(prg)})

    with tc.jax_knows_h100():
        out = tc.both(case)
    assert out["run"] == ["running", "queued"]
    prefix = tc.PORT.keys.admission_prefix(2)
    assert [k.startswith(prefix) for k in out["keys"]] == [True] * (
        arg == "owned_shards")
    if arg == "owned_shards":
        # shard 2 is not ours: its leader admits it, this process does not
        assert out["records"] == [("late", "queued", 2)]
    else:
        assert out["records"] == []
        assert out["passes"][0] and "late" in out["world"]["versions"]


def test_records_and_classes_are_jax_s():
    """The journal's JSON and the default ladder are JAX's, key for key:
    a record one package wrote, the other reads."""
    assert tc.PORT.adm.DEFAULT_PRIORITY_CLASSES == \
        tc.JAX.adm.DEFAULT_PRIORITY_CLASSES
    assert tc.PORT.adm.DEFAULT_CLASS == tc.JAX.adm.DEFAULT_CLASS
    assert tc.PORT.adm.DEFAULT_MAX_SKIPS == tc.JAX.adm.DEFAULT_MAX_SKIPS
    for shard in (0, 3):
        jrec = tc.JAX.adm.AdmissionRecord(7, "web.r1", "growback", "batch",
                                          skips=2, ts=1.5, accel="h100-8",
                                          trace_id="ab", shard=shard)
        trec = tc.PORT.adm.AdmissionRecord.from_json(jrec.to_json())
        assert trec.to_json() == jrec.to_json()
        assert trec.key() == jrec.key()
    assert not hasattr(tc.PORT.js, "DEFAULT_PRIORITY_CLASSES")
    assert [f.name for f in dataclasses.fields(tc.PORT.js.JobState)] == [
        f.name for f in dataclasses.fields(tc.JAX.js.JobState)]


def test_an_oracle_inside_a_probe_sees_what_jax_sees(monkeypatch):
    """The transient that ``chip_smoke.py``'s market oracles wait out by
    reading between admission passes: a pass that probes a queued gang
    on a full pool bumps its version pointer before the claim and rolls
    it back when the claim fails. An oracle read inside the probe finds
    the same dangling pointer in both packages; read after the pass, it
    finds nothing."""
    def case(pkg):
        prg = boot(pkg)
        run(pkg, prg, "a", 8)
        queued = run(pkg, prg, "b", 8)["phase"]
        inside = []
        crash_point = pkg.job.crash_point

        def spy(label):
            if label == "job.run.after_version_bump":
                inside.append(tc.market_oracle(pkg, prg))
            crash_point(label)

        monkeypatch.setattr(pkg.job, "crash_point", spy)
        return books(pkg, prg, queued=queued, passes=placed(prg),
                     inside=inside)

    out = tc.both(case)
    assert out["queued"] == "queued" and out["passes"] == []
    assert out["inside"] == [["job b: latest pointer v1 has no stored "
                              "state"]]
    assert out["oracle"] == []
