"""The port's store failure domain (``service/store_health.py``:
``StoreHealth``, ``StoreHealthKV``, the stale-read marker) against the JAX
package's on the CPU — the single-host cases of
``tests/test_store_brownout.py``: the healthy → degraded → outage machine
on a scripted clock (blips below the threshold, the grace window, the
heal and its ``on_recover`` hooks, application errors proving the store
alive, the single-flight probe mutation and the typed 503), the deadline
threading into the backends, and each package's daemon over a
``FaultyKV`` store: mutations refused fast with HTTP 503 and
``Retry-After`` once the outage is declared (one probe let through), the
mode on ``/healthz``, ``/metrics`` and the events ring, the reconciler and
the work queue held while the store is out and resumed after, a full
reconcile pass demanded by the heal, and a replacement refused by failed
store writes landing after the heal. Each case runs in both packages
and their results must be equal."""

import http.client
import json
import time

import pytest

import torch_control as tc


def wait_until(fn, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.005)
    pytest.fail(f"timed out waiting for {what}")


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _machine(pkg, **kw):
    clock = _Clock()
    kw.setdefault("fail_threshold", 3)
    kw.setdefault("outage_grace_s", 2.0)
    kw.setdefault("probe_interval_s", 1.0)
    return pkg.health.StoreHealth(
        clock=clock, registry=pkg.metrics.MetricsRegistry(), **kw), clock


def _fail(h, n=1):
    for _ in range(n):
        h.observe("get", 1.0, ok=False, error="refused")


def _view(h):
    v = h.status_view()
    v.pop("lastTransitionTs")
    return v


def blips(pkg):
    h, _ = _machine(pkg)
    _fail(h, 2)
    out = [h.mode]
    h.observe("get", 1.0, ok=True)
    _fail(h, 2)  # streak reset: still healthy
    return out + [h.mode, _view(h)]


def degraded_then_outage(pkg):
    h, clock = _machine(pkg)
    _fail(h, 3)
    out = [h.mode, h.allows_writes()]
    clock.now += 1.9
    _fail(h)
    out.append(h.mode)  # inside the grace window
    clock.now += 0.2
    _fail(h)
    out += [h.mode, h.allows_writes(), h.serve_stale_reads(),
            [(e["event"], e["frm"]) for e in h.events_view()], _view(h)]
    return out


def heal_fires_on_recover(pkg):
    h, clock = _machine(pkg)
    fired = []
    h.on_recover(lambda: fired.append(1))
    _fail(h, 3)
    clock.now += 3.0
    _fail(h)
    out = [h.mode]
    h.observe("get", 1.0, ok=True)
    out += [h.mode, list(fired)]
    _fail(h, 3)  # degraded → healthy does NOT fire: nothing was held
    h.observe("get", 1.0, ok=True)
    return out + [list(fired), _view(h)]


def app_errors_alive(pkg):
    h, _ = _machine(pkg)
    kv = pkg.health.StoreHealthKV(pkg.kv.MemoryKV(), h)
    for _ in range(5):
        with pytest.raises(pkg.errors.NotExistInStore):
            kv.get("/missing")
    kv.put("/a", "1")
    kv.apply([("put", "/b", "2")])
    w = kv.watch("/", 0)
    w.poll(0.01)
    w.close()
    return [h.mode, _view(h)]


def probe_then_503(pkg):
    h, clock = _machine(pkg)
    _fail(h, 3)
    clock.now += 3.0
    _fail(h)
    out = [h.mode]
    h.admit_mutation()  # the first caller IS the probe
    with pytest.raises(pkg.errors.StoreDegraded) as ei:
        h.admit_mutation()  # single-flight: held
    e = ei.value
    out.append((e.http_status, e.code, e.retry_after_s, e.data))
    clock.now += 1.1  # the probe interval elapsed
    h.admit_mutation()  # the next probe
    h.observe("get", 1.0, ok=True)
    for _ in range(10):
        h.admit_mutation()  # healthy: free passage
    return out + [h.mode]


def stale_marker(pkg):
    pkg.health.consume_stale_read()
    pkg.health.mark_stale_read(42.0)
    out = [pkg.health.consume_stale_read(), pkg.health.consume_stale_read()]
    h = pkg.health.StoreHealth(registry=pkg.metrics.MetricsRegistry())
    h.note_stale_read(17.0)
    return out + [pkg.health.consume_stale_read(),
                  h.status_view()["staleReads"]]


MACHINE = {f.__name__: f for f in (blips, degraded_then_outage,
                                   heal_fires_on_recover, app_errors_alive,
                                   probe_then_503, stale_marker)}


@pytest.mark.parametrize("name", sorted(MACHINE))
def test_machine_as_jax_s(name):
    got = MACHINE[name](tc.PORT)
    assert got == MACHINE[name](tc.JAX)
    if name == "probe_then_503":
        assert got[1] == (503, 10506, 1.0, {"storeMode": "outage"})
    if name == "degraded_then_outage":
        assert got[:6] == ["degraded", True, "degraded", "outage", False,
                           True]


def test_deadlines_reach_the_backends(tmp_path, monkeypatch):
    kv = tc.PORT.kv
    s = kv.open_store("sqlite", sqlite_path=str(tmp_path / "d.db"),
                      op_deadline_s=0.07)
    assert s._busy_timeout_s == 0.07
    s.close()
    s = kv.open_store("sqlite", sqlite_path=str(tmp_path / "e.db"))
    assert s._busy_timeout_s == kv.SqliteKV.BUSY_TIMEOUT_S
    s.close()
    monkeypatch.setattr(kv.EtcdKV, "_post", lambda self, *a, **k: {})
    assert kv.EtcdKV("http://127.0.0.1:1",
                     op_deadline_s=0.25)._op_timeout_s == 0.25
    assert kv.EtcdKV("http://127.0.0.1:1")._op_timeout_s == (
        kv.EtcdKV.OP_TIMEOUT_S == 1.0)


# -- a daemon over a FaultyKV store --------------------------------------------


def _boot(pkg, root, **overrides):
    kv = pkg.faultykv.FaultyKV(pkg.kv.MemoryKV())
    cfg = dict(port=0, start_port=46000, end_port=46999,
               reconcile_on_start=False, store_health_fail_threshold=3,
               store_health_outage_grace_s=0.15,
               store_health_probe_interval_s=0.1)
    cfg.update(overrides)
    conf = pkg.config.Config(store_backend="memory", runtime_backend="fake",
                             health_watch_interval=0, **cfg)
    prg = pkg.daemon.Program(conf, host="127.0.0.1", kv=kv,
                             runtime=pkg.fake.FakeRuntime(root=root))
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    prg.start()
    return prg, kv


def _call(prg, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", prg.api_server.port,
                                      timeout=10)
    conn.request(method, path,
                 body=json.dumps(body).encode() if body is not None else None)
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), json.loads(resp.read()))
    conn.close()
    return out


def _force_outage(prg, kv):
    """A dead store, detected by the traffic a single host has: reads
    through the API fail typed until the grace window declares it."""
    kv.set_outage(True)
    deadline = time.monotonic() + 10
    while prg.store_health.mode != "outage":
        assert time.monotonic() < deadline, "no outage declared"
        _call(prg, "GET", "/api/v1/containers/canary")
        time.sleep(0.03)


def _heal(prg, kv):
    kv.set_outage(False)
    _call(prg, "GET", "/api/v1/containers/canary")  # one op proves it
    wait_until(lambda: prg.store_health.mode == "healthy", what="heal")


def api_outage(pkg, root):
    prg, kv = _boot(pkg, root)
    out = []
    try:
        _, _, r = _call(prg, "POST", "/api/v1/containers", {
            "imageName": "jax", "containerName": "canary", "gpuCount": 1})
        out.append(r["code"])
        st, hdr, r = _call(prg, "GET", "/api/v1/containers/canary")
        out.append((st, r["code"], "stale" in r, "X-Stale-Read" in hdr))
        out.append(_call(prg, "GET", "/healthz")[2]["data"]["storeHealth"][
            "mode"])
        _force_outage(prg, kv)
        # a read pays the deadline-bounded store attempt: typed failure
        st, _, r = _call(prg, "GET", "/api/v1/containers/canary")
        out.append((st, r["code"]))
        # the first mutation is the admitted probe: typed StoreUnavailable
        st, _, r = _call(prg, "POST", "/api/v1/containers", {
            "imageName": "jax", "containerName": "denied", "gpuCount": 1})
        out.append((st, r["code"]))
        # right after: 503 with Retry-After, zero store round trips
        n0 = len(kv.calls)
        st, hdr, r = _call(prg, "POST", "/api/v1/containers", {
            "imageName": "jax", "containerName": "denied2", "gpuCount": 1})
        out.append((st, r["code"], r["data"], int(hdr["Retry-After"]) >= 1,
                    len(kv.calls) == n0))
        sh = _call(prg, "GET", "/healthz")[2]["data"]["storeHealth"]
        out.append((sh["mode"], sh["outagesTotal"]))
        kinds = [e.get("event") for e in _call(
            prg, "GET", "/api/v1/events?limit=200")[2]["data"]]
        out.append(["store-mode-degraded" in kinds,
                    "store-mode-outage" in kinds])
        _heal(prg, kv)
        st, hdr, r = _call(prg, "GET", "/api/v1/containers/canary")
        out.append((st, r["code"], "stale" in r))
        _, _, r = _call(prg, "POST", "/api/v1/containers", {
            "imageName": "jax", "containerName": "later", "gpuCount": 1})
        out.append(r["code"])
        conn = http.client.HTTPConnection("127.0.0.1", prg.api_server.port,
                                          timeout=10)
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
        conn.close()
        out.append(['store_ops_total{outcome="ok"}' in body,
                    'store_ops_total{outcome="unavailable"}' in body,
                    "store_mode 0" in body, "store_op_ms_bucket" in body,
                    "store_outages_total 1" in body])
    finally:
        kv.set_outage(False)
        prg.stop()
    return out


def test_api_fails_mutations_fast_in_an_outage_as_jax(tmp_path):
    got = api_outage(tc.PORT, str(tmp_path / "port"))
    assert got == api_outage(tc.JAX, str(tmp_path / "jax"))
    assert got[4] == (200, 10502)  # the probe reached the dead store
    assert got[5] == (503, 10506, {"storeMode": "outage"}, True, True)
    assert got[-1] == [True] * 5


def writer_holds(pkg, root):
    prg, kv = _boot(pkg, root, reconcile_full_interval_s=60.0)
    out = []
    ran = []
    try:
        prg.container_svc.run_container(pkg.c.ContainerRun(
            image_name="jax", container_name="t", chip_count=1))
        prg.runtime.crash_container("t-0")
        prg.wq.register("brownout-probe", lambda rec: ran.append(1))
        wait_until(lambda: prg.reconcile_informer.synced, what="feed sync")
        prg.reconciler.reconcile()  # the startup full: repairs t-0
        _force_outage(prg, kv)
        prg.runtime.crash_container("t-0")
        # the reconciler holds: a skipped report, no repair
        held = prg.reconciler.reconcile()
        out.append(tc.shape(held))
        out.append(tc.shape(prg.reconciler.reconcile()))
        # a dry run is not held (observation mutates nothing): it sweeps,
        # and its first read meets the dead store
        try:
            prg.reconciler.reconcile(dry_run=True, mode="full")
            out.append("swept")
        except pkg.errors.StoreUnavailable:
            out.append("StoreUnavailable")
        out.append(prg.reconciler.store_skips)
        # the work queue holds execution of what it was handed
        skips0 = prg.wq.store_skips
        prg.wq.submit_record("brownout-probe", {})
        time.sleep(0.3)
        out.append((list(ran), prg.wq.store_skips >= skips0 + 1))
        _heal(prg, kv)
        wait_until(lambda: ran == [1], what="held record runs on heal")
        # the heal marked everything dirty: the next pass is full
        wait_until(lambda: prg.reconciler.dirty_view()["fullPending"],
                   what="dirty-all after heal")
        out.append(prg.reconciler.dirty_view()["fullReason"] in (
            "store-recovered", "relist"))
        after = prg.reconciler.reconcile()
        out.append((after["mode"], [(a["action"], a["target"])
                                    for a in after["actions"]]))
        out.append([e["action"] for e in prg.reconciler.events_view()
                    if e["action"].startswith("store-outage")])
        wq_events = [e["event"] for e in prg.wq.stats()["events"]]
        out.append(["store-outage-hold" in wq_events,
                    "store-outage-over" in wq_events])
        out.append(tc.invariants(pkg, prg))
    finally:
        kv.set_outage(False)
        prg.stop()
    return out


def test_writers_hold_in_an_outage_and_resume_as_jax(tmp_path):
    got = writer_holds(tc.PORT, str(tmp_path / "port"))
    assert got == writer_holds(tc.JAX, str(tmp_path / "jax"))
    assert got[0]["mode"] == "skipped" and got[0]["actions"] == []
    assert got[2] == "StoreUnavailable"  # the dry run swept
    assert got[4] == ([], True)
    assert got[6] == ("full", [("restart-dead", "t-0")])
    assert got[7] == ["store-outage-hold", "store-outage-over"]
    assert got[-1] == []


def midflow(pkg, root):
    prg, kv = _boot(pkg, root)
    out = []
    try:
        _, _, r = _call(prg, "POST", "/api/v1/containers", {
            "imageName": "jax", "containerName": "vic", "gpuCount": 2})
        out.append(r["code"])
        # the NEXT batched store writes die: the replacement is
        # interrupted partway, and the caller sees a typed error
        kv.fail_nth("apply", kv.op_count("apply") + 1, times=2)
        _, _, r = _call(prg, "PATCH", "/api/v1/containers/vic/gpu",
                        {"gpuCount": 1})
        out.append(r["code"])
        out.append(_call(prg, "GET", "/api/v1/containers/vic")[2]["code"])
        for i in range(10):  # burn what is left of the scripted failures
            try:
                kv.apply([("put", "/chaos/drain", str(i))])
                break
            except pkg.errors.StoreUnavailable:
                continue
        rec = prg.reconciler.reconcile()
        out.append([(a["action"], a["target"]) for a in rec["actions"]])
        _, _, r = _call(prg, "PATCH", "/api/v1/containers/vic/gpu",
                        {"gpuCount": 1})
        out.append(r["code"])
        prg.wq.drain()
        info = _call(prg, "GET", "/api/v1/containers/vic")[2]
        out.append((info["code"],
                    len(info["data"]["state"]["spec"]["chip_ids"])))
        out.append(tc.invariants(pkg, prg))
    finally:
        prg.stop()
    return out


def test_replacement_interrupted_by_the_store_converges_as_jax(tmp_path):
    got = midflow(tc.PORT, str(tmp_path / "port"))
    assert got == midflow(tc.JAX, str(tmp_path / "jax"))
    assert got[1] == tc.PORT.errors.StoreUnavailable.code
    # the version transition is one atomic batch: refused whole, it left
    # nothing half-applied for the sweep, and the intent lands after
    assert got[3] == []
    assert got[4:] == [200, (200, 1), []]
