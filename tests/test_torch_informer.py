"""The port's ``state/informer.py`` (``Informer``, ``InformerReadKV``)
against the JAX package's on the CPU (modeled on
``tests/test_informer.py``): each package's reflector over its own
``MemoryKV`` (or ``FaultyKV``) is fed the same mutations — the initial
list reaching handlers as synthetic events, live events replayed into the
mirror and the handlers, a watch gap (WatchLost) answered by a relist
whose diff carries every swallowed put and delete, a store outage
degrading the reflector and its recovery, the status view read back from
the registry — and ``InformerReadKV`` routes reads as JAX's does: the
mirror while active and synced (zero store reads, absence
authoritative), the store otherwise, writes always through, and during a
store outage an explicitly stale mirror read. The handlers' events, the
mirror, the events ring and the counters must be equal."""

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


def make_informer(pkg, kv, registry=None):
    return pkg.informer.Informer(
        kv, pkg.keys.PREFIX + "/", registry=registry,
        relist_backoff_base_s=0.01, relist_backoff_max_s=0.05,
        poll_timeout_s=0.05)


def _events(seen):
    return [(e.op, e.key, e.value) for e in seen]


def list_then_watch(pkg):
    P = pkg.keys.PREFIX
    kv = pkg.kv.MemoryKV()
    kv.put(f"{P}/containers/pre/latest", "0")
    seen = []
    inf = make_informer(pkg, kv)
    inf.register(f"{P}/containers/", seen.append)
    inf.start()
    try:
        wait_until(lambda: inf.synced, what="initial sync")
        first = _events(seen)
        kv.put(f"{P}/containers/new/latest", "1")
        kv.put(f"{P}/volumes/other/latest", "9")  # filtered from handler
        kv.delete(f"{P}/containers/pre/latest")
        wait_until(lambda: len(seen) == 3, what="event delivery")
        return {"first": first, "all": _events(seen),
                "mirror": inf.range_prefix(P + "/"),
                "get": [inf.get(f"{P}/containers/pre/latest"),
                        inf.get(f"{P}/volumes/other/latest")]}
    finally:
        inf.close()


def watch_lost_relist(pkg):
    P = pkg.keys.PREFIX
    kv = pkg.kv.MemoryKV(log_retain=4)
    registry = pkg.metrics.MetricsRegistry()
    inf = make_informer(pkg, kv, registry=registry)
    seen = []
    inf.register(P + "/", seen.append)
    inf.start()
    try:
        wait_until(lambda: inf.synced, what="initial sync")
        inf.close()  # wedge the consumer so the log overruns it
        for i in range(12):
            kv.put(f"{P}/burst/{i:02d}", str(i))
        seen.clear()
        inf.start()
        wait_until(lambda: inf.synced and registry.counter_value(
            "informer_relists_total") >= 2, what="relist after gap")
        wait_until(lambda: len(seen) >= 12, what="diff replay")
        return {"keys": sorted(e.key for e in seen),
                "last": inf.get(f"{P}/burst/11"),
                "relists": registry.counter_value("informer_relists_total")}
    finally:
        inf.close()


def outage_then_recovery(pkg):
    P = pkg.keys.PREFIX
    kv = pkg.faultykv.FaultyKV(pkg.kv.MemoryKV())
    kv.put(f"{P}/x", "1")
    # the next two relist attempts fail typed, then the store heals
    kv.fail_nth("range_prefix_with_rev",
                kv.op_count("range_prefix_with_rev") + 1, times=2)
    inf = make_informer(pkg, kv)
    inf.start()
    try:
        wait_until(lambda: inf.synced, what="recovery after outage")
        return {"x": inf.get(f"{P}/x"),
                "degraded": [(e["event"], e["reason"])
                             for e in inf.events_view()
                             if e["event"] == "informer-degraded"]}
    finally:
        inf.close()


def relist_diff_deletes(pkg):
    P = pkg.keys.PREFIX
    kv = pkg.kv.MemoryKV(log_retain=4)
    inf = make_informer(pkg, kv)
    key = f"{P}/containers/doomed/latest"
    kv.put(key, "0")
    seen = []
    inf.register(key, seen.append)
    inf.start()
    try:
        wait_until(lambda: inf.synced, what="initial sync")
        inf.close()
        kv.delete(key)
        for i in range(12):  # overrun the log so resume is impossible
            kv.put(f"{P}/noise/{i}", "x")
        inf.start()
        wait_until(lambda: any(e.op == "delete" for e in seen),
                   what="synthetic delete from relist diff")
        return {"events": [(e.op, e.key) for e in seen], "get": inf.get(key)}
    finally:
        inf.close()


def status_view(pkg):
    registry = pkg.metrics.MetricsRegistry()
    kv = pkg.kv.MemoryKV()
    inf = make_informer(pkg, kv, registry=registry)
    inf.start()
    try:
        wait_until(lambda: inf.synced, what="sync")
        kv.put(f"{pkg.keys.PREFIX}/a", "1")
        wait_until(lambda: inf.status_view()["eventsTotal"] >= 1,
                   what="event counter")
        view = inf.status_view()
        rendered = registry.render()
        return {"keys": sorted(view), "synced": view["synced"],
                "relists": view["relistsTotal"],
                "events": view["eventsTotal"],
                "lastRev": view["lastRev"] >= 1,
                "lag": view["watchLagMs"] >= 0,
                "exported": ["informer_events_total" in rendered,
                             "informer_watch_lag_ms" in rendered]}
    finally:
        inf.close()


SCRIPTS = {f.__name__: f for f in (list_then_watch, watch_lost_relist,
                                   outage_then_recovery, relist_diff_deletes,
                                   status_view)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_reflector_as_jax(name):
    got = SCRIPTS[name](tc.PORT)
    assert got == SCRIPTS[name](tc.JAX)
    if name == "outage_then_recovery":
        assert got["degraded"] == [("informer-degraded", "store-outage")] * 2


def _read_kv_script(pkg, active, start=True, health=None):
    P = pkg.keys.PREFIX
    counting = pkg.kv.CountingKV(pkg.kv.MemoryKV())
    key = f"{P}/containers/web/latest"
    counting.put(key, "3")
    registry = pkg.metrics.MetricsRegistry()
    inf = make_informer(pkg, counting, registry=registry)
    read_kv = pkg.informer.InformerReadKV(counting, inf, active=active,
                                          store_health=health)
    out = {}
    if start:
        inf.start()
    try:
        if start:
            wait_until(lambda: inf.synced, what="sync")
        before = counting.snapshot()
        out["reads"] = [(read_kv.get(key),
                         read_kv.range_prefix(f"{P}/containers/"))
                        for _ in range(5)]
        out["keys"] = read_kv.keys_prefix(f"{P}/containers/")
        with pytest.raises(pkg.errors.NotExistInStore):
            read_kv.get(f"{P}/containers/nope/latest")
        out["store_reads"] = pkg.kv.CountingKV.delta(before,
                                                     counting.snapshot())
        out["hits"] = registry.counter_value("informer_cache_hits_total")
        out["misses"] = registry.counter_value("informer_cache_misses_total")
        read_kv.put(f"{P}/w", "1")
        read_kv.apply([("put", f"{P}/w2", "2")])
        out["written"] = [counting.inner.get(f"{P}/w"),
                          counting.inner.get(f"{P}/w2")]
        read_kv.delete_prefix(f"{P}/w")
        out["deleted"] = counting.inner.get_or(f"{P}/w")
        return out
    finally:
        inf.close()


@pytest.mark.parametrize("role", ["standby", "standby-unsynced", "leader"])
def test_read_kv_routes_as_jax(role):
    def script(pkg):
        return _read_kv_script(pkg, active=lambda: role != "leader",
                               start=role != "standby-unsynced")

    got = script(tc.PORT)
    assert got == script(tc.JAX)
    if role == "standby":
        # served from the mirror: no store read at all
        assert not {"get", "range_prefix", "keys_prefix"} & set(
            got["store_reads"])
        assert got["hits"] >= 10
    else:
        assert got["hits"] == 0


def test_read_kv_serves_stale_in_a_store_outage():
    """In an outage the mirror answers even unsynced, for every role, and
    the read is marked stale for the HTTP layer to surface."""
    seen = {}
    for pkg in tc.PKGS:
        health = pkg.health.StoreHealth(fail_threshold=1, outage_grace_s=0.0)
        health.observe("get", 1.0, ok=False, error="down")
        assert health.mode == "outage"
        out = _read_kv_script(pkg, active=lambda: False, health=health)
        out["stale"] = pkg.health.consume_stale_read() is not None
        out["staleReads"] = health.status_view()["staleReads"]
        seen[pkg.name] = out
    assert seen["port"] == seen["jax"]
    assert seen["port"]["stale"] and seen["port"]["staleReads"] >= 10
