"""The port's ``EtcdKV`` (``state/kv.py``, over the standard library's
``http.client``) against the JAX package's (over ``requests``) on the CPU:
each package's store talks to its own copy of the in-repo etcd
grpc-gateway fake (``tests/etcd_gateway.py``, bytes-level etcd semantics
over real HTTP), and both are fed the same script. Covered: the KV
contract (base64 keys and values, byte-interval prefix ranges, the
all-0xff sentinel, keys-only and paged ranges, revisions, strict value
decoding), native txns with guards and etcd's duplicate-key rule, the
``/v3/watch`` stream (one revision per txn, per-key delete expansion,
prefix filtering, compaction as WatchLost, the stream dying as
StoreUnavailable, a cancel that leaves no reader blocked), outage
normalization (reads retried with backoff, writes and txns never), the
dial at construction, ``CountingKV``'s round-trip counts, and a daemon
booted on etcd. Results, error classes, gateway-side request counts and
the bytes each gateway holds must be equal."""

import threading
import time

import pytest

import torch_control as tc
from etcd_gateway import start_gateway, stop_gateway

pytest.importorskip("requests")  # the JAX package's EtcdKV needs it


@pytest.fixture(scope="module")
def gateways():
    servers = {pkg.name: start_gateway()[0] for pkg in tc.PKGS}
    yield servers
    for server in servers.values():
        stop_gateway(server)


@pytest.fixture()
def gw(gateways):
    """Both gateways, emptied: one per package, shared by the module."""
    for s in gateways.values():
        s.store.clear()
        s.events.clear()
        s.rev = s.compacted = s.fail_next = s.fail_seen = s.txn_count = 0
    return gateways


def _kv(pkg, gw, **kw):
    server = gw[pkg.name]
    return pkg.kv.EtcdKV(f"http://127.0.0.1:{server.server_address[1]}",
                         **kw)


def _outcome(fn):
    """A call's value or the class of what it raised; HTTP refusals read
    alike (``requests.HTTPError`` in JAX, ``EtcdHTTPError`` in the port)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001
        name = type(e).__name__
        return ("raise", "HTTPError" if name in ("HTTPError",
                                                 "EtcdHTTPError") else name)


def _both(script, gw, **kw):
    out = {}
    for pkg in tc.PKGS:
        kv = _kv(pkg, gw, **kw)
        try:
            out[pkg.name] = script(pkg, kv, gw[pkg.name])
        finally:
            kv.close()
    assert out["port"] == out["jax"]
    return out["port"]


def contract(pkg, kv, server):
    out = []
    kv.put("/apis/v1/containers/foo/3", '{"spec": 1}')
    out.append(kv.get("/apis/v1/containers/foo/3"))
    out.append(b"/apis/v1/containers/foo/3" in server.store)
    out.append(_outcome(lambda: kv.get("/nope")))
    out.append(kv.get_or("/nope", "dflt"))
    kv.put("/k", "значение ☃")
    out.append(kv.get("/k"))
    kv.delete("/k")
    kv.delete("/k")  # absent: no error, etcd semantics
    out.append(_outcome(lambda: kv.get("/k")))
    for k, v in [("/apis/v1/containers/foo/0", "a"),
                 ("/apis/v1/containers/foo/1", "b"),
                 ("/apis/v1/containers/foobar/0", "c"),
                 ("/apis/v1/containers/fop", "d"),
                 ("/apis/v1/volumes/foo/0", "e")]:
        kv.put(k, v)
    out.append(kv.range_prefix("/apis/v1/containers/foo"))
    out.append(kv.range_prefix("/apis/v1/containers/foo/"))
    out.append(kv.keys_prefix("/apis/v1/containers/"))
    out.append(kv.keys_prefix("/apis/v1/containers/", limit=2,
                              start_after="/apis/v1/containers/foo/0"))
    page, rev = kv.range_prefix_page("/apis/v1/containers/", 2)
    out.append(page)
    out.append(kv.range_prefix_page("/apis/v1/containers/", 2,
                                    start_after=max(page), at_rev=rev))
    kv.put("/apis/v1/containers/zzz", "moved")
    out.append(_outcome(lambda: kv.range_prefix_page(
        "/apis/v1/containers/", 2, start_after=max(page), at_rev=rev)))
    out.append(kv.range_prefix_with_rev("/apis/v1/volumes/"))
    out.append(kv.current_rev())
    kv.delete_prefix("/apis/v1/containers/foo/")
    out.append(kv.range_prefix("/apis/v1/"))
    kv.put("a", "1")
    kv.put("\udcff\udcff", "2")  # raw bytes ff ff on the wire
    out.append(server.store[b"\xff\xff"])
    out.append(kv.range_prefix("\udcff"))
    server.store[b"/corrupt"] = b"\xff\xfe binary"
    out.append(_outcome(lambda: kv.get("/corrupt")))
    out.append(sorted(server.store.items()))
    return out


def test_kv_contract_as_jax_s(gw):
    got = _both(contract, gw)
    assert got[6] == {"/apis/v1/containers/foo/0": "a",
                      "/apis/v1/containers/foo/1": "b",
                      "/apis/v1/containers/foo/3": '{"spec": 1}',
                      "/apis/v1/containers/foobar/0": "c"}
    assert got[12] == ("raise", "ContinueExpired")
    assert got[-2] == ("raise", "UnicodeDecodeError")


def test_prefix_helpers_are_jax_s():
    for s in ("abc", "a\udcff", "\udcff", "/apis/v1/", "é"):
        assert tc.PORT.kv._prefix_end(s) == tc.JAX.kv._prefix_end(s)
        assert tc.PORT.kv._b64(s) == tc.JAX.kv._b64(s)
        assert tc.PORT.kv._unb64_key(tc.PORT.kv._b64(s)) == s


def test_matches_memory_kv_semantics(gw):
    def script(pkg, kv, server):
        mem = pkg.kv.MemoryKV()
        for target in (kv, mem):
            for op, *args in [("put", "/c/a/0", "1"), ("put", "/c/a/1", "2"),
                              ("put", "/c/ab/0", "3"), ("delete", "/c/a/0"),
                              ("put", "/c/a/1", "2b")]:
                getattr(target, op)(*args)
            target.apply([("put", "/c/b/0", "4"), ("delete_prefix", "/c/a/")])
        return [(kv.range_prefix(p), mem.range_prefix(p))
                for p in ("/c/a", "/c/a/", "/c/", "/nope")]

    for etcd, mem in _both(script, gw):
        assert etcd == mem


def txns(pkg, kv, server):
    out = []
    kv.put("/f/old", "x")
    kv.put("/p/a", "1")
    kv.put("/p/b", "2")
    kv.apply([("put", "/f/v/0", "spec"), ("put", "/f/latest", "0"),
              ("delete", "/f/old"), ("delete_prefix", "/p/")])
    out.append(server.txn_count)  # the whole batch: ONE round trip
    out.append(kv.range_prefix("/"))
    out.append(_outcome(lambda: kv.apply([("put", "/g", "1")],
                                         guards=[("value", "/f/latest",
                                                  "9")])))
    out.append(kv.get_or("/g"))
    out.append(_outcome(lambda: kv.apply([("put", "/g", "1")],
                                         guards=[("value", "/f/latest", "0"),
                                                 ("value", "/absent", None)])))
    out.append(_outcome(lambda: kv.cas("/g", "1", "2")))
    out.append(_outcome(lambda: kv.cas("/g", "1", "3")))
    out.append(_outcome(lambda: kv.apply([("put", "/d", "1"),
                                          ("put", "/d", "2")])))
    out.append(kv.range_prefix("/"))
    out.append(server.txn_count)
    return out


def test_txns_as_jax_s(gw):
    got = _both(txns, gw)
    assert got[0] == 1
    assert got[2] == ("raise", "GuardFailed") and got[3] is None
    assert got[7] == ("raise", "HTTPError")  # etcd's duplicate-key rule


def _drain(w, n, timeout_s=5.0):
    out = []
    deadline = time.time() + timeout_s
    while len(out) < n and time.time() < deadline:
        out += w.poll(0.1)
    return out


def watches(pkg, kv, server):
    out = []
    w = kv.watch("/t/", kv.current_rev())
    kv.apply([("put", "/t/a", "1"), ("put", "/t/b", "2")])
    kv.put("/u/x", "filtered")
    kv.put("/t/c", "3")
    kv.delete_prefix("/t/")
    out.append([tuple(e) for e in _drain(w, 6)])
    w.close()
    out.append(w.poll(0.1))  # closed: quiet, not an error
    for i in range(5):
        kv.put(f"/t/k{i}", str(i))
    server.compacted = 3
    w = kv.watch("/t/", start_rev=1)
    lost = None
    deadline = time.time() + 5
    while lost is None and time.time() < deadline:
        try:
            w.poll(0.1)
        except Exception as e:  # noqa: BLE001
            lost = (type(e).__name__, "compact" in str(e))
    w.close()
    out.append(lost)
    server.compacted = 0
    snap, rev = kv.range_prefix_with_rev("/t/")
    w = kv.watch("/t/", rev)
    kv.put("/t/after", "1")
    out.append([(e.op, e.key, e.value) for e in _drain(w, 1)])
    w.close()
    return out


def test_watch_stream_as_jax_s(gw):
    got = _both(watches, gw)
    ops = [(op, key) for _, op, key, _ in got[0]]
    assert ops == [("put", "/t/a"), ("put", "/t/b"), ("put", "/t/c"),
                   ("delete", "/t/a"), ("delete", "/t/b"), ("delete", "/t/c")]
    assert got[0][0][0] == got[0][1][0]  # one txn, one revision
    assert got[2] == ("WatchLost", True)


def test_cancel_leaves_no_reader_blocked(gw):
    """A watch blocked mid-read on a quiet stream: close returns at once
    and the reader thread is gone — no socket left to a thread."""
    kv = _kv(tc.PORT, gw)
    try:
        def readers():
            return [t for t in threading.enumerate()
                    if t.name == "etcd-watch"]

        before = len(readers())
        ws = [kv.watch("/quiet/", 0) for _ in range(4)]
        time.sleep(0.1)  # every reader is parked in its read
        t0 = time.perf_counter()
        for w in ws:
            w.close()
        assert time.perf_counter() - t0 < 1.0
        assert not any(w._thread.is_alive() for w in ws)
        assert all(w.poll(0.05) == [] for w in ws)
        assert len(readers()) == before
    finally:
        kv.close()


def test_stream_death_is_store_unavailable():
    """The gateway going away mid-stream surfaces at the next poll as the
    typed StoreUnavailable in both packages (the consumer relists)."""
    seen = {}
    for pkg in tc.PKGS:
        server, _ = start_gateway()
        kv = pkg.kv.EtcdKV(f"http://127.0.0.1:{server.server_address[1]}")
        w = kv.watch("/t/", kv.current_rev())
        stop_gateway(server)
        err = None
        deadline = time.time() + 5
        while err is None and time.time() < deadline:
            try:
                w.poll(0.1)
            except Exception as e:  # noqa: BLE001
                err = type(e).__name__
        w.close()
        kv.close()
        seen[pkg.name] = err
    assert seen["port"] == seen["jax"] == "StoreUnavailable"


def outages(pkg, kv, server):
    out = []
    kv.put("/k", "v")
    server.fail_next = 2  # two aborted requests, then healthy
    out.append((_outcome(lambda: kv.get("/k")), server.fail_seen))
    server.fail_next, server.fail_seen = 10, 0  # longer than the budget
    out.append((_outcome(lambda: kv.get("/k")), server.fail_seen))
    server.fail_next, server.fail_seen = 0, 0
    kv.put("/p/a", "1")
    server.fail_next = 1
    out.append((_outcome(lambda: kv.range_prefix("/p/")), server.fail_seen))
    server.fail_next, server.fail_seen = 1, 0
    out.append((_outcome(lambda: kv.put("/w", "1")), server.fail_seen,
                server.fail_next, kv.get_or("/w")))
    server.fail_next, server.fail_seen = 1, 0
    out.append((_outcome(lambda: kv.apply([("put", "/w", "1")])),
                server.fail_seen, server.fail_next, kv.get_or("/w")))
    out.append(_outcome(lambda: kv.get("/absent")))
    return out


def test_outages_normalize_as_jax_s(gw):
    got = _both(outages, gw, retry_attempts=3, retry_base_s=0.001,
                retry_max_s=0.01)
    assert got[0] == (("ok", "v"), 2)  # reads retry through a blip
    assert got[1] == (("raise", "StoreUnavailable"), 3)  # bounded
    # writes and txns: normalized, never retried
    assert got[3] == (("raise", "StoreUnavailable"), 1, 0, None)
    assert got[4] == (("raise", "StoreUnavailable"), 1, 0, None)
    assert got[5] == ("raise", "NotExistInStore")


def test_dial_fails_fast_and_typed():
    for pkg in tc.PKGS:
        t0 = time.perf_counter()
        with pytest.raises(pkg.errors.StoreUnavailable):
            pkg.kv.EtcdKV("http://127.0.0.1:9")  # connection refused
        assert time.perf_counter() - t0 < 2.5
    with pytest.raises(ValueError):
        tc.PORT.kv.EtcdKV("127.0.0.1:2379")  # no scheme


def counting(pkg, kv, server):
    c = pkg.kv.CountingKV(kv)
    store = pkg.store.StateStore(c)
    versions = pkg.version.VersionMap(c, pkg.keys.VERSIONS_CONTAINER_KEY)
    before = c.snapshot()
    snap, rev = c.range_prefix_with_rev("/c/")
    w = c.watch("/c/", rev)
    for i in range(5):
        c.put(f"/c/k{i}", str(i))
    events = len(_drain(w, 5))
    w.close()
    c.apply([("put", "/c/x", "1"), ("delete_prefix", "/c/k")])
    versions.set("t", 0)
    c.get_or("/c/x")
    c.keys_prefix("/c/")
    c.range_prefix_page("/c/", 10)
    out = [events, pkg.kv.CountingKV.delta(before, c.snapshot()), c.reads(),
           store.history(pkg.keys.Resource.CONTAINERS, "t")]
    return out


def test_counting_kv_round_trips_as_jax_s(gw):
    got = _both(counting, gw)
    assert got[0] == 5
    assert got[1]["watch"] == 1 and got[1]["apply"] >= 1


def test_daemon_on_etcd_as_jax(gw, tmp_path):
    """``open_store("etcd", ...)`` with the retry and deadline keys, a
    daemon on it: a container run, crashed and repaired by the reconciler
    leaves the same keys in each gateway."""
    seen = {}
    for pkg in tc.PKGS:
        server = gw[pkg.name]
        kv = pkg.kv.open_store(
            "etcd", etcd_addr=f"http://127.0.0.1:{server.server_address[1]}",
            retry_attempts=2, retry_base_s=0.001, retry_max_s=0.01,
            op_deadline_s=0.5)
        assert kv._op_timeout_s == 0.5
        rt = pkg.fake.FakeRuntime(root=str(tmp_path / pkg.name))
        prg = tc.boot(pkg, kv, rt)
        prg.container_svc.run_container(pkg.c.ContainerRun(
            image_name="i", container_name="t", chip_count=2,
            container_ports=[pkg.c.ContainerPort(80)]))
        rt.crash_container("t-0")
        report = prg.reconciler.reconcile()
        seen[pkg.name] = {"report": tc.shape(report),
                          "world": tc.prg_world(prg),
                          "keys": sorted(server.store),
                          "invariants": tc.invariants(pkg, prg)}
        prg.stop()
    assert seen["port"] == seen["jax"]
    assert seen["port"]["invariants"] == []
    assert [a["action"] for a in seen["port"]["report"]["actions"]] == [
        "restart-dead"]


def test_threads_share_a_bounded_pool(gw):
    """Many short-lived threads through one EtcdKV (the daemon's request
    threads, one a client connection), more at once than the pool holds:
    every write reads back, no request fails, and however many threads
    come and go, the connections left open are at most the pool's size."""
    import sys

    kv = _kv(tc.PORT, gw, op_deadline_s=5.0)
    assert tc.PORT.kv.EtcdKV.POOL_SIZE == 10  # a requests.Session's
    # a small pool, so a wave both reuses idle connections and dials (and
    # closes again) the ones the pool cannot keep
    kv.POOL_SIZE = 3
    errors_seen = []
    n_waves, n_threads, n_ops = 4, 6, 4

    def worker(w, i, go, started):
        try:
            go.wait(30)
            for k in range(n_ops):
                kv.put(f"/s/{w}/{i}/{k}", f"{i}.{k}")
                started.set()
                assert kv.get(f"/s/{w}/{i}/{k}") == f"{i}.{k}"
        except Exception as e:  # noqa: BLE001
            errors_seen.append(e)
        finally:
            started.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for w in range(n_waves):
            # each thread starts once the one before it has a reply: the
            # fake gateway's listen backlog is 5, and a burst of dials past
            # it is reset, which would be the gateway's fault, not the pool's
            gates = [threading.Event() for _ in range(n_threads + 1)]
            gates[0].set()
            threads = [threading.Thread(target=worker,
                                        args=(w, i, gates[i], gates[i + 1]))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert len(kv._conns) <= kv.POOL_SIZE
    finally:
        sys.setswitchinterval(old)
    try:
        assert errors_seen == []
        assert len(kv.range_prefix("/s/")) == n_waves * n_threads * n_ops
        assert len(kv._conns) <= kv.POOL_SIZE
        assert len(kv._idle) == len(kv._conns)  # nothing busy is left open
    finally:
        kv.close()
    assert kv._conns == set() and kv._idle == []
