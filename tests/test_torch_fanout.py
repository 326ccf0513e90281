"""The port's ``runtime/fanout.py`` against the JAX package's on the CPU:
the same batches through each package's ``Fanout`` give the same results
and the same contracts — results in submission order, an ``Exception``
collected into its result, a ``BaseException`` (the chaos kill) raised to
the caller after the batch settles, ``workers=1`` serial byte for byte
(stop at the first failure, the rest never dispatched), the
``fanout.mid_batch`` crash point, the ``runtime_calls_total`` /
``fanout_batches_total`` counters and the ``fanout_batch_ms`` histogram —
plus real overlap in parallel mode, thread-safe fakes under concurrent
calls, and the daemon's one pool with its ``/healthz`` view and gauges."""

import http.client
import json
import threading
import time

import pytest

import torch_control as tc


def _batch_script(pkg, workers):
    """One fixed script of batches: what each returned and raised."""
    err = pkg.errors.ApiError
    reg = pkg.metrics.MetricsRegistry()
    f = pkg.fanout.Fanout(workers, registry=reg)
    out = []
    ran = []

    def mk(i, fail=False):
        def fn():
            ran.append(i)
            if fail:
                raise err(f"call {i}")
            return i * 10
        return fn

    res = f.run([(str(i), "container_create", mk(i)) for i in range(6)])
    out.append([(r.key, r.ok, r.value, r.skipped) for r in res])
    ran.clear()
    res = f.run([("0", "container_stop", mk(0)),
                 ("1", "container_stop", mk(1, fail=True)),
                 ("2", "container_stop", mk(2)),
                 ("3", "container_stop", mk(3))])
    out.append([(r.key, r.ok, r.value, r.skipped,
                 type(r.error).__name__ if r.error else None) for r in res])
    out.append(sorted(ran))
    with pytest.raises(err):
        res[1].unwrap()
    if workers == 1:
        with pytest.raises(RuntimeError, match="skipped"):
            res[2].unwrap()
    out.append(f.run([]))
    view = f.status_view()
    out.append({k: view[k] for k in ("workers", "inflight", "batches",
                                     "calls")})
    out.append([reg.counter_value("runtime_calls_total",
                                  {"op": "container_create"}),
                reg.counter_value("runtime_calls_total",
                                  {"op": "container_stop"}),
                reg.counter_value("fanout_batches_total")])
    out.append("fanout_batch_ms_bucket" in reg.render())
    f.close()
    return out


@pytest.mark.parametrize("workers", [1, 4])
def test_batches_give_jax_s_results(workers):
    got = _batch_script(tc.PORT, workers)
    assert got == _batch_script(tc.JAX, workers)
    if workers == 1:
        # serial: the failure stops dispatch, the rest are skipped
        assert got[1][2:] == [("2", False, None, True, None),
                              ("3", False, None, True, None)]
        assert got[2] == [0, 1]
    else:
        assert got[2] == [0, 1, 2, 3]


def test_serial_preserves_submission_order():
    for pkg in tc.PKGS:
        order = []
        pkg.fanout.Fanout(1).run([(str(i), "op", lambda i=i: order.append(i))
                                  for i in range(5)])
        assert order == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("workers", [1, 4])
def test_base_exception_reaches_the_caller(workers):
    """A BaseException is never swallowed into a result: the kill -9
    model needs it to reach the caller, after the batch settled."""
    outcomes = {}
    for pkg in tc.PKGS:
        class Kill(BaseException):
            pass

        done = []

        def die():
            raise Kill()

        def slow():
            time.sleep(0.02)
            done.append("c")
            return 3

        f = pkg.fanout.Fanout(workers)
        with pytest.raises(Kill):
            f.run([("a", "op", lambda: 1), ("b", "op", die), ("c", "op", slow)])
        f.close()
        outcomes[pkg.name] = list(done)
    assert outcomes["port"] == outcomes["jax"]
    # serial: never dispatched after the kill; parallel: settled first
    assert outcomes["port"] == ([] if workers == 1 else ["c"])


@pytest.mark.parametrize("workers", [1, 4])
def test_mid_batch_crash_point(workers):
    """``fanout.mid_batch`` fires once the first call settles: serial mode
    never dispatches the rest, parallel mode awaits the calls in flight."""
    outcomes = {}
    for pkg in tc.PKGS:
        ran = []
        f = pkg.fanout.Fanout(workers)
        with pkg.crash.armed("fanout.mid_batch"):
            with pytest.raises(pkg.crash.SimulatedCrash):
                f.run([(str(i), "op", lambda i=i: ran.append(i))
                       for i in range(3)])
        assert f.inflight() == 0
        f.close()
        outcomes[pkg.name] = sorted(ran)
    assert outcomes["port"] == outcomes["jax"]
    if workers == 1:
        assert outcomes["port"] == [0]


def test_parallel_actually_overlaps():
    """4 calls × 80 ms sleeps on 4 workers take about one sleep."""
    f = tc.PORT.fanout.Fanout(4)
    t0 = time.perf_counter()
    f.run([(str(i), "op", lambda: time.sleep(0.08)) for i in range(4)])
    wall = time.perf_counter() - t0
    f.close()
    assert wall < 0.25, f"no overlap: {wall:.3f}s for 4x80ms"


def test_serial_default_is_unregistered_and_one_worker():
    assert tc.PORT.fanout.SERIAL.workers == tc.JAX.fanout.SERIAL.workers == 1


def _thread_safe_fakes(pkg):
    out = {}
    rt = pkg.faulty.FaultyRuntime(pkg.fake.FakeRuntime(),
                                  pkg.faulty.FaultPlan())
    threads = [threading.Thread(target=lambda i=i: [
        rt.container_exists(f"c{i}-{k}") for k in range(4)])
        for i in range(50)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["journal"] = (len(rt.calls), rt.op_count("container_exists"))
    rt = pkg.faulty.FaultyRuntime(pkg.fake.FakeRuntime(), pkg.faulty.FaultPlan(
        rules=[pkg.faulty.FaultRule(op="container_list",
                                    on_calls=frozenset(), times=1)]))
    failures = []

    def lister():
        try:
            rt.container_list()
        except Exception as e:  # noqa: BLE001
            failures.append(e)

    threads = [threading.Thread(target=lister) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["fired"] = (len(failures), len([c for c in rt.calls
                                        if c[2] == "fail"]))
    rt = pkg.fake.FakeRuntime()
    threads = [threading.Thread(target=lambda i=i: (
        rt.container_create(pkg.spec.ContainerSpec(name=f"c{i}", image="x")),
        rt.container_start(f"c{i}"), rt.container_stop(f"c{i}"),
        rt.container_remove(f"c{i}"))) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["fake"] = (rt.container_list(), len(rt.calls))
    return out


def test_fakes_are_thread_safe_as_jax_s():
    got = _thread_safe_fakes(tc.PORT)
    assert got == _thread_safe_fakes(tc.JAX)
    assert got == {"journal": (200, 200), "fired": (1, 1), "fake": ([], 96)}


def test_daemon_builds_one_pool_and_surfaces_it(tmp_path):
    """``fanout_workers`` sizes the daemon's one pool, which the
    reconciler gets; ``/healthz`` carries its view and ``/metrics`` its
    gauges, as JAX's daemon does."""
    views = {}
    for pkg in tc.PKGS:
        kv = pkg.kv.MemoryKV()
        prg = tc.boot(pkg, kv, pkg.fake.FakeRuntime(
            root=str(tmp_path / pkg.name)), fanout_workers=3, port=0)
        prg.cfg.reconcile_on_start = False
        prg.start()
        try:
            assert prg.reconciler._fanout is prg.fanout
            conn = http.client.HTTPConnection(
                "127.0.0.1", prg.api_server.port, timeout=10)
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())["data"]
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.close()
        finally:
            prg.stop()
        views[pkg.name] = (health["fanout"], "fanout_workers 3" in text,
                           "fanout_inflight 0" in text)
    assert views["port"] == views["jax"]
    assert views["port"][0]["workers"] == 3 and views["port"][1:] == (
        True, True)
