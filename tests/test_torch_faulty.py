"""The port's chaos tools — ``runtime/faulty.py`` (``FaultyRuntime``,
``FaultPlan``, ``FaultRule``, ``fail_nth``, ``InjectedFault``) and
``state/faulty.py`` (``FaultyKV``) — against the JAX package's on the CPU
(modeled on ``tests/test_faulty_runtime.py`` and the ``FaultyKV`` tier of
``tests/test_store_brownout.py``): the same plans over each package's
fake runtime and memory store fire on the same calls with the same modes
(fail, ambiguous, latency, unreachable, probabilistic from a seed), the
hard outage, the per-prefix partition and the latency window act alike,
and the call journals, outcomes and error classes are equal."""

import time

import pytest

import torch_control as tc


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001
        return ("raise", type(e).__name__)


def _runtime_script(pkg, root):
    f = pkg.faulty
    rt = f.FaultyRuntime(pkg.fake.FakeRuntime(root=root), f.FaultPlan())
    out = []
    rt.container_create(pkg.spec.ContainerSpec(name="t0", image="jax"))
    rt.add_rules([f.fail_nth("container_start", 2)])
    out += [_outcome(lambda: rt.container_start("t0")) for _ in range(3)]
    rt.clear_rules()
    rt.container_stop("t0")
    rt.add_rules([f.fail_nth("container_start", 5)])  # call 5: fail, no effect
    out.append(_outcome(lambda: rt.container_start("t0")))
    out.append(rt.inner.container_inspect("t0").running)
    rt.add_rules([f.fail_nth("container_start", 6, mode="ambiguous")])
    out.append(_outcome(lambda: rt.container_start("t0")))
    out.append(rt.inner.container_inspect("t0").running)  # effect landed
    rt.add_rules([f.FaultRule(op="container_stop", on_calls={2},
                              mode="latency", latency_s=0.01)])
    out.append(_outcome(lambda: rt.container_stop("t0")))
    rt.add_rules([f.fail_nth("container_exists", 1, mode="unreachable")])
    out.append(_outcome(lambda: rt.container_exists("t0")))
    rt.set_unreachable(True)
    out.append(_outcome(lambda: rt.container_list()))
    rt.set_unreachable(False)
    rt.add_rules([f.FaultRule(op="container_list", times=-1)])
    out += [_outcome(lambda: rt.container_list()) for _ in range(3)]
    rt.clear_rules()
    out.append(_outcome(lambda: rt.container_list()))
    rt.container_start("t0")
    rt.crash_container("t0")  # a FakeRuntime helper through the seam
    info = rt.container_inspect("t0")
    out.append((info.running, info.exit_code))
    out.append([rt.op_count(op) for op in ("container_create",
                                          "container_start",
                                          "container_stop")])
    out.append(list(rt.calls))
    with pytest.raises(ValueError):
        f.FaultRule(op="container_list", mode="explode")
    rt.close()
    return out


def test_runtime_faults_fire_as_jax_s(tmp_path):
    got = _runtime_script(tc.PORT, str(tmp_path / "port"))
    assert got == _runtime_script(tc.JAX, str(tmp_path / "jax"))
    assert got[:3] == [("ok", None), ("raise", "InjectedFault"),
                       ("ok", None)]


def _seeded_pattern(pkg, root, seed):
    f = pkg.faulty
    rt = f.FaultyRuntime(pkg.fake.FakeRuntime(root=root), f.FaultPlan(
        rules=[f.FaultRule(op="container_list", probability=0.5, times=-1)],
        seed=seed))
    pattern = [_outcome(rt.container_list)[0] for _ in range(20)]
    rt.close()
    return pattern


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_seeded_plan_replays_jax_s_pattern(seed, tmp_path):
    got = _seeded_pattern(tc.PORT, str(tmp_path / "p"), seed)
    assert got == _seeded_pattern(tc.JAX, str(tmp_path / "j"), seed)
    assert got == _seeded_pattern(tc.PORT, str(tmp_path / "p2"), seed)
    assert "raise" in got and "ok" in got


def _kv_script(pkg):
    kv = pkg.faultykv.FaultyKV(pkg.kv.MemoryKV())
    out = []
    kv.put("/a", "1")
    kv.fail_nth("get", 2)
    out += [_outcome(lambda: kv.get("/a")) for _ in range(3)]
    kv.fail_nth("put", 2, mode="ambiguous")
    out.append(_outcome(lambda: kv.put("/amb", "landed")))
    out.append(kv.inner.get("/amb"))
    kv.put("/q/a", "1")
    kv.put("/other", "2")
    kv.set_partition("/q/")
    out += [_outcome(lambda: kv.put("/q/b", "x")),
            _outcome(lambda: kv.range_prefix("/")),
            _outcome(lambda: kv.get("/other"))]
    kv.set_partition("/q/", active=False)
    out.append(_outcome(lambda: kv.get("/q/a")))
    w = kv.watch("/w/")
    kv.put("/w/a", "1")
    out.append([e.key for e in w.poll(0.01)])
    kv.set_outage(True)
    out += [_outcome(lambda: w.poll(0.01)), _outcome(lambda: kv.get("/w/a")),
            _outcome(lambda: kv.apply([("put", "/x", "1")])),
            kv.inner.get("/w/a")]
    kv.set_outage(False)
    out.append(w.poll(0.01))
    w.close()
    kv.set_latency(0.05)
    t0 = time.perf_counter()
    out.append(kv.get("/a"))
    out.append(time.perf_counter() - t0 >= 0.05)
    kv.set_latency(0.0)
    out.append(kv.current_rev() >= 1)
    out.append([c for c in kv.calls])
    return out


def test_faulty_kv_as_jax_s():
    got = _kv_script(tc.PORT)
    assert got == _kv_script(tc.JAX)
    assert got[:3] == [("ok", "1"), ("raise", "StoreUnavailable"),
                       ("ok", "1")]
    assert got[3:5] == [("raise", "StoreUnavailable"), "landed"]


def test_faulty_kv_reexports_the_runtime_vocabulary():
    assert tc.PORT.faultykv.FaultPlan is tc.PORT.faulty.FaultPlan
    assert tc.PORT.faultykv.FaultRule is tc.PORT.faulty.FaultRule
