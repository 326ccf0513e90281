"""The port's state layer, errors and tracer against the JAX package's on
the CPU: ``state/kv.py`` (``MemoryKV``, ``SqliteKV``) driven by the same
seeded scripts of puts, gets, deletes, prefix deletes, guarded batches,
pages and watches gives the same values, revisions, events and error
classes; ``state/keys.py`` the same keys; ``errors.py`` the same classes
and codes; ``telemetry/trace.py`` the same span tree for one nested
call."""

import inspect

import numpy as np
import pytest

from tpu_docker_api import errors as jerrors
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.telemetry import trace as jtrace
from tpu_docker_api_torch import errors as terrors
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.telemetry import trace as ttrace

KEYS = ["/a/0", "/a/1", "/a/10", "/a/2", "/b/0", "/b/1", "/ab", "/c"]
PREFIXES = ["/a/", "/a", "/b/", "/", "/zz"]
RETAIN = 12  # small, so scripts trim the watch log and expire pages


def _open(mod, backend, tmp_path, tag):
    if backend == "memory":
        return mod.MemoryKV(log_retain=RETAIN)
    return mod.SqliteKV(str(tmp_path / f"{tag}.db"), log_retain=RETAIN,
                       trim_every=3)


def _script(seed: int, n: int = 120) -> list[tuple]:
    """A seeded op list; values and guards are drawn from what a store
    plausibly holds, so about half the guards pass."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        k = KEYS[rng.integers(len(KEYS))]
        p = PREFIXES[rng.integers(len(PREFIXES))]
        v = f"v{rng.integers(4)}"
        kind = rng.choice(["put", "get", "delete", "delete_prefix", "apply",
                           "cas", "range", "keys", "page", "rev", "poll"],
                          p=[.2, .1, .08, .04, .14, .08, .08, .08, .1, .04,
                             .06])
        if kind == "apply":
            batch = [("put", KEYS[rng.integers(len(KEYS))], f"v{j}")
                     for j in range(rng.integers(0, 3))]
            if rng.random() < .3:
                batch.append(("delete", KEYS[rng.integers(len(KEYS))]))
            guards = [("value", k, None if rng.random() < .4 else v)
                      for _ in range(rng.integers(0, 2))]
            ops.append(("apply", batch, guards))
        elif kind == "cas":
            ops.append(("cas", k, None if rng.random() < .3 else v, f"c{i}"))
        elif kind == "keys":
            ops.append(("keys", p, int(rng.integers(0, 3)),
                        KEYS[rng.integers(len(KEYS))]
                        if rng.random() < .5 else ""))
        elif kind == "page":
            ops.append(("page", p, int(rng.integers(1, 3)),
                        KEYS[rng.integers(len(KEYS))]
                        if rng.random() < .5 else "",
                        int(rng.integers(0, 3))))  # 0: now, else now - r
        else:
            ops.append((kind, k, p, v))
    return ops


def _run(kv, script) -> list:
    """Each op's outcome: its result, or its error's class name."""
    out = []
    watch = kv.watch("/a", 0)
    for op in script:
        try:
            kind = op[0]
            if kind == "put":
                res = kv.put(op[1], op[3])
            elif kind == "get":
                res = kv.get(op[1])
            elif kind == "delete":
                res = kv.delete(op[1])
            elif kind == "delete_prefix":
                res = kv.delete_prefix(op[2])
            elif kind == "apply":
                res = kv.apply(op[1], guards=op[2])
            elif kind == "cas":
                res = kv.cas(op[1], op[2], op[3])
            elif kind == "range":
                res = kv.range_prefix_with_rev(op[2])
            elif kind == "keys":
                res = kv.keys_prefix(op[1], limit=op[2], start_after=op[3])
            elif kind == "page":
                at = max(kv.current_rev() - op[4], 1) if op[4] else 0
                res = kv.range_prefix_page(op[1], op[2], start_after=op[3],
                                           at_rev=at)
            elif kind == "rev":
                res = (kv.current_rev(), kv.get_or(op[1], "absent"))
            else:
                res = [tuple(e) for e in watch.poll(0.0)]
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            res = type(e).__name__
            if kind == "poll":
                watch = kv.watch("/a", kv.current_rev())
        out.append(res)
    out.append(("final", kv.range_prefix(""), kv.current_rev()))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
@pytest.mark.parametrize("seed", range(5))
def test_kv_scripts_match_jax(tmp_path, backend, seed):
    script = _script(seed)
    want = _run(_open(jkv, backend, tmp_path, "jax"), script)
    got = _run(_open(tkv, backend, tmp_path, "port"), script)
    assert got == want
    kinds = {r for r in want if isinstance(r, str)}
    assert "NotExistInStore" in kinds and "GuardFailed" in kinds


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_watch_from_a_compacted_revision_is_lost_in_both(tmp_path, backend):
    outcomes = []
    for mod, tag in ((jkv, "jax"), (tkv, "port")):
        kv = _open(mod, backend, tmp_path, tag)
        for i in range(3 * RETAIN):
            kv.put(f"/a/{i % 5}", str(i))
        with pytest.raises(Exception) as lost:
            kv.watch("/a/", 1).poll(0.0)
        w = kv.watch("/a/", kv.current_rev())
        kv.delete_prefix("/a/")
        outcomes.append((type(lost.value).__name__,
                         [tuple(e) for e in w.poll(0.5)]))
        kv.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == "WatchLost" and len(outcomes[1][1]) == 5


def test_sqlite_watch_crosses_instances_on_one_file(tmp_path):
    """Two port stores on one file, as two daemons share one: the second
    one's watch sees the first one's commits, revisions included."""
    a = tkv.SqliteKV(str(tmp_path / "shared.db"))
    b = tkv.SqliteKV(str(tmp_path / "shared.db"))
    w = b.watch("/x/", b.current_rev())
    a.apply([("put", "/x/1", "one"), ("put", "/y", "no")])
    a.delete("/x/1")
    events = w.poll(1.0)
    events += w.poll(0.2)
    assert [(e.op, e.key, e.value) for e in events] == [
        ("put", "/x/1", "one"), ("delete", "/x/1", None)]
    assert events[-1].rev == a.current_rev() == b.current_rev()
    a.close()
    b.close()


def test_open_store_refuses_etcd_by_name(tmp_path):
    # etcd is ported: an unreachable address fails the dial, typed
    with pytest.raises(terrors.StoreUnavailable):
        tkv.open_store("etcd", etcd_addr="http://127.0.0.1:9")
    with pytest.raises(ValueError, match="unknown store backend"):
        tkv.open_store("redis")
    assert isinstance(tkv.open_store("memory"), tkv.MemoryKV)
    kv = tkv.open_store("sqlite", sqlite_path=str(tmp_path / "s.db"),
                        op_deadline_s=0.5)
    assert isinstance(kv, tkv.SqliteKV) and kv._busy_timeout_s == 0.5
    kv.close()


def _api_errors(mod) -> dict:
    return {name: (cls.code, cls.http_status, [b.__name__
                                               for b in cls.__mro__[1:-3]])
            for name, cls in inspect.getmembers(mod, inspect.isclass)
            if issubclass(cls, mod.ApiError)}


def test_every_error_class_has_jax_code():
    want = _api_errors(jerrors)
    assert _api_errors(terrors) == want
    assert want["ChipNotEnough"][0] == 10601
    assert want["PortNotEnough"][0] == 10602
    assert want["TopologyUnknown"][0] == 10603
    assert terrors.HOST_PATH_ERRORS == (terrors.HostUnreachable, OSError)
    assert terrors.StoreDegraded("x", retry_after_s=2.5).retry_after_s == 2.5


@pytest.mark.parametrize("value", [3, 3.0, 3.9, True, "3", None, float("nan"),
                                   float("inf"), -7, 2**70])
def test_request_coercion_matches_jax(value):
    for fn in ("as_int", "as_float"):
        outcomes = []
        for mod in (jerrors, terrors):
            try:
                outcomes.append(getattr(mod, fn)(value, "field"))
            except mod.BadRequest as e:
                outcomes.append(("BadRequest", str(e)))
        assert outcomes[0] == outcomes[1]


def test_keys_match_jax():
    consts = {n: getattr(jkeys, n) for n in dir(jkeys)
              if n.isupper() and isinstance(getattr(jkeys, n), str)}
    assert consts and consts == {n: getattr(tkeys, n) for n in consts}
    assert tkeys.SCHEDULER_CHIPS_KEY == "/apis/v1/scheduler/chips"
    assert tkeys.SCHEDULER_PORTS_KEY == "/apis/v1/scheduler/ports"
    for name in ("train", "train-3", "a-b-12", "x-", "job-1#s0", "-4"):
        for fn in ("split_versioned_name", "job_owner_base"):
            assert getattr(tkeys, fn)(name) == getattr(jkeys, fn)(name)
    for res in jkeys.Resource:
        tres = tkeys.Resource(res.value)
        for fn, args in (("family_prefix", ("b",)), ("version_key", ("b", 7)),
                         ("latest_key", ("b",)), ("family_key", ("b-3",))):
            assert (getattr(tkeys, fn)(tres, *args)
                    == getattr(jkeys, fn)(res, *args))
    assert [r.value for r in tkeys.Resource] == [r.value
                                                 for r in jkeys.Resource]


def _tree(mod, kv_mod):
    """One nested call under a root span: two children, a traced
    function, a failing child, and a KV batch; the span tree as (name,
    parent's name, status, attrs, isRoot) in start order."""
    tracer = mod.Tracer(buffer_size=8)

    @mod.traced("work.fn")
    def fn():
        with mod.child("work.inner", depth=2):
            pass

    kv = kv_mod.MemoryKV()
    with tracer.span("root", attrs={"requestId": "r1"}) as root:
        with mod.child("a", x=1):
            fn()
        with pytest.raises(ValueError):
            with mod.child("b"):
                raise ValueError("no")
        kv.apply([("put", "/k", "v")], guards=[("value", "/k", None)])
    view = tracer.trace_view(root.trace_id)
    names = {s["spanId"]: s["name"] for s in view["spans"]}
    tree = [(s["name"], names.get(s["parentId"], ""), s["status"],
             s["attrs"], s["isRoot"]) for s in view["spans"]]
    summary = tracer.summaries()
    return tree, sorted(summary), sorted(summary["items"][0]), \
        tracer.find_by_request_id("r1")["traceId"] == root.trace_id


def test_trace_span_tree_matches_jax():
    want = _tree(jtrace, jkv)
    assert _tree(ttrace, tkv) == want
    assert [t[0] for t in want[0]] == ["root", "a", "work.fn", "work.inner",
                                       "b", "kv.apply"]
    assert ttrace.parse_traceparent("00-" + "a" * 32 + "-" + "b" * 16
                                    + "-01") == ("a" * 32, "b" * 16)
