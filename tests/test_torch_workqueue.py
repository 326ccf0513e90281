"""The port's durable work queue (``state/workqueue.py``) against the JAX
package's on the CPU: the same submits, handlers and faults give the same
runs, journal, stats, dead letters and error classes — submit and
dedup, replay after a ``SimulatedCrash`` at each ``queue.*`` boundary,
the backoff schedule, dead letters and their operator-retry budget,
saturation and shutdown. Task ids are random in both, so they are
renamed in order of appearance before comparing."""

import json
import re
import types

import pytest

from tpu_docker_api import errors as jerrors
from tpu_docker_api.service import crashpoints as jcrash
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.state import workqueue as jwq
from tpu_docker_api.utils import backoff as jbackoff
from tpu_docker_api_torch import errors as terrors
from tpu_docker_api_torch.service import crashpoints as tcrash
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.state import workqueue as twq
from tpu_docker_api_torch.telemetry import metrics as tmetrics
from tpu_docker_api.telemetry import metrics as jmetrics
from tpu_docker_api_torch.utils import backoff as tbackoff

JAX = types.SimpleNamespace(wq=jwq, kv=jkv, keys=jkeys, crash=jcrash,
                            errors=jerrors, metrics=jmetrics)
PORT = types.SimpleNamespace(wq=twq, kv=tkv, keys=tkeys, crash=tcrash,
                             errors=terrors, metrics=tmetrics)
_ID = re.compile(r"\b[0-9a-f]{12}\b")


def _norm(obj):
    """Rename 12-hex task ids to t0, t1, ... in order of appearance."""
    names: dict[str, str] = {}
    text = json.dumps(obj, sort_keys=True, default=str)
    return json.loads(_ID.sub(
        lambda m: names.setdefault(m.group(0), f"t{len(names)}"), text))


def _journal(pkg, kv):
    return kv.range_prefix(pkg.keys.PREFIX + "/queue/")


def _queue(pkg, kv, **kw):
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("max_retries", 2)
    return pkg.wq.WorkQueue(kv, metrics=pkg.metrics.MetricsRegistry(), **kw)


def _run_lifecycle(pkg):
    kv = pkg.kv.MemoryKV()
    wq = _queue(pkg, kv, seed=0, dead_letter_retry_budget=2)
    ran, comp = [], []
    flaky = {"n": 0}

    def flaky_exec(rec):
        flaky["n"] += 1
        if flaky["n"] % 2:
            raise OSError("engine blip")
        ran.append(("flaky", rec.params))

    def poison(rec):
        raise ValueError(f"bad {rec.params['i']}")

    wq.register("probe", lambda rec: ran.append(("probe", rec.params)))
    wq.register("flaky", flaky_exec)
    wq.register("poison", poison, on_fail=lambda rec: comp.append(rec.kind))
    out = []
    ids = [wq.submit_record("probe", {"i": i}) for i in range(3)]
    ids.append(wq.submit_record("probe", {"i": 9}, idempotency_key="k"))
    ids.append(wq.submit_record("probe", {"i": 10}, idempotency_key="k"))
    ids.append(wq.submit_record("flaky", {"x": 1}))
    ids.append(wq.submit_record("poison", {"i": 1}))
    ids.append(wq.submit_record("nobody", {}))
    out.append(ids)
    out.append(_journal(pkg, kv))
    wq.start()
    wq.drain()
    out.append(ran)
    out.append(comp)
    stats = wq.stats()
    stats.pop("events")
    out.append(stats)
    out.append(wq.dead_letter_view())
    out.append(_journal(pkg, kv))
    for _ in range(4):
        try:
            out.append(wq.retry_dead_letters())
        except pkg.errors.ApiError as e:
            out.append((type(e).__name__, e.code, e.http_status))
        wq.drain()
        out.append(wq.dead_letter_view())
    out.append(wq._metrics.render())
    wq.close()
    out.append((wq.closed, _outcome(lambda: wq.submit_record("probe", {}))))
    return out


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__


def test_record_lifecycle_journal_and_dead_letters_match_jax():
    want = _norm(_run_lifecycle(JAX))
    got = _norm(_run_lifecycle(PORT))
    assert got == want
    assert got[0][3] == got[0][4]  # the keyed duplicate was absorbed
    assert got[4]["journal"] == {"entries": 2, "pending": 0, "inflight": 0,
                                 "dead": 2}
    assert ["RetryBudgetExhausted", 10803, 409] in got[7:15]
    assert got[-1] == [True, "QueueClosed"]


def _run_replay(pkg, label, tmp_path):
    kv = pkg.kv.MemoryKV()
    effects = []

    def copy(wq):
        def run(rec):
            if not wq.marker_done(rec.task_id):
                effects.append(("copy", rec.params["n"]))
                wq.mark_done(rec.task_id)
            effects.append(("start", rec.params["n"]))
        return run

    dead = _queue(pkg, kv)
    dead.register("copy", copy(dead))
    for n in range(3):
        dead.submit_record("copy", {"n": n})
    out = [_journal(pkg, kv)]
    with pkg.crash.armed(label, skip=1):
        try:
            dead.replay_journal(include_local=True)
            out.append("no crash")
        except pkg.crash.SimulatedCrash as e:
            out.append(e.label)
    out.append(list(effects))
    out.append(_journal(pkg, kv))
    # the daemon restarts over the same store: a fresh queue adopts the
    # journal and finishes every record exactly once in effect
    wq = _queue(pkg, kv)
    wq.register("copy", copy(wq))
    wq.start()
    out.append(wq.replay_journal())
    wq.drain()
    out.append(effects)
    out.append(_journal(pkg, kv))
    out.append(wq.dead_letter_view())
    wq.close()
    return out


@pytest.mark.parametrize("label", ["queue.claim", "queue.exec", "queue.ack"])
def test_replay_after_a_simulated_crash_matches_jax(label, tmp_path):
    want = _norm(_run_replay(JAX, label, tmp_path))
    got = _norm(_run_replay(PORT, label, tmp_path))
    assert got == want
    assert got[1] == label
    copies = [n for kind, n in map(tuple, got[5]) if kind == "copy"]
    assert sorted(copies) == [0, 1, 2]  # the marker: no copy ran twice
    assert got[6] == {} and got[7] == []


@pytest.mark.parametrize("seed", range(4))
def test_backoff_schedule_matches_jax(seed):
    import random

    for attempt in range(0, 70, 3):
        for jitter in (0.0, 0.25):
            a = jbackoff.backoff_delay_s(attempt, 0.05, 2.0, jitter,
                                         random.Random(seed))
            b = tbackoff.backoff_delay_s(attempt, 0.05, 2.0, jitter,
                                         random.Random(seed))
            assert a == b
    jq = jwq.WorkQueue(jkv.MemoryKV(), seed=seed)
    tq = twq.WorkQueue(tkv.MemoryKV(), seed=seed)
    assert ([jq.retry_delay_s(i) for i in range(8)]
            == [tq.retry_delay_s(i) for i in range(8)])


def _run_saturation(pkg):
    kv = pkg.kv.MemoryKV()
    wq = _queue(pkg, kv, capacity=1, submit_timeout_s=0.01)
    wq.register("probe", lambda rec: None)
    out = [wq.submit_record("probe", {"i": 0})]
    for _ in range(2):
        try:
            wq.submit_record("probe", {"i": 1})
        except pkg.errors.ApiError as e:
            out.append((type(e).__name__, e.code, e.http_status))
    out.append(_journal(pkg, kv))  # the refused record left no entry
    wq.start()
    wq.drain()
    out.append(_journal(pkg, kv))
    wq.close()
    try:
        wq.submit_record("probe", {})
    except pkg.errors.ApiError as e:
        out.append((type(e).__name__, e.code, e.http_status))
    out.append(wq.stats()["closed"])
    return out


def test_saturation_and_shutdown_match_jax():
    want = _norm(_run_saturation(JAX))
    got = _norm(_run_saturation(PORT))
    assert got == want
    assert got[1] == ["QueueSaturated", 10801, 429]
    assert got[-2] == ["QueueClosed", 10802, 503]
