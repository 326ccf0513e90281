"""The idle-by-range and device-by-range arithmetic of
``harness/phases.py`` on synthetic intervals and events; its readers on
runs with nothing to read; and the tiny CPU cells reading the program's
spans and counters."""

import json
import random
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench.harness import phases, spec
from portbench.harness.runner import run_cell
from portbench.harness.trace import summarize

SEED = 2**31 + 53


def test_nested_ranges_belong_to_the_innermost():
    opened = [(0.0, 10.0, "outer"), (2.0, 4.0, "inner"),
              (6.0, 8.0, "other"), (12.0, 13.0, "outer")]
    assert phases.innermost(opened) == [
        (0.0, 2.0, "outer"), (2.0, 4.0, "inner"), (4.0, 6.0, "outer"),
        (6.0, 8.0, "other"), (8.0, 10.0, "outer"), (12.0, 13.0, "outer")]


def test_ranges_opened_at_once_give_the_shorter():
    assert phases.innermost([(0.0, 5.0, "long"), (0.0, 2.0, "short")]) == [
        (0.0, 2.0, "short"), (2.0, 5.0, "long")]


def test_idle_includes_the_window_edges_and_clips_to_it():
    busy = [(-1.0, 0.5), (1.0, 2.0), (1.5, 2.5), (3.0, 5.0), (5.5, 9.0)]
    assert phases.idle_intervals(busy, 0.0, 6.0) == [
        (0.5, 1.0), (2.5, 3.0), (5.0, 5.5)]
    assert phases.idle_intervals([(1.0, 2.0)], 0.0, 3.0) == [
        (0.0, 1.0), (2.0, 3.0)]
    assert phases.idle_intervals([], 0.0, 3.0) == [(0.0, 3.0)]


def test_idle_by_owner_on_nested_ranges():
    pieces = phases.innermost([(0.0, 10.0, "outer"), (2.0, 4.0, "inner")])
    idle = phases.idle_intervals([(1.0, 3.0), (5.0, 9.0)], 0.0, 12.0)
    assert idle == [(0.0, 1.0), (3.0, 5.0), (9.0, 12.0)]
    got = phases.overlap_by_owner(idle, pieces)
    assert got == pytest.approx({"outer": 1.0 + 1.0 + 1.0, "inner": 1.0})


@pytest.mark.parametrize("seed", range(5))
def test_shares_sum_to_no_more_than_idle(seed):
    """Random ranges, nested, on two threads and over the window's
    edges, over random device operations: the ranges' idle shares sum to
    at most the window's idle share, as ``trace.summarize`` reads it."""
    rng = random.Random(seed)
    window = 100.0
    events, names = [], ("a", "b", "c")
    for i in range(40):
        a = rng.uniform(-5, window)
        events.append(_event(rng.choice(names), a, a + rng.uniform(0.1, 20),
                             thread=rng.choice((1, 2))))
    shift = rng.uniform(0, 2)       # the window's start on the trace
    for i in range(60):
        a = rng.uniform(5, window - 5) + shift
        events.append(_event("k", a, a + rng.uniform(0.01, 3),
                             device=DeviceType.CUDA, id=1000 + i))
    red = phases.by_range(events, window, names)
    shares = [red["idle_s"][n] / red["window_s"] for n in names]
    idle_share = summarize(events, red["window_s"])["idle_share"]
    assert all(s >= 0 for s in shares)
    assert sum(shares) <= idle_share + 1e-9


def _event(name, start, end, *, device=DeviceType.CPU, id=0, thread=1):
    """A profiler event at times in seconds (the profiler's are in
    microseconds)."""
    s, e = start * 1e6, end * 1e6
    return SimpleNamespace(
        name=name, device_type=device, id=id, thread=thread,
        is_user_annotation=False, input_shapes=[],
        time_range=SimpleNamespace(start=s, end=e, elapsed_us=lambda: e - s))


def test_device_time_goes_to_the_range_open_at_its_launch():
    """A kernel belongs to the range open when the CUDA API call of its own
    id ran, on any thread; a framework op with the same id (the two are
    counted apart) does not decide it; one with no CUDA API call, or
    launched outside every range, counts nowhere."""
    cuda = DeviceType.CUDA
    events = [
        _event("train_step.backward", 1.0, 10.0),
        _event("aten::mm", 2.0, 3.0, id=7, thread=2),
        _event("cudaLaunchKernel", 2.2, 2.3, id=501, thread=2),
        _event("gemm", 4.0, 6.0, device=cuda, id=501),
        _event("train_step.optimizer", 11.0, 12.0),
        _event("aten::add", 11.2, 11.4, id=503),
        _event("cuLaunchKernelEx", 11.5, 11.6, id=502),
        _event("adam8_kernel", 12.0, 12.5, device=cuda, id=502),
        _event("cudaLaunchKernel", 8.0, 8.1, id=503, thread=2),
        _event("add_kernel", 9.5, 9.9, device=cuda, id=503),
        _event("orphan_kernel", 9.6, 9.7, device=cuda, id=600),
        _event("cudaLaunchKernel", 13.0, 13.1, id=504),
        _event("late_kernel", 13.5, 14.0, device=cuda, id=504),
    ]
    red = phases.by_range(events, 15.0, phases.STEP)
    assert red["device_s"] == pytest.approx({
        "train_step.forward": 0.0, "train_step.backward": 2.4,
        "train_step.optimizer": 0.5})
    assert red["count"] == {"train_step.forward": 0,
                            "train_step.backward": 1,
                            "train_step.optimizer": 1}


class _Window:
    """A stand-in for ``trace.Window`` over synthetic events."""

    def __init__(self, events, window_s):
        self.prof = SimpleNamespace(events=lambda: events)
        self.window_s = window_s


def _serving_run(window, handles=(), stats=None):
    stats = stats or {"decode_chunks": 0}
    return SimpleNamespace(rec={
        "window": window, "t0": 0.0, "t_end": 10.0, "stats0": stats,
        "stats1": stats,
        "sent": [SimpleNamespace(handle=h) for h in handles]})


READERS = {
    "idle_in_admit.chat": lambda r: phases.idle_in(r, phases.ADMIT),
    "idle_in_launch.chat": lambda r: phases.idle_in(r, phases.LAUNCH),
    "idle_in_process.chat": lambda r: phases.idle_in(r, phases.PROCESS),
    "optimizer_ms.train": phases.optimizer_ms,
    "decode_launch_ms.chat": phases.decode_launch_ms,
    "queue_wait_ms.chat": phases.queue_wait_ms,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_run_without_a_trace_or_the_program_s_spans_reads_none(name):
    """No trace (a ``--trace 0`` run); a trace of a program that opens
    none of the ranges, on the CPU (no device operations) or with them;
    an engine without the counter or the stamp."""
    old_handle = SimpleNamespace(submitted_at=1.0, first_token_at=2.0)
    assert READERS[name](_serving_run(None, [old_handle])) is None
    for events in ([_event("aten::mm", 1.0, 2.0)],
                   [_event("aten::mm", 1.0, 2.0),
                    _event("cudaLaunchKernel", 1.2, 1.3, id=5),
                    _event("gemm", 1.5, 2.5, device=DeviceType.CUDA,
                           id=5)]):
        run = _serving_run(_Window(events, 3.0), [old_handle],
                           {"decode_chunks": 4})
        assert READERS[name](run) is None


def test_the_loader_reader_reads_none_without_the_counter(monkeypatch):
    from tpu_docker_api_torch.data import loader

    monkeypatch.delattr(loader, "wait_count")
    assert phases.loader_wait_ms(SimpleNamespace()) is None
    monkeypatch.setattr(loader, "wait_count",
                        {"batches": 0, "wait_s": 0.0}, raising=False)
    assert phases.loader_wait_ms(SimpleNamespace()) is None


def test_queue_wait_counts_the_window_s_admissions_only():
    hs = [SimpleNamespace(submitted_at=-1.0, admitted_at=-0.5),
          SimpleNamespace(submitted_at=1.0, admitted_at=1.5),
          SimpleNamespace(submitted_at=2.0, admitted_at=2.1),
          SimpleNamespace(submitted_at=9.0, admitted_at=10.5),
          SimpleNamespace(submitted_at=9.5, admitted_at=None)]
    got = phases.queue_wait_ms(_serving_run(None, hs))
    assert got == pytest.approx(1e3 * (0.5 + 0.1) / 2)


def _run(tiny_bench, name):
    root, pb = tiny_bench
    cell = spec.find_cell(name, root=root, portbench=pb)
    out = run_cell(cell, SEED, 4.0, True, torch.device("cpu"),
                   time.perf_counter(), portbench=pb)
    return json.loads(json.dumps(out))["metrics"]


def test_the_tiny_chat_cell_reads_the_engine_s_spans(tiny_bench):
    m = _run(tiny_bench, "moe-tiny.chat")
    for name in ("queue_wait_ms.chat", "decode_launch_ms.chat"):
        assert m[name]["unit"] == "ms" and m[name]["value"] > 0
    idle = [m[f"idle_in_{p}.chat"]["value"]
            for p in ("admit", "launch", "process")]
    assert all(v >= 0 for v in idle)
    assert sum(idle) <= m["device_idle.chat"]["value"] + 1e-9


def test_the_tiny_train_cell_reads_the_loader_s_counter(tiny_bench):
    from tpu_docker_api_torch.data import loader

    loader.wait_count.update(batches=0, wait_s=0.0)
    m = _run(tiny_bench, "tiny.train")
    assert m["loader_wait_ms.train"]["value"] > 0
    assert loader.wait_count["batches"] >= 3 + 1 + 1
    assert "optimizer_ms.train" in m
