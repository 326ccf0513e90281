"""Idle time and device time by the program's named ranges, on the
device trace's clock; and the readers of the program's own spans and
counters.

A traced window (``harness/trace.py``'s ``Window``) holds the program's
``record_function`` ranges as host events beside the device operations,
on one clock whose origin is the window's start. Each instant of the
host timeline belongs to the innermost range open over it, on any host
thread: the one opened last (``innermost``). The device's idle intervals
are the gaps between its operations that ``trace.summarize`` finds, and
the window's edges before the first and after the last; an idle instant
counts for the range that owned it. A device operation belongs to the
range that owned the instant its CUDA API call (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``) was made. This is
the benchmark's own copy of the arithmetic; it reads nothing of the
program but the names of the ranges.

Every reader returns None where its run has nothing to read: no trace,
or a program without the range, stamp or counter (the program before
they were added).
"""

from __future__ import annotations

import bisect
import weakref

#: the slot engine's ranges (``infer/slots.py``) and the train step's
#: (``train/trainer.py``)
ADMIT, LAUNCH, PROCESS = ("SlotEngine.admit", "SlotEngine.decode_launch",
                          "SlotEngine.process")
ENGINE = (ADMIT, LAUNCH, PROCESS)
OPTIMIZER = "train_step.optimizer"
STEP = ("train_step.forward", "train_step.backward", OPTIMIZER)

_reduced: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def innermost(opened) -> list[tuple[float, float, str]]:
    """The timeline ``opened`` ((start, end, name) ranges) covers, cut
    into disjoint (start, end, name) pieces in order, each owned by the
    innermost range over it: the one opened last (of two opened at once,
    the shorter)."""
    points = sorted({p for a, b, _ in opened for p in (a, b)})
    order = sorted(opened, key=lambda o: (o[0], -o[1]))
    pieces: list[tuple[float, float, str]] = []
    active: list = []
    k = 0
    for p, q in zip(points, points[1:]):
        while k < len(order) and order[k][0] <= p:
            active.append(order[k])
            k += 1
        active = [o for o in active if o[1] > p]
        if not active:
            continue
        name = active[-1][2]
        if pieces and pieces[-1][1] == p and pieces[-1][2] == name:
            pieces[-1] = (pieces[-1][0], q, name)
        else:
            pieces.append((p, q, name))
    return pieces


def idle_intervals(busy, w0: float, w1: float) -> list[tuple[float, float]]:
    """The parts of ``[w0, w1]`` that no (start, end) interval of
    ``busy`` covers, in order."""
    out, at = [], w0
    for a, b in sorted(busy):
        a, b = max(a, w0), min(b, w1)
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < w1:
        out.append((at, w1))
    return out


def overlap_by_owner(intervals, pieces) -> dict[str, float]:
    """Seconds of the disjoint, ordered ``intervals`` inside each owner's
    ``pieces`` (``innermost``'s)."""
    out: dict[str, float] = {}
    j = 0
    for a, b in intervals:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            p0, p1, name = pieces[k]
            out[name] = out.get(name, 0.0) + min(b, p1) - max(a, p0)
            k += 1
    return out


def owner_at(t: float, pieces, starts) -> str | None:
    """The owner of instant ``t`` (``starts``: the pieces' starts)."""
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else None


def by_range(events, window_s: float, ranges) -> dict:
    """Over the ``window_s`` traced of a profiler's ``events``: the
    idle seconds each of ``ranges`` owned, the device seconds launched
    in each, and how many times each was opened."""
    from torch.autograd import DeviceType

    names = set(ranges)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    opened = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
              for e in host if e.name in names]
    pieces = innermost(opened)
    busy = [(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in dev]
    # the window's clock starts a little after the profiler's: its
    # window_s are placed to hold every operation where they can, so the
    # idle time is trace.summarize's, window_s less the busy union
    w0 = 0.0
    if busy:
        w0 = min(min(a for a, _ in busy),
                 max(0.0, max(b for _, b in busy) - window_s))
    idle = overlap_by_owner(idle_intervals(busy, w0, w0 + window_s), pieces)
    # a device operation shares its id (CUPTI's correlation id) with the
    # CUDA API call that launched it, and no other host event is keyed so
    launched_at = {e.id: e.time_range.start / 1e6 for e in host
                   if e.name.startswith("cu")}
    starts = [p[0] for p in pieces]
    device: dict[str, float] = {}
    for e in dev:
        t = launched_at.get(e.id)
        name = None if t is None else owner_at(t, pieces, starts)
        if name is not None:
            device[name] = (device.get(name, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e6)
    count = {r: 0 for r in ranges}
    for _, _, name in opened:
        count[name] += 1
    return {"window_s": window_s, "count": count,
            "idle_s": {r: idle.get(r, 0.0) for r in ranges},
            "device_s": {r: device.get(r, 0.0) for r in ranges}}


def _of_window(run, ranges) -> dict | None:
    """``by_range`` of the run's traced window (once a run), or None where
    the run has no trace or the program opened none of ``ranges``."""
    rec = getattr(run, "rec", None)
    win = rec.get("window") if isinstance(rec, dict) else None
    if win is None:
        return None
    key = tuple(ranges)
    got = _reduced.setdefault(win, {})
    if key not in got:
        got[key] = by_range(win.prof.events(), win.window_s, ranges)
    out = got[key]
    return out if any(out["count"].values()) else None


def idle_in(run, name: str):
    """Share of the traced window the device sat idle while the engine
    was inside range ``name``, in %."""
    r = _of_window(run, ENGINE)
    return None if r is None else 100.0 * r["idle_s"][name] / r["window_s"]


def optimizer_ms(run):
    """Device ms launched inside the train step's optimizer range, a
    traced step."""
    r = _of_window(run, STEP)
    if r is None or not r["count"][OPTIMIZER]:
        return None
    return 1e3 * r["device_s"][OPTIMIZER] / r["count"][OPTIMIZER]


def decode_launch_ms(run):
    """Host ms the engine spent dispatching a decode chunk, over the
    window (its traced end included): the engine's ``decode_launch_s``
    over its ``decode_chunks``."""
    s0, s1 = run.rec["stats0"], run.rec["stats1"]
    if "decode_launch_s" not in s1:
        return None
    chunks = s1["decode_chunks"] - s0["decode_chunks"]
    if chunks <= 0:
        return None
    return 1e3 * (s1["decode_launch_s"] - s0["decode_launch_s"]) / chunks


def queue_wait_ms(run):
    """Mean ms from submit to a slot (``Handle.admitted_at``) of the
    requests admitted in the window."""
    t0, t_end = run.rec["t0"], run.rec["t_end"]
    waits = []
    for s in run.rec["sent"]:
        at = getattr(s.handle, "admitted_at", None)
        if at is not None and t0 <= at < t_end:
            waits.append(at - s.handle.submitted_at)
    return 1e3 * sum(waits) / len(waits) if waits else None


def loader_wait_ms(run):
    """Host ms a call of the loader's batch function took, over every
    batch the run's process drew (the loader's ``wait_count``)."""
    from tpu_docker_api_torch.data import loader

    count = getattr(loader, "wait_count", None)
    if not count or not count["batches"]:
        return None
    return 1e3 * count["wait_s"] / count["batches"]
