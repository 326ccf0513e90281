"""Device-time summary of a ``torch.profiler`` window: where a training
step's time goes on the card (the port's own kernels against cuBLAS and
the rest) and how much of the window the device sat idle; and the model
path's named ranges (:func:`span`).

The summary counts the CUDA kernel events of the trace. Kernels run on
one stream here, so they do not overlap and their durations add up to
the device's busy time. A trace with no device events (a profiler that
could not trace the card) gives ``kernel_events: 0`` and no shares.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

from tpu_docker_api_torch.telemetry.trace import NOOP

#: kernel-name fragment → class; the first match wins
_CLASSES = (
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_bwd_dq_kernel", "flash_bwd_dq"),
    ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
    ("adam8_kernel", "adam8"),
    ("gemm", "cublas"),
    ("cutlass", "cublas"),
    ("xmma", "cublas"),
    ("nvjet", "cublas"),
    ("sm90_", "cublas"),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for fragment, cls in _CLASSES:
        if fragment in low:
            return cls
    return "other"


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    is collecting, else the shared no-op scope. A range lands on the
    trace's timeline beside the kernels it launched; with no profiler it
    costs one read of the profiler's flag, where ``record_function``
    costs its full price whether or not anything records it. A profiler
    collecting is the only switch."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return NOOP


def _innermost(opened) -> list[tuple[float, float, str]]:
    """The timeline that ``opened`` ((start, end, name) ranges, on any
    threads) covers, cut into disjoint (start, end, name) pieces, each
    owned by the innermost range over it: the one opened last (of two
    opened at once, the shorter)."""
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


def ms_by_range(events, ranges) -> dict[str, float]:
    """Device milliseconds by named range. A device operation belongs to
    the innermost range of ``ranges`` that was open, on any host thread,
    when the host call that launched it ran (:func:`_innermost`): a
    backward range counts the kernels autograd launched from its own
    thread. The launching call is the CUDA API call of the operation's own
    id (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``);
    operations launched outside every named range count nowhere."""
    from torch.autograd import DeviceType

    names = set(ranges)
    out = {r: 0.0 for r in ranges}
    host = [e for e in events if e.device_type == DeviceType.CPU]
    pieces = _innermost([(e.time_range.start, e.time_range.end, e.name)
                        for e in host if e.name in names])
    if not pieces:
        return out
    # a device operation shares its id (CUPTI's correlation id) with the
    # CUDA API call that launched it; framework ops' ids are another count
    launched_at = {e.id: e.time_range.start for e in host
                   if e.name.startswith("cu")}
    starts = [p[0] for p in pieces]
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        t = launched_at.get(e.id)
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < pieces[i][1]:
            out[pieces[i][2]] += e.time_range.elapsed_us() / 1e3
    return out


def device_time_summary(prof, wall_s: float, top: int = 12,
                        ranges: tuple[str, ...] = ()) -> dict:
    """Milliseconds of device time by kernel class over a window of
    ``wall_s`` host seconds (synchronised at both ends), the busy and
    idle shares of that window, and the ``top`` kernels by time. For each
    name in ``ranges`` (a :func:`span` range), the device time of the
    operations launched inside it (:func:`ms_by_range`)."""
    from torch.autograd import DeviceType

    events = prof.events()
    # a record_function range also shows on the device's timeline as a
    # user annotation spanning its kernels: not a kernel of its own
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        return {"kernel_events": 0, "window_ms": wall_s * 1e3}
    by_class: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_class[kernel_class(e.name)] += ms
        by_name[e.name] += ms
    busy_ms = sum(by_class.values())
    window_ms = wall_s * 1e3
    return {
        "kernel_events": len(kernels),
        "window_ms": window_ms,
        "busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / window_ms),
        "ms_by_class": dict(by_class),
        "share_by_class": {k: v / busy_ms for k, v in by_class.items()},
        "ms_by_range": ms_by_range(events, ranges),
        "top_kernels": [[name[:120], ms] for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
    }
