"""A ``torch.profiler`` window and its reduction to device time.

The window is synchronised at both ends and opened and closed by the
thread that issues all of the run's device work, so every device event
in it belongs to work launched inside it. The reduction is a copy of the
port's ``telemetry/profile.py`` arithmetic: device events on one stream
do not overlap, so the busy time is the union of their intervals;
``idle = 1 - busy / window``. Kernels are classed by name (the port's
four kernels by their function names, cuBLAS by its name fragments).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

#: kernel-name fragment → class; the first match wins
CLASSES = (
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_bwd_dq_kernel", "flash_bwd_dq"),
    ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
    ("adam8_kernel", "adam8"),
    ("gemm", "cublas"), ("cutlass", "cublas"), ("xmma", "cublas"),
    ("nvjet", "cublas"), ("sm90_", "cublas"),
)

#: the flash forward's op, whose recorded input shapes size each call
FLASH_OP = "tpu_docker_api_torch::flash_fwd"


def kernel_class(name: str) -> str:
    low = name.lower()
    for fragment, cls in CLASSES:
        if fragment in low:
            return cls
    return "other"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Window:
    """``with Window() as w: ...`` traces the block; ``w.summary`` after
    it. Opened and closed in the thread that launches the device work."""

    def __init__(self):
        self._summary: dict | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    @property
    def summary(self) -> dict:
        """The reduction, made at its first read (after the run's
        window, not in it)."""
        if self._summary is None:
            self._summary = summarize(self.prof.events(), self.window_s)
        return self._summary


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize(events, window_s: float, top: int = 10) -> dict:
    """Busy and idle seconds of the device, seconds by kernel class and
    by name, the flash forward calls' shapes, and the longest idle gaps
    with the host op that was running in each."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                   for e in dev)
    busy = _union((a, b) for a, b, _ in spans)
    by_class: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for a, b, name in spans:
        cls = kernel_class(name)
        by_class[cls] += b - a
        by_name[name] += b - a
        counts[cls] += 1
    gaps = []
    end = spans[0][1] if spans else 0.0
    for a, b, _ in spans[1:]:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    gaps.sort(reverse=True)
    cpu_spans = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                 for e in cpu]

    def host_at(t0, t1):
        """The shortest host op covering the gap's middle."""
        mid = (t0 + t1) / 2
        best = None
        for a, b, name in cpu_spans:
            if a <= mid <= b and (best is None or b - a < best[0]):
                best = (b - a, name)
        return best[1] if best else "no host op recorded"

    flash_shapes = [e.input_shapes for e in cpu if e.name == FLASH_OP]
    return {
        "window_s": window_s,
        "busy_s": busy,
        "idle_share": max(0.0, 1.0 - busy / window_s),
        "s_by_class": dict(by_class),
        "count_by_class": dict(counts),
        "flash_fwd_shapes": flash_shapes,
        "device_ops": [[n[:120], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[host_at(t0, t1)[:120], g]
                      for g, t0, t1 in gaps[:top]],
    }
