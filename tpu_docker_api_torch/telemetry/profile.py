"""Device-time summary of a ``torch.profiler`` window: where a training
step's time goes on the card (the port's own kernels against cuBLAS and
the rest) and how much of the window the device sat idle.

The summary counts the CUDA kernel events of the trace. Kernels run on
one stream here, so they do not overlap and their durations add up to
the device's busy time. A trace with no device events (a profiler that
could not trace the card) gives ``kernel_events: 0`` and no shares.
"""

from __future__ import annotations

from collections import defaultdict

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


def device_time_summary(prof, wall_s: float, top: int = 12,
                        ranges: tuple[str, ...] = ()) -> dict:
    """Milliseconds of device time by kernel class over a window of
    ``wall_s`` host seconds (synchronised at both ends), the busy and
    idle shares of that window, and the ``top`` kernels by time. For each
    name in ``ranges`` (a ``torch.profiler.record_function`` range), the
    device time of the kernels launched inside it (``ms_by_range``)."""
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
        "ms_by_range": {r: sum(e.device_time_total for e in events
                               if e.name == r
                               and e.device_type == DeviceType.CPU) / 1e3
                        for r in ranges},
        "top_kernels": [[name[:120], ms] for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
    }
