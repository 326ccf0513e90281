"""In-process metrics registry with Prometheus text exposition — the
port's own copy of the subset of ``tpu_docker_api/telemetry/metrics.py``
that serving and the control plane use: histograms (``observe``),
counters (``counter_inc``, pull-time ``counter_fn``, ``counter_value``,
``counter_sum``), gauges (labeled ``gauge_set``, pull-time ``gauge_fn``,
labeled ``gauge_series_fn``), ``render`` and the process-wide
``REGISTRY``. Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0)


def _esc_label(v) -> str:
    """Label-value escaping: backslash, double quote and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v: str) -> str:
    """HELP-text escaping: backslash and newline."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Thread-safe metric store. Each distinct label set is its own
    series, Prometheus-style."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._hists: dict[str, dict[tuple, list]] = {}
        self._hist_buckets: dict[str, tuple[float, ...]] = {}
        self._help: dict[str, tuple[str, str]] = {}  # name -> (type, help)
        self._gauge_fns: dict[str, Callable[[], float]] = {}
        self._gauge_series_fns: dict[str, Callable[[], list]] = {}
        self._counter_fns: dict[str, Callable[[], float]] = {}

    def _declare(self, name: str, typ: str, help: str) -> None:
        """Register (or re-assert) a metric's type; a name reused with a
        different type raises instead of rendering a contradictory page."""
        cur = self._help.get(name)
        if cur is None:
            self._help[name] = (typ, help)
        elif cur[0] != typ:
            raise ValueError(
                f"metric {name!r} already registered as {cur[0]}, "
                f"cannot re-register as {typ}")

    def counter_inc(self, name: str, labels: dict | None = None,
                    value: float = 1.0, help: str = "") -> None:
        with self._lock:
            self._declare(name, "counter", help)
            series = self._counters.setdefault(name, {})
            key = tuple(sorted((labels or {}).items()))
            series[key] = series.get(key, 0.0) + value

    def counter_value(self, name: str, labels: dict | None = None) -> float:
        """Read a counter's current value (0.0 if never incremented), so
        a status view reads back the very counters /metrics exports."""
        with self._lock:
            series = self._counters.get(name, {})
            return series.get(tuple(sorted((labels or {}).items())), 0.0)

    def counter_sum(self, name: str) -> float:
        """Sum a counter across all label series (0.0 if never
        incremented): the gateway's status view totals its labeled
        families from the books /metrics exports."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def gauge_set(self, name: str, value: float, labels: dict | None = None,
                  help: str = "") -> None:
        """Set a labeled gauge (the capacity market's queue depth, a
        service's replica counts)."""
        with self._lock:
            self._declare(name, "gauge", help)
            self._gauges.setdefault(name, {})[
                tuple(sorted((labels or {}).items()))] = value

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "") -> None:
        """Register a pull-time gauge."""
        with self._lock:
            self._declare(name, "gauge", help)
            self._gauge_fns[name] = fn

    def gauge_series_fn(self, name: str,
                        fn: Callable[[], list], help: str = "") -> None:
        """Register a pull-time LABELED gauge family: ``fn()`` returns
        ``[(labels_dict, value), ...]``, rendered fresh at every scrape
        (per-engine pool stats: the engine set is the pod's)."""
        with self._lock:
            self._declare(name, "gauge", help)
            self._gauge_series_fns[name] = fn

    def counter_fn(self, name: str, fn: Callable[[], float],
                   help: str = "") -> None:
        """Register a pull-time COUNTER (a monotonic value owned
        elsewhere, e.g. an engine's completed-request count)."""
        with self._lock:
            self._declare(name, "counter", help)
            self._counter_fns[name] = fn

    def observe(self, name: str, value: float, labels: dict | None = None,
                buckets: Iterable[float] = _DEFAULT_BUCKETS,
                help: str = "") -> None:
        with self._lock:
            self._declare(name, "histogram", help)
            bks = self._hist_buckets.setdefault(name, tuple(buckets))
            series = self._hists.setdefault(name, {})
            key = tuple(sorted((labels or {}).items()))
            if key not in series:
                series[key] = [[0] * (len(bks) + 1), 0.0, 0]
            counts, total, n = series[key]
            for i, b in enumerate(bks):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            series[key] = [counts, total + value, n + 1]

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: list[str] = []
        with self._lock:
            for name, (typ, hlp) in sorted(self._help.items()):
                if hlp:
                    out.append(f"# HELP {name} {_esc_help(hlp)}")
                out.append(f"# TYPE {name} {typ}")
                if typ in ("counter", "gauge"):
                    fns = self._counter_fns if typ == "counter" \
                        else self._gauge_fns
                    if name in fns:
                        try:
                            v = float(fns[name]())
                        except Exception:  # noqa: BLE001 — never break
                            continue       # /metrics on one bad source
                        out.append(f"{name} {v:g}")
                    if name in self._gauge_series_fns:
                        try:
                            series = list(self._gauge_series_fns[name]())
                        except Exception:  # noqa: BLE001 — never break
                            series = []    # /metrics on one bad source
                        for labels, v in sorted(
                                series, key=lambda s: sorted(s[0].items())):
                            out.append(
                                f"{name}{_fmt_labels(labels)} {float(v):g}")
                    values = self._counters if typ == "counter" \
                        else self._gauges
                    for key, v in sorted(values.get(name, {}).items()):
                        out.append(f"{name}{_fmt_labels(dict(key))} {v:g}")
                else:  # histogram; counts are already cumulative
                    bks = self._hist_buckets.get(name, ())
                    for key, (counts, total, n) in sorted(
                            self._hists.get(name, {}).items()):
                        labels = dict(key)
                        for i, b in enumerate(bks):
                            out.append(
                                f"{name}_bucket"
                                f"{_fmt_labels({**labels, 'le': f'{b:g}'})} "
                                f"{counts[i]}")
                        out.append(f"{name}_bucket"
                                   f"{_fmt_labels({**labels, 'le': '+Inf'})}"
                                   f" {n}")
                        out.append(f"{name}_sum{_fmt_labels(labels)} "
                                   f"{total:g}")
                        out.append(f"{name}_count{_fmt_labels(labels)} {n}")
        return "\n".join(out) + "\n"


#: process-wide default registry (the work queue and the health watcher
#: when no registry is handed in)
REGISTRY = MetricsRegistry()
