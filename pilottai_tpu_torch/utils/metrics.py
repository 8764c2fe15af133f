"""In-process metrics bus: counters, gauges and latency histograms (the
port's copy of ``pilottai_tpu/utils/metrics.py``).

One registry aggregates every component's series: the engine's fault
domain counts its rebuilds, recoveries, sheds, expiries and poisoned
folds here under the JAX engine's names, and the breakers and the
degrade ladder their gauges. The exporters and ``get_metrics()`` that
read it come with the metrics foundation (ROADMAP P6b, second half).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Any, Deque, Dict, Optional, Tuple

# Longest sliding window rate() supports; counter event history is pruned
# past it so hot counters stay O(events-in-window), not O(process-lifetime).
_RATE_WINDOW_MAX = 300.0


class _Histogram:
    """Bounded window of the most recent observations with percentile
    queries, plus all-time count/total.

    Percentiles are WINDOW-AWARE: ``values`` holds the last
    ``max_samples`` observations in arrival order, so quantiles describe
    recent behavior. (The previous design kept a sorted list and evicted
    at a rotating *value-rank* index, which dropped arbitrary-aged
    samples — percentiles silently mixed all-time and recent data.)
    ``count``/``total`` (and therefore ``mean``) remain all-time.
    """

    __slots__ = ("values", "count", "total", "max_samples")

    def __init__(self, max_samples: int = 4096) -> None:
        self.values: Deque[float] = deque(maxlen=max_samples)
        self.count = 0
        self.total = 0.0
        self.max_samples = max_samples

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.values.append(value)

    def percentile(self, q: float) -> Optional[float]:
        if not self.values:
            return None
        ordered = sorted(self.values)
        idx = min(len(ordered) - 1, int(q / 100.0 * len(ordered)))
        return ordered[idx]

    def summary(self) -> Dict[str, Any]:
        ordered = sorted(self.values)

        def pct(q: float) -> Optional[float]:
            if not ordered:
                return None
            return ordered[min(len(ordered) - 1, int(q / 100.0 * len(ordered)))]

        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else None,
            "p50": pct(50),
            "p90": pct(90),
            "p99": pct(99),
            # Samples the percentiles above were computed over (≤
            # max_samples; < count once eviction starts).
            "window": len(ordered),
        }


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms, labelled by name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        # Per-counter (timestamp, cumulative-after-inc) events for sliding
        # window rates; pruned to _RATE_WINDOW_MAX keeping one event at or
        # before the boundary as the window base.
        self._events: Dict[str, Deque[Tuple[float, float]]] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, _Histogram] = {}
        # Declared series: name -> kind ("counter" | "gauge" | "histogram").
        # A declaration is a CONTRACT: the series appears in snapshot()
        # (zero-valued until first observation) and therefore in every
        # exporter built on it. obs.export_completeness walks this table
        # so a subsystem can't register a series and ship it half-wired
        # (present in code, absent from /metrics).
        self._declared: Dict[str, str] = {}
        self._started = time.time()

    def inc(self, name: str, value: float = 1.0) -> None:
        now = time.time()
        with self._lock:
            self._counters[name] += value
            ev = self._events.get(name)
            if ev is None:
                ev = self._events[name] = deque()
            # Coalesce into per-second buckets: a hot counter (per-token
            # incs at production rates) must stay O(window seconds), not
            # O(increments) — both for memory and for rate()'s base scan.
            if ev and int(ev[-1][0]) == int(now):
                ev[-1] = (ev[-1][0], self._counters[name])
            else:
                ev.append((now, self._counters[name]))
            cutoff = now - _RATE_WINDOW_MAX
            while len(ev) >= 2 and ev[1][0] <= cutoff:
                ev.popleft()

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def remove_gauge(self, name: str) -> None:
        """Drop a gauge entirely (e.g. a reaped agent's health gauge —
        a stale last value would read as a live report forever)."""
        with self._lock:
            self._gauges.pop(name, None)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = _Histogram()
            self._histograms[name].observe(value)

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def rate(self, name: str, window: Optional[float] = 60.0) -> float:
        """Counter value per second over the trailing ``window`` seconds
        (capped at 300 s). The previous counter ÷ uptime-since-start
        definition underreported current throughput after any idle
        period; pass ``window=None`` for that all-time average.
        """
        with self._lock:
            now = time.time()
            if window is None:
                elapsed = max(now - self._started, 1e-9)
                return self._counters.get(name, 0.0) / elapsed
            window = min(window, _RATE_WINDOW_MAX)
            cur = self._counters.get(name, 0.0)
            ev = self._events.get(name)
            if not ev:
                return 0.0
            cutoff = now - window
            base = 0.0
            for ts, cum in ev:
                if ts > cutoff:
                    break
                base = cum
            # A registry younger than the window divides by its actual
            # age — otherwise a fresh process underreports for a minute.
            elapsed = max(min(window, now - self._started), 1e-9)
            return max(cur - base, 0.0) / elapsed

    def get(self, name: str) -> float:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, 0.0)

    def declare(self, name: str, kind: str = "gauge") -> None:
        """Declare a series the deployment is expected to export.
        ``kind`` is "counter", "gauge" or "histogram". Declared-but-not-
        yet-observed series surface in ``snapshot()`` with a zero value
        (empty summary for histograms) so scrapers see the full surface
        from boot and the export-completeness check can verify every
        registration reaches the exposition."""
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown series kind {kind!r}")
        with self._lock:
            self._declared[name] = kind

    def declared(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._declared)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.summary() for k, h in self._histograms.items()}
            for name, kind in self._declared.items():
                if kind == "counter":
                    counters.setdefault(name, 0.0)
                elif kind == "gauge":
                    gauges.setdefault(name, 0.0)
                elif name not in hists:
                    hists[name] = _Histogram().summary()
            return {
                "uptime_s": time.time() - self._started,
                "counters": counters,
                "gauges": gauges,
                "histograms": hists,
            }

    def reset_histograms(self, prefix: str = "") -> None:
        """Drop histograms whose name starts with ``prefix`` (all when
        empty). Section-scoped measurement (bench) resets the request-
        phase histograms between sections so each section's percentiles
        describe ONLY its own traffic — the window alone still mixes a
        small section with its large predecessor's samples."""
        with self._lock:
            for name in [
                n for n in self._histograms if n.startswith(prefix)
            ]:
                del self._histograms[name]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._events.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._started = time.time()


class _Timer:
    def __init__(self, registry: MetricsRegistry, name: str) -> None:
        self._registry = registry
        self._name = name
        self._start = 0.0

    def __enter__(self) -> "_Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._registry.observe(self._name, time.perf_counter() - self._start)


global_metrics = MetricsRegistry()
