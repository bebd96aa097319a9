"""Process-wide metric registry: named counters/gauges/histograms with role
labels, shared by every role in the process (actor/learner/replay/serve/
supervisor) and drained two ways — periodic JSONL rows through the existing
``MetricsLogger`` surface, and Prometheus text exposition (obs/export.py).

Design points:
  * one lock per registry, shared by its metrics — recording is a dict lookup
    plus a float add under an RLock, cheap enough for per-batch call sites
    (the per-*step* hot path on device never touches this; only host-side
    bookkeeping does);
  * histograms keep a bounded window (deque) for percentiles plus lifetime
    count/sum — ``snapshot(reset=True)`` gives per-interval stats without
    losing the cumulative view;
  * metrics are keyed (name, role): the same metric name can exist per role
    ("frames_total" for actor and learner) and exports with a role label.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Tuple


class Counter:
    """Monotone counter.  ``inc`` only; resets never (windows are the
    consumer's job: diff successive scrapes/rows)."""

    kind = "counter"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, occupancy, bytes)."""

    kind = "gauge"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


class Histogram:
    """Windowed observations + lifetime count/sum.

    ``snapshot()`` summarises the current window (count/mean/p50/p90/p99/max);
    ``reset=True`` clears the window (per-interval timing rows) while the
    lifetime totals keep accumulating (Prometheus summary export)."""

    kind = "histogram"

    def __init__(self, lock: threading.RLock, window: int = 8192):
        self._lock = lock
        self._win: collections.deque = collections.deque(maxlen=window)
        self.total_count = 0
        self.total_sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._win.append(v)
            self.total_count += 1
            self.total_sum += v

    def snapshot(self, reset: bool = False) -> Dict[str, float]:
        with self._lock:
            laps = sorted(self._win)
            if reset:
                self._win.clear()
        n = len(laps)
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "mean": sum(laps) / n,
            "p50": laps[n // 2],
            "p90": laps[min(int(n * 0.9), n - 1)],
            "p99": laps[min(int(n * 0.99), n - 1)],
            "max": laps[-1],
        }


class MetricRegistry:
    """Thread-safe get-or-create registry of (name, role) -> metric."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, str], Any] = {}

    def _get(self, name: str, role: str, cls, **kwargs):
        key = (name, role)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(self._lock, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} (role={role!r}) already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, role: str = "") -> Counter:
        return self._get(name, role, Counter)

    def gauge(self, name: str, role: str = "") -> Gauge:
        return self._get(name, role, Gauge)

    def histogram(self, name: str, role: str = "", window: int = 8192) -> Histogram:
        return self._get(name, role, Histogram, window=window)

    def collect(self) -> List[Tuple[str, str, Any]]:
        """Stable-ordered [(name, role, metric)] snapshot of registrations."""
        with self._lock:
            items = sorted(self._metrics.items())
        return [(name, role, m) for (name, role), m in items]

    def as_dict(self, reset_histograms: bool = False) -> Dict[str, Any]:
        """Flat {"name{role}": value-or-snapshot} view, the payload the
        periodic 'timing' row and tests read."""
        out: Dict[str, Any] = {}
        for name, role, m in self.collect():
            key = f"{name}{{{role}}}" if role else name
            if isinstance(m, Histogram):
                out[key] = m.snapshot(reset=reset_histograms)
            else:
                out[key] = m.get()
        return out


_global: Optional[MetricRegistry] = None
_global_lock = threading.Lock()


def get() -> MetricRegistry:
    """The process-wide default registry (serving and ad-hoc call sites);
    train loops build a per-run registry via RunObs so concurrent runs in one
    process (the test suite) don't cross-pollute windows."""
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricRegistry()
        return _global


def reset_global() -> None:
    """Test hook: drop the process-wide registry."""
    global _global
    with _global_lock:
        _global = None
