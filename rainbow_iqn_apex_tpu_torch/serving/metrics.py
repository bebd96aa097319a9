"""Serving metrics: latency percentiles, batch occupancy, queue depth, sheds.

The serving loop is host-threaded (the device does the math; the host does the
coalescing), so the interesting health signals are host-side: how long a
request waits end-to-end, how full the batches the batcher manages to build
are (occupancy == useful rows / padded rows is the padding tax; useful rows /
batches is the coalescing win), how deep the queue runs, and how often the
server sheds under overload.  Rows go through the same
``utils.logging.MetricsLogger`` JSONL surface as training metrics, so one
consumer reads both.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

import numpy as np

from rainbow_iqn_apex_tpu_torch.obs import registry as obs_registry
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger


class ServeMetrics:
    """Thread-safe rolling aggregation of per-request / per-batch stats.

    One instance is shared by the batcher (enqueue/shed), the worker (batch
    stats, request completion latencies) and the swap watcher (swap events);
    ``emit`` snapshots-and-resets the rolling window into one JSONL row.

    Backed by the shared obs/ MetricRegistry (role "serve"): every recording
    mirrors into registry counters/histograms so the /metrics exposition and
    the JSONL rows read the same numbers.  The window/percentile logic (and
    the whole ``record_*``/``emit``/``stats`` API) is unchanged — the
    registry is an additional sink, not a replacement surface.
    """

    def __init__(
        self,
        logger: Optional[MetricsLogger] = None,
        latency_window: int = 65536,
        registry: Optional[obs_registry.MetricRegistry] = None,
    ):
        self.logger = logger
        self.registry = registry if registry is not None else obs_registry.get()
        self._c_requests = self.registry.counter("serve_requests_total", "serve")
        self._c_shed = self.registry.counter("serve_shed_total", "serve")
        self._c_cancelled = self.registry.counter("serve_cancelled_total", "serve")
        self._c_batches = self.registry.counter("serve_batches_total", "serve")
        self._c_swaps = self.registry.counter("serve_swaps_total", "serve")
        self._c_padded = self.registry.counter("serve_padded_rows_total", "serve")
        self._g_queue = self.registry.gauge("serve_queue_depth", "serve")
        self._h_latency = self.registry.histogram("serve_latency_ms", "serve")
        # pipeline lag attribution (obs/pipeline_trace.py naming): how long
        # requests sat queued before the batcher granted them a batch slot —
        # the serving path's analogue of the learner's sample-age lag
        self._h_slot_wait = self.registry.histogram(
            "lag_batch_slot_wait_ms", "serve")
        self._lock = threading.Lock()
        self._lat_ms: collections.deque = collections.deque(maxlen=latency_window)
        self._reset_window()
        # lifetime counters (never reset; stats() reports them)
        self.total_requests = 0
        self.total_shed = 0
        self.total_batches = 0
        self.total_swaps = 0
        self.total_cancelled = 0

    def _reset_window(self) -> None:
        self._win_requests = 0
        self._win_rows_padded = 0
        self._win_batches = 0
        self._win_shed = 0
        self._win_cancelled = 0
        self._win_queue_depth_sum = 0.0

    # ------------------------------------------------------------- recording
    def record_batch(self, n_requests: int, padded: int, queue_depth: int) -> None:
        with self._lock:
            self._win_requests += n_requests
            self._win_rows_padded += padded
            self._win_batches += 1
            self._win_queue_depth_sum += queue_depth
            self.total_requests += n_requests
            self.total_batches += 1
        self._c_requests.inc(n_requests)
        self._c_batches.inc()
        self._c_padded.inc(padded)
        self._g_queue.set(queue_depth)

    def record_queue_wait(self, wait_ms: float) -> None:
        """Mean queued-request wait of one coalesced batch (submit -> batch
        slot), recorded by MicroBatcher.take."""
        self._h_slot_wait.observe(wait_ms)

    def record_latency_ms(self, latency_ms: float) -> None:
        with self._lock:
            self._lat_ms.append(latency_ms)
        self._h_latency.observe(latency_ms)

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self._win_shed += n
            self.total_shed += n
        self._c_shed.inc(n)

    def record_cancelled(self, n: int = 1) -> None:
        """Queued futures dropped by the batcher because their client
        cancelled (result() timeout, disconnect) — capacity saved, not an
        error; a climbing rate means clients are giving up faster than the
        server answers."""
        with self._lock:
            self._win_cancelled += n
            self.total_cancelled += n
        self._c_cancelled.inc(n)

    def record_swap(self, **fields: Any) -> None:
        """A completed (or failed) weight swap; always emitted immediately —
        swaps are rare, load-bearing events that must not wait for the next
        periodic row."""
        with self._lock:
            self.total_swaps += 1
        self._c_swaps.inc()
        if self.logger is not None:
            self.logger.log("swap", **fields)

    # ------------------------------------------------------------- reporting
    def _percentiles(self) -> Dict[str, float]:
        if not self._lat_ms:
            return {}
        arr = np.asarray(self._lat_ms, np.float64)
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        return {
            "latency_p50_ms": round(float(p50), 3),
            "latency_p95_ms": round(float(p95), 3),
            "latency_p99_ms": round(float(p99), 3),
            "latency_max_ms": round(float(arr.max()), 3),
        }

    def _snapshot_locked(self) -> Dict[str, Any]:
        batches = max(self._win_batches, 1)
        return {
            "requests": self._win_requests,
            "batches": self._win_batches,
            "shed": self._win_shed,
            "cancelled": self._win_cancelled,
            "batch_occupancy_mean": round(self._win_requests / batches, 3),
            # an idle window pays no padding tax (0/0 is NOT "100% padded")
            "pad_fraction": 0.0 if self._win_rows_padded == 0 else round(
                1.0 - self._win_requests / self._win_rows_padded, 4
            ),
            "queue_depth_mean": round(self._win_queue_depth_sum / batches, 2),
            **self._percentiles(),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Current window stats WITHOUT resetting (for stats()/assertions)."""
        with self._lock:
            return self._snapshot_locked()

    def emit(self, **extra: Any) -> Dict[str, Any]:
        """Write one 'serve' JSONL row from the current window, then reset
        the window (latencies keep their rolling deque — percentiles smooth
        over window boundaries instead of jumping).  Snapshot and reset hold
        ONE lock acquisition: an event recorded between them would vanish
        from every window row."""
        with self._lock:
            row = self._snapshot_locked()
            self._reset_window()
        row.update(extra)
        if self.logger is not None:
            self.logger.log("serve", **row)
        return row

    def stats(self) -> Dict[str, Any]:
        """Lifetime counters plus the live window snapshot."""
        return {
            "total_requests": self.total_requests,
            "total_shed": self.total_shed,
            "total_batches": self.total_batches,
            "total_swaps": self.total_swaps,
            "total_cancelled": self.total_cancelled,
            "batch_occupancy_lifetime": round(
                self.total_requests / max(self.total_batches, 1), 3
            ),
            **self.snapshot(),
        }
