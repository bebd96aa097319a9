"""Host spans and device gauges of the port.

Counterpart of ``rainbow_iqn_apex_tpu/obs/trace.py``.  ``with
tracer.span("learn_step"):`` aggregates the region's host wall time into a
registry histogram (``span_<name>_ms``, the source of the periodic 'timing'
row and the /metrics summary) and emits one exemplar 'span' JSONL row per
span name per flush interval, with span_id/parent_id from a thread-local
stack.  Spans are host spans: on CUDA the learn step returns once its work
is queued, so ``learn_step`` measures dispatch, not device time.
Device-memory gauges come from ``torch.cuda.memory_stats``.  The JAX
package's --trace-dir profiler window and compile counters are not ported.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict

import torch

from rainbow_iqn_apex_tpu_torch.obs.registry import MetricRegistry

_span_ids = itertools.count(1)
_tls = threading.local()


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class Tracer:
    """Per-run span recorder.  ``logger`` is a MetricsLogger (or None:
    aggregate-only); ``reset_exemplars()`` re-arms one exemplar row per span
    name and is called by RunObs at each periodic flush."""

    def __init__(self, registry: MetricRegistry, logger=None, role: str = ""):
        self.registry = registry
        self.logger = logger
        self.role = role
        self._seen: set = set()
        self._seen_lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        sid = next(_span_ids)
        stack = _stack()
        parent = stack[-1] if stack else 0
        stack.append(sid)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur_ms = (time.perf_counter() - t0) * 1e3
            stack.pop()
            self.registry.histogram(f"span_{name}_ms", self.role).observe(dur_ms)
            if self.logger is not None:
                with self._seen_lock:
                    emit = name not in self._seen
                    if emit:
                        self._seen.add(name)
                if emit:
                    self.logger.log("span", name=name, span_id=sid, parent_id=parent,
                                    dur_ms=round(dur_ms, 3), role=self.role, **attrs)

    def reset_exemplars(self) -> None:
        with self._seen_lock:
            self._seen.clear()

    def span_stats(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """{span_name: snapshot} for every span histogram of the registry."""
        out = {}
        for name, role, m in self.registry.collect():
            if name.startswith("span_") and m.kind == "histogram":
                key = name[len("span_"):]
                if role and role != self.role:
                    key = f"{key}@{role}"
                out[key] = m.snapshot(reset=reset)
        return out


def sample_device_gauges(registry: MetricRegistry, role: str = "",
                         device: torch.device = None) -> None:
    """Device-memory gauges of ``device`` from ``torch.cuda.memory_stats``;
    a no-op for the CPU (the gauges simply never appear)."""
    if device is None or device.type != "cuda":
        return
    stats = torch.cuda.memory_stats(device)
    for key, name in (("allocated_bytes.all.current", "bytes_in_use"),
                      ("allocated_bytes.all.peak", "peak_bytes_in_use"),
                      ("reserved_bytes.all.current", "bytes_reserved")):
        if key in stats:
            registry.gauge(f"device_{name}", role).set(float(stats[key]))
