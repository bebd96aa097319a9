"""obs/ — the port's telemetry: the row schema, the metric registry, the
/metrics + /healthz endpoint, run health, host spans, pipeline tracing
(copies of the JAX package's jax-free modules of the same names, and torch
versions of its ``trace.py``), and ``RunObs``, the per-run bundle the train
loop constructs right after its MetricsLogger."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from rainbow_iqn_apex_tpu_torch.obs.export import ObsHTTPServer
from rainbow_iqn_apex_tpu_torch.obs.health import RunHealth
from rainbow_iqn_apex_tpu_torch.obs.pipeline_trace import (
    PipelineTracer,
    critical_path,
    format_critical_path,
)
from rainbow_iqn_apex_tpu_torch.obs.registry import MetricRegistry
from rainbow_iqn_apex_tpu_torch.obs.trace import Tracer, sample_device_gauges
from rainbow_iqn_apex_tpu_torch.utils.profiling import StepTimer


class RunObs:
    """Everything one training run needs from obs/, in one object:

        obs = RunObs(cfg, metrics, role="learner", device=device)
        with obs.span("act"): ...                       # hot regions
        obs.after_learn_step(step)                      # per learn step
        obs.periodic(step, frames, replay_occupancy=x)  # at metrics cadence
        obs.close(step, frames)                         # at exit

    ``periodic`` emits the 'timing' row (StepTimer percentiles + span
    aggregates) and the 'health' row and samples the device-memory gauges.
    When cfg.obs_http_port > 0 the /metrics + /healthz endpoint is served
    for the run's lifetime.  ``trace_dir`` device traces and the ``obs_net``
    relay are not ported and raise."""

    def __init__(self, cfg, metrics, role: str = "learner",
                 registry: Optional[MetricRegistry] = None, start_http: bool = True,
                 device: Optional[torch.device] = None):
        if getattr(cfg, "trace_dir", ""):
            raise NotImplementedError("trace_dir device traces are not ported yet")
        if getattr(cfg, "obs_net", False):
            raise NotImplementedError("the obs_net telemetry relay is not ported yet")
        self.cfg = cfg
        self.metrics = metrics
        self.role = role
        self.device = device
        self.registry = registry if registry is not None else MetricRegistry()
        self.tracer = Tracer(self.registry, metrics, role)
        self.health = RunHealth(self.registry, metrics, role=role,
                                max_nan_strikes=getattr(cfg, "max_nan_strikes", 3))
        add_observer = getattr(metrics, "add_observer", None)
        if add_observer is not None:
            add_observer(self.health.observe_row)
        self.timer = StepTimer()
        self.http: Optional[ObsHTTPServer] = None
        port = int(getattr(cfg, "obs_http_port", 0) or 0)
        if start_http and port > 0:
            self.http = ObsHTTPServer(self.registry, self.health.healthz, port=port).start()
        self._steps = self.registry.gauge("learn_step", role)
        self._frames = self.registry.gauge("frames", role)
        self._closed = False

    def span(self, name: str, **attrs: Any):
        return self.tracer.span(name, **attrs)

    def after_learn_step(self, step: int, units: int = 1) -> None:
        """Per-learn-step bookkeeping: the StepTimer lap."""
        self.timer.lap(units=units)
        self.health.note_finite_step()

    def periodic(self, step: int, frames: int = 0, **gauges: Any) -> None:
        """Emit 'timing' + 'health' rows for the window ending now."""
        self._steps.set(step)
        self._frames.set(frames)
        sample_device_gauges(self.registry, self.role, self.device)
        stats = self.timer.stats()
        timing: Dict[str, Any] = {f"learn_{k}": round(float(v), 6) for k, v in stats.items()}
        timing["spans"] = {
            name: {k: round(float(v), 6) for k, v in snap.items()}
            for name, snap in self.tracer.span_stats(reset=True).items()
        }
        self.metrics.log("timing", step=step, frames=frames, **timing)
        self.tracer.reset_exemplars()
        self.health.tick(step, frames, **gauges)

    def close(self, step: int = 0, frames: int = 0, **gauges: Any) -> None:
        """Final flush: the last timing + health rows, stop the endpoint.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self.periodic(step, frames, **gauges)
        finally:
            if self.http is not None:
                self.http.stop()
                self.http = None


__all__ = ["MetricRegistry", "ObsHTTPServer", "PipelineTracer", "RunHealth", "RunObs",
           "StepTimer", "Tracer", "critical_path", "format_critical_path",
           "sample_device_gauges"]
