"""End-to-end pipeline tracing & lag attribution (jax-free).

Ape-X's learning dynamics are governed by *lags* — how stale a sampled
transition is when the learner consumes it, how far actor weights trail the
learner, how long a publish takes to reach every consumer (Horgan et al.,
arXiv:1803.00933), and IMPACT (arXiv:1912.00167) shows those staleness terms
trade directly against throughput.  The rest of obs/ measures every stage in
isolation; this module connects them *causally*: units of work (an env tick,
a learn step, a weight publish, a serving request) carry a ``trace_id``, and
every stage they flow through — act/env-step -> replay append -> sample/
gather -> learn dispatch -> ring retirement -> publish -> adoption, plus the
router admit -> dispatch -> reply path — emits a linked span, so one Perfetto
timeline (scripts/trace_export.py) or one ``critical_path:`` verdict
(scripts/obs_report.py) answers "which stage bounds the pipeline".

Two strictly separated cost tiers:

* **lag metrics** are ALWAYS ON: a handful of registry histogram observations
  per batch/publish (``lag_*`` names, surfaced as one periodic ``lag`` JSONL
  row + /metrics).  They touch no RNG and no device state, so default
  behaviour stays bitwise identical to the untraced build (tier-1 asserts
  the off-mode trajectories).
* **span emission** is SAMPLED 1-in-N (``Config.trace_sample_every``;
  0 = off, the default): only every Nth unit of work emits ``span_link``
  rows, so the learn-loop overhead stays within the <=3% bench gate
  (the ``trace_overhead`` bench row) while flows remain reconstructible.

Trace ids are deterministic strings ``"<kind><host>-<unit>"`` (e.g.
``"a0-512"`` = host 0's append tick 512, ``"l0-40"`` = learn step 40,
``"w0-3"`` = weight version 3, ``"r0-17"`` = routed request 17), so two
processes that never exchanged tracer state still stamp the SAME id for the
same logical unit — which is exactly what lets trace_export draw publish ->
adopt flow arrows across hosts.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# Canonical stage -> bottleneck verdict for the critical-path analyzer.
# Stages not listed classify as their own name (still ranked, just unmapped).
STAGE_VERDICTS: Dict[str, str] = {
    "act": "actor-bound",
    "env_step": "actor-bound",
    "append": "actor-bound",
    "replay_sample": "sampler-starved",
    "draw": "sampler-starved",
    "gather": "sampler-starved",
    "learn_step": "device-bound",
    "ring_retire": "writeback-bound",
    "publish": "publish-bound",
    "adopt": "publish-bound",
    "route": "serve-bound",
    "router_dispatch": "serve-bound",
    "batch_slot": "serve-bound",
}


class PipelineTracer:
    """Per-run causal tracer: sampled span emission + always-on lag metrics.

    ``logger`` is a MetricsLogger (or None: metrics-only); ``registry`` is
    the run's MetricRegistry (or None: spans-only); ``sample_every`` is the
    1-in-N span sampling knob (0 disables span rows entirely).  All methods
    are safe from worker threads (span ids come from a process-wide counter,
    per-consumer adopt windows are lock-guarded).
    """

    def __init__(
        self,
        logger=None,
        registry=None,
        sample_every: int = 0,
        host: int = 0,
        role: str = "learner",
        clock: Callable[[], float] = time.time,
    ):
        self.logger = logger
        self.registry = registry
        self.sample_every = max(int(sample_every), 0)
        self.host = int(host)
        self.role = role
        self.clock = clock
        self._span_ids = itertools.count(1)
        self._lock = threading.Lock()
        # publish bookkeeping: version -> publish wall ts (bounded), plus the
        # recent inter-publish gaps the propagation budget derives from
        self._pub_ts: "collections.OrderedDict[int, float]" = (
            collections.OrderedDict())
        self._pub_gaps: collections.deque = collections.deque(maxlen=32)
        self.max_weight_lag = 0  # loops set this; 0 = no propagation budget

    # ------------------------------------------------------------- sampling
    @property
    def spans_on(self) -> bool:
        return self.sample_every > 0 and self.logger is not None

    def sampled(self, unit: int) -> bool:
        """True when unit-of-work ``unit`` should emit full spans."""
        return self.spans_on and int(unit) % self.sample_every == 0

    def trace_id(self, kind: str, unit: int) -> str:
        return f"{kind}{self.host}-{int(unit)}"

    def maybe_trace(self, kind: str, unit: int) -> Optional[str]:
        """The loops' one-liner: a trace id when this unit is sampled, else
        None (and every span() taking None is a zero-cost no-op)."""
        return self.trace_id(kind, unit) if self.sampled(unit) else None

    # ---------------------------------------------------------------- spans
    def emit_span(
        self,
        stage: str,
        trace_id: Optional[str],
        t0: float,
        t1: Optional[float] = None,
        parent_id: int = 0,
        links: Iterable[str] = (),
        **attrs: Any,
    ) -> int:
        """Emit one ``span_link`` row; returns its span id (0 when no row
        was written — trace_id None or no logger)."""
        if trace_id is None or self.logger is None:
            return 0
        t1 = self.clock() if t1 is None else t1
        sid = next(self._span_ids)
        links = [l for l in links if l]
        self.logger.log(
            "span_link",
            stage=stage,
            trace_id=trace_id,
            span_id=sid,
            parent_id=int(parent_id),
            t0=round(float(t0), 6),
            dur_ms=round((t1 - t0) * 1e3, 3),
            role=self.role,
            **({"links": links} if links else {}),
            **attrs,
        )
        return sid

    @contextlib.contextmanager
    def span(self, stage: str, trace_id: Optional[str],
             parent_id: int = 0, links: Iterable[str] = (), **attrs: Any):
        """``with ptrace.span("learn_step", tid):`` — no-op when ``tid`` is
        None (the unsampled/off path pays one ``is None`` check)."""
        if trace_id is None or self.logger is None:
            yield 0
            return
        t0 = self.clock()
        try:
            yield 0
        finally:
            self.emit_span(stage, trace_id, t0, parent_id=parent_id,
                           links=links, **attrs)

    def link_ids(self, kind: str, units: Iterable[int],
                 limit: int = 8) -> List[str]:
        """Trace ids of the SAMPLED units among ``units`` (bounded): the
        learn span links to the env-tick traces of its sampled rows, so
        Perfetto draws append -> learn flow arrows without a row per
        transition."""
        if not self.spans_on:
            return []
        out: List[str] = []
        seen = set()
        for u in units:
            u = int(u)
            # u <= 0 is the "never stamped" sentinel (slots restored from a
            # snapshot, or written before attach_tracer) — linking to a
            # nonexistent trace would join unrelated learn steps in the
            # export's flow pass
            if u > 0 and u % self.sample_every == 0 and u not in seen:
                seen.add(u)
                out.append(self.trace_id(kind, u))
                if len(out) >= limit:
                    break
        return out

    # ----------------------------------------------------------- lag metrics
    def lag(self, name: str, value: float) -> None:
        """Record one always-on lag observation into ``lag_<name>`` (the
        periodic ``lag`` row + /metrics read these back)."""
        if self.registry is not None:
            self.registry.histogram(f"lag_{name}", self.role).observe(
                float(value))

    def note_publish(self, version: int, ts: Optional[float] = None) -> None:
        """A weight publish landed: remember its wall ts (the adopt lag
        anchor) and fold the inter-publish gap into the propagation budget."""
        ts = self.clock() if ts is None else float(ts)
        with self._lock:
            if self._pub_ts:
                gap = ts - self._pub_ts[next(reversed(self._pub_ts))]
                if gap > 0:
                    self._pub_gaps.append(gap)
            self._pub_ts[int(version)] = ts
            while len(self._pub_ts) > 64:
                self._pub_ts.popitem(last=False)

    def note_adopt(self, consumer: str, version: int,
                   lag_ms: Optional[float] = None,
                   ts: Optional[float] = None) -> Optional[float]:
        """A consumer adopted ``version``.  ``lag_ms`` may be supplied
        directly (cross-process consumers measure against the publish row's
        own ts); otherwise it is derived from this tracer's publish table.
        Returns the lag recorded (None when underivable)."""
        ts = self.clock() if ts is None else float(ts)
        if lag_ms is None:
            with self._lock:
                pub = self._pub_ts.get(int(version))
            if pub is None:
                return None
            lag_ms = max((ts - pub) * 1e3, 0.0)
        lag_ms = float(lag_ms)
        # per-consumer window as a registry histogram under a "consumer:"
        # role — the registry's existing bounded-window percentile machinery
        # instead of a second hand-rolled one; lag_snapshot folds these into
        # publish_adopt_ms_by_consumer
        if self.registry is not None:
            self.registry.histogram(
                "lag_publish_adopt_ms", f"consumer:{consumer}"
            ).observe(lag_ms)
        self.lag("publish_adopt_ms", lag_ms)
        return lag_ms

    def publish_cadence_s(self) -> Optional[float]:
        """Median inter-publish gap (seconds); None before 2 publishes."""
        with self._lock:
            gaps = sorted(self._pub_gaps)
        return gaps[len(gaps) // 2] if gaps else None

    def adopt_budget_ms(self) -> Optional[float]:
        """The propagation budget: a consumer may trail by at most
        ``max_weight_lag`` publishes (the staleness fence's own bound), so
        its publish->adopt p99 budget is max_weight_lag * the observed
        publish cadence.  None when fencing is off or cadence unknown."""
        if self.max_weight_lag <= 0:
            return None
        cadence = self.publish_cadence_s()
        if cadence is None:
            return None
        return self.max_weight_lag * cadence * 1e3

    def lag_snapshot(self) -> Dict[str, Any]:
        """The payload of one periodic ``lag`` row: per-metric WINDOW
        percentiles from the ``lag_*`` registry histograms plus per-consumer
        publish->adopt stats and the propagation budget.

        Windows RESET on snapshot (lifetime count/sum stay on the
        histograms): each lag row covers only the interval since the last
        one.  This is what makes RunHealth's heal edge real — a consumer
        that caught back up produces a clean next window instead of one
        early slow burst pinning the cumulative p99 over budget (and the
        run degraded, with the consumer named) for the rest of the run."""
        out: Dict[str, Any] = {}
        by_consumer: Dict[str, Dict[str, float]] = {}
        if self.registry is not None:
            for name, role, m in self.registry.collect():
                if not (name.startswith("lag_") and m.kind == "histogram"):
                    continue
                snap = m.snapshot(reset=True)
                if not snap.get("count"):
                    continue
                snap = {k: round(float(v), 4) for k, v in snap.items()}
                if role.startswith("consumer:"):
                    by_consumer[role[len("consumer:"):]] = snap
                else:
                    out[name[len("lag_"):]] = snap
        if by_consumer:
            out["publish_adopt_ms_by_consumer"] = by_consumer
        budget = self.adopt_budget_ms()
        if budget is not None:
            out["publish_adopt_budget_ms"] = round(budget, 3)
        return out

    def emit_lag_row(self, step: int = 0, **extra: Any) -> Optional[Dict]:
        """One ``lag`` JSONL row at the metrics cadence (loops call this
        from the same place they call obs_run.periodic)."""
        if self.logger is None:
            return None
        snap = self.lag_snapshot()
        if not snap and not extra:
            return None
        return self.logger.log("lag", step=int(step), **snap, **extra)


# --------------------------------------------------------------------------
# Critical-path analysis over span_link rows (shared by obs_report and
# relay_watch — the verdict string must not drift between the two).
# --------------------------------------------------------------------------

def critical_path(rows: Iterable[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Attribute end-to-end latency to pipeline stages from ``span_link``
    rows: each stage's EXCLUSIVE time (its span durations minus its child
    spans' durations — nested spans must not double-bill their parents) is
    summed, and the stage with the largest share is the verdict.

    Returns ``{"stage", "share", "verdict", "stages": {stage: {ms, share}}}``
    or None when no span_link rows are present."""
    spans = [r for r in rows if r.get("kind") == "span_link"]
    if not spans:
        return None
    # child durations roll up by (host, parent span id); span ids are only
    # unique within a process, so key on the emitting host too
    child_ms: Dict[Tuple[int, int], float] = {}
    for r in spans:
        parent = int(r.get("parent_id") or 0)
        if parent:
            key = (int(r.get("host", 0)), parent)
            child_ms[key] = child_ms.get(key, 0.0) + float(r.get("dur_ms", 0.0))
    stages: Dict[str, float] = {}
    for r in spans:
        key = (int(r.get("host", 0)), int(r.get("span_id", 0)))
        excl = max(float(r.get("dur_ms", 0.0)) - child_ms.get(key, 0.0), 0.0)
        stage = str(r.get("stage", "unknown"))
        stages[stage] = stages.get(stage, 0.0) + excl
    total = sum(stages.values())
    if total <= 0:
        return None
    ranked = sorted(stages.items(), key=lambda kv: -kv[1])
    top_stage, top_ms = ranked[0]
    return {
        "stage": top_stage,
        "share": round(top_ms / total, 4),
        "verdict": STAGE_VERDICTS.get(top_stage, top_stage),
        "stages": {
            s: {"ms": round(ms, 3), "share": round(ms / total, 4)}
            for s, ms in ranked
        },
    }


def format_critical_path(cp: Optional[Dict[str, Any]]) -> Optional[str]:
    """One-line rendering shared by obs_report and relay_watch:
    ``gather 61% (sampler-starved)``."""
    if not cp:
        return None
    return f"{cp['stage']} {round(cp['share'] * 100)}% ({cp['verdict']})"
