"""The port's copy of the pipeline tracer (rainbow_iqn_apex_tpu_torch.obs.
pipeline_trace) against the JAX package's: the same calls on a fixed clock
give the same span rows, lag windows, propagation budget and critical-path
verdict."""

import pytest

from rainbow_iqn_apex_tpu.obs import MetricRegistry as JaxRegistry
from rainbow_iqn_apex_tpu.obs import PipelineTracer as JaxTracer
from rainbow_iqn_apex_tpu.obs import critical_path as jax_critical_path
from rainbow_iqn_apex_tpu.obs import format_critical_path as jax_format
from rainbow_iqn_apex_tpu_torch.obs import (
    MetricRegistry,
    PipelineTracer,
    critical_path,
    format_critical_path,
)


class _Rows:
    """A MetricsLogger stand-in that keeps what is logged."""

    def __init__(self):
        self.rows = []

    def log(self, kind, step=0, **kw):
        row = dict(kind=kind, step=step, **kw)
        self.rows.append(row)
        return row


def _drive(tracer_cls, registry_cls):
    ticks = iter(0.5 * k for k in range(1000))
    logger = _Rows()
    tr = tracer_cls(logger, registry_cls(), sample_every=2, host=1,
                    clock=lambda: next(ticks))
    tr.max_weight_lag = 3
    seen = {"sampled": [tr.maybe_trace("l", u) for u in range(5)],
            "links": tr.link_ids("a", [0, 2, 3, 4, 4, 6, 8, 10], limit=3)}
    for step in range(4):
        tid = tr.maybe_trace("l", step)
        with tr.span("learn_step", tid, step=step):
            tr.emit_span("gather", tid, tr.clock(), parent_id=1,
                         links=tr.link_ids("a", [2 * step + 2]))
        tr.lag("sample_age_steps", 10.0 + step)
    for version in range(3):
        tr.note_publish(version)
        seen[f"adopt{version}"] = tr.note_adopt("actor0", version)
    seen["adopt_direct"] = tr.note_adopt("actor1", 2, lag_ms=12.5)
    seen["cadence"] = tr.publish_cadence_s()
    seen["budget"] = tr.adopt_budget_ms()
    seen["lag_row"] = tr.emit_lag_row(step=4, extra=1)
    seen["lag_row_again"] = tr.emit_lag_row(step=5)
    return logger.rows, seen


def test_pipeline_tracer_matches_the_jax_package():
    rows, seen = _drive(PipelineTracer, MetricRegistry)
    jax_rows, jax_seen = _drive(JaxTracer, JaxRegistry)
    assert rows == jax_rows
    assert seen == jax_seen
    spans = [r for r in rows if r["kind"] == "span_link"]
    assert {r["trace_id"] for r in spans} == {"l1-0", "l1-2"}
    cp = critical_path(rows)
    assert cp == jax_critical_path(jax_rows) and cp is not None
    assert format_critical_path(cp) == jax_format(cp)


@pytest.mark.parametrize("sample_every", [0, 3])
def test_pipeline_tracer_off_and_sampling_match_the_jax_package(sample_every):
    port = PipelineTracer(_Rows(), sample_every=sample_every)
    ref = JaxTracer(_Rows(), sample_every=sample_every)
    assert port.spans_on == ref.spans_on
    assert [port.maybe_trace("r", u) for u in range(10)] == \
        [ref.maybe_trace("r", u) for u in range(10)]
    assert critical_path([]) is None and jax_critical_path([]) is None
