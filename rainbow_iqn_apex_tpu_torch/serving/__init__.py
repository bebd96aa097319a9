"""Batched low-latency policy inference on one CUDA device: dynamic
micro-batching over bucketed shapes, a bucketed inference engine whose
forward runs the port's kernels, in-memory weight hot-swap and the JSONL /
Prometheus metrics surface.  Counterpart of ``rainbow_iqn_apex_tpu/serving``
(engine, server, batcher, metrics); the fleet, network and checkpoint-watch
layers are not ported."""

from rainbow_iqn_apex_tpu_torch.serving.batcher import (
    MicroBatcher,
    RequestCancelled,
    ServeFuture,
    ServerClosed,
    ServerOverloaded,
    pick_bucket,
)
from rainbow_iqn_apex_tpu_torch.serving.engine import (
    InferenceEngine,
    fit_buckets,
    parse_buckets,
)
from rainbow_iqn_apex_tpu_torch.serving.metrics import ServeMetrics
from rainbow_iqn_apex_tpu_torch.serving.server import PolicyServer

__all__ = [
    "InferenceEngine",
    "MicroBatcher",
    "PolicyServer",
    "RequestCancelled",
    "ServeFuture",
    "ServeMetrics",
    "ServerClosed",
    "ServerOverloaded",
    "fit_buckets",
    "parse_buckets",
    "pick_bucket",
]
