"""The weight-publish surface of the port's Ape-X driver.

Counterpart of ``rainbow_iqn_apex_tpu/parallel/quant_publish.py``
(``QuantPublishMixin``) on its ``serve_quantize="off"`` path: the learner's
parameters go to the actor's copy with a monotonically increasing version
stamp, rounded through bf16 when ``cfg.bf16_weight_sync`` is set (the JAX
package's ``_uncast(device_put(_cast(p)))``) or copied in fp32; the epoch
fence refuses a publish from a superseded learner; each publish logs one
``publish`` row with its byte count and feeds the publish->adopt tracer.
Any other ``serve_quantize`` mode (the int8 / fp8 gated publish, kernel
K10) raises NotImplementedError.

The actor's parameters are a separate set of tensors: Adam updates the
learner's in place, so an actor that shared them would act on every later
step as well (JAX's arrays are immutable, so its copy is a snapshot by
construction).

A driver using the mixin provides ``state`` (the learner's ``TrainState``),
``actor_net`` (the actor's network), ``cfg``, ``weights_version`` and
``actor_weights_version``.
"""

from __future__ import annotations

import time

import torch


class QuantPublishMixin:
    """Versioned learner -> actor weight publish (``serve_quantize="off"``)."""

    def _init_quant_publish(self, cfg) -> str:
        """Install the publish state; returns the effective mode, "off"."""
        if cfg.serve_quantize != "off":
            raise NotImplementedError(
                f"serve_quantize={cfg.serve_quantize!r}: the quantized publish (K10) is not "
                "ported yet")
        self.quant_mode = "off"
        self._actor_quant = False
        self._calib_obs = None
        self._obs_metrics = None
        self._obs_registry = None
        self._obs_tracer = None
        self._epoch_fence = None
        self.learner_epoch = 0
        self.fenced_publishes = 0
        return self.quant_mode

    def attach_obs(self, metrics=None, registry=None, tracer=None) -> None:
        """The run's metrics surface, for the ``publish`` rows and gauges,
        and the ``PipelineTracer`` that anchors publish->adopt lags."""
        self._obs_metrics = metrics
        self._obs_registry = registry
        self._obs_tracer = tracer

    def attach_epoch_fence(self, fence, learner_epoch: int) -> None:
        """Arm the zombie-learner publish fence: with ``fence`` latched
        above ``learner_epoch``, ``publish_weights`` refuses."""
        self._epoch_fence = fence
        self.learner_epoch = int(learner_epoch)

    def wants_calibration(self) -> bool:
        return self.quant_mode != "off" and self._calib_obs is None

    def _params_bytes(self) -> int:
        """Bytes of the learner's parameters as stored (fp32)."""
        return int(sum(p.numel() * p.element_size() for p in self.state.net.parameters()))

    def publish_weights(self) -> int:
        """Learner -> actor copy (the Redis SET + actor GET pair of the
        reference); returns the new weight version, which the actor adopts
        with the parameters."""
        if self._epoch_fence is not None and self._epoch_fence.stale(self.learner_epoch):
            self.fenced_publishes += 1
            if self._obs_metrics is not None:
                self._obs_metrics.log(
                    "failover", event="fenced_stale", surface="publish",
                    epoch=self.learner_epoch, fence_epoch=self._epoch_fence.epoch,
                    version=self.weights_version)
            return self.weights_version
        t_pub0 = time.time()
        bf16 = bool(self.cfg.bf16_weight_sync)
        learner = dict(self.state.net.named_parameters())
        with torch.no_grad():
            for name, dst in self.actor_net.named_parameters():
                src = learner[name].detach()
                dst.copy_(src.to(torch.bfloat16) if bf16 else src)
        published_mode = "bf16" if bf16 else "fp32"
        bytes_fp32 = self._params_bytes()
        published_bytes = bytes_fp32 // (2 if bf16 else 1)
        self._actor_quant = False
        self.weights_version += 1
        self.actor_weights_version = self.weights_version
        if self._obs_tracer is not None:
            tr = self._obs_tracer
            tr.note_publish(self.weights_version, ts=t_pub0)
            if tr.sampled(self.weights_version):
                tr.emit_span("publish", tr.trace_id("w", self.weights_version), t_pub0,
                             version=self.weights_version, mode=published_mode)
            tr.note_adopt("actor_inproc", self.weights_version)
        if self._obs_metrics is not None:
            self._obs_metrics.log(
                "publish", version=self.weights_version, bytes=published_bytes,
                bytes_fp32=bytes_fp32, mode=published_mode, quant_active=self._actor_quant)
        if self._obs_registry is not None:
            self._obs_registry.counter("publish_bytes_total", "learner").inc(published_bytes)
        return self.weights_version
