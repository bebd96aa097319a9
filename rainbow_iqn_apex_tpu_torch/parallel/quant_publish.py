"""The weight-publish surface of the port's Ape-X driver, with the gated
int8 / fp8 publish.

Counterpart of ``rainbow_iqn_apex_tpu/parallel/quant_publish.py``
(``QuantPublishMixin``, :47-228) for one process: the learner's parameters
go to the actor with a monotonically increasing version stamp; the epoch
fence refuses a publish from a superseded learner; each publish logs one
``publish`` row with its byte count and feeds the publish->adopt tracer.

With ``cfg.serve_quantize`` "int8" or "fp8" and a calibration batch set
(``set_calibration``, drawn from replay at warm-up), a publish quantizes
the learner's fp32 parameters on the card (K10q) into a staging
``QuantizedIQN`` and gates them: the learner's network and the staged one
act on the calibration batch under the same taus and noise, drawn from a
generator seeded ``cfg.seed + 8221`` anew for each gate.  Agreement of the
greedy actions at or above ``cfg.quant_agreement_min`` copies the staged q
and s in place into the actor's ``QuantizedIQN`` and the actor acts on it
(``_actor_quant``); the ``publish`` row's bytes are the q bytes plus the
fp32 scale bytes (JAX's ``_tree_wire_bytes``).  Below it, the publish falls
back to the bf16 / fp32 copy and emits one reasoned ``quant_fallback``
row.  Every gate sets the ``quant_action_agreement`` gauge, and each
fallback adds one to ``quant_fallback_total``.  Without a calibration
batch a publish is the full-precision one.

The actor's parameters are a separate set of tensors: Adam updates the
learner's in place, so an actor that shared them would act on every later
step as well (JAX's arrays are immutable, so its copy is a snapshot by
construction).

A driver using the mixin provides ``state`` (the learner's ``TrainState``),
``actor_net`` (the actor's network), ``_act`` (its act step), ``device``,
``num_actions``, ``cfg``, ``weights_version`` and ``actor_weights_version``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.models.quantized import QuantizedIQN, make_quantized_network
from rainbow_iqn_apex_tpu_torch.utils import hostsync
from rainbow_iqn_apex_tpu_torch.utils.quantize import (
    QuantizedParams,
    check_mode,
    greedy_agreement,
    quantize_params,
)


class QuantPublishMixin:
    """Versioned learner -> actor weight publish, gated int8 / fp8 or
    bf16 / fp32."""

    def _init_quant_publish(self, cfg) -> str:
        """Install the publish state; returns the effective mode."""
        self.quant_mode = check_mode(cfg.serve_quantize)
        self._actor_quant = False
        self.quant_agreement: Optional[float] = None
        self.quant_fallbacks = 0
        self._calib_obs: Optional[torch.Tensor] = None
        self._obs_metrics = None
        self._obs_registry = None
        self._obs_tracer = None
        self._epoch_fence = None
        self.learner_epoch = 0
        self.fenced_publishes = 0
        self.actor_qnet: Optional[QuantizedIQN] = None
        if self.quant_mode != "off":
            learner = {k: v.detach() for k, v in self.state.net.named_parameters()}

            def holder() -> QuantizedIQN:
                return make_quantized_network(
                    cfg, self.num_actions, QuantizedParams.like(learner, self.quant_mode),
                    use_noise=True)

            self._staged_qnet = holder()  # K10q's target, gated before any copy
            self.actor_qnet = holder()
        return self.quant_mode

    def attach_obs(self, metrics=None, registry=None, tracer=None) -> None:
        """The run's metrics surface, for the ``publish`` / ``quant`` /
        ``quant_fallback`` rows and gauges, and the ``PipelineTracer`` that
        anchors publish->adopt lags."""
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

    def set_calibration(self, obs_batch: np.ndarray) -> None:
        """Calibration observations for the gate, drawn from replay (a
        sampled batch's stacked obs), clipped to ``cfg.quant_calib_batch``."""
        n = min(len(obs_batch), max(int(self.cfg.quant_calib_batch), 1))
        obs = torch.from_numpy(np.ascontiguousarray(obs_batch[:n], np.uint8))
        with hostsync.sanctioned():  # a one-time upload at warm-up
            self._calib_obs = obs.to(self.device)

    def _gate_actions(self, qnet: QuantizedIQN):
        """(learner's actions, quantized actions) on the calibration batch,
        both under one draw of taus and noise from a generator seeded
        ``cfg.seed + 8221``."""
        g = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 8221)
        n = self._calib_obs.shape[0]
        taus = torch.rand((n, self.cfg.num_quantile_samples), generator=g, device=self.device)
        noise = qnet.sample_noise(g)
        a32, _ = self._act(self.state.net, self._calib_obs, None, taus, noise)
        aq, _ = self._act(qnet, self._calib_obs, None, taus, noise)
        return a32, aq

    def _quant_row(self, kind: str, **fields) -> None:
        if self._obs_metrics is not None:
            self._obs_metrics.log(kind, **fields)
        if self._obs_registry is not None:
            if kind == "quant_fallback":
                self._obs_registry.counter("quant_fallback_total", "learner").inc()
            if fields.get("agreement") is not None:
                self._obs_registry.gauge("quant_action_agreement", "learner").set(
                    float(fields["agreement"]))

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
        published_mode = None
        if self.quant_mode != "off" and self._calib_obs is not None:
            staged = self._staged_qnet
            quantize_params(self.state.net, self.quant_mode, out=staged.qparams)  # K10q
            a32, aq = self._gate_actions(staged)
            with hostsync.sanctioned():  # publish boundary: the ring is drained
                agreement = greedy_agreement(hostsync.to_host(a32), hostsync.to_host(aq))
            self.quant_agreement = agreement
            if agreement >= self.cfg.quant_agreement_min:
                # only the quantized weights reach the actor
                self.actor_qnet.load_(staged.qparams)
                self._actor_quant = True
                published_mode = self.quant_mode
                published_bytes = staged.qparams.wire_bytes()
                self._quant_row("quant", event="gate", mode=self.quant_mode, active=True,
                                agreement=round(agreement, 6),
                                threshold=self.cfg.quant_agreement_min)
            else:
                self.quant_fallbacks += 1
                self._quant_row("quant_fallback", reason="agreement_below_min",
                                mode=self.quant_mode, agreement=round(agreement, 6),
                                threshold=self.cfg.quant_agreement_min, step=self.state.step)
        bytes_fp32 = self._params_bytes()
        if published_mode is None:
            bf16 = bool(self.cfg.bf16_weight_sync)
            learner = dict(self.state.net.named_parameters())
            with torch.no_grad():
                for name, dst in self.actor_net.named_parameters():
                    src = learner[name].detach()
                    dst.copy_(src.to(torch.bfloat16) if bf16 else src)
            published_mode = "bf16" if bf16 else "fp32"
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

    @property
    def actor(self):
        """The network the actor acts on: the quantized holder after a
        passed gate, else the bf16 / fp32 copy."""
        return self.actor_qnet if self._actor_quant else self.actor_net
