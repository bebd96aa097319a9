"""PolicyServer: batched low-latency ``act(observation) -> action`` for many
concurrent clients, with weight hot-swap, on one CUDA device.

Counterpart of ``rainbow_iqn_apex_tpu/serving/server.py`` (:48-374).  One
worker thread owns the device; clients only touch the queue:

    client threads --submit--> MicroBatcher (bounded queue, deadline)
                                   |
                              worker thread --pad to bucket--> InferenceEngine
                                   |                               ^
                              fulfil futures                 load_params()
                              + ServeMetrics                   hot-swap

Not ported (each raises NotImplementedError): checkpoint-driven serving
(``checkpointer``, ``from_checkpoint``, ``reload``; the JAX checkpoints are
Orbax), the fleet telemetry relay (``cfg.obs_net``) and more than one
device.

Quantized serving (``cfg.serve_quantize`` "int8" or "fp8") gates on seeded
uniform calibration frames, ``quant_calib_batch`` of them from
``numpy.random.default_rng(cfg.seed + 7)`` as the JAX server makes them;
the gate's ``quant`` / ``quant_fallback`` rows go to the metrics log, its
agreement to the ``quant_action_agreement`` gauge and each fallback to the
``quant_fallback_total`` counter, and ``healthz`` and ``stats`` carry the
engine's ``quant_state()``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.obs.export import ObsHTTPServer
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike
from rainbow_iqn_apex_tpu_torch.serving.batcher import (
    MicroBatcher,
    ServeFuture,
    ServerClosed,
)
from rainbow_iqn_apex_tpu_torch.serving.engine import InferenceEngine, parse_buckets
from rainbow_iqn_apex_tpu_torch.serving.metrics import ServeMetrics
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger

_NO_CHECKPOINTS = (
    "checkpoint-driven serving is not ported yet: the JAX checkpoints are "
    "Orbax and the port's checkpointer is still to come; hot-swap with "
    "load_params instead")


class PolicyServer:
    """Serve IQN policy inference to concurrent clients.

    Lifecycle: construct -> start() -> submit()/act() from any thread ->
    stop().  stop() drains queued requests before exiting (graceful), unless
    ``drain=False`` fails them immediately.
    """

    def __init__(
        self,
        cfg: Config,
        num_actions: int,
        params: Mapping[str, torch.Tensor],
        device: DeviceLike = None,
        checkpointer: Optional[Any] = None,
        state_shape: Optional[Tuple[int, ...]] = None,
        metrics_path: Optional[str] = None,
        echo_metrics: bool = False,
    ):
        if checkpointer is not None:
            raise NotImplementedError(_NO_CHECKPOINTS)
        if getattr(cfg, "obs_net", False):
            raise NotImplementedError(
                "cfg.obs_net: the fleet telemetry relay is not ported yet")
        self.cfg = cfg
        self.num_actions = num_actions
        self._obs_shape = tuple(state_shape or cfg.state_shape)
        self.metrics = ServeMetrics(
            MetricsLogger(metrics_path, run_id=cfg.run_id, echo=echo_metrics)
            if metrics_path
            else None
        )
        # the quantization gate's calibration: seeded uniform frames, which
        # exercise the whole numeric path (engine.set_calibration takes real
        # traffic or replay frames instead)
        calib_obs = None
        if getattr(cfg, "serve_quantize", "off") != "off":
            n = max(int(getattr(cfg, "quant_calib_batch", 64)), 1)
            calib_obs = np.random.default_rng(cfg.seed + 7).integers(
                0, 255, (n, *self._obs_shape), dtype=np.uint8)
        self.engine = InferenceEngine(
            cfg,
            num_actions,
            params,
            device=device,
            buckets=parse_buckets(cfg.serve_batch_buckets),
            mode=cfg.serve_mode,
            state_shape=self._obs_shape,
            calib_obs=calib_obs,
            quant_log=self._quant_log,
        )
        self.batcher = MicroBatcher(
            self.engine.buckets,
            deadline_s=cfg.serve_deadline_ms / 1e3,
            queue_bound=cfg.serve_queue_bound,
            metrics=self.metrics,
        )
        self._metrics_interval_s = max(cfg.serve_metrics_interval_s, 0.0)
        self._worker: Optional[threading.Thread] = None
        self._started = False
        self.obs_http: Optional[ObsHTTPServer] = None
        if int(getattr(cfg, "obs_http_port", 0) or 0) > 0:
            self.obs_http = ObsHTTPServer(
                self.metrics.registry, self.healthz, port=cfg.obs_http_port
            )

    def _quant_log(self, kind: str, **fields: Any) -> None:
        """The engine's gate rows -> the metrics surface: the row, the
        agreement gauge and the fallback counter."""
        reg = self.metrics.registry
        if kind == "quant_fallback":
            reg.counter("quant_fallback_total", "serve").inc()
        if fields.get("agreement") is not None:
            reg.gauge("quant_action_agreement", "serve").set(float(fields["agreement"]))
        if self.metrics.logger is not None:
            self.metrics.logger.log(kind, **fields)

    @classmethod
    def from_checkpoint(cls, *args: Any, **kwargs: Any) -> "PolicyServer":
        raise NotImplementedError(_NO_CHECKPOINTS)

    # -------------------------------------------------------------- lifecycle
    def warmup(self) -> int:
        """Run every bucket once now, not on first live traffic, so the first
        request of each size does not pay one-time costs (the kernels' build
        and load, cuDNN's algorithm choice) inside its latency.  Idempotent;
        returns the bucket count.  ``start()`` runs it on the worker thread,
        because PyTorch's cuDNN and cuBLAS handles are per thread."""
        for b in self.engine.buckets:
            self.engine.infer(np.zeros((b, *self._obs_shape), np.uint8))
        return len(self.engine.buckets)

    def start(self, warmup: bool = True) -> "PolicyServer":
        """Start the worker; with ``warmup`` it first runs every bucket on its
        own thread, and start() returns once that is done (or re-raises what
        the warmup raised, leaving the server unstarted)."""
        if self._started:
            return self
        ready = threading.Event()
        failed: list = []
        self._worker = threading.Thread(
            target=self._run_worker, args=(warmup, ready, failed),
            name="serve-worker", daemon=True,
        )
        self._worker.start()
        ready.wait()
        if failed:
            self._worker.join()
            self._worker = None
            raise failed[0]
        self._started = True
        if self.obs_http is not None:
            self.obs_http.start()
        return self

    def stop(self, drain: bool = True) -> Dict[str, Any]:
        """Shut down: refuse new requests, drain (or fail) queued ones, emit
        a final metrics row.  Returns lifetime stats."""
        self.batcher.close()
        if not drain:
            self.batcher.abort_pending(ServerClosed("server stopped"))
        if self._worker is not None:
            self._worker.join(timeout=60)
            self._worker = None
        # whatever is STILL queued (never started, or the join timed out on a
        # wedged worker) fails promptly instead of hanging its clients
        self.batcher.abort_pending(ServerClosed("server stopped"))
        if self.obs_http is not None:
            self.obs_http.stop()
        self.metrics.emit(final=True)
        if self.metrics.logger is not None:
            self.metrics.logger.close()
        return self.metrics.stats()

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ client API
    def _validate(self, obs: np.ndarray) -> np.ndarray:
        arr = np.asarray(obs)
        if tuple(arr.shape) != self._obs_shape:
            raise ValueError(
                f"observation shape {tuple(arr.shape)} != served {self._obs_shape}"
            )
        if arr.dtype != np.uint8:
            # silent uint8 truncation would turn normalized float frames
            # into all-zero pixels and confidently wrong actions
            raise TypeError(f"observations must be uint8 frames, got {arr.dtype}")
        return arr

    def submit(self, obs: np.ndarray) -> ServeFuture:
        """Enqueue one observation [H, W, C] uint8; returns a future.
        Raises ServerOverloaded when the queue is at its bound (shed) and
        ServerClosed after stop().  Shape/dtype are validated HERE, in the
        caller's thread: a malformed observation fails its own client and
        never reaches the worker's batch assembly."""
        return self.batcher.submit(self._validate(obs))

    def act(self, obs: np.ndarray, timeout: Optional[float] = 30.0) -> int:
        """Blocking convenience: one observation in, one action out."""
        action, _ = self.act_values(obs, timeout)
        return action

    def act_values(
        self, obs: np.ndarray, timeout: Optional[float] = 30.0
    ) -> Tuple[int, np.ndarray]:
        """Blocking act returning (action, expected Q per action [A]).
        A timed-out request is cancelled before the TimeoutError propagates,
        so the batcher does not dispatch its dead slot."""
        fut = self.submit(obs)
        try:
            return fut.result(timeout)
        except TimeoutError:
            fut.cancel()
            raise

    def reload(self, step: Optional[int] = None, force: bool = False) -> Dict[str, Any]:
        raise NotImplementedError(_NO_CHECKPOINTS)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> int:
        """Direct hot-swap from an in-memory state dict."""
        version = self.engine.load_params(params)
        self.metrics.record_swap(ok=True, params_version=version, source="direct")
        return version

    def healthz(self) -> Dict[str, Any]:
        """Live status for /healthz: failing = the worker thread died under a
        started server; degraded = shedding in the current window or the
        queue is within 20% of its shed bound."""
        snap = self.metrics.snapshot()
        depth = self.batcher.depth()
        worker_alive = self._worker is not None and self._worker.is_alive()
        status = "ok"
        if snap.get("shed", 0) > 0 or depth >= 0.8 * self.cfg.serve_queue_bound:
            status = "degraded"
        if self._started and not worker_alive:
            status = "failing"
        return {
            "status": status,
            "queue_depth": depth,
            "worker_alive": worker_alive,
            "params_version": self.engine.params_version,
            "weights_version": self.engine.params_version,
            "weights_age_s": round(self.engine.weights_age_s(), 3),
            "device": str(self.engine.device),
            **self.engine.quant_state(),
            **snap,
        }

    def stats(self) -> Dict[str, Any]:
        return {
            "queue_depth": self.batcher.depth(),
            "params_version": self.engine.params_version,
            "buckets": self.engine.buckets,
            **self.engine.quant_state(),
            **self.metrics.stats(),
        }

    # ------------------------------------------------------------ worker loop
    def _run_worker(self, warmup: bool, ready: threading.Event, failed: list) -> None:
        try:
            if warmup:
                self.warmup()
        except Exception as e:  # handed to start(), which re-raises it
            failed.append(e)
            return
        finally:
            ready.set()
        self._serve_loop()

    def _serve_loop(self) -> None:
        last_emit = time.monotonic()
        # idle timeout = metrics interval: take() returns [] on a quiet
        # queue so the heartbeat row below still fires with zero traffic
        idle_s = self._metrics_interval_s or None
        while True:
            batch = self.batcher.take(idle_timeout_s=idle_s)
            if batch is None:  # closed and drained
                break
            if batch:
                try:
                    obs = np.stack([f.obs for f in batch])
                    actions, qs = self.engine.infer(obs)
                except Exception as e:  # fail the batch, keep serving
                    for fut in batch:
                        fut.set_error(e)
                else:
                    for i, fut in enumerate(batch):
                        fut.set_result(int(actions[i]), qs[i])
                        self.metrics.record_latency_ms(fut.latency_ms)
            now = time.monotonic()
            if self._metrics_interval_s and now - last_emit >= self._metrics_interval_s:
                last_emit = now
                try:
                    self.metrics.emit(queue_depth=self.batcher.depth())
                except Exception:  # a metrics I/O failure (disk full on the
                    pass           # JSONL path) must never kill the worker
