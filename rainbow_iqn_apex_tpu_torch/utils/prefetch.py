"""Learner-side batch prefetch pipeline of the port.

Counterpart of ``rainbow_iqn_apex_tpu/utils/prefetch.py``: a worker thread
samples the replay, assembles the dense batch and stages it to the device
while the learn step for the previous batch is still executing.  On CUDA
the staging runs on a side stream (pinned host memory, non-blocking
copies) and records an event; ``get()`` makes the consumer's stream wait
on that event, so the main thread never blocks on host-side sampling or on
the upload.  The sample-ahead pusher of the JAX package (device-side
sampling) is not ported.

Priority write-back consequently lags by the pipeline depth — exactly the
staleness semantics the distributed reference already has (the learner's
priority updates race later samples through Redis).  The write-back side of
that overlap is the depth-K ring in utils/writeback.py: together they make
the steady-state learn loop issue zero blocking host<->device transfers per
step (docs/PERFORMANCE.md has the sync-point inventory).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional

import torch


class BatchPrefetcher:
    """Background sampler: ``sample_fn()`` -> item, produced ahead of use.

    The GIL is the synchronisation story, matching the replay's in-process
    single-writer discipline (appends happen on the main thread between
    get() calls; NumPy ops release the GIL only inside C loops that don't
    observe partial Python-level state).

    When an obs MetricRegistry is attached, the pipeline exports its own
    health onto it (role "prefetch"), so obs_report can tell learner
    STARVATION (sampler too slow: queue depth pinned at 0, empty-wait count
    climbing) from device-bound steps (queue full, no empty waits):

      prefetch_queue_depth       gauge: staged batches ready to consume
      prefetch_empty_wait_total  counter: get() calls that found it empty
      prefetch_empty_wait_s     histogram: how long those gets blocked
    """

    def __init__(
        self,
        sample_fn: Callable[[], Any],
        depth: int = 2,
        registry=None,
        role: str = "prefetch",
    ):
        self.sample_fn = sample_fn
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._g_depth = self._c_empty = self._h_wait = None
        if registry is not None:
            self._g_depth = registry.gauge("prefetch_queue_depth", role)
            self._c_empty = registry.counter("prefetch_empty_wait_total", role)
            self._h_wait = registry.histogram("prefetch_empty_wait_s", role)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self.sample_fn()
            except BaseException as e:  # surfaced on the consumer thread
                self._exc = e
                self._q.put(None)
                return
            # block while the queue is full (bounded staleness)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    if self._g_depth is not None:
                        self._g_depth.set(self._q.qsize())
                    break
                except queue.Full:
                    continue

    def get(self, timeout: float = 60.0):
        if self._exc is not None and self._q.empty():
            # repeated get() after a surfaced failure: fail fast, don't hang
            raise RuntimeError("prefetch worker failed") from self._exc
        empty_at_get = self._q.empty()
        if empty_at_get and self._c_empty is not None:
            self._c_empty.inc()  # starvation signal: consumer outran sampler
            t0 = time.monotonic()
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"prefetch worker produced nothing for {timeout}s "
                "(replay sampler stalled or device transfer wedged)"
            ) from None
        if self._g_depth is not None:
            self._g_depth.set(self._q.qsize())
            if empty_at_get:
                self._h_wait.observe(time.monotonic() - t0)
        if item is None and self._exc is not None:
            raise RuntimeError("prefetch worker failed") from self._exc
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class ReplayPrefetcher(BatchPrefetcher):
    """Replay sampling staged on a side CUDA stream: items are ``(idx,
    Batch)``; ``get()`` orders the consumer's stream after the upload."""

    def __init__(self, memory, cfg, beta_fn: Callable[[], float], device: torch.device,
                 registry=None):
        from rainbow_iqn_apex_tpu_torch.agents.agent import to_device_batch

        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        def _sample():
            s = memory.sample(cfg.batch_size, beta_fn())
            if self.stream is None:
                return s.idx, to_device_batch(s, device), None
            with torch.cuda.stream(self.stream):
                batch = to_device_batch(s, device)
                staged = torch.cuda.Event()
                staged.record(self.stream)
            return s.idx, batch, staged

        super().__init__(_sample, depth=cfg.prefetch_depth, registry=registry)

    def get(self, timeout: float = 60.0):
        idx, batch, staged = super().get(timeout=timeout)
        if staged is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged)
            for t in (batch.obs, batch.action, batch.reward, batch.next_obs,
                      batch.discount, batch.weight):
                t.record_stream(current)  # the allocator may not reuse it early
        return idx, batch


def make_replay_prefetcher(
    memory, cfg, beta_fn: Callable[[], float], device: torch.device, registry=None
) -> ReplayPrefetcher:
    """The train-loop wiring: sample -> (idx, device-staged Batch)."""
    return ReplayPrefetcher(memory, cfg, beta_fn, device, registry=registry)
