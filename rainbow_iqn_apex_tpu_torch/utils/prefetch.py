"""Learner-side batch prefetch pipeline of the port.

Counterpart of ``rainbow_iqn_apex_tpu/utils/prefetch.py``: a worker thread
samples the replay, assembles the dense batch and stages it to the device
while the learn step for the previous batch is still executing.  On CUDA
the staging runs on a side stream (pinned host memory, non-blocking
copies) and records an event; ``get()`` makes the consumer's stream wait
on that event, so the main thread never blocks on host-side sampling or on
the upload.  ``SampleAheadPusher`` does the same for batches whose
indices the device sample frontier drew (replay/frontier.py).

Priority write-back consequently lags by the pipeline depth — exactly the
staleness semantics the distributed reference already has (the learner's
priority updates race later samples through Redis).  The write-back side of
that overlap is the depth-K ring in utils/writeback.py: together they make
the steady-state learn loop issue zero blocking host<->device transfers per
step (docs/PERFORMANCE.md has the sync-point inventory).

Unlike the JAX package's worker, which samples whenever its queue has room
and so sees whichever appends and write-backs the main thread happened to
finish first, this one works through one queue in the order the consumer
fills it: a sample request at the start (``depth`` of them) and at every
``get()``, and each priority write-back (``call()``).  The consumer calls
``settle()`` before its own writes (the appends), which waits until the
queue is worked off.  A batch therefore sees exactly the appends and
write-backs made before the ``get()`` that asked for it, a seeded run draws
the same batches whatever the threads' timing, and the learner thread does
no replay work but the appends.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

_STOP = object()


class BatchPrefetcher:
    """Background sampler: ``stage_fn(sample_fn(request_fn()))`` -> item,
    produced ahead of use.

    ``request_fn`` runs on the consumer's thread when a batch is asked for
    (its result, e.g. the IS exponent, goes to ``sample_fn``); ``sample_fn``
    and ``stage_fn`` run on the worker, as does each ``call(fn, *args)``, in
    the order they were asked for.  ``settle()`` waits for every
    ``sample_fn`` and ``call`` asked for so far, not for the staging.

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
        sample_fn: Callable[[Any], Any],
        depth: int = 2,
        registry=None,
        role: str = "prefetch",
        request_fn: Callable[[], Any] = lambda: None,
        stage_fn: Callable[[Any], Any] = lambda item: item,
    ):
        self.sample_fn = sample_fn
        self.request_fn = request_fn
        self.stage_fn = stage_fn
        self.depth = depth
        self._work: queue.Queue = queue.Queue()  # (fn, args, stage) in asked order
        self._q: queue.Queue = queue.Queue()  # at most `depth` items: one per request
        self._done = threading.Condition()
        self._n_asked = self._n_done = 0
        self._exc: Optional[BaseException] = None
        self._g_depth = self._c_empty = self._h_wait = None
        if registry is not None:
            self._g_depth = registry.gauge("prefetch_queue_depth", role)
            self._c_empty = registry.counter("prefetch_empty_wait_total", role)
            self._h_wait = registry.histogram("prefetch_empty_wait_s", role)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        for _ in range(depth):
            self._ask(self.sample_fn, (self.request_fn(),), True)

    def _ask(self, fn: Callable, args: tuple, stage: bool) -> None:
        self._n_asked += 1
        self._work.put((fn, args, stage))

    def call(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the worker after everything asked so far
        (a write to what ``sample_fn`` reads); returns at once."""
        self._ask(fn, args, False)

    def _worker(self) -> None:
        while True:
            work = self._work.get()
            if work is _STOP:
                return
            fn, args, stage = work
            try:
                out = fn(*args)
                with self._done:
                    self._n_done += 1
                    self._done.notify_all()
                if stage:
                    self._q.put(self.stage_fn(out))
                    if self._g_depth is not None:
                        self._g_depth.set(self._q.qsize())
            except BaseException as e:  # surfaced on the consumer thread
                with self._done:
                    self._exc = e
                    self._done.notify_all()
                self._q.put(None)
                return

    def settle(self, timeout: float = 60.0) -> None:
        """Wait until every sample and call asked for so far has run: call
        before writing to what ``sample_fn`` reads.  A worker failure is
        raised by the next ``get()``."""
        with self._done:
            done = self._done.wait_for(
                lambda: self._n_done >= self._n_asked or self._exc is not None, timeout)
        if not done:
            raise TimeoutError(f"prefetch worker did not settle in {timeout}s")

    def get(self, timeout: float = 60.0):
        """The oldest staged item; asks for the next one."""
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
        self._ask(self.sample_fn, (self.request_fn(),), True)
        return item

    def close(self) -> None:
        """Stop the worker after the work asked so far (at most ``depth``
        samples and the pending calls): the replay then ends in the same
        state on every run."""
        self._work.put(_STOP)
        self._thread.join(timeout=5)


def _stage_sample(sample, device: torch.device, stream, with_idx: bool = False):
    """``(sample.idx, device Batch, event)``: the host sample uploaded on
    ``stream`` (pinned, non-blocking) with an event behind it; on the CPU
    (``stream`` None) a plain copy and no event.  ``with_idx`` also stages
    the rows' slot ids as ``batch.idx`` (int32), for a device write-back."""
    from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames, to_device_batch

    with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
        batch = to_device_batch(sample, device)
        if with_idx:
            batch.idx = put_frames(np.asarray(sample.idx, np.int32), device)
        if stream is None:
            return sample.idx, batch, None
        staged = torch.cuda.Event()
        staged.record(stream)
    return sample.idx, batch, staged


def _adopt(batch, staged, device: torch.device):
    """Order the consumer's stream after a staged upload, and keep the
    batch's memory from being reused before that stream is done with it."""
    if staged is None:
        return batch
    current = torch.cuda.current_stream(device)
    current.wait_event(staged)
    for f in dataclasses.fields(batch):
        t = getattr(batch, f.name)
        if t is not None:
            t.record_stream(current)
    return batch


class ReplayPrefetcher(BatchPrefetcher):
    """Replay sampling staged on a side CUDA stream: items are ``(idx,
    Batch)``; ``get()`` orders the consumer's stream after the upload.  The
    IS exponent ``beta_fn()`` is read when a batch is asked for, and
    ``update_priorities`` writes back on the worker, in order."""

    def __init__(self, memory, cfg, beta_fn: Callable[[], float], device: torch.device,
                 registry=None):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._memory = memory
        super().__init__(lambda beta: memory.sample(cfg.batch_size, beta),
                         depth=cfg.prefetch_depth, registry=registry,
                         request_fn=beta_fn,
                         stage_fn=lambda s: _stage_sample(s, device, self.stream))

    def update_priorities(self, idx, td_abs) -> None:
        self.call(self._memory.update_priorities, idx, td_abs)

    def get(self, timeout: float = 60.0):
        idx, batch, staged = super().get(timeout=timeout)
        return idx, _adopt(batch, staged, self.device)


class SampleAheadPusher(BatchPrefetcher):
    """Sample-ahead over the device sample frontier (replay/frontier.py):
    index blocks drawn on the device (K5f), frames gathered from host
    memory at those indices, staged to the device with their slot ids on a
    side stream; the learner pops ``(idx, batch)`` and writes back through
    ``batch.idx`` (K6f).

    Counterpart of ``rainbow_iqn_apex_tpu/utils/prefetch.py:SampleAheadPusher``.
    The JAX pusher draws whenever its queue has room, so the IS exponent,
    the item count and the staged appends a draw sees follow thread
    timing.  Here everything that decides a batch's rows is fixed on the
    consumer's thread when the batch is asked for (at the start ``depth``
    times, then at every ``get()``): ``beta_fn()``, ``n_items_fn()``, the
    flush of staged appends and the draws themselves, which only enqueue
    work on the frontier's stream.  The worker then, in request order,
    materializes each block once (its own event, not a device sync, so the
    consumer's ``forbid_host_sync()`` holds), gathers the batch
    (``assemble_fn(idx, weight)`` -> host ``SampledBatch``) and stages it.
    With ``settle()`` before each host replay write, a seeded run draws the
    same batches whatever the threads' timing.

    Per request: when the current block is used up, the oldest drawn block
    becomes current (one is drawn if none is), then blocks are drawn until
    ``draw_ahead`` wait behind it.  After R requests, ceil(R / G) +
    draw_ahead blocks have been drawn (G = ``frontier.draw_block``): the
    K5f launches.

    ``reuse`` (replay ratio K): one batch feeds K learn passes, so both
    ``depth`` and ``draw_ahead`` shrink K-fold (ceil, at least 1).

    Gauges on the shared registry (role ``prefetch``), beside the base
    class's ``prefetch_*`` ones:

      sample_ahead_queue_depth          staged batches ready to pop
      sample_ahead_stale_indices_total  rows served across a shard
                                        drop/readmit epoch flip
    """

    def __init__(
        self,
        frontier,
        assemble_fn: Callable[[Any, Any], Any],  # (idx, weight) -> host SampledBatch
        batch_size: int,
        beta_fn: Callable[[], float],
        n_items_fn: Callable[[], int],
        device: torch.device,
        depth: int = 2,
        draw_ahead: int = 2,
        reuse: int = 1,
        registry=None,
        role: str = "prefetch",
    ):
        self.frontier = frontier
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._assemble = assemble_fn
        self._B = int(batch_size)
        self._beta_fn = beta_fn
        self._n_items_fn = n_items_fn
        shrink = max(int(reuse), 1)
        self._draw_ahead = max(-(-int(draw_ahead) // shrink), 1)
        depth = max(-(-int(depth) // shrink), 1)
        self._blocks: collections.deque = collections.deque()  # drawn, not yet current
        self._current = None
        self._row = 0
        self.blocks_drawn = 0
        self._g_sa_depth = self._c_stale = None
        if registry is not None:
            self._g_sa_depth = registry.gauge("sample_ahead_queue_depth", role)
            self._c_stale = registry.counter("sample_ahead_stale_indices_total", role)
        super().__init__(self._produce, depth=depth, registry=registry, role=role,
                         request_fn=self._request,
                         stage_fn=lambda s: _stage_sample(s, device, self.stream, with_idx=True))

    def _draw(self):
        self.blocks_drawn += 1
        return self.frontier.draw(self._B, self._beta_fn(), self._n_items_fn())

    def _request(self):
        """On the consumer's thread: the (block, row) of the next batch."""
        if self._current is None or self._row == self._current.groups:
            self._current = self._blocks.popleft() if self._blocks else self._draw()
            self._row = 0
        while len(self._blocks) < self._draw_ahead:
            self._blocks.append(self._draw())
        self._row += 1
        return self._current, self._row - 1

    def _produce(self, request):
        """On the worker: gather the batch of one (block, row)."""
        block, row = request
        idx, weight = block.host()
        if row == 0:
            stale = self.frontier.stale_rows(idx, block.stamp)
            if stale and self._c_stale is not None:
                self._c_stale.inc(stale)
        return self._assemble(idx[row], weight[row])

    def get(self, timeout: float = 60.0):
        idx, batch, staged = super().get(timeout=timeout)
        if self._g_sa_depth is not None:
            self._g_sa_depth.set(self._q.qsize())
        return idx, _adopt(batch, staged, self.device)


def make_replay_prefetcher(
    memory, cfg, beta_fn: Callable[[], float], device: torch.device, registry=None
) -> ReplayPrefetcher:
    """The train-loop wiring: sample -> (idx, device-staged Batch)."""
    return ReplayPrefetcher(memory, cfg, beta_fn, device, registry=registry)
