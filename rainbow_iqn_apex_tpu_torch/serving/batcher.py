"""Dynamic micro-batching: coalesce concurrent act() requests into one batch.

Batched inference is where accelerator throughput lives (Stooke & Abbeel,
arXiv:1803.02811): one [B, H, W, C] dispatch amortises the fixed
per-dispatch cost over B requests.  The batcher's contract:

- requests enter a BOUNDED queue (backpressure); a full queue sheds the
  request immediately with ``ServerOverloaded`` instead of growing latency
  without bound — the caller sees the overload and can back off;
- the worker drains the queue into one batch per dispatch, waiting at most
  ``deadline_s`` past the OLDEST queued request's arrival before dispatching
  whatever it has (latency bound), and never waiting at all once ``max_batch``
  requests are queued (throughput bound);
- the batch is padded up to a small set of bucketed sizes chosen at
  construction, so the device only ever sees a few fixed shapes (see
  engine.py).

A copy of ``rainbow_iqn_apex_tpu/serving/batcher.py``: the port keeps its own
copy of every module it needs from the JAX package.

All of this is plain host threading: requests are tiny numpy arrays and the
device call itself happens outside the lock.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


class ServerOverloaded(RuntimeError):
    """Raised to the submitting client when the request queue is full."""


class ServerClosed(RuntimeError):
    """Raised to the submitting client when the server is shut down."""


class RequestCancelled(RuntimeError):
    """Raised from ``result()`` after the future was cancelled."""


class ServeFuture:
    """One in-flight request: the client blocks on ``result()``; the worker
    fulfils with ``set_result``/``set_error``.

    A client that gives up (``result()`` timeout, disconnect) should call
    ``cancel()``: a cancelled future is skipped by the batcher instead of
    padding, dispatching and fulfilling a dead slot — under a slow-client
    cohort the abandoned requests would otherwise silently burn batch
    capacity the live clients need."""

    __slots__ = ("obs", "t_enqueue", "_lock", "_event", "_action", "_q",
                 "_error", "_cancelled", "_callbacks")

    def __init__(self, obs: np.ndarray):
        self.obs = obs
        self.t_enqueue = time.monotonic()
        # the lock serialises settle-vs-cancel and callback registration:
        # exactly one of {result, error, cancelled} wins, and a callback
        # added after settling still fires exactly once
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._action: Optional[int] = None
        self._q: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._callbacks: List = []

    def _settle(self) -> Optional[List]:
        """Mark settled; returns the callbacks to run (None if already set)."""
        if self._event.is_set():
            return None
        self._event.set()
        cbs, self._callbacks = self._callbacks, []
        return cbs

    def _run_callbacks(self, cbs: Optional[List]) -> None:
        for cb in cbs or ():
            try:
                cb(self)
            except Exception:
                pass  # an observer bug must never poison the worker loop

    def set_result(self, action: int, q: np.ndarray) -> None:
        with self._lock:
            self._action = action
            self._q = q
            cbs = self._settle()
        self._run_callbacks(cbs)

    def set_error(self, err: BaseException) -> None:
        with self._lock:
            if not self._event.is_set():
                self._error = err
            cbs = self._settle()
        self._run_callbacks(cbs)

    def cancel(self) -> bool:
        """Abandon the request.  True when the cancel won (the future was not
        yet fulfilled): the batcher will drop it instead of dispatching, and
        ``result()`` raises RequestCancelled.  False when a result/error
        already landed — the outcome stands and nothing changes."""
        with self._lock:
            if self._event.is_set():
                return False
            self._cancelled = True
            self._error = RequestCancelled("request cancelled by client")
            cbs = self._settle()
        self._run_callbacks(cbs)
        return True

    def cancelled(self) -> bool:
        return self._cancelled

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` once the future settles (result, error or
        cancel); runs immediately when already settled.  The router uses
        this for inflight accounting and dead-engine re-dispatch."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callbacks([fn])

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Tuple[int, np.ndarray]:
        """Block until fulfilled; returns (action, q_values [A])."""
        if not self._event.wait(timeout):
            raise TimeoutError("serve request not fulfilled in time")
        if self._error is not None:
            raise self._error
        return self._action, self._q

    @property
    def latency_ms(self) -> float:
        return (time.monotonic() - self.t_enqueue) * 1e3


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    """Smallest bucket >= n (buckets sorted ascending; n <= max bucket)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class MicroBatcher:
    """Bounded request queue + deadline-driven coalescing.

    The worker thread (server.py) calls ``take()`` in a loop; client threads
    call ``submit()``.  ``close()`` wakes everyone; queued requests are still
    drained by the worker (graceful shutdown), new submissions are refused.
    """

    def __init__(
        self,
        buckets: Sequence[int],
        deadline_s: float,
        queue_bound: int,
        metrics=None,
    ):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.buckets}")
        self.max_batch = self.buckets[-1]
        self.deadline_s = float(deadline_s)
        self.queue_bound = int(queue_bound)
        self.metrics = metrics
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False

    # ---------------------------------------------------------- client side
    def submit(self, obs: np.ndarray) -> ServeFuture:
        fut = self.try_submit(obs)
        if fut is None:
            if self.metrics is not None:
                self.metrics.record_shed()
            raise ServerOverloaded(
                f"request queue full ({self.queue_bound}); shedding"
            )
        return fut

    def try_submit(self, obs: np.ndarray) -> Optional[ServeFuture]:
        """submit() minus the shed accounting: returns None when the queue
        is full instead of recording a shed and raising.  For probing
        callers that own their own shed story (the fleet router tries
        several engines per request — a probe that lands elsewhere is not
        an engine shed, and counting it would flip health to degraded on
        phantom pressure).  Still raises ServerClosed after close()."""
        fut = ServeFuture(obs)
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
            if len(self._queue) >= self.queue_bound:
                return None
            self._queue.append(fut)
            self._nonempty.notify()
        return fut

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---------------------------------------------------------- worker side
    def take(
        self, poll_s: float = 0.05, idle_timeout_s: Optional[float] = None
    ) -> Optional[List[ServeFuture]]:
        """Block for the next coalesced batch.

        Returns up to ``max_batch`` requests: immediately when the queue
        already holds a full batch, otherwise after the oldest queued request
        has waited ``deadline_s``.  With ``idle_timeout_s`` set, an EMPTY
        queue for that long returns ``[]`` — the worker's cue to emit a
        liveness heartbeat and call again.  Returns None only when closed
        AND drained — the worker's signal to exit.
        """
        t_start = time.monotonic()
        cancelled = 0
        with self._lock:
            while True:
                # drop cancelled heads eagerly: an abandoned request must not
                # hold the deadline clock (its enqueue time is the oldest) or
                # a batch slot — the slow-client cohort would otherwise burn
                # capacity live clients need
                while self._queue and self._queue[0].cancelled():
                    self._queue.popleft()
                    cancelled += 1
                if self._queue:
                    deadline = self._queue[0].t_enqueue + self.deadline_s
                    if len(self._queue) >= self.max_batch or self._closed:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._nonempty.wait(timeout=min(remaining, poll_s))
                else:
                    if self._closed:
                        if cancelled and self.metrics is not None:
                            self.metrics.record_cancelled(cancelled)
                        return None
                    if (idle_timeout_s is not None
                            and time.monotonic() - t_start >= idle_timeout_s):
                        if cancelled and self.metrics is not None:
                            self.metrics.record_cancelled(cancelled)
                        return []
                    self._nonempty.wait(timeout=poll_s)
            batch: List[ServeFuture] = []
            while self._queue and len(batch) < self.max_batch:
                fut = self._queue.popleft()
                if fut.cancelled():
                    cancelled += 1
                    continue
                batch.append(fut)
            n = len(batch)
            depth_after = len(self._queue)
        if self.metrics is not None:
            if cancelled:
                self.metrics.record_cancelled(cancelled)
            if n:
                self.metrics.record_batch(
                    n, pick_bucket(self.buckets, n), depth_after
                )
                # queue-to-slot wait (pipeline lag attribution): how long
                # this batch's requests sat queued before coalescing granted
                # them a slot — guarded getattr so metrics stand-ins without
                # the obs surface keep working
                record_wait = getattr(self.metrics, "record_queue_wait", None)
                if record_wait is not None:
                    now = time.monotonic()
                    record_wait(
                        sum((now - f.t_enqueue) for f in batch) / n * 1e3)
        return batch

    def close(self) -> None:
        """Refuse new submissions; the worker keeps draining what's queued."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()

    def abort_pending(self, err: BaseException) -> int:
        """Fail every queued request (hard shutdown path); returns count."""
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for fut in pending:
            fut.set_error(err)
        return len(pending)
