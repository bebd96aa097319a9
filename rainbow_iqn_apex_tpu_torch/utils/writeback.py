"""Pipelined priority write-back: the depth-K in-flight ring that keeps the
learner hot path free of blocking device->host reads.

Counterpart of ``rainbow_iqn_apex_tpu/utils/writeback.py`` for torch.  The
loop pushes each dispatched step's ``(step, idx, info)`` with ``info`` still
on the device, including the in-graph ``finite`` flag (ops/learn.py).  At
push the ring starts the step's device->host copies — ``priorities`` and
the scalars stacked into one vector — into pinned host memory with
``non_blocking=True``, and records a CUDA event behind them.  Once more than
``depth`` entries are in flight the oldest retires: it waits on its event
inside ``hostsync.sanctioned()`` (by then the device has K newer steps
queued, so the copy has long landed) and hands back host priorities and
scalars for the replay write-back and the deferred
``TrainSupervisor.retire_ok`` check.  On the CPU the "copy" is a clone.

With ``materialize_priorities=False`` (device sampling: the write-back
target is the device priority mirror, replay/frontier.py) only the scalars
cross to the host; retirement hands the still-on-device |TD| tensor on.

Rollback contract: when a retired entry is non-finite the caller must
quarantine the retired idx AND every idx still in the ring — ``flush()``
hands those back without reading their (poisoned) values — then roll back
to a snapshot taken at a drain point, which is by construction >= K steps
behind the poisoned step.

depth=0 degenerates to one read per step: push retires immediately.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.utils import hostsync


@dataclasses.dataclass
class RetiredStep:
    """One learn step, materialized on the host at ring retirement.  In
    mirror mode (``materialize_priorities=False``) ``idx`` and
    ``priorities`` stay the device tensors they were pushed as."""

    step: int
    idx: Any  # np.ndarray, or the batch's device slot ids in mirror mode
    priorities: Any  # np.ndarray, or the device |TD| in mirror mode
    finite: bool
    scalars: Dict[str, float]  # loss, grad_norm, q_mean, ... (host floats)
    lag: int  # newest dispatched step - this step, at retirement


class _Staged:
    """One in-flight step: its device->host copies and the event behind them."""

    def __init__(self, info: Dict[str, Any], materialize: bool = True):
        # host numbers (a reuse step's replay_ratio, reuse_index) need no copy
        self.host = {k: v for k, v in info.items() if not torch.is_tensor(v)}
        tensors = {k: v.detach() for k, v in info.items() if torch.is_tensor(v)}
        pri = tensors.pop("priorities")
        self.keys = sorted(k for k, v in tensors.items() if v.dim() == 0)
        scalars = (torch.stack([tensors[k].to(torch.float32) for k in self.keys])
                   if self.keys else pri.new_zeros((0,), dtype=torch.float32))
        self.materialize_priorities = materialize
        self.event = None
        if not materialize:
            self.priorities = pri  # stays on the device
        if pri.device.type == "cuda":
            if materialize:
                self.priorities = torch.empty(pri.shape, dtype=pri.dtype, pin_memory=True)
                self.priorities.copy_(pri, non_blocking=True)
            self.scalars = torch.empty(scalars.shape, dtype=torch.float32, pin_memory=True)
            self.scalars.copy_(scalars, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.scalars = scalars.clone()
            if materialize:
                self.priorities = pri.clone()

    def materialize(self) -> Tuple[Any, bool, Dict[str, float]]:
        """Wait for the copies (a sanctioned sync); (priorities, finite,
        scalars), the priorities a device tensor in mirror mode."""
        with hostsync.sanctioned():
            if self.event is not None:
                self.event.synchronize()
            values = {**dict(zip(self.keys, self.scalars.tolist())), **self.host}
            pri = (self.priorities.numpy().copy() if self.materialize_priorities
                   else self.priorities)
        finite = bool(values.pop("finite", 1.0))
        return pri, finite, values


class WritebackRing:
    """Depth-K ring of in-flight ``(step, idx, device info)`` learn steps.
    Gauges (in-flight depth, write-back lag) land on the shared obs
    registry when one is attached.

    ``materialize_priorities=False`` (the write-back target takes device
    tensors: the frontier's mirror) copies only the scalars and the finite
    flag to the host.  ``tracer`` (a ``PipelineTracer``) records the
    dispatch-to-retire wall lag (``lag_ring_retire_ms``) and, for sampled
    steps, a ``ring_retire`` span of the retirement work."""

    def __init__(self, depth: int, registry=None, role: str = "learner",
                 materialize_priorities: bool = True, tracer=None):
        self.depth = max(int(depth), 0)
        self._materialize = bool(materialize_priorities)
        self._tracer = tracer
        self._q: collections.deque = collections.deque()
        self._last_pushed = 0
        self._retired_total = 0
        self.last_lag = 0  # dispatch-to-retire lag of the newest retirement
        self._g_depth = self._g_lag = None
        if registry is not None:
            self._g_depth = registry.gauge("writeback_inflight", role)
            self._g_lag = registry.gauge("writeback_lag_steps", role)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def retired_total(self) -> int:
        return self._retired_total

    def push(
        self, step: int, idx: np.ndarray, info: Dict[str, Any]
    ) -> Optional[RetiredStep]:
        """Enqueue a dispatched step and start its device->host copies;
        returns the retired oldest entry when the ring was already holding
        ``depth`` steps (None otherwise)."""
        self._q.append((int(step), idx, _Staged(info, self._materialize), time.time()))
        self._last_pushed = int(step)
        retired = self.retire_one() if len(self._q) > self.depth else None
        if self._g_depth is not None:
            self._g_depth.set(len(self._q))
        return retired

    def retire_one(self) -> RetiredStep:
        """Materialize and pop the OLDEST in-flight step (sanctioned sync)."""
        step, idx, staged, t_push = self._q.popleft()
        t_retire = time.time()
        pri, finite, scalars = staged.materialize()
        lag = self._last_pushed - step
        self.last_lag = lag
        self._retired_total += 1
        if self._g_depth is not None:
            self._g_depth.set(len(self._q))
            self._g_lag.set(lag)
        if self._tracer is not None:
            # the lag is dispatch -> retire (how stale the priorities are
            # when they land); the span is only the retirement work
            self._tracer.lag("ring_retire_ms", (time.time() - t_push) * 1e3)
            if self._tracer.sampled(step):
                self._tracer.emit_span("ring_retire", self._tracer.trace_id("l", step),
                                       t_retire, step=step, lag_steps=lag)
        return RetiredStep(
            step=step, idx=idx, priorities=pri, finite=finite,
            scalars=scalars, lag=lag,
        )

    def drain(self) -> List[RetiredStep]:
        """Retire everything in flight, oldest first (ring-boundary sync:
        snapshot capture, weight publish, checkpoint, end of run).  Callers
        that can roll back should prefer retiring one at a time via
        ``retire_one`` so entries behind a tripped flag stay quarantinable."""
        return [self.retire_one() for _ in range(len(self._q))]

    def flush(self) -> List[Tuple[int, np.ndarray]]:
        """Drop every in-flight entry WITHOUT materializing its device info
        (it may be poisoned); returns ``[(step, idx), ...]`` oldest-first for
        quarantine write-back."""
        out = [(step, idx) for step, idx, _, _ in self._q]
        self._q.clear()
        if self._g_depth is not None:
            self._g_depth.set(0)
        return out


def cadence_hit(step: int, interval: int, reuse_k: int = 1) -> bool:
    """Did the step counter CROSS a multiple of ``interval`` in the jump
    that landed on ``step``?  With replay reuse (cfg.replay_ratio = K > 1)
    the learner step advances K per fused dispatch, so ``step % interval ==
    0`` would silently skip any cadence not divisible by K; ``step %
    interval < K`` fires exactly once per crossing instead (intervals are
    assumed >= K — every production cadence is orders of magnitude above
    it).  K = 1 degenerates to the exact ``% == 0`` the pre-reuse loops
    ran, so the default path's behaviour is unchanged."""
    return bool(interval) and step % interval < max(int(reuse_k), 1)


def check_reuse_cadences(cfg, *names: str) -> None:
    """``cadence_hit`` (and the delta-based publish/snapshot cadences) fire
    once per interval CROSSING under step jumps of K = cfg.replay_ratio,
    assuming every live interval >= K; a sub-K interval fires every fused
    dispatch — eval/drain after each learn call, the per-step-sync loop the
    ring exists to avoid — with no error.  The reuse loops call this at
    start to make the documented assumption real."""
    k = max(int(cfg.replay_ratio), 1)
    if k == 1:
        return
    for name in names:
        iv = int(getattr(cfg, name) or 0)
        if iv and iv < k:
            raise ValueError(
                f"{name} ({iv}) must be 0 (off) or >= replay_ratio ({k}): "
                "the step counter advances K per fused reuse dispatch and "
                "cadences fire once per interval crossing, so a sub-K "
                "interval would fire EVERY dispatch "
                "(docs/PERFORMANCE.md \"Replay reuse\")")


def reuse_learn_row(reuse_k: int,
                    scalars: Dict[str, Any]) -> Dict[str, Any]:
    """Learn-row extras for a replay-reuse run (docs/PERFORMANCE.md "Replay
    reuse"), from the newest RETIRED sample's host scalars — one definition
    so train.py and parallel/apex.py can't drift on the row surface (same
    rationale as ``pipeline_gauges``).  Empty at K = 1 so default-path rows
    stay byte-identical."""
    if reuse_k == 1:
        return {}
    ri = scalars.get("reuse_index")
    return {
        "replay_ratio": reuse_k,
        # host-sync-ok: ring-retired host scalars, already materialized
        "reuse_index": None if ri is None else int(ri),
        "clip_frac": scalars.get("clip_frac"),
    }


def reuse_health(reuse_k: int,
                 scalars: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The ``pipeline_gauges(reuse=)`` payload for health rows: None at
    K = 1 (rows stay byte-identical), else K + the newest retired sample's
    mean reuse-pass clip fraction (the K-too-high early warning)."""
    if reuse_k == 1:
        return None
    return {
        "replay_ratio": reuse_k,
        "reuse_clip_frac": scalars.get("clip_frac"),
    }


def pipeline_gauges(ring: WritebackRing, registry, frontier=None,
                    reuse: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """The pipeline-health gauges the loop feeds to ``obs_run.periodic``;
    the sample-ahead ones only while a device frontier is live."""
    out = {
        "writeback_inflight": len(ring),
        "writeback_lag_steps": ring.last_lag,
        "prefetch_queue_depth": registry.gauge(
            "prefetch_queue_depth", "prefetch"
        ).get(),
        "prefetch_empty_waits": registry.counter(
            "prefetch_empty_wait_total", "prefetch"
        ).get(),
    }
    if reuse:
        out.update(reuse)
    if frontier is not None:
        out.update({
            "sample_ahead_queue_depth": registry.gauge(
                "sample_ahead_queue_depth", "prefetch").get(),
            "sample_ahead_stale_indices": registry.counter(
                "sample_ahead_stale_indices_total", "prefetch").get(),
            "mirror_reconcile_s": registry.gauge("mirror_reconcile_s", "frontier").get(),
        })
    return out


class RingCommitter:
    """The commit/quarantine/drain protocol around a WritebackRing.

    ``commit(retired)``: the deferred guard.  A finite step writes its
    priorities back and keeps its host scalars readable via ``scalars`` (the
    metric cadence reads these instead of syncing on the device queue).  A
    non-finite step quarantines EVERY in-flight idx set — the tripped
    entry's AND everything still in the ring (they were sampled/learned from
    states downstream of the poison; |TD|=0 drops them to the eps^omega
    priority floor so none can re-sample into a rollback livelock) — then
    rolls back via ``load_snapshot(*supervisor.rollback())`` to the last
    drained-and-verified snapshot, which is by construction >= the ring
    depth behind the poison.

    ``on_drain`` runs after every clean drain: device sampling reconciles
    the priority mirror into the host sum-trees there, so snapshots,
    publishes and checkpoints read a caught-up cold path.
    """

    def __init__(self, ring: WritebackRing, update_priorities, supervisor,
                 load_snapshot, on_drain: Optional[Callable[[], Any]] = None):
        self.ring = ring
        self._update = update_priorities
        self._sup = supervisor
        self._load_snapshot = load_snapshot
        self._on_drain = on_drain
        self.scalars: Dict[str, float] = {}  # newest retired step's scalars

    def _quarantine_and_rollback(self, bad: RetiredStep) -> None:
        self._update(bad.idx, np.zeros(len(bad.idx)))
        for _step_no, idx in self.ring.flush():
            self._update(idx, np.zeros(len(idx)))
        self._load_snapshot(*self._sup.rollback())

    def commit(self, retired: Optional[RetiredStep]) -> bool:
        """True when the step (or None) is fine; False after a quarantine +
        rollback — the loop should ``continue``."""
        if retired is None:
            return True
        if not self._sup.retire_ok(retired):
            self._quarantine_and_rollback(retired)
            return False
        self._update(retired.idx, retired.priorities)
        self.scalars.update(retired.scalars)
        return True

    def drain(self) -> bool:
        """Ring boundary: retire everything in flight; False when one
        tripped and we rolled back (``on_drain`` is then skipped: the next
        clean drain catches up)."""
        while len(self.ring):
            if not self.commit(self.ring.retire_one()):
                return False
        if self._on_drain is not None:
            self._on_drain()
        return True
