"""Train-loop supervision: NaN/Inf guard with rollback, stall watchdog,
retried checkpoint/replay IO.

The port's copy of ``rainbow_iqn_apex_tpu/parallel/supervisor.py``; its
rollback snapshots are host copies of the state dict, the Adam state and
the generator's state.

Ape-X runs are long-lived by construction (arXiv:1803.00933): over days of
training the learner WILL see a poisoned batch (inf reward from a broken
env, NaN grads from an fp edge), checkpoint IO WILL flake (networked FS),
and a step WILL wedge (device stall, dead collective peer).  Before this
module, any one of those killed `train_apex` outright.  The supervisor
turns them into bounded, reported events:

- **NaN/Inf guard**: every learn step's finiteness is checked.  The hot
  loops compute the flag IN-GRAPH (``info["finite"]``, ops/learn.py) and
  defer the host read to the write-back ring boundary
  (``retire_ok`` — utils/writeback.py), so the guard adds no per-step
  device round-trip; ``step_ok`` remains the synchronous form for loops
  that already hold host scalars (anakin's segment results, tests).  A
  non-finite step rolls params + optimizer state + RNG back to the
  last-good in-memory snapshot and skips the poisoned batch's priority
  write-back — with a ring in flight the caller also quarantines every
  in-flight idx set, and the snapshot is only ever captured at a drain
  point so it can never contain an unverified step; ``max_nan_strikes``
  consecutive bad steps abort the run (`TrainAborted`) — rollback can mask
  a transient, not a systemically poisoned replay.
- **Stall watchdog**: a daemon thread that fires when no learn step
  completes within ``stall_timeout_s`` — the signal a wedged collective or
  device gives you nothing else for.  Detection is reporting (metrics row +
  counter); a Python thread cannot interrupt a blocked device call, so the
  watchdog's job is making the stall visible to the harness watching the
  metrics stream.
- **Retried IO**: checkpoint saves and replay snapshots run under the shared
  bounded backoff-with-jitter policy (utils/faults.RetryPolicy — the same
  policy serving's hot-swap uses).  Interval saves that exhaust the budget
  degrade to a reported fault (training is the product; durability is
  best-effort mid-run); the final save at exit is critical and re-raises.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.utils import faults, hostsync


class TrainAborted(RuntimeError):
    """Too many consecutive non-finite learn steps; rollback cannot help."""


class StallWatchdog:
    """Fires ``on_stall(elapsed_s)`` when ``tick()`` goes quiet for longer
    than ``timeout_s``.  One firing per stall episode (re-arms on the next
    tick).  The thread starts lazily at the first tick so jit compilation
    of the first step never counts as a stall."""

    def __init__(
        self,
        timeout_s: float,
        on_stall: Callable[[float], None],
        poll_s: Optional[float] = None,
    ):
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.poll_s = poll_s if poll_s is not None else max(timeout_s / 4.0, 0.05)
        self.stalls = 0
        self._last: Optional[float] = None
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def tick(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._fired = False
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="stall-watchdog", daemon=True
                )
                self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if self._last is None or self._fired:
                    continue
                elapsed = time.monotonic() - self._last
                if elapsed < self.timeout_s:
                    continue
                self._fired = True
                self.stalls += 1
            try:
                self.on_stall(elapsed)
            except Exception:
                pass  # a broken reporter must not kill the watchdog

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class TrainSupervisor:
    """Wraps a train loop's learn-step sequence with fault handling.

    The loop stays explicit; the supervisor is called at four seams:

        sup.snapshot_if_due(step, lambda: (host_state(...), key))
        batch = sup.poison_maybe(batch)          # chaos: nan_loss point
        info = <learn step>; sup.maybe_stall()   # chaos: stalled_step point
        if sup.step_ok(info): <priority write-back, metrics, publish>
        else: agent.load_snapshot(*sup.rollback())

    plus retried IO: ``sup.save_checkpoint(...)`` / ``sup.save_replay(...)``.
    """

    def __init__(
        self,
        cfg,
        metrics=None,
        injector: Optional[faults.FaultInjector] = None,
        registry=None,
    ):
        self.cfg = cfg
        self.metrics = metrics
        # obs/ wiring: live supervisor gauges (strikes/rollbacks/stalls/IO
        # faults) for /metrics scrapes.  Fault *counters* are folded from the
        # fault rows by obs.health (the MetricsLogger observer), so the row
        # funnel stays the single source and nothing double-counts.
        self.registry = registry
        self.injector = injector if injector is not None else faults.get()
        self.policy = faults.RetryPolicy.from_config(cfg)
        self.max_nan_strikes = int(cfg.max_nan_strikes)
        self.snapshot_interval = max(int(cfg.guard_snapshot_interval), 1)
        self.strikes = 0  # consecutive non-finite steps
        self.rollbacks = 0
        self.io_faults = 0
        self._snap: Optional[Tuple[int, Any, Any]] = None  # (step, state, key)
        self.watchdog: Optional[StallWatchdog] = None
        if cfg.stall_timeout_s > 0:
            self.watchdog = StallWatchdog(cfg.stall_timeout_s, self._on_stall)

    # ------------------------------------------------------------- reporting
    def _report(self, event: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.log("fault", event=event, **fields)
        if self.registry is not None:
            self.registry.gauge("nan_strikes", "supervisor").set(self.strikes)
            self.registry.gauge("rollbacks", "supervisor").set(self.rollbacks)
            self.registry.gauge("stalls", "supervisor").set(self.stalls)
            self.registry.gauge("io_faults", "supervisor").set(self.io_faults)

    def _on_stall(self, elapsed: float) -> None:
        self._report("stalled_step", elapsed_s=round(elapsed, 3))

    @property
    def stalls(self) -> int:
        return self.watchdog.stalls if self.watchdog is not None else 0

    # ------------------------------------------------------------- snapshots
    def snapshot_due(self, step: int) -> bool:
        """True when ``snapshot_if_due(step, ...)`` would capture.  Pipelined
        loops check this FIRST and drain their write-back ring before
        capturing, so the snapshot can never contain an unverified step."""
        return self._snap is None or step - self._snap[0] >= self.snapshot_interval

    def snapshot_if_due(self, step: int, capture: Callable[[], Tuple[Any, Any]]) -> bool:
        """Refresh the last-good (state, key) host copy every
        ``guard_snapshot_interval`` learner steps.  ``capture`` returns host
        copies (``ops.learn.host_state`` of the state dict, the Adam state
        and the step; the generator's state as the key); it runs as a
        sanctioned sync (snapshot cadence, not the per-step hot path)."""
        if not self.snapshot_due(step):
            return False
        with hostsync.sanctioned():
            state, key = capture()
            self._snap = (step, state, key.clone())
        return True

    def rollback(self) -> Tuple[Any, Any]:
        """The last-good (state, key); counts a strike, raises
        ``TrainAborted`` past the budget.  Caller re-places onto its mesh."""
        self.rollbacks += 1
        if self._snap is None:
            self._report("train_aborted", reason="no_snapshot")
            raise TrainAborted(
                "non-finite learn step before any good snapshot existed"
            )
        if self.strikes >= self.max_nan_strikes:
            self._report("train_aborted", reason="strike_budget",
                         strikes=self.strikes)
            raise TrainAborted(
                f"{self.strikes} consecutive non-finite learn steps "
                f"(budget {self.max_nan_strikes}); replay looks poisoned"
            )
        step, state, key = self._snap
        self._report("rollback", to_step=step, strikes=self.strikes)
        return state, key

    # ------------------------------------------------------------ step guard
    def step_ok(self, info: Dict[str, Any]) -> bool:
        """True when the step's loss/grad-norm are finite.  Ticks the stall
        watchdog (a completed step IS the liveness signal).  Synchronous
        form: floats the scalars here (one device->host sync when they are
        still device arrays) — the pipelined loops use ``retire_ok``."""
        if self.watchdog is not None:
            self.watchdog.tick()
        with hostsync.sanctioned():
            loss = float(info["loss"])
            grad = float(info["grad_norm"]) if "grad_norm" in info else 0.0
        return self._finite_ok(loss, grad, math.isfinite(loss) and math.isfinite(grad))

    def retire_ok(self, retired) -> bool:
        """Deferred step guard for the write-back ring (utils/writeback.py):
        the finiteness flag was computed in-graph K steps ago and
        materialized at the ring boundary, so this touches no device value.
        On False the caller must quarantine EVERY in-flight idx set (the
        retired entry's and the ring's flush()) before rolling back."""
        if self.watchdog is not None:
            self.watchdog.tick()
        loss = retired.scalars.get("loss", float("nan"))
        grad = retired.scalars.get("grad_norm", 0.0)
        return self._finite_ok(loss, grad, bool(retired.finite), step=retired.step,
                               lag=retired.lag)

    def _finite_ok(self, loss: float, grad: float, finite: bool, **extra) -> bool:
        if finite:
            self.strikes = 0
            return True
        self.strikes += 1
        self._report(
            "nonfinite_step",
            loss=loss if math.isfinite(loss) else str(loss),
            grad_norm=grad if math.isfinite(grad) else str(grad),
            strikes=self.strikes,
            **extra,
        )
        return False

    # ---------------------------------------------------------------- chaos
    def poison_maybe(self, batch):
        """nan_loss injection point: when armed, returns a copy of the batch
        with non-finite rewards (the shape a broken env/replay corruption
        actually produces), so the guard's detection path is exercised end
        to end.  Disarmed: returns the batch untouched."""
        if not self.injector.enabled or not self.injector.fire("nan_loss"):
            return batch
        self._report("injected_nan_batch")
        reward = batch.reward
        if isinstance(reward, torch.Tensor):  # device Batch (prefetched)
            poisoned = reward * float("nan")
        else:  # host SampledBatch
            poisoned = np.asarray(reward) * np.nan
        return dataclasses.replace(batch, reward=poisoned)

    def maybe_stall(self) -> None:
        """stalled_step injection point: block for cfg.fault_stall_s, as a
        wedged device dispatch would."""
        if self.injector.enabled and self.injector.fire("stalled_step"):
            self._report("injected_stall", seconds=self.cfg.fault_stall_s)
            time.sleep(self.cfg.fault_stall_s)

    # ------------------------------------------------------------ retried IO
    def _retry(self, what: str, fn: Callable, critical: bool) -> bool:
        def on_retry(attempt: int, exc: BaseException) -> None:
            self.io_faults += 1
            self._report(
                "io_retry",
                what=what,
                attempt=attempt,
                error=f"{type(exc).__name__}: {exc}"[:200],
            )

        try:
            faults.retry_call(
                fn, self.policy, retry_on=(OSError, IOError), on_retry=on_retry
            )
            return True
        except (OSError, IOError) as e:
            if critical:
                raise
            self._report(
                "io_failed", what=what, error=f"{type(e).__name__}: {e}"[:200]
            )
            return False

    def save_checkpoint(
        self, ckpt, step: int, state, extra: Optional[Dict[str, Any]] = None,
        critical: bool = False,
    ) -> bool:
        """Checkpointer.save under the shared retry policy.  Interval saves
        (critical=False) degrade to a reported fault on exhaustion; the
        final save at exit should pass critical=True."""
        return self._retry(
            "checkpoint", lambda: ckpt.save(step, state, extra), critical
        )

    def save_replay(self, cfg, memory, critical: bool = False) -> bool:
        from rainbow_iqn_apex_tpu_torch.utils.checkpoint import save_replay_snapshot

        return self._retry(
            "replay_snapshot", lambda: save_replay_snapshot(cfg, memory), critical
        )

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
