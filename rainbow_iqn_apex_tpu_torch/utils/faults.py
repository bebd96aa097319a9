"""Deterministic fault injection + the one retry/backoff policy.

Ape-X's premise is long-running distributed training where actors, the
replay fabric, and the learner fail independently (arXiv:1803.00933); a
resilient stack therefore needs a way to *manufacture* those failures on
demand, deterministically, so chaos tests and soak runs exercise the same
recovery code that real preemptions will.  This module is that mechanism:

- ``FaultInjector``: named injection points, armed from ``Config.fault_spec``
  or the ``RIA_FAULTS`` env var (env wins — a soak harness can arm faults
  without touching run configs).  Firing is deterministic: ``point@n`` fires
  on the n-th call, ``point:p`` fires with seeded probability p, bare
  ``point`` fires every call.  The hooks live where real faults strike —
  Checkpointer.save (write failure), snapshot_io.atomic_savez (torn file),
  the supervisor's step loop (NaN batch, stalled step), the heartbeat writer
  (dead host) — so an injected fault takes the same code path as a real one.
- ``RetryPolicy`` / ``retry_call``: bounded retry with exponential backoff
  and deterministic jitter, shared by training checkpoint/snapshot IO and
  the serving hot-swap (one retry policy across serving + training).
- ``FailureBudget``: bounded per-key strike counting with poisoning — the
  policy serving/swap.py previously hand-rolled per checkpoint step.

The fault matrix (injection point -> detection -> recovery) is documented in
docs/RESILIENCE.md.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

# Named injection points.  Adding one means adding the hook AND a row to the
# docs/RESILIENCE.md fault matrix AND a chaos test exercising it.
POINTS = (
    "checkpoint_write",  # Checkpointer.save raises IOError (flaky/remote FS)
    "replay_snapshot_corrupt",  # atomic_savez lands a corrupt file (torn write)
    "nan_loss",  # the sampled batch is poisoned with non-finite rewards
    "stalled_step",  # the learn step blocks (wedged device / collective)
    "heartbeat_loss",  # a host stops writing its heartbeat file (preemption)
    "actor_exit",  # an actor process exits mid-run (OOM kill, crash loop)
    "lease_lost",  # a LIVE process stops renewing its lease (zombie / split
    # brain: the incarnation epoch fencing exists for)
    "shard_rejoin",  # shard readmission fails once (re-registration raced)
    "learner_exit",  # the LEARNER process exits mid-run (the last single
    # point of failure; a live standby claims the role — failover)
    "standby_claim",  # a standby's takeover claim attempt fails once
    # (filesystem hiccup mid-O_EXCL; the standby re-arms and re-claims)
    "net_delay",  # a wire write stalls (latency spike; netcore/chaos.py
    # consults this at its delay decision site)
    "net_corrupt",  # one outgoing wire byte flips (CRC catches it; the
    # plane must convert to its typed Frame* error and reconnect)
    "net_partition",  # an outgoing wire write is silently dropped
    # (one-way partition / frame-atomic loss; ack timeout, not corruption)
    "net_slow_peer",  # this process reads the wire slowly (slow consumer;
    # the peer's bounded per-conn queue must shed only THIS connection)
)

ENV_VAR = "RIA_FAULTS"


class FaultSpecError(ValueError):
    pass


def _parse_spec(spec: str) -> Dict[str, Tuple[Set[int], float, bool]]:
    """``"nan_loss@5,checkpoint_write@1,heartbeat_loss:0.5"`` ->
    {point: (fire_at_calls, probability, always)}."""
    out: Dict[str, Tuple[Set[int], float, bool]] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        name, at, prob, always = entry, None, 0.0, False
        if "@" in entry:
            name, _, n = entry.partition("@")
            try:
                at = int(n)
            except ValueError:
                raise FaultSpecError(f"bad call index in fault entry '{entry}'")
            if at < 1:
                raise FaultSpecError(f"call index must be >= 1 in '{entry}'")
        elif ":" in entry:
            name, _, p = entry.partition(":")
            try:
                prob = float(p)
            except ValueError:
                raise FaultSpecError(f"bad probability in fault entry '{entry}'")
            if not 0.0 <= prob <= 1.0:
                raise FaultSpecError(f"probability out of [0,1] in '{entry}'")
        else:
            always = True
        if name not in POINTS:
            raise FaultSpecError(
                f"unknown fault point '{name}' (known: {', '.join(POINTS)})"
            )
        ats, pr, alw = out.get(name, (set(), 0.0, False))
        if at is not None:
            ats.add(at)
        out[name] = (ats, max(pr, prob), alw or always)
    return out


class FaultInjector:
    """Seeded, counter-based fault firing at named points.

    Call counters are per-point and thread-safe (the prefetcher and the
    heartbeat writer run off the main thread).  ``fire(point)`` increments
    the point's counter and reports whether this call should fault; the
    decision sequence is a pure function of (spec, seed, call order), so a
    chaos test replays exactly.
    """

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self._rules = _parse_spec(spec)
        self._rng = random.Random(seed)
        self._calls: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    def has(self, point: str) -> bool:
        """Whether the spec arms ``point`` at all, WITHOUT counting a call
        (hot paths gate on this before paying for ``fire()``)."""
        return point in self._rules

    def fire(self, point: str) -> bool:
        """True when the current call at ``point`` should fault."""
        if point not in POINTS:
            raise FaultSpecError(f"unknown fault point '{point}'")
        with self._lock:
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            rule = self._rules.get(point)
            if rule is None:
                return False
            ats, prob, always = rule
            hit = always or n in ats or (prob > 0.0 and self._rng.random() < prob)
            if hit:
                self._fired[point] = self._fired.get(point, 0) + 1
            return hit

    def calls(self, point: str) -> int:
        with self._lock:
            return self._calls.get(point, 0)

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)


# ------------------------------------------------------------- global access
# Deep hooks (snapshot_io, checkpoint) cannot thread an injector argument
# through every caller; they consult the installed one.  Default: disabled.
_NULL = FaultInjector("")
_current: FaultInjector = _NULL


def install(injector: Optional[FaultInjector]) -> FaultInjector:
    global _current
    _current = injector if injector is not None else _NULL
    return _current


def install_from(cfg) -> FaultInjector:
    """Arm injection from Config/env (env var wins so soak harnesses can arm
    chaos without editing run configs).  No spec -> the null injector."""
    spec = os.environ.get(ENV_VAR, "") or getattr(cfg, "fault_spec", "")
    return install(FaultInjector(spec, seed=getattr(cfg, "seed", 0)))


def get() -> FaultInjector:
    return _current


# ------------------------------------------------------------ retry/backoff
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter.

    ``attempts`` is the TOTAL number of tries (1 = no retry).  Delay before
    retry k (k>=1) is ``min(base_delay_s * 2**(k-1), max_delay_s)`` scaled by
    a jitter factor in [1-jitter, 1+jitter] drawn from a seeded stream, so
    two runs with the same seed back off identically (and a fleet of runs
    with different seeds doesn't thundering-herd a shared filesystem).
    """

    attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        return cls(
            attempts=cfg.io_retry_attempts,
            base_delay_s=cfg.io_retry_base_s,
            max_delay_s=cfg.io_retry_max_s,
            seed=cfg.seed,
        )

    def delays(self) -> Sequence[float]:
        """The full backoff schedule (delay before retry 1..attempts-1)."""
        rng = random.Random(self.seed)
        out = []
        for k in range(1, self.attempts):
            d = min(self.base_delay_s * (2 ** (k - 1)), self.max_delay_s)
            out.append(d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))
        return out


def retry_call(
    fn: Callable,
    policy: RetryPolicy = RetryPolicy(),
    retry_on: Tuple = (OSError, IOError),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` under ``policy``; re-raises the last error when the
    budget is exhausted.  ``on_retry(attempt, exc)`` observes each failure
    (metrics hook)."""
    delays = policy.delays()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — bounded, IO-dominated
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt >= policy.attempts:
                raise
            sleep(delays[attempt - 1])
    raise last  # unreachable; keeps type-checkers honest


# ----------------------------------------------------------- failure budget
class FailureBudget:
    """Bounded per-key failure counting with poisoning.

    The policy serving/swap.py hand-rolled for checkpoint steps, shared:
    ``record(key)`` counts a failure; once a key accumulates
    ``max_failures`` it is poisoned — callers stop retrying it (no retry
    storm against a genuinely bad artifact).  ``clear(key)`` un-poisons
    after a success (a recovered artifact is whole again).
    """

    def __init__(self, max_failures: int = 3):
        self.max_failures = int(max_failures)
        self._counts: Dict = {}
        self._lock = threading.Lock()

    def record(self, key) -> int:
        with self._lock:
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            return n

    def failures(self, key) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def poisoned(self, key) -> bool:
        with self._lock:
            return self._counts.get(key, 0) >= self.max_failures

    def clear(self, key) -> None:
        with self._lock:
            self._counts.pop(key, None)
