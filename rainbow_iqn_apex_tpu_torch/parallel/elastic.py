"""Role leases and the weight-staleness fence of the port's Ape-X loop.

A copy of the parts of ``rainbow_iqn_apex_tpu/parallel/elastic.py`` (which
is jax-free) that ``parallel/apex.py:train_apex`` uses: per-host lease
files (``HeartbeatWriter``, ``Lease``, ``HeartbeatMonitor``,
``heartbeat_dir``, ``next_lease_epoch``) and the ``StalenessFence`` that
keeps the ``weight_version_lag`` gauge.  Every lease file carries (role,
shard, lease epoch, weight_version); the monitor reports both edges,
``host_dead`` when a lease expires and ``host_alive`` when a host beats
again, once per lease epoch.  The weight mailbox, role claims, epoch fence
and respawn supervisor of the JAX module serve learner failover and
out-of-process actors, which the port does not run yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from rainbow_iqn_apex_tpu_torch.utils import faults


def heartbeat_dir(cfg) -> str:
    return os.path.join(cfg.results_dir, cfg.run_id, "heartbeats")


def next_lease_epoch(directory: str, process_id: int) -> int:
    """Claim this host's next incarnation epoch.  Every process START —
    first launch, scheduler restart, crash-loop relaunch — gets a bumped
    epoch, which is what makes the monitor's once-per-epoch transition
    dedupe see a relaunched incarnation as a NEW death/revival instead of
    suppressing it, and what epoch-fences the dead incarnation's writes.

    The claim is one empty O_EXCL marker file per epoch (``h<i>.e<k>``),
    NOT a read-modify-write counter: a double-launch of the same host id
    (scheduler races its own zombie — exactly the split-brain epoch fencing
    exists for) must end up with two DIFFERENT epochs, and O_EXCL is the
    one primitive that guarantees it.  Markers are a few bytes each and
    bounded by the restart count.  A supervisor that assigns epochs
    explicitly (RoleSupervisor) does not need this; it exists for
    self-managed launches (launch_apex.sh, `--resume auto` under an
    external scheduler)."""
    os.makedirs(directory, exist_ok=True)
    epoch = 0
    while True:
        try:
            fd = os.open(
                os.path.join(directory, f"h{process_id}.e{epoch}"),
                os.O_CREAT | os.O_EXCL | os.O_WRONLY,
            )
            os.close(fd)
            return epoch
        except FileExistsError:
            epoch += 1



# ------------------------------------------------------------- lease writing
class HeartbeatWriter:
    """Daemon thread re-writing this host's lease file every ``interval_s``.

    The file is both the host's liveness heartbeat and its role lease:
    the payload carries (role, shard, lease epoch, weight_version) so the
    monitor can tell a respawned incarnation (new epoch) from a flapping
    file, and an external observer can see what the host was FOR.  Writes
    are atomic (tmp + rename) so a reader never sees a torn JSON.  The
    ``heartbeat_loss`` fault point suppresses writes (a preempted host,
    manufactured); ``lease_lost`` does the same for a live process whose
    renewals stop (a zombie incarnation — the split-brain shape epoch
    fencing exists for)."""

    def __init__(self, directory: str, process_id: int, interval_s: float,
                 injector: Optional[faults.FaultInjector] = None,
                 role: str = "host", shard: Optional[int] = None,
                 epoch: int = 0,
                 payload_fn: Optional[Callable[[], Dict]] = None):
        self.directory = directory
        self.process_id = int(process_id)
        self.interval_s = float(interval_s)
        self.injector = injector if injector is not None else faults.get()
        self.path = os.path.join(directory, f"h{process_id}.json")
        self.payload: Dict = {"role": role, "epoch": int(epoch)}
        if shard is not None:
            self.payload["shard"] = int(shard)
        # the multi-game lease payload field (`game`, read back as
        # Lease.game) rides update_payload like every other contract field
        # dynamic lease payload (serving fleet): merged into every renewal so
        # fast-moving fields (queue_depth, weights_version) ride the lease
        # without the owner calling update_payload on its own hot path
        self.payload_fn = payload_fn
        self.beats = 0
        self.suppressed = 0
        # payload writers (adopt/rollout threads) race the beat thread's
        # read; an unguarded dict resize mid-unpack would raise past the
        # loop's OSError net and silently kill the heartbeat — a healthy
        # engine would then be evicted on a phantom lease expiry
        self._payload_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def set_weight_version(self, version: int) -> None:
        """Stamp the weight version this host currently acts with; rides in
        every subsequent lease renewal (external staleness monitoring)."""
        with self._payload_lock:
            self.payload["weight_version"] = int(version)

    def update_payload(self, **fields: Any) -> None:
        """Merge static fields (lanes, buckets, ...) into every renewal."""
        with self._payload_lock:
            self.payload.update(fields)

    def beat(self) -> None:
        """One lease renewal (also usable inline, without the thread)."""
        if self.injector.enabled:
            hb = self.injector.fire("heartbeat_loss")
            ll = self.injector.fire("lease_lost")
            if hb or ll:
                with self._payload_lock:
                    self.suppressed += 1
                return
        os.makedirs(self.directory, exist_ok=True)
        dynamic: Dict = {}
        if self.payload_fn is not None:
            try:
                dynamic = dict(self.payload_fn())
            except Exception:
                pass  # a flaky gauge read must not suppress the renewal itself
        with self._payload_lock:
            static = dict(self.payload)
        row = {
            "process_id": self.process_id,
            "t_mono": time.monotonic(),
            "t_wall": time.time(),
            **static,
            **dynamic,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(row, f)
        os.replace(tmp, self.path)
        with self._payload_lock:
            self.beats += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.beat()
            except OSError:
                pass  # a flaky FS write is itself a missed beat; keep going
            self._stop.wait(self.interval_s)

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self.beat()  # first beat synchronously: exists before any check
            self._thread = threading.Thread(
                target=self._run, name="heartbeat-writer", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


@dataclasses.dataclass(frozen=True)
class Lease:
    """One host's lease as last observed on disk."""

    host: int
    age_s: float
    fresh: bool  # age <= the monitor's timeout
    role: str = "host"
    shard: Optional[int] = None
    epoch: int = 0
    weight_version: int = -1
    fenced: bool = False  # the host's staleness fence is currently closed
    payload_ok: bool = True  # False: mtime was readable, the JSON was not
    # serving-fleet payload (role "engine", serving/fleet/registry.py): the
    # router discovers capacity and load through the SAME lease machinery
    # that heals training hosts — no second discovery protocol
    lanes: int = 0  # engine mesh width (dispatch weight denominator)
    buckets: Tuple[int, ...] = ()  # padded batch sizes the engine compiled
    queue_depth: int = -1  # engine request-queue depth at the last renewal
    # cross-host serving plane (serving/net/): where this engine's
    # TransportServer listens.  "" / 0 = in-process only — the registry
    # attaches no remote transport and the engine is visible-but-unroutable
    # from other hosts, exactly the pre-net behaviour
    addr: str = ""
    port: int = 0
    # multi-game payload (multitask/): the game (or comma-joined game set)
    # this host's lanes are pinned to — RoleSupervisor respawn decisions and
    # fence monitors stay game-aware without a second discovery channel
    game: Optional[str] = None
    # league payload (league/; docs/LEAGUE.md): which population member this
    # host trains and at which exploit generation — the league controller
    # reads PBT state straight off the lease it already watches, no second
    # discovery channel (same rationale as `game`)
    member: Optional[int] = None
    generation: int = -1
    # learner-failover payload (parallel/failover.py): the learner-role
    # epoch this incarnation trains under.  Distinct from ``epoch`` (the
    # HOST incarnation counter): a learner host may respawn many times
    # (epoch climbs) while the learner ROLE stays at one learner_epoch until
    # a standby takes over.  Standbys fence takeover claims on it.
    learner_epoch: int = 0
    # live fleet telemetry payload (obs/net/): where the obs collector's
    # aggregated /metrics + /fleetz HTTP endpoint listens — dashboards
    # (scripts/obs_top.py) discover it through the same lease the relays
    # dial, no second discovery channel
    http_port: int = 0


# ---------------------------------------------------------- lease monitoring
class HeartbeatMonitor:
    """Scan peer lease files; report dead AND revived hosts, edge-triggered.

    Staleness is judged by file mtime (monotone-ish on one filesystem and
    immune to clock skew between hosts writing wall-clock payloads).  A host
    with NO file yet is not dead — it may simply not have started; only a
    file that existed and stopped updating is a death signal.

    Transition dedupe fires **once per lease epoch**: a host reported dead
    stays reported until it is observed ALIVE (a fresh beat) — NOT until its
    file merely becomes unobservable.  The previous implementation forgot a
    reported host the moment its file vanished (eviction cleanup, a torn
    read racing a rename), so a lingering stale file re-emitted ``host_dead``
    on every poll after such a gap; regression-tested in
    tests/test_multihost.py.  A stale file carrying a HIGHER epoch than the
    one reported is a new incarnation that died before it was ever seen
    fresh — that is a fresh death and fires again.
    """

    def __init__(self, directory: str, timeout_s: float,
                 self_id: Optional[int] = None,
                 skew_tolerance_s: float = 0.0):
        self.directory = directory
        self.timeout_s = float(timeout_s)
        # extra freshness grace absorbing reader-vs-writer clock skew: mtime
        # is stamped by the WRITER's clock (NFS and friends), age by the
        # READER's, so a reader running ahead inflates every age and can
        # false-evict a healthy host (cfg.lease_skew_tolerance_s).  The
        # grace widens only the fresh/dead boundary — reported ages stay raw
        self.skew_tolerance_s = float(skew_tolerance_s)
        self.self_id = self_id
        # host -> lease epoch at which its death was reported; entries are
        # removed ONLY by an observed fresh beat (the bugfix above)
        self._dead_epochs: Dict[int, int] = {}

    def leases(self) -> Dict[int, Lease]:
        """host id -> Lease for every readable lease file."""
        out: Dict[int, Lease] = {}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        now = time.time()
        for name in names:
            if not (name.startswith("h") and name.endswith(".json")):
                continue
            path = os.path.join(self.directory, name)
            try:
                hid = int(name[1:-5])
                age = now - os.path.getmtime(path)
            except (ValueError, OSError):
                continue  # torn tmp file or a peer mid-rename
            payload: Dict = {}
            payload_ok = True
            try:  # payload is best-effort: mtime alone decides liveness
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                payload_ok = False
            shard = payload.get("shard")
            out[hid] = Lease(
                host=hid,
                age_s=age,
                fresh=age <= self.timeout_s + self.skew_tolerance_s,
                role=str(payload.get("role", "host")),
                shard=None if shard is None else int(shard),
                epoch=int(payload.get("epoch", 0) or 0),
                weight_version=int(payload.get("weight_version", -1)),
                fenced=bool(payload.get("fenced", False)),
                payload_ok=payload_ok,
                lanes=int(payload.get("lanes", 0) or 0),
                buckets=tuple(int(b) for b in payload.get("buckets") or ()),
                queue_depth=int(payload.get("queue_depth", -1)),
                game=payload.get("game"),
                member=(None if payload.get("member") is None
                        else int(payload["member"])),
                generation=int(payload.get("generation", -1)),
                learner_epoch=int(payload.get("learner_epoch", 0) or 0),
                addr=str(payload.get("addr", "") or ""),
                port=int(payload.get("port", 0) or 0),
                http_port=int(payload.get("http_port", 0) or 0),
            )
        return out

    def ages(self) -> Dict[int, float]:
        """host id -> seconds since its lease file was last written."""
        return {hid: lease.age_s for hid, lease in self.leases().items()}

    def check(self) -> List[int]:
        """All hosts currently considered dead (stale past timeout)."""
        return sorted(
            hid
            for hid, lease in self.leases().items()
            if not lease.fresh and hid != self.self_id
        )

    def poll(self) -> Tuple[List[Lease], List[Lease]]:
        """(newly_dead, newly_alive) lease lists — the edges since the last
        poll, each fired once per (host, epoch)."""
        newly_dead: List[Lease] = []
        newly_alive: List[Lease] = []
        for hid, lease in sorted(self.leases().items()):
            if hid == self.self_id:
                continue
            if lease.fresh:
                # the alive edge's epoch is LOAD-BEARING (readmission fences
                # on it): if the payload read raced the writer's rename,
                # defer the edge to the next poll rather than hand the
                # controller a default epoch 0 — the file is being actively
                # rewritten every interval, so the retry is imminent.  The
                # DEATH edge below deliberately does not defer: a torn final
                # write from a dying host may never become readable, and a
                # conservative epoch-0 death report (re-fired if a real
                # higher epoch surfaces later) beats missing the death.
                if not lease.payload_ok:
                    continue
                if hid in self._dead_epochs:
                    del self._dead_epochs[hid]
                    newly_alive.append(lease)
            else:
                reported = self._dead_epochs.get(hid)
                if reported is None or lease.epoch > reported:
                    self._dead_epochs[hid] = lease.epoch
                    newly_dead.append(lease)
        return newly_dead, newly_alive

    def newly_dead(self) -> List[int]:
        """Hosts that died since the last poll (compat shim over ``poll``;
        callers that also want the revival edge use ``poll`` directly)."""
        dead, _ = self.poll()
        return [lease.host for lease in dead]


# ------------------------------------------------------------ weight mailbox

# ----------------------------------------------------------- staleness fence
class StalenessFence:
    """Pause acting when the adopted weight version trails the published one
    by more than ``max_lag`` publishes (IMPACT: unbounded staleness corrupts
    learning silently — shedding frames is strictly better than feeding
    replay off-policy-beyond-budget experience).

    ``observe`` returns True when acting is allowed.  Fence/resume edges are
    emitted once per episode as ``actor_fenced`` rows (``action`` is
    "fence" or "resume"); frames refused while fenced accumulate in
    ``shed_frames``.  ``max_lag <= 0`` disables fencing but keeps the
    ``weight_version_lag`` gauge live."""

    def __init__(self, max_lag: int, metrics=None, registry=None,
                 role: str = "actor", game: Optional[str] = None):
        self.max_lag = int(max_lag)
        self.metrics = metrics
        self.registry = registry
        self.role = role
        # multi-game attribution (multitask/): a fence episode on a
        # game-pinned actor lane names WHICH game sheds frames — the
        # "one game collapsed while others train" triage key
        # (docs/RUNBOOK.md)
        self.game = game
        self.fenced = False
        self.fences = 0
        self.shed_frames = 0
        self.lag = 0

    def _gauge(self, name: str, value: float) -> None:
        if self.registry is not None:
            self.registry.gauge(name, self.role).set(value)

    def _edge(self, action: str, step: int) -> None:
        if self.metrics is None:
            return
        extra = {} if self.game is None else {"game": self.game}
        self.metrics.log("actor_fenced", action=action, lag=self.lag,
                         max_lag=self.max_lag, step=int(step), **extra)

    def observe(self, held_version: int, published_version: int,
                step: int = 0, frames_at_stake: int = 0) -> bool:
        self.lag = max(int(published_version) - int(held_version), 0)
        self._gauge("weight_version_lag", self.lag)
        if self.max_lag <= 0:
            return True
        if self.lag > self.max_lag:
            if not self.fenced:
                self.fenced = True
                self.fences += 1
                self._edge("fence", step)
            self.shed_frames += int(frames_at_stake)
            self._gauge("actor_shed_frames", self.shed_frames)
            return False
        if self.fenced:
            self.fenced = False
            self._edge("resume", step)
        return True
