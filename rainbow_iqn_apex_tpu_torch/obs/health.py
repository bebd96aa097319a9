"""RunHealth: fold every liveness signal into one periodic 'health' row.

Ape-X health is not one number — it is the *joint* state of heartbeats
(host_dead rows), supervisor fault rows (nonfinite_step / rollback /
stalled_step / io_retry), serve-side shedding, and the replay/queue gauges.
Before this module a human answered "is this run healthy" by hand-grepping
four row kinds out of metrics.jsonl; RunHealth folds them into a single row

    {"kind": "health", "status": "ok"|"degraded"|"failing", ...}

emitted at the metrics cadence, plus a ``healthz()`` dict the /healthz HTTP
endpoint (obs/export.py) serves live.

Signal plumbing is observational: RunHealth attaches to the MetricsLogger as
a row observer, so every fault/serve/swap row any component logs is counted
here with NO new coupling to the supervisor/serving internals — components
keep reporting exactly as they did before it.

Status rules (deterministic, windowed between ticks):
  failing   - supervisor abort seen (train_aborted), OR consecutive
              non-finite strikes reached the rollback budget, OR a stall
              fired in a window where zero learn steps completed (wedged
              collective/device: the run is not making progress);
  degraded  - any fault row, shed, or dead host in the window, or any host
              currently dead (survivors-only sampling keeps training, but a
              human should know);
  ok        - none of the above.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Optional

from rainbow_iqn_apex_tpu_torch.obs.registry import MetricRegistry


class RunHealth:
    def __init__(
        self,
        registry: MetricRegistry,
        logger=None,
        role: str = "",
        max_nan_strikes: int = 3,
    ):
        self.registry = registry
        self.logger = logger
        self.role = role
        self.max_nan_strikes = max(int(max_nan_strikes), 1)
        self._lock = threading.Lock()
        self.fault_counts: collections.Counter = collections.Counter()
        self.dead_hosts: set = set()
        # elasticity (docs/RESILIENCE.md "heal"): hosts whose lease came
        # back (host_alive) leave dead_hosts; hosts the RoleSupervisor
        # permanently evicted leave dead_hosts too — a deliberately resized
        # fleet is healthy at its new size, not degraded forever — but stay
        # listed so the report shows the run shrank.  Fenced actors hold the
        # run degraded until they resume.
        self.evicted_hosts: set = set()
        self.fenced_hosts: set = set()
        # pipeline tracing (obs/pipeline_trace.py): consumers whose
        # publish->adopt p99 breached the max_weight_lag-derived budget in
        # the newest `lag` row — the window is degraded and the health row
        # NAMES the offender; a clean lag row clears the set
        self.lag_consumers: set = set()
        self.readmits = 0
        # learner failover (parallel/failover.py; docs/RESILIENCE.md
        # "learner failover"): a takeover latches the run degraded until the
        # SUCCESSOR completes its first clean learn step (note_finite_step
        # is the heal edge) — "a standby claimed the role" is only half the
        # story until the claimed learner actually trains.
        self.takeover_pending = False
        self.takeovers = 0
        self.total_shed = 0
        self._last_strikes = 0
        self._aborted = False
        self._stall_active = False  # set by stalled_step, cleared by a
        # completed finite step — lets healthz() report a LIVE wedge as
        # failing even though the hung loop will never tick() again
        # window state (reset every tick)
        self._win_faults: collections.Counter = collections.Counter()
        self._win_shed = 0
        self._last_step: Optional[int] = None
        self._last_status = "ok"
        self._last_row: Dict[str, Any] = {"status": "ok", "step": 0}

    # ----------------------------------------------------------- observation
    def observe_row(self, row: Dict[str, Any]) -> None:
        """MetricsLogger observer: fold fault/serve rows as they are logged."""
        kind = row.get("kind")
        if kind == "fault":
            self.note_fault(str(row.get("event", "unknown")), row)
        elif kind == "serve":
            shed = row.get("shed") or 0
            if shed:
                with self._lock:
                    self.total_shed += shed
                    self._win_shed += shed
                self.registry.counter("shed_total", "serve").inc(shed)
        elif kind == "host_alive":
            host = row.get("alive_host")
            with self._lock:
                if host is not None:
                    self.dead_hosts.discard(host)
                    self.evicted_hosts.discard(host)
            self.registry.counter("host_alive_total", "health").inc()
        elif kind == "shard_readmit":
            with self._lock:
                self.readmits += 1
            self.registry.counter("shard_readmit_total", "health").inc()
        elif kind == "actor_fenced":
            # fenced_host: set when a controller relays another host's fence
            # state (lease-carried); the envelope host is the emitter
            host = row.get("fenced_host", row.get("host", 0))
            resumed = row.get("action") == "resume"
            with self._lock:
                if resumed:
                    self.fenced_hosts.discard(host)
                else:
                    self.fenced_hosts.add(host)
                    # the fence edge itself is a degradation signal for the
                    # window it happened in (frames are being shed)
                    self.fault_counts["actor_fenced"] += 1
                    self._win_faults["actor_fenced"] += 1
            self.registry.counter("actor_fenced_total", "health").inc()
        elif kind == "route":
            # router sheds degrade exactly like serve sheds; a LOST accepted
            # request (engine died, nowhere to re-route) is a fault — the
            # fleet broke its zero-loss invariant
            shed = row.get("shed") or 0
            lost = row.get("lost") or 0
            with self._lock:
                if shed:
                    self.total_shed += shed
                    self._win_shed += shed
                if lost:
                    self.fault_counts["route_lost"] += lost
                    self._win_faults["route_lost"] += lost
            if shed:
                self.registry.counter("shed_total", "router").inc(shed)
        elif kind == "net":
            # cross-host transport flaps (serving/net/): a disconnect /
            # reconnect / bounded-probe timeout means remote capacity
            # silently came or went this window — requests survived (the
            # re-route invariant), but a human should know the wire is
            # churning; a reconnect STORM holds the run degraded window
            # after window exactly like a crash-looping actor
            event = row.get("event")
            if event in ("disconnect", "reconnect", "probe_timeout",
                         "bad_frame"):
                with self._lock:
                    self.fault_counts["net_flap"] += 1
                    self._win_faults["net_flap"] += 1
                self.registry.counter("net_flaps_total", "health").inc()
        elif kind == "replay_net":
            # cross-host replay plane flaps (replay/net/): a disconnect /
            # reconnect / probe timeout / torn frame means replay capacity
            # came or went (the learner re-routes to survivors), and a
            # spool shed means actor experience is being DROPPED — both are
            # things a human should know about, so a flap storm holds the
            # run degraded window after window like the serving plane's
            event = row.get("event")
            if event in ("disconnect", "reconnect", "probe_timeout",
                         "bad_frame", "spool_shed", "peer_dead"):
                with self._lock:
                    self.fault_counts["replay_net_flap"] += 1
                    self._win_faults["replay_net_flap"] += 1
                self.registry.counter(
                    "replay_net_flaps_total", "health").inc()
        elif kind == "obs_net":
            # live telemetry plane flaps (obs/net/): a relay disconnect /
            # reconnect / spool shed means the LIVE fleet view is lossy or
            # churning this window — training is untouched (the plane is
            # never load-bearing and the local JSONL stays complete), but
            # an operator watching the dashboard is watching a partial
            # fleet, so the window degrades with the reason counted
            event = row.get("event")
            if event in ("disconnect", "reconnect", "spool_shed"):
                with self._lock:
                    self.fault_counts["obs_net_flap"] += 1
                    self._win_faults["obs_net_flap"] += 1
                self.registry.counter(
                    "obs_net_flaps_total", "health").inc()
        elif kind == "gossip":
            # federation visibility only: stale peers skew dispatch but the
            # router stays correct (its own view is authoritative), so the
            # row feeds gauges, not degradation
            self.registry.gauge("gossip_peers_fresh", "health").set(
                int(row.get("fresh", 0) or 0))
        elif kind == "scale":
            # a scale action is a sizing decision, not a degradation; count
            # it and track the fleet size for the health row's gauges
            self.registry.counter("scale_events_total", "health").inc()
            engines = row.get("engines")
            if engines is not None:
                self.registry.gauge("fleet_size", "health").set(int(engines))
        elif kind == "rollout":
            self.registry.counter("rollout_events_total", "health").inc()
            if row.get("event") == "refused_backward":
                # the guard WORKED, but something tried to move the fleet
                # backwards — a human should know this window was degraded
                with self._lock:
                    self.fault_counts["rollout_refused"] += 1
                    self._win_faults["rollout_refused"] += 1
        elif kind == "quant_fallback":
            # the agreement gate refused quantized params: the run keeps
            # serving fp32 correctly, but the window is degraded — the
            # operator is paying full-precision cost they configured away
            # (RUNBOOK "agreement gate keeps falling back")
            with self._lock:
                self.fault_counts["quant_fallback"] += 1
                self._win_faults["quant_fallback"] += 1
            self.registry.counter("quant_fallback_total", "health").inc()
        elif kind == "quant":
            if row.get("agreement") is not None:
                self.registry.gauge("quant_action_agreement", "health").set(
                    float(row["agreement"]))
        elif kind == "publish":
            b = int(row.get("bytes") or 0)
            if b:
                self.registry.counter("publish_bytes_total", "health").inc(b)
            self.registry.gauge("publish_bytes_last", "health").set(b)
        elif kind == "league":
            # population-based training (league/; docs/LEAGUE.md): exploit
            # and adoption are NORMAL operation (counted, not degrading) —
            # but a COLLAPSED population (fewer than 2 members alive: the
            # selection loop has nobody left to select between) and a
            # refused adoption (digest mismatch: the bit-exact copy
            # contract broke) degrade the window with the reason named
            event = row.get("event")
            if event == "exploit":
                self.registry.counter("league_exploits_total", "health").inc()
            elif event == "adopt":
                self.registry.counter("league_adoptions_total", "health").inc()
            elif event == "adopt_refused":
                with self._lock:
                    self.fault_counts["league_adopt_refused"] += 1
                    self._win_faults["league_adopt_refused"] += 1
                self.registry.counter(
                    "league_adopt_refused_total", "health").inc()
            if event == "status":
                alive = row.get("alive")
                if alive is not None:
                    self.registry.gauge(
                        "league_members_alive", "health").set(int(alive))
                if row.get("collapsed"):
                    with self._lock:
                        self.fault_counts["league_collapsed"] += 1
                        self._win_faults["league_collapsed"] += 1
        elif kind == "failover":
            # learner failover lifecycle (parallel/failover.py).  A takeover
            # is the single point of failure actually failing — degrade the
            # window AND latch degraded until the successor's first clean
            # learn step (note_finite_step clears the latch).  A fenced
            # stale publish/write-back means a ZOMBIE predecessor is still
            # running — the fence worked, but a human should know it is
            # firing.  Lost claim races are normal standby operation:
            # counted, never degrading.
            event = row.get("event")
            if event == "takeover":
                with self._lock:
                    self.takeover_pending = True
                    self.takeovers += 1
                    self.fault_counts["failover_takeover"] += 1
                    self._win_faults["failover_takeover"] += 1
                self.registry.counter(
                    "failover_takeovers_total", "health").inc()
                mttr = row.get("mttr_s")
                if mttr is not None:
                    self.registry.gauge("failover_mttr_s", "health").set(
                        float(mttr))
            elif event == "fenced_stale":
                with self._lock:
                    self.fault_counts["failover_fenced"] += 1
                    self._win_faults["failover_fenced"] += 1
                self.registry.counter(
                    "failover_fenced_total", "health").inc()
            elif event == "zombie_exit":
                # the fence's terminal edge: a superseded incarnation saw
                # the successor's claim and exited its train loop — counted
                # like the per-surface refusals (a human should know a
                # zombie existed), degrading the window the same way
                with self._lock:
                    self.fault_counts["failover_zombie_exit"] += 1
                    self._win_faults["failover_zombie_exit"] += 1
                self.registry.counter(
                    "failover_zombie_exits_total", "health").inc()
            elif event == "holdoff":
                # takeover-in-progress wait: a standby deferring to a
                # sibling's claimed-but-not-yet-leased takeover — normal
                # race resolution, counted, never degrading
                self.registry.counter(
                    "failover_holdoffs_total", "health").inc()
            elif event == "claim":
                self.registry.counter(
                    "failover_claims_total", "health").inc()
            elif event == "restore":
                self.registry.counter(
                    "failover_restores_total", "health").inc()
        elif kind == "lag":
            # propagation-lag budget check (obs/pipeline_trace.py): the
            # budget is max_weight_lag publishes' worth of publish cadence —
            # a consumer whose publish->adopt p99 exceeds it is adopting
            # weights slower than the staleness fence tolerates, which means
            # it is about to fence (shed frames) or is already serving
            # stale-beyond-budget answers.  Degrade the window and NAME it.
            budget = row.get("publish_adopt_budget_ms")
            per = row.get("publish_adopt_ms_by_consumer") or {}
            breached = ([c for c, s in per.items()
                         if (s or {}).get("p99", 0) > budget]
                        if budget else [])
            with self._lock:
                if breached:
                    self.lag_consumers.update(breached)
                    self.fault_counts["propagation_lag"] += len(breached)
                    self._win_faults["propagation_lag"] += len(breached)
                elif per:
                    # a lag row with adopt stats and no breach is the heal
                    # edge: stop naming consumers that caught back up
                    self.lag_consumers.clear()
            if breached:
                self.registry.counter(
                    "propagation_lag_breaches_total", "health").inc(
                    len(breached))

    def note_fault(self, event: str, row: Optional[Dict[str, Any]] = None) -> None:
        if event == "actor_done":
            # a clean rc=0 completion (finite league member reached t_max)
            # is lifecycle, not degradation: counted, never window-degrading
            with self._lock:
                self.fault_counts[event] += 1
            self.registry.counter(f"fault_{event}_total", "supervisor").inc()
            return
        with self._lock:
            self.fault_counts[event] += 1
            self._win_faults[event] += 1
            if event == "nonfinite_step":
                strikes = (row or {}).get("strikes")
                self._last_strikes = (
                    int(strikes) if strikes is not None else self._last_strikes + 1
                )
            elif event == "rollback":
                pass  # strikes latch until a finite step clears them
            elif event == "stalled_step":
                self._stall_active = True
            elif event == "train_aborted":
                self._aborted = True
            elif event == "host_dead":
                host = (row or {}).get("dead_host")
                if host is not None:
                    self.dead_hosts.add(host)
            elif event == "actor_evicted":
                # permanent, deliberate fleet resize: the host stops holding
                # the run degraded but stays on the books as evicted
                host = (row or {}).get("role_host")
                if host is not None:
                    self.dead_hosts.discard(host)
                    self.evicted_hosts.add(host)
        self.registry.counter(f"fault_{event}_total", "supervisor").inc()

    def note_finite_step(self) -> None:
        """A completed finite learn step clears the strike latch (mirrors
        TrainSupervisor.step_ok) and ends any live stall episode."""
        with self._lock:
            self._last_strikes = 0
            self._stall_active = False
            self.takeover_pending = False  # successor trained: heal edge

    def note_abort(self) -> None:
        self.note_fault("train_aborted")

    # ------------------------------------------------------------- reporting
    def _status_locked(self, steps_in_window: Optional[int]) -> str:
        if self._aborted or self._last_strikes >= self.max_nan_strikes:
            return "failing"
        # a stall with no progress is failing.  On the tick path progress is
        # the step delta; on the LIVE path (healthz of a wedged loop that
        # will never tick again) it is "has any step completed since the
        # stall fired" — the _stall_active latch.
        if self._stall_active and (steps_in_window is None
                                   or steps_in_window <= 0):
            return "failing"
        if (
            sum(self._win_faults.values()) > 0
            or self._win_shed > 0
            or self.dead_hosts
            or self.fenced_hosts
            or self.takeover_pending
        ):
            return "degraded"
        return "ok"

    def status(self) -> str:
        with self._lock:
            return self._status_locked(None)

    def tick(self, step: int, frames: int = 0, **gauges: Any) -> Dict[str, Any]:
        """Close the current window: compute status, emit one 'health' row
        (when a logger is attached), reset window counters.  Extra ``gauges``
        (replay_occupancy, queue_depth, ...) ride along in the row and are
        mirrored into registry gauges for /metrics."""
        with self._lock:
            steps_in_window = (
                None if self._last_step is None else step - self._last_step
            )
            status = self._status_locked(steps_in_window)
            row = {
                "status": status,
                "step": int(step),
                "frames": int(frames),
                "faults_window": int(sum(self._win_faults.values())),
                "faults_total": int(sum(self.fault_counts.values())),
                "rollbacks": int(self.fault_counts.get("rollback", 0)),
                "stalls": int(self.fault_counts.get("stalled_step", 0)),
                "io_retries": int(self.fault_counts.get("io_retry", 0)),
                "nan_strikes": int(self._last_strikes),
                "shed_total": int(self.total_shed),
                "hosts_dead": sorted(self.dead_hosts),
                "hosts_evicted": sorted(self.evicted_hosts),
                "hosts_fenced": sorted(self.fenced_hosts),
                "lag_consumers": sorted(self.lag_consumers),
                "readmits": int(self.readmits),
                "takeovers": int(self.takeovers),
                "takeover_pending": bool(self.takeover_pending),
            }
            self._win_faults.clear()
            self._win_shed = 0
            if steps_in_window is not None and steps_in_window > 0:
                self._stall_active = False  # progress ended the episode
            self._last_step = step
            self._last_status = status
        for k, v in gauges.items():
            row[k] = v
            try:
                self.registry.gauge(k, self.role).set(float(v))
            except (TypeError, ValueError):
                pass  # non-numeric gauge: row-only
        self.registry.gauge(
            "health_status", self.role
        ).set({"ok": 0, "degraded": 1, "failing": 2}[status])
        self._last_row = row
        if self.logger is not None:
            self.logger.log("health", **row)
        return row

    def healthz(self) -> Dict[str, Any]:
        """Live dict for the /healthz endpoint: the LAST emitted row plus the
        instantaneous status (a stall can flip it between ticks)."""
        with self._lock:
            live = self._status_locked(None)
            out = dict(self._last_row)
        out["status"] = live
        out["ts"] = round(time.time(), 3)
        return out
