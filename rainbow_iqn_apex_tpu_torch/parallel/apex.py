"""Ape-X on one card (``--role apex``): one device is both the learner and
the actor fleet's inference engine, host vector envs feed a host-memory
sharded prioritized replay, and the learner samples it either on the host
or, with ``device_sampling``, through the device sample frontier.

Counterpart of ``rainbow_iqn_apex_tpu/parallel/apex.py`` (``ActorPriorityEstimator``
:97-135, ``ApexDriver`` :138-522, ``train_apex`` :560-1593) for one process
and one device, ``architecture="iqn"``:

  reference (PyTorch + Redis)          this module
  ---------------------------------    ---------------------------------------
  1 learner process on GPU             the learn step on the card (K1-K4)
  N actor processes on CPUs            batched vector-env lanes, acting on the
                                       same card with a stale actor copy of
                                       the weights (device-resident frame stack)
  Redis experience append              host-memory sharded replay append
  Redis batch fetch + priority write   host sample + write-back, or device
                                       draws (K5f) + write-back into the
                                       device priority mirror (K6f)
  Redis weight mailbox                 publish: learner -> actor copy, bf16-
                                       rounded under ``bf16_weight_sync``, or
                                       gated int8 / fp8 (``serve_quantize``:
                                       K10q, then the actor acts through
                                       K10d and K10g)
  actor-side initial priorities        n-step TD estimate from the actor's own
                                       Q outputs, no extra forward pass

Multi-game (``games``, ``multitask/``): lane blocks pinned to games, the
task-conditioned ``MultiGameIQN`` learner and actor (K2g, K4m; K4l under
reuse), a ``MultiGameReplay`` of game-pinned shard blocks behind the
interleave schedule, per-game ``eval`` rows with an ``eval_mt`` aggregate
and a periodic ``games`` row.  Replay reuse (``replay_ratio`` K > 1): one
sampled batch drives K learn passes (``ops.learn.make_reuse_learn_step``),
the step counter jumps K per batch and cadences fire on crossings.

Not ported, each raising NotImplementedError (ROADMAP.md): league
membership (``league_dir``), the cross-host replay plane
(``replay_net_remote``), learner failover (``failover_standby``), more than
one device or process (A13), and with ``games`` the quantized actors
(``serve_quantize``) and the device frontier (``device_sampling``).  The JAX
loop logs a "notice" and falls back for some of these; the port refuses
them.

Differences of form from the JAX loop:

- Every replay read the learner's batches depend on happens on a worker in
  the order it was asked for, and the loop calls ``settle()`` before each
  host replay write (appends, reconcile, snapshot).  With device sampling,
  the IS exponent, the item count, the flush of staged appends and the
  draws are fixed on this thread when a batch is asked for
  (``utils/prefetch.py:SampleAheadPusher``).  So a seeded run repeats
  exactly in both sampling modes, where the JAX pusher's draws follow
  thread timing.
- ``step`` is the learner's host counter; no device value is read for it.

Run it as ``python -m rainbow_iqn_apex_tpu_torch.train --role apex ...``.
"""

from __future__ import annotations

import collections
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.agents.agent import FrameStacker, put_frames, to_device_batch
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.envs import make_vector_env
from rainbow_iqn_apex_tpu_torch.obs import PipelineTracer, RunObs
from rainbow_iqn_apex_tpu_torch.ops.act import (
    DeviceLike,
    build_act_step,
    load_network,
    resolve_device,
)
from rainbow_iqn_apex_tpu_torch.ops.learn import (
    Batch,
    build_learn_step,
    check_supported,
    host_state,
    init_train_state,
    load_host_state,
)
from rainbow_iqn_apex_tpu_torch.parallel.elastic import (
    HeartbeatMonitor,
    HeartbeatWriter,
    StalenessFence,
    heartbeat_dir,
    next_lease_epoch,
)
from rainbow_iqn_apex_tpu_torch.parallel.multihost import plan_hosts, shift_stack
from rainbow_iqn_apex_tpu_torch.parallel.quant_publish import QuantPublishMixin
from rainbow_iqn_apex_tpu_torch.parallel.sharded_replay import ShardedReplay
from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
from rainbow_iqn_apex_tpu_torch.utils import faults, hostsync
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import (
    Checkpointer,
    maybe_restore_replay,
    maybe_resume,
    rng_extra,
    rng_from_extra,
)
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger
from rainbow_iqn_apex_tpu_torch.utils.prefetch import make_replay_prefetcher
from rainbow_iqn_apex_tpu_torch.utils.writeback import (
    RingCommitter,
    WritebackRing,
    cadence_hit,
    check_reuse_cadences,
    pipeline_gauges,
    reuse_health,
    reuse_learn_row,
)


class ActorPriorityEstimator:
    """Ape-X actor-side initial priorities from the actor's own Q outputs.

    Buffers n+1 ticks of (Q(s, a_sel), reward, terminal) per lane; when the
    replay completes the transition started n ticks ago, emits
        |R_n + gamma^n * maxQ(s_now) * alive - Q(s_then, a_then)|
    with the same truncate-at-terminal rules the replay applies.  A copy of
    the JAX package's (numpy only).
    """

    def __init__(self, lanes: int, n_step: int, gamma: float):
        self.n = n_step
        self.gamma = gamma
        self.q_sel = collections.deque(maxlen=n_step + 1)  # each [L]
        self.rew = collections.deque(maxlen=n_step + 1)
        self.term = collections.deque(maxlen=n_step + 1)

    def push(
        self,
        q_values: np.ndarray,  # [L, A] actor Q estimates at s_t
        actions: np.ndarray,  # [L]
        rewards: np.ndarray,  # [L] r_t
        terminals: np.ndarray,  # [L] d_t
    ) -> Optional[np.ndarray]:
        L = actions.shape[0]
        self.q_sel.append(q_values[np.arange(L), actions])
        self.rew.append(rewards.astype(np.float32))
        self.term.append(terminals.astype(bool))
        if len(self.rew) <= self.n:
            return None
        # window ticks: t-n .. t-1 rewards, bootstrap at t
        r = np.stack(list(self.rew))[:-1]  # [n, L] == r_{t-n..t-1}
        d = np.stack(list(self.term))[:-1]  # [n, L]
        alive = np.cumprod(1.0 - d[:-1].astype(np.float32), axis=0)
        alive = np.concatenate([np.ones((1, L), np.float32), alive], axis=0)
        gammas = self.gamma ** np.arange(self.n, dtype=np.float32)
        rn = (r * alive * gammas[:, None]).sum(axis=0)
        no_done = 1.0 - d.any(axis=0).astype(np.float32)
        boot = (self.gamma**self.n) * q_values.max(axis=1) * no_done
        return np.abs(rn + boot - self.q_sel[0]).astype(np.float64)


def check_apex(cfg: Config) -> None:
    """Raise for the parts of the JAX Ape-X loop the port does not run yet."""
    check_supported(cfg)  # architecture "iqn"
    if cfg.league_dir or cfg.league_member_id >= 0:
        raise NotImplementedError("league membership (league_dir, A19) is not ported yet")
    if cfg.games and cfg.serve_quantize != "off":
        raise NotImplementedError(
            "games with serve_quantize: the quantized multi-game actor needs the game "
            "embedding in K10d and models/quantized.py (ROADMAP.md queue A)")
    if cfg.games and cfg.device_sampling:
        raise NotImplementedError(
            "games with device_sampling: the device frontier's batches do not carry game "
            "ids in the port yet (ROADMAP.md queue A)")
    if cfg.replay_net_remote:
        raise NotImplementedError("the cross-host replay plane (replay_net_remote) is not "
                                  "ported yet")
    if cfg.failover_standby:
        raise NotImplementedError("learner failover (failover_standby) is not ported yet")
    if cfg.learner_devices:
        raise NotImplementedError(
            "learner_devices > 0 (separate learner and actor devices, A13) is not ported yet: "
            "the port's apex runs on one device")


class ApexDriver(QuantPublishMixin):
    """The learner's state and step, the actor's stale copy of the weights
    (bf16 / fp32, or quantized after a passed gate: ``actor``) and its act
    step, on one device.  Randomness: one ``torch.Generator`` on the device,
    seeded from ``cfg.seed``, draws the taus and noise of every act and
    learn step in call order (the quantization gate has its own)."""

    def __init__(self, cfg: Config, num_actions: int,
                 state_shape: Optional[Tuple[int, ...]] = None, device: DeviceLike = None,
                 spec=None):
        self.cfg = cfg
        self.num_actions = num_actions
        self.spec = spec  # multitask.MultiGameSpec: the task-conditioned mode
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # TF32 would round fp32 operands to 10 mantissa bits (as Agent does)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # replay reuse: one learn_batch call is K passes, so step advances K
        self.reuse_k = max(int(cfg.replay_ratio), 1)
        self.generator = torch.Generator(device=self.device).manual_seed(int(cfg.seed))
        self._lane_games: Optional[torch.Tensor] = None  # [L] int32, multi-game only
        if spec is not None:
            from rainbow_iqn_apex_tpu_torch.multitask.ops import (
                build_mt_act_step,
                build_mt_learn_step,
                init_mt_train_state,
                load_mt_network,
            )

            self.state = init_mt_train_state(cfg, spec, cfg.seed, device=self.device)
            self._learn = build_mt_learn_step(cfg, spec)
            self._act = build_mt_act_step(cfg, spec, use_noise=True)
            self.actor_net = load_mt_network(cfg, spec, self.state.net.state_dict(),
                                             self.device, use_noise=True)
        else:
            self.state = init_train_state(cfg, num_actions, cfg.seed, state_shape=state_shape,
                                          device=self.device)
            self._learn = build_learn_step(cfg, num_actions)
            self._act = build_act_step(cfg, num_actions, use_noise=True)
            # the actor's own tensors: Adam updates the learner's in place
            self.actor_net = load_network(cfg, num_actions, self.state.net.state_dict(),
                                          self.device, use_noise=True, state_shape=state_shape)
        self.actor_stack: Optional[torch.Tensor] = None  # made at the first act_frames
        self._init_quant_publish(cfg)
        self.weights_version = 0
        self.actor_weights_version = 0
        self.publish_weights()  # initial broadcast

    # ---------------------------------------------------------------- resume
    def load_state(self, state: Dict[str, Any], extra: Optional[Dict[str, Any]] = None) -> None:
        """A restored host state into the learner, the saved generator state
        when the checkpoint has one, and a re-publish.  The weight version
        resumes from the checkpoint, so a restarted learner publishes
        versions above the ones actors already hold."""
        load_host_state(self.state, state)
        self.generator.set_state(rng_from_extra(extra or {}, self.generator.get_state()))
        saved = int((extra or {}).get("weights_version", 0))
        self.weights_version = max(self.weights_version, saved)
        self.publish_weights()

    def restore(self, ckpt) -> Dict[str, Any]:
        """The latest checkpoint into the learner, re-published; returns its
        extra metadata."""
        state, extra = ckpt.restore()
        self.load_state(state, extra)
        return extra

    def load_snapshot(self, state: Dict[str, Any], key: torch.Tensor) -> None:
        """NaN-guard rollback: the last good host state back into the
        learner.  No re-publish: the poisoned state was never published."""
        load_host_state(self.state, state)
        self.generator.set_state(key)

    # ------------------------------------------------------------- multi-game
    def set_lane_games(self, games: np.ndarray) -> None:
        """Multi-game mode: the [L] per-lane game ids every act call
        conditions on (the lane order of ``multitask.build_game_lanes``)."""
        self._lane_games = put_frames(np.asarray(games, np.int32), self.device)

    @property
    def _game_args(self) -> tuple:
        """The act step's extra operand: the lane game ids in multi-game
        mode, nothing otherwise."""
        return () if self._lane_games is None else (self._lane_games,)

    # ----------------------------------------------------------------- compute
    def act_async(self, stacked_obs: np.ndarray, draws=None):
        """Act on a host [L, H, W, h] stack; returns device (actions, q)
        without waiting.  ``draws`` = (taus, noise) replaces the generator's."""
        return self._act(self.actor, put_frames(stacked_obs, self.device), *self._game_args,
                         self.generator, *(draws or ()))

    def act(self, stacked_obs: np.ndarray, draws=None) -> Tuple[np.ndarray, np.ndarray]:
        a, q = self.act_async(stacked_obs, draws)
        with hostsync.sanctioned():  # the obligatory actor->env hand-off
            return hostsync.to_host(a), hostsync.to_host(q)

    def act_frames(self, frames: np.ndarray, prev_cuts: np.ndarray,
                   draws=None) -> Tuple[np.ndarray, np.ndarray]:
        """Device-stacked acting: push the newest [L, H, W] frames into the
        device-resident stack (zeroing lanes whose episode was cut LAST
        tick, the host FrameStacker's order) and act on it."""
        if self.actor_stack is None:
            h, w = frames.shape[1], frames.shape[2]
            self.actor_stack = torch.zeros((frames.shape[0], h, w, self.cfg.history_length),
                                           dtype=torch.uint8, device=self.device)
        keep = put_frames((~np.asarray(prev_cuts, bool)).astype(np.uint8), self.device)
        shift_stack(self.actor_stack, put_frames(np.asarray(frames, np.uint8), self.device), keep)
        a, q = self._act(self.actor, self.actor_stack, *self._game_args, self.generator,
                         *(draws or ()))
        with hostsync.sanctioned():  # the obligatory actor->env hand-off
            return hostsync.to_host(a), hostsync.to_host(q)

    def learn(self, sample) -> Dict[str, Any]:
        return self.learn_batch(to_device_batch(sample, self.device))

    def learn_batch(self, batch: Batch, draws=None) -> Dict[str, Any]:
        """One learn step; ``info`` stays on the device (the write-back ring
        reads it K steps later)."""
        self.state, info = self._learn(self.state, batch, self.generator, draws)
        return info

    @property
    def step(self) -> int:
        return self.state.step


def _eval_learner(cfg: Config, env, driver: ApexDriver) -> Dict[str, Any]:
    """Evaluate the LEARNER's current params (the reference evaluates the
    learner checkpoint) on a cached eval agent; a drain-boundary sync."""
    from rainbow_iqn_apex_tpu_torch.eval import evaluate_state

    with hostsync.sanctioned():
        return evaluate_state(cfg, env, driver.state, seed=cfg.seed + 977)


def _eval_multigame(cfg: Config, spec, driver: ApexDriver, metrics, step: int,
                    games_obs) -> Dict[str, Any]:
    """Multi-game eval: one ``eval`` row per game (keyed by ``game``) and one
    ``eval_mt`` row with the suite's human-normalized median and mean;
    returns the flat aggregate for the run summary.  A drain-boundary sync."""
    from rainbow_iqn_apex_tpu_torch.multitask.eval import evaluate_multigame

    with hostsync.sanctioned():
        res = evaluate_multigame(cfg, spec, driver.state, seed=cfg.seed + 977)
    games_obs.note_eval(res)
    for name, row in res["games"].items():
        metrics.log("eval", step=step, game=name, **row)
    metrics.log("eval_mt", step=step, score_mean=res["score_mean"],
                hn_median=res["hn_median"], hn_mean=res["hn_mean"],
                hn_games=res["hn_games"], games=len(res["games"]))
    return {key: res[key] for key in ("score_mean", "hn_median", "hn_mean", "hn_games")}


def train_apex(cfg: Config, max_frames: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The Ape-X loop on ``device`` (``cuda:0`` unless named); returns a
    summary dict (final eval, steps, fault counts)."""
    check_apex(cfg)
    device = resolve_device(device)
    total_frames = max_frames or cfg.t_max
    lanes_total = cfg.num_actors * cfg.num_envs_per_actor
    plan = plan_hosts(cfg, lanes_total)
    lanes, lane_lo = plan.lanes, plan.lane_lo
    local_batch = plan.local_batch
    # multi-game mode: per-game lane blocks, the task-conditioned learner,
    # game-pinned replay shard blocks, per-game eval and obs rows
    from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec

    spec = MultiGameSpec.from_config(cfg, device=device)
    games_obs = None
    if spec is not None:
        from rainbow_iqn_apex_tpu_torch.multitask.lanes import build_game_lanes, lane_games
        from rainbow_iqn_apex_tpu_torch.multitask.obs import GamesObs

        if lanes % spec.num_games:
            raise ValueError(f"total lanes {lanes} must divide across {spec.num_games} games")
        env = build_game_lanes(spec, lanes // spec.num_games, seed=cfg.seed + lane_lo,
                               device=device)
        games_obs = GamesObs(spec)
    else:
        # per-lane seeds are carved from the global lane space
        env = make_vector_env(cfg.env_id, lanes, seed=cfg.seed + lane_lo, device=device)
    driver = ApexDriver(cfg, env.num_actions,
                        state_shape=(*env.frame_shape, cfg.history_length), device=device,
                        spec=spec)
    replay_kwargs = dict(
        history=cfg.history_length,
        n_step=cfg.multi_step,
        gamma=cfg.gamma,
        priority_exponent=cfg.priority_exponent,
        priority_eps=cfg.priority_eps,
        seed=cfg.seed + lane_lo,
        use_native=cfg.use_native_sumtree,
    )
    if spec is not None:
        from rainbow_iqn_apex_tpu_torch.multitask.replay import MultiGameReplay

        driver.set_lane_games(lane_games(spec, lanes // spec.num_games))
        # cfg.replay_shards is PER GAME: each game owns its shard block
        shards = max(cfg.replay_shards, 1) * spec.num_games
        memory = MultiGameReplay.build_games(
            spec, max(cfg.replay_shards, 1), cfg.memory_capacity, lanes,
            schedule=cfg.multitask_schedule, **replay_kwargs)
    else:
        shards = cfg.replay_shards
        memory = ShardedReplay.build(max(shards, 1), cfg.memory_capacity, lanes,
                                     frame_shape=env.frame_shape, **replay_kwargs)
    learn_start = cfg.learn_start
    from rainbow_iqn_apex_tpu_torch.train import priority_beta

    run_dir = os.path.join(cfg.results_dir, cfg.run_id)
    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), cfg.run_id,
                            host=cfg.process_id)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    faults.install_from(cfg)
    obs_run = RunObs(cfg, metrics, role="learner", device=device)
    memory.attach_registry(obs_run.registry)
    # pipeline tracing: always-on lag attribution (sample age, ring
    # retirement, publish->adopt) + 1-in-N spans when trace_sample_every > 0
    ptrace = PipelineTracer(metrics, obs_run.registry, cfg.trace_sample_every,
                            host=cfg.process_id)
    ptrace.max_weight_lag = cfg.max_weight_lag
    memory.attach_tracer(ptrace)
    driver.attach_obs(metrics, obs_run.registry, tracer=ptrace)
    sup = TrainSupervisor(cfg, metrics=metrics, registry=obs_run.registry)

    heartbeat = monitor = None
    if cfg.heartbeat_interval_s > 0:
        heartbeat = HeartbeatWriter(
            heartbeat_dir(cfg), cfg.process_id, cfg.heartbeat_interval_s,
            role="apex", shard=cfg.process_id * max(shards, 1),
            # every (re)start claims a fresh incarnation epoch
            epoch=next_lease_epoch(heartbeat_dir(cfg), cfg.process_id),
        )
        if spec is not None:
            # the lease carries the game set this host serves
            heartbeat.update_payload(game=",".join(spec.games))
        heartbeat.set_weight_version(driver.weights_version)
        heartbeat.start()
        monitor = HeartbeatMonitor(heartbeat_dir(cfg), cfg.heartbeat_timeout_s,
                                   self_id=cfg.process_id)
    # the in-process actor adopts each version with its params, so the lag
    # is 0 here; observe() keeps the weight_version_lag gauge live
    fence = StalenessFence(cfg.max_weight_lag, metrics=metrics, registry=obs_run.registry)

    # device sample frontier: the shard priority leaves mirrored on the
    # device, index blocks and IS weights drawn there (K5f), the learner's
    # write-back into the mirror (K6f); off (or depth 0) samples the host
    frontier = None
    if cfg.device_sampling and cfg.sample_ahead_depth > 0:
        from rainbow_iqn_apex_tpu_torch.replay.frontier import DeviceSampleFrontier

        frontier = DeviceSampleFrontier.from_sharded(
            memory, registry=obs_run.registry, seed=cfg.seed + 31, device=device)

    frames = 0
    last_pub = 0
    restored = maybe_resume(cfg, ckpt)
    if restored is not None:
        state, extra, _ = restored
        driver.load_state(state, extra)
        frames = int(extra.get("frames", 0))
        last_pub = driver.step
        maybe_restore_replay(cfg, memory)
        metrics.log("resume", step=driver.step, frames=frames)

    estimator = (ActorPriorityEstimator(lanes, cfg.multi_step, cfg.gamma)
                 if cfg.initial_priority_from_actor else None)
    obs = env.reset()
    returns: collections.deque = collections.deque(maxlen=100)
    prefetcher = None

    def _settle() -> None:
        # the loop's own replay writes wait for the worker's queue, so a
        # seeded run gathers the same batches (utils/prefetch.py)
        if prefetcher is not None:
            prefetcher.settle()

    def _write_back(idx, td_abs) -> None:
        if frontier is not None:  # K6f into the mirror, device tensors in
            frontier.update(idx, td_abs)
        elif prefetcher is not None:  # on the worker, in order with its samples
            prefetcher.update_priorities(idx, td_abs)
        else:
            memory.update_priorities(idx, td_abs)

    def _reconcile() -> None:
        _settle()  # the worker's gathers read the host trees
        frontier.reconcile()

    # pipelined write-back: step t's priorities retire while step t+K runs;
    # with the frontier the |TD| never leaves the device, reconcile() syncs
    # the cold path at drains
    ring = WritebackRing(cfg.writeback_depth, registry=obs_run.registry,
                         materialize_priorities=frontier is None, tracer=ptrace)
    committer = RingCommitter(ring, _write_back, sup, driver.load_snapshot,
                              on_drain=_reconcile if frontier is not None else None)
    last_scalars = committer.scalars  # newest RETIRED step's host scalars
    _commit, _drain = committer.commit, committer.drain
    # replay reuse: one sampled batch drives K learn passes, so the step
    # counter jumps K per batch, the sample trigger divides steps back into
    # batches and cadences fire on crossings (cadence_hit)
    reuse_k = driver.reuse_k
    check_reuse_cadences(cfg, "metrics_interval", "eval_interval", "checkpoint_interval",
                         "guard_snapshot_interval", "weight_publish_interval")

    # device-resident stacking replaces the host FrameStacker (pipelined
    # mode keeps the host stacker: its one-tick lag would need a second
    # device stack in flight)
    use_dstack = cfg.device_frame_stack and not cfg.pipelined_actor
    stacker = None if use_dstack else FrameStacker(lanes, env.frame_shape, cfg.history_length)
    prev_cuts = np.zeros(lanes, bool)
    _append = memory.append_batch
    pending = None  # pipelined: device (actions, q) dispatched last tick
    held = None  # pipelined: completed transition awaiting its Q for append
    try:
        while frames < total_frames:
            tick_tid = ptrace.maybe_trace("a", memory.append_ticks + 1)
            with ptrace.span("act", tick_tid):
                if use_dstack:
                    with obs_run.span("act"):
                        actions, q = driver.act_frames(obs, prev_cuts)
                else:
                    stacked = stacker.push(obs)
                    if cfg.pipelined_actor:
                        # act on THIS obs, execute the action computed from
                        # the PREVIOUS one (the first tick primes the pipe)
                        nxt = driver.act_async(stacked)
                        if pending is None:
                            pending = nxt
                        with hostsync.sanctioned():
                            actions = hostsync.to_host(pending[0])
                    else:
                        actions, q = driver.act(stacked)
            with ptrace.span("env_step", tick_tid):
                new_obs, rewards, terminals, truncs, ep_returns = env.step(actions)
            cuts = terminals | truncs  # truncation cuts windows like a terminal
            _settle()
            if cfg.pipelined_actor:
                # the transition (s_t, a_t, r_t) needs Q(s_t): `nxt`, computed
                # while the envs stepped; append it one tick later
                if held is not None:
                    h_obs, h_act, h_rew, h_term, h_trunc, h_q = held
                    pri = None
                    if estimator:
                        with hostsync.sanctioned():
                            pri = estimator.push(hostsync.to_host(h_q), h_act, h_rew,
                                                 h_term | h_trunc)
                    with ptrace.span("append", tick_tid):
                        _append(h_obs, h_act, h_rew, h_term, pri, truncations=h_trunc)
                held = (obs, actions, rewards, terminals, truncs, nxt[1])
                pending = nxt
            else:
                pri = estimator.push(q, actions, rewards, cuts) if estimator else None
                with ptrace.span("append", tick_tid):
                    _append(obs, actions, rewards, terminals, pri, truncations=truncs)
            if not use_dstack:
                stacker.reset_lanes(cuts)
            prev_cuts = cuts
            obs = new_obs
            frames += lanes_total
            for r in ep_returns[~np.isnan(ep_returns)]:
                returns.append(float(r))

            if len(memory) >= learn_start and memory.sampleable:
                if driver.wants_calibration():
                    # the gate's calibration: one sampled batch's stacked obs,
                    # drawn once at warm-up (only with serve_quantize on, so
                    # the sampler's stream is otherwise untouched)
                    _settle()
                    with hostsync.sanctioned():
                        calib = memory.sample(min(cfg.quant_calib_batch, cfg.batch_size),
                                              priority_beta(cfg, frames))
                    driver.set_calibration(calib.obs)
                if frontier is not None and prefetcher is None:
                    # sample-ahead: device-drawn index blocks, host frame
                    # gathers, staged device batches; the learner only pops
                    from rainbow_iqn_apex_tpu_torch.replay.frontier import make_batch_assembler
                    from rainbow_iqn_apex_tpu_torch.utils.prefetch import SampleAheadPusher

                    prefetcher = SampleAheadPusher(
                        frontier,
                        make_batch_assembler(memory, registry=obs_run.registry),
                        cfg.batch_size,
                        lambda: priority_beta(cfg, frames),
                        lambda: len(memory),
                        device,
                        depth=cfg.sample_ahead_depth,
                        reuse=reuse_k,
                        registry=obs_run.registry,
                    )
                elif frontier is None and cfg.prefetch_depth > 0 and prefetcher is None:
                    prefetcher = make_replay_prefetcher(
                        memory, cfg, lambda: priority_beta(cfg, frames), device,
                        registry=obs_run.registry)
                steps_due = frames // cfg.frames_per_learn - driver.step // reuse_k
                for _ in range(max(steps_due, 0)):
                    if sup.snapshot_due(driver.step):
                        # drain BEFORE capturing: the rollback target must
                        # never hold a step whose finiteness is in flight
                        if not _drain():
                            continue
                        sup.snapshot_if_due(
                            driver.step,
                            lambda: (host_state(driver.state), driver.generator.get_state()))
                    ltid = ptrace.maybe_trace("l", driver.step + 1)
                    if prefetcher is not None:
                        with ptrace.span("gather", ltid):
                            idx, batch = prefetcher.get()
                        links = ptrace.link_ids("a", memory.trace_ids(idx)) if ltid else ()
                        with ptrace.span("learn_step", ltid, links=links, step=driver.step + 1):
                            with obs_run.span("learn_step"):
                                info = driver.learn_batch(sup.poison_maybe(batch))
                        # the mirror's write-back takes the ids staged with the batch
                        wb_idx = batch.idx if frontier is not None else idx
                    else:
                        with ptrace.span("replay_sample", ltid):
                            with obs_run.span("replay_sample"):
                                sample = memory.sample(local_batch, priority_beta(cfg, frames))
                        idx = wb_idx = sample.idx
                        links = ptrace.link_ids("a", memory.trace_ids(idx)) if ltid else ()
                        with ptrace.span("learn_step", ltid, links=links, step=driver.step + 1):
                            with obs_run.span("learn_step"):
                                info = driver.learn(sup.poison_maybe(sample))
                    sup.maybe_stall()
                    # dispatch-only: info stays on the device; the ring
                    # retires step t-K (write-back + deferred NaN guard)
                    if not _commit(ring.push(driver.step, wb_idx, info)):
                        continue
                    step = driver.step
                    obs_run.after_learn_step(step, units=reuse_k)
                    if step - last_pub >= cfg.weight_publish_interval:
                        # actors never adopt params with an unverified step
                        # in their history: everything in flight retires first
                        if not _drain():
                            continue
                        with obs_run.span("publish_weights"):
                            version = driver.publish_weights()
                        last_pub = step
                        obs_run.registry.gauge("weights_version", "learner").set(version)
                        if heartbeat is not None:
                            heartbeat.set_weight_version(version)
                    if cadence_hit(step, cfg.metrics_interval, reuse_k):
                        fence.observe(driver.actor_weights_version, driver.weights_version,
                                      step=step)
                        # scalars of the newest RETIRED step: host floats
                        metrics.log(
                            "learn",
                            step=step,
                            frames=frames,
                            fps=metrics.fps(frames),
                            loss=last_scalars.get("loss", float("nan")),
                            q_mean=last_scalars.get("q_mean", float("nan")),
                            mean_return=float(np.mean(returns)) if returns else float("nan"),
                            staleness=step - last_pub,
                            **reuse_learn_row(reuse_k, last_scalars),
                        )
                        obs_run.periodic(
                            step,
                            frames,
                            replay_size=len(memory),
                            # survivors-aware occupancy from ShardedReplay._observe
                            replay_occupancy=round(
                                obs_run.registry.gauge("replay_occupancy", "replay").get(), 4),
                            weight_staleness=step - last_pub,
                            weights_version=driver.weights_version,
                            weight_version_lag=fence.lag,
                            **pipeline_gauges(ring, obs_run.registry, frontier,
                                              reuse=reuse_health(reuse_k, last_scalars)),
                        )
                        if spec is not None:
                            # per-game learn share, replay occupancy, latest eval
                            metrics.log(
                                "games", step=step, frames=frames,
                                schedule=cfg.multitask_schedule,
                                **games_obs.row(
                                    learn_shares=memory.learn_shares(),
                                    learn_rows=memory.learn_rows_by_game,
                                    sampled_rows=memory.sampled_rows_by_game,
                                    game_sizes=memory.game_sizes(),
                                    game_occupancy=memory.game_occupancy(),
                                    dead_games=memory.dead_games(),
                                ),
                            )
                        ptrace.emit_lag_row(
                            step, **({} if reuse_k == 1 else {"replay_ratio": reuse_k}))
                        if monitor is not None:
                            # host_dead / host_alive edges, once per lease epoch
                            dead, alive = monitor.poll()
                            for lease in dead:
                                metrics.log("fault", event="host_dead", dead_host=lease.host,
                                            epoch=lease.epoch, step=step, frames=frames)
                            for lease in alive:
                                metrics.log("host_alive", alive_host=lease.host,
                                            epoch=lease.epoch, step=step, frames=frames)
                    if cadence_hit(step, cfg.eval_interval, reuse_k):
                        if not _drain():  # evaluate only verified params
                            continue
                        if spec is not None:
                            _eval_multigame(cfg, spec, driver, metrics, step, games_obs)
                        else:
                            metrics.log("eval", step=step, **_eval_learner(cfg, env, driver))
                    if cadence_hit(step, cfg.checkpoint_interval, reuse_k):
                        if not _drain():  # checkpoint only verified params
                            continue
                        sup.save_checkpoint(
                            ckpt, step, driver.state,
                            {"frames": frames, "weights_version": driver.weights_version,
                             **rng_extra(driver.generator)})
                        _settle()
                        sup.save_replay(cfg, memory)
        # end of run: the in-flight tail retires before the final eval/save
        _drain()
    finally:
        if prefetcher is not None:
            prefetcher.close()
        sup.close()
        obs_run.close(driver.step, frames)
        if heartbeat is not None:
            heartbeat.stop()
    if spec is not None:
        final_eval = _eval_multigame(cfg, spec, driver, metrics, driver.step, games_obs)
    else:
        final_eval = _eval_learner(cfg, env, driver)
        metrics.log("eval", step=driver.step, **final_eval)
    sup.save_checkpoint(
        ckpt, driver.step, driver.state,
        {"frames": frames, "weights_version": driver.weights_version,
         **rng_extra(driver.generator)}, critical=True)
    if frontier is not None:
        # the final drain may have been skipped by a rollback: catch the
        # cold-path trees up before they are persisted
        frontier.reconcile()
    sup.save_replay(cfg, memory, critical=True)
    ckpt.wait()
    metrics.close()
    return {
        "frames": frames,
        "learn_steps": driver.step,
        "lanes": lanes_total,
        "train_return_mean": float(np.mean(returns)) if returns else float("nan"),
        "rollbacks": sup.rollbacks,
        "stalls": sup.stalls,
        "io_faults": sup.io_faults,
        **{f"eval_{k}": v for k, v in final_eval.items()},
    }
