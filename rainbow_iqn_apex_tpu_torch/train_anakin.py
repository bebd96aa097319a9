"""Anakin trainer of the port (``--role anakin``): the Rainbow-IQN learner and
its prioritized replay both on the card, host envs feeding one small
[L, H, W] frame tensor per tick.

Counterpart of ``rainbow_iqn_apex_tpu/train_anakin.py`` ``train_anakin``
(:84-235), line for line: the same algorithm and schedules as
``--role single`` (act and learn interleaved at ``frames_per_learn``,
n-step PER with max-priority insertion of fresh transitions, the scheduled
target copy inside the learn step, checkpoints, JSONL metrics, periodic
eval), with the replay in device memory (``replay/device.py``).

Per tick:
  1. act_append: append LAST tick's completed transition into the ring (K7;
     lag one, so its reward and terminal are known), shift the
     device-resident frame stack, act on it.  Reading the actions back is
     the loop's one host sync, and it is sanctioned.
  2. the fused learn steps when due: sample (K5, K8), learn, priority
     write-back (K6), with no host sync between metrics rows.

With a ``jaxgame:`` env and ``fused_env`` on (the default), ``train_anakin``
goes to ``train_anakin_fused``: the counterpart of the JAX module's fully
fused variant (:245-542), with the env on the card as well.  Per tick: act
(K2, K3, K4), the games' tick (K12), the replay append (K7), and ``lanes //
frames_per_learn`` learn steps when warm (K5, K8, K1-K4 and their backward
kernels, K6); segments of ``anakin_segment_ticks`` ticks run under
``forbid_host_sync()``, read once each for metrics.

Not ported (raises NotImplementedError): ``replay_ratio > 1``, as in the JAX
package, and the fused path over several GPUs (``learner_devices > 1``).

Run it as ``python -m rainbow_iqn_apex_tpu_torch.train --role anakin ...``.
"""

from __future__ import annotations

import collections
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.envs import make_vector_env
from rainbow_iqn_apex_tpu_torch.obs import RunObs
from rainbow_iqn_apex_tpu_torch.ops.act import (
    DeviceLike,
    build_act_step,
    load_network,
    resolve_device,
)
from rainbow_iqn_apex_tpu_torch.ops.learn import check_supported, init_train_state, load_host_state
from rainbow_iqn_apex_tpu_torch.parallel.multihost import shift_stack
from rainbow_iqn_apex_tpu_torch.replay.device import (
    DeviceReplay,
    DeviceReplayState,
    build_device_learn,
)
from rainbow_iqn_apex_tpu_torch.train import priority_beta
from rainbow_iqn_apex_tpu_torch.utils import hostsync
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import Checkpointer, maybe_resume
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger

_REPLAY_FIELDS = ("frames", "actions", "rewards", "terminals", "cuts", "priority")


def _replay_snapshot_path(cfg: Config) -> str:
    return os.path.join(cfg.checkpoint_dir, cfg.run_id, "replay_anakin.npz")


def _save_replay(cfg: Config, ds: DeviceReplayState) -> None:
    if not cfg.snapshot_replay:
        return
    from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

    with hostsync.sanctioned():
        host = {name: getattr(ds, name).cpu().numpy() for name in _REPLAY_FIELDS}
        host["max_priority"] = ds.max_priority.cpu().numpy()
    snapshot_io.atomic_savez(
        _replay_snapshot_path(cfg), **host,
        pos=np.asarray(ds.pos, np.int32), filled=np.asarray(ds.filled, np.int32))


def _maybe_restore_replay(cfg: Config, ds: DeviceReplayState) -> int:
    """Restores ``ds`` in place from the snapshot when there is one of the
    ring's shape; returns the restored ticks (they drive the host-side
    warmness counters, which must match the restored ring), else 0."""
    path = _replay_snapshot_path(cfg)
    if not (cfg.snapshot_replay and os.path.exists(path)):
        return 0
    from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

    z = snapshot_io.load(path)
    if tuple(z["frames"].shape) != tuple(ds.frames.shape):
        return 0  # shape change: degrade to cold replay, same as the host path
    for name in (*_REPLAY_FIELDS, "max_priority"):
        getattr(ds, name).copy_(torch.from_numpy(np.asarray(z[name])))
    ds.pos, ds.filled = int(z["pos"]), int(z["filled"])
    return int(z["filled"])


def train_anakin(cfg: Config, max_frames: Optional[int] = None,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Runs training on ``device`` (``cuda:0`` unless named); returns a
    summary dict (final eval, steps)."""
    if int(cfg.replay_ratio) > 1:
        raise NotImplementedError(
            "replay_ratio > 1 (clipped replay reuse) targets the actor-bound "
            "apex/single loops; the anakin learner is already fused "
            "device-resident (as in the JAX package)")
    if cfg.fused_env and cfg.env_id.startswith("jaxgame:"):
        return train_anakin_fused(cfg, max_frames, device=device)
    check_supported(cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # TF32 would round fp32 operands to 10 mantissa bits (as Agent does)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    total_frames = max_frames or cfg.t_max
    lanes = cfg.num_envs_per_actor
    env = make_vector_env(cfg.env_id, lanes, seed=cfg.seed, device=device)
    if cfg.memory_capacity % lanes:
        raise ValueError(
            f"memory capacity {cfg.memory_capacity} not divisible by {lanes} lanes")
    seg = cfg.memory_capacity // lanes
    replay = DeviceReplay(
        lanes=lanes, seg=seg, frame_shape=env.frame_shape,
        history=cfg.history_length, n_step=cfg.multi_step, gamma=cfg.gamma,
        priority_exponent=cfg.priority_exponent, priority_eps=cfg.priority_eps,
        device=device,
    )
    ds = replay.init_state()
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    ts = init_train_state(cfg, env.num_actions, cfg.seed,
                          state_shape=(*env.frame_shape, cfg.history_length), device=device)
    act_fn = build_act_step(cfg, env.num_actions, use_noise=True)

    def act_append(stack, ds, frame, keep, prev):
        """Append last tick's completed transition (none on the first
        tick), shift the device stack, act."""
        if prev is not None:
            replay.append(ds, *prev)
        shift_stack(stack, frame, keep)
        actions, _q = act_fn(ts.net, stack, generator)
        return actions

    fused = build_device_learn(cfg, env.num_actions, replay)

    run_dir = os.path.join(cfg.results_dir, cfg.run_id)
    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), cfg.run_id)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    obs_run = RunObs(cfg, metrics, role="learner", device=device)

    frames = 0
    ticks = 0
    restored = maybe_resume(cfg, ckpt)
    if restored is not None:
        host, extra, _ = restored
        load_host_state(ts, host)
        frames = int(extra.get("frames", 0))
        ticks = _maybe_restore_replay(cfg, ds)
        metrics.log("resume", step=ts.step, frames=frames)
    learn_steps = ts.step

    h, w = env.frame_shape
    stack = torch.zeros((lanes, h, w, cfg.history_length), dtype=torch.uint8, device=device)
    obs = env.reset()
    prev_cuts = np.zeros(lanes, bool)
    prev = None  # device-resident (frame, action, reward, term, trunc) of last tick
    returns: collections.deque = collections.deque(maxlen=100)

    try:
        while frames < total_frames:
            frame_d = put_frames(obs, device)
            keep_d = put_frames((~prev_cuts).astype(np.uint8), device)
            with obs_run.span("act_append"):
                actions_d = act_append(stack, ds, frame_d, keep_d, prev)
                actions = hostsync.to_host(actions_d)  # the sanctioned actor->env read
            new_obs, rewards, terminals, truncs, ep_returns = env.step(actions)
            # held for NEXT tick's append: the pre-step frame with this step's
            # action, reward and terminal; the fresh transition's priority is
            # the running max, the reference's single-process insertion rule
            prev = (
                frame_d,
                actions_d,
                put_frames(rewards.astype(np.float32), device),
                put_frames(terminals, device),
                put_frames(truncs, device),
            )
            prev_cuts = terminals | truncs
            obs = new_obs
            frames += lanes
            ticks += 1
            for r in ep_returns[~np.isnan(ep_returns)]:
                returns.append(float(r))

            # warmness from host-side lockstep counters (appends lag one tick)
            stored = min(max(ticks - 1, 0), seg) * lanes
            if stored >= cfg.learn_start and ticks - 1 > cfg.multi_step:
                steps_due = frames // cfg.frames_per_learn - learn_steps
                for _ in range(max(steps_due, 0)):
                    with obs_run.span("learn_step"):
                        ts, ds, info = fused(ts, ds, generator, priority_beta(cfg, frames))
                    learn_steps += 1
                    # no device wait: the learn steps stay asynchronous between
                    # metrics rows; steady-state the device queue throttles the
                    # host, so StepTimer's steps/s stays true
                    obs_run.after_learn_step(learn_steps)
                    if learn_steps % cfg.metrics_interval == 0:
                        metrics.log(
                            "learn",
                            step=learn_steps,
                            frames=frames,
                            fps=metrics.fps(frames),
                            loss=hostsync.scalar(info["loss"]),
                            q_mean=hostsync.scalar(info["q_mean"]),
                            grad_norm=hostsync.scalar(info["grad_norm"]),
                            mean_return=float(np.mean(returns)) if returns else float("nan"),
                        )
                        obs_run.periodic(
                            learn_steps, frames,
                            replay_occupancy=round(stored / cfg.memory_capacity, 4),
                        )
                    if cfg.eval_interval and learn_steps % cfg.eval_interval == 0:
                        metrics.log("eval", step=learn_steps, **_eval(cfg, env, ts))
                    if cfg.checkpoint_interval and learn_steps % cfg.checkpoint_interval == 0:
                        ckpt.save(learn_steps, ts, {"frames": frames})
                        _save_replay(cfg, ds)
    finally:
        obs_run.close(learn_steps, frames)
    final_eval = _eval(cfg, env, ts)
    metrics.log("eval", step=learn_steps, **final_eval)
    ckpt.save(learn_steps, ts, {"frames": frames})
    _save_replay(cfg, ds)
    ckpt.wait()
    metrics.close()
    return {
        "frames": frames,
        "learn_steps": learn_steps,
        "train_return_mean": float(np.mean(returns)) if returns else float("nan"),
        **{f"eval_{k}": v for k, v in final_eval.items()},
    }


def _eval(cfg: Config, env, ts) -> Dict[str, Any]:
    from rainbow_iqn_apex_tpu_torch.eval import evaluate_state

    return evaluate_state(cfg, env, ts, seed=cfg.seed + 977)




# ---------------------------------------------------------------------------
# Fully fused Anakin: the env on the device too (jaxgame:* games, K12)
# ---------------------------------------------------------------------------
def fused_beta(cfg: Config, frames: int) -> float:
    """The IS exponent of the fused tick in fp32, as the JAX graph computes
    ``bw + (1 - bw) * min(frames / t_max, 1)``."""
    frac = np.minimum(np.float32(frames) / np.float32(cfg.t_max), np.float32(1.0))
    return float(np.float32(cfg.priority_weight) + np.float32(1.0 - cfg.priority_weight) * frac)


def build_fused_segment(cfg: Config, game, replay: DeviceReplay, learn_fn):
    """The fused Anakin segment: ``(carry, key, generator, *, draws=None) ->
    (carry, outs)`` runs ``cfg.anakin_segment_ticks`` ticks of act (K2, K3,
    K4) -> env step (K12) -> replay append (K7) -> ``lanes //
    frames_per_learn`` learn steps when warm, all on the device with no host
    sync (eager launches).

    carry = (ts, ds, env_states, ep_returns, stack, frame, keep, frames):
    the train and replay states and the lanes are updated in place, and
    ``frames`` is a host int.  outs = per tick (ep_return [T, L], NaN except
    on cuts; loss, q_mean, grad_norm [T, learns_per_tick], NaN when cold),
    device tensors to read once per segment.

    The env's keys are JAX's: ``split(key, T)`` tick keys, each split into
    (act, step, learn) keys, of which the env step takes the second.  The
    network's taus and noise and the sampler's uniforms come from
    ``generator``; ``draws`` (one dict per tick: ``"act"``: the act step's
    ``taus`` / ``noise``; ``"learn"``: a list of the learn calls' ``u`` /
    ``draws``) replaces them in tests.  The warm gate and beta are computed
    on the host from the replay's host counters, so they need no read-back."""
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import batched_reset_step

    lanes = cfg.num_envs_per_actor
    learns_per_tick = lanes // cfg.frames_per_learn
    seg = replay.seg
    act_fn = build_act_step(cfg, game.num_actions, use_noise=True)
    env_step = batched_reset_step(game)
    ticks = cfg.anakin_segment_ticks

    def segment(carry, key, generator: Optional[torch.Generator], *, draws=None):
        ts, ds, env_s, ep, stack, frame, keep, frames = carry
        keys = prng.split(prng.split(prng.as_key(key), ticks), 3)  # [T, (act, step, learn), 2]
        dev = ds.device
        out_ret = torch.empty((ticks, lanes), dtype=torch.float32, device=dev)
        infos = torch.full((3, ticks, learns_per_tick), float("nan"), device=dev)
        for t in range(ticks):
            tick_draws = draws[t] if draws is not None else {}
            shift_stack(stack, frame, keep)
            actions, _q = act_fn(ts.net, stack, generator, **tick_draws.get("act", {}))
            env_s, ep, next_frame, reward, term, trunc, out_ret[t] = env_step(
                env_s, ep, actions, keys[t, 1])
            # the completed transition, appended the same tick
            replay.append(ds, frame, actions, reward, term, trunc)
            frames += lanes
            stored = min(ds.filled, seg) * lanes
            if stored >= cfg.learn_start and ds.filled > cfg.multi_step:
                beta = fused_beta(cfg, frames)
                learn_draws = tick_draws.get("learn", [{}] * learns_per_tick)
                for i in range(learns_per_tick):
                    ts, ds, info = learn_fn(ts, ds, generator, beta, **learn_draws[i])
                    infos[:, t, i] = torch.stack([info["loss"], info["q_mean"],
                                                  info["grad_norm"]])
            keep = (~(term | trunc)).to(torch.uint8)
            frame = next_frame
        return (ts, ds, env_s, ep, stack, frame, keep, frames), (out_ret, *infos)

    return segment


def build_fused_eval(cfg: Config, game, episodes: int, max_ticks: int = 1024,
                     device: DeviceLike = None):
    """Evaluation on the device: ``episodes`` lanes played greedily (noise
    off, per-tick taus as in eval.py) for up to ``max_ticks``, through the
    shared rollout core (``envs.device_games.build_rollout``): each lane
    scores its first episode, capped at the budget.  Returns ``eval_fn(net,
    key, generator=None, *, taus=None) -> returns [episodes]``: the online
    ``net``'s weights go into a greedy copy; ``taus`` (one [episodes, K]
    tensor per tick) replaces the generator's in tests."""
    from rainbow_iqn_apex_tpu_torch.envs.device_games import build_rollout

    act_fn = build_act_step(cfg, game.num_actions, use_noise=False)
    dev = resolve_device(device)
    greedy = []

    def eval_fn(net, key, generator: Optional[torch.Generator] = None, *, taus=None):
        if not greedy:
            greedy.append(load_network(cfg, game.num_actions, net.state_dict(), dev,
                                       use_noise=False,
                                       state_shape=(*game.frame_shape, cfg.history_length)))
        else:
            with torch.no_grad():
                greedy[0].load_state_dict(net.state_dict())
        tick_taus = iter(taus) if taus is not None else None

        def action_fn(aux, states, stack, gen):
            actions, _q = act_fn(greedy[0], stack, gen,
                                 taus=None if tick_taus is None else next(tick_taus))
            return actions

        rollout = build_rollout(game, action_fn, episodes, max_ticks,
                                history=cfg.history_length, device=dev)
        return rollout(None, key, generator)

    return eval_fn


def fused_eval_scores(eval_fn, net, key, generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
    """Host summary of ``build_fused_eval``'s returns, with the keys of
    ``eval.evaluate`` (so metrics rows are interchangeable)."""
    scores = hostsync.to_host(eval_fn(net, key, generator))
    return {
        "episodes": int(len(scores)),
        "score_mean": float(scores.mean()),
        "score_median": float(np.median(scores)),
        "score_min": float(scores.min()),
        "score_max": float(scores.max()),
    }


def init_fused_carry(cfg: Config, game, replay: DeviceReplay, ts, ds, key, frames: int = 0):
    """Fresh lanes (``batched_init`` from ``key``, K12 on the card) and an
    empty device stack for ``build_fused_segment``, on the replay's device."""
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init

    lanes = cfg.num_envs_per_actor
    h, w = game.frame_shape
    dev = replay.device
    env_s, frame = game_init(game, key, lanes, dev)
    ep = torch.zeros(lanes, dtype=torch.float32, device=dev)
    stack = torch.zeros((lanes, h, w, cfg.history_length), dtype=torch.uint8, device=dev)
    keep = torch.ones(lanes, dtype=torch.uint8, device=dev)
    return (ts, ds, env_s, ep, stack, frame, keep, int(frames))


def train_anakin_fused(cfg: Config, max_frames: Optional[int] = None,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """Everything on the card: act -> env step -> replay append -> (learn x
    k), ``anakin_segment_ticks`` ticks per segment, with a handful of host
    reads per segment for metrics.  The semantics of the host-fed loop:
    the same learn step, max-priority fresh insertion, two-channel cuts, beta
    anneal and warm gate.  One deliberate difference, the JAX package's own:
    the learn cadence is ``lanes / frames_per_learn`` steps per warm tick
    (lanes must divide by frames_per_learn).  Runs on ``device`` (``cuda:0``
    unless named); returns the summary dict."""
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game, tick_budget

    total_frames = max_frames or cfg.t_max
    lanes = cfg.num_envs_per_actor
    if lanes % cfg.frames_per_learn:
        raise ValueError(
            f"fused anakin needs lanes ({lanes}) divisible by frames_per_learn "
            f"({cfg.frames_per_learn}) — the learn cadence is in-graph")
    if cfg.learner_devices > 1:
        raise NotImplementedError(
            f"learner_devices={cfg.learner_devices}: the lane-sharded fused anakin over "
            "several GPUs is not ported yet (ROADMAP.md queue A item 9)")
    check_supported(cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # TF32 would round fp32 operands to 10 mantissa bits (as Agent does)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ticks = cfg.anakin_segment_ticks
    game_name = cfg.env_id.split(":", 1)[1]
    game = make_device_game(game_name)
    h, w = game.frame_shape
    if cfg.memory_capacity % lanes:
        raise ValueError(
            f"memory capacity {cfg.memory_capacity} not divisible by {lanes} lanes")
    seg = cfg.memory_capacity // lanes
    replay = DeviceReplay(
        lanes=lanes, seg=seg, frame_shape=(h, w),
        history=cfg.history_length, n_step=cfg.multi_step, gamma=cfg.gamma,
        priority_exponent=cfg.priority_exponent, priority_eps=cfg.priority_eps,
        device=device,
    )
    key = prng.prng_key(cfg.seed)
    key, _k_init, k_env = prng.split(key, 3)
    ts = init_train_state(cfg, game.num_actions, cfg.seed,
                          state_shape=(h, w, cfg.history_length), device=device)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    segment = build_fused_segment(cfg, game, replay,
                                  build_device_learn(cfg, game.num_actions, replay))

    run_dir = os.path.join(cfg.results_dir, cfg.run_id)
    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), cfg.run_id)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    obs_run = RunObs(cfg, metrics, role="learner", device=device)

    frames = 0
    ds = replay.init_state()
    restored = maybe_resume(cfg, ckpt)
    if restored is not None:
        host, extra, _ = restored
        load_host_state(ts, host)
        frames = int(extra.get("frames", 0))
        # the replay snapshot only on an actual resume: a fresh run with the
        # same run_id cold-starts its ring
        _maybe_restore_replay(cfg, ds)
        metrics.log("resume", step=ts.step, frames=frames)
    learn_steps = ts.step
    carry = init_fused_carry(cfg, game, replay, ts, ds, k_env, frames)

    eval_fn = build_fused_eval(cfg, game, cfg.eval_episodes,
                               max_ticks=tick_budget(game_name, 1024), device=device)
    eval_gen = torch.Generator(device=device)

    def run_eval(step_no: int) -> Dict[str, Any]:
        # deterministic per eval point: the env keys from the JAX eval key,
        # the taus from a generator seeded from the same point
        k = prng.fold_in(prng.prng_key(cfg.seed + 977), step_no)
        eval_gen.manual_seed((cfg.seed + 977) * 1_000_003 + step_no)
        return fused_eval_scores(eval_fn, carry[0].net, k, eval_gen)

    returns: collections.deque = collections.deque(maxlen=100)

    def crossed(interval: int, before: int, after: int) -> bool:
        return interval > 0 and before // interval != after // interval

    def nan_mean(x: np.ndarray) -> float:
        return float(np.nanmean(x)) if np.any(~np.isnan(x)) else float("nan")

    try:
        while frames < total_frames:
            key, k = prng.split(key, 2)
            with obs_run.span("segment", ticks=ticks):
                with hostsync.forbid_host_sync():
                    carry, (out_ret, loss, q_mean, grad_norm) = segment(carry, k, generator)
                ts, ds, frames = carry[0], carry[1], carry[7]
                prev_steps, learn_steps = learn_steps, ts.step
                # the segment's one read: its per-tick returns and learn rows
                ret_h = hostsync.to_host(out_ret)
            obs_run.after_learn_step(learn_steps)
            for r in ret_h[~np.isnan(ret_h)]:
                returns.append(float(r))

            if crossed(cfg.metrics_interval, prev_steps, learn_steps):
                metrics.log(
                    "learn",
                    step=learn_steps,
                    frames=frames,
                    fps=metrics.fps(frames),
                    loss=nan_mean(hostsync.to_host(loss)),
                    q_mean=nan_mean(hostsync.to_host(q_mean)),
                    grad_norm=nan_mean(hostsync.to_host(grad_norm)),
                    mean_return=float(np.mean(returns)) if returns else float("nan"),
                )
                obs_run.periodic(learn_steps, frames)
            if crossed(cfg.eval_interval, prev_steps, learn_steps):
                metrics.log("eval", step=learn_steps, **run_eval(learn_steps))
            if crossed(cfg.checkpoint_interval, prev_steps, learn_steps):
                ckpt.save(learn_steps, ts, {"frames": frames})
                _save_replay(cfg, ds)
    finally:
        obs_run.close(learn_steps, frames)
    final_eval = run_eval(learn_steps)
    metrics.log("eval", step=learn_steps, **final_eval)
    ckpt.save(learn_steps, ts, {"frames": frames})
    _save_replay(cfg, ds)
    ckpt.wait()
    metrics.close()
    return {
        "frames": frames,
        "learn_steps": learn_steps,
        "train_return_mean": float(np.mean(returns)) if returns else float("nan"),
        **{f"eval_{k}": v for k, v in final_eval.items()},
    }
