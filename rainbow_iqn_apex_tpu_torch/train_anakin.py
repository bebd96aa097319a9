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

Not ported (each raises NotImplementedError): the fused variant with the env
on the device (``train_anakin_fused`` and its helpers, for ``jaxgame:``
envs) and ``replay_ratio > 1``.

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
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, build_act_step, resolve_device
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
        return train_anakin_fused(cfg, max_frames)
    check_supported(cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # TF32 would round fp32 operands to 10 mantissa bits (as Agent does)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    total_frames = max_frames or cfg.t_max
    lanes = cfg.num_envs_per_actor
    env = make_vector_env(cfg.env_id, lanes, seed=cfg.seed)
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
# Fully fused Anakin: the env on the device (jaxgame:* games) -- not ported
# ---------------------------------------------------------------------------
def _needs_device_games(name: str):
    raise NotImplementedError(
        f"{name}: the fused Anakin trainer needs the on-device games "
        "(envs/device_games.py), which are not ported yet")


def train_anakin_fused(cfg: Config, max_frames: Optional[int] = None) -> Dict[str, Any]:
    _needs_device_games("train_anakin_fused")


def build_fused_segment(cfg: Config, game, replay: DeviceReplay, learn_fn):
    _needs_device_games("build_fused_segment")


def build_fused_eval(cfg: Config, game, episodes: int, max_ticks: int = 1024):
    _needs_device_games("build_fused_eval")


def fused_eval_scores(eval_fn, params, key) -> Dict[str, Any]:
    _needs_device_games("fused_eval_scores")


def init_fused_carry(cfg: Config, game, replay: DeviceReplay, ts, ds, key, *args, **kwargs):
    _needs_device_games("init_fused_carry")
