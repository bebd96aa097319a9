"""R2D2 training loop of the port: recurrent actor + stored-state sequence replay.

Counterpart of ``rainbow_iqn_apex_tpu/train_r2d2.py`` (:42-243), line for
line: ``train.py``'s act/learn interleave with the frame replay replaced by
``SequenceReplay`` and the actor threading its LSTM state through time,
stored with every step so each sequence starts from the exact state the
actor had.  One learn step per ``frames_per_learn * r2d2_seq_len`` env
frames (the same per-transition reuse as the IQN loop), each followed by its
priority write-back, a device read, as in the JAX loop.

Reached through ``python -m rainbow_iqn_apex_tpu_torch.train --role single
--architecture r2d2`` (``cuda:0`` unless ``--device`` names another).  The
checkpoint extra also carries the generator's state, so a resumed run
continues the noise stream.
"""

from __future__ import annotations

import collections
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.agents.agent import FrameStacker, put_frames
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.envs import make_env, make_vector_env
from rainbow_iqn_apex_tpu_torch.obs import RunObs
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import load_host_state
from rainbow_iqn_apex_tpu_torch.ops.r2d2 import (
    as_actor_input,
    build_r2d2_act_step,
    build_r2d2_learn_step,
    init_r2d2_state,
    to_device_seq_batch,
)
from rainbow_iqn_apex_tpu_torch.replay.sequence import SequenceReplay
from rainbow_iqn_apex_tpu_torch.utils import hostsync
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import (
    Checkpointer,
    maybe_restore_replay,
    maybe_resume,
    rng_extra,
    rng_from_extra,
    save_replay_snapshot,
)
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger


class R2D2Agent:
    """Host facade: recurrent act / learn with an explicit LSTM state."""

    def __init__(self, cfg: Config, num_actions: int, frame_shape, seed: int, train: bool = True,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.num_actions = num_actions
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # TF32 would round the fp32 LSTM's products to 10 mantissa bits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.state = init_r2d2_state(cfg, num_actions, seed, frame_shape, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._act = build_r2d2_act_step(cfg, num_actions)
        self._act_eval = build_r2d2_act_step(cfg, num_actions, use_noise=cfg.eval_noisy)
        self._learn = build_r2d2_learn_step(cfg, num_actions) if train else None

    def initial_lstm_state(self, batch: int):
        return self.state.net.initial_state(batch, self.device)

    def act(self, obs, lstm_state, eval_mode: bool = False, read_state: bool = False):
        """obs [B, H, W] uint8 (history 1) or [B, H, W, hist] stacked ->
        (actions [B] on the host, new state on the device); with
        ``read_state`` also the new state's host copy (c, h), read in the
        same transfer as the actions."""
        fn = self._act_eval if eval_mode else self._act
        x = put_frames(as_actor_input(obs, self.cfg.history_length), self.device)
        action, _, new_state = fn(self.state.net, x, lstm_state, self.generator)
        # the actor->env hand-off is an obligatory host read
        if not read_state:
            return hostsync.to_host(action), new_state
        packed = hostsync.to_host(torch.cat([action[:, None].float(), *new_state], dim=1))
        size = self.cfg.lstm_size
        host = (packed[:, 1:1 + size], packed[:, 1 + size:])
        return packed[:, 0].astype(np.int32), new_state, host

    def learn(self, sample) -> Dict[str, Any]:
        self.state, info = self._learn(self.state, to_device_seq_batch(sample, self.device),
                                       self.generator)
        return info

    @property
    def step(self) -> int:
        return self.state.step


def _mask_reset(lstm_state, terminals: np.ndarray):
    """Zero the (c, h) rows of lanes whose episode just ended."""
    c, h = lstm_state
    keep = put_frames(1.0 - np.asarray(terminals, np.float32), c.device)[:, None]
    return c * keep, h * keep


def evaluate_r2d2(cfg: Config, agent: R2D2Agent, episodes: Optional[int] = None,
                  seed: int = 0, max_steps: int = 200_000, env=None) -> Dict[str, Any]:
    """E greedy episodes (noise off unless ``cfg.eval_noisy``) on a fresh env."""
    episodes = episodes or cfg.eval_episodes
    env = env if env is not None else make_env(cfg.env_id, seed=seed, device=agent.device)
    scores = []
    for _ in range(episodes):
        frame = env.reset()
        state = agent.initial_lstm_state(1)
        stacker = FrameStacker(1, env.frame_shape, cfg.history_length)
        ep_ret = 0.0
        for _ in range(max_steps):
            a, state = agent.act(stacker.push(frame[None]), state, eval_mode=True)
            ts = env.step(int(a[0]))
            frame = ts.obs
            ep_ret += ts.reward
            if ts.terminal or ts.truncated:
                if ts.info and "episode_return" in ts.info:
                    ep_ret = float(ts.info["episode_return"])
                break
        scores.append(ep_ret)
    arr = np.asarray(scores, np.float64)
    return {
        "episodes": episodes,
        "score_mean": float(arr.mean()),
        "score_median": float(np.median(arr)),
        "score_min": float(arr.min()),
        "score_max": float(arr.max()),
    }


def train_r2d2(cfg: Config, max_frames: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Runs R2D2 training on ``device`` (``cuda:0`` unless named); returns
    the summary dict."""
    from rainbow_iqn_apex_tpu_torch.train import priority_beta

    if cfg.replay_ratio > 1:
        raise ValueError(
            "replay_ratio > 1 (clipped replay reuse) is implemented for the "
            "single-process and apex IQN loops; sequence-batch reuse under "
            "LSTM state is the recorded ROADMAP follow-up")
    device = resolve_device(device)
    total_frames = max_frames or cfg.t_max
    lanes = cfg.num_envs_per_actor
    env = make_vector_env(cfg.env_id, lanes, seed=cfg.seed, device=device)
    agent = R2D2Agent(cfg, env.num_actions, env.frame_shape, cfg.seed, device=device)

    seq_total = cfg.r2d2_burn_in + cfg.r2d2_seq_len
    memory = SequenceReplay(
        capacity=max(cfg.memory_capacity // seq_total, 64),
        seq_len=seq_total,
        frame_shape=env.frame_shape,
        lstm_size=cfg.lstm_size,
        lanes=lanes,
        stride=max(seq_total - cfg.r2d2_overlap, 1),
        priority_exponent=cfg.priority_exponent,
        priority_eps=cfg.priority_eps,
        seed=cfg.seed,
    )

    run_dir = os.path.join(cfg.results_dir, cfg.run_id)
    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), cfg.run_id)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    obs_run = RunObs(cfg, metrics, role="learner", device=device)

    frames = 0
    restored = maybe_resume(cfg, ckpt)
    if restored is not None:
        host, extra, _ = restored
        load_host_state(agent.state, host)
        agent.generator.set_state(rng_from_extra(extra, agent.generator.get_state()))
        frames = int(extra.get("frames", 0))
        maybe_restore_replay(cfg, memory)
        metrics.log("resume", step=agent.step, frames=frames)

    obs = env.reset()
    lstm_state = agent.initial_lstm_state(lanes)
    # the host copy of lstm_state: each step's stored state (read with the
    # actions, so a tick makes one device read)
    state_c = np.zeros((lanes, cfg.lstm_size), np.float32)
    state_h = np.zeros_like(state_c)
    stacker = FrameStacker(lanes, env.frame_shape, cfg.history_length)
    returns: collections.deque = collections.deque(maxlen=100)
    learn_start_seqs = max(cfg.learn_start // seq_total, 8)

    def _extra() -> Dict[str, Any]:
        return {"frames": frames, **rng_extra(agent.generator)}

    try:
        while frames < total_frames:
            stacked = stacker.push(obs)  # the actor sees the frame-stacked input
            with obs_run.span("act"):
                actions, lstm_state, (next_c, next_h) = agent.act(stacked, lstm_state,
                                                                  read_state=True)
            new_obs, rewards, terminals, truncs, ep_returns = env.step(actions)
            cuts = terminals | truncs  # a truncation ends the sequence window too
            # the replay stores SINGLE frames; the learn step re-stacks on the device
            memory.append_batch(
                obs, actions, rewards, terminals, state_c, state_h, truncations=truncs
            )
            lstm_state = _mask_reset(lstm_state, cuts)
            keep = (1.0 - cuts.astype(np.float32))[:, None]
            state_c, state_h = next_c * keep, next_h * keep
            stacker.reset_lanes(cuts)
            obs = new_obs
            frames += lanes
            for r in ep_returns[~np.isnan(ep_returns)]:
                returns.append(float(r))

            if len(memory) >= learn_start_seqs:
                # an R2D2 step trains batch_size sequences x seq_len steps:
                # one per frames_per_learn * seq_len frames is the IQN reuse
                frames_per_step = cfg.frames_per_learn * cfg.r2d2_seq_len
                steps_due = frames // frames_per_step - agent.step
                for _ in range(max(steps_due, 0)):
                    with obs_run.span("replay_sample"):
                        sample = memory.sample(cfg.batch_size, priority_beta(cfg, frames))
                    with obs_run.span("learn_step"):
                        info = agent.learn(sample)
                    memory.update_priorities(sample.idx, hostsync.to_host(info["priorities"]))
                    step = agent.step
                    obs_run.after_learn_step(step)
                    if step % cfg.metrics_interval == 0:
                        metrics.log(
                            "learn",
                            step=step,
                            frames=frames,
                            fps=metrics.fps(frames),
                            loss=hostsync.scalar(info["loss"]),
                            q_mean=hostsync.scalar(info["q_mean"]),
                            mean_return=float(np.mean(returns)) if returns else float("nan"),
                            sequences=len(memory),
                        )
                        obs_run.periodic(step, frames, replay_size=len(memory))
                    if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                        ckpt.save(step, agent.state, _extra())
                        save_replay_snapshot(cfg, memory)
    finally:
        obs_run.close(agent.step, frames)
    final_eval = evaluate_r2d2(cfg, agent, seed=cfg.seed + 977)
    metrics.log("eval", step=agent.step, **final_eval)
    ckpt.save(agent.step, agent.state, _extra())
    save_replay_snapshot(cfg, memory)
    ckpt.wait()
    metrics.close()
    return {
        "frames": frames,
        "learn_steps": agent.step,
        "sequences": len(memory),
        "train_return_mean": float(np.mean(returns)) if returns else float("nan"),
        **{f"eval_{k}": v for k, v in final_eval.items()},
    }
