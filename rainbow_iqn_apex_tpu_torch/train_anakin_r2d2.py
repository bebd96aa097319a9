"""R2D2 Anakin trainer of the port (``--role anakin --architecture r2d2``):
the recurrent learner and its stored-state sequence replay both on the card,
host envs feeding one small [L, H, W] frame tensor per tick.

Counterpart of ``rainbow_iqn_apex_tpu/train_anakin_r2d2.py``, its host-fed
loop (``_train_anakin_r2d2_hostfed``, :417-584) line for line: the semantics
of the host R2D2 trainer (``train_r2d2.py``) with the sequence ring, the
builders, the LSTM state and the frame stack device-resident across ticks:

- the actor sees the frame-stacked input and an LSTM; the ring stores single
  frames and the PRE-act LSTM state of each step;
- the LSTM state zero-resets on a terminal or a truncation (the keep mask);
- one learn step per ``frames_per_learn * r2d2_seq_len`` env frames, counted
  from the tick the warm gate opens (``filled >= max(learn_start //
  seq_total, 8)`` sequences; it latches);
- evaluation through one ``R2D2Agent(train=False)`` at ``seed + 31`` and
  ``evaluate_r2d2(seed=cfg.seed + 977)``.

Per tick:
  1. act_append: append LAST tick's completed transition with its pre-act
     LSTM state (lag one, so its reward and cut are known), shift the device
     frame stack, zero-reset the cut lanes' LSTM state, all in one K7s
     launch, then act (K9, K3, K4).  Reading the actions back is the loop's one host sync, and it is
     sanctioned.  The ring's counters are host ints, so the warm gate reads
     no device value (the JAX loop reads ``filled`` back each tick until it
     opens).
  2. the fused learn steps when due: draw (K5s), gather (K8s), the R2D2 learn
     step with the priority write-back (K6s) in its K11 launch, with no host
     sync between metrics rows.

Not ported (each raises NotImplementedError): the fully fused loop with the
env on the device (``jaxgame:`` ids with ``fused_env``: its own slice in
ROADMAP.md queue A, on A18's device games and K12) and ``learner_devices >
1`` (ROADMAP.md A13, more than one GPU).  ``replay_ratio > 1`` raises ValueError, as in JAX.

Run it as ``python -m rainbow_iqn_apex_tpu_torch.train --role anakin
--architecture r2d2 ...`` (``cuda:0`` unless ``--device`` names another).
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
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import load_host_state
from rainbow_iqn_apex_tpu_torch.ops.r2d2 import build_r2d2_act_step, init_r2d2_state
from rainbow_iqn_apex_tpu_torch.replay.device_sequence import (
    HOST_FIELDS,
    DeviceSeqState,
    DeviceSequenceReplay,
    build_device_r2d2_learn,
)
from rainbow_iqn_apex_tpu_torch.train import priority_beta
from rainbow_iqn_apex_tpu_torch.utils import hostsync
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import Checkpointer, maybe_resume
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger


def _seq_geometry(cfg: Config):
    """(seq_total, stride, capacity, learn_start_seqs), as the host trainer
    (train_r2d2.train_r2d2) sizes them."""
    seq_total = cfg.r2d2_burn_in + cfg.r2d2_seq_len
    stride = max(seq_total - cfg.r2d2_overlap, 1)
    capacity = max(cfg.memory_capacity // seq_total, 64)
    learn_start_seqs = max(cfg.learn_start // seq_total, 8)
    return seq_total, stride, capacity, learn_start_seqs


def _learn_cadence(cfg: Config):
    """(period_ticks, learns_per_tick) of the fused loop's static cadence:
    one learn step per frames_per_learn * r2d2_seq_len env frames."""
    fps = cfg.frames_per_learn * cfg.r2d2_seq_len
    lanes = cfg.num_envs_per_actor
    if fps % lanes == 0:
        return fps // lanes, 1
    if lanes % fps == 0:
        return 1, lanes // fps
    valid = sorted(
        {d for d in range(1, max(fps, lanes) * 2 + 1)
         if fps % d == 0 or d % fps == 0}
    )
    below = max((d for d in valid if d < lanes), default=None)
    above = min((d for d in valid if d > lanes), default=None)
    near = " or ".join(str(d) for d in (below, above) if d is not None)
    raise ValueError(
        f"fused R2D2 anakin needs lanes ({lanes}) and frames_per_learn * "
        f"r2d2_seq_len ({fps}) to divide one another — the learn cadence "
        f"is compiled into the graph.  Nearest valid --num-envs-per-actor: "
        f"{near}"
    )


def _needs_device_games(name: str):
    raise NotImplementedError(
        f"{name}: the fused R2D2 Anakin loop (the env on the device, jaxgame: ids) is not "
        "ported yet; it waits on its own slice in ROADMAP.md queue A, after A18's device "
        "games and K12")


def build_fused_r2d2_segment(cfg: Config, game, replay: DeviceSequenceReplay, learn_fn,
                             append_fn=None):
    _needs_device_games("build_fused_r2d2_segment")


def init_fused_r2d2_carry(cfg: Config, game, ts, ss, key, frames: int = 0):
    _needs_device_games("init_fused_r2d2_carry")


def build_fused_r2d2_eval(cfg: Config, game, episodes: int, max_ticks: int = 1024):
    _needs_device_games("build_fused_r2d2_eval")


# --------------------------------------------------------- replay snapshot
def _replay_snapshot_path(cfg: Config) -> str:
    return os.path.join(cfg.checkpoint_dir, cfg.run_id, "replay_anakin_r2d2.npz")


def _save_replay(cfg: Config, ss: DeviceSeqState) -> None:
    """The ring under the JAX snapshot's file name and fields."""
    if not cfg.snapshot_replay:
        return
    from rainbow_iqn_apex_tpu_torch.convert import device_seq_state_arrays
    from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

    with hostsync.sanctioned():
        arrays = device_seq_state_arrays(ss)
    snapshot_io.atomic_savez(_replay_snapshot_path(cfg), **arrays)


def _maybe_restore_replay(cfg: Config, ss: DeviceSeqState) -> DeviceSeqState:
    """``ss`` restored in place from the snapshot when there is one of the
    ring's geometry; a geometry change degrades to the cold ring, as in
    JAX."""
    path = _replay_snapshot_path(cfg)
    if not (cfg.snapshot_replay and os.path.exists(path)):
        return ss
    from rainbow_iqn_apex_tpu_torch.convert import from_jax_device_seq_state
    from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

    z = snapshot_io.load(path)
    if tuple(z["frames"].shape) != tuple(ss.frames.shape) or tuple(
            z["buf_frames"].shape) != tuple(ss.buf_frames.shape):
        return ss
    restored = from_jax_device_seq_state(z, device="cpu")
    for name in DeviceSeqState.__dataclass_fields__:
        if name in HOST_FIELDS:
            setattr(ss, name, getattr(restored, name))
        else:
            getattr(ss, name).copy_(getattr(restored, name))
    return ss


# ------------------------------------------------------------------ trainer
def build_act_append(cfg: Config, num_actions: int, replay: DeviceSequenceReplay,
                     generator: Optional[torch.Generator]):
    """The loop's tick on the device, ``(net, stack, ss, lstm, frame, keep,
    prev) -> (actions, lstm, pre)``: append LAST tick's completed transition
    ``prev`` (lag one: reward and cut are known only after env.step; none on
    the first tick), zero-reset the cut lanes' frame stack and LSTM state
    (``keep`` [lanes] 0/1), act on the stack.  ``pre`` is the state the actor
    had BEFORE seeing this frame, which the NEXT append stores (stored-state
    replay).  ``stack`` and ``ss`` are updated in place.  Everything before
    the act is one K7s launch (``DeviceSequenceReplay.act_prologue``)."""
    act_fn = build_r2d2_act_step(cfg, num_actions, use_noise=True)

    def act_append(net, stack, ss, lstm, frame, keep, prev):
        pre = replay.act_prologue(ss, prev, stack, frame, keep, lstm)
        actions, _q, lstm = act_fn(net, stack, pre, generator)
        return actions, lstm, pre

    return act_append


def train_anakin_r2d2(cfg: Config, max_frames: Optional[int] = None,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """R2D2 Anakin on ``device`` (``cuda:0`` unless named): the host-fed
    loop; returns the summary dict."""
    if cfg.replay_ratio > 1:
        raise ValueError(
            "replay_ratio > 1 (clipped replay reuse) is implemented for the "
            "single-process and apex IQN loops; the fused anakin R2D2 "
            "learner rejects it (ROADMAP follow-up)")
    if cfg.fused_env and cfg.env_id.startswith("jaxgame:"):
        _needs_device_games("train_anakin_r2d2 with a jaxgame: env")
    if cfg.learner_devices > 1:
        raise NotImplementedError(
            f"learner_devices={cfg.learner_devices}: the sharded sequence ring is not ported "
            "yet (ROADMAP.md A13, more than one GPU)")
    return _train_anakin_r2d2_hostfed(cfg, max_frames, device)


def _train_anakin_r2d2_hostfed(cfg: Config, max_frames: Optional[int] = None,
                               device: DeviceLike = None) -> Dict[str, Any]:
    """Host-fed R2D2 Anakin: the env on the host, everything else on the
    card across ticks; per tick the host ships one [L, H, W] frame tensor
    and reads back the actions."""
    from rainbow_iqn_apex_tpu_torch.train_r2d2 import R2D2Agent, evaluate_r2d2

    device = resolve_device(device)
    if device.type == "cuda":
        # TF32 would round the fp32 LSTM's products to 10 mantissa bits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    total_frames = max_frames or cfg.t_max
    lanes = cfg.num_envs_per_actor
    env = make_vector_env(cfg.env_id, lanes, seed=cfg.seed, device=device)
    h, w = env.frame_shape
    seq_total, stride, capacity, learn_start_seqs = _seq_geometry(cfg)
    replay = DeviceSequenceReplay(
        capacity=capacity, seq_len=seq_total, frame_shape=(h, w),
        lstm_size=cfg.lstm_size, lanes=lanes, stride=stride,
        priority_exponent=cfg.priority_exponent,
        priority_eps=cfg.priority_eps, device=device,
    )
    ts = init_r2d2_state(cfg, env.num_actions, cfg.seed, frame_shape=(h, w), device=device)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    act_append = build_act_append(cfg, env.num_actions, replay, generator)

    learn = build_device_r2d2_learn(cfg, env.num_actions, replay)

    run_dir = os.path.join(cfg.results_dir, cfg.run_id)
    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), cfg.run_id)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    obs_run = RunObs(cfg, metrics, role="learner", device=device)

    frames = 0
    ss = replay.init_state()
    restored = maybe_resume(cfg, ckpt)
    if restored is not None:
        host, extra, _ = restored
        load_host_state(ts, host)
        frames = int(extra.get("frames", 0))
        ss = _maybe_restore_replay(cfg, ss)
        metrics.log("resume", step=ts.step, frames=frames)
    learn_steps = ts.step

    stack = torch.zeros((lanes, h, w, cfg.history_length), dtype=torch.uint8, device=device)
    lstm = (torch.zeros((lanes, cfg.lstm_size), dtype=torch.float32, device=device),
            torch.zeros((lanes, cfg.lstm_size), dtype=torch.float32, device=device))
    obs = env.reset()
    prev_cuts = np.zeros(lanes, bool)
    prev = None
    returns: collections.deque = collections.deque(maxlen=100)
    frames_per_step = cfg.frames_per_learn * cfg.r2d2_seq_len
    warm = False  # latches: filled is monotone
    warm_open_frames = warm_open_steps = 0

    # one eval agent for the whole run, its state swapped for the learner's
    eval_agent = R2D2Agent(cfg, env.num_actions, env.frame_shape, cfg.seed + 31, train=False,
                           device=device)

    def run_eval(ts):
        eval_agent.state = ts
        return evaluate_r2d2(cfg, eval_agent, seed=cfg.seed + 977)

    try:
        while frames < total_frames:
            frame_d = put_frames(obs, device)
            keep_d = put_frames((~prev_cuts).astype(np.uint8), device)
            with obs_run.span("act_append"):
                actions_d, lstm, pre = act_append(ts.net, stack, ss, lstm, frame_d, keep_d,
                                                  prev)
                actions = hostsync.to_host(actions_d)  # the sanctioned actor->env read
            new_obs, rewards, terminals, truncs, ep_returns = env.step(actions)
            # held for NEXT tick's append: the pre-step frame and pre-act state
            # with this step's action, reward and cut flags (host arrays)
            prev = (frame_d, actions_d, rewards.astype(np.float32), terminals, truncs,
                    pre[0], pre[1])
            prev_cuts = terminals | truncs
            obs = new_obs
            frames += lanes
            for r in ep_returns[~np.isnan(ep_returns)]:
                returns.append(float(r))

            # the warm gate on the ring's own (host) sequence count
            if not warm and ss.filled >= learn_start_seqs:
                warm = True
                # the cadence counts from the warm-open point (no catch-up
                # burst on a barely filled ring), for a resumed run too
                warm_open_frames = frames
                warm_open_steps = learn_steps
            if warm:
                steps_due = ((frames - warm_open_frames) // frames_per_step
                             - (learn_steps - warm_open_steps))
                for _ in range(max(steps_due, 0)):
                    with obs_run.span("learn_step"):
                        ts, ss, info = learn(ts, ss, generator, priority_beta(cfg, frames))
                    learn_steps += 1
                    # no device wait: the learn steps stay asynchronous
                    obs_run.after_learn_step(learn_steps)
                    if learn_steps % cfg.metrics_interval == 0:
                        metrics.log(
                            "learn", step=learn_steps, frames=frames,
                            fps=metrics.fps(frames), loss=hostsync.scalar(info["loss"]),
                            q_mean=hostsync.scalar(info["q_mean"]),
                            grad_norm=hostsync.scalar(info["grad_norm"]),
                            mean_return=float(np.mean(returns)) if returns else float("nan"),
                        )
                        obs_run.periodic(learn_steps, frames)
                    if cfg.eval_interval and learn_steps % cfg.eval_interval == 0:
                        metrics.log("eval", step=learn_steps, **run_eval(ts))
                    if cfg.checkpoint_interval and learn_steps % cfg.checkpoint_interval == 0:
                        ckpt.save(learn_steps, ts, {"frames": frames})
                        _save_replay(cfg, ss)
    finally:
        obs_run.close(learn_steps, frames)
    final_eval = run_eval(ts)
    metrics.log("eval", step=learn_steps, **final_eval)
    ckpt.save(learn_steps, ts, {"frames": frames})
    _save_replay(cfg, ss)
    ckpt.wait()
    metrics.close()
    return {
        "frames": frames,
        "learn_steps": learn_steps,
        "train_return_mean": float(np.mean(returns)) if returns else float("nan"),
        **{f"eval_{k}": v for k, v in final_eval.items()},
    }
