"""R2D2 sequence learn step and recurrent act step of the port.

Counterpart of ``rainbow_iqn_apex_tpu/ops/r2d2.py``: replay the first
``burn_in`` steps of each stored sequence without gradient to warm the LSTM
state from its stored (c, h), train on the rest; targets through the value
rescale h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x; n-step double-Q with
the online unroll choosing a* and the target unroll evaluating it; sequence
priority eta max|td| + (1 - eta) mean|td|.

On CUDA: the in-sequence frame stack is K8s-stack, each unroll's recurrence
K9 (the online train unroll's backward K9-bwd), the heads K3 (+K3-bwd), the
dueling combine K4 (the online one in gather mode, +K4-bwd), and the TD,
loss, priorities and loss gradient K11.  The convolutions and the large
products around the kernels (phi @ W_i, dW_h, dW_i, dphi) go to
cuDNN/cuBLAS, Adam to ``torch.optim.Adam(fused=True)``.

Differences of form from the JAX step, none of them of value:
- ``R2D2TrainState`` holds live modules and the optimizer, updated in place;
  ``step`` is a host int.
- The burn-in runs the trunk and the LSTM only: its Q head is dead code in
  the JAX graph (only the state is used), which XLA drops.
- Randomness: one ``torch.Generator`` draws the online, then the target
  unroll's head noise; ``draws={"online": noise, "target": noise}`` injects
  them (tests).
- ``info`` stays on the device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import dueling_head
from rainbow_iqn_apex_tpu_torch.kernels.r2d2_td import (
    R2D2TDFn,
    TDParams,
    value_rescale,
    value_unrescale,
)
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback
from rainbow_iqn_apex_tpu_torch.kernels.seq_stack import seq_stack
from rainbow_iqn_apex_tpu_torch.models.init import init_network_
from rainbow_iqn_apex_tpu_torch.models.r2d2 import LSTMState, R2D2Net, make_r2d2_network
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import TrainState, clip_by_global_norm_, make_optimizer

__all__ = [
    "R2D2TrainState",
    "SequenceBatch",
    "as_actor_input",
    "build_r2d2_act_step",
    "build_r2d2_learn_step",
    "init_r2d2_state",
    "make_r2d2_network",
    "stack_seq_frames",
    "to_device_seq_batch",
    "value_rescale",
    "value_unrescale",
]


@dataclasses.dataclass
class SequenceBatch:
    """[B, L] training sequences on the learner's device; L = burn_in + train_len."""

    obs: torch.Tensor  # [B, L, H, W, C] uint8
    action: torch.Tensor  # [B, L] int32
    reward: torch.Tensor  # [B, L] f32
    done: torch.Tensor  # [B, L] bool: the episode ended AT step t
    valid: torch.Tensor  # [B, L] bool: the step belongs to the episode
    init_c: torch.Tensor  # [B, lstm] stored recurrent state at the sequence start
    init_h: torch.Tensor  # [B, lstm]
    weight: torch.Tensor  # [B] f32 IS weights


def stack_seq_frames(obs_seq: torch.Tensor, history: int) -> torch.Tensor:
    """In-sequence frame stacking (K8s-stack on CUDA): [B, L, H, W, 1] ->
    [B, L, H, W, history], channel k holding the frame from t-(history-1-k),
    zero-padded before the sequence starts.  history 1 is the identity."""
    if history <= 1:
        return obs_seq
    return seq_stack(obs_seq.contiguous(), history)


def to_device_seq_batch(s, device: torch.device) -> SequenceBatch:
    """Host ``SequenceSample`` -> device ``SequenceBatch`` (non-blocking
    pinned uploads on CUDA)."""
    return SequenceBatch(
        obs=put_frames(s.obs, device),
        action=put_frames(np.asarray(s.action, np.int32), device),
        reward=put_frames(np.asarray(s.reward, np.float32), device),
        done=put_frames(np.asarray(s.done, np.bool_), device),
        valid=put_frames(np.asarray(s.valid, np.bool_), device),
        init_c=put_frames(np.asarray(s.init_c, np.float32), device),
        init_h=put_frames(np.asarray(s.init_h, np.float32), device),
        weight=put_frames(np.asarray(s.weight, np.float32), device),
    )


@dataclasses.dataclass
class R2D2TrainState(TrainState):
    """The R2D2 learner's state: the ``TrainState`` fields (so ``host_state``,
    ``load_host_state`` and the checkpointer take it as they are) over
    ``R2D2Net`` modules."""

    net: R2D2Net
    target: R2D2Net


def init_r2d2_state(cfg: Config, num_actions: int, seed: int, frame_shape: Tuple[int, int],
                    channels: Optional[int] = None, device: DeviceLike = None) -> R2D2TrainState:
    """Fresh state on ``device`` (``cuda:0`` unless named): params from
    ``seed`` with the JAX model's distributions, target = a copy, Adam
    moments zero.  ``channels`` defaults to ``cfg.history_length``."""
    device = resolve_device(device)
    net = make_r2d2_network(cfg, num_actions, state_shape=(*frame_shape,
                                                            channels or cfg.history_length))
    init_network_(net, torch.Generator().manual_seed(int(seed)))
    net.to(device)
    target = copy.deepcopy(net).requires_grad_(False)
    return R2D2TrainState(net=net, target=target, optimizer=make_optimizer(cfg, net.parameters()))


def _unroll_features(net: R2D2Net, obs: torch.Tensor, state: LSTMState, resets: torch.Tensor,
                     burn_in: int) -> torch.Tensor:
    """Burn-in without gradient, then the train unroll: the train slice's
    LSTM outputs [B*T, lstm].  The state resets where a step follows a
    terminal (``resets``, over the whole L)."""
    if burn_in > 0:
        with torch.no_grad():
            _, state = net.features(obs[:, :burn_in], state, resets[:, :burn_in])
        state = (state[0].detach(), state[1].detach())
    feat, _ = net.features(obs[:, burn_in:], state, resets[:, burn_in:])
    return feat.reshape(-1, feat.shape[-1])


def build_r2d2_learn_step(cfg: Config, num_actions: int):
    """The learn step ``(state, batch, generator=None, draws=None,
    writeback=None) -> (state, info)``; ``state`` is updated in place and
    returned.  ``writeback``: a ``Writeback`` target (the device sequence
    ring's priorities at the batch's draws) that K11's launch writes the
    priorities into, K6s's write-back folded in."""
    burn, n = cfg.r2d2_burn_in, cfg.multi_step
    history = cfg.history_length
    if history > 1 and burn < history - 1:
        raise ValueError(
            f"r2d2_burn_in ({burn}) must be >= history_length-1 ({history - 1}): on-device "
            "frame stacking zero-pads the first history-1 steps of each sequence, which must "
            "fall inside the burn-in region or the loss trains on observations the actor "
            "never saw")
    params_td = TDParams(n, cfg.gamma, cfg.r2d2_eta, cfg.value_rescale_eps)
    del num_actions  # the state's networks carry it

    def learn_step(state: R2D2TrainState, batch: SequenceBatch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Dict[str, Tuple[torch.Tensor, torch.Tensor]]]] = None,
                   writeback: Optional[Writeback] = None):
        draws = draws or {}
        obs = batch.obs
        if history > 1 and obs.shape[-1] == 1:
            obs = stack_seq_frames(obs, history)  # single-frame sequences -> stacked input
        steps = obs.shape[1] - burn  # the train slice
        prev_done = torch.cat([torch.zeros_like(batch.done[:, :1]), batch.done[:, :-1]], dim=1)
        init = (batch.init_c, batch.init_h)
        params = list(state.net.parameters())

        feat = _unroll_features(state.net, obs, init, prev_done, burn)
        actions = batch.action[:, burn:].reshape(-1).contiguous()
        q_taken, q_sel = state.net.gather(feat, actions, draws.get("online"), generator)
        with torch.no_grad():
            feat_t = _unroll_features(state.target, obs, init, prev_done, burn)
            value, adv = state.target.heads(feat_t, draws.get("target"), generator)
            _, q_tgt, _ = dueling_head(value, adv, 1)
        batch_size = obs.shape[0]
        # K11 reads the train slice of reward, done and valid in place
        loss, priorities, q_mean = R2D2TDFn.apply(
            q_taken.reshape(batch_size, steps), q_sel.reshape(batch_size, steps, -1),
            q_tgt.reshape(batch_size, steps, -1), batch.reward[:, burn:], batch.done[:, burn:],
            batch.valid[:, burn:], batch.weight, params_td, writeback)

        # the conv weights' gradients come back channels-last; the fused
        # Adam reads each gradient in its parameter's (contiguous) layout
        grads = [g.contiguous() for g in torch.autograd.grad(loss, params)]
        grad_norm = clip_by_global_norm_(grads, cfg.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
        for p in params:
            p.grad = None
        state.step += 1
        if state.step % cfg.target_update_period == 0:
            with torch.no_grad():
                torch._foreach_copy_(list(state.target.parameters()), params)
        loss = loss.detach()
        info = {
            "loss": loss,
            "priorities": priorities,
            "q_mean": q_mean,
            "grad_norm": grad_norm,
            # the NaN/Inf guard flag, as the IQN step's
            "finite": torch.isfinite(loss) & torch.isfinite(grad_norm),
        }
        return state, info

    return learn_step


def as_actor_input(obs, history: int) -> np.ndarray:
    """Actor observations as [B, H, W, C] host uint8 with C == history (the
    host FrameStacker supplies the stack when history > 1)."""
    x = np.asarray(obs)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] != history:
        raise ValueError(
            f"actor obs has {x.shape[-1]} channels but history_length is {history}; feed "
            "FrameStacker output (or raw [B,H,W] frames when history_length == 1)")
    return x


def build_r2d2_act_step(cfg: Config, num_actions: int, use_noise: bool = True):
    """Recurrent acting: (net, obs [B, H, W, C] uint8 tensor, state,
    generator, noise=None) -> (action [B] int32, q [B, A], new state), all
    on the net's device.  C must match the training channels."""

    def act_step(net: R2D2Net, obs: torch.Tensor, state: LSTMState,
                 generator: Optional[torch.Generator], noise=None):
        if net.num_actions != num_actions:
            raise ValueError("act step and network disagree on the number of actions")
        if obs.shape[-1] != cfg.history_length:
            raise ValueError(f"actor obs has {obs.shape[-1]} channels, history_length is "
                             f"{cfg.history_length}")
        with torch.inference_mode():
            q, action, new_state = net.step(obs[:, None], state, noise=noise,
                                            generator=generator, noisy=use_noise)
        return action[:, 0], q[:, 0], new_state

    return act_step
