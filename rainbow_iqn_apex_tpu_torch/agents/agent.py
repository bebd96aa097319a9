"""The Agent of the port: acting, learning, rollback.

Counterpart of ``rainbow_iqn_apex_tpu/agents/agent.py``: a thin host-side
facade over the learn step (``ops/learn.py``) and the same live network
acting under ``inference_mode``.  The network keeps its fp32 master
parameters (they are what Adam updates; ``cast_for_inference_`` is never
called on it), and every forward casts them to the compute dtype as the
JAX model does.  Randomness: one ``torch.Generator`` on the learner's
device, seeded from ``cfg.seed``, draws the taus and noise of acting and of
every learn step.

On CUDA the Agent turns TF32 off for matmuls and cuDNN, process-wide (a
torch setting, not one of the module), so the learner's fp32 work (the first
convolution, the fp32 products) stays fp32 as in the JAX reference.

Frames cross to the device once per tick as one uint8 tensor, copied from
pinned host memory without blocking the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import (
    Batch,
    TrainState,
    build_learn_step,
    init_train_state,
    load_host_state,
)
from rainbow_iqn_apex_tpu_torch.replay.buffer import SampledBatch
from rainbow_iqn_apex_tpu_torch.utils import hostsync


def put_frames(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on CUDA through pinned memory with a
    non-blocking copy (the host does not wait for it)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_device_batch(sample: SampledBatch, device: torch.device) -> Batch:
    """Host SampledBatch -> device Batch (non-blocking pinned uploads); a
    multi-game sample's game ids go along."""
    game = getattr(sample, "game", None)
    return Batch(
        obs=put_frames(sample.obs, device),
        action=put_frames(np.asarray(sample.action, np.int32), device),
        reward=put_frames(np.asarray(sample.reward, np.float32), device),
        next_obs=put_frames(sample.next_obs, device),
        discount=put_frames(np.asarray(sample.discount, np.float32), device),
        weight=put_frames(np.asarray(sample.weight, np.float32), device),
        game=None if game is None else put_frames(np.asarray(game, np.int32), device),
    )


class FrameStacker:
    """Rolling [L, H, W, hist] uint8 stack with per-lane terminal reset."""

    def __init__(self, lanes: int, frame_shape: Tuple[int, int], history: int):
        self.buf = np.zeros((lanes, *frame_shape, history), np.uint8)

    def push(self, frames: np.ndarray) -> np.ndarray:
        """Shift in the newest frame; returns the stacked state (a copy)."""
        self.buf[..., :-1] = self.buf[..., 1:]
        self.buf[..., -1] = frames
        return self.buf.copy()

    def reset_lanes(self, mask: np.ndarray) -> None:
        """Zero the history of lanes whose episode just ended."""
        self.buf[mask] = 0


class Agent:
    def __init__(
        self,
        cfg: Config,
        num_actions: int,
        seed: int,
        train: bool = True,
        state_shape: Optional[Tuple[int, ...]] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.num_actions = num_actions
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # TF32 would round fp32 operands to 10 mantissa bits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # replay reuse: one learn_batch call is K passes, so step advances K
        self.reuse_k = max(int(cfg.replay_ratio), 1)
        self.state: TrainState = init_train_state(
            cfg, num_actions, seed, state_shape=state_shape, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._learn = build_learn_step(cfg, num_actions) if train else None

    # ------------------------------------------------------------------ acting
    def act(self, stacked_obs: np.ndarray, eval_mode: bool = False) -> np.ndarray:
        """Greedy actions for a [L, H, W, hist] uint8 batch.  Noise is drawn
        anew every call (off at evaluation unless ``cfg.eval_noisy``)."""
        noisy = self.cfg.eval_noisy if eval_mode else True
        with torch.inference_mode():
            out = self.state.net(put_frames(stacked_obs, self.device),
                                 self.cfg.num_quantile_samples,
                                 generator=self.generator, noisy=noisy)
        # the actor->env hand-off is an obligatory host read
        return hostsync.to_host(out.action)

    # ---------------------------------------------------------------- learning
    def learn(self, sample: SampledBatch) -> Dict[str, Any]:
        """One learner step on a host SampledBatch; ``info`` stays on the
        device (the write-back ring reads it K steps later)."""
        return self.learn_batch(to_device_batch(sample, self.device))

    def learn_batch(self, batch: Batch) -> Dict[str, Any]:
        """One learner step on an already-staged device Batch."""
        self.state, info = self._learn(self.state, batch, self.generator)
        return info

    @property
    def step(self) -> int:
        """Learner steps taken: a host counter, never a device read."""
        return self.state.step

    # ---------------------------------------------------------------- rollback
    def load_snapshot(self, state: Dict[str, Any], key: torch.Tensor) -> None:
        """NaN-guard rollback / resume: replace the live state and the
        generator's state with a host copy (``ops.learn.host_state``)."""
        load_host_state(self.state, state)
        self.generator.set_state(key)
