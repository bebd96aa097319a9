"""Device-resident prioritized replay of the port: the ring, the priorities
and every sample and priority update on the card, so a learner step moves
nothing between host and device.

Counterpart of ``rainbow_iqn_apex_tpu/replay/device.py`` (``DeviceReplay``,
``build_device_learn``), the same semantics: a multi-lane ring with per-lane
episode adjacency, frame-stack reconstruction with cut zeroing, n-step
assembly stopping at terminals, two-channel terminal/truncation cuts with
the time-limit rule (a window whose first cut is a truncation is
ineligible), the write cursor's dead zone, proportional stratified sampling
over p^omega, IS weights (N P)^-beta max-normalised, and never-resurrect
write-back.  On CUDA every one of those steps is one of the port's kernels:
K7 ``append``, K5 ``draw``, K8 ``assemble``, K6 ``update_priorities``; the
fused learner (``build_device_learn``) folds K6 into K1's weighted launch.

Differences of form from the JAX module, none of them of value:
- The state is updated in place (a 1,000,000-slot Atari ring is 7 GB of
  frames; the JAX module donates it).  Methods return the state they were
  given.
- ``pos`` and ``filled`` are host ints: lockstep counters the host knows
  already, so no kernel argument needs a device read.  ``max_priority``
  stays a 0-d device tensor.
- Randomness: ``draw`` and the samplers take a device ``torch.Generator``,
  or ``u=`` (the [B] or [G, B] uniforms, for tests), in place of a key.
- ``sample`` hands K5's on-device priority sum to K8; ``assemble`` called on
  its own runs K5 for that sum alone.

Not ported (each raises NotImplementedError): the multi-device
``build_device_learn_sharded``, ``device_replay_specs`` and
``device_replay_shardings``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels.replay_append import replay_append
from rainbow_iqn_apex_tpu_torch.kernels.replay_assemble import replay_assemble
from rainbow_iqn_apex_tpu_torch.kernels.replay_draw import replay_draw
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback, replay_writeback
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import Batch, build_learn_step


@dataclasses.dataclass
class DeviceReplayState:
    """The whole replay on one device (updated in place)."""

    frames: torch.Tensor  # [L, S, H, W] uint8
    actions: torch.Tensor  # [L, S] int32
    rewards: torch.Tensor  # [L, S] f32
    terminals: torch.Tensor  # [L, S] bool: true env terminals (stop bootstrap)
    cuts: torch.Tensor  # [L, S] bool: terminal or truncation (stream breaks)
    priority: torch.Tensor  # [L * S] f32 p^omega; 0 = ineligible
    max_priority: torch.Tensor  # [] f32 default for fresh items
    pos: int = 0  # lane-local write cursor
    filled: int = 0  # lane-local written count (<= S)

    @property
    def device(self) -> torch.device:
        return self.priority.device

    def to(self, device: DeviceLike) -> "DeviceReplayState":
        """A copy on ``device`` (always a copy, also on the same device)."""
        dev = torch.device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev, copy=True)
            for f in dataclasses.fields(self) if f.name not in ("pos", "filled")})


class DeviceReplay:
    """Static configuration plus the ops over a ``DeviceReplayState``."""

    def __init__(
        self,
        lanes: int,
        seg: int,  # slots per lane (capacity = lanes * seg)
        frame_shape: Tuple[int, int],
        history: int = 4,
        n_step: int = 3,
        gamma: float = 0.99,
        priority_exponent: float = 0.5,
        priority_eps: float = 1e-6,
        device: DeviceLike = None,
    ):
        if seg <= history + n_step:
            raise ValueError("per-lane segment too small for history + n_step")
        self.lanes = lanes
        self.seg = seg
        self.frame_shape = tuple(frame_shape)
        self.history = history
        self.n_step = n_step
        self.gamma = gamma
        self.omega = priority_exponent
        self.eps = priority_eps
        self.device = resolve_device(device)
        # gamma^k in f32, as the JAX module's gamma ** arange(n + 1)
        self._gammas = torch.from_numpy(
            np.float32(gamma) ** np.arange(n_step + 1, dtype=np.float32)).to(self.device)

    # ------------------------------------------------------------------ init
    def init_state(self) -> DeviceReplayState:
        h, w = self.frame_shape
        L, S, dev = self.lanes, self.seg, self.device
        return DeviceReplayState(
            frames=torch.zeros((L, S, h, w), dtype=torch.uint8, device=dev),
            actions=torch.zeros((L, S), dtype=torch.int32, device=dev),
            rewards=torch.zeros((L, S), dtype=torch.float32, device=dev),
            terminals=torch.zeros((L, S), dtype=torch.bool, device=dev),
            cuts=torch.zeros((L, S), dtype=torch.bool, device=dev),
            priority=torch.zeros((L * S,), dtype=torch.float32, device=dev),
            max_priority=torch.ones((), dtype=torch.float32, device=dev),
        )

    # ---------------------------------------------------------------- append
    def append(
        self,
        state: DeviceReplayState,
        frames: torch.Tensor,  # [L, H, W] uint8
        actions: torch.Tensor,  # [L] int32
        rewards: torch.Tensor,  # [L] f32
        terminals: torch.Tensor,  # [L] bool
        truncations: torch.Tensor,  # [L] bool
        priorities: Optional[torch.Tensor] = None,  # [L] raw |TD| or None
    ) -> DeviceReplayState:
        """One lockstep tick of all lanes (K7), then the host counters."""
        replay_append(state, frames, actions, rewards, terminals, truncations, priorities,
                      state.pos, state.filled, self.history, self.n_step, self.eps, self.omega)
        state.pos = (state.pos + 1) % self.seg
        state.filled = min(state.filled + 1, self.seg)
        return state

    # ---------------------------------------------------------------- sample
    def _uniforms(self, groups: int, batch_size: int, generator: Optional[torch.Generator],
                  u: Optional[torch.Tensor]) -> torch.Tensor:
        if u is None:
            return torch.rand((groups, batch_size), generator=generator, device=self.device)
        return u.to(self.device, torch.float32).reshape(groups, batch_size).contiguous()

    def draw(self, state: DeviceReplayState, batch_size: int,
             generator: Optional[torch.Generator] = None,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stratified proportional draw over p^omega (K5): one uniform per
        stratum, inverse cdf.  Returns idx [B] int32 global slots."""
        idx, _total = replay_draw(state.priority, self._uniforms(1, batch_size, generator, u))
        return idx[0]

    def _assemble(self, state: DeviceReplayState, idx: torch.Tensor, total: torch.Tensor,
                  beta: float, group: int, with_weight: bool) -> Tuple[Batch, torch.Tensor]:
        a = replay_assemble(state, idx.reshape(-1), total, self._gammas, beta, state.filled,
                            self.history, self.n_step, group, with_weight)
        batch = Batch(obs=a.obs, action=a.action, reward=a.reward, next_obs=a.next_obs,
                      discount=a.discount, weight=a.weight)
        return batch, a.prob

    def assemble(self, state: DeviceReplayState, idx: torch.Tensor, beta: float, *,
                 with_weight: bool = True) -> Tuple[Batch, torch.Tensor]:
        """n-step assembly + stack gathers + IS weights at given global slot
        ids (K8; K5 computes the priority sum).  Returns (Batch, prob [B]).
        ``with_weight=False`` gives weights of one."""
        _, total = replay_draw(state.priority, state.priority.new_empty((0, 1)))
        return self._assemble(state, idx, total, beta, idx.numel(), with_weight)

    def sample(self, state: DeviceReplayState, batch_size: int, beta: float,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Batch, torch.Tensor]:
        """Stratified proportional sample + n-step assembly + IS weights.
        Returns (idx [B] int32 global slots, Batch, prob [B])."""
        idx, total = replay_draw(state.priority, self._uniforms(1, batch_size, generator, u))
        batch, prob = self._assemble(state, idx, total, beta, batch_size, True)
        return idx[0], batch, prob

    def sample_grouped(self, state: DeviceReplayState, batch_size: int, groups: int,
                       beta: float, generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Batch, torch.Tensor]:
        """``groups`` independent stratified draws of ``batch_size`` in one
        [G * B] learn batch, each group with its own max-normalised IS
        weights.  Returns (idx [G, B], Batch over [G * B], prob [G * B])."""
        idx, total = replay_draw(state.priority, self._uniforms(groups, batch_size, generator, u))
        batch, prob = self._assemble(state, idx, total, beta, batch_size, True)
        return idx, batch, prob

    # ------------------------------------------------------------- priorities
    def update_priorities_grouped(self, state: DeviceReplayState, idx: torch.Tensor,
                                  td_abs: torch.Tensor) -> DeviceReplayState:
        """Write-back for ``sample_grouped``'s [G, B] indices with G-sequential
        semantics (K6): on a slot drawn by several groups the last group's
        priority stands."""
        replay_writeback(state.priority, state.max_priority, idx.to(torch.int32).contiguous(),
                         td_abs.reshape(-1).contiguous(), self.eps, self.omega)
        return state

    def update_priorities(self, state: DeviceReplayState, idx: torch.Tensor,
                          td_abs: torch.Tensor) -> DeviceReplayState:
        """Learner write-back, never resurrecting cursor-invalidated slots (K6)."""
        return self.update_priorities_grouped(state, idx.reshape(1, -1), td_abs)

    def writeback_target(self, state: DeviceReplayState, idx: torch.Tensor) -> Writeback:
        """``update_priorities_grouped``'s write-back at ``idx`` [G, B], as a
        target that the learn step's K1 launch writes its priorities into."""
        return Writeback(state.priority, state.max_priority, idx.to(torch.int32).contiguous(),
                         self.eps, self.omega)


def build_device_learn(cfg, num_actions: int, replay: DeviceReplay):
    """The Anakin learner tick: sample -> learn -> priority write-back,
    ``(train_state, replay_state, generator, beta, *, u=None, draws=None) ->
    (train_state, replay_state, info)``, both states updated in place and
    ``info`` left on the device: no host transfer.  ``u`` injects the
    sampler's uniforms and ``draws`` the learn step's taus and noise.

    The write-back is ``update_priorities_grouped``'s, unconditional as in
    JAX.  Nothing between the learn step's loss and the write-back reads or
    writes the ring's priorities, so the learn step's K1 launch does it
    (a ``writeback_target``; K6 folded into K1, one launch fewer a step).
    A reuse step (``replay_ratio`` > 1) writes its last pass's priorities
    with K6 after it."""
    learn_step = build_learn_step(cfg, num_actions)
    groups = getattr(cfg, "sample_groups", 1)
    reuse = int(cfg.replay_ratio) > 1

    def fused(train_state, replay_state, generator, beta, *, u=None, draws=None):
        if groups > 1:
            idx, batch, _prob = replay.sample_grouped(
                replay_state, cfg.batch_size, groups, beta, generator, u)
        else:
            idx, batch, _prob = replay.sample(replay_state, cfg.batch_size, beta, generator, u)
            idx = idx.reshape(1, -1)
        if reuse:
            train_state, info = learn_step(train_state, batch, generator, draws)
            replay.update_priorities_grouped(replay_state, idx, info["priorities"])
        else:
            train_state, info = learn_step(train_state, batch, generator, draws,
                                           writeback=replay.writeback_target(replay_state, idx))
        return train_state, replay_state, info

    return fused


def build_device_learn_sharded(cfg, num_actions: int, local_replay: DeviceReplay, mesh,
                               axis: str = "dp"):
    raise NotImplementedError(
        "the lane-sharded multi-device learner is not ported yet (multi-GPU slice)")


def device_replay_specs(axis: str = "dp"):
    raise NotImplementedError("replay sharding specs are not ported yet (multi-GPU slice)")


def device_replay_shardings(mesh, axis: str = "dp"):
    raise NotImplementedError("replay shardings are not ported yet (multi-GPU slice)")
