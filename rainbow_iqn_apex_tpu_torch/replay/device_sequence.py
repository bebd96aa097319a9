"""Device-resident stored-state sequence replay of the port (R2D2's Anakin
learner): the sequence ring, the per-lane builders and every sample and
priority update on the card, so a learn step moves nothing between host and
device.

Counterpart of ``rainbow_iqn_apex_tpu/replay/device_sequence.py``
(``DeviceSeqState``, ``DeviceSequenceReplay``, ``build_device_r2d2_learn``),
the same semantics: per-lane builders chopping the episode streams into
overlapping windows of L steps with the actor's LSTM state at each window's
start, two-channel cuts (a flush on a terminal or a truncation, ``done`` on
true terminals only), max-priority insertion, a ring with one scratch row
at index C, proportional stratified sampling over the effective priorities
(a uniform draw over the filled prefix while they sum to 0), IS weights
(N P)^-beta max-normalised per group, and the eta-mix write-back.  On CUDA
every one of those steps is one of the port's kernels: K7s ``append``, K5s
``draw``, K8s ``assemble``, K6s ``update_priorities`` (folded into the
learn step's K11 launch on the fused step), and the act tick's prologue
``act_prologue`` (K7s's append with the frame-stack shift and the reset
LSTM state in its launch).

Differences of form from the JAX module, none of them of value:
- The state is updated in place (the reference config's ring is 7 GB of
  frames; the JAX module donates it).  Methods return the state they were
  given.
- ``pos``, ``filled`` and ``buf_len`` are host counters (ints and a numpy
  [lanes] int32 array): the emissions of a tick follow from ``buf_len`` and
  the host env's cut flags, so the host knows them without reading the
  device, and no kernel argument needs a device read.  ``max_priority``
  stays a 0-d device tensor.  ``append`` therefore takes ``rewards``,
  ``terminals`` and ``truncations`` as host arrays.
- K7s writes only the emitting lanes' windows; the JAX graph scatters the
  others into the scratch row, which sampling never reads.  The scratch
  row's contents, and builder steps at or past ``buf_len``, are not part of
  the semantics.
- On a slot drawn twice, the write-back keeps the last group's priority and,
  inside a group, the last occurrence's (JAX's scatter leaves that order
  open).
- Randomness: ``draw`` and ``sample_grouped`` take a device
  ``torch.Generator``, or ``u=`` (the [B] or [G, B] uniforms, for tests), in
  place of a key.  ``draw`` returns K5s's ``meta`` (the effective total and
  the fallback flag) beside the ids, for K8s; ``assemble`` called on its
  own runs K5s for ``meta`` alone.

Not ported (each raises NotImplementedError; ROADMAP.md A13, more than one GPU):
the multi-device ``stack_seq_shards``, ``device_seq_specs``,
``device_seq_shardings``, ``build_sharded_seq_append`` and
``build_device_r2d2_learn_sharded``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback
from rainbow_iqn_apex_tpu_torch.kernels.seq_append import act_prologue, plan_append, seq_append
from rainbow_iqn_apex_tpu_torch.kernels.seq_assemble import seq_assemble
from rainbow_iqn_apex_tpu_torch.kernels.seq_draw import seq_draw
from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import seq_writeback
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device

# the host counters; every other field is a tensor on the ring's device
HOST_FIELDS = ("pos", "filled", "buf_len")


@dataclasses.dataclass
class DeviceSeqState:
    """The whole sequence replay on one device (updated in place); the
    fields and their order are the JAX ``DeviceSeqState``'s."""

    # sequence ring, one scratch row at index C
    frames: torch.Tensor  # [C+1, L, H, W] uint8
    actions: torch.Tensor  # [C+1, L] int32
    rewards: torch.Tensor  # [C+1, L] f32
    dones: torch.Tensor  # [C+1, L] bool
    valids: torch.Tensor  # [C+1, L] bool
    init_c: torch.Tensor  # [C+1, lstm] f32
    init_h: torch.Tensor  # [C+1, lstm] f32
    priority: torch.Tensor  # [C] f32 (already ^omega)
    pos: int  # next ring slot
    filled: int
    max_priority: torch.Tensor  # [] f32
    # per-lane builders
    buf_frames: torch.Tensor  # [lanes, L, H, W] uint8
    buf_actions: torch.Tensor  # [lanes, L] int32
    buf_rewards: torch.Tensor  # [lanes, L] f32
    buf_dones: torch.Tensor  # [lanes, L] bool
    buf_c: torch.Tensor  # [lanes, L, lstm] f32
    buf_h: torch.Tensor  # [lanes, L, lstm] f32
    buf_len: np.ndarray  # [lanes] int32, host

    @property
    def device(self) -> torch.device:
        return self.priority.device

    def to(self, device: DeviceLike) -> "DeviceSeqState":
        """A copy on ``device`` (always a copy, also on the same device)."""
        dev = torch.device(device)
        return dataclasses.replace(self, buf_len=self.buf_len.copy(), **{
            f.name: getattr(self, f.name).to(dev, copy=True)
            for f in dataclasses.fields(self) if f.name not in HOST_FIELDS})


def _host(x, dtype) -> np.ndarray:
    """A per-lane host array; a CUDA tensor is refused (reading it would sync)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("rewards, terminals and truncations are host arrays: the host "
                             "derives every lane's emission from them")
        x = x.numpy()
    return np.asarray(x, dtype)


class DeviceSequenceReplay:
    """Static configuration plus the ops over a ``DeviceSeqState``."""

    def __init__(
        self,
        capacity: int,
        seq_len: int,
        frame_shape: Tuple[int, int],
        lstm_size: int,
        lanes: int,
        stride: Optional[int] = None,
        priority_exponent: float = 0.9,
        priority_eps: float = 1e-6,
        device: DeviceLike = None,
    ):
        if stride is not None and not (0 < stride <= seq_len):
            raise ValueError("stride must be in (0, seq_len]")
        if capacity < lanes:
            raise ValueError(
                f"capacity ({capacity}) must be >= lanes ({lanes}): every "
                "lane can emit a sequence on the same tick"
            )
        self.capacity = capacity
        self.L = seq_len
        self.lanes = lanes
        self.stride = stride or max(seq_len // 2, 1)
        self.omega = priority_exponent
        self.eps = priority_eps
        self.frame_shape = tuple(frame_shape)
        self.lstm_size = lstm_size
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init_state(self) -> DeviceSeqState:
        C, L, (h, w), m, lanes = (
            self.capacity, self.L, self.frame_shape, self.lstm_size, self.lanes,
        )
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return DeviceSeqState(
            frames=zeros((C + 1, L, h, w), torch.uint8),
            actions=zeros((C + 1, L), torch.int32),
            rewards=zeros((C + 1, L), torch.float32),
            dones=zeros((C + 1, L), torch.bool),
            valids=zeros((C + 1, L), torch.bool),
            init_c=zeros((C + 1, m), torch.float32),
            init_h=zeros((C + 1, m), torch.float32),
            priority=zeros((C,), torch.float32),
            pos=0,
            filled=0,
            max_priority=torch.ones((), dtype=torch.float32, device=dev),
            buf_frames=zeros((lanes, L, h, w), torch.uint8),
            buf_actions=zeros((lanes, L), torch.int32),
            buf_rewards=zeros((lanes, L), torch.float32),
            buf_dones=zeros((lanes, L), torch.bool),
            buf_c=zeros((lanes, L, m), torch.float32),
            buf_h=zeros((lanes, L, m), torch.float32),
            buf_len=np.zeros((lanes,), np.int32),
        )

    # ------------------------------------------------------------- appending
    def append(
        self,
        s: DeviceSeqState,
        frames: torch.Tensor,  # [lanes, H, W] uint8: the frame the action saw
        actions: torch.Tensor,  # [lanes] int32
        rewards,  # [lanes] f32, host
        terminals,  # [lanes] bool, host: TRUE terminals only
        truncations,  # [lanes] bool, host: time-limit cuts
        lstm_c: torch.Tensor,  # [lanes, lstm] actor state BEFORE this step
        lstm_h: torch.Tensor,
    ) -> DeviceSeqState:
        """One lockstep tick of all lanes (K7s), then the host counters."""
        plan, args = self._plan(s, frames, actions, rewards, terminals, truncations, lstm_c,
                                lstm_h)
        seq_append(s, *args, plan, self.stride)
        s.buf_len, s.pos, s.filled = plan.buf_len, plan.pos, plan.filled
        return s

    def _plan(self, s: DeviceSeqState, frames, actions, rewards, terminals, truncations,
              lstm_c, lstm_h):
        """An append's host plan and K7s's arguments (``seq_append``'s)."""
        terminals = _host(terminals, bool)
        plan = plan_append(s.buf_len, terminals, _host(truncations, bool), s.pos, s.filled,
                           self.capacity, self.L, self.stride)
        return plan, (frames, actions.to(torch.int32), _host(rewards, np.float32), terminals,
                      lstm_c.to(torch.float32), lstm_h.to(torch.float32))

    def act_prologue(self, s: DeviceSeqState, prev: Optional[tuple], stack: torch.Tensor,
                     frame: torch.Tensor, keep: torch.Tensor,
                     lstm: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The R2D2 act tick's prologue in one K7s launch: ``append`` of the
        last transition ``prev`` (``append``'s arguments in order; None on
        the first tick), then ``stack`` [lanes, H, W, h] uint8 shifted in
        place by ``frame`` with the lanes whose ``keep`` [lanes] uint8 is 0
        zeroed, and pre = ``lstm`` * keep, which the act starts from.
        Returns pre (c, h)."""
        plan, args = (None, None) if prev is None else self._plan(s, *prev)
        pre = act_prologue(s, args, plan, self.stride, stack, frame, keep,
                           lstm[0].to(torch.float32), lstm[1].to(torch.float32))
        if plan is not None:
            s.buf_len, s.pos, s.filled = plan.buf_len, plan.pos, plan.filled
        return pre

    # -------------------------------------------------------------- sampling
    def _uniforms(self, groups: int, batch_size: int, generator: Optional[torch.Generator],
                  u: Optional[torch.Tensor]) -> torch.Tensor:
        if u is None:
            return torch.rand((groups, batch_size), generator=generator, device=self.device)
        return u.to(self.device, torch.float32).reshape(groups, batch_size).contiguous()

    def draw(self, s: DeviceSeqState, batch_size: int,
             generator: Optional[torch.Generator] = None,
             u: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stratified proportional draw over the effective priorities (K5s).
        Returns (idx [B] int32, meta [2]: the total and the cold-ring flag)."""
        idx, meta = seq_draw(s.priority, s.filled, self._uniforms(1, batch_size, generator, u))
        return idx[0], meta

    def _assemble(self, s: DeviceSeqState, idx: torch.Tensor, meta: torch.Tensor, beta: float,
                  group: int, with_weight: bool):
        from rainbow_iqn_apex_tpu_torch.ops.r2d2 import SequenceBatch  # ops imports replay

        g = seq_assemble(s, idx.reshape(-1), meta, beta, s.filled, group, with_weight)
        batch = SequenceBatch(obs=g.obs[..., None], action=g.action, reward=g.reward,
                              done=g.done, valid=g.valid, init_c=g.init_c, init_h=g.init_h,
                              weight=g.weight)
        return batch, g.prob

    def assemble(self, s: DeviceSeqState, idx: torch.Tensor, beta: float, *,
                 with_weight: bool = True):
        """Gather sequences + IS weights at slot ids (K8s; K5s computes the
        effective total).  Returns (SequenceBatch with [B, L, H, W, 1] obs,
        prob [B]); ``with_weight=False`` gives weights of one."""
        _, meta = seq_draw(s.priority, s.filled, s.priority.new_empty((0, 1)))
        idx = idx.to(torch.int32).reshape(-1).contiguous()
        return self._assemble(s, idx, meta, beta, idx.numel(), with_weight)

    def sample_grouped(self, s: DeviceSeqState, batch_size: int, groups: int, beta: float,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None):
        """``groups`` independent stratified draws of ``batch_size`` sequences
        in one [G * B] learn batch, with per-group max-normalised IS weights
        (G sequential reference steps; G 1 is ``draw`` then ``assemble``),
        K5s's total handed to K8s.  Returns (idx [G, B], SequenceBatch over
        [G * B], prob [G * B])."""
        idx, meta = seq_draw(s.priority, s.filled,
                             self._uniforms(groups, batch_size, generator, u))
        batch, prob = self._assemble(s, idx, meta, beta, batch_size, True)
        return idx, batch, prob

    # ------------------------------------------------------------- priorities
    def update_priorities_grouped(self, s: DeviceSeqState, idx: torch.Tensor,
                                  td_mix: torch.Tensor) -> DeviceSeqState:
        """Write-back for ``sample_grouped``'s [G, B] indices in group order
        (K6s): on a repeated slot the last group wins."""
        seq_writeback(s.priority, s.max_priority, idx.to(torch.int32).contiguous(),
                      td_mix.reshape(-1).to(torch.float32).contiguous(), self.eps, self.omega)
        return s

    def update_priorities(self, s: DeviceSeqState, idx: torch.Tensor,
                          td_mix: torch.Tensor) -> DeviceSeqState:
        """Learner eta-mix write-back: a direct set and a running max (K6s)."""
        return self.update_priorities_grouped(s, idx.reshape(1, -1), td_mix)

    def writeback_target(self, s: DeviceSeqState, idx: torch.Tensor) -> Writeback:
        """``update_priorities_grouped``'s write-back at ``idx`` [G, B], as a
        target that the learn step's K11 launch writes its priorities into."""
        return Writeback(s.priority, s.max_priority, idx.to(torch.int32).contiguous(), self.eps,
                         self.omega)


def build_device_r2d2_learn(cfg, num_actions: int, replay: DeviceSequenceReplay):
    """The R2D2 Anakin learner tick: draw -> assemble -> sequence learn step
    -> eta-mix write-back, ``(train_state, replay_state, generator, beta, *,
    u=None, draws=None) -> (train_state, replay_state, info)``, both states
    updated in place and ``info`` left on the device: no host transfer.
    ``u`` injects the sampler's uniforms and ``draws`` the learn step's noise.

    The write-back is ``update_priorities_grouped``'s.  Nothing between the
    learn step's TD epilogue and the write-back reads or writes the ring's
    priorities, so K11's launch does it (a ``writeback_target``: K6s folded
    into K11, one launch fewer a step).

    Warm-gate contract, as in JAX: callers learn only once the ring holds
    ``max(learn_start // seq_total, 8)`` sequences; a cold ring degrades the
    draw to uniform over the filled prefix."""
    from rainbow_iqn_apex_tpu_torch.ops.r2d2 import build_r2d2_learn_step

    learn_step = build_r2d2_learn_step(cfg, num_actions)
    groups = getattr(cfg, "sample_groups", 1)

    def fused(train_state, replay_state, generator, beta, *, u=None, draws=None):
        idx, batch, _prob = replay.sample_grouped(
            replay_state, cfg.batch_size, groups, beta, generator, u)
        train_state, info = learn_step(train_state, batch, generator, draws,
                                       writeback=replay.writeback_target(replay_state, idx))
        return train_state, replay_state, info

    return fused


# ---------------------------------------------------------------------------
# dp-sharded variant (per-shard rings): the multi-GPU slice
# ---------------------------------------------------------------------------
def _multi_gpu(name: str):
    raise NotImplementedError(
        f"{name}: the sharded sequence replay is not ported yet (ROADMAP.md A13, more than one "
        "GPU)")


def stack_seq_shards(local_state: DeviceSeqState, n_dev: int) -> DeviceSeqState:
    _multi_gpu("stack_seq_shards")


def device_seq_specs(axis: str = "dp"):
    _multi_gpu("device_seq_specs")


def device_seq_shardings(mesh, axis: str = "dp"):
    _multi_gpu("device_seq_shardings")


def build_sharded_seq_append(replay: DeviceSequenceReplay, mesh, axis: str = "dp"):
    _multi_gpu("build_sharded_seq_append")


def build_device_r2d2_learn_sharded(cfg, num_actions: int, local_replay: DeviceSequenceReplay,
                                    mesh, axis: str = "dp"):
    _multi_gpu("build_device_r2d2_learn_sharded")
