"""Stored-state sequence replay for R2D2.

A copy of ``rainbow_iqn_apex_tpu/replay/sequence.py`` (jax-free there): only
the import paths point at the port's own ``replay/sumtree.py``,
``replay/snapshot_io.py`` and ``utils/hostsync.py``.

Parity: the reference's R2D2 stretch config (BASELINE.json:10; SURVEY.md §5
"long-context": sequence replay is replay-format work — stored LSTM state +
burn-in — not sequence-parallel compute).  Design per Kapturowski et al.:

- actors chop each lane's episode stream into fixed-length sequences of
  L = burn_in + seq_len steps, adjacent sequences overlapping by L - stride;
- each sequence records the actor's LSTM state at its first step (the
  "stored state" that seeds burn-in at training time) — exact for overlapped
  windows too, via a per-step state history;
- sequences never mix episodes: a terminal OR truncation inside the window
  ends the valid region and the remainder is zero-padded with valid=False.
  Two-channel cut semantics (mirroring the frame replay,
  replay/buffer.py): both channels cut the stream, but only true terminals
  are stored in `done` — a time-limit truncation leaves done=False, and the
  learn step (ops/r2d2.py) masks out steps whose bootstrap would need data
  beyond the cut instead of teaching V=0 there;
- a sum-tree prioritizes whole sequences (max-priority on insert, eta-mix
  write-back from the learner).

Storage is sequence-major NumPy: frames are duplicated across overlapping
windows (factor ~L/stride) in exchange for contiguous [B, L] gathers that
feed the TPU directly — the dedup trick of the frame replay doesn't pay here
because the LSTM needs contiguous time anyway.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.replay.sumtree import SumTree
from rainbow_iqn_apex_tpu_torch.utils import hostsync


@dataclasses.dataclass
class SequenceSample:
    idx: np.ndarray  # [B] sequence slot ids
    obs: np.ndarray  # [B, L, H, W, 1] uint8
    action: np.ndarray  # [B, L] int32
    reward: np.ndarray  # [B, L] f32
    done: np.ndarray  # [B, L] bool
    valid: np.ndarray  # [B, L] bool
    init_c: np.ndarray  # [B, lstm] f32
    init_h: np.ndarray  # [B, lstm] f32
    weight: np.ndarray  # [B] f32
    prob: np.ndarray = None  # [B] f64 — local sample probability (for the
    # multi-host global IS-weight derivation, mirroring SampledBatch.prob)


class SequenceReplay:
    """Prioritized ring of fixed-length sequences with stored LSTM states."""

    def __init__(
        self,
        capacity: int,  # number of sequences
        seq_len: int,  # L = burn_in + trained steps
        frame_shape: Tuple[int, int],
        lstm_size: int,
        lanes: int = 1,
        stride: Optional[int] = None,  # steps between sequence starts
        priority_exponent: float = 0.9,
        priority_eps: float = 1e-6,
        seed: int = 0,
    ):
        if stride is not None and not (0 < stride <= seq_len):
            raise ValueError("stride must be in (0, seq_len]")
        self.capacity = capacity
        self.L = seq_len
        self.lanes = lanes
        self.stride = stride or max(seq_len // 2, 1)
        self.omega = priority_exponent
        self.eps = priority_eps
        self.rng = np.random.default_rng(seed)

        h, w = frame_shape
        self.frames = np.zeros((capacity, seq_len, h, w), np.uint8)
        self.actions = np.zeros((capacity, seq_len), np.int32)
        self.rewards = np.zeros((capacity, seq_len), np.float32)
        self.dones = np.zeros((capacity, seq_len), bool)
        self.valids = np.zeros((capacity, seq_len), bool)
        self.init_c = np.zeros((capacity, lstm_size), np.float32)
        self.init_h = np.zeros((capacity, lstm_size), np.float32)

        self.tree = SumTree(capacity)
        self.pos = 0
        self.filled = 0
        self.max_priority = 1.0
        # same single-writer discipline as PrioritizedReplay: serialise
        # append/sample/update so a prefetch thread never sees partial state
        self._lock = threading.Lock()
        self._frontier = None  # device sample frontier (attach_frontier)
        # pipeline tracing (obs/pipeline_trace.py): per-slot emit stamps so
        # sample time can attribute sequence age (emit ticks + seconds) —
        # always-on telemetry, no numerics touched
        self._emit_seq = np.zeros(capacity, np.int64)
        self._emit_ts = np.zeros(capacity, np.float64)
        # producing lane per stored sequence (telemetry, like the emit
        # stamps): multi-game runs map lane -> game for per-game learn-share
        # attribution; not persisted in snapshots (restored slots read 0)
        self._slot_lane = np.zeros(capacity, np.int64)
        self.emit_count = 0
        self._tracer = None

        # ---- per-lane builders: step data + the actor LSTM state BEFORE
        # each buffered step (so any window start has its exact state) ------
        self._buf_frames = np.zeros((lanes, seq_len, h, w), np.uint8)
        self._buf_actions = np.zeros((lanes, seq_len), np.int32)
        self._buf_rewards = np.zeros((lanes, seq_len), np.float32)
        self._buf_dones = np.zeros((lanes, seq_len), bool)
        self._buf_c = np.zeros((lanes, seq_len, lstm_size), np.float32)
        self._buf_h = np.zeros((lanes, seq_len, lstm_size), np.float32)
        self._buf_len = np.zeros(lanes, np.int64)
        self._lane_idx = np.arange(lanes)

    # -------------------------------------------------------------- building
    def append_batch(
        self,
        frames: np.ndarray,  # [lanes, H, W] uint8 — frame the action saw
        actions: np.ndarray,
        rewards: np.ndarray,
        terminals: np.ndarray,  # [lanes] bool — TRUE env terminals only
        lstm_c: np.ndarray,  # [lanes, lstm] actor state BEFORE this step
        lstm_h: np.ndarray,
        truncations: Optional[np.ndarray] = None,  # [lanes] bool — time-limit cuts
    ) -> int:
        """Push one lockstep tick; emits completed sequences. Returns the
        number of sequences emitted this tick.

        Both terminals and truncations flush the lane's builder (the episode
        stream breaks there), but only terminals are stored in the sequence's
        `done` channel — the learn step bootstraps through a truncation from
        whatever valid data exists before it, never teaching V=0 at the cut.
        """
        with self._lock:
            return self._append_locked(
                frames, actions, rewards, terminals, lstm_c, lstm_h, truncations
            )

    def _append_locked(
        self, frames, actions, rewards, terminals, lstm_c, lstm_h, truncations
    ):
        if truncations is None:
            truncations = np.zeros(self.lanes, bool)
        # vectorised scatter into each lane's builder row (the per-lane
        # Python loop only runs for lanes that EMIT this tick — rare)
        lane = self._lane_idx
        k = self._buf_len
        self._buf_frames[lane, k] = frames
        self._buf_actions[lane, k] = actions
        self._buf_rewards[lane, k] = rewards
        self._buf_dones[lane, k] = np.asarray(terminals, bool)
        self._buf_c[lane, k] = lstm_c
        self._buf_h[lane, k] = lstm_h
        self._buf_len += 1

        cut = np.asarray(terminals, bool) | np.asarray(truncations, bool)
        emit = cut | (self._buf_len == self.L)
        emitted = 0
        for i in np.flatnonzero(emit):
            emitted += self._emit(int(i), flush=bool(cut[i]))
        return emitted

    def _emit(self, lane: int, flush: bool) -> int:
        """Store the lane's buffered window as one sequence.  On flush
        (terminal) the builder restarts empty; otherwise the last
        L - stride steps carry over so adjacent sequences overlap, seeded
        with the exact stored state from the per-step history."""
        k = int(self._buf_len[lane])
        if k == 0:
            return 0
        slot = self.pos
        for store, buf in (
            (self.frames, self._buf_frames),
            (self.actions, self._buf_actions),
            (self.rewards, self._buf_rewards),
            (self.dones, self._buf_dones),
        ):
            store[slot] = 0
            store[slot, :k] = buf[lane, :k]
        self.valids[slot] = False
        self.valids[slot, :k] = True
        self.init_c[slot] = self._buf_c[lane, 0]
        self.init_h[slot] = self._buf_h[lane, 0]
        self.tree.set(np.asarray([slot]), np.asarray([self.max_priority]))
        if self._frontier is not None:
            self._frontier.stage(
                np.asarray([slot]), np.asarray([self.max_priority])
            )
        self.emit_count += 1
        self._emit_seq[slot] = self.emit_count
        self._emit_ts[slot] = time.time()
        self._slot_lane[slot] = lane
        self.pos = (self.pos + 1) % self.capacity
        self.filled = min(self.filled + 1, self.capacity)

        if flush:
            self._buf_len[lane] = 0
        else:
            tail = self.L - self.stride
            if tail > 0:
                for buf in (
                    self._buf_frames,
                    self._buf_actions,
                    self._buf_rewards,
                    self._buf_dones,
                    self._buf_c,
                    self._buf_h,
                ):
                    buf[lane, :tail] = buf[lane, self.stride :].copy()
            self._buf_len[lane] = tail
        return 1

    def __len__(self) -> int:
        return self.filled

    @property
    def sampleable(self) -> bool:
        return self.tree.total > 0

    def attach_frontier(self, frontier) -> None:
        """Device-sampling wiring (replay/frontier.py): emitted sequences
        stage their slot priority to the HBM mirror."""
        self._frontier = frontier

    def attach_tracer(self, tracer) -> None:
        """Pipeline-tracing wiring (obs/pipeline_trace.py): sample/assemble
        record batch sequence-age lags on the shared registry."""
        self._tracer = tracer

    def lane_of(self, idx: np.ndarray) -> np.ndarray:
        """Producing lane of each stored sequence slot (0 for restored
        slots — the stamps are telemetry, not persisted)."""
        return self._slot_lane[np.asarray(idx, np.int64)]

    def slot_lanes(self) -> np.ndarray:
        """Producing lane of every written slot ([filled])."""
        return self._slot_lane[: self.filled]

    def trace_ids(self, idx: np.ndarray) -> np.ndarray:
        """Emit tick of each slot in ``idx`` (0 = never stamped)."""
        return self._emit_seq[np.asarray(idx, np.int64)]

    def _record_sample_age(self, idx: np.ndarray) -> None:
        if self._tracer is None or idx.size == 0:
            return
        ts = self._emit_ts[idx]
        written = ts > 0
        if not written.any():
            return
        self._tracer.lag("sample_age_ticks", float(
            (self.emit_count - self._emit_seq[idx][written]).mean()))
        self._tracer.lag("sample_age_s",
                         float((time.time() - ts[written]).mean()))

    # -------------------------------------------------------------- sampling
    def sample(self, batch_size: int, beta: float) -> SequenceSample:
        hostsync.check_host_work("replay_sample")
        with self._lock:
            return self._sample_locked(batch_size, beta)

    def assemble_idx(
        self, idx: np.ndarray, weight: np.ndarray,
        prob: Optional[np.ndarray] = None,
    ) -> SequenceSample:
        """Index-driven sequence gather at already-drawn slot ids (the
        device-sampling path: the frontier drew ``idx`` and computed
        ``weight`` in HBM)."""
        idx = np.asarray(idx, np.int64).ravel()
        if idx.size and (idx.min() < 0 or idx.max() >= self.capacity):
            raise IndexError(f"assemble idx out of range [0, {self.capacity})")
        with self._lock:
            self._record_sample_age(idx)
            return SequenceSample(
                idx=idx,
                obs=self.frames[idx][..., None],
                action=self.actions[idx],
                reward=self.rewards[idx],
                done=self.dones[idx],
                valid=self.valids[idx],
                init_c=self.init_c[idx],
                init_h=self.init_h[idx],
                weight=np.asarray(weight, np.float32).ravel(),
                prob=None if prob is None else np.asarray(prob).ravel(),
            )

    def _sample_locked(self, batch_size: int, beta: float) -> SequenceSample:
        idx, prob = self.tree.sample_stratified(batch_size, self.rng)
        self._record_sample_age(idx)
        prob = np.maximum(prob, 1e-12)
        weights = (self.filled * prob) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        return SequenceSample(
            idx=idx,
            obs=self.frames[idx][..., None],
            action=self.actions[idx],
            reward=self.rewards[idx],
            done=self.dones[idx],
            valid=self.valids[idx],
            init_c=self.init_c[idx],
            init_h=self.init_h[idx],
            weight=weights,
            prob=prob,
        )

    def update_priorities(self, idx: np.ndarray, td_mix: np.ndarray) -> None:
        with self._lock:
            pri = (np.asarray(td_mix, np.float64) + self.eps) ** self.omega
            self.max_priority = max(self.max_priority, float(pri.max()))
            self.tree.set(idx, pri)

    # -------------------------------------------------------------- snapshot
    def snapshot(self, path: str) -> None:
        """Persist sequences AND the per-lane builder windows (so a resumed
        run continues mid-episode without losing the partial window)."""
        from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

        with self._lock:
            snapshot_io.atomic_savez(
                path,
                frames=self.frames,
                actions=self.actions,
                rewards=self.rewards,
                dones=self.dones,
                valids=self.valids,
                init_c=self.init_c,
                init_h=self.init_h,
                tree=self.tree.tree,
                pos=self.pos,
                filled=self.filled,
                max_priority=self.max_priority,
                buf_frames=self._buf_frames,
                buf_actions=self._buf_actions,
                buf_rewards=self._buf_rewards,
                buf_dones=self._buf_dones,
                buf_c=self._buf_c,
                buf_h=self._buf_h,
                buf_len=self._buf_len,
            )

    def restore(self, path: str) -> None:
        from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

        z = snapshot_io.load(path)
        if z["frames"].shape != self.frames.shape:
            raise ValueError(
                f"snapshot shape {z['frames'].shape} != buffer {self.frames.shape}"
            )
        with self._lock:
            for name, arr in (
                ("frames", self.frames), ("actions", self.actions),
                ("rewards", self.rewards), ("dones", self.dones),
                ("valids", self.valids), ("init_c", self.init_c),
                ("init_h", self.init_h), ("buf_frames", self._buf_frames),
                ("buf_actions", self._buf_actions),
                ("buf_rewards", self._buf_rewards),
                ("buf_dones", self._buf_dones), ("buf_c", self._buf_c),
                ("buf_h", self._buf_h), ("buf_len", self._buf_len),
            ):
                arr[:] = z[name]
            self.tree.tree[:] = z["tree"]
            self.pos = int(z["pos"])
            self.filled = int(z["filled"])
            self.max_priority = float(z["max_priority"])
        if self._frontier is not None:
            self._frontier.refresh_from_host()
