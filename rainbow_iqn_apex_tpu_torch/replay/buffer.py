"""Prioritized replay memory with n-step assembly and frame-dedup storage.

Parity: reference `rainbowiqn/memory.py` `ReplayMemory` (SURVEY.md §2 row 5):
proportional prioritization over p^omega, stratified batch sampling,
importance-sampling weights (N * P(i))^-beta normalised by the batch max,
n-step transition assembly from a ring buffer, and frame de-duplication —
each 84x84 frame is stored once and stacks are reconstructed at sample time.

TPU-first design notes:
- Everything is dense NumPy on the host; the device only ever sees the
  assembled [B, H, W, C] uint8 batch (SURVEY §7: "host replay, device
  batches").  Sampling cost is dominated by two fancy-indexed gathers.
- Multi-lane layout: a batched vector env steps L environments in lockstep
  (the TPU-native actor shape). Each lane owns a contiguous ring segment of
  the buffer so episode adjacency — which both frame-stack reconstruction
  and n-step assembly rely on — is preserved per lane, with one global
  sum-tree over all slots.  This replaces the reference's one-process-one-
  buffer adjacency assumption without giving up dedup.
- The sum-tree hot path can be served by the C++ core (replay/native.py)
  with identical layout; `SumTree` is the NumPy fallback.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.replay.sumtree import SumTree
from rainbow_iqn_apex_tpu_torch.utils import hostsync


@dataclasses.dataclass
class SampledBatch:
    """Host-side sample, ready to ship to the device as one transfer."""

    idx: np.ndarray  # [B] int64 global slot ids (for update_priorities)
    obs: np.ndarray  # [B, H, W, hist] uint8
    action: np.ndarray  # [B] int32
    reward: np.ndarray  # [B] float32 — n-step discounted return
    next_obs: np.ndarray  # [B, H, W, hist] uint8
    discount: np.ndarray  # [B] float32 — gamma^n * (1 - done-within-n)
    weight: np.ndarray  # [B] float32 — IS weights, max-normalised
    prob: np.ndarray = None  # [B] float64 — buffer-local sample probability
    # (kept alongside weight so sharded replay can re-derive globally
    # consistent IS weights; see parallel/sharded_replay.py)
    game: np.ndarray = None  # [B] int32 game ids — multi-game runs only
    # (multitask/replay.py attaches them; None on the single-game path)


class PrioritizedReplay:
    """Proportional PER over a multi-lane ring of de-duplicated frames.

    Per-timestep record (lane-local index t): the newest preprocessed frame
    f_t (the last slice of the state the action was chosen from), the action
    a_t, the resulting reward r_t and terminal flag d_t.
    """

    def __init__(
        self,
        capacity: int,
        frame_shape: Tuple[int, int],
        history: int = 4,
        n_step: int = 3,
        gamma: float = 0.99,
        lanes: int = 1,
        priority_exponent: float = 0.5,
        priority_eps: float = 1e-6,
        seed: int = 0,
        use_native: bool = True,
    ):
        if capacity % lanes != 0:
            raise ValueError(f"capacity {capacity} not divisible by lanes {lanes}")
        self.capacity = capacity
        self.lanes = lanes
        self.seg = capacity // lanes  # slots per lane ring
        if self.seg <= history + n_step:
            raise ValueError("per-lane segment too small for history + n_step")
        self.history = history
        self.n_step = n_step
        self.gamma = gamma
        self.omega = priority_exponent
        self.eps = priority_eps
        self.rng = np.random.default_rng(seed)

        h, w = frame_shape
        self.frames = np.zeros((capacity, h, w), dtype=np.uint8)
        self.actions = np.zeros(capacity, dtype=np.int32)
        self.rewards = np.zeros(capacity, dtype=np.float32)
        self.terminals = np.zeros(capacity, dtype=bool)  # true env terminals
        # cuts = terminal OR truncation: where the episode STREAM breaks
        # (frame stacks and n-step windows must not cross a cut; only true
        # terminals stop value bootstrapping — the two-channel design that
        # removes the time-limit bias, docs/DESIGN.md)
        self.cuts = np.zeros(capacity, dtype=bool)

        self.tree: SumTree
        self._core = None  # v2 fused C++ append/assemble (replay/native)
        if use_native:
            from rainbow_iqn_apex_tpu_torch.replay.native import (
                NativeSumTree,
                ReplayCore,
                native_available,
            )

            if native_available():
                self.tree = NativeSumTree(capacity)
                # rb_assemble's per-window scratch is sized for history<=16
                # (any sane stack depth); deeper stacks use the NumPy path
                if history <= 16:
                    self._core = ReplayCore(self)
            else:
                self.tree = SumTree(capacity)
        else:
            self.tree = SumTree(capacity)

        self.pos = 0  # lane-local write cursor (lockstep across lanes)
        self.filled = 0  # lane-local count of written slots (<= seg)
        self.max_priority = 1.0  # tree-space (already ^omega) value for new items
        # Serialises the multi-statement append/sample/update sequences so a
        # background prefetch thread (utils/prefetch.py) never observes a
        # half-applied tree update or a frame array mid-overwrite. Held only
        # for the ~ms host-side critical sections; device compute overlaps
        # freely. This is the explicit single-writer discipline SURVEY §5
        # calls for in place of Redis's single-threaded command loop.
        self._lock = threading.Lock()

        # discount ladder gamma^0..gamma^n, reused every sample
        self._gammas = self.gamma ** np.arange(self.n_step + 1, dtype=np.float32)
        self._lane_base = np.arange(self.lanes, dtype=np.int64) * self.seg

    # ------------------------------------------------------------------ append
    def append_batch(
        self,
        frames: np.ndarray,  # [L, H, W] uint8
        actions: np.ndarray,  # [L]
        rewards: np.ndarray,  # [L]
        terminals: np.ndarray,  # [L] bool — true env terminals (stop bootstrap)
        priorities: Optional[np.ndarray] = None,  # [L] raw |TD| (Ape-X actors)
        truncations: Optional[np.ndarray] = None,  # [L] bool — time-limit cuts
    ) -> np.ndarray:
        """Append one lockstep step of all lanes. Returns global slot ids."""
        L = frames.shape[0]
        if L != self.lanes:
            raise ValueError(f"expected {self.lanes} lanes, got {L}")
        with self._lock:
            return self._append_locked(
                frames, actions, rewards, terminals, priorities, truncations
            )

    def _append_locked(self, frames, actions, rewards, terminals, priorities, truncations):
        if self._core is not None:
            # v2: ring writes + every tree update in one native call
            self.max_priority = self._core.append_tick(
                frames, actions, rewards, terminals, priorities, truncations
            )
            slots = self._lane_base + self.pos
            self.pos = (self.pos + 1) % self.seg
            self.filled = min(self.filled + 1, self.seg)
            return slots
        slots = self._lane_base + self.pos
        self.frames[slots] = frames
        self.actions[slots] = actions
        self.rewards[slots] = rewards
        self.terminals[slots] = terminals
        self.cuts[slots] = (
            terminals if truncations is None else (terminals | truncations)
        )

        # One fused priority write per step covers three DISJOINT slot groups
        # (disjointness holds because seg > history + n_step):
        #  - the fresh slot: not yet sampleable, its n-step future is missing;
        #  - the slot written n_step appends ago: its future is now complete
        #    -> eligible. When actors supply an initial priority (Ape-X), it
        #    is the priority of THAT completed transition, not of this frame;
        #  - the cursor dead zone [new_pos, new_pos+history-1]: slots whose
        #    lookback window would cross the write cursor and mix frames from
        #    two different ring laps. (While the buffer is young these are
        #    unwritten and already zero — harmless.)
        new_pos = (self.pos + 1) % self.seg
        dead = (new_pos + np.arange(self.history)) % self.seg
        dead_slots = (self._lane_base[:, None] + dead[None, :]).ravel()
        upd_idx = [slots, dead_slots]
        upd_pri = [np.zeros(self.lanes), np.zeros(dead_slots.size)]
        if self.filled >= self.n_step:
            ready = (self.pos - self.n_step) % self.seg
            if priorities is None:
                pri = np.full(self.lanes, self.max_priority)
            else:
                pri = (np.asarray(priorities, np.float64) + self.eps) ** self.omega
                self.max_priority = max(self.max_priority, float(pri.max()))
            # Unbiased time-limit handling: a transition whose n-step window
            # hits a TRUNCATION before any terminal cannot form a correct
            # bootstrap target (the post-cut state belongs to a new episode
            # and the pre-cut final state was never stored) — it is simply
            # never eligible, rather than faking a terminal.
            w_offs = (ready + np.arange(self.n_step)) % self.seg
            w_slots = self._lane_base[:, None] + w_offs[None, :]
            cuts_w = self.cuts[w_slots]  # [L, n]
            term_w = self.terminals[w_slots]
            first_cut = cuts_w.argmax(axis=1)
            has_cut = cuts_w.any(axis=1)
            first_is_trunc = ~term_w[np.arange(self.lanes), first_cut]
            pri = np.where(has_cut & first_is_trunc, 0.0, pri)
            upd_idx.append(self._lane_base + ready)
            upd_pri.append(pri)
        self.tree.set(np.concatenate(upd_idx), np.concatenate(upd_pri))

        self.pos = new_pos
        self.filled = min(self.filled + 1, self.seg)
        return slots

    # ------------------------------------------------------------- live retune
    def set_priority_exponent(self, omega: float) -> None:
        """Mid-run omega adoption (league/ live gene): applies to every
        FUTURE append/write-back; existing tree values keep their old
        exponent until rewritten — Ape-X already tolerates priorities that
        stale (the write-back ring lags them anyway)."""
        with self._lock:
            self.omega = float(omega)

    @property
    def max_n_step(self) -> int:
        """Largest n the ring geometry admits (constructor + set_n_step
        require seg > history + n) — league genomes clamp to this so an
        explore draw near the prior ceiling can never crash-loop a member
        into eviction."""
        return self.seg - self.history - 1

    def set_n_step(self, n_step: int) -> None:
        """Mid-run n-step adoption (league/ live gene, adopted at drain
        boundaries).  Assembly recomputes every window from raw per-step
        rewards, so EXISTING transitions re-read correctly under the new n
        — what changes is *eligibility*: which slots have a complete,
        cut-legal n-step future.  Eligibility is therefore recomputed for
        the whole ring (vectorised, one pass) instead of trusting marks
        made under the old n:

        - slots within n of the write cursor lose eligibility (future now
          incomplete) until the cursor moves past them — and since append
          only marks the slot exactly n back, slots in the old-n..new-n gap
          would otherwise stay marked with a short future;
        - slots whose NEW window hits a truncation before any terminal are
          fenced (the unbiased time-limit rule, re-applied under new n);
        - newly-eligible slots (n shrank) enter at ``max_priority``, the
          fresh-item default.
        """
        n = int(n_step)
        if n < 1:
            raise ValueError(f"n_step ({n}) must be >= 1")
        with self._lock:
            if n == self.n_step:
                return
            if self.seg <= self.history + n:
                raise ValueError(
                    f"per-lane segment {self.seg} too small for history "
                    f"{self.history} + n_step {n} — a smaller replay or a "
                    f"shorter n is required (league genomes must respect "
                    "the buffer geometry)")
            self.n_step = n
            self._gammas = self.gamma ** np.arange(n + 1, dtype=np.float32)
            self._refresh_eligibility_locked()

    def _refresh_eligibility_locked(self, chunk: int = 8192) -> None:
        """Recompute tree eligibility for every slot under the current
        n_step/history.  Vectorised in offset CHUNKS: the window gather is
        [lanes, chunk, n] — an Atari-scale ring (1M slots, n up to the
        genome prior's 10) would otherwise materialize ~100MB of transient
        index/bool arrays inside the buffer lock for one rare retune."""
        if self.filled == 0:
            return
        steps = np.arange(self.n_step)
        for lo in range(0, self.seg, chunk):
            offs = np.arange(lo, min(lo + chunk, self.seg))
            written = (np.ones(offs.size, bool) if self.filled >= self.seg
                       else offs < self.filled)
            # future complete: the newest written slot is (pos-1) % seg;
            # slot `off` needs n appends after it, i.e. age >= n
            future_ok = ((self.pos - 1 - offs) % self.seg) >= self.n_step
            # lookback dead zone: stacks ending here would cross the cursor
            look_dead = ((offs - self.pos) % self.seg) < self.history
            ok_off = written & future_ok & ~look_dead
            # unbiased time-limit rule under the NEW window: first cut
            # inside [off, off+n) being a truncation fences the slot
            w_offs = (offs[:, None] + steps[None, :]) % self.seg
            slots = (self._lane_base[:, None, None]
                     + w_offs[None, :, :])  # [L, chunk, n]
            cuts_w = self.cuts[slots]
            term_w = self.terminals[slots]
            first_cut = cuts_w.argmax(axis=2)
            has_cut = cuts_w.any(axis=2)
            first_is_trunc = ~np.take_along_axis(
                term_w, first_cut[..., None], axis=2)[..., 0]
            eligible = ok_off[None, :] & ~(has_cut & first_is_trunc)
            idx = (self._lane_base[:, None] + offs[None, :]).ravel()
            current = self.tree.get(idx)
            flat = eligible.ravel()
            self.tree.set(idx, np.where(
                flat, np.where(current > 0, current, self.max_priority),
                0.0))

    def append(self, frame, action, reward, terminal, priority=None) -> int:
        """Single-lane convenience (reference's per-process API shape)."""
        pri = None if priority is None else np.asarray([priority])
        return int(
            self.append_batch(
                np.asarray(frame)[None],
                np.asarray([action]),
                np.asarray([reward], np.float32),
                np.asarray([terminal]),
                pri,
            )[0]
        )

    def __len__(self) -> int:
        return self.filled * self.lanes

    @property
    def sampleable(self) -> bool:
        return self.tree.total > 0

    # ------------------------------------------------------------------ sample
    def _gather_stacks(self, lane: np.ndarray, off: np.ndarray) -> np.ndarray:
        """Frame stacks ending at lane-local offset `off`: [B, H, W, history].

        Frames from before the episode start (a terminal strictly inside the
        lookback window) are zeroed — the reference's reset-time zero-stack
        semantics without storing the zero frames.
        """
        B = off.shape[0]
        steps = np.arange(-(self.history - 1), 1)  # [-h+1 .. 0]
        offs = (off[:, None] + steps[None, :]) % self.seg  # [B, h]
        slots = lane[:, None] * self.seg + offs
        stacks = self.frames[slots]  # [B, h, H, W]

        # an episode cut at window position j (j < h-1) kills frames [.. j]
        term = self.cuts[slots[:, :-1]]  # [B, h-1]
        dead_tail = np.cumsum(term[:, ::-1], axis=1)[:, ::-1] > 0  # any terminal at/after j
        valid = np.concatenate([~dead_tail, np.ones((B, 1), bool)], axis=1)
        # frames older than what's been written in a young buffer are invalid too
        if self.filled < self.seg:
            age_ok = (off[:, None] + steps[None, :]) >= 0
            valid &= age_ok
        stacks = stacks * valid[:, :, None, None].astype(np.uint8)
        return np.moveaxis(stacks, 1, -1)  # [B, H, W, h]

    def sample(self, batch_size: int, beta: float) -> SampledBatch:
        """Stratified proportional sample + n-step assembly + IS weights."""
        hostsync.check_host_work("replay_sample")
        with self._lock:
            return self._sample_locked(batch_size, beta)

    def _sample_locked(self, batch_size: int, beta: float) -> SampledBatch:
        idx, prob = self.tree.sample_stratified(batch_size, self.rng)
        prob = np.maximum(prob, 1e-12)  # fp edge-fall can land on a zero leaf
        obs, next_obs, action, reward, discount = self._assemble_locked(idx)
        n = len(self)
        weights = (n * prob) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        return SampledBatch(
            idx=idx,
            obs=obs,
            action=action,
            reward=reward,
            next_obs=next_obs,
            discount=discount,
            weight=weights,
            prob=prob,
        )

    def assemble(self, idx: np.ndarray, out=None):
        """n-step assembly + stack gathers at already-drawn slot ids (the
        device-sampling gather path: the frontier drew ``idx`` on device;
        the host's job is this index-driven gather).  Returns
        ``(obs, next_obs, action, reward, discount)`` in ``idx`` order.
        ``out``, when given, receives the rows in place (contiguous row
        slices of a larger batch — zero-copy on the native core)."""
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        if idx.size and (idx.min() < 0 or idx.max() >= self.capacity):
            # the native core would read out of bounds — fail loudly instead
            raise IndexError(
                f"assemble idx out of range [0, {self.capacity})"
            )
        with self._lock:
            return self._assemble_locked(idx, out)

    def _assemble_locked(self, idx: np.ndarray, out=None):
        batch_size = idx.shape[0]
        if self._core is not None:
            # v2: n-step scan + both stack gathers in one native call
            return self._core.assemble(idx, batch_size, out=out)
        lane = idx // self.seg
        off = idx % self.seg

        # --- n-step scan (vectorised over the batch) ---------------------
        steps = np.arange(self.n_step)
        f_offs = (off[:, None] + steps[None, :]) % self.seg  # [B, n]
        f_slots = lane[:, None] * self.seg + f_offs
        r = self.rewards[f_slots]  # [B, n]
        d = self.terminals[f_slots]  # [B, n]
        # alive[k] = no terminal strictly before step k
        alive = np.cumprod(1.0 - d[:, :-1].astype(np.float32), axis=1)
        alive = np.concatenate([np.ones((batch_size, 1), np.float32), alive], axis=1)
        reward = (r * alive * self._gammas[None, : self.n_step]).sum(axis=1)
        done_within = d.any(axis=1)
        discount = np.where(done_within, 0.0, self._gammas[self.n_step]).astype(
            np.float32
        )

        obs = self._gather_stacks(lane, off)
        next_obs = self._gather_stacks(lane, (off + self.n_step) % self.seg)
        action = self.actions[lane * self.seg + off]
        reward = reward.astype(np.float32)
        if out is not None:  # NumPy fallback: one copy into the caller rows
            out[0][:] = obs
            out[1][:] = next_obs
            out[2][:] = action
            out[3][:] = reward
            out[4][:] = discount
            return out
        return (obs, next_obs, action, reward, discount)

    # -------------------------------------------------------------- snapshot
    def snapshot(self, path: str) -> None:
        """Persist the full replay state (parity: the reference's replay
        survives via Redis RDB/AOF persistence, SURVEY.md §5 'Checkpoint';
        here one compressed npz per shard)."""
        with self._lock:
            self._snapshot_locked(path)

    def _snapshot_locked(self, path: str) -> None:
        import json

        from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

        snapshot_io.atomic_savez(
            path,
            frames=self.frames,
            actions=self.actions,
            rewards=self.rewards,
            terminals=self.terminals,
            cuts=self.cuts,
            tree=self.tree.tree,
            pos=self.pos,
            filled=self.filled,
            max_priority=self.max_priority,
            # sampler RNG state: exact resume must replay the SAME batch the
            # uninterrupted run would have drawn (preemption-safe resume)
            rng_state=np.frombuffer(
                json.dumps(self.rng.bit_generator.state).encode(), np.uint8
            ),
        )

    def restore(self, path: str) -> None:
        from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

        self.apply_snapshot(snapshot_io.load(path))

    def apply_snapshot(self, z) -> None:
        """Apply an already-loaded (and CRC-verified) snapshot payload —
        lets ShardedReplay verify every shard first and apply without
        re-reading the files."""
        if z["frames"].shape != self.frames.shape:
            raise ValueError(
                f"snapshot shape {z['frames'].shape} != buffer {self.frames.shape}"
            )
        self.frames[:] = z["frames"]
        self.actions[:] = z["actions"]
        self.rewards[:] = z["rewards"]
        self.terminals[:] = z["terminals"]
        # older snapshots (pre two-channel) carry no cuts array
        self.cuts[:] = z["cuts"] if "cuts" in z.files else z["terminals"]
        self.tree.tree[:] = z["tree"]
        self.pos = int(z["pos"])
        self.filled = int(z["filled"])
        self.max_priority = float(z["max_priority"])
        if "rng_state" in z.files:  # pre-resilience snapshots carry no RNG
            import json

            self.rng.bit_generator.state = json.loads(
                np.asarray(z["rng_state"], np.uint8).tobytes().decode()
            )

    # -------------------------------------------------------------- priorities
    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray) -> None:
        """Learner write-back: p = (|TD| + eps)^omega (reference semantics)."""
        with self._lock:
            pri = (np.asarray(td_abs, np.float64) + self.eps) ** self.omega
            self.max_priority = max(self.max_priority, float(pri.max()))
            # Never resurrect slots the cursor has since invalidated.
            current = self.tree.get(np.asarray(idx))
            pri = np.where(current > 0, pri, 0.0)
            self.tree.set(idx, pri)
