"""Sharded prioritized replay — the Redis-shard topology in host DRAM.

A copy of ``rainbow_iqn_apex_tpu/parallel/sharded_replay.py`` (jax-free) over
the port's ``replay.buffer``; the frontier hooks (``attach_frontier``, the
staged append deltas, drop/readmit fencing, ``eligible_mask``,
``assemble_global``, the refresh on ``restore``) drive the port's
``replay/frontier.py``.

Parity: reference component row 6 (SURVEY.md §2): replay contents sharded
across multiple redis-server instances so many actors append and one learner
samples, with remote priority write-back.  Here each shard is a
PrioritizedReplay owned by the host (one per pod host in the multi-host
picture; several in-process shards model the same topology single-host), and
"remote" traffic becomes NumPy writes — the learner's sample mixes
sub-batches drawn from every shard in proportion to total shard priority
mass, which is exactly proportional global sampling (the same distribution a
single giant tree would give).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay, SampledBatch
from rainbow_iqn_apex_tpu_torch.utils import faults, hostsync


class ShardedReplay:
    """K independent PER shards behind the single-buffer interface.

    Lane -> shard assignment is static (contiguous blocks), mirroring the
    reference's actor->redis-shard pinning; global slot ids are
    (shard_id * shard_capacity + local_slot).
    """

    def __init__(self, shards: Sequence[PrioritizedReplay]):
        if not shards:
            raise ValueError("need at least one shard")
        caps = {s.capacity for s in shards}
        if len(caps) != 1:
            raise ValueError("all shards must share a capacity")
        self.shards: List[PrioritizedReplay] = list(shards)
        self.shard_capacity = shards[0].capacity
        self.lanes_per_shard = shards[0].lanes
        self.rng = np.random.default_rng(shards[0].rng.integers(2**31))
        # graceful degradation: shards marked dead (their host stopped
        # heartbeating / their backing store is gone) are excluded from
        # append/sample/write-back so the learner keeps training on the
        # survivors instead of wedging (docs/RESILIENCE.md)
        self._dead: set = set()
        # elasticity (docs/RESILIENCE.md "heal"): each shard carries the
        # lease epoch of the incarnation allowed to write it.  drop ->
        # readmit bumps the epoch, so a zombie pre-eviction incarnation's
        # appends/write-backs are fenced off instead of corrupting the
        # readmitted shard (split-brain protection).
        self._epoch: List[int] = [0] * len(self.shards)
        self._fenced_writes = 0
        self._reg = None  # obs registry (attach_registry); None = untracked
        self._frontier = None  # device sample frontier (attach_frontier)
        # pipeline tracing (obs/pipeline_trace.py): every written slot is
        # stamped with the append tick + wall clock it landed on, so sample
        # time can attribute each batch's AGE (ticks + seconds) and derive
        # the env-tick trace ids the learn span links back to.  16 bytes per
        # slot, two scatter writes per append tick — always-on cheap; no
        # numerics touched, so the untraced path stays bitwise identical.
        n_slots = len(self.shards) * self.shard_capacity
        self._append_seq = np.zeros(n_slots, np.int64)
        self._append_ts = np.zeros(n_slots, np.float64)
        self.append_ticks = 0  # monotone appends-per-lane counter
        self._tracer = None

    def attach_registry(self, registry, role: str = "replay") -> None:
        """obs/ wiring: appended/sampled row counters + occupancy and
        dead-shard gauges under the given role label."""
        self._reg = registry
        self._role = role
        registry.gauge("replay_shards", role).set(len(self.shards))

    def attach_tracer(self, tracer) -> None:
        """Pipeline-tracing wiring (obs/pipeline_trace.py): sample/assemble
        record batch sample-age lags; ``trace_ids`` maps sampled slots back
        to the append ticks that wrote them (the learn span's flow links)."""
        self._tracer = tracer

    def _stamp_append(self, k: int, shard: PrioritizedReplay,
                      pos_before: int) -> None:
        slots = k * self.shard_capacity + shard._lane_base + pos_before
        self._append_seq[slots] = self.append_ticks
        self._append_ts[slots] = time.time()

    def _record_sample_age(self, idx: np.ndarray) -> None:
        if self._tracer is None or idx.size == 0:
            return
        ts = self._append_ts[idx]
        written = ts > 0  # pre-attach / restored slots carry no stamp
        if not written.any():
            return
        self._tracer.lag("sample_age_ticks", float(
            (self.append_ticks - self._append_seq[idx][written]).mean()))
        self._tracer.lag("sample_age_s",
                         float((time.time() - ts[written]).mean()))

    def trace_ids(self, idx: np.ndarray) -> np.ndarray:
        """Append tick of each global slot in ``idx`` (0 = never stamped)."""
        return self._append_seq[np.asarray(idx, np.int64)]

    def attach_frontier(self, frontier) -> None:
        """Device-sampling wiring (replay/frontier.py): subsequent appends
        stage their tree leaf deltas to the HBM priority mirror, and shard
        drop/readmit fence the mirror alongside the host epoch."""
        self._frontier = frontier

    def _stage_frontier_delta(self, k: int, shard: PrioritizedReplay,
                              pos_before: int) -> None:
        """Mirror one append tick's three disjoint leaf updates (fresh slot,
        cursor dead zone, ready slot — see buffer._append_locked) by reading
        the freshly written tree values back: works identically for the
        NumPy and native-core append paths, and re-staging an unchanged
        ready value is harmless."""
        seg = shard.seg
        new_pos = (pos_before + 1) % seg
        cols = np.concatenate([
            np.asarray(
                [pos_before, (pos_before - shard.n_step) % seg], np.int64
            ),
            (new_pos + np.arange(shard.history, dtype=np.int64)) % seg,
        ])
        slots = (shard._lane_base[:, None] + cols[None, :]).ravel()
        self._frontier.stage(
            k * self.shard_capacity + slots, shard.tree.get(slots)
        )

    def _observe(self) -> None:
        if self._reg is None:
            return
        cap = self.shard_capacity * (len(self.shards) - len(self._dead))
        self._reg.gauge("replay_size", self._role).set(len(self))
        self._reg.gauge("replay_occupancy", self._role).set(
            len(self) / max(cap, 1)
        )
        self._reg.gauge("replay_dead_shards", self._role).set(len(self._dead))

    @classmethod
    def build(
        cls, num_shards: int, capacity_total: int, lanes_total: int, **kwargs
    ) -> "ShardedReplay":
        if capacity_total % num_shards or lanes_total % num_shards:
            raise ValueError("capacity and lanes must divide evenly into shards")
        seed = kwargs.pop("seed", 0)
        shards = [
            PrioritizedReplay(
                capacity_total // num_shards,
                lanes=lanes_total // num_shards,
                seed=seed + 1000 * k,
                **kwargs,
            )
            for k in range(num_shards)
        ]
        return cls(shards)

    # ------------------------------------------------------------------ append
    def append_batch(
        self,
        frames: np.ndarray,
        actions: np.ndarray,
        rewards: np.ndarray,
        terminals: np.ndarray,
        priorities: Optional[np.ndarray] = None,
        truncations: Optional[np.ndarray] = None,
    ) -> None:
        """Lockstep append of all lanes, block-partitioned across shards.
        Lanes pinned to a dead shard are dropped (their actor host is gone;
        the surviving shards keep absorbing their own lanes)."""
        lps = self.lanes_per_shard
        self.append_ticks += 1
        for k, shard in enumerate(self.shards):
            if k in self._dead:
                continue
            sl = slice(k * lps, (k + 1) * lps)
            pos_before = shard.pos
            shard.append_batch(
                frames[sl],
                actions[sl],
                rewards[sl],
                terminals[sl],
                None if priorities is None else priorities[sl],
                None if truncations is None else truncations[sl],
            )
            self._stamp_append(k, shard, pos_before)
            if self._frontier is not None:
                self._stage_frontier_delta(k, shard, pos_before)
            if self._reg is not None:
                self._reg.counter("replay_appended_rows", self._role).inc(lps)
        self._observe()

    def __len__(self) -> int:
        return sum(len(s) for k, s in enumerate(self.shards) if k not in self._dead)

    @property
    def sampleable(self) -> bool:
        """ANY alive shard with priority mass makes the aggregate
        sampleable: ``sample`` already hands a zero-mass shard a zero
        multinomial count, and requiring ALL alive shards to hold data
        would let one cold readmitted shard (an explicitly supported
        healing state) halt a learner whose surviving shards are full."""
        return any(
            s.sampleable
            for k, s in enumerate(self.shards) if k not in self._dead
        )

    # -------------------------------------------------------------- degradation
    def drop_shard(self, k: int) -> None:
        """Mark shard ``k`` dead: its lanes stop appending, its contents stop
        being sampled, priority write-backs to it are dropped.  Idempotent.
        The learner's sample distribution renormalises over the survivors —
        exactly what losing one redis-server of a sharded fleet means."""
        if not 0 <= k < len(self.shards):
            raise ValueError(f"no shard {k} (have {len(self.shards)})")
        if len(self._dead) >= len(self.shards) - 1 and k not in self._dead:
            raise RuntimeError("cannot drop the last surviving replay shard")
        already = k in self._dead
        self._dead.add(k)
        if self._frontier is not None and not already:
            # fence the HBM mirror too: zero the slice so device draws
            # renormalise over survivors exactly like the host sample
            self._frontier.on_drop(k)
        self._observe()

    @property
    def dead_shards(self) -> Tuple[int, ...]:
        return tuple(sorted(self._dead))

    # -------------------------------------------------------------- elasticity
    def shard_epoch(self, k: int) -> int:
        """The lease epoch currently allowed to write shard ``k``."""
        return self._epoch[k]

    @property
    def fenced_writes(self) -> int:
        """Appends/write-backs rejected by epoch fencing (lifetime)."""
        return self._fenced_writes

    def readmit_shard(self, k: int, epoch: Optional[int] = None,
                      reseed_priority: bool = True) -> int:
        """Reverse ``drop_shard``: a rejoining host re-registers its (empty
        or snapshot-restored) shard under a NEW lease epoch.  Sampling
        rebalances over the survivor set automatically (the proportional
        split sees the shard's mass again), and the shard's default append
        priority is re-seeded from the survivors' current max so a cold
        rejoining shard's fresh experience competes immediately instead of
        starving behind a year of accumulated priority mass.  Returns the
        epoch that now owns the shard; the ``shard_rejoin`` fault point
        makes the re-registration itself fail once (callers retry under the
        shared RetryPolicy)."""
        if not 0 <= k < len(self.shards):
            raise ValueError(f"no shard {k} (have {len(self.shards)})")
        if k not in self._dead:
            raise ValueError(f"shard {k} is not dead; nothing to readmit")
        injector = faults.get()
        if injector.enabled and injector.fire("shard_rejoin"):
            raise OSError(f"injected shard_rejoin failure for shard {k}")
        new_epoch = self._epoch[k] + 1 if epoch is None else int(epoch)
        # equal epoch is legal: a false-positive drop (lease blip) readmits
        # the SAME incarnation, whose writes stay valid; only an OLDER epoch
        # — a superseded incarnation — is an error
        if new_epoch < self._epoch[k]:
            raise ValueError(
                f"readmission epoch {new_epoch} is older than the fenced "
                f"epoch {self._epoch[k]} for shard {k}"
            )
        if reseed_priority:
            survivor_max = [
                s.max_priority for j, s in enumerate(self.shards)
                if j != k and j not in self._dead
            ]
            if survivor_max:
                self.shards[k].max_priority = max(
                    max(survivor_max), self.shards[k].max_priority
                )
        self._dead.discard(k)
        self._epoch[k] = new_epoch
        if self._frontier is not None:
            # the mirror re-reads the readmitted shard's host tree (the cold
            # source of truth the rejoining host restored) under a fresh
            # frontier epoch, so sample-ahead batches drawn pre-readmission
            # are countable as stale
            self._frontier.on_readmit(k)
        if self._reg is not None:
            self._reg.counter("replay_shard_readmits", self._role).inc()
        self._observe()
        return new_epoch

    def _fence(self, k: int, epoch: Optional[int]) -> bool:
        """True when a write stamped ``epoch`` may land on shard ``k``."""
        if k in self._dead:
            return False
        if epoch is not None and int(epoch) != self._epoch[k]:
            self._fenced_writes += 1
            if self._reg is not None:
                self._reg.counter("replay_fenced_writes", self._role).inc()
            return False
        return True

    def append_shard(
        self,
        k: int,
        frames: np.ndarray,
        actions: np.ndarray,
        rewards: np.ndarray,
        terminals: np.ndarray,
        priorities: Optional[np.ndarray] = None,
        truncations: Optional[np.ndarray] = None,
        epoch: Optional[int] = None,
    ) -> bool:
        """Epoch-fenced single-shard append (the elastic ingest path: one
        producer host feeds exactly its own shard).  Returns False — and
        drops the rows — when the shard is dead or ``epoch`` names a stale
        incarnation; True when the rows landed."""
        if not 0 <= k < len(self.shards):
            raise ValueError(f"no shard {k} (have {len(self.shards)})")
        if not self._fence(k, epoch):
            return False
        pos_before = self.shards[k].pos
        self.append_ticks += 1
        self.shards[k].append_batch(
            frames, actions, rewards, terminals, priorities, truncations
        )
        self._stamp_append(k, self.shards[k], pos_before)
        if self._frontier is not None:
            self._stage_frontier_delta(k, self.shards[k], pos_before)
        if self._reg is not None:
            self._reg.counter("replay_appended_rows", self._role).inc(
                len(actions)
            )
        self._observe()
        return True

    def update_shard_priorities(
        self, k: int, local_idx: np.ndarray, td_abs: np.ndarray,
        epoch: Optional[int] = None,
    ) -> bool:
        """Epoch-fenced per-shard priority write-back (same fence as
        ``append_shard``; a stale incarnation's TD estimates must not skew
        the readmitted shard's sampling distribution)."""
        if not 0 <= k < len(self.shards):
            raise ValueError(f"no shard {k} (have {len(self.shards)})")
        if not self._fence(k, epoch):
            return False
        self.shards[k].update_priorities(local_idx, td_abs)
        return True

    # ------------------------------------------------------------------ sample
    def sample(self, batch_size: int, beta: float) -> SampledBatch:
        """Proportional global sample: shard k contributes ~ its share of the
        total priority mass (multinomial split), then samples locally."""
        hostsync.check_host_work("replay_sample")
        totals = np.asarray(
            [
                0.0 if k in self._dead else s.tree.total
                for k, s in enumerate(self.shards)
            ],
            np.float64,
        )
        if totals.sum() <= 0:
            raise ValueError("cannot sample: all surviving shards empty")
        counts = self.rng.multinomial(batch_size, totals / totals.sum())
        # a zero-count shard simply doesn't contribute this batch (matches
        # multi-redis sampling); the multinomial split makes the overall draw
        # exactly proportional to global priority mass.
        parts: List[SampledBatch] = []
        probs: List[np.ndarray] = []
        n_global = len(self)
        for k, (shard, c) in enumerate(zip(self.shards, counts)):
            if c == 0:
                continue
            b = shard.sample(int(c), beta)
            parts.append(
                SampledBatch(
                    idx=b.idx + k * self.shard_capacity,
                    obs=b.obs,
                    action=b.action,
                    reward=b.reward,
                    next_obs=b.next_obs,
                    discount=b.discount,
                    weight=b.weight,  # replaced below with the global version
                    prob=b.prob,
                )
            )
            # global sample probability: local prob scaled by the shard's
            # share of total priority mass
            probs.append(b.prob * (totals[k] / totals.sum()))

        if self._reg is not None:
            self._reg.counter("replay_sampled_rows", self._role).inc(batch_size)
        cat = lambda f: np.concatenate([getattr(p, f) for p in parts])  # noqa: E731
        prob = np.concatenate(probs)
        idx_all = cat("idx")
        self._record_sample_age(idx_all)
        weight = (n_global * np.maximum(prob, 1e-12)) ** (-beta)
        weight = (weight / weight.max()).astype(np.float32)
        return SampledBatch(
            idx=idx_all,
            obs=cat("obs"),
            action=cat("action"),
            reward=cat("reward"),
            next_obs=cat("next_obs"),
            discount=cat("discount"),
            weight=weight,
            prob=prob,
        )

    def eligible_mask(self, idx: np.ndarray) -> np.ndarray:
        """True where global slot ``idx`` is CURRENTLY eligible (host-tree
        leaf > 0 on an alive shard).  The append path maintains the
        invariant that every slot whose history/n-step window would cross
        the write cursor carries zero priority, so a sample-ahead batch can
        re-check its device-drawn indices at GATHER time: rows invalidated
        by cursor movement since the draw read as False (their assembly
        would mix frames from two ring laps) and get their IS weight zeroed
        instead of training on straddled transitions."""
        idx = np.asarray(idx, np.int64).ravel()
        shard_of = idx // self.shard_capacity
        local = idx % self.shard_capacity
        ok = np.zeros(idx.shape[0], bool)
        in_range = (idx >= 0) & (idx < len(self.shards) * self.shard_capacity)
        for k, shard in enumerate(self.shards):
            if k in self._dead:
                continue
            m = (shard_of == k) & in_range
            if m.any():
                ok[m] = shard.tree.get(local[m]) > 0
        return ok

    def assemble_global(
        self,
        idx: np.ndarray,
        weight: np.ndarray,
        prob: Optional[np.ndarray] = None,
    ) -> SampledBatch:
        """Index-driven batch assembly at already-drawn global slot ids (the
        device-sampling hot path: the frontier drew ``idx`` and computed
        ``weight`` in HBM; the host's remaining job is this frame gather).

        Rows come back sorted by slot id.  PER batches are exchangeable —
        per-row weights/probs travel with their rows — and the frontier's
        stratified draw emits slot-sorted indices already, so sorting is
        usually a no-op; it makes every shard's rows one CONTIGUOUS slice
        of the output, which the native core fills IN PLACE (zero extra
        copies — the host sample path's per-shard concatenate pays one
        full batch copy here)."""
        idx = np.asarray(idx, np.int64).ravel()
        weight = np.asarray(weight, np.float32).ravel()
        B = idx.shape[0]
        n_slots = len(self.shards) * self.shard_capacity
        if B and (idx.min() < 0 or idx.max() >= n_slots):
            # match PrioritizedReplay.assemble: silent np.empty rows for
            # out-of-range ids would train on garbage
            raise IndexError(f"assemble_global idx out of range [0, {n_slots})")
        if np.any(idx[1:] < idx[:-1]):  # host callers may pass unsorted
            order = np.argsort(idx, kind="stable")
            idx, weight = idx[order], weight[order]
            if prob is not None:
                prob = np.asarray(prob).ravel()[order]
        shard_of = idx // self.shard_capacity
        local = idx % self.shard_capacity
        s0 = self.shards[0]
        h, w = s0.frames.shape[1], s0.frames.shape[2]
        obs = np.empty((B, h, w, s0.history), np.uint8)
        next_obs = np.empty_like(obs)
        action = np.empty(B, np.int32)
        reward = np.empty(B, np.float32)
        discount = np.empty(B, np.float32)
        bounds = np.searchsorted(shard_of, np.arange(len(self.shards) + 1))
        for k, shard in enumerate(self.shards):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            if lo == hi:
                continue
            sl = slice(lo, hi)
            shard.assemble(local[sl], out=(
                obs[sl], next_obs[sl], action[sl], reward[sl], discount[sl],
            ))
        if self._reg is not None:
            self._reg.counter("replay_sampled_rows", self._role).inc(B)
        self._record_sample_age(idx)
        return SampledBatch(
            idx=idx,
            obs=obs,
            action=action,
            reward=reward,
            next_obs=next_obs,
            discount=discount,
            weight=weight,
            prob=None if prob is None else np.asarray(prob).ravel(),
        )

    # -------------------------------------------------------------- snapshot
    def snapshot(self, path_prefix: str) -> None:
        """One npz per shard (the per-host persistence unit in the pod
        picture, mirroring per-redis-instance RDB files) plus a tiny meta
        file carrying the shard-split RNG, so a resumed learner draws the
        same shard mix the uninterrupted run would have."""
        import json

        from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

        for k, shard in enumerate(self.shards):
            shard.snapshot(f"{path_prefix}_shard{k}")
        snapshot_io.atomic_savez(
            f"{path_prefix}_meta",
            rng_state=np.frombuffer(
                json.dumps(self.rng.bit_generator.state).encode(), np.uint8
            ),
            # elasticity state: writer epochs + dead set, so a resumed run
            # keeps fencing the same stale incarnations it fenced before
            shard_epochs=np.asarray(self._epoch, np.int64),
            dead_shards=np.asarray(sorted(self._dead), np.int64),
        )

    def restore(self, path_prefix: str) -> None:
        import json
        import os

        from rainbow_iqn_apex_tpu_torch.replay import snapshot_io

        # check the whole shard set up front — existence AND CRC — so a kill
        # that landed between shard writes, or one torn shard file, reads as
        # "no snapshot" instead of a half-restored mix.  The verified
        # payloads are applied directly (one disk read per shard, not two).
        paths = [f"{path_prefix}_shard{k}" for k in range(len(self.shards))]
        for p in paths:
            if not os.path.exists(snapshot_io.npz_path(p)):
                raise FileNotFoundError(snapshot_io.npz_path(p))
        payloads = [snapshot_io.load(p) for p in paths]  # SnapshotCorrupt here
        for shard, z in zip(self.shards, payloads):
            shard.apply_snapshot(z)
        try:  # pre-resilience snapshots carry no meta file
            meta = snapshot_io.load(f"{path_prefix}_meta")
            self.rng.bit_generator.state = json.loads(
                np.asarray(meta["rng_state"], np.uint8).tobytes().decode()
            )
            if "shard_epochs" in meta:  # pre-elastic metas carry neither
                epochs = np.asarray(meta["shard_epochs"], np.int64)
                if len(epochs) == len(self.shards):
                    self._epoch = [int(e) for e in epochs]
                self._dead = {int(k) for k in np.asarray(
                    meta["dead_shards"], np.int64)}
        except snapshot_io.MISSING:
            pass
        if self._frontier is not None:
            self._frontier.refresh_from_host(dead=self._dead)

    # ------------------------------------------------------------- live retune
    @property
    def max_n_step(self) -> int:
        """Largest n every shard's geometry admits (league genome clamp)."""
        return min(s.max_n_step for s in self.shards)

    def set_n_step(self, n_step: int) -> None:
        """Mid-run n-step adoption (league/ live gene): every shard
        re-fences its eligibility under the new window.  Callers adopt at a
        drain boundary with the device frontier OFF — the HBM mirror stages
        deltas under the old window geometry (league member loops fall back
        to host sampling, parallel/apex.py)."""
        for shard in self.shards:
            shard.set_n_step(n_step)

    def set_priority_exponent(self, omega: float) -> None:
        """Mid-run omega adoption (league/ live gene): future write-backs
        use the new exponent on every shard."""
        for shard in self.shards:
            shard.set_priority_exponent(omega)

    # -------------------------------------------------------------- priorities
    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray) -> None:
        shard_of = idx // self.shard_capacity
        local = idx % self.shard_capacity
        for k, shard in enumerate(self.shards):
            if k in self._dead:
                continue  # write-backs racing a shard death are dropped
            m = shard_of == k
            if m.any():
                shard.update_priorities(local[m], td_abs[m])
