"""MultiGameReplay: game-pinned replay shard blocks behind one interface.

A copy of ``rainbow_iqn_apex_tpu/multitask/replay.py`` over the port's
``parallel.sharded_replay`` and ``replay.buffer``.

IS-A `ShardedReplay` — every elasticity/persistence/telemetry affordance
(epoch-fenced drop/readmit, CRC snapshots, registry/tracer wiring, the
device sample frontier's mirror, the write-back ring's `update_priorities`
target) is inherited unchanged.  The deltas are the game layer:

- shard k belongs to game ``k // shards_per_game`` (contiguous blocks,
  aligned with lanes.build_game_lanes' lane order), so per-game priority
  trees exist for free: they are the game's shard block;
- ``sample`` draws a GAME-INTERLEAVED batch: an `InterleaveSchedule`
  apportions the batch across alive games (uniform / loss / mass,
  config-selected), then each game's rows come from a proportional draw
  over ITS OWN shard block.  IS weights use each row's true sampling
  probability under the interleaved scheme (share_g * p_local/mass_g), so
  the estimator stays unbiased for whatever schedule is chosen;
- ``update_priorities`` additionally feeds the loss-proportional
  schedule's per-game |TD| EMA and the per-game learn-share counters the
  `games` obs row reports — zero extra device work, the write-back ring
  already hands it the host |TD| rows.

One game losing every shard (drop_shard) just zeroes its schedule share:
the apportionment renormalises over the survivors and the other games'
sampling is never interrupted (tests/test_multitask.py, chaos-marked).

Device sampling composes under ``multitask_schedule="mass"``: the
frontier's HBM draw is proportional to global priority mass, which IS the
mass schedule (the drivers fall back to this host path, with a notice,
for the per-game-quota schedules).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec
from rainbow_iqn_apex_tpu_torch.parallel.sharded_replay import ShardedReplay
from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay, SampledBatch
from rainbow_iqn_apex_tpu_torch.utils import hostsync

SCHEDULES = ("uniform", "loss", "mass")


def apportion(batch_size: int, shares: np.ndarray) -> np.ndarray:
    """Deterministic largest-remainder apportionment of ``batch_size`` rows
    over ``shares`` (ties break toward the lower game index) — the
    interleave must be reproducible under a fixed seed, so no RNG here."""
    shares = np.asarray(shares, np.float64)
    total = shares.sum()
    if total <= 0:
        raise ValueError("cannot apportion: no positive shares")
    raw = batch_size * shares / total
    base = np.floor(raw).astype(np.int64)
    rem = int(batch_size - base.sum())
    if rem > 0:
        order = np.argsort(-(raw - base), kind="stable")
        base[order[:rem]] += 1
    return base


class InterleaveSchedule:
    """Per-game batch shares for the interleaved sample.

    ``uniform``: equal rows per game with sampleable mass.
    ``loss``:    proportional to each game's EMA of retired mean |TD| —
                 games the learner currently struggles on get more replay
                 (the PER idea lifted one level up).
    ``mass``:    proportional to per-game priority mass — exactly the
                 distribution one global tree (or the device frontier's
                 HBM draw) would give.
    """

    def __init__(self, mode: str, num_games: int, ema: float = 0.95):
        # "fixed:w1,...,wG": explicit per-game shares — the league genome's
        # schedule-shares gene (league/population.py perturbs them;
        # docs/LEAGUE.md).  Dead games still renormalise over survivors.
        self.fixed: Optional[np.ndarray] = None
        if mode.startswith("fixed:"):
            try:
                shares = np.asarray(
                    [float(s) for s in mode.split(":", 1)[1].split(",")],
                    np.float64)
            except ValueError:
                raise ValueError(
                    f"multitask_schedule {mode!r}: shares must be numbers "
                    "(\"fixed:0.6,0.4\")")
            if len(shares) != num_games:
                raise ValueError(
                    f"multitask_schedule {mode!r} names {len(shares)} "
                    f"shares for {num_games} games — one share per game")
            if (not np.isfinite(shares).all() or (shares < 0).any()
                    or shares.sum() <= 0):
                raise ValueError(
                    f"multitask_schedule {mode!r}: shares must be "
                    "finite, >= 0 and sum > 0")
            self.fixed = shares / shares.sum()
        elif mode not in SCHEDULES:
            raise ValueError(
                f"unknown multitask_schedule {mode!r} (want {SCHEDULES} "
                "or \"fixed:w1,...,wG\")")
        self.mode = "fixed" if self.fixed is not None else mode
        self.num_games = int(num_games)
        self.ema = float(ema)
        # |TD| EMA starts flat at 1.0: until real TD lands, "loss" == uniform
        self.td_ema = np.ones(num_games, np.float64)

    def note_td(self, game_ids: np.ndarray, td_abs: np.ndarray) -> None:
        """Fold one retired step's per-row |TD| into the per-game EMA."""
        game_ids = np.asarray(game_ids, np.int64)
        td = np.abs(np.asarray(td_abs, np.float64))
        counts = np.bincount(game_ids, minlength=self.num_games)
        sums = np.bincount(game_ids, weights=td, minlength=self.num_games)
        seen = counts > 0
        means = np.where(seen, sums / np.maximum(counts, 1), 0.0)
        self.td_ema[seen] = (
            self.ema * self.td_ema[seen] + (1.0 - self.ema) * means[seen]
        )

    def shares(self, game_mass: np.ndarray) -> np.ndarray:
        """[G] shares summing to 1 over games with positive priority mass
        (a mass-less game — cold, or every shard dead — gets zero and the
        rest renormalise: per-game isolation)."""
        alive = np.asarray(game_mass, np.float64) > 0
        if not alive.any():
            raise ValueError("cannot sample: every game is empty or dead")
        if self.mode == "uniform":
            raw = alive.astype(np.float64)
        elif self.mode == "loss":
            raw = np.where(alive, np.maximum(self.td_ema, 1e-12), 0.0)
        elif self.mode == "fixed":
            raw = np.where(alive, self.fixed, 0.0)
            if raw.sum() <= 0:  # every positively-weighted game is dead
                raw = alive.astype(np.float64)
        else:  # mass
            raw = np.where(alive, game_mass, 0.0)
        return raw / raw.sum()


class MultiGameReplay(ShardedReplay):
    """K*G game-pinned PER shards behind the ShardedReplay interface."""

    def __init__(self, shards, spec: MultiGameSpec, shards_per_game: int,
                 schedule: str = "uniform"):
        if len(shards) != spec.num_games * shards_per_game:
            raise ValueError(
                f"{len(shards)} shards != {spec.num_games} games x "
                f"{shards_per_game} shards/game")
        super().__init__(shards)
        self.spec = spec
        self.shards_per_game = int(shards_per_game)
        self.schedule = InterleaveSchedule(schedule, spec.num_games)
        # per-game learn-share/telemetry counters (the `games` obs row)
        self.learn_rows_by_game = np.zeros(spec.num_games, np.int64)
        self.sampled_rows_by_game = np.zeros(spec.num_games, np.int64)

    # ------------------------------------------------------------------ build
    @classmethod
    def build_games(
        cls,
        spec: MultiGameSpec,
        shards_per_game: int,
        capacity_total: int,
        lanes_total: int,
        schedule: str = "uniform",
        **kwargs,
    ) -> "MultiGameReplay":
        num_shards = spec.num_games * max(int(shards_per_game), 1)
        if capacity_total % num_shards or lanes_total % num_shards:
            raise ValueError(
                f"capacity {capacity_total} and lanes {lanes_total} must "
                f"divide evenly into {num_shards} game-pinned shards")
        seed = kwargs.pop("seed", 0)
        kwargs.setdefault("frame_shape", spec.frame_shape)
        shards = [
            PrioritizedReplay(
                capacity_total // num_shards,
                lanes=lanes_total // num_shards,
                seed=seed + 1000 * k,
                **kwargs,
            )
            for k in range(num_shards)
        ]
        return cls(shards, spec, max(int(shards_per_game), 1),
                   schedule=schedule)

    # ------------------------------------------------------------------ maps
    def game_of_shard(self, k: int) -> int:
        return int(k) // self.shards_per_game

    def games_of(self, idx: np.ndarray) -> np.ndarray:
        """[B] int32 game id of each global slot id."""
        idx = np.asarray(idx, np.int64)
        return ((idx // self.shard_capacity)
                // self.shards_per_game).astype(np.int32)

    def game_sizes(self) -> np.ndarray:
        """[G] transitions held per game (alive shards only)."""
        out = np.zeros(self.spec.num_games, np.int64)
        for k, shard in enumerate(self.shards):
            if k not in self._dead:
                out[self.game_of_shard(k)] += len(shard)
        return out

    def game_occupancy(self) -> np.ndarray:
        """[G] per-game fill fraction over the game's ALIVE capacity
        (a game with every shard dead reads 0.0)."""
        sizes = self.game_sizes().astype(np.float64)
        caps = np.zeros(self.spec.num_games, np.float64)
        for k in range(len(self.shards)):
            if k not in self._dead:
                caps[self.game_of_shard(k)] += self.shard_capacity
        return np.where(caps > 0, sizes / np.maximum(caps, 1.0), 0.0)

    # ---------------------------------------------------------------- sample
    def sample(self, batch_size: int, beta: float) -> SampledBatch:
        """Game-interleaved proportional sample (see module docstring)."""
        hostsync.check_host_work("replay_sample")
        G, spg = self.spec.num_games, self.shards_per_game
        totals = np.asarray(
            [0.0 if k in self._dead else s.tree.total
             for k, s in enumerate(self.shards)],
            np.float64,
        )
        game_mass = totals.reshape(G, spg).sum(axis=1)
        shares = self.schedule.shares(game_mass)
        counts = apportion(batch_size, shares)
        n_global = len(self)
        parts: List[SampledBatch] = []
        probs: List[np.ndarray] = []
        games: List[np.ndarray] = []
        for g in range(G):
            c = int(counts[g])
            if c == 0:
                continue
            block = slice(g * spg, (g + 1) * spg)
            mass_g = game_mass[g]
            # within the game: the same multinomial shard split the
            # single-game ShardedReplay.sample performs over its shards
            split = self.rng.multinomial(c, totals[block] / mass_g)
            for j, ck in enumerate(split):
                if ck == 0:
                    continue
                k = g * spg + j
                b = self.shards[k].sample(int(ck), beta)
                parts.append(SampledBatch(
                    idx=b.idx + k * self.shard_capacity,
                    obs=b.obs, action=b.action, reward=b.reward,
                    next_obs=b.next_obs, discount=b.discount,
                    weight=b.weight, prob=b.prob,
                ))
                # true row probability under the interleaved scheme
                probs.append(b.prob * (totals[k] / mass_g) * shares[g])
                games.append(np.full(int(ck), g, np.int32))
            self.sampled_rows_by_game[g] += c
        if self._reg is not None:
            self._reg.counter("replay_sampled_rows", self._role).inc(
                batch_size)
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
            game=np.concatenate(games),
        )

    def assemble_global(self, idx, weight, prob=None) -> SampledBatch:
        """Device-sampling gather path: inherited assembly + game ids
        attached, so the frontier's batches condition the learner too."""
        batch = super().assemble_global(idx, weight, prob)
        batch.game = self.games_of(batch.idx)
        self.sampled_rows_by_game += np.bincount(
            batch.game, minlength=self.spec.num_games).astype(np.int64)
        return batch

    # ------------------------------------------------------------ priorities
    def note_learn_idx(self, idx: np.ndarray) -> None:
        """Per-game learn-row accounting from slot ids alone — the device-
        sampling path's hook: in mirror mode the ring retires |TD| as a
        DEVICE array straight into the frontier (update_priorities below is
        never on the hot path), but the idx vector is host NumPy either
        way, so the `games` row's learn share stays live.  The loss-EMA is
        deliberately NOT fed here (no host |TD| to fold — and the frontier
        only composes with the mass schedule, which ignores it)."""
        g = self.games_of(idx)
        if len(g):
            self.learn_rows_by_game += np.bincount(
                g, minlength=self.spec.num_games).astype(np.int64)

    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray) -> None:
        g = self.games_of(idx)
        if len(g):
            self.schedule.note_td(g, td_abs)
        self.note_learn_idx(idx)
        super().update_priorities(idx, td_abs)

    def learn_shares(self) -> np.ndarray:
        """[G] fraction of learned (priority-written) rows per game."""
        total = self.learn_rows_by_game.sum()
        if total == 0:
            return np.zeros(self.spec.num_games)
        return self.learn_rows_by_game / total

    def dead_games(self) -> List[int]:
        """Games whose EVERY shard is currently dead."""
        G, spg = self.spec.num_games, self.shards_per_game
        return [
            g for g in range(G)
            if all(g * spg + j in self._dead for j in range(spg))
        ]

    def game_shards(self, g: int) -> List[int]:
        """Shard indices of game ``g``'s block (drop/readmit targets)."""
        spg = self.shards_per_game
        return list(range(g * spg, (g + 1) * spg))
