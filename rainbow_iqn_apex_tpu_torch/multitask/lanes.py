"""Per-game actor lanes: pin contiguous vector-env lane blocks to games.

A copy of ``rainbow_iqn_apex_tpu/multitask/lanes.py``; ``build_game_lanes``
takes the ``device`` its ``jaxgame:`` lanes run on (``cuda:0`` unless named).

The lane order is the load-bearing contract: game g owns lanes
[g*lanes_per_game, (g+1)*lanes_per_game), which is exactly the block
`MultiGameReplay` pins to game g's replay shards (ShardedReplay's
contiguous lane->shard split), so appends land on the right game's
priority trees with zero per-tick routing work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.envs.base import Env, TimeStep, VectorEnv
from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec


class GameLaneEnv(Env):
    """One game lane behind the suite-common surface.

    Frames are zero-padded bottom/right to the spec's common (H, W) — the
    game's own pixels keep their coordinates, the pad is static black the
    conv trunk learns to ignore.  The declared action space is the padded
    ``spec.max_actions``; in-graph action masks make the policy pick
    in-range actions, and an out-of-range id (possible for a generalist
    net without masks, e.g. the r2d2 multi-game path) is mapped ``a %
    num_actions`` instead of crashing the lane."""

    def __init__(self, env: Env, spec: MultiGameSpec, game_id: int):
        self.env = env
        self.spec = spec
        self.game_id = int(game_id)
        self.game = spec.games[self.game_id]
        self._real_actions = spec.num_actions[self.game_id]
        h, w = env.frame_shape
        H, W = spec.frame_shape
        if h > H or w > W:
            raise ValueError(
                f"game {self.game} frame {h}x{w} exceeds the common "
                f"{H}x{W} — spec.frame_shape must be the suite max"
            )
        self._pad = ((0, H - h), (0, W - w))
        self._needs_pad = (h, w) != (H, W)

    @property
    def num_actions(self) -> int:
        return self.spec.max_actions

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self.spec.frame_shape

    def _pad_frame(self, frame: np.ndarray) -> np.ndarray:
        if not self._needs_pad:
            return frame
        return np.pad(frame, self._pad)

    def reset(self) -> np.ndarray:
        return self._pad_frame(self.env.reset())

    def step(self, action: int) -> TimeStep:
        ts = self.env.step(int(action) % self._real_actions)
        return TimeStep(
            self._pad_frame(ts.obs), ts.reward, ts.terminal,
            ts.truncated, ts.info,
        )

    def close(self) -> None:
        self.env.close()


def lane_games(spec: MultiGameSpec, lanes_per_game: int) -> np.ndarray:
    """[L] int32 game id per lane, game-major blocks (the lane contract)."""
    return np.repeat(
        np.arange(spec.num_games, dtype=np.int32), lanes_per_game
    )


def build_game_lanes(
    spec: MultiGameSpec, lanes_per_game: int, seed: int = 0, device=None
) -> VectorEnv:
    """VectorEnv with ``lanes_per_game`` lanes pinned to each game in spec
    order.  Per-lane seeds stay carved from the global lane index, exactly
    like the single-game `make_vector_env`, so a lane crash rebuilds the
    same stream."""
    from rainbow_iqn_apex_tpu_torch.envs import make_env

    if lanes_per_game < 1:
        raise ValueError("need at least one lane per game")
    games_of_lane = lane_games(spec, lanes_per_game)

    def factory(lane: int) -> Env:
        g = int(games_of_lane[lane])
        return GameLaneEnv(
            make_env(spec.games[g], seed=seed + lane, device=device), spec, g
        )

    lanes = [factory(i) for i in range(spec.num_games * lanes_per_game)]
    return VectorEnv(lanes, env_factory=factory)
