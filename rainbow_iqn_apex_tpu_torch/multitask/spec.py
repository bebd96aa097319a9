"""MultiGameSpec: the parsed `Config.games` contract.

A copy of ``rainbow_iqn_apex_tpu/multitask/spec.py``; ``probe`` takes the
``device`` its ``jaxgame:`` envs are made on (``cuda:0`` unless named).

One frozen, hashable value object that every multitask layer keys on —
the driver builds its networks from it, the replay derives its
game-pinned shard map from it, eval walks its game list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def parse_games(games: str) -> Tuple[str, ...]:
    """"a,b,c" -> ("a", "b", "c"); order-preserving, duplicates rejected
    (a duplicated game would double its lane/shard share silently)."""
    names = tuple(g.strip() for g in str(games).split(",") if g.strip())
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate game in games={games!r}")
    return names


@dataclasses.dataclass(frozen=True)
class MultiGameSpec:
    """The static multi-game contract derived from Config.games.

    ``frame_shape`` is the padded COMMON (H, W) every lane/eval env emits
    (max over the suite, zero-padded bottom/right) so one network
    serves every game; ``num_actions`` is per game, ``max_actions`` the
    padded action-space width the network emits — per-game action masks
    (ops.action_mask_table) keep greedy selection inside each game's real
    action set."""

    games: Tuple[str, ...]
    num_actions: Tuple[int, ...]
    frame_shape: Tuple[int, int]

    def __post_init__(self):
        if len(self.games) < 1:
            raise ValueError("MultiGameSpec needs at least one game")
        if len(self.num_actions) != len(self.games):
            raise ValueError("num_actions must align with games")

    @property
    def num_games(self) -> int:
        return len(self.games)

    @property
    def max_actions(self) -> int:
        return max(self.num_actions)

    def game_index(self, name: str) -> int:
        return self.games.index(name)

    @classmethod
    def from_config(cls, cfg, device=None) -> Optional["MultiGameSpec"]:
        """None when cfg.games is unset (the single-game seed path);
        otherwise probe each game once for its action/frame spaces."""
        names = parse_games(getattr(cfg, "games", ""))
        if not names:
            return None
        return cls.probe(names, device=device)

    @classmethod
    def probe(cls, names: Tuple[str, ...], device=None) -> "MultiGameSpec":
        from rainbow_iqn_apex_tpu_torch.envs import make_env

        actions, heights, widths = [], [], []
        for name in names:
            env = make_env(name, seed=0, device=device)
            actions.append(int(env.num_actions))
            h, w = env.frame_shape
            heights.append(int(h))
            widths.append(int(w))
            env.close()
        return cls(
            games=tuple(names),
            num_actions=tuple(actions),
            frame_shape=(max(heights), max(widths)),
        )
