"""Deterministic toy environments for CI and learning-integration tests.

Where no ALE/ROMs are installed (SURVEY.md §7 build constraints), these envs
play the role Pong plays for the reference (SURVEY.md §4: "Pong as the smoke
test"): small, fully observable pixel games a correct Rainbow-IQN agent must
solve quickly.  They emit the same uint8 frame surface as the Atari path so
the entire agent/replay/learner stack is exercised unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.envs.base import Env, TimeStep


class CatchEnv(Env):
    """Catch: a ball falls from the top; move the paddle to catch it.

    Actions: 0=stay, 1=left, 2=right.  Reward +1 on catch, -1 on miss, 0
    otherwise; episode ends when the ball reaches the bottom row.  Rendered
    as an (size*cell) x (size*cell) uint8 frame.
    """

    NUM_ACTIONS = 3

    def __init__(self, size: int = 10, cell: int = 8, seed: int = 0):
        self.size = size
        self.cell = cell
        self.rng = np.random.default_rng(seed)
        self.ball_row = 0
        self.ball_col = 0
        self.paddle = size // 2
        self._ret = 0.0

    @property
    def num_actions(self) -> int:
        return self.NUM_ACTIONS

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return (self.size * self.cell, self.size * self.cell)

    def _render(self) -> np.ndarray:
        grid = np.zeros((self.size, self.size), np.uint8)
        grid[self.ball_row, self.ball_col] = 255
        grid[self.size - 1, self.paddle] = 128
        return np.kron(grid, np.ones((self.cell, self.cell), np.uint8))

    def reset(self) -> np.ndarray:
        self.ball_row = 0
        self.ball_col = int(self.rng.integers(0, self.size))
        self.paddle = self.size // 2
        self._ret = 0.0
        return self._render()

    def step(self, action: int) -> TimeStep:
        self.paddle = int(np.clip(self.paddle + (0, -1, 1)[action], 0, self.size - 1))
        self.ball_row += 1
        terminal = self.ball_row == self.size - 1
        reward = 0.0
        if terminal:
            reward = 1.0 if self.paddle == self.ball_col else -1.0
        self._ret += reward
        info = {"episode_return": self._ret} if terminal else None
        return TimeStep(self._render(), reward, terminal, False, info)


class ChainEnv(Env):
    """n-state chain: start at the left; RIGHT n-1 times earns the big
    reward, LEFT ends with a small one.  Exercises n-step credit assignment
    and exploration (greedy-myopic agents take the small exit)."""

    NUM_ACTIONS = 2  # 0=left, 1=right

    def __init__(self, length: int = 8, frame: int = 40, seed: int = 0):
        self.length = length
        self.frame = frame
        self.pos = 0
        self._ret = 0.0

    @property
    def num_actions(self) -> int:
        return self.NUM_ACTIONS

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return (self.frame, self.frame)

    def _render(self) -> np.ndarray:
        img = np.zeros((self.frame, self.frame), np.uint8)
        w = self.frame // self.length
        img[:, self.pos * w : (self.pos + 1) * w] = 255
        return img

    def reset(self) -> np.ndarray:
        self.pos = 0
        self._ret = 0.0
        return self._render()

    def step(self, action: int) -> TimeStep:
        if action == 0:
            reward, terminal = 0.1, True
        else:
            self.pos += 1
            terminal = self.pos == self.length - 1
            reward = 1.0 if terminal else 0.0
        self._ret += reward
        info = {"episode_return": self._ret} if terminal else None
        return TimeStep(self._render(), reward, terminal, False, info)


def make_toy_env(name: str, seed: int = 0) -> Env:
    if name == "catch":
        return CatchEnv(seed=seed)
    if name == "chain":
        return ChainEnv(seed=seed)
    raise ValueError(f"unknown toy env '{name}' (have: catch, chain)")
