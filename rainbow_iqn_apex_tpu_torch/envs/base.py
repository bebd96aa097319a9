"""Environment interface.

Parity: reference `rainbowiqn/env.py` exposes reset/step/action_space
(SURVEY.md §1 row "Environment").  We keep that minimal surface but define it
as an explicit ABC with a TimeStep record, plus a batched VectorEnv — the
TPU-native actor shape is a *batch* of environments stepped in lockstep so
device inference sees one [L, H, W, C] tensor per tick (SURVEY.md §2 native-dep
table: "batched, vectorized host env layer feeding pmapped actor inference").
"""

from __future__ import annotations

import abc
import dataclasses
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TimeStep:
    obs: np.ndarray  # [H, W] uint8 preprocessed frame (pre-stack)
    reward: float
    terminal: bool  # episode over (game over under SABER rules)
    truncated: bool = False  # time-limit cut (108k-frame cap), not a true terminal
    info: Optional[dict] = None


class Env(abc.ABC):
    """Single environment: produces preprocessed uint8 frames."""

    @property
    @abc.abstractmethod
    def num_actions(self) -> int: ...

    @property
    @abc.abstractmethod
    def frame_shape(self) -> Tuple[int, int]: ...

    @abc.abstractmethod
    def reset(self) -> np.ndarray:
        """Start an episode; returns the first preprocessed frame."""

    @abc.abstractmethod
    def step(self, action: int) -> TimeStep: ...

    def close(self) -> None:  # optional
        pass


class VectorEnv:
    """Steps L independent Env instances in lockstep with auto-reset.

    On terminal/truncation the lane resets immediately and the returned obs is
    the first frame of the new episode (the terminal flag tells the replay to
    cut the stack/n-step window there — matching the reference's per-process
    reset-then-continue actor loop, SURVEY §3.2).

    Failure tolerance: the reference's story is "actors only produce data; if
    one dies, restart it by hand" (SURVEY §5 / Ape-X paper).  Here a lane
    whose env raises is rebuilt automatically from ``env_factory`` (when
    given) and reported as a terminal step with zero reward, so the replay
    cleanly cuts the episode — the in-process equivalent of an actor restart.
    """

    def __init__(self, envs: Sequence[Env], env_factory=None, max_lane_restarts: int = 20):
        if not envs:
            raise ValueError("need at least one env")
        self.envs: List[Env] = list(envs)
        self.env_factory = env_factory  # lane index -> new Env
        self.max_lane_restarts = max_lane_restarts
        self.lane_restarts = 0
        self._restarts_per_lane = [0] * len(envs)
        n0, f0 = envs[0].num_actions, envs[0].frame_shape
        if any(e.num_actions != n0 or e.frame_shape != f0 for e in envs):
            raise ValueError("all lanes must share action/frame spaces")

    def __len__(self) -> int:
        return len(self.envs)

    @property
    def num_actions(self) -> int:
        return self.envs[0].num_actions

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self.envs[0].frame_shape

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def step(
        self, actions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (obs [L,H,W] u8, reward [L] f32, terminal [L] bool,
        truncated [L] bool, episode_return [L] f32 — NaN except on the tick
        an episode ended).

        Both terminal and truncation auto-reset the lane and MUST cut the
        replay's stack/n-step/sequence windows; only `terminal` stops value
        bootstrapping.  Both replays honour this two-channel contract: the
        frame replay stores cuts separately from terminals
        (replay/buffer.py) and the sequence replay flushes on either channel
        while recording done only for true terminals (replay/sequence.py).
        """
        L = len(self.envs)
        obs = np.empty((L, *self.frame_shape), np.uint8)
        rew = np.empty(L, np.float32)
        term = np.empty(L, bool)
        trunc = np.zeros(L, bool)
        ep_ret = np.full(L, np.nan, np.float32)
        for i, env in enumerate(self.envs):
            try:
                ts = env.step(int(actions[i]))
            except Exception as e:
                if self.env_factory is None:
                    raise
                if self._restarts_per_lane[i] >= self.max_lane_restarts:
                    raise RuntimeError(
                        f"env lane {i} exceeded {self.max_lane_restarts} "
                        "restarts — persistently broken, not transient"
                    ) from e
                self._restarts_per_lane[i] += 1
                self.lane_restarts += 1
                print(
                    f"[vector-env] lane {i} crashed ({type(e).__name__}: {e}); "
                    f"restarting (restart #{self._restarts_per_lane[i]})",
                    file=sys.stderr,
                )
                try:
                    env.close()
                except Exception:
                    pass
                self.envs[i] = self.env_factory(i)
                obs[i] = self.envs[i].reset()
                rew[i] = 0.0
                term[i] = False
                trunc[i] = True  # cut the episode cleanly, don't poison values
                continue
            rew[i] = ts.reward
            term[i] = ts.terminal
            trunc[i] = ts.truncated and not ts.terminal
            if ts.terminal or ts.truncated:
                if ts.info and "episode_return" in ts.info:
                    ep_ret[i] = ts.info["episode_return"]
                obs[i] = env.reset()
            else:
                obs[i] = ts.obs
        return obs, rew, term, trunc, ep_ret
