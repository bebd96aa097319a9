"""Atari environment with DeepMind/SABER preprocessing.

Parity: reference `rainbowiqn/env.py` (SURVEY.md §2 row 2) — ALE lifecycle +
grayscale, 84x84 resize, action-repeat 4 with max over the last 2 raw frames,
reward clip to [-1, 1], and the SABER protocol options (arXiv:1908.04683):
sticky actions p=0.25, the full 18-action set, termination on game over (not
life loss), and the 30-minute (108k raw frame) episode cap.

Design: all preprocessing operates on a small ``RawAtari`` duck-type rather
than on ale_py directly, so that a machine without ALE/ROMs still runs
every Atari-specific assumption behind the env seam (SURVEY.md §7).
`ALEAdapter` binds the real ale_py when present; tests inject a fake.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import numpy as np

from rainbow_iqn_apex_tpu_torch.envs.base import Env, TimeStep

try:  # optional: image resize via OpenCV, with a NumPy fallback
    import cv2  # type: ignore

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


class RawAtari(Protocol):
    """The minimal ALE surface the preprocessing needs."""

    num_actions: int

    def reset(self) -> None: ...
    def act(self, action: int) -> float: ...  # raw (unclipped) reward
    def screen(self) -> np.ndarray: ...  # grayscale [H_raw, W_raw] uint8
    def game_over(self) -> bool: ...
    def lives(self) -> int: ...


def _resize(frame: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    if _HAVE_CV2:
        return cv2.resize(frame, (hw[1], hw[0]), interpolation=cv2.INTER_AREA).astype(
            np.uint8
        )
    # NumPy area-mean fallback (exact when shapes divide evenly), fully
    # vectorised via two cumulative-sum passes — the previous per-pixel
    # Python double loop cost ~ms/frame, a silent preprocessing tax on the
    # actor hot path of any ALE box without cv2 (VERDICT r4).  Bin [i, j]
    # averages frame[ys[i]:ye[i], xs[j]:xe[j]] (ends forced >= 1 wide), and
    # the float->uint8 cast truncates, matching the old loop bit-for-bit.
    h, w = frame.shape
    th, tw = hw
    ys = (np.arange(th + 1) * h // th).astype(int)
    xs = (np.arange(tw + 1) * w // tw).astype(int)
    ye = np.maximum(ys[1:], ys[:-1] + 1)
    xe = np.maximum(xs[1:], xs[:-1] + 1)
    c = np.zeros((h + 1, w), np.float64)
    np.cumsum(frame, axis=0, out=c[1:])
    rowsum = c[ye] - c[ys[:-1]]  # [th, w] — per-bin row sums
    c2 = np.zeros((th, w + 1), np.float64)
    np.cumsum(rowsum, axis=1, out=c2[:, 1:])
    s = c2[:, xe] - c2[:, xs[:-1]]  # [th, tw] — per-bin area sums
    area = (ye - ys[:-1])[:, None] * (xe - xs[:-1])[None, :]
    return (s / area).astype(np.uint8)


class AtariEnv(Env):
    """SABER/DeepMind-preprocessed Atari over any RawAtari backend."""

    def __init__(
        self,
        raw: RawAtari,
        frame_shape: Tuple[int, int] = (84, 84),
        action_repeat: int = 4,
        sticky_actions: float = 0.25,
        reward_clip: float = 1.0,
        terminal_on_life_loss: bool = False,
        max_episode_frames: int = 108_000,
        seed: int = 0,
    ):
        self.raw = raw
        self._frame_shape = frame_shape
        self.action_repeat = action_repeat
        self.sticky = sticky_actions
        self.reward_clip = reward_clip
        self.life_loss = terminal_on_life_loss
        self.max_frames = max_episode_frames
        self.rng = np.random.default_rng(seed)
        self._prev_action = 0
        self._raw_frames = 0
        self._lives = 0
        self._ret = 0.0  # raw (unclipped) episode return, for eval parity

    @property
    def num_actions(self) -> int:
        return self.raw.num_actions

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self._frame_shape

    def reset(self) -> np.ndarray:
        self.raw.reset()
        self._prev_action = 0
        self._raw_frames = 0
        self._ret = 0.0
        self._lives = self.raw.lives()
        return _resize(self.raw.screen(), self._frame_shape)

    def step(self, action: int) -> TimeStep:
        # SABER sticky actions: with prob p the PREVIOUS action repeats.
        if self.sticky > 0 and self.rng.random() < self.sticky:
            action = self._prev_action
        self._prev_action = action

        reward = 0.0
        screens = []  # last two raw screens for flicker max-pooling
        terminal = False
        for _ in range(self.action_repeat):
            reward += float(self.raw.act(action))
            self._raw_frames += 1
            screens.append(self.raw.screen())
            if self.raw.game_over():
                terminal = True
                break
            if self.life_loss and self.raw.lives() < self._lives:
                self._lives = self.raw.lives()
                terminal = True
                break
        self._lives = self.raw.lives()

        pooled = np.maximum(screens[-1], screens[-2]) if len(screens) >= 2 else screens[-1]
        frame = _resize(pooled, self._frame_shape)

        self._ret += reward
        truncated = (not terminal) and self._raw_frames >= self.max_frames
        if self.reward_clip > 0:
            reward = float(np.clip(reward, -self.reward_clip, self.reward_clip))
        info = (
            {"episode_return": self._ret, "raw_frames": self._raw_frames}
            if (terminal or truncated)
            else None
        )
        return TimeStep(frame, reward, terminal, truncated, info)


class ALEAdapter:
    """Binds ale_py (when installed) to the RawAtari protocol.

    SABER uses the full 18-action legal set (reference behaviour); pass
    ``full_action_set=False`` for the minimal set.
    """

    def __init__(self, game: str, seed: int = 0, full_action_set: bool = True):
        try:
            import ale_py  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "ale_py is not installed in this environment. Atari runs need "
                "ale-py + ROMs; use toy:* envs here, or install ale-py where "
                "available. The preprocessing stack itself is fully testable "
                "via the RawAtari seam."
            ) from e
        self._ale = ale_py.ALEInterface()
        self._ale.setInt("random_seed", seed)
        # repeat_action_probability=0 here: stickiness is implemented (and
        # unit-tested) in AtariEnv so the policy is backend-independent.
        self._ale.setFloat("repeat_action_probability", 0.0)
        self._ale.loadROM(ale_py.roms.get_rom_path(game))
        self._actions = (
            self._ale.getLegalActionSet()
            if full_action_set
            else self._ale.getMinimalActionSet()
        )
        self.num_actions = len(self._actions)

    def reset(self) -> None:
        self._ale.reset_game()

    def act(self, action: int) -> float:
        return self._ale.act(self._actions[action])

    def screen(self) -> np.ndarray:
        return self._ale.getScreenGrayscale().squeeze()

    def game_over(self) -> bool:
        return self._ale.game_over()

    def lives(self) -> int:
        return self._ale.lives()


def make_atari_env(game: str, seed: int = 0, **kwargs) -> AtariEnv:
    full = kwargs.pop("full_action_set", True)
    return AtariEnv(ALEAdapter(game, seed=seed, full_action_set=full), seed=seed, **kwargs)
