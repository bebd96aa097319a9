"""multitask/ — multi-game Ape-X on one card, the port of
``rainbow_iqn_apex_tpu/multitask/``:

  spec.py    MultiGameSpec: the parsed ``Config.games`` contract (a copy)
  lanes.py   per-game actor lanes behind the suite-common surface (a copy)
  model.py   MultiGameIQN: RainbowIQN with a zero-initialised game
             embedding (K2g) and per-game action masks (K4m, K4l)
  ops.py     task-conditioned act and learn steps
  replay.py  MultiGameReplay: game-pinned shard blocks behind the
             interleave schedule (a copy)
  eval.py    multi-game evaluation with human-normalized aggregates
  obs.py     the periodic ``games`` row (a copy)

Everything is importable from here lazily (PEP 562).
"""

from __future__ import annotations

import importlib

_LAZY = {
    "MultiGameSpec": "rainbow_iqn_apex_tpu_torch.multitask.spec",
    "parse_games": "rainbow_iqn_apex_tpu_torch.multitask.spec",
    "GameLaneEnv": "rainbow_iqn_apex_tpu_torch.multitask.lanes",
    "build_game_lanes": "rainbow_iqn_apex_tpu_torch.multitask.lanes",
    "MultiGameIQN": "rainbow_iqn_apex_tpu_torch.multitask.model",
    "build_mt_act_step": "rainbow_iqn_apex_tpu_torch.multitask.ops",
    "build_mt_learn_step": "rainbow_iqn_apex_tpu_torch.multitask.ops",
    "init_mt_train_state": "rainbow_iqn_apex_tpu_torch.multitask.ops",
    "InterleaveSchedule": "rainbow_iqn_apex_tpu_torch.multitask.replay",
    "MultiGameReplay": "rainbow_iqn_apex_tpu_torch.multitask.replay",
    "aggregate_human_normalized": "rainbow_iqn_apex_tpu_torch.multitask.obs",
    "evaluate_multigame": "rainbow_iqn_apex_tpu_torch.multitask.eval",
    "GamesObs": "rainbow_iqn_apex_tpu_torch.multitask.obs",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
