"""Multi-game evaluation: every game of the suite, then the suite aggregate.

Counterpart of ``rainbow_iqn_apex_tpu/multitask/eval.py``.  Per game: E
greedy episodes (noise off unless ``cfg.eval_noisy``) on the game's own env
behind the suite-common padded surface, the loop of ``eval.evaluate``.
Suite: human-normalized median and mean over the games with a known
baseline (the Atari-57 reporting convention).

The eval network is cached per (cfg, spec, noisy, device) and takes the
learner's parameters at each call; its generator is seeded ``cfg.seed + 1``
anew at each call, so two evaluations of the same parameters draw the same
taus and noise.  One network serves the whole suite (the game id is data).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.agents.agent import FrameStacker, put_frames
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.eval import human_normalized
from rainbow_iqn_apex_tpu_torch.multitask.lanes import GameLaneEnv
from rainbow_iqn_apex_tpu_torch.multitask.obs import aggregate_human_normalized
from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec
from rainbow_iqn_apex_tpu_torch.utils import hostsync

__all__ = ["aggregate_human_normalized", "evaluate_multigame"]


@functools.lru_cache(maxsize=4)
def _cached_mt_eval(cfg: Config, spec: MultiGameSpec, noisy: bool, device: torch.device):
    from rainbow_iqn_apex_tpu_torch.multitask.ops import build_mt_act_step, make_mt_network

    net = make_mt_network(cfg, spec, use_noise=noisy).to(device).requires_grad_(False).eval()
    return net, build_mt_act_step(cfg, spec, use_noise=noisy)


def evaluate_multigame(
    cfg: Config,
    spec: MultiGameSpec,
    state,
    seed: int = 0,
    episodes: Optional[int] = None,
    max_steps_per_episode: int = 200_000,
) -> Dict[str, Any]:
    """Evaluate the learner's ``TrainState`` (its online network) on every
    game in the spec, on the network's device.

    Returns {"games": {env_id: {episodes, score_mean, score_median,
    score_min, score_max, human_normalized?}}, hn_median, hn_mean,
    hn_games, score_mean (suite mean of per-game means)}.
    """
    from rainbow_iqn_apex_tpu_torch.envs import make_env

    episodes = episodes or cfg.eval_episodes
    device = next(state.net.parameters()).device
    net, act = _cached_mt_eval(cfg, spec, bool(cfg.eval_noisy), device)
    with torch.no_grad():
        net.load_state_dict(state.net.state_dict())
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    per_game: Dict[str, Dict[str, Any]] = {}
    per_game_hn: Dict[str, Optional[float]] = {}
    for g, name in enumerate(spec.games):
        env = GameLaneEnv(make_env(name, seed=seed + g, device=device), spec, g)
        game_ids = put_frames(np.full(1, g, np.int32), device)
        scores = []
        for _ep in range(episodes):
            stacker = FrameStacker(1, env.frame_shape, cfg.history_length)
            frame = env.reset()
            ep_ret = 0.0
            for _ in range(max_steps_per_episode):
                stacked = stacker.push(frame[None])
                a, _q = act(net, put_frames(stacked, device), game_ids, generator)
                ts = env.step(int(hostsync.to_host(a)[0]))
                frame = ts.obs
                ep_ret += ts.reward
                if ts.terminal or ts.truncated:
                    if ts.info and "episode_return" in ts.info:
                        ep_ret = float(ts.info["episode_return"])
                    break
            scores.append(ep_ret)
        env.close()
        arr = np.asarray(scores, np.float64)
        row: Dict[str, Any] = {
            "episodes": episodes,
            "score_mean": float(arr.mean()),
            "score_median": float(np.median(arr)),
            "score_min": float(arr.min()),
            "score_max": float(arr.max()),
        }
        hn = human_normalized(name, row["score_mean"])
        per_game_hn[name] = hn
        if hn is not None:
            row["human_normalized"] = hn
        per_game[name] = row
    return {
        "games": per_game,
        "score_mean": float(np.mean([r["score_mean"] for r in per_game.values()])),
        **aggregate_human_normalized(per_game_hn),
    }
