"""Evaluation of the port (counterpart of ``rainbow_iqn_apex_tpu/eval.py``
``evaluate`` and ``evaluate_state``): run E episodes on a fresh env with
greedy acting (noise off unless ``cfg.eval_noisy``), report raw mean/median
scores plus normalised scores when baselines are known."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.agents.agent import Agent, FrameStacker
from rainbow_iqn_apex_tpu_torch.atari57 import ATARI57_BASELINES
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.envs import make_env

# Published per-game random/human baselines used for human-normalised scores
# (Rainbow paper appendix convention), keyed by env_id.  Toy entries are
# analytic; the Atari-57 rows come from the shared table in atari57.py (same
# RECON caveat as there — recall-sourced, re-verify before publication).
HUMAN_BASELINES: Dict[str, Dict[str, float]] = {
    # env_id: {"random": r, "human": h}
    "toy:catch": {"random": -0.8, "human": 1.0},  # analytic: random ~ 2/size - 1
    "toy:chain": {"random": 0.15, "human": 1.0},
}
HUMAN_BASELINES.update(
    {
        f"atari:{game}": {"random": random, "human": human}
        for game, (random, human) in ATARI57_BASELINES.items()
    }
)


def human_normalized(env_id: str, score: float) -> Optional[float]:
    base = HUMAN_BASELINES.get(env_id)
    if not base or base["human"] == base["random"]:
        return None
    return (score - base["random"]) / (base["human"] - base["random"])


def evaluate(
    cfg: Config,
    agent: Agent,
    episodes: Optional[int] = None,
    seed: int = 0,
    max_steps_per_episode: int = 200_000,
) -> Dict[str, Any]:
    """Run E eval episodes on a fresh env; returns score stats."""
    episodes = episodes or cfg.eval_episodes
    env = make_env(cfg.env_id, seed=seed, device=agent.device)
    scores = []
    for ep in range(episodes):
        stacker = FrameStacker(1, env.frame_shape, cfg.history_length)
        frame = env.reset()
        ep_ret = 0.0
        for _ in range(max_steps_per_episode):
            stacked = stacker.push(frame[None])
            action = int(agent.act(stacked, eval_mode=True)[0])
            ts = env.step(action)
            frame = ts.obs
            ep_ret += ts.reward
            if ts.terminal or ts.truncated:
                if ts.info and "episode_return" in ts.info:
                    ep_ret = float(ts.info["episode_return"])  # raw, unclipped
                break
        scores.append(ep_ret)
    arr = np.asarray(scores, np.float64)
    out: Dict[str, Any] = {
        "episodes": episodes,
        "score_mean": float(arr.mean()),
        "score_median": float(np.median(arr)),
        "score_min": float(arr.min()),
        "score_max": float(arr.max()),
    }
    hn = human_normalized(cfg.env_id, out["score_mean"])
    if hn is not None:
        out["human_normalized"] = hn
    return out


@functools.lru_cache(maxsize=4)
def _cached_eval_agent(cfg: Config, num_actions: int, frame_shape: Tuple[int, int],
                       device: torch.device) -> Agent:
    """One eval Agent per (cfg, env, device), reused across eval intervals."""
    return Agent(cfg, num_actions, cfg.seed + 1, train=False,
                 state_shape=(*frame_shape, cfg.history_length), device=device)


def evaluate_state(cfg: Config, env, state, seed: int = 0) -> Dict[str, Any]:
    """Evaluate a learner's current ``TrainState`` (its online network) on a
    cached eval Agent on the same device.  The Agent's generator is reseeded
    on every call, so two evals of the same params draw the same taus and
    noise."""
    device = next(state.net.parameters()).device
    agent = _cached_eval_agent(cfg, env.num_actions, tuple(env.frame_shape), device)
    with torch.no_grad():
        agent.state.net.load_state_dict(state.net.state_dict())
    agent.generator.manual_seed(cfg.seed + 1)
    return evaluate(cfg, agent, seed=seed)
