"""Environments of the port: copies of the JAX package's host envs
(``envs/base.py``, ``envs/toy.py``, ``envs/atari.py``) and the port of its
device games (``envs/device_games.py``, on JAX's Threefry stream in
``envs/prng.py``).  The port makes ``toy:``, ``atari:`` and ``jaxgame:``
envs (a ``jaxgame:`` lane runs on ``device``, ``cuda:0`` unless named);
``gym:`` and ``procgen:`` are not ported and raise."""

from rainbow_iqn_apex_tpu_torch.envs.atari import ALEAdapter, AtariEnv, make_atari_env
from rainbow_iqn_apex_tpu_torch.envs.base import Env, TimeStep, VectorEnv
from rainbow_iqn_apex_tpu_torch.envs.device_games import JaxGameEnv
from rainbow_iqn_apex_tpu_torch.envs.toy import CatchEnv, ChainEnv, make_toy_env


def make_env(env_id: str, seed: int = 0, device=None, **kwargs) -> Env:
    """Env factory keyed by the config's env_id: "toy:catch" | "atari:Pong" |
    "jaxgame:breakout" (``device`` is where a ``jaxgame:`` lane runs)."""
    kind, _, name = env_id.partition(":")
    if kind == "toy":
        return make_toy_env(name, seed=seed)
    if kind == "atari":
        return make_atari_env(name, seed=seed, **kwargs)
    if kind == "jaxgame":
        return JaxGameEnv(name, seed=seed, device=device)
    if kind in ("gym", "procgen"):
        raise NotImplementedError(
            f"'{kind}:' envs are not ported to the PyTorch package yet "
            "(ROADMAP.md queue A); use 'toy:', 'atari:' or 'jaxgame:'")
    raise ValueError(f"unknown env id '{env_id}' (want 'toy:', 'atari:' or 'jaxgame:')")


def make_vector_env(env_id: str, num_envs: int, seed: int = 0, device=None,
                    **kwargs) -> VectorEnv:
    def factory(lane: int) -> Env:
        return make_env(env_id, seed=seed + lane, device=device, **kwargs)

    return VectorEnv([factory(i) for i in range(num_envs)], env_factory=factory)


__all__ = [
    "Env",
    "TimeStep",
    "VectorEnv",
    "CatchEnv",
    "JaxGameEnv",
    "ChainEnv",
    "AtariEnv",
    "ALEAdapter",
    "make_env",
    "make_toy_env",
    "make_atari_env",
    "make_vector_env",
]
