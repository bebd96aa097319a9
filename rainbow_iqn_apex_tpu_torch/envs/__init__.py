"""Environments of the port: copies of the JAX package's host envs
(``envs/base.py``, ``envs/toy.py``, ``envs/atari.py``).  The port makes
``toy:`` and ``atari:`` envs; the other kinds of the JAX package are not
ported and raise."""

from rainbow_iqn_apex_tpu_torch.envs.atari import ALEAdapter, AtariEnv, make_atari_env
from rainbow_iqn_apex_tpu_torch.envs.base import Env, TimeStep, VectorEnv
from rainbow_iqn_apex_tpu_torch.envs.toy import CatchEnv, ChainEnv, make_toy_env


def make_env(env_id: str, seed: int = 0, **kwargs) -> Env:
    """Env factory keyed by the config's env_id: "toy:catch" | "atari:Pong"."""
    kind, _, name = env_id.partition(":")
    if kind == "toy":
        return make_toy_env(name, seed=seed)
    if kind == "atari":
        return make_atari_env(name, seed=seed, **kwargs)
    if kind in ("jaxgame", "gym", "procgen"):
        raise NotImplementedError(
            f"'{kind}:' envs are not ported to the PyTorch package yet "
            "(ROADMAP.md queue A); use 'toy:' or 'atari:'")
    raise ValueError(f"unknown env id '{env_id}' (want 'toy:' or 'atari:')")


def make_vector_env(env_id: str, num_envs: int, seed: int = 0, **kwargs) -> VectorEnv:
    def factory(lane: int) -> Env:
        return make_env(env_id, seed=seed + lane, **kwargs)

    return VectorEnv([factory(i) for i in range(num_envs)], env_factory=factory)


__all__ = [
    "Env",
    "TimeStep",
    "VectorEnv",
    "CatchEnv",
    "ChainEnv",
    "AtariEnv",
    "ALEAdapter",
    "make_env",
    "make_toy_env",
    "make_atari_env",
    "make_vector_env",
]
