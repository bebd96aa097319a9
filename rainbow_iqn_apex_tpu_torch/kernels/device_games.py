"""K12: the device games' tick, with JAX's Threefry key stream.

Replaces ``batched_reset_step`` (``rainbow_iqn_apex_tpu/envs/device_games.py:974-1011``)
over each game's ``init`` / ``step`` / ``render`` (:105-520, the seeded-level
variants :547-825): for L lanes in one launch, the per-lane keys
(``split(key, L)``, then ``split(k)`` into step and reset keys), the game's
step, reward, terminal and truncation (cleared where a terminal falls), the
episode return (accumulated, emitted on a cut, zeroed), a fresh ``init`` on
a cut and the 80x80 uint8 render of the new state.  The same kernel also
initialises lanes (``batched_init`` and the host adapter's reset), renders
a state, and takes one step with a given key and no reset (the host
adapter).  Every result is bit-equal to the plain twins below and to JAX.

The state is a game's ``NamedTuple`` of [L, ...] tensors (int32, bool,
Asterix@var's ``gold_p`` float32), updated in place; the key lives on the
host (an int64 [2] tensor or pair) and goes to the kernel by value.

Bound on the H100: the frames written once, L x 6,400 B, plus the state:
launch-bound at training widths.  The kernel (``csrc/device_games.cu``) is
a warp per lane, four lanes a block: the state in the warp's registers, the
step's and the reset's Threefry hashes spread over its threads depth by
depth, grid-wide logic by ballots, the frame in 16-byte stores.

Each function runs the kernel for CUDA states and the plain twin
(``*_plain``) for CPU states.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.envs import prng
from rainbow_iqn_apex_tpu_torch.kernels import build

NAME = "K12_device_games"
SOURCE = "rainbow_iqn_apex_tpu_torch/csrc/device_games.cu"
REPLACES = "rainbow_iqn_apex_tpu/envs/device_games.py:974"

GAME_IDS = {"catch": 0, "breakout": 1, "freeway": 2, "asterix": 3, "invaders": 4}
VARIANT = 5
_TICK, _STEP, _INIT_SPLIT, _INIT_DIRECT, _RENDER = range(5)
# field -> (dtype, trailing shape); every other field is an int32 scalar per lane
_FIELDS = {"bricks": (torch.bool, (10, 10)), "wall": (torch.bool, (10, 10)),
           "aliens": (torch.bool, (10, 10)), "fleet": (torch.bool, (10, 10)),
           "cars": (torch.int32, (8,)), "speeds": (torch.int32, (8,)),
           "dirs": (torch.int32, (8,)), "col": (torch.int32, (8,)),
           "dirn": (torch.int32, (8,)), "lane_dir": (torch.int32, (8,)),
           "active": (torch.bool, (8,)), "gold": (torch.bool, (8,)),
           "gold_p": (torch.float32, (8,)), "drift": (torch.int32, (10,))}


def field_spec(name: str) -> Tuple[torch.dtype, Tuple[int, ...]]:
    return _FIELDS.get(name, (torch.int32, ()))


def _where_cut(cut: torch.Tensor, fresh, ns):
    """The fresh state on cut lanes, the stepped one elsewhere."""
    return type(ns)(*[torch.where(cut.reshape(-1, *[1] * (n.ndim - 1)), f, n)
                      for n, f in zip(ns, fresh)])


# ---------------------------------------------------------------- twins
def game_tick_plain(game, states, ep_rets: torch.Tensor, actions: torch.Tensor,
                    key) -> Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """The auto-reset tick in plain torch: ``(states, ep_rets, frames,
    reward, term, trunc & ~term, out_ret)``, new tensors."""
    k = prng.split(prng.split(prng.as_key(key).to(ep_rets.device), actions.shape[0]), 2)
    ns, reward, term, trunc = game.step(states, actions, k[:, 0])
    cut = term | trunc
    ep = ep_rets + reward
    out_ret = torch.where(cut, ep, float("nan"))
    ns = _where_cut(cut, game.init(k[:, 1]), ns)
    ep = torch.where(cut, 0.0, ep)
    return ns, ep, game.render(ns), reward, term, trunc & ~term, out_ret


def game_init_plain(game, key, lanes: int, device, direct: bool = False):
    """(state, frames) of ``lanes`` fresh lanes: per-lane keys
    ``split(key, lanes)``, or the key itself (``direct``)."""
    key = prng.as_key(key).to(device)
    keys = key.expand(lanes, 2) if direct else prng.split(key, lanes)
    state = game.init(keys)
    return state, game.render(state)


# ----------------------------------------------------------------- kernel
@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().port_device_games
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_uint, ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _game_id(game) -> int:
    return GAME_IDS[game.name] + (VARIANT if game.pool_size else 0)


def _check_state(game, states, lanes: int, dev: torch.device) -> None:
    if type(states) is not game.state_type:
        raise TypeError(f"K12 takes a {game.state_type.__name__}, got {type(states).__name__}")
    for name, t in zip(states._fields, states):
        dtype, shape = field_spec(name)
        if t.dtype != dtype or tuple(t.shape) != (lanes, *shape):
            raise TypeError(f"K12 takes {name} as {dtype} {(lanes, *shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"K12 takes {name} contiguous on {dev}")


def _launch(game, states, mode: int, key, lanes: int, frames: torch.Tensor, ep_rets=None,
            actions=None, reward=None, term=None, trunc=None, out_ret=None) -> None:
    dev = frames.device
    _check_state(game, states, lanes, dev)
    for name, t, dtype in (("ep_ret", ep_rets, torch.float32), ("actions", actions, torch.int32)):
        if t is not None and (t.dtype != dtype or t.device != dev or t.numel() != lanes
                              or not t.is_contiguous()):
            raise ValueError(f"K12 takes {name} as [{lanes}] {dtype} contiguous on {dev}")
    a, b = (int(v) & prng.MASK for v in prng.as_key(key, "cpu").tolist())
    fields = (ctypes.c_void_p * len(states))(*[t.data_ptr() for t in states])
    with torch.cuda.device(dev):
        code = _entry()(
            _game_id(game), ctypes.cast(fields, ctypes.c_void_p), len(states),
            build.ptr(ep_rets), build.ptr(actions), a, b, mode, build.ptr(frames),
            build.ptr(reward), build.ptr(term), build.ptr(trunc), build.ptr(out_ret), lanes,
            game.pool_base, game.pool_size, game.cap, game.cell, build.stream_of(dev))
    build.check_launch(NAME, code)


def _empty_state(game, lanes: int, dev: torch.device):
    return game.state_type(*[torch.empty((lanes, *field_spec(f)[1]), dtype=field_spec(f)[0],
                                         device=dev) for f in game.state_type._fields])


def _frames(game, lanes: int, dev: torch.device) -> torch.Tensor:
    return torch.empty((lanes, *game.frame_shape), dtype=torch.uint8, device=dev)


def _host_key(key) -> torch.Tensor:
    key = prng.as_key(key)
    if key.device.type != "cpu":
        raise ValueError("K12 takes its key on the host (a function of the host's key stream)")
    return key


def game_tick(game, states, ep_rets: torch.Tensor, actions: torch.Tensor, key):
    """One auto-reset tick of every lane, ``states`` and ``ep_rets`` in
    place: returns ``(frames, reward, term, trunc & ~term, out_ret)``."""
    key = _host_key(key)
    if ep_rets.device.type == "cpu":
        ns, ep, frames, reward, term, trunc, out_ret = game_tick_plain(game, states, ep_rets,
                                                                       actions, key)
        for dst, src in zip(states, ns):
            dst.copy_(src)
        ep_rets.copy_(ep)
        return frames, reward, term, trunc, out_ret
    lanes, dev = actions.shape[0], ep_rets.device
    frames = _frames(game, lanes, dev)
    reward = torch.empty(lanes, dtype=torch.float32, device=dev)
    term = torch.empty(lanes, dtype=torch.bool, device=dev)
    trunc = torch.empty(lanes, dtype=torch.bool, device=dev)
    out_ret = torch.empty(lanes, dtype=torch.float32, device=dev)
    _launch(game, states, _TICK, key, lanes, frames, ep_rets=ep_rets, actions=actions,
            reward=reward, term=term, trunc=trunc, out_ret=out_ret)
    return frames, reward, term, trunc, out_ret


def game_step(game, states, actions: torch.Tensor, key):
    """One step of every lane with ``key`` itself and no reset (the host
    adapter), ``states`` in place: returns ``(frames, reward, term, trunc)``."""
    key = _host_key(key)
    lanes, dev = actions.shape[0], actions.device
    if dev.type == "cpu":
        ns, reward, term, trunc = game.step(states, actions, key.expand(lanes, 2))
        for dst, src in zip(states, ns):
            dst.copy_(src)
        return game.render(states), reward, term, trunc
    frames = _frames(game, lanes, dev)
    reward = torch.empty(lanes, dtype=torch.float32, device=dev)
    term = torch.empty(lanes, dtype=torch.bool, device=dev)
    trunc = torch.empty(lanes, dtype=torch.bool, device=dev)
    _launch(game, states, _STEP, key, lanes, frames, actions=actions, reward=reward, term=term,
            trunc=trunc)
    return frames, reward, term, trunc


def game_init(game, key, lanes: int, device: torch.device, direct: bool = False):
    """``lanes`` fresh lanes on ``device`` and their frames: per-lane keys
    ``split(key, lanes)`` (``batched_init``), or the key itself
    (``direct``, the host adapter's reset)."""
    key = _host_key(key)
    device = torch.device(device)
    if device.type == "cpu":
        return game_init_plain(game, key, lanes, device, direct)
    state, frames = _empty_state(game, lanes, device), _frames(game, lanes, device)
    _launch(game, state, _INIT_DIRECT if direct else _INIT_SPLIT, key, lanes, frames)
    return state, frames


def game_render(game, states) -> torch.Tensor:
    """[L, H, W] uint8 frames of ``states``."""
    lanes, dev = states.t.shape[0], states.t.device
    if dev.type == "cpu":
        return game.render(states)
    frames = _frames(game, lanes, dev)
    _launch(game, states, _RENDER, (0, 0), lanes, frames)
    return frames
