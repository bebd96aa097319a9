"""Carry Rainbow-IQN and R2D2 weights between the JAX package's flax params and the port.

``from_flax`` takes the flax params tree (``TrainState.params`` or
``R2D2TrainState.params``) with numpy leaves and returns the port's state
dict (fp32 CPU tensors for ``RainbowIQN`` or ``R2D2Net``); ``to_flax`` goes
back.  The round trip is exact: only layouts change, never values.

Layouts:
- conv kernels are [kh, kw, in, out] in flax and [out, in, kh, kw] in torch;
- the Dense ``embed`` kernel and NoisyLinear ``w_mu`` / ``w_sigma`` are
  [in, out] in flax and [out, in] in the port;
- biases are the same [out] vectors;
- R2D2's flax ``OptimizedLSTMCell`` keeps one kernel per gate,
  ``lstm/cell/{ii,if,ig,io}/kernel`` [F, H] (no bias) and
  ``lstm/cell/{hi,hf,hg,ho}/{kernel,bias}`` [H, H] and [H]; the port holds
  them concatenated in that gate order, as the cell concatenates them before
  its products: ``lstm.w_i`` [F, 4H], ``lstm.w_h`` [H, 4H], ``lstm.b`` [4H].
- the multi-game embedding (``MultiGameIQN``) is flax ``game_embed/embedding``
  [G, F] and the port's ``game_embed`` [G, F], the same layout.
The trunk's flatten order (H, W, C) is kept by ``ConvTrunk`` itself, so no
weight after it needs permuting.

A whole learner state crosses too: ``from_flax_train_state`` takes the JAX
``TrainState``'s (or ``R2D2TrainState``'s) pieces (params, target params, the optax
``ScaleByAdamState`` moments ``mu`` / ``nu`` and ``count``, and ``step``,
all as numpy) and returns the port's host state (``ops.learn.host_state``
form, for ``ops.learn.load_host_state``); ``to_flax_train_state`` goes back.
The Adam moments have the params' layout, so they convert as params do.

``from_jax_device_replay_state`` takes a JAX ``DeviceReplayState`` with
numpy leaves (``jax.device_get`` of one) and returns the port's
``replay.device.DeviceReplayState``: the same arrays (no layout changes),
``pos`` and ``filled`` as host ints.  ``from_jax_device_seq_state`` does the
same for R2D2's ``DeviceSeqState`` (``pos``, ``filled`` and ``buf_len`` become
host counters), and ``device_seq_state_arrays`` gives a port
``replay.device_sequence.DeviceSeqState`` back as numpy arrays under the JAX
field names (``DeviceSeqState(**{k: jnp.asarray(v) ...})`` on the JAX side).

Device-game states cross too: ``from_jax_game_state`` takes a JAX game
state ``NamedTuple`` (``CatchState``, ..., ``InvadersVarState``) of numpy
[L, ...] leaves and returns the port's state of the same name
(``envs.device_games``) with the same arrays; ``game_state_arrays`` goes
back to {field: numpy}.  ``from_jax_fused_carry`` takes the lane half of a
JAX fused-Anakin carry, ``(env_s, ep, stack, frame, keep)``, and returns the
port's; ``fused_carry_arrays`` goes back.

Quantized weights cross as well: ``from_flax_quantized`` takes a JAX
``quantize_tree_jax`` / ``cast_tree_fp8`` tree of ``{"q", "s"}`` cells and
returns the port's ``utils.quantize.QuantizedParams``, each q laid out as
its parameter and each s as it is; ``to_flax_quantized`` goes back.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

_NOISY_HEADS = ("value_hidden", "value_out", "advantage_hidden", "advantage_out",
                "q_hidden", "q_out")
_GATES = "ifgo"  # flax OptimizedLSTMCell's gate order
_LSTM = ("lstm.w_i", "lstm.w_h", "lstm.b")


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True, order="C"))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _leaves(tree: Mapping[str, Any]):
    """(port name, flax leaf, axes that turn the flax layout into the port's
    or None) for each parameter of a flax-shaped tree."""
    trunk = tree["ConvTrunk_0"]
    for i in range(len(trunk)):
        conv = trunk[f"Conv_{i}"]
        yield f"trunk.convs.{i}.weight", conv["kernel"], (3, 2, 0, 1)
        yield f"trunk.convs.{i}.bias", conv["bias"], None
    if "CosineTauEmbedding_0" in tree:
        embed = tree["CosineTauEmbedding_0"]["embed"]
        yield "tau_embed.embed.weight", embed["kernel"], (1, 0)
        yield "tau_embed.embed.bias", embed["bias"], None
    for name in _NOISY_HEADS:
        if name in tree:
            for p in ("w_mu", "b_mu", "w_sigma", "b_sigma"):
                yield f"{name}.{p}", tree[name][p], (1, 0) if p[0] == "w" else None
    if "game_embed" in tree:
        yield "game_embed", tree["game_embed"]["embedding"], None


def _flax_tree(names, leaf) -> Dict[str, Any]:
    """The flax-shaped tree of ``leaf(name, axes)`` for the port's parameter
    ``names``; ``axes`` turns the port's layout into flax's, or is None."""
    out: Dict[str, Any] = {"ConvTrunk_0": {}}
    for name in names:
        parts = name.split(".")
        if parts[0] == "trunk":
            node = out["ConvTrunk_0"].setdefault(f"Conv_{parts[2]}", {})
            key = "kernel" if parts[3] == "weight" else "bias"
            node[key] = leaf(name, (2, 3, 1, 0) if key == "kernel" else None)
        elif parts[0] == "tau_embed":
            key = "kernel" if parts[2] == "weight" else "bias"
            embed = out.setdefault("CosineTauEmbedding_0", {}).setdefault("embed", {})
            embed[key] = leaf(name, (1, 0) if key == "kernel" else None)
        elif parts[0] == "lstm":
            continue  # the cell's per-gate tree: _lstm_to_flax
        elif parts[0] == "game_embed":
            out["game_embed"] = {"embedding": leaf(name, None)}
        else:
            out.setdefault(parts[0], {})[parts[1]] = leaf(
                name, (1, 0) if parts[1][0] == "w" else None)
    return out


def _layout(a: np.ndarray, axes) -> np.ndarray:
    return a if axes is None else np.ascontiguousarray(np.transpose(a, axes))


def _lstm_from_flax(cell: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``OptimizedLSTMCell`` params -> the port's concatenated ones."""
    def cat(prefix: str, key: str) -> torch.Tensor:
        return _t(np.concatenate([np.asarray(cell[prefix + g][key]) for g in _GATES], axis=-1))

    return {"lstm.w_i": cat("i", "kernel"), "lstm.w_h": cat("h", "kernel"),
            "lstm.b": cat("h", "bias")}


def _lstm_to_flax(w_i: np.ndarray, w_h: np.ndarray, b: np.ndarray) -> Dict[str, Any]:
    """The port's concatenated LSTM params -> flax ``lstm/cell`` per gate."""
    hidden = w_h.shape[0]
    cell: Dict[str, Any] = {}
    for k, g in enumerate(_GATES):
        cols = slice(k * hidden, (k + 1) * hidden)
        cell["i" + g] = {"kernel": np.ascontiguousarray(w_i[:, cols])}
        cell["h" + g] = {"kernel": np.ascontiguousarray(w_h[:, cols]),
                         "bias": np.ascontiguousarray(b[cols])}
    return {"cell": cell}


def from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) -> the port's ``RainbowIQN`` or ``R2D2Net``
    state dict."""
    out = {name: _t(_layout(np.asarray(a), axes)) for name, a, axes in _leaves(params)}
    if "lstm" in params:
        out.update(_lstm_from_flax(params["lstm"]["cell"]))
    return out


def to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> flax params with fp32 numpy leaves."""
    out = _flax_tree(state, lambda name, axes: _layout(_n(state[name]), axes))
    if "lstm.w_h" in state:
        out["lstm"] = _lstm_to_flax(*(_n(state[name]) for name in _LSTM))
    return out


def from_flax_quantized(qtree: Mapping[str, Any]):
    """A JAX ``quantize_tree_jax`` / ``cast_tree_fp8`` tree of ``{"q", "s"}``
    cells (numpy leaves) -> the port's ``QuantizedParams``: each q laid out
    as ``from_flax`` lays out its parameter, each s kept (the per-channel
    scales of the flax kernel's last axis are those of the port's dim 0), on
    the CPU."""
    from rainbow_iqn_apex_tpu_torch.utils.quantize import QuantizedParams

    leaves = list(_leaves(qtree))
    q0 = np.asarray(leaves[0][1]["q"])
    mode = "int8" if q0.dtype == np.int8 else "fp8"
    if mode == "fp8" and "float8_e4m3" not in str(q0.dtype):
        raise ValueError(f"from_flax_quantized: q of dtype {q0.dtype} is neither int8 nor e4m3")
    shapes = {name: _layout(np.asarray(cell["q"]), axes).shape for name, cell, axes in leaves}
    out = QuantizedParams(mode, shapes)
    for name, cell, axes in leaves:
        q = _layout(np.asarray(cell["q"]).view(np.uint8), axes)
        out.q[name].view(torch.uint8).copy_(torch.from_numpy(np.array(q, copy=True)))
        out.s[name].copy_(torch.from_numpy(np.array(cell["s"], np.float32).reshape(-1)))
    return out


def to_flax_quantized(qp) -> Dict[str, Any]:
    """A ``QuantizedParams`` -> the flax-shaped tree of ``{"q", "s"}`` cells
    with numpy leaves: q int8 in int8 mode, in fp8 mode its e4m3 bit
    patterns as uint8 (numpy has no e4m3 dtype without ml_dtypes)."""
    def cell(name, axes):
        q = qp.q[name].detach().cpu()
        q = q.numpy() if qp.mode == "int8" else q.view(torch.uint8).numpy()
        return {"q": _layout(q, axes), "s": qp.s[name].detach().cpu().numpy().copy()}

    return _flax_tree(qp.shapes, cell)


def from_flax_train_state(params: Mapping[str, Any], target_params: Mapping[str, Any],
                          mu: Mapping[str, Any], nu: Mapping[str, Any], count: Any,
                          step: Any) -> Dict[str, Any]:
    """The JAX learner state's pieces -> the port's host state."""
    return {
        "params": from_flax(params),
        "target_params": from_flax(target_params),
        "adam": {"mu": from_flax(mu), "nu": from_flax(nu), "count": int(np.asarray(count))},
        "step": int(np.asarray(step)),
    }


def to_flax_train_state(host: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's host state -> {params, target_params, mu, nu, count, step}
    with flax layouts and numpy leaves (count and step int32)."""
    adam = host["adam"]
    return {
        "params": to_flax(host["params"]),
        "target_params": to_flax(host["target_params"]),
        "mu": to_flax(adam["mu"]),
        "nu": to_flax(adam["nu"]),
        "count": np.asarray(adam["count"], np.int32),
        "step": np.asarray(host["step"], np.int32),
    }


def from_jax_device_replay_state(state: Any, device: Union[str, torch.device] = "cpu"):
    """A JAX ``DeviceReplayState`` (numpy leaves) -> the port's, on ``device``."""
    from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplayState

    def put(name: str, dtype: Any) -> torch.Tensor:
        arr = np.array(getattr(state, name), dtype=dtype, copy=True, order="C")
        return torch.from_numpy(arr).to(device)

    return DeviceReplayState(
        frames=put("frames", np.uint8), actions=put("actions", np.int32),
        rewards=put("rewards", np.float32), terminals=put("terminals", np.bool_),
        cuts=put("cuts", np.bool_), priority=put("priority", np.float32),
        max_priority=put("max_priority", np.float32),
        pos=int(np.asarray(state.pos)), filled=int(np.asarray(state.filled)))


_SEQ_DTYPES = {"frames": np.uint8, "actions": np.int32, "rewards": np.float32,
               "dones": np.bool_, "valids": np.bool_, "init_c": np.float32,
               "init_h": np.float32, "priority": np.float32, "pos": np.int32,
               "filled": np.int32, "max_priority": np.float32, "buf_frames": np.uint8,
               "buf_actions": np.int32, "buf_rewards": np.float32, "buf_dones": np.bool_,
               "buf_c": np.float32, "buf_h": np.float32, "buf_len": np.int32}


def from_jax_device_seq_state(state: Any, device: Union[str, torch.device] = "cpu"):
    """A JAX ``DeviceSeqState`` (numpy leaves, or any object or mapping with
    its fields) -> the port's, on ``device``."""
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import HOST_FIELDS, DeviceSeqState

    def get(name: str) -> np.ndarray:
        value = state[name] if isinstance(state, Mapping) else getattr(state, name)
        return np.array(value, dtype=_SEQ_DTYPES[name], copy=True, order="C")

    fields = {name: torch.from_numpy(get(name)).to(device)
              for name in _SEQ_DTYPES if name not in HOST_FIELDS}
    return DeviceSeqState(**fields, pos=int(get("pos")), filled=int(get("filled")),
                          buf_len=get("buf_len"))


def device_seq_state_arrays(state) -> Dict[str, np.ndarray]:
    """A port ``DeviceSeqState`` -> {JAX field name: numpy array}."""

    def host(value: Any) -> Any:
        return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value

    return {name: np.asarray(host(getattr(state, name)), dtype=dtype)
            for name, dtype in _SEQ_DTYPES.items()}


def from_jax_game_state(state: Any, device: Union[str, torch.device] = "cpu"):
    """A JAX device-game state (numpy [L, ...] leaves) -> the port's, on ``device``."""
    from rainbow_iqn_apex_tpu_torch.envs import device_games
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import field_spec

    cls = getattr(device_games, type(state).__name__)
    fields = {}
    for name in cls._fields:
        dtype = field_spec(name)[0]
        arr = np.array(getattr(state, name), copy=True, order="C")
        fields[name] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return cls(**fields)


def game_state_arrays(state: Any) -> Dict[str, np.ndarray]:
    """A port device-game state -> {JAX field name: numpy array}."""
    return {name: value.detach().cpu().numpy() for name, value in zip(state._fields, state)}


def from_jax_fused_carry(env_s: Any, ep: Any, stack: Any, frame: Any, keep: Any,
                         device: Union[str, torch.device] = "cpu"):
    """The lane half of a JAX fused-Anakin carry (numpy leaves) -> the port's
    ``(env_s, ep [L] f32, stack [L, H, W, C] u8, frame [L, H, W] u8, keep [L] u8)``."""
    def put(a: Any, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(device=device, dtype=dtype)

    return (from_jax_game_state(env_s, device), put(ep, torch.float32), put(stack, torch.uint8),
            put(frame, torch.uint8), put(keep, torch.uint8))


def fused_carry_arrays(env_s: Any, ep: torch.Tensor, stack: torch.Tensor, frame: torch.Tensor,
                       keep: torch.Tensor) -> Dict[str, Any]:
    """The port's lane carry -> numpy, under the JAX carry's names."""
    return {"env_s": game_state_arrays(env_s), "ep": _n(ep), "stack": _n(stack),
            "frame": _n(frame), "keep": _n(keep)}
