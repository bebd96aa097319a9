"""Carry Rainbow-IQN weights between the JAX package's flax params and the port.

``from_flax`` takes the flax params tree (``TrainState.params``) with numpy
leaves and returns the port's state dict (fp32 CPU tensors for
``RainbowIQN``); ``to_flax`` goes back.  The round trip is exact: only
layouts change, never values.

Layouts:
- conv kernels are [kh, kw, in, out] in flax and [out, in, kh, kw] in torch;
- the Dense ``embed`` kernel and NoisyLinear ``w_mu`` / ``w_sigma`` are
  [in, out] in flax and [out, in] in the port;
- biases are the same [out] vectors.
The trunk's flatten order (H, W, C) is kept by ``ConvTrunk`` itself, so no
weight after it needs permuting.

A whole learner state crosses too: ``from_flax_train_state`` takes the JAX
``TrainState``'s pieces (params, target params, the optax
``ScaleByAdamState`` moments ``mu`` / ``nu`` and ``count``, and ``step``,
all as numpy) and returns the port's host state (``ops.learn.host_state``
form, for ``ops.learn.load_host_state``); ``to_flax_train_state`` goes back.
The Adam moments have the params' layout, so they convert as params do.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_NOISY_HEADS = ("value_hidden", "value_out", "advantage_hidden", "advantage_out",
                "q_hidden", "q_out")


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True, order="C"))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) -> the port's ``RainbowIQN`` state dict."""
    out: Dict[str, torch.Tensor] = {}
    trunk = params["ConvTrunk_0"]
    for i in range(len(trunk)):
        conv = trunk[f"Conv_{i}"]
        out[f"trunk.convs.{i}.weight"] = _t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
        out[f"trunk.convs.{i}.bias"] = _t(conv["bias"])
    embed = params["CosineTauEmbedding_0"]["embed"]
    out["tau_embed.embed.weight"] = _t(np.transpose(embed["kernel"]))
    out["tau_embed.embed.bias"] = _t(embed["bias"])
    for name in _NOISY_HEADS:
        if name in params:
            layer = params[name]
            out[f"{name}.w_mu"] = _t(np.transpose(layer["w_mu"]))
            out[f"{name}.b_mu"] = _t(layer["b_mu"])
            out[f"{name}.w_sigma"] = _t(np.transpose(layer["w_sigma"]))
            out[f"{name}.b_sigma"] = _t(layer["b_sigma"])
    return out


def to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> flax params with fp32 numpy leaves."""
    trunk = {}
    i = 0
    while f"trunk.convs.{i}.weight" in state:
        trunk[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(
                np.transpose(_n(state[f"trunk.convs.{i}.weight"]), (2, 3, 1, 0))),
            "bias": _n(state[f"trunk.convs.{i}.bias"]),
        }
        i += 1
    out: Dict[str, Any] = {
        "ConvTrunk_0": trunk,
        "CosineTauEmbedding_0": {"embed": {
            "kernel": np.ascontiguousarray(_n(state["tau_embed.embed.weight"]).T),
            "bias": _n(state["tau_embed.embed.bias"]),
        }},
    }
    for name in _NOISY_HEADS:
        if f"{name}.w_mu" in state:
            out[name] = {
                "w_mu": np.ascontiguousarray(_n(state[f"{name}.w_mu"]).T),
                "b_mu": _n(state[f"{name}.b_mu"]),
                "w_sigma": np.ascontiguousarray(_n(state[f"{name}.w_sigma"]).T),
                "b_sigma": _n(state[f"{name}.b_sigma"]),
            }
    return out


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
