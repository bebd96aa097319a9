"""Parity of the PyTorch port's model (rainbow_iqn_apex_tpu_torch.models)
with the JAX package's, layer by layer and end to end.

Both frameworks get the same weights (JAX init, perturbed with a seeded
numpy draw so that biases are non-zero and no matrix is transpose-invariant,
carried across by convert.py), the same taus (injected through ``taus=``)
and, in noisy mode, the same standard normals (injected on the JAX side by
monkeypatching ``jax.random.normal`` in this process only).

Tolerances: fp32 1e-5 abs/rel, since only the summation order differs.
bf16 3e-2 abs on quantiles, from bf16 rounding (8-bit mantissa) at the
model's rounding points; bf16 greedy actions must agree wherever the top-2
Q gap exceeds that tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.models.iqn import RainbowIQN as JaxIQN
from rainbow_iqn_apex_tpu.models.layers import ConvTrunk as JaxConvTrunk
from rainbow_iqn_apex_tpu.models.layers import CosineTauEmbedding as JaxCosEmbed
from rainbow_iqn_apex_tpu.models.layers import NoisyLinear as JaxNoisyLinear
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.models import (
    ConvTrunk,
    CosineTauEmbedding,
    NoisyLinear,
    RainbowIQN,
    greedy_action,
    init_params,
    q_values,
)

A = 4
HIDDEN = 64
COSINES = 16
SHAPE = (44, 44, 2)
FP32 = dict(atol=1e-5, rtol=1e-5)
BF16_ATOL = 3e-2
NOISY = ("value_hidden", "value_out", "advantage_hidden", "advantage_out")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_net(dtype="float32", use_noise=False, num_actions=A):
    return JaxIQN(num_actions=num_actions, hidden_size=HIDDEN, num_cosines=COSINES,
                  use_noise=use_noise, compute_dtype=DTYPES[dtype][0])


def _port_net(params, dtype="float32", use_noise=False, shape=SHAPE, num_actions=A):
    net = RainbowIQN(num_actions, shape, hidden_size=HIDDEN, num_cosines=COSINES,
                     use_noise=use_noise, compute_dtype=DTYPES[dtype][1])
    net.load_state_dict(convert.from_flax(params))
    return net.requires_grad_(False)


@functools.lru_cache(maxsize=None)
def _flax_params(shape=SHAPE, seed=0, num_actions=A):
    """JAX-initialised params with every leaf perturbed by a seeded draw
    (cached: read-only in every test)."""
    key = jax.random.PRNGKey(seed)
    params = _jax_net(num_actions=num_actions).init(
        {"params": key, "taus": key, "noise": key},
        jnp.zeros((1, *shape), jnp.uint8), 8)["params"]
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        if path[-1].key in ("bias", "b_mu", "b_sigma"):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return (leaf * rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


def _obs(batch, shape=SHAPE, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, *shape), dtype=np.uint8)


def _taus(batch, n, seed=2):
    return np.random.default_rng(seed).random((batch, n), dtype=np.float32)


def _normals(in_out_pairs, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(i).astype(np.float32),
             rng.standard_normal(o).astype(np.float32)) for i, o in in_out_pairs]


def _inject_jax_normals(monkeypatch, pairs):
    """Make jax.random.normal hand out ``pairs`` (eps_in, eps_out) in call order."""
    queue = [a for pair in pairs for a in pair]

    def fake_normal(key, shape=(), dtype=jnp.float32):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr, dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    return queue


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("shape", [(44, 44, 2), (52, 44, 2)])
def test_conv_trunk_parity_flatten_order(shape):
    """H != W shows an H/W mix-up; the HWC flatten order must match flax's."""
    params = _flax_params(shape)
    x = _obs(3, shape).astype(np.float32) / 255.0
    ref = JaxConvTrunk(compute_dtype=jnp.float32).apply(
        {"params": params["ConvTrunk_0"]}, jnp.asarray(x))
    trunk = ConvTrunk(shape[-1], torch.float32)
    state = convert.from_flax(params)
    trunk.load_state_dict({k[len("trunk."):]: v for k, v in state.items()
                           if k.startswith("trunk.")})
    with torch.no_grad():
        got = trunk(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)


@pytest.mark.parametrize("with_phi", [False, True])
def test_cosine_tau_embedding_parity(with_phi):
    """psi alone (phi = 1) and the merged phi * psi, folded to [B*N, F]."""
    params = _flax_params()
    feat = params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    taus = _taus(3, 8)
    psi = np.asarray(JaxCosEmbed(features=feat, num_cosines=COSINES, compute_dtype=jnp.float32)
                     .apply({"params": params["CosineTauEmbedding_0"]}, jnp.asarray(taus)))
    phi = (np.random.default_rng(5).random((3, feat), dtype=np.float32) if with_phi
           else np.ones((3, feat), np.float32))
    embed = CosineTauEmbedding(feat, COSINES, torch.float32)
    state = convert.from_flax(params)
    embed.embed.weight.data = state["tau_embed.embed.weight"]
    embed.embed.bias.data = state["tau_embed.embed.bias"]
    with torch.no_grad():
        got = embed(torch.from_numpy(taus), torch.from_numpy(phi))
    want = (phi[:, None, :] * psi).reshape(3 * 8, feat)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
def test_noisy_linear_parity(monkeypatch, use_noise):
    params = _flax_params()
    layer_p = params["advantage_hidden"]
    fan_in, out = layer_p["w_mu"].shape
    x = np.random.default_rng(6).standard_normal((7, fan_in)).astype(np.float32)
    (eps,) = _normals([(fan_in, out)])
    if use_noise:
        _inject_jax_normals(monkeypatch, [eps])
    ref = JaxNoisyLinear(out, use_noise=use_noise, compute_dtype=jnp.float32).apply(
        {"params": layer_p}, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(0)})
    layer = NoisyLinear(fan_in, out, compute_dtype=torch.float32)
    state = convert.from_flax(params)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()
                           if k.startswith("advantage_hidden.")})
    with torch.no_grad():
        got = layer(torch.from_numpy(x),
                    tuple(map(torch.from_numpy, eps)) if use_noise else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)


# --------------------------------------------------------------- end to end
def _run_both(monkeypatch, dtype, use_noise, batch, n=8, shape=SHAPE):
    params = _flax_params(shape)
    obs, taus = _obs(batch, shape), _taus(batch, n)
    feat = params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    pairs = _normals([(feat, HIDDEN), (HIDDEN, 1), (feat, HIDDEN), (HIDDEN, A)])
    if use_noise:
        left = _inject_jax_normals(monkeypatch, pairs)
    ref_q, ref_taus = _jax_net(dtype, use_noise).apply(
        {"params": params}, jnp.asarray(obs), n, taus=jnp.asarray(taus),
        rngs={"noise": jax.random.PRNGKey(0)})
    if use_noise:
        assert not left  # every layer drew its noise exactly once
    net = _port_net(params, dtype, use_noise, shape)
    noise = {name: tuple(map(torch.from_numpy, p)) for name, p in zip(NOISY, pairs)}
    with torch.no_grad():
        out = net(torch.from_numpy(obs), n, taus=torch.from_numpy(taus),
                  noise=noise if use_noise else None)
    np.testing.assert_array_equal(out.taus.numpy(), np.asarray(ref_taus))
    return np.asarray(ref_q), out


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
def test_rainbow_iqn_parity_fp32(monkeypatch, use_noise, batch):
    ref_q, out = _run_both(monkeypatch, "float32", use_noise, batch)
    assert out.quantiles.shape == ref_q.shape == (batch, 8, A)
    np.testing.assert_allclose(out.quantiles.numpy(), ref_q, **FP32)
    ref_mean = ref_q.mean(axis=1)
    np.testing.assert_allclose(out.q.numpy(), ref_mean, **FP32)
    np.testing.assert_array_equal(out.action.numpy(), np.argmax(ref_mean, -1))


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
def test_rainbow_iqn_parity_bf16(monkeypatch, use_noise, batch):
    ref_q, out = _run_both(monkeypatch, "bfloat16", use_noise, batch)
    assert out.quantiles.dtype == torch.float32
    np.testing.assert_allclose(out.quantiles.numpy(), ref_q, atol=BF16_ATOL, rtol=0)
    ref_mean = ref_q.mean(axis=1)
    top2 = np.sort(ref_mean, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > BF16_ATOL
    np.testing.assert_array_equal(out.action.numpy()[clear], np.argmax(ref_mean, -1)[clear])


def test_rainbow_iqn_parity_tall_frames(monkeypatch):
    """52x44 frames end to end: a trunk flattened in the wrong order would
    misalign every weight after it."""
    ref_q, out = _run_both(monkeypatch, "float32", False, 2, shape=(52, 44, 2))
    np.testing.assert_allclose(out.quantiles.numpy(), ref_q, **FP32)


def test_q_values_and_greedy_action_helpers():
    quantiles = torch.tensor([[[1.0, 3.0, 3.0], [1.0, 1.0, 1.0]]])
    np.testing.assert_allclose(q_values(quantiles).numpy(), [[1.0, 2.0, 2.0]])
    assert greedy_action(quantiles).tolist() == [1]  # first of the tie
    assert greedy_action(quantiles).dtype == torch.int32


# ----------------------------------------------------------------- convert
def test_convert_round_trip_is_exact():
    params = _flax_params()
    back = convert.to_flax(convert.from_flax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a), b)
    # and the port side: state dict -> flax -> state dict
    state = convert.from_flax(params)
    again = convert.from_flax(convert.to_flax(state))
    assert state.keys() == again.keys()
    for k in state:
        assert torch.equal(state[k], again[k]), k


def test_convert_layouts():
    params = _flax_params()
    state = convert.from_flax(params)
    kernel = np.asarray(params["ConvTrunk_0"]["Conv_0"]["kernel"])  # [kh, kw, in, out]
    assert state["trunk.convs.0.weight"][5, 1, 2, 3] == kernel[2, 3, 1, 5]
    w_mu = np.asarray(params["value_hidden"]["w_mu"])  # [in, out]
    assert state["value_hidden.w_mu"][7, 11] == w_mu[11, 7]


# -------------------------------------------------------------------- init
def test_init_params_follow_flax_distributions():
    cfg = Config(frame_height=44, frame_width=44, history_length=2,
                 hidden_size=HIDDEN, num_cosines=COSINES)
    state = init_params(cfg, A, seed=0)
    again = init_params(cfg, A, seed=0)
    assert all(torch.equal(state[k], again[k]) for k in state)  # seeded
    for k, v in state.items():
        if k.startswith(("trunk", "tau_embed")) and k.endswith("bias"):
            assert torch.count_nonzero(v) == 0, k
    fan_in = state["value_hidden.w_mu"].shape[1]
    bound = fan_in ** -0.5
    assert state["value_hidden.w_mu"].abs().max() <= bound
    assert torch.allclose(state["value_hidden.w_sigma"], torch.tensor(0.5 * bound))
    assert torch.allclose(state["value_hidden.b_sigma"], torch.tensor(0.5 * bound))
    conv = state["trunk.convs.2.weight"]  # fan_in 64 * 3 * 3, 36864 draws
    std = (1.0 / conv[0].numel()) ** 0.5
    assert conv.abs().max() <= 2.0 * std / 0.87962566103423978 + 1e-7
    assert abs(conv.std().item() / std - 1.0) < 0.05
    # the port's net takes exactly these keys, and so does the converter
    jax_like = convert.to_flax(state)
    assert set(jax_like) == {"ConvTrunk_0", "CosineTauEmbedding_0", *NOISY}
