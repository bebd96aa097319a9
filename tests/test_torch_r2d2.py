"""The port's R2D2 (rainbow_iqn_apex_tpu_torch: models/r2d2.py, ops/r2d2.py,
replay/sequence.py, train_r2d2.py, the R2D2 half of convert.py) against the
JAX package's, on the CPU through the plain twins of the kernels (K9, K9-bwd,
K11, K8s-stack, and K3/K4 as the IQN tests use them).

Sizes are the JAX tests' (tests/test_r2d2.py): 44x44 frames, LSTM 32,
hidden 32, burn-in 4, 8 trained steps, here 4 actions.  Both frameworks get
the same weights (a JAX R2D2TrainState carried across by convert.py, two
steps in so the Adam moments are non-zero), the same batch (numpy, seeded)
and the same noise: the port through ``noise=`` / ``draws=``, the JAX side
by monkeypatching ``jax.random.normal`` in call order, in this process only.

Tolerances (none widened for the port):
- fp32: rtol/atol 1e-5 for the unroll, the forward, the LSTM's gradient, the
  loss, the priorities, q_mean and grad_norm; params, target params and Adam
  moments after a step rtol 1e-4, atol 1e-6 (Adam divides by sqrt(nu)).
- bf16 (trunk and heads; the LSTM stays fp32): model outputs within 3e-2,
  as tests/test_torch_model.py; a learn step's loss, priorities and q_mean
  rtol 2e-2 / atol 3e-2 and grad_norm 2^-6, as tests/test_torch_learn.py's
  bf16 step.
- The replay is numpy on both sides: equal.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.models.r2d2 import R2D2Net as JaxR2D2Net
from rainbow_iqn_apex_tpu.models.r2d2 import _ResettableLSTMStep
from rainbow_iqn_apex_tpu.ops import r2d2 as jr2d2
from rainbow_iqn_apex_tpu.replay.sequence import SequenceReplay as JaxSequenceReplay
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels.lstm import LSTMFn, lstm_backward_plain, lstm_forward_plain
from rainbow_iqn_apex_tpu_torch.models.r2d2 import R2D2Net, ResettableLSTM
from rainbow_iqn_apex_tpu_torch.ops import r2d2 as pr2d2
from rainbow_iqn_apex_tpu_torch.ops.learn import host_state, load_host_state
from rainbow_iqn_apex_tpu_torch.replay.sequence import SequenceReplay
from rainbow_iqn_apex_tpu_torch.train import train
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import Checkpointer

A = 4
FRAME = (44, 44)
LSTM = 32
HIDDEN = 32
BURN, SEQ = 4, 8
L = BURN + SEQ
B = 4
FP32 = dict(rtol=1e-5, atol=1e-5)
STEP_INFO = dict(rtol=1e-5, atol=1e-6)
STEP_STATE = dict(rtol=1e-4, atol=1e-6)
BF16_OUT = dict(rtol=0.0, atol=3e-2)
NOISY = ("value_hidden", "value_out", "advantage_hidden", "advantage_out")
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=what, **tol)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(dtype="float32", **kw):
    base = dict(compute_dtype=dtype, frame_height=FRAME[0], frame_width=FRAME[1],
                history_length=2, hidden_size=HIDDEN, lstm_size=LSTM, r2d2_burn_in=BURN,
                r2d2_seq_len=SEQ, r2d2_overlap=4, multi_step=2, gamma=0.9, batch_size=B,
                learning_rate=1e-3, target_update_period=10, architecture="r2d2")
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _inject(monkeypatch, normals):
    """jax.random.normal hands out ``normals`` in call order (the R2D2 net
    draws nothing else from it on apply); returns the queue."""
    nq = list(normals)

    def fake_normal(key, shape=(), dtype=jnp.float32):
        arr = nq.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr, dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    return nq


def _noise(rng, feat=LSTM):
    dims = [(feat, HIDDEN), (HIDDEN, 1), (feat, HIDDEN), (HIDDEN, A)]
    return {layer: (rng.standard_normal(i).astype(np.float32),
                    rng.standard_normal(o).astype(np.float32))
            for layer, (i, o) in zip(NOISY, dims)}


def _flat(noise):
    return [a for layer in NOISY for a in noise[layer]]


def _port_noise(noise):
    return {k: (_t(a), _t(b)) for k, (a, b) in noise.items()}


def _obs(rng, batch, steps, channels):
    return rng.integers(0, 256, (batch, steps, *FRAME, channels), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_params(channels: int = 1):
    net = JaxR2D2Net(num_actions=A, lstm_size=LSTM, hidden_size=HIDDEN, compute_dtype=jnp.float32)
    obs = jnp.zeros((1, 2, *FRAME, channels), jnp.uint8)
    params = net.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                      obs, net.initial_state(1))["params"]
    return _np(params)


def _port_net(params, dtype, channels=1, use_noise=True):
    net = R2D2Net(A, (*FRAME, channels), lstm_size=LSTM, hidden_size=HIDDEN, use_noise=use_noise,
                  compute_dtype=DT[dtype][1])
    net.load_state_dict(convert.from_flax(params))
    return net


# ------------------------------------------------------------ value rescale
def test_value_rescale_and_unrescale_match_jax():
    x = np.array([-1e4, -100.0, -7.3, -1.0, -1e-4, 0.0, 1e-4, 0.5, 1.0, 7.3, 1000.0, 3e5],
                 np.float32)
    _close(pr2d2.value_rescale(_t(x)).numpy(), jr2d2.value_rescale(jnp.asarray(x)), FP32, "h")
    _close(pr2d2.value_unrescale(_t(x)).numpy(), jr2d2.value_unrescale(jnp.asarray(x)), FP32,
           "h^-1")
    back = pr2d2.value_unrescale(pr2d2.value_rescale(_t(x)))
    _close(back.numpy(), x, dict(rtol=1e-4, atol=1e-5), "h^-1(h(x))")


@pytest.mark.parametrize("history", [1, 3, 4])
def test_stack_seq_frames_matches_jax(history):
    obs = _obs(np.random.default_rng(history), 2, 7, 1)
    want = np.asarray(jr2d2.stack_seq_frames(jnp.asarray(obs), history))
    got = pr2d2.stack_seq_frames(_t(obs), history).numpy()
    np.testing.assert_array_equal(got, want)
    if history > 1:  # channel k at t holds frame t - (history - 1 - k), zeros before 0
        np.testing.assert_array_equal(got[:, 3, ..., 0], obs[:, 3 - history + 1, ..., 0])
        assert not got[:, 0, ..., : history - 1].any()


# ---------------------------------------------------------- LSTM (K9 twin)
def _jax_lstm(params, x, state, resets):
    from flax import linen as nn

    class Unroll(nn.Module):
        @nn.compact
        def __call__(self, state, xs, resets):
            scan = nn.scan(_ResettableLSTMStep, variable_broadcast="params",
                           split_rngs={"params": False}, in_axes=0, out_axes=0)
            final, outs = scan(features=LSTM, name="lstm")(
                state, (jnp.moveaxis(xs, 1, 0), jnp.moveaxis(resets, 1, 0)))
            return jnp.moveaxis(outs, 0, 1), final

    return Unroll().apply({"params": {"lstm": params}}, state, x, resets)


def _resets(rng, batch, steps, p=0.2):
    r = rng.random((batch, steps)) < p
    r[0, 2] = True
    return r


def test_lstm_unroll_and_its_gradient_match_jax():
    """The resettable LSTM (K9's twin forward and K9-bwd's twin backward
    through ``LSTMFn``) against the flax cell scanned by R2D2Net, with
    planted resets: h_seq and the final (c, h), then the gradient of a
    weighted sum of all three in x, W_i, W_h and b."""
    rng = np.random.default_rng(3)
    feat, steps = 24, 9
    cell = _jax_params()["lstm"]["cell"]
    cell = {k: {n: (rng.standard_normal(v.shape) * 0.3).astype(np.float32) for n, v in p.items()}
            for k, p in cell.items() if k[0] == "h"} | {
        f"i{g}": {"kernel": (rng.standard_normal((feat, LSTM)) * 0.2).astype(np.float32)}
        for g in "ifgo"}
    x = rng.standard_normal((B, steps, feat)).astype(np.float32)
    c0, h0 = (rng.standard_normal((B, LSTM)).astype(np.float32) * 0.5 for _ in range(2))
    resets = _resets(rng, B, steps)
    gh, gc, gs = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, steps, LSTM), (B, LSTM), (B, LSTM)))

    def loss(params, xx):
        hs, (c, h) = _jax_lstm(params, xx, (jnp.asarray(c0), jnp.asarray(h0)),
                               jnp.asarray(resets))
        return jnp.sum(hs * gh) + jnp.sum(c * gc) + jnp.sum(h * gs), (hs, c, h)

    (_, (hs_ref, c_ref, h_ref)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"cell": cell}, jnp.asarray(x))

    lstm = ResettableLSTM(feat, LSTM)
    lstm.load_state_dict({k.split(".", 1)[1]: v
                          for k, v in convert.from_flax({"ConvTrunk_0": {},
                                                         "lstm": {"cell": cell}}).items()})
    xt = _t(x).requires_grad_()
    hs, (c, h) = lstm(xt, (_t(c0), _t(h0)), _t(resets))
    _close(hs.detach().numpy(), hs_ref, FP32, "h_seq")
    _close(c.detach().numpy(), c_ref, FP32, "c_T")
    _close(h.detach().numpy(), h_ref, FP32, "h_T")
    ((hs * _t(gh)).sum() + (c * _t(gc)).sum() + (h * _t(gs)).sum()).backward()
    want = convert._lstm_from_flax(gp["cell"])
    _close(xt.grad.numpy(), gx, FP32, "dx")
    for name in ("w_i", "w_h", "b"):
        _close(getattr(lstm, name).grad.numpy(), want[f"lstm.{name}"].numpy(), FP32, name)


def test_lstm_backward_twin_equals_autograd_of_the_forward_twin():
    """K9-bwd's twin (the kernel's own arithmetic) against torch autograd of
    K9's twin, on one random unroll with resets."""
    rng = np.random.default_rng(4)
    steps, hidden = 6, 8
    xw = _t(rng.standard_normal((3, steps, 4 * hidden)).astype(np.float32)).requires_grad_()
    w_h = _t(rng.standard_normal((hidden, 4 * hidden)).astype(np.float32) * 0.4)
    b = _t(rng.standard_normal(4 * hidden).astype(np.float32) * 0.1)
    c0, h0 = (_t(rng.standard_normal((3, hidden)).astype(np.float32)) for _ in range(2))
    reset = _t(_resets(rng, 3, steps))
    hs, c, h, (gates, c_seq) = lstm_forward_plain(xw, w_h, b, reset, c0, h0, save=True)
    gh, gc = _t(rng.standard_normal(hs.shape).astype(np.float32)), _t(rng.standard_normal(c.shape).astype(np.float32))
    ((hs * gh).sum() + (c * gc).sum()).backward()
    dpre = lstm_backward_plain(gh, None, gc, w_h, reset, gates.detach(), c_seq.detach(), c0)
    _close(dpre.numpy(), xw.grad.numpy(), FP32, "d pre")
    xw2 = xw.detach().clone().requires_grad_()
    w2, b2 = w_h.clone().requires_grad_(), b.clone().requires_grad_()
    hs2, c2, _ = LSTMFn.apply(xw2, w2, b2, reset, c0, h0)
    ((hs2 * gh).sum() + (c2 * gc).sum()).backward()
    _close(xw2.grad.numpy(), xw.grad.numpy(), FP32, "LSTMFn dxw")


# ---------------------------------------------------------------- network
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r2d2_forward_with_resets_matches_jax(monkeypatch, dtype):
    """q [B, T, A] and the final state from the same params, noise, obs,
    stored state and planted resets."""
    jdt, _ = DT[dtype]
    params = _jax_params()
    rng = np.random.default_rng(5)
    obs = _obs(rng, 3, 5, 1)
    c0, h0 = (rng.standard_normal((3, LSTM)).astype(np.float32) * 0.5 for _ in range(2))
    resets = _resets(rng, 3, 5)
    noise = _noise(rng)
    _inject(monkeypatch, _flat(noise))
    jnet = JaxR2D2Net(num_actions=A, lstm_size=LSTM, hidden_size=HIDDEN, compute_dtype=jdt)
    q_ref, (c_ref, h_ref) = jnet.apply({"params": params}, jnp.asarray(obs),
                                       (jnp.asarray(c0), jnp.asarray(h0)),
                                       resets=jnp.asarray(resets), rngs={"noise": jax.random.PRNGKey(0)})
    net = _port_net(params, dtype)
    with torch.no_grad():
        q, (c, h) = net(_t(obs), (_t(c0), _t(h0)), _t(resets), noise=_port_noise(noise))
    assert q.shape == (3, 5, A) and q.dtype == torch.float32
    tol = FP32 if dtype == "float32" else BF16_OUT  # bf16: phi rounds in the trunk
    _close(c.numpy(), c_ref, tol, "c")
    _close(h.numpy(), h_ref, tol, "h")
    _close(q.numpy(), q_ref, tol, "q")


def test_stepwise_equals_unrolled_with_resets():
    """One 6-step unroll == six one-step calls threading the state, the same
    noise each step, with a reset planted mid-sequence (the JAX test's
    property, and the act path's K9 at T = 1 against the learner's)."""
    rng = np.random.default_rng(6)
    net = _port_net(_jax_params(), "float32")
    obs = _t(_obs(rng, 2, 6, 1))
    resets = torch.zeros((2, 6), dtype=torch.bool)
    resets[0, 3] = resets[1, 1] = True
    noise = _port_noise(_noise(rng))
    state = net.initial_state(2)
    with torch.no_grad():
        q_full, (c_full, h_full) = net(obs, state, resets, noise=noise)
        qs = []
        for t in range(6):
            q_t, state = net(obs[:, t:t + 1], state, resets[:, t:t + 1], noise=noise)
            qs.append(q_t[:, 0])
    _close(torch.stack(qs, 1).numpy(), q_full.numpy(), FP32, "q")
    _close(state[0].numpy(), c_full.numpy(), FP32, "c")
    _close(state[1].numpy(), h_full.numpy(), FP32, "h")
    # a reset cuts the memory: what came before it changes nothing after it
    obs2 = obs.clone()
    obs2[0, :3] = 0
    with torch.no_grad():
        q2, _ = net(obs2, net.initial_state(2), resets, noise=noise)
    assert not torch.allclose(q2[0, 2], q_full[0, 2])
    _close(q2[0, 3:].numpy(), q_full[0, 3:].numpy(), FP32, "after the reset")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_step_matches_jax(monkeypatch, dtype):
    jdt, _ = DT[dtype]
    jcfg, pcfg = _cfgs(dtype, history_length=1)
    params = _jax_params()
    rng = np.random.default_rng(7)
    obs = rng.integers(0, 256, (5, *FRAME, 1), dtype=np.uint8)
    c0, h0 = (rng.standard_normal((5, LSTM)).astype(np.float32) * 0.5 for _ in range(2))
    noise = _noise(rng)
    _inject(monkeypatch, _flat(noise))
    a_ref, q_ref, (c_ref, h_ref) = jr2d2.build_r2d2_act_step(jcfg, A)(
        params, jnp.asarray(obs), (jnp.asarray(c0), jnp.asarray(h0)), jax.random.PRNGKey(0))
    net = _port_net(params, dtype)
    a, q, (c, h) = pr2d2.build_r2d2_act_step(pcfg, A)(net, _t(obs), (_t(c0), _t(h0)), None,
                                                     noise=_port_noise(noise))
    tol = FP32 if dtype == "float32" else BF16_OUT
    _close(c.numpy(), c_ref, tol, "c")
    _close(h.numpy(), h_ref, tol, "h")
    _close(q.numpy(), q_ref, tol, "q")
    top2 = np.sort(np.asarray(q_ref), axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > (1e-5 if dtype == "float32" else 6e-2)
    np.testing.assert_array_equal(a.numpy()[clear], np.asarray(a_ref)[clear])
    assert a.dtype == torch.int32
    with pytest.raises(ValueError):
        pr2d2.as_actor_input(np.zeros((2, *FRAME, 2), np.uint8), 1)
    assert pr2d2.as_actor_input(np.zeros((2, *FRAME), np.uint8), 1).shape == (2, *FRAME, 1)


# -------------------------------------------------------------- learn step
def _batch(seed, history=1, batch=B):
    """Sequences with a terminal that ends the valid region (0), a time-limit
    cut (1, done never set), full ones, and a terminal mid-sequence that
    leaves the rest valid (3: plants a reset inside both the burn-in and the
    train unroll)."""
    rng = np.random.default_rng(seed)
    done = np.zeros((batch, L), bool)
    valid = np.ones((batch, L), bool)
    done[0, 8] = True
    valid[0, 9:] = False
    valid[1, 10:] = False
    done[3, 2] = done[3, 6] = True
    return dict(
        obs=_obs(rng, batch, L, 1),
        action=rng.integers(0, A, (batch, L)).astype(np.int32),
        reward=rng.normal(size=(batch, L)).astype(np.float32),
        done=done, valid=valid,
        init_c=(rng.standard_normal((batch, LSTM)) * 0.5).astype(np.float32),
        init_h=(rng.standard_normal((batch, LSTM)) * 0.5).astype(np.float32),
        weight=rng.uniform(0.5, 1.5, batch).astype(np.float32),
    )


def _jbatch(b):
    return jr2d2.SequenceBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _pbatch(b):
    return pr2d2.SequenceBatch(**{k: _t(v) for k, v in b.items()})


def _adam(opt_state):
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


@functools.lru_cache(maxsize=None)
def _warm_jax_state(history: int = 2):
    """A JAX R2D2TrainState two fp32 learn steps in (random noise, no
    target copy): Adam moments and count non-zero.  Cached; read-only."""
    jcfg, _ = _cfgs("float32", history_length=history)
    state = jr2d2.init_r2d2_state(jcfg, A, jax.random.PRNGKey(0), FRAME)
    step = jax.jit(jr2d2.build_r2d2_learn_step(jcfg, A))
    for k in range(2):
        state, _ = step(state, _jbatch(_batch(20 + k)), jax.random.PRNGKey(100 + k))
    return state


def _port_state(pcfg, jstate):
    st = pr2d2.init_r2d2_state(pcfg, A, 0, FRAME, device="cpu")
    adam = _adam(jstate.opt_state)
    host = convert.from_flax_train_state(_np(jstate.params), _np(jstate.target_params),
                                         _np(adam.mu), _np(adam.nu), adam.count, jstate.step)
    return load_host_state(st, host)


def _jax_step(jcfg, queue):
    """The JAX learn step compiled once: a step's normals go in as
    arguments and the fake ``jax.random.normal`` hands them out while it
    traces (burn-in draws included: that head is dead code in the graph)."""
    step = jr2d2.build_r2d2_learn_step(jcfg, A)

    def run(state, batch, key, normals):
        queue[:] = list(normals)
        out = step(state, batch, key)
        assert not queue  # every apply drew exactly once
        return out

    return jax.jit(run)


def _step_draws(seed):
    rng = np.random.default_rng(seed)
    online, target = _noise(rng), _noise(rng)
    dead = [np.zeros_like(a) for a in _flat(online)]  # the burn-in heads' draws
    normals = dead + _flat(online) + dead + _flat(target)
    return normals, {"online": _port_noise(online), "target": _port_noise(target)}


def _compare_states(pstate, jstate, tol):
    want = convert.to_flax_train_state(host_state(pstate))
    adam = _adam(jstate.opt_state)
    assert int(want["step"]) == int(jstate.step) and int(want["count"]) == int(adam.count)
    for key, ref in (("params", jstate.params), ("target_params", jstate.target_params),
                     ("mu", adam.mu), ("nu", adam.nu)):
        flat_w = jax.tree_util.tree_flatten_with_path(_np(ref))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(want[key])[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            _close(g, w, tol, f"{key} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("steps,period", [(1, 10), (3, 2)], ids=["one_step", "three_steps_copy"])
def test_learn_steps_match_jax(monkeypatch, steps, period):
    """From the same converted state, fp32, history 2 (frames stacked in the
    step): every step's loss, priorities, q_mean and grad_norm, then params,
    target params (a copy on step 4 with period 2) and the Adam state."""
    jcfg, pcfg = _cfgs(target_update_period=period)
    jstate = _warm_jax_state()
    pstate = _port_state(pcfg, jstate)
    queue = _inject(monkeypatch, [])
    jstep = _jax_step(jcfg, queue)
    pstep = pr2d2.build_r2d2_learn_step(pcfg, A)
    for k in range(steps):
        b = _batch(60 + k)
        normals, draws = _step_draws(40 + k)
        jstate, jinfo = jstep(jstate, _jbatch(b), jax.random.PRNGKey(7), normals)
        pstate, pinfo = pstep(pstate, _pbatch(b), draws=draws)
        for key in ("loss", "priorities", "q_mean", "grad_norm"):
            _close(pinfo[key].numpy(), jinfo[key], STEP_INFO, f"step {k} {key}")
        assert bool(pinfo["finite"]) and bool(jinfo["finite"])
        assert float(pinfo["loss"]) > 0
    assert pstate.step == int(jstate.step)
    _compare_states(pstate, jstate, STEP_STATE)


def test_bf16_learn_step_matches_jax(monkeypatch):
    jcfg, pcfg = _cfgs("bfloat16")
    jstate = _warm_jax_state()
    pstate = _port_state(pcfg, jstate)
    jstep = _jax_step(jcfg, _inject(monkeypatch, []))
    b = _batch(3)
    normals, draws = _step_draws(77)
    jstate, jinfo = jstep(jstate, _jbatch(b), jax.random.PRNGKey(1), normals)
    pstate, pinfo = pr2d2.build_r2d2_learn_step(pcfg, A)(pstate, _pbatch(b), draws=draws)
    for key in ("loss", "priorities", "q_mean"):
        _close(pinfo[key].numpy(), jinfo[key], dict(rtol=2e-2, atol=3e-2), key)
    _close(pinfo["grad_norm"].numpy(), jinfo["grad_norm"], dict(rtol=2 ** -6, atol=0), "grad_norm")


def test_burn_in_below_history_is_refused():
    _, pcfg = _cfgs(history_length=4, r2d2_burn_in=2)
    with pytest.raises(ValueError, match="r2d2_burn_in"):
        pr2d2.build_r2d2_learn_step(pcfg, A)


@functools.lru_cache(maxsize=None)
def _fresh_state_host():
    _, pcfg = _cfgs(history_length=1)
    return host_state(pr2d2.init_r2d2_state(pcfg, A, 0, FRAME, device="cpu"))


def _masked_step(valid, done=None, seed=11):
    """tests/test_r2d2.py's masking scenarios on the port: one step from a
    fresh history-1 state on a batch with only ``valid`` / ``done`` set."""
    _, pcfg = _cfgs(history_length=1)
    state = load_host_state(pr2d2.init_r2d2_state(pcfg, A, 0, FRAME, device="cpu"),
                            _fresh_state_host())
    b = _batch(seed)
    b["valid"] = valid
    b["done"] = np.zeros((B, L), bool) if done is None else done
    _, info = pr2d2.build_r2d2_learn_step(pcfg, A)(state, _pbatch(b),
                                                   torch.Generator().manual_seed(seed))
    return float(info["loss"]), info["priorities"].numpy()


@pytest.mark.parametrize("case", ["all_invalid", "truncation", "terminal", "inside_cut"])
def test_masking_cases_of_the_jax_tests_hold(case):
    """tests/test_r2d2.py:289-345: invalid steps contribute nothing; a
    truncation never teaches V=0 (windows crossing the cut are masked, the
    same region ended by a terminal trains); steps whose window ends inside
    a later cut train."""
    if case == "all_invalid":
        loss, pri = _masked_step(np.zeros((B, L), bool))
        assert loss == pytest.approx(0.0, abs=1e-7) and np.allclose(pri, 0.0, atol=1e-7)
    elif case in ("truncation", "terminal"):
        valid = np.zeros((B, L), bool)
        valid[:, :6] = True
        done = None
        if case == "terminal":
            done = np.zeros((B, L), bool)
            done[:, 5] = True
        loss, pri = _masked_step(valid, done)
        if case == "truncation":
            assert loss == pytest.approx(0.0, abs=1e-7) and np.allclose(pri, 0.0, atol=1e-7)
        else:
            assert loss > 0.0 and pri.max() > 0.0
    else:
        valid = np.zeros((B, L), bool)
        valid[:, :7] = True
        loss, _ = _masked_step(valid)
        assert loss > 0.0


# ------------------------------------------------------------------ replay
def _seq_tick(mems, t, terminal=False, truncated=False, lanes=1):
    f = np.full((lanes, 4, 4), t % 256, np.uint8)
    for mem in mems:
        mem.append_batch(f, np.full(lanes, t, np.int32), np.full(lanes, float(t), np.float32),
                         np.full(lanes, terminal, bool), np.full((lanes, 6), 10.0 * t, np.float32),
                         np.full((lanes, 6), -10.0 * t, np.float32),
                         truncations=np.full(lanes, truncated, bool))


def _assert_same_samples(port, ref, batch, beta):
    s, r = port.sample(batch, beta), ref.sample(batch, beta)
    for field in ("idx", "obs", "action", "reward", "done", "valid", "init_c", "init_h", "weight",
                  "prob"):
        np.testing.assert_array_equal(getattr(s, field), getattr(r, field), err_msg=field)
    return s


@pytest.mark.parametrize("case", ["emission_overlap", "terminal_flush", "truncation",
                                  "priorities_and_snapshot"])
def test_sequence_replay_matches_jax(case, tmp_path):
    """The port's copy of SequenceReplay against the JAX package's on the
    same ticks: lengths, every sampled field and, for the cases of
    tests/test_r2d2.py, their expectations on the port."""
    kw = dict(lstm_size=6, lanes=2, stride=4, seed=3, priority_exponent=1.0)
    port, ref = SequenceReplay(32, 8, (4, 4), **kw), JaxSequenceReplay(32, 8, (4, 4), **kw)
    mems = (port, ref)
    if case == "emission_overlap":
        for t in range(16):
            _seq_tick(mems, t, lanes=2)
        assert len(port) == len(ref) == 6  # emits at t = 7, 11, 15 on each lane
        s = _assert_same_samples(port, ref, 8, 1.0)
        i1 = np.flatnonzero(s.idx == 2)  # lane 0's second window: steps 4..11, state from t = 4
        if i1.size:
            np.testing.assert_array_equal(s.action[i1[0]], np.arange(4, 12))
            np.testing.assert_allclose(s.init_c[i1[0]], 40.0)
    elif case in ("terminal_flush", "truncation"):
        for t in range(5):
            _seq_tick(mems, t, lanes=2, terminal=(case == "terminal_flush" and t == 4),
                      truncated=(case == "truncation" and t == 4))
        assert len(port) == len(ref) == 2
        s = _assert_same_samples(port, ref, 4, 1.0)
        assert s.valid[:, :5].all() and not s.valid[:, 5:].any()
        assert s.done[:, 4].all() == (case == "terminal_flush") and not s.done[:, :4].any()
        for t in range(8):
            _seq_tick(mems, 100 + t, lanes=2)
        assert len(port) == len(ref) == 4
        s = _assert_same_samples(port, ref, 8, 1.0)
        i = np.flatnonzero(s.idx == 2)
        if i.size:  # a fresh window after the cut
            np.testing.assert_array_equal(s.action[i[0]], np.arange(100, 108))
    else:
        for t in range(20):
            _seq_tick(mems, t, lanes=2, terminal=(t == 13))
        s = _assert_same_samples(port, ref, 4, 0.5)
        for mem in mems:
            mem.update_priorities(s.idx[:2], np.array([100.0, 0.5]))
        _assert_same_samples(port, ref, 8, 0.5)
        port.snapshot(str(tmp_path / "seq"))
        back = SequenceReplay(32, 8, (4, 4), **kw)
        back.restore(str(tmp_path / "seq"))
        assert len(back) == len(port) and back.pos == port.pos
        np.testing.assert_array_equal(back.tree.tree, port.tree.tree)
        for t in range(20, 26):  # the builder windows were restored too
            _seq_tick((back, port), t, lanes=2)
        np.testing.assert_array_equal(back.frames, port.frames)
        np.testing.assert_array_equal(back.init_h, port.init_h)


# ----------------------------------------------------------------- convert
def test_r2d2_train_state_round_trip_is_exact():
    jstate = _warm_jax_state()
    adam = _adam(jstate.opt_state)
    assert int(adam.count) == 2 and np.any(np.asarray(adam.mu["lstm"]["cell"]["hi"]["kernel"]))
    _, pcfg = _cfgs()
    pstate = _port_state(pcfg, jstate)
    names = dict(pstate.net.named_parameters())
    np.testing.assert_array_equal(
        names["lstm.w_h"].detach().numpy()[:, LSTM:2 * LSTM],
        np.asarray(jstate.params["lstm"]["cell"]["hf"]["kernel"]))
    np.testing.assert_array_equal(
        pstate.optimizer.state[names["lstm.w_i"]]["exp_avg"].numpy()[:, 3 * LSTM:],
        np.asarray(adam.mu["lstm"]["cell"]["io"]["kernel"]))
    back = convert.to_flax_train_state(host_state(pstate))
    assert int(back["step"]) == int(jstate.step) and int(back["count"]) == int(adam.count)
    for key, ref in (("params", jstate.params), ("target_params", jstate.target_params),
                     ("mu", adam.mu), ("nu", adam.nu)):
        flat_w = jax.tree_util.tree_flatten_with_path(_np(ref))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(back[key])[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            np.testing.assert_array_equal(g, w, err_msg=f"{key} {path}")


def test_port_init_has_the_jax_distributions():
    """Fresh port params: the LSTM's recurrent kernels orthogonal per gate,
    input kernels of variance ~1/F, zero biases; shapes as the JAX tree's."""
    _, pcfg = _cfgs()
    net = pr2d2.init_r2d2_state(pcfg, A, 0, FRAME, device="cpu").net
    want = convert.from_flax(_jax_params(channels=2))
    got = net.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                          for k, v in want.items()}
    for gate in net.lstm.w_h.detach().split(LSTM, dim=1):
        _close((gate.t() @ gate).numpy(), np.eye(LSTM), dict(rtol=0, atol=1e-5), "orthogonal")
    assert not net.lstm.b.detach().any()
    feat = net.lstm.w_i.shape[0]
    assert abs(float(net.lstm.w_i.detach().var()) * feat - 1.0) < 0.1


# --------------------------------------------------------------- the loop
def _loop_cfg(tmp_path, **kw):
    base = dict(env_id="toy:catch", compute_dtype="float32", history_length=1,
                hidden_size=16, lstm_size=16, r2d2_burn_in=2, r2d2_seq_len=6, r2d2_overlap=2,
                multi_step=2, gamma=0.9, batch_size=4, learning_rate=2e-3,
                target_update_period=20, memory_capacity=1200, learn_start=80,
                frames_per_learn=1, num_envs_per_actor=4, metrics_interval=5,
                eval_interval=0, checkpoint_interval=0, eval_episodes=2, role="single",
                architecture="r2d2", results_dir=str(tmp_path / "results"),
                checkpoint_dir=str(tmp_path / "ckpt"), seed=3)
    base.update(kw)
    return Config(**base)


def _rows(cfg):
    with open(os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_r2d2_then_resumes_and_continues(tmp_path):
    """``train`` routes --architecture r2d2 to train_r2d2: a short run writes
    learn rows, a checkpoint at its last step (the full learner state with
    Adam) and a sequence-replay snapshot; a resumed run starts from that
    step, frame count, replay and generator state and continues."""
    cfg = _loop_cfg(tmp_path, snapshot_replay=True, checkpoint_interval=10)
    s1 = train(cfg, max_frames=200, device="cpu")
    assert s1["frames"] == 200 and s1["learn_steps"] > 10 and s1["sequences"] > 8
    assert np.isfinite(s1["eval_score_mean"])
    assert any(r["kind"] == "learn" and np.isfinite(r["loss"]) for r in _rows(cfg))
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    host, extra = ckpt.restore()
    assert host["step"] == s1["learn_steps"] == ckpt.latest_step()
    assert host["adam"]["count"] == s1["learn_steps"] and "lstm.w_h" in host["adam"]["mu"]
    assert extra["frames"] == 200 and "rng_state" in extra

    s2 = train(cfg.replace(resume=True), max_frames=260, device="cpu")
    resumed = [r for r in _rows(cfg) if r["kind"] == "resume"]
    assert resumed and resumed[0]["step"] == s1["learn_steps"] and resumed[0]["frames"] == 200
    assert s2["learn_steps"] > s1["learn_steps"] and s2["sequences"] > s1["sequences"]


@pytest.mark.parametrize("kw,err", [(dict(role="anakin", env_id="jaxgame:catch", fused_env=True),
                                     NotImplementedError),
                                    (dict(role="apex"), NotImplementedError),
                                    (dict(replay_ratio=2), ValueError)],
                         ids=["anakin", "apex", "reuse"])
def test_unported_r2d2_options_raise(tmp_path, kw, err):
    with pytest.raises(err):
        train(_loop_cfg(tmp_path, **kw), max_frames=8, device="cpu")


def test_r2d2_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_loop_cfg(tmp_path), max_frames=8)
