"""K4's heads mode (``dueling_learn``): the learn step's three heads in one
launch, held against the JAX learn step on the CPU through its plain twin.

The JAX side runs ``rainbow_iqn_apex_tpu/ops/learn.py:125-152`` (and the
multi-game loss of ``multitask/ops.py:101-140``) as the package writes it:
three ``net.apply`` calls, the (masked) greedy a*, the two
``take_along_axis`` gathers and td_target, with the taus and noise of each
forward injected by monkeypatching ``jax.random.uniform`` / ``normal`` in
call order (numpy draws from a seed).  The port takes the same draws
through each network's ``heads`` and hands the three heads to
``dueling_learn_plain``.

Tolerances: a* equal; z_next, td_target, z_online and on_q 1e-5 (fp32,
summation order only); the loss, priorities and each gradient tensor those
of ``tests/test_torch_learn.py``: STEP_INFO (rtol 1e-5, atol 1e-6) for the
loss and priorities, FP32 (rtol / atol 1e-5) for the gradients of the
module tests, here over the whole network.  Cases: single-game, masked
multi-game, and a reuse pass (the IS weights scaled by a clipped ratio).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.models.iqn import greedy_action as jax_greedy_action
from rainbow_iqn_apex_tpu.multitask import model as jmodel
from rainbow_iqn_apex_tpu.multitask import ops as jops
from rainbow_iqn_apex_tpu.multitask.spec import MultiGameSpec as JaxSpec
from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu.ops.losses import quantile_huber_loss as jax_quantile_huber_loss
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels import launches
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
    dueling_head_plain,
    dueling_learn,
    dueling_learn_plain,
)
from rainbow_iqn_apex_tpu_torch.multitask import ops as pops
from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn

A = 3
B = 4
SHAPE = (44, 44, 2)
FP32 = dict(rtol=1e-5, atol=1e-5)
STEP_INFO = dict(rtol=1e-5, atol=1e-6)
NOISY = ("value_hidden", "value_out", "advantage_hidden", "advantage_out")
SPEC3 = MultiGameSpec(games=("a", "b", "c"), num_actions=(5, 3, 4), frame_shape=(44, 44))


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=what, **tol)


def _cfgs(**kw):
    base = dict(compute_dtype="float32", frame_height=SHAPE[0], frame_width=SHAPE[1],
                history_length=SHAPE[2], hidden_size=32, num_cosines=16, num_tau_samples=8,
                num_tau_prime_samples=6, num_quantile_samples=4, batch_size=B)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _inject(monkeypatch, uniforms, normals):
    """jax.random.uniform hands out ``uniforms`` (the taus: U[0, 1)) and
    jax.random.normal ``normals`` in call order; other uniform draws (flax's
    initialiser shape check) go to the real function."""
    uq, nq = list(uniforms), list(normals)
    real_uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if (minval, maxval) != (0.0, 1.0):
            return real_uniform(key, shape, dtype, minval, maxval)
        arr = uq.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr, dtype)

    def fake_normal(key, shape=(), dtype=jnp.float32):
        arr = nq.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr, dtype)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jax.random, "normal", fake_normal)
    return uq, nq


def _draws(cfg, feat, actions, seed):
    """taus and per-layer noise of the select, target and online forwards."""
    rng = np.random.default_rng(seed)
    dims = [(feat, cfg.hidden_size), (cfg.hidden_size, 1), (feat, cfg.hidden_size),
            (cfg.hidden_size, actions)]
    out = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        out[name] = (rng.random((B, n), dtype=np.float32),
                     {layer: (rng.standard_normal(i).astype(np.float32),
                              rng.standard_normal(o).astype(np.float32))
                      for layer, (i, o) in zip(NOISY, dims)})
    return out


def _flat(draws):
    uniforms, normals = [], []
    for name in ("select", "target", "online"):
        taus, noise = draws[name]
        uniforms.append(taus)
        normals += [a for layer in NOISY for a in noise[layer]]
    return uniforms, normals


def _port_draw(draw):
    taus, noise = draw
    return _t(taus), {k: (_t(a), _t(b)) for k, (a, b) in noise.items()}


def _batch(seed, game=None, counts=None):
    rng = np.random.default_rng(seed)
    if game is None:
        action = rng.integers(0, A, B).astype(np.int32)
    else:
        action = np.asarray([rng.integers(0, counts[g]) for g in game], np.int32)
    out = dict(obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8), action=action,
               reward=rng.normal(size=B).astype(np.float32),
               next_obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
               discount=np.array([0.9, 0.9, 0.0, 0.81], np.float32),
               weight=rng.uniform(0.5, 1.5, B).astype(np.float32))
    if game is not None:
        out["game"] = np.asarray(game, np.int32)
    return out


def _jitter(tree, seed):
    """A copy of a params tree moved off it (a target net that is not the
    online net)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + rng.normal(0, 0.02, np.shape(x)).astype(np.asarray(x).dtype)), tree)


# ------------------------------------------------------------ JAX side
@functools.lru_cache(maxsize=None)
def _jax_single():
    jcfg, _ = _cfgs()
    params = jlearn.init_train_state(jcfg, A, jax.random.PRNGKey(0), state_shape=SHAPE).params
    return params, _jitter(params, 1)


@functools.lru_cache(maxsize=None)
def _jax_multi():
    jcfg, _ = _cfgs()
    jspec = JaxSpec(games=SPEC3.games, num_actions=SPEC3.num_actions, frame_shape=SPEC3.frame_shape)
    params = jops.init_mt_train_state(jcfg, jspec, jax.random.PRNGKey(0)).params
    emb = np.random.default_rng(2).normal(0, 0.3, np.shape(params["game_embed"]["embedding"]))
    params = {**params, "game_embed": {"embedding": jnp.asarray(emb, jnp.float32)}}
    # the pad slot 4 (no action of games 1 and 2) favoured, so the mask decides a*
    adv_out = dict(params["advantage_out"])
    adv_out["b_mu"] = jnp.asarray(adv_out["b_mu"]).at[4].add(5.0)
    params = {**params, "advantage_out": adv_out}
    return params, _jitter(params, 3), jspec


def _jax_heads_and_loss(jcfg, params, target_params, batch, weight_scale, multi):
    """loss_and_priorities of the JAX package written out (single-game
    ops/learn.py:125-160, multi-game multitask/ops.py:101-140): returns the
    heads' outputs, the loss, priorities and d loss / d params."""
    if multi:
        jspec = _jax_multi()[2]
        net = jops.make_mt_network(jcfg, jspec)
        table = jnp.asarray(jops.action_mask_table(jspec))
        game = jnp.asarray(batch["game"])

        def apply(p, obs, n):
            return net.apply({"params": p}, obs, game, n,
                             rngs={"taus": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)})

        def greedy(q):
            return jmodel.masked_greedy_action(q, game, table)
    else:
        net = jlearn.make_network(jcfg, A)

        def apply(p, obs, n):
            return net.apply({"params": p}, obs, n,
                             rngs={"taus": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)})

        greedy = jax_greedy_action
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        sel_q, _ = apply(p, jb["next_obs"], jcfg.num_quantile_samples)
        a_star = greedy(sel_q)
        tgt_q, _ = apply(target_params, jb["next_obs"], jcfg.num_tau_prime_samples)
        z_next = jnp.take_along_axis(tgt_q, a_star[:, None, None], axis=-1)[..., 0]
        td_target = jax.lax.stop_gradient(jb["reward"][:, None] + jb["discount"][:, None] * z_next)
        on_q, taus = apply(p, jb["obs"], jcfg.num_tau_samples)
        z_online = jnp.take_along_axis(on_q, jb["action"][:, None, None], axis=-1)[..., 0]
        per_sample, td_abs = jax_quantile_huber_loss(z_online, taus, td_target, jcfg.kappa)
        weight = jb["weight"] if weight_scale is None else jb["weight"] * jnp.asarray(weight_scale)
        return jnp.mean(weight * per_sample), (a_star, z_next, td_target, z_online,
                                               on_q.mean(axis=1), td_abs)

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return loss, aux, grads


# ------------------------------------------------------------ the cases
def _port_state(pcfg, params, target_params, multi):
    if multi:
        st = pops.init_mt_train_state(pcfg, SPEC3, seed=0, device="cpu")
    else:
        st = plearn.init_train_state(pcfg, A, seed=0, state_shape=SHAPE, device="cpu")
    with torch.no_grad():
        st.net.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
        st.target.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, target_params)))
    return st


@pytest.mark.parametrize("case", ["single", "multi", "reuse_pass"])
def test_heads_twin_and_loss_match_the_jax_learn_step(monkeypatch, case):
    multi = case == "multi"
    jcfg, pcfg = _cfgs()
    params, target_params = (_jax_multi() if multi else _jax_single())[:2]
    actions = SPEC3.max_actions if multi else A
    feat = np.shape(params["CosineTauEmbedding_0"]["embed"]["kernel"])[1]
    draws = _draws(pcfg, feat, actions, seed={"single": 5, "multi": 6, "reuse_pass": 7}[case])
    game = [0, 1, 2, 1] if multi else None
    batch = _batch(11, game, SPEC3.num_actions if multi else None)
    scale = None
    if case == "reuse_pass":  # passes 2..K scale the IS weights by the clipped ratio
        scale = np.asarray([1.2, 0.8, 1.0, 0.95], np.float32)
    uq, nq = _inject(monkeypatch, *_flat(draws))
    loss, (a_star, z_next, td_target, z_online, on_q, td_abs), grads = _jax_heads_and_loss(
        jcfg, params, target_params, batch, scale, multi)
    assert not uq and not nq  # every JAX forward drew exactly once
    st = _port_state(pcfg, params, target_params, multi)
    pb = plearn.Batch(**{k: _t(v) for k, v in batch.items()})
    pgame = pb.game
    def head(net, obs, name, n):
        taus, noise = _port_draw(draws[name])
        return (*net.heads(obs, n, taus=taus, noise=noise, game=pgame)[:2], n)

    with torch.no_grad():
        select = head(st.net, pb.next_obs, "select", pcfg.num_quantile_samples)
        target = head(st.target, pb.next_obs, "target", pcfg.num_tau_prime_samples)
        online = head(st.net, pb.obs, "online", pcfg.num_tau_samples)
    margs = st.net.mask_args(pgame) if multi else ()
    before = dict(launches)
    got = dueling_learn(select, target, online, pb.action, pb.reward, pb.discount, *margs)
    want = dueling_learn_plain(select, target, online, pb.action, pb.reward, pb.discount, *margs)
    assert dict(launches) == before  # the CPU runs the twin, and counts nothing
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    p_z_online, p_on_q, p_a_star, p_z_next, p_td = got
    np.testing.assert_array_equal(p_a_star.numpy(), np.asarray(a_star))
    if multi:  # inside each row's game, where unmasked a row would pick a pad slot
        assert all(int(a) < SPEC3.num_actions[g] for a, g in zip(p_a_star, game))
        unmasked = dueling_head_plain(*select)[2]
        assert any(int(a) >= SPEC3.num_actions[g] for a, g in zip(unmasked, game))
    _close(p_z_next.numpy(), z_next, FP32, "z_next")
    _close(p_td.numpy(), td_target, FP32, "td_target")
    _close(p_z_online.numpy(), z_online, FP32, "z_online")
    _close(p_on_q.numpy(), on_q, FP32, "on_q")
    # the whole loss through the heads launch's autograd function
    p_loss, p_aux = plearn.loss_and_priorities(
        pcfg, st, pb, draws={k: _port_draw(v) for k, v in draws.items()},
        weight_scale=None if scale is None else _t(scale))
    _close(p_loss.item(), loss, STEP_INFO, "loss")
    _close(p_aux["td_abs"].numpy(), td_abs, STEP_INFO, "priorities")
    names = [n for n, _ in st.net.named_parameters()]
    p_grads = torch.autograd.grad(p_loss, [p for _, p in st.net.named_parameters()])
    want_tree = convert.from_flax(jax.tree.map(np.asarray, grads))
    assert sorted(want_tree) == sorted(names)
    for name, g in zip(names, p_grads):
        _close(g.numpy(), want_tree[name].numpy(), FP32, f"d loss / d {name}")
