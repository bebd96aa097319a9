"""The learn step's loss chain (``kernels/learn_loss.py``: K4's heads mode,
K1's weighted mode and K4-bwd's loss mode in one autograd function) against
the JAX package on the CPU, where each step runs its plain twin.

The JAX side composes ``rainbow_iqn_apex_tpu/ops/learn.py:125-162`` from the
heads on: the dueling combine of ``models/iqn.py:94-101`` (the advantage
alone without dueling), the (masked) greedy a* of the select head, the two
``take_along_axis`` gathers, td_target under ``stop_gradient``, the
package's own ``quantile_huber_loss`` and ``jnp.mean`` of the IS-weighted
per-sample losses (``weight * weight_scale`` formed first), differentiated
by ``jax.grad`` in the online head's value and advantage.  Both sides take
the same numpy draws from a seed.

Tolerances: 1e-5 abs / rel in fp32 (summation order only) for the loss,
per_sample, td_abs, on_q, z_next and both gradients; against the parent's
route (the heads' twin, ``QuantileHuberFn``, the product and ``torch.mean``
through torch's autograd) 1e-6, one product's rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.models.iqn import greedy_action as jax_greedy_action
from rainbow_iqn_apex_tpu.multitask.model import masked_greedy_action as jax_masked_greedy
from rainbow_iqn_apex_tpu.ops.losses import quantile_huber_loss as jax_quantile_huber_loss
from rainbow_iqn_apex_tpu_torch.kernels import launches
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
    dueling_learn_plain,
    dueling_loss_bwd,
    dueling_loss_bwd_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.learn_loss import learn_loss
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import (
    QuantileHuberFn,
    quantile_huber_weighted,
    quantile_huber_weighted_plain,
)

FP32 = dict(rtol=1e-5, atol=1e-5)
ROUTE = dict(rtol=1e-6, atol=1e-6)
K, N_PRIME, N = 4, 6, 8  # select, target and online taus: small N
COUNTS = (5, 3, 4)  # the masked multi-game case: three games' action counts, A 5


def _inputs(seed, batch, actions, dueling, scaled, multi=False):
    r = np.random.default_rng(seed)

    def head(taus):
        v = r.standard_normal((batch * taus, 1)).astype(np.float32) if dueling else None
        return v, r.standard_normal((batch * taus, actions)).astype(np.float32), taus

    out = dict(select=head(K), target=head(N_PRIME), online=head(N),
               take=r.integers(0, actions, batch).astype(np.int32),
               reward=r.standard_normal(batch).astype(np.float32),
               discount=np.where(r.random(batch) < 0.2, 0.0, 0.97).astype(np.float32),
               taus=r.random((batch, N), dtype=np.float32),
               weight=r.uniform(0.2, 1.5, batch).astype(np.float32),
               scale=r.uniform(0.5, 2.0, batch).astype(np.float32) if scaled else None,
               game=None, mask=None)
    if multi:
        out["game"] = (np.arange(batch) % len(COUNTS)).astype(np.int32)
        out["mask"] = np.arange(actions)[None, :] < np.asarray(COUNTS)[:, None]
        out["take"] = np.asarray([r.integers(0, COUNTS[g]) for g in out["game"]], np.int32)
        # favour each row's out-of-game slots, so the mask decides a*
        sel_v, sel_a, _ = out["select"]
        sel_a.reshape(batch, K, actions)[:, :, actions - 1] += 3.0
    return out


def _jax_chain(inp, kappa, cotangent):
    """(loss, per_sample, td_abs, on_q [B, A], z_next, d value, d adv) of
    ``cotangent * loss`` as the JAX learn step composes it."""
    batch = inp["take"].shape[0]

    def combine(v, a, taus):
        q = a if v is None else v + a - a.mean(axis=-1, keepdims=True)
        return q.reshape(batch, taus, a.shape[-1]).astype(jnp.float32)

    sel_v, sel_a, _ = inp["select"]
    sel_q = combine(sel_v, jnp.asarray(sel_a), K)
    if inp["game"] is None:
        a_star = jax_greedy_action(sel_q)
    else:
        a_star = jax_masked_greedy(sel_q, jnp.asarray(inp["game"]), jnp.asarray(inp["mask"]))
    tgt_v, tgt_a, _ = inp["target"]
    tgt_q = combine(tgt_v, jnp.asarray(tgt_a), N_PRIME)
    z_next = jnp.take_along_axis(tgt_q, a_star[:, None, None], axis=-1)[..., 0]
    td_target = jax.lax.stop_gradient(
        jnp.asarray(inp["reward"])[:, None] + jnp.asarray(inp["discount"])[:, None] * z_next)
    on_v, on_a, _ = inp["online"]
    dueling = on_v is not None

    def loss_fn(v, a):
        on_q = combine(v if dueling else None, a, N)
        z_online = jnp.take_along_axis(on_q, jnp.asarray(inp["take"])[:, None, None],
                                       axis=-1)[..., 0]
        per_sample, td_abs = jax_quantile_huber_loss(z_online, jnp.asarray(inp["taus"]),
                                                     td_target, kappa)
        weight = jnp.asarray(inp["weight"])
        if inp["scale"] is not None:
            weight = weight * jnp.asarray(inp["scale"])
        loss = jnp.mean(weight * per_sample)
        return cotangent * loss, (loss, per_sample, td_abs, on_q.mean(axis=1))

    v0 = jnp.asarray(on_v) if dueling else jnp.zeros((1,), jnp.float32)
    (_, (loss, per_sample, td_abs, on_q)), (d_v, d_a) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(v0, jnp.asarray(on_a))
    return loss, per_sample, td_abs, on_q, z_next, (d_v if dueling else None), d_a


def _t(a, grad=False):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _port_args(inp):
    def head(h, grad=False):
        return _t(h[0], grad), _t(h[1], grad), h[2]

    online = head(inp["online"], grad=True)
    rest = (_t(inp["take"]), head(inp["select"]), head(inp["target"]), _t(inp["reward"]),
            _t(inp["discount"]), _t(inp["taus"]), _t(inp["weight"]), _t(inp["scale"]))
    margs = (None, None) if inp["game"] is None else (_t(inp["game"]), _t(inp["mask"]))
    return online, rest, margs


def _port_chain(inp, kappa, cotangent):
    online, (take, select, target, reward, discount, taus, weight, scale), margs = \
        _port_args(inp)
    loss, per_sample, td_abs, on_q, z_next = learn_loss(
        online, take, select, target, reward, discount, taus, weight, scale, kappa, *margs)
    leaves = [t for t in online[:2] if t is not None]
    out = loss if cotangent == 1.0 else cotangent * loss
    grads = torch.autograd.grad(out, leaves)
    d_v, d_a = (None, grads[0]) if online[0] is None else grads
    return loss, per_sample, td_abs, on_q, z_next, d_v, d_a


def _parent_route(inp, kappa):
    """The chain as the learn step ran it before K1's weighted mode: the
    heads' twin, QuantileHuberFn, the product and torch.mean, differentiated
    by torch's autograd."""
    online, (take, select, target, reward, discount, taus, weight, scale), margs = \
        _port_args(inp)
    z_online, on_q, _, z_next, td_target = dueling_learn_plain(
        select, target, online, take, reward, discount, *margs)
    per_sample, td_abs = QuantileHuberFn.apply(z_online, taus, td_target.detach(), kappa)
    w = weight if scale is None else weight * scale
    loss = torch.mean(w * per_sample)
    leaves = [t for t in online[:2] if t is not None]
    grads = torch.autograd.grad(loss, leaves)
    return loss, per_sample, td_abs, *((None, grads[0]) if online[0] is None else grads)


def _close(got, want, tol, what):
    if want is None:
        assert got is None, what
        return
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got,
                                          np.float64),
                               np.asarray(want, np.float64), err_msg=what, **tol)


NAMES = ("loss", "per_sample", "td_abs", "on_q", "z_next", "d value", "d adv")


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("kappa", [1.0, 0.5])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dueling", [True, False])
def test_loss_chain_matches_the_jax_learn_step(batch, kappa, scaled, dueling):
    inp = _inputs(batch * 7 + int(scaled) + 2 * int(dueling), batch, 5, dueling, scaled)
    before = dict(launches)
    got = _port_chain(inp, kappa, 1.0)
    assert dict(launches) == before  # the CPU runs the twins and counts nothing
    want = _jax_chain(inp, kappa, 1.0)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, FP32, name)


@pytest.mark.parametrize("scaled", [False, True])
def test_loss_chain_matches_jax_on_a_masked_multi_game_batch(scaled):
    inp = _inputs(41, 32, 5, True, scaled, multi=True)
    got = _port_chain(inp, 1.0, 1.0)
    for name, g, w in zip(NAMES, got, _jax_chain(inp, 1.0, 1.0)):
        _close(g, w, FP32, name)
    # the mask decided a*: inside each row's game, where unmasked rows pick a pad slot
    online, (take, select, target, reward, discount, *_), margs = _port_args(inp)
    masked = dueling_learn_plain(select, target, online, take, reward, discount, *margs)[2]
    unmasked = dueling_learn_plain(select, target, online, take, reward, discount)[2]
    limit = np.asarray(COUNTS)[inp["game"]]
    assert (masked.numpy() < limit).all() and (unmasked.numpy() >= limit).any()


@pytest.mark.parametrize("dueling", [True, False])
def test_loss_chain_scaled_by_a_cotangent_of_two_and_a_half(dueling):
    inp = _inputs(43, 32, 5, dueling, True)
    got = _port_chain(inp, 1.0, 2.5)
    want = _jax_chain(inp, 1.0, 2.5)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, FP32, name)
    unit = _port_chain(inp, 1.0, 1.0)
    for name, g, u in zip(NAMES[5:], got[5:], unit[5:]):
        if u is not None:  # the cotangent reaches the backward as a scale
            _close(g, 2.5 * u, ROUTE, name)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dueling", [True, False])
def test_loss_chain_matches_the_parent_route(dueling, scaled):
    inp = _inputs(47, 32, 18, dueling, scaled)
    got = _port_chain(inp, 1.0, 1.0)
    want = _parent_route(inp, 1.0)
    for name, g, w in zip(("loss", "per_sample", "td_abs"), got[:3], want[:3]):
        _close(g, w.detach(), ROUTE, name)
    for name, g, w in zip(NAMES[5:], got[5:], want[3:]):
        _close(g, None if w is None else w.numpy(), ROUTE, name)


def test_loss_chain_outputs_carry_no_gradient_but_the_loss():
    inp = _inputs(53, 4, 3, True, False)
    online, (take, select, target, reward, discount, taus, weight, scale), margs = \
        _port_args(inp)
    loss, per_sample, td_abs, on_q, z_next = learn_loss(
        online, take, select, target, reward, discount, taus, weight, scale, 1.0, *margs)
    assert loss.requires_grad and loss.dim() == 0
    assert not any(t.requires_grad for t in (per_sample, td_abs, on_q, z_next))


def test_weighted_and_loss_mode_wrappers_run_their_twins_on_the_cpu():
    r = np.random.default_rng(59)
    online = _t(r.standard_normal((6, 8)).astype(np.float32))
    taus = _t(r.random((6, 8), dtype=np.float32))
    target = _t(r.standard_normal((6, 5)).astype(np.float32))
    weight, scale = _t(r.random(6, dtype=np.float32)), _t(r.random(6, dtype=np.float32))
    take = _t(r.integers(0, 4, 6).astype(np.int32))
    before = dict(launches)
    for s in (None, scale):
        got = quantile_huber_weighted(online, taus, target, weight, s, 0.5)
        want = quantile_huber_weighted_plain(online, taus, target, weight, s, 0.5)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        d_loss = torch.tensor(2.5)
        for dueling in (True, False):
            got = dueling_loss_bwd(d_loss, weight, s, want[3], take, 4, dueling)
            ref = dueling_loss_bwd_plain(d_loss, weight, s, want[3], take, 4, dueling)
            for g, w in zip(got, ref):
                assert (g is None and w is None) or torch.equal(g, w)
    assert dict(launches) == before
