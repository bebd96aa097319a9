"""The port's device replay (rainbow_iqn_apex_tpu_torch.replay.device) against
the JAX package's DeviceReplay, on the CPU through the plain twins of K5-K8.

Both get the same numpy-seeded trace; the JAX replay is jitted on the CPU as
its own tests run it, and a JAX state crosses to the port through
``convert.from_jax_device_replay_state``.  The sampler's uniforms go to the
port through ``u=`` and to JAX by monkeypatching ``jax.random.uniform``.

Tolerances:
- append: every uint8/int/bool field, ``pos`` and ``filled`` equal; the
  priorities and ``max_priority`` to 1e-6 relative (the same fp32 ops; a
  power may round differently in the last bit).
- draw: exact slot ids on dyadic priorities, where every cdf value is exact
  in fp32 whatever the summation order; on random priorities a chi-square of
  many draws against p / sum p (the two frameworks' fp32 cdfs differ in the
  last bits, so ids may differ where u lies within rounding of a boundary).
- assemble / sample_grouped: obs, next_obs, action and discount equal;
  reward, prob and weight to 1e-6 relative (fp32 sums and powers in another
  order).
- update_priorities: to 1e-6 relative against JAX and against the port's
  host PrioritizedReplay (which computes in fp64); zero slots stay exactly 0.
- shift_stack: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.parallel.multihost import shift_stack as jax_shift_stack
from rainbow_iqn_apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.parallel.multihost import shift_stack
from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay
from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, DeviceReplayState

L, S = 2, 24  # lanes, slots per lane
H = W = 10
HIST, NSTEP, GAMMA = 3, 2, 0.9
REL = dict(rtol=1e-6, atol=0.0)
FIELDS = ("frames", "actions", "rewards", "terminals", "cuts")


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# (history, n_step): the default, and the edges of K7's window and K8's
# stacks (S = 24 > h + n throughout)
GEOMETRIES = [(HIST, NSTEP), (1, 1), (7, 5)]


def _pair(history=HIST, n_step=NSTEP):
    jdev = JaxDeviceReplay(lanes=L, seg=S, frame_shape=(H, W), history=history, n_step=n_step,
                           gamma=GAMMA)
    pdev = DeviceReplay(lanes=L, seg=S, frame_shape=(H, W), history=history, n_step=n_step,
                        gamma=GAMMA, device="cpu")
    return jdev, pdev


def _trace(seed, ticks, p_term=0.08, p_trunc=0.06):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        term = rng.random(L) < p_term
        out.append(dict(
            frames=rng.integers(1, 255, (L, H, W), dtype=np.uint8),
            actions=rng.integers(0, 4, L).astype(np.int32),
            rewards=rng.normal(size=L).astype(np.float32),
            terminals=term,
            truncations=(rng.random(L) < p_trunc) & ~term,
            priorities=(rng.random(L) * 2.0).astype(np.float32) + 0.05,
        ))
    return out


def _fill_jax(jdev, trace, actor=True):
    append = jax.jit(jdev.append)
    ds = jdev.init_state()
    for t in trace:
        ds = append(ds, *(jnp.asarray(t[k]) for k in
                          ("frames", "actions", "rewards", "terminals", "truncations")),
                    jnp.asarray(t["priorities"]) if actor else None)
    return ds


def _fill_port(pdev, trace, actor=True):
    ds = pdev.init_state()
    for t in trace:
        pdev.append(ds, *(torch.from_numpy(t[k]) for k in
                          ("frames", "actions", "rewards", "terminals", "truncations")),
                    torch.from_numpy(t["priorities"]) if actor else None)
    return ds


def _port_state(jds) -> DeviceReplayState:
    return convert.from_jax_device_replay_state(jax.device_get(jds), device="cpu")


def _assert_same_state(pds, jds):
    host = jax.device_get(jds)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(pds, name).numpy(), np.asarray(getattr(host, name)),
                                      err_msg=name)
    np.testing.assert_allclose(pds.priority.numpy(), np.asarray(host.priority), **REL)
    np.testing.assert_allclose(pds.max_priority.numpy(), np.asarray(host.max_priority), **REL)
    assert (pds.pos, pds.filled) == (int(host.pos), int(host.filled))


def _fake_uniform(monkeypatch, uniforms, keys=None):
    """jax.random.uniform hands out ``uniforms`` [G, B]: row g for the g-th
    of ``keys`` (sample_grouped's vmapped draws), else row 0."""
    real = jax.random.uniform
    table = jnp.asarray(uniforms)

    def fake(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if (minval, maxval) != (0.0, 1.0):
            return real(key, shape, dtype, minval, maxval)
        if keys is None:
            return table[0].astype(dtype).reshape(shape)
        row = jnp.argmax(jnp.all(jnp.asarray(key) == keys, axis=-1))
        return table[row].astype(dtype).reshape(shape)

    monkeypatch.setattr(jax.random, "uniform", fake)


# ----------------------------------------------------------------- append
@pytest.mark.parametrize("history,n_step", GEOMETRIES)
@pytest.mark.parametrize("actor", [True, False], ids=["actor_pri", "max_pri"])
@pytest.mark.parametrize("ticks", [5, S - 1, S + 10, 3 * S])
def test_append_matches_jax(ticks, actor, history, n_step):
    """Every field after young, just-full, wrapped and steady-state fills,
    with actor priorities and with max-priority insertion."""
    trace = _trace(0, ticks)
    jdev, pdev = _pair(history, n_step)
    _assert_same_state(_fill_port(pdev, trace, actor), _fill_jax(jdev, trace, actor))


# ------------------------------------------------------------------- draw
def _dyadic_state(jdev):
    """A wrapped ring whose eligible slots hold priorities k / 8: every
    partial sum is exact in fp32."""
    jds = _fill_jax(jdev, _trace(1, 2 * S))
    rng = np.random.default_rng(2)
    pri = np.asarray(jds.priority)
    dyadic = np.where(pri > 0, rng.integers(1, 9, pri.shape) / 8.0, 0.0).astype(np.float32)
    return jds.replace(priority=jnp.asarray(dyadic))


@pytest.mark.parametrize("groups", [1, 4])
def test_draw_on_dyadic_priorities_matches_jax_exactly(monkeypatch, groups):
    """Equal slot ids, and the last uniform just below 1 rounds u up to the
    total: JAX clips that draw onto slot N - 1 and so must the port."""
    jdev, pdev = _pair()
    jds = _dyadic_state(jdev)
    pds = _port_state(jds)
    batch, beta = 8, 0.6
    rng = np.random.default_rng(3)
    u = rng.random((groups, batch), dtype=np.float32)
    u[-1, -1] = np.float32(1.0 - 2.0 ** -24)
    key = jax.random.PRNGKey(5)
    if groups == 1:
        _fake_uniform(monkeypatch, u)
        want = np.asarray(jdev.draw(jds, key, batch))[None]
        got = pdev.draw(pds, batch, u=torch.from_numpy(u[0]))[None]
    else:
        _fake_uniform(monkeypatch, u, keys=jax.random.split(key, groups))
        want, jbatch, jprob = jdev.sample_grouped(jds, key, batch, groups, jnp.float32(beta))
        got, pbatch, pprob = pdev.sample_grouped(pds, batch, groups, beta, u=torch.from_numpy(u))
        _assert_same_batch(pbatch, pprob, jbatch, jprob)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.reshape(-1)[-1]) == L * S - 1


def test_draw_on_random_priorities_is_proportional():
    """Many stratified draws of the port land within the chi-square band of
    the exact proportional distribution, binned by slot so every bin has a
    healthy expected count (the test of tests/test_device_sampling.py)."""
    jdev, pdev = _pair()
    pds = _port_state(_fill_jax(jdev, _trace(4, 2 * S)))
    p = pds.priority.double().numpy()
    p = p / p.sum()
    bins = 8
    bin_of = (np.arange(L * S) * bins) // (L * S)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(bins)
    batch, calls = 50, 400
    for _ in range(calls):
        idx = pdev.draw(pds, batch, generator=gen).numpy()
        assert np.all(p[idx] > 0), "an ineligible slot was drawn"
        np.add.at(counts, bin_of[idx], 1)
    expected = np.zeros(bins)
    np.add.at(expected, bin_of, p)
    expected *= batch * calls
    keep = expected > 0
    chi = float(((counts[keep] - expected[keep]) ** 2 / expected[keep]).sum())
    assert chi < 24.32, f"chi2 {chi:.1f} >= 24.32 (df 7, alpha 0.001)"


# --------------------------------------------------------------- assemble
def _assert_same_batch(pbatch, pprob, jbatch, jprob):
    for name in ("obs", "next_obs", "action", "discount"):
        np.testing.assert_array_equal(getattr(pbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    for got, want, name in ((pbatch.reward, jbatch.reward, "reward"), (pprob, jprob, "prob"),
                            (pbatch.weight, jbatch.weight, "weight")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **REL)


@pytest.mark.parametrize("history,n_step", GEOMETRIES)
@pytest.mark.parametrize("with_weight", [True, False])
@pytest.mark.parametrize("ticks", [S - 5, 2 * S], ids=["young", "wrapped"])
def test_assemble_matches_jax_at_the_same_indices(ticks, with_weight, history, n_step):
    """Stacks with cut zeroing (and age zeroing while the ring is young),
    n-step returns, discounts, actions, probabilities and IS weights."""
    jdev, pdev = _pair(history, n_step)
    jds = _fill_jax(jdev, _trace(6, ticks, p_term=0.15, p_trunc=0.1))
    pds = _port_state(jds)
    rng = np.random.default_rng(7)
    idx = rng.integers(0, L * S, 16).astype(np.int32)
    beta = 0.55
    jbatch, jprob = jax.jit(jdev.assemble, static_argnames="with_weight")(
        jds, jnp.asarray(idx), jnp.float32(beta), with_weight=with_weight)
    pbatch, pprob = pdev.assemble(pds, torch.from_numpy(idx), beta, with_weight=with_weight)
    _assert_same_batch(pbatch, pprob, jbatch, jprob)


# ------------------------------------------------------------- write-back
def _host_replay(trace):
    host = PrioritizedReplay(capacity=L * S, frame_shape=(H, W), history=HIST, n_step=NSTEP,
                             gamma=GAMMA, lanes=L, seed=7, use_native=False)
    for t in trace:
        host.append_batch(t["frames"], t["actions"], t["rewards"], t["terminals"],
                          priorities=t["priorities"], truncations=t["truncations"])
    return host


@pytest.mark.parametrize("groups", [1, 3])
def test_update_priorities_matches_jax_and_the_host_replay(groups):
    """Duplicate ids inside a group and across groups, and zero slots (the
    fresh slot, the dead zone, truncation-dead windows): the last occurrence
    wins, group order holds, and a zero slot is never resurrected."""
    trace = _trace(8, 2 * S)
    jdev, pdev = _pair()
    jds = _fill_jax(jdev, trace)
    pds = _port_state(jds)
    host = _host_replay(trace)
    np.testing.assert_allclose(pds.priority.numpy(), host.tree.get(np.arange(L * S)), **REL)
    pri = pds.priority.numpy()
    zeros = np.flatnonzero(pri == 0.0)
    live = np.flatnonzero(pri > 0.0)
    assert zeros.size >= 2 and live.size >= 4
    rng = np.random.default_rng(9)
    batch = 8
    idx = rng.choice(live[:4], (groups, batch)).astype(np.int32)  # many repeats
    idx[0, :2] = zeros[:2]
    idx[-1, -1] = idx[0, 3]  # a slot of the first group again in the last
    td = rng.random((groups, batch)).astype(np.float32) * 3.0
    if groups == 1:
        jds = jdev.update_priorities(jds, jnp.asarray(idx[0]), jnp.asarray(td[0]))
        pdev.update_priorities(pds, torch.from_numpy(idx[0]), torch.from_numpy(td[0]))
    else:
        jds = jdev.update_priorities_grouped(jds, jnp.asarray(idx), jnp.asarray(td.reshape(-1)))
        pdev.update_priorities_grouped(pds, torch.from_numpy(idx), torch.from_numpy(td.reshape(-1)))
    for g in range(groups):
        host.update_priorities(idx[g], td[g])
    got = pds.priority.numpy()
    np.testing.assert_allclose(got, np.asarray(jds.priority), **REL)
    np.testing.assert_allclose(got, host.tree.get(np.arange(L * S)), **REL)
    assert np.all(got[zeros] == 0.0)
    np.testing.assert_allclose(pds.max_priority.numpy(), np.asarray(jds.max_priority), **REL)
    assert float(pds.max_priority) == pytest.approx(host.max_priority, rel=1e-6)


def test_shift_stack_matches_jax():
    rng = np.random.default_rng(10)
    stack = rng.integers(0, 255, (3, 6, 5, 4), dtype=np.uint8)
    frame = rng.integers(0, 255, (3, 6, 5), dtype=np.uint8)
    keep = np.array([1, 0, 1], np.uint8)
    want = jax_shift_stack(jnp.asarray(stack), jnp.asarray(frame), jnp.asarray(keep))
    got_t = torch.from_numpy(stack.copy())
    out = shift_stack(got_t, torch.from_numpy(frame), torch.from_numpy(keep))
    assert out is got_t
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


def test_state_copies_and_the_converter_keep_every_field():
    jdev, pdev = _pair()
    jds = _fill_jax(jdev, _trace(11, S + 3))
    pds = _port_state(jds)
    _assert_same_state(pds, jds)
    copy = pds.to("cpu")
    copy.priority.zero_()
    assert float(pds.priority.sum()) > 0  # a copy, not a view
    assert (copy.pos, copy.filled) == (pds.pos, pds.filled)
    with pytest.raises(ValueError):
        DeviceReplay(lanes=L, seg=HIST + NSTEP, frame_shape=(H, W), history=HIST,
                     n_step=NSTEP, device="cpu")
