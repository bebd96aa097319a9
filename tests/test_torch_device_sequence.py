"""The port's device sequence replay (rainbow_iqn_apex_tpu_torch.replay.
device_sequence) against the JAX package's DeviceSequenceReplay, on the CPU
through the plain twins of K7s, K5s, K8s and K6s.

Sizes are the JAX tests' (tests/test_device_sequence.py): 3 lanes, L 6,
stride 3, capacity 16, 8x8 frames, LSTM 4; the learn steps run on 44x44
frames with tests/test_torch_r2d2.py's R2D2 (LSTM 32, burn-in 4 + 8).  Both
packages get the same numpy-seeded trace; the JAX replay is jitted on the
CPU as its own tests run it, and a JAX state crosses to the port through
``convert.from_jax_device_seq_state``.  The sampler's uniforms are JAX's own,
computed from its key and handed to the port as ``u=``; the learn step's
noise goes to the port through ``draws=`` and to JAX by monkeypatching
``jax.random.normal`` (tests/test_torch_r2d2.py's ``_jax_step`` technique).

Tolerances:
- append: ring rows [0, C) (the scratch row C is not part of the
  semantics), the priorities, ``pos``, ``filled``, ``max_priority``,
  ``buf_len`` and each builder's steps below ``buf_len``: bit-equal.
- draw: exact slot ids on dyadic priorities (every cdf value exact in fp32,
  whatever the summation order) and on a cold ring.
- assemble: gathered fields equal; ``prob`` and the weights to 1e-6
  relative (fp32 sums and powers in another order).
- write-back: priorities and ``max_priority`` to 1e-6 relative: XLA's
  fp32 power and torch's round differently in the last bit for ~2 % of
  inputs (``(2 + 1e-6) ** 0.9``: 1.8660667 in XLA, 1.8660668 in torch and
  in float64 rounded to fp32), and the running maximum carries that bit.
- learn steps: loss, priorities, q_mean and grad_norm 1e-5; params, target
  params and Adam moments 1e-4 (fp32); the ring's priorities after each
  write-back 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.replay.device_sequence import DeviceSeqState as JaxSeqState
from rainbow_iqn_apex_tpu.replay.device_sequence import DeviceSequenceReplay as JaxSeqReplay
from rainbow_iqn_apex_tpu.replay.device_sequence import (
    build_device_r2d2_learn as jax_build_device_r2d2_learn,
)
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.kernels import launches
from rainbow_iqn_apex_tpu_torch.replay import (
    DeviceSeqState,
    DeviceSequenceReplay,
    build_device_r2d2_learn,
)
from rainbow_iqn_apex_tpu_torch.replay import device_sequence
from test_torch_r2d2 import (
    A,
    STEP_INFO,
    STEP_STATE,
    _cfgs,
    _compare_states,
    _inject,
    _port_state,
    _step_draws,
    _warm_jax_state,
)

LANES, L, STRIDE, CAP = 3, 6, 3, 16
H = W = 8
LSTM = 4
OMEGA, EPS = 0.9, 1e-6
REL = dict(rtol=1e-6, atol=0.0)
RING = ("frames", "actions", "rewards", "dones", "valids", "init_c", "init_h")
BUILDERS = ("buf_frames", "buf_actions", "buf_rewards", "buf_dones", "buf_c", "buf_h")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(seq_len=L, stride=STRIDE, frame=(H, W), lstm=LSTM, lanes=LANES, cap=CAP):
    kw = dict(capacity=cap, seq_len=seq_len, frame_shape=frame, lstm_size=lstm, lanes=lanes,
              stride=stride, priority_exponent=OMEGA, priority_eps=EPS)
    return JaxSeqReplay(**kw), DeviceSequenceReplay(**kw, device="cpu")


def _trace(rng, ticks, lanes=LANES, frame=(H, W), lstm=LSTM, p_term=0.1, p_trunc=0.07):
    for _ in range(ticks):
        term = rng.random(lanes) < p_term
        yield (rng.integers(0, 255, (lanes, *frame), dtype=np.uint8),
               rng.integers(0, 4, lanes).astype(np.int32),
               rng.normal(size=lanes).astype(np.float32), term,
               (rng.random(lanes) < p_trunc) & ~term,
               rng.normal(size=(lanes, lstm)).astype(np.float32),
               rng.normal(size=(lanes, lstm)).astype(np.float32))


def _drive(jdev, pdev, ticks, seed=0, **kw):
    """The same trace through both appends; returns (JAX state, port state)."""
    append = jax.jit(jdev.append)
    js, ps = jdev.init_state(), pdev.init_state()
    lanes, frame, lstm = pdev.lanes, pdev.frame_shape, pdev.lstm_size
    for f, a, r, term, trunc, c, h in _trace(np.random.default_rng(seed), ticks, lanes, frame,
                                             lstm, **kw):
        js = append(js, *(jnp.asarray(x) for x in (f, a, r, term, trunc, c, h)))
        pdev.append(ps, torch.from_numpy(f), torch.from_numpy(a), r, term, trunc,
                    torch.from_numpy(c), torch.from_numpy(h))
    return js, ps


def _assert_same_ring(js, ps):
    js = jax.device_get(js)
    cap = ps.priority.shape[0]
    assert (ps.pos, ps.filled) == (int(js.pos), int(js.filled))
    np.testing.assert_array_equal(ps.buf_len, np.asarray(js.buf_len))
    for name in RING:
        np.testing.assert_array_equal(getattr(ps, name)[:cap].numpy(),
                                      np.asarray(getattr(js, name))[:cap], err_msg=name)
    np.testing.assert_array_equal(ps.priority.numpy(), np.asarray(js.priority))
    np.testing.assert_array_equal(ps.max_priority.numpy(), np.asarray(js.max_priority))
    for lane, n in enumerate(ps.buf_len):
        for name in BUILDERS:
            np.testing.assert_array_equal(getattr(ps, name)[lane, :n].numpy(),
                                          np.asarray(getattr(js, name))[lane, :n],
                                          err_msg=f"{name} lane {lane}")


# ------------------------------------------------------------------ append
@pytest.mark.parametrize("ticks", [4, 17, 60])
def test_append_matches_jax(ticks):
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, ticks)
    _assert_same_ring(js, ps)
    if ticks == 60:
        assert ps.filled == CAP and int(js.filled) == CAP  # the ring wrapped


@pytest.mark.parametrize("p_term,p_trunc", [(0.1, 0.07), (0.0, 0.0)], ids=["cuts", "no_cuts"])
def test_append_with_a_self_overlapping_carry_matches_jax(p_term, p_trunc):
    """stride 2 < L - stride 5: the carry-over moves the builder onto
    itself, the trap of an in-place copy."""
    jdev, pdev = _pair(seq_len=7, stride=2)
    js, ps = _drive(jdev, pdev, 45, seed=3, p_term=p_term, p_trunc=p_trunc)
    _assert_same_ring(js, ps)


def test_append_refuses_device_cut_flags_and_keeps_host_counters():
    _, pdev = _pair()
    ps = pdev.init_state()
    f, a, r, term, trunc, c, h = next(_trace(np.random.default_rng(1), 1))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    with pytest.raises(ValueError, match="host arrays"):
        pdev.append(ps, torch.from_numpy(f), torch.from_numpy(a), r,
                    torch.from_numpy(term).as_subclass(FakeCuda), trunc, torch.from_numpy(c),
                    torch.from_numpy(h))
    assert isinstance(ps.pos, int) and isinstance(ps.buf_len, np.ndarray)


def test_wrappers_run_the_twins_on_cpu_without_counting():
    before = dict(launches)
    jdev, pdev = _pair()
    _, ps = _drive(jdev, pdev, 20)
    idx, batch, _ = pdev.sample_grouped(ps, 4, 1, 0.5, u=torch.rand(4))
    pdev.update_priorities_grouped(ps, idx, torch.rand(4))
    assert dict(launches) == before
    assert batch.obs.shape == (4, L, H, W, 1) and batch.weight.shape == (4,)


# -------------------------------------------------------------------- draw
def _dyadic(js, ps, seed=0):
    """The same priorities of multiples of 1/8 (zeros included) in both."""
    rng = np.random.default_rng(seed)
    pri = (rng.integers(0, 9, CAP) / 8).astype(np.float32)
    pri[ps.filled:] = 0.0
    ps.priority.copy_(torch.from_numpy(pri))
    return js._replace(priority=jnp.asarray(pri))


def _jax_uniforms(key, batch, groups=0):
    """The draw's uniforms JAX takes from ``key`` ([B], or [G, B] over the
    G keys that sample_grouped splits off)."""
    if not groups:
        return np.array(jax.random.uniform(key, (batch,)))
    return np.stack([np.array(jax.random.uniform(k, (batch,)))
                     for k in jax.random.split(key, groups)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_matches_jax_on_dyadic_priorities(seed):
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, 40, seed=seed)
    js = _dyadic(js, ps, seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.jit(jdev.draw, static_argnums=2)(js, key, 8))
    got, meta = pdev.draw(ps, 8, u=torch.from_numpy(_jax_uniforms(key, 8)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(meta[0]) == float(jnp.sum(js.priority)) and float(meta[1]) == 0.0


@pytest.mark.parametrize("groups", [1, 2])
def test_sample_grouped_matches_jax(groups):
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, 60, seed=4)
    js = _dyadic(js, ps, 4)
    key, batch, beta = jax.random.PRNGKey(9), 3, 0.6
    jidx, jb, jprob = jdev.sample_grouped(js, key, batch, groups, jnp.float32(beta))
    pidx, pb, pprob = pdev.sample_grouped(
        ps, batch, groups, beta, u=torch.from_numpy(_jax_uniforms(key, batch, groups)))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    for name in ("obs", "action", "reward", "done", "valid", "init_c", "init_h"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_allclose(pprob.numpy(), np.asarray(jprob), **REL)
    np.testing.assert_allclose(pb.weight.numpy(), np.asarray(jb.weight), **REL)


def test_cold_ring_draw_degrades_to_uniform_as_jax():
    """tests/test_device_sequence.py's cold-ring case: a dead-empty ring
    draws slot 0 with finite weights; a filled prefix with zeroed
    priorities draws uniformly over it, the same slots as JAX."""
    jdev, pdev = _pair()
    js, ps = jdev.init_state(), pdev.init_state()
    key = jax.random.PRNGKey(0)
    idx, meta = pdev.draw(ps, 32, u=torch.from_numpy(_jax_uniforms(key, 32)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jdev.draw(js, key, 32)))
    assert set(idx.tolist()) == {0} and float(meta[1]) == 1.0
    batch, prob = pdev.assemble(ps, idx, 0.5)
    jbatch, jprob = jdev.assemble(js, jnp.asarray(idx.numpy()), jnp.float32(0.5))
    assert np.isfinite(batch.weight.numpy()).all()
    np.testing.assert_allclose(batch.weight.numpy(), np.asarray(jbatch.weight), **REL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), **REL)
    js, ps.filled = js._replace(filled=jnp.int32(5)), 5
    key = jax.random.PRNGKey(1)
    idx, _ = pdev.draw(ps, 64, u=torch.from_numpy(_jax_uniforms(key, 64)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jdev.draw(js, key, 64)))
    assert idx.max() < 5 and len(set(idx.tolist())) > 1


# ---------------------------------------------------------------- assemble
@pytest.mark.parametrize("with_weight", [True, False])
def test_assemble_matches_jax(with_weight):
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, 50, seed=5)
    idx = np.random.default_rng(5).integers(0, CAP, 8).astype(np.int32)
    jb, jprob = jax.jit(jdev.assemble, static_argnames="with_weight")(
        js, jnp.asarray(idx), jnp.float32(0.6), with_weight=with_weight)
    pb, pprob = pdev.assemble(ps, torch.from_numpy(idx), 0.6, with_weight=with_weight)
    for name in ("obs", "action", "reward", "done", "valid", "init_c", "init_h"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_allclose(pprob.numpy(), np.asarray(jprob), **REL)
    np.testing.assert_allclose(pb.weight.numpy(), np.asarray(jb.weight), **REL)
    assert with_weight or (pb.weight.numpy() == 1.0).all()


# --------------------------------------------------------------- write-back
def test_update_priorities_matches_jax():
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, 30, seed=7)
    idx = np.array([0, 2, 5], np.int32)
    td = np.array([0.5, 2.0, 0.01], np.float32)
    js = jax.jit(jdev.update_priorities)(js, jnp.asarray(idx), jnp.asarray(td))
    pdev.update_priorities(ps, torch.from_numpy(idx), torch.from_numpy(td))
    np.testing.assert_allclose(ps.priority.numpy(), np.asarray(js.priority), **REL)
    np.testing.assert_allclose(ps.max_priority.numpy(), np.asarray(js.max_priority), **REL)


def test_update_priorities_grouped_matches_jax_and_the_last_write_wins():
    """Repeats across groups: the last group wins, as in JAX.  Inside a
    group (where JAX leaves the order open) the port writes the last
    occurrence."""
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, 60, seed=8)
    idx = np.array([[1, 4, 7, 9], [4, 2, 9, 11]], np.int32)
    td = np.array([0.8, 0.3, 1.5, 0.1, 0.2, 2.5, 0.05, 0.7], np.float32)
    js = jax.jit(jdev.update_priorities_grouped)(js, jnp.asarray(idx), jnp.asarray(td))
    pdev.update_priorities_grouped(ps, torch.from_numpy(idx), torch.from_numpy(td))
    np.testing.assert_allclose(ps.priority.numpy(), np.asarray(js.priority), **REL)
    np.testing.assert_allclose(ps.max_priority.numpy(), np.asarray(js.max_priority), **REL)
    assert float(ps.priority[4]) == pytest.approx((0.2 + EPS) ** OMEGA, rel=1e-6)
    pdev.update_priorities(ps, torch.tensor([3, 3]), torch.tensor([0.4, 0.9]))
    assert float(ps.priority[3]) == pytest.approx((0.9 + EPS) ** OMEGA, rel=1e-6)


# -------------------------------------------------------------- learn steps
def _learn_ring(groups):
    """JAX and port rings of 44x44 frames and LSTM 32 sequences of
    tests/test_torch_r2d2.py's length (burn-in 4 + 8), dyadic priorities."""
    jcfg, pcfg = _cfgs(sample_groups=groups)
    seq = jcfg.r2d2_burn_in + jcfg.r2d2_seq_len
    jdev, pdev = _pair(seq_len=seq, stride=seq - jcfg.r2d2_overlap, frame=(44, 44),
                       lstm=jcfg.lstm_size, lanes=3, cap=16)
    js, ps = _drive(jdev, pdev, 60, seed=12, p_term=0.05, p_trunc=0.03)
    return jcfg, pcfg, jdev, pdev, _dyadic(js, ps, 12), ps


def _jax_fused(jcfg, jdev, queue):
    fused = jax_build_device_r2d2_learn(jcfg, A, jdev)

    def run(ts, ss, key, beta, normals):
        queue[:] = list(normals)
        out = fused(ts, ss, key, beta)
        assert not queue  # every apply drew exactly once
        return out

    return jax.jit(run)


@pytest.mark.parametrize("steps,groups", [(1, 1), (3, 1), (1, 2), (3, 2)],
                         ids=["one_step", "three_steps", "one_step_g2", "three_steps_g2"])
def test_fused_learn_matches_jax(monkeypatch, steps, groups):
    """One and three fused draw -> assemble -> learn -> write-back steps
    from one converted state and ring (history 2 stacked in the step; G 1
    and 2): every step's loss, priorities, q_mean and grad_norm and the
    ring's priorities after its write-back, then the learner state."""
    jcfg, pcfg, jdev, pdev, js, ps = _learn_ring(groups)
    jts = _warm_jax_state()
    pts = _port_state(pcfg, jts)
    jfused = _jax_fused(jcfg, jdev, _inject(monkeypatch, []))
    pfused = build_device_r2d2_learn(pcfg, A, pdev)
    for k in range(steps):
        key, beta = jax.random.PRNGKey(30 + k), 0.4 + 0.1 * k
        normals, draws = _step_draws(70 + k)
        u = _jax_uniforms(jax.random.split(key)[0], pcfg.batch_size, groups if groups > 1 else 0)
        jts, js, jinfo = jfused(jts, js, key, jnp.float32(beta), normals)
        pts, ps, pinfo = pfused(pts, ps, None, beta, u=torch.from_numpy(u), draws=draws)
        for name in ("loss", "priorities", "q_mean", "grad_norm"):
            np.testing.assert_allclose(pinfo[name].numpy(), np.asarray(jinfo[name]),
                                       err_msg=f"step {k}: {name}", **STEP_INFO)
        np.testing.assert_allclose(ps.priority.numpy(), np.asarray(js.priority),
                                   err_msg=f"step {k}: ring priority", **REL)
        np.testing.assert_allclose(ps.max_priority.numpy(), np.asarray(js.max_priority), **REL)
        assert pinfo["priorities"].shape == (groups * pcfg.batch_size,)
    assert pts.step == int(jts.step)
    _compare_states(pts, jts, STEP_STATE)


# ---------------------------------------------------------------- convert
def test_convert_round_trips_a_jax_ring():
    jdev, pdev = _pair()
    js, ps = _drive(jdev, pdev, 25, seed=13)
    crossed = convert.from_jax_device_seq_state(jax.device_get(js))
    assert isinstance(crossed, DeviceSeqState) and isinstance(crossed.pos, int)
    _assert_same_ring(js, crossed)
    back = JaxSeqState(**{k: jnp.asarray(v) for k, v in
                          convert.device_seq_state_arrays(crossed).items()})
    for name in JaxSeqState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(js, name)), err_msg=name)
    copy = crossed.to("cpu")
    copy.priority.add_(1.0)
    copy.buf_len[0] += 1
    assert not torch.equal(copy.priority, crossed.priority)
    assert copy.buf_len[0] != crossed.buf_len[0]


def test_sharded_sequence_parts_raise_naming_the_multi_gpu_item():
    for fn, args in ((device_sequence.stack_seq_shards, (None, 2)),
                     (device_sequence.device_seq_specs, ()),
                     (device_sequence.device_seq_shardings, (None,)),
                     (device_sequence.build_sharded_seq_append, (None, None)),
                     (device_sequence.build_device_r2d2_learn_sharded, (None, A, None, None))):
        with pytest.raises(NotImplementedError, match="A13, more than one GPU"):
            fn(*args)
