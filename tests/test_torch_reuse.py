"""Replay reuse (replay_ratio K > 1) in the port against the JAX package, on
the CPU.

- One single-game ``make_reuse_learn_step`` call at K = 2 and K = 4 from a
  converted JAX state, with the JAX step's draws injected in call order
  (the ratio forward, pass 1, then the fori_loop body's ratio forward and
  pass, traced once, so passes 2..K share their draws): info, ``step +=
  K`` and the state after the update.
- At zero parameter drift the ratio is exactly 1 and nothing clips
  (tests/test_replay_reuse.py:183-196).
- The loops: ``train`` writes priorities once per sampled batch; the
  port's ``train_apex`` runs tests/test_replay_reuse.py's compositions
  (multi-game, device sampling, cadences not divisible by K) with those
  tests' assertions.

Tolerances as tests/test_torch_learn.py: info rtol 1e-5, state rtol 1e-4.
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
from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn

A = 3
B = 4
SHAPE = (44, 44, 2)
STEP_INFO = dict(rtol=1e-5, atol=1e-6)
STEP_STATE = dict(rtol=1e-4, atol=1e-6)
NOISY = ("value_hidden", "value_out", "advantage_hidden", "advantage_out")


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


def _inject(monkeypatch, uniforms, normals):
    """jax.random.uniform (U[0, 1) draws) and jax.random.normal hand out the
    given arrays in call order; returns both queues."""
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


def _cfgs(**kw):
    base = dict(compute_dtype="float32", frame_height=SHAPE[0], frame_width=SHAPE[1],
                history_length=SHAPE[2], hidden_size=32, num_cosines=16, num_tau_samples=8,
                num_tau_prime_samples=8, num_quantile_samples=4, batch_size=B,
                learning_rate=1e-3, adam_eps=1.5e-4, max_grad_norm=10.0,
                target_update_period=100)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
        action=rng.integers(0, A, B).astype(np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        next_obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
        discount=np.array([0.9, 0.9, 0.0, 0.81], np.float32),
        weight=rng.uniform(0.5, 1.5, B).astype(np.float32),
    )


def _forward(rng, feat, hidden, n):
    dims = [(feat, hidden), (hidden, 1), (feat, hidden), (hidden, A)]
    return (rng.random((B, n), dtype=np.float32),
            {layer: (rng.standard_normal(i).astype(np.float32),
                     rng.standard_normal(o).astype(np.float32))
             for layer, (i, o) in zip(NOISY, dims)})


def _pass(cfg, feat, rng):
    return [_forward(rng, feat, cfg.hidden_size, n)
            for n in (cfg.num_quantile_samples, cfg.num_tau_prime_samples, cfg.num_tau_samples)]


def _flat(forwards):
    uniforms, normals = [], []
    for taus, noise in forwards:
        uniforms.append(taus)
        normals += [a for layer in NOISY for a in noise[layer]]
    return uniforms, normals


def _port(forward):
    taus, noise = forward
    return _t(taus), {k: (_t(a), _t(b)) for k, (a, b) in noise.items()}


def _port_pass(forwards):
    return dict(zip(("select", "target", "online"), map(_port, forwards)))


def _adam(opt_state):
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _warm_jax_state():
    jcfg, _ = _cfgs()
    # eager: compiling the whole step would cost more than the two steps
    state = jlearn.init_train_state(jcfg, A, jax.random.PRNGKey(0), state_shape=SHAPE)
    step = jlearn.build_learn_step(jcfg, A)
    for k in range(2):
        state, _ = step(state, jlearn.Batch(**{n: jnp.asarray(v) for n, v in
                                               _batch(20 + k).items()}),
                        jax.random.PRNGKey(100 + k))
    return state


def _port_state(pcfg, jstate):
    st = plearn.init_train_state(pcfg, A, seed=0, state_shape=SHAPE, device="cpu")
    adam = _adam(jstate.opt_state)
    host = convert.from_flax_train_state(_np(jstate.params), _np(jstate.target_params),
                                         _np(adam.mu), _np(adam.nu), adam.count, jstate.step)
    return plearn.load_host_state(st, host)


def _compare_states(pstate, jstate, tol):
    want = convert.to_flax_train_state(plearn.host_state(pstate))
    adam = _adam(jstate.opt_state)
    assert int(want["step"]) == int(jstate.step) and int(want["count"]) == int(adam.count)
    for key, ref in (("params", jstate.params), ("target_params", jstate.target_params),
                     ("mu", adam.mu), ("nu", adam.nu)):
        flat_w = jax.tree_util.tree_flatten_with_path(_np(ref))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(want[key])[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            _close(g, w, tol, f"{key} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("k", [2, 4])
def test_reuse_learn_step_matches_jax(monkeypatch, k):
    """target_update_period 3 puts a target copy inside the K = 4 call."""
    jcfg, pcfg = _cfgs(replay_ratio=k, target_update_period=3)
    jstate = _warm_jax_state()
    pstate = _port_state(pcfg, jstate)
    feat = jstate.params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    rng = np.random.default_rng(70 + k)
    ratio = _forward(rng, feat, pcfg.hidden_size, pcfg.num_quantile_samples)
    first, body = _pass(pcfg, feat, rng), _pass(pcfg, feat, rng)
    uq, nq = _inject(monkeypatch, *_flat([ratio, *first, ratio, *body]))
    b = _batch(80)
    jstate2, jinfo = jlearn.build_learn_step(jcfg, A)(
        jstate, jlearn.Batch(**{n: jnp.asarray(v) for n, v in b.items()}), jax.random.PRNGKey(3))
    assert not uq and not nq
    draws = {"ratio": _port(ratio), "passes": [_port_pass(first)] + [_port_pass(body)] * (k - 1)}
    pstate, pinfo = plearn.build_learn_step(pcfg, A)(
        pstate, plearn.Batch(**{n: _t(v) for n, v in b.items()}), draws=draws)
    for key in ("loss", "priorities", "q_mean", "target_q_mean", "grad_norm", "clip_frac"):
        _close(pinfo[key].numpy(), jinfo[key], STEP_INFO, key)
    assert bool(pinfo["finite"]) and bool(jinfo["finite"])
    assert pinfo["replay_ratio"] == int(jinfo["replay_ratio"]) == k
    assert pinfo["reuse_index"] == int(jinfo["reuse_index"]) == k - 1
    assert pstate.step == int(jstate2.step) == int(jstate.step) + k
    _compare_states(pstate, jstate2, STEP_STATE)


def test_zero_drift_means_ratio_one_and_zero_clip_frac():
    """lr 0: the params never move, so each reuse pass's ratio is exactly 1
    (one shared ratio draw) and nothing clips, even at c = 1 + 1e-7; K
    passes leave the params bitwise unchanged while step advances K."""
    _, pcfg = _cfgs(replay_ratio=3, reuse_clip=1.0000001, learning_rate=0.0, max_grad_norm=0.0)
    state = plearn.init_train_state(pcfg, A, seed=0, state_shape=SHAPE, device="cpu")
    before = {n: p.detach().clone() for n, p in state.net.named_parameters()}
    b = plearn.Batch(**{n: _t(v) for n, v in _batch(1).items()})
    logp = plearn.make_policy_logp(pcfg)
    taus = torch.rand((B, pcfg.num_quantile_samples), generator=torch.Generator().manual_seed(5))
    noise = state.net.sample_noise(torch.Generator().manual_seed(6))
    assert torch.equal(logp(state.net, b, taus, noise), logp(state.net, b, taus, noise))
    state, info = plearn.build_learn_step(pcfg, A)(state, b, torch.Generator().manual_seed(1))
    assert float(info["clip_frac"]) == 0.0 and bool(info["finite"])
    assert state.step == 3
    for n, p in state.net.named_parameters():
        assert torch.equal(p, before[n]), n


# ------------------------------------------------------------------- loops
def _rows(cfg):
    path = os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_priorities_written_once_per_sample_final_pass(tmp_path, monkeypatch):
    """tests/test_replay_reuse.py:206-239 through the port's train(): one
    batch-sized write-back per sampled batch, learn_steps = K x batches."""
    from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay
    from rainbow_iqn_apex_tpu_torch.train import train

    writes = []
    orig = PrioritizedReplay.update_priorities

    def spy(self, idx, priorities):
        writes.append(np.asarray(priorities).shape)
        return orig(self, idx, priorities)

    monkeypatch.setattr(PrioritizedReplay, "update_priorities", spy)
    cfg = Config(
        env_id="toy:chain", compute_dtype="float32", history_length=2, hidden_size=32,
        num_cosines=8, num_tau_samples=4, num_tau_prime_samples=4, num_quantile_samples=4,
        batch_size=16, learning_rate=1e-3, multi_step=3, gamma=0.9, memory_capacity=2048,
        learn_start=64, frames_per_learn=4, replay_ratio=2, target_update_period=64,
        num_envs_per_actor=4, metrics_interval=20, eval_interval=0, checkpoint_interval=0,
        eval_episodes=2, stall_timeout_s=0.0, writeback_depth=1, seed=11,
        results_dir=str(tmp_path / "results"), checkpoint_dir=str(tmp_path / "ckpt"))
    summary = train(cfg, max_frames=256, device="cpu")
    assert summary["rollbacks"] == 0
    samples = 256 // cfg.frames_per_learn
    assert summary["learn_steps"] == cfg.replay_ratio * samples
    assert len(writes) == samples
    assert all(shape == (cfg.batch_size,) for shape in writes)
    learn = [r for r in _rows(cfg) if r["kind"] == "learn"]
    assert learn and all(r["replay_ratio"] == 2 and r["reuse_index"] in (None, 1)
                         for r in learn)


def _apex_cfg(tmp_path, run_id, **kw):
    base = dict(
        env_id="toy:catch", compute_dtype="float32", frame_height=44, frame_width=44,
        history_length=2, hidden_size=32, num_cosines=8, num_tau_samples=4,
        num_tau_prime_samples=4, num_quantile_samples=4, batch_size=16, learning_rate=1e-3,
        multi_step=3, gamma=0.9, memory_capacity=2048, learn_start=256, frames_per_learn=2,
        target_update_period=100, num_envs_per_actor=8, metrics_interval=50, eval_interval=0,
        checkpoint_interval=0, eval_episodes=2, stall_timeout_s=0.0, writeback_depth=2,
        replay_shards=2, weight_publish_interval=100, seed=3, run_id=run_id, role="apex",
        results_dir=str(tmp_path / run_id / "results"),
        checkpoint_dir=str(tmp_path / run_id / "ckpt"))
    base.update(kw)
    return Config(**base)


def test_reuse_composes_with_multitask(tmp_path):
    """tests/test_replay_reuse.py:284-302: the two-game apex at K = 2 runs
    the masked-logp reuse step for the whole suite."""
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex

    cfg = _apex_cfg(tmp_path, "reuse_mt", games="toy:catch,toy:chain", frames_per_learn=4,
                    replay_ratio=2, replay_shards=1, memory_capacity=4096)
    summary = train_apex(cfg, max_frames=768, device="cpu")
    assert summary["rollbacks"] == 0
    assert summary["learn_steps"] == 2 * (768 // cfg.frames_per_learn)
    rows = _rows(cfg)
    learn_rows = [r for r in rows if r["kind"] == "learn"]
    assert learn_rows and all(r["replay_ratio"] == 2 for r in learn_rows)
    assert any(r["kind"] == "games" for r in rows)


def test_reuse_composes_with_device_sampling(tmp_path):
    """tests/test_replay_reuse.py:262-280: the frontier, the sample-ahead
    pusher (queue shrunk K-fold) and the mirror write-back feed K-pass
    steps, one popped batch per K learn steps, with no forbidden host sync."""
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex
    from rainbow_iqn_apex_tpu_torch.utils import hostsync

    cfg = _apex_cfg(tmp_path, "reuse_dev", device_sampling=True, sample_ahead_depth=2,
                    replay_ratio=2)
    with hostsync.forbid_host_sync():
        summary = train_apex(cfg, max_frames=448, device="cpu")
    assert summary["rollbacks"] == 0
    assert summary["learn_steps"] == 2 * (summary["frames"] // cfg.frames_per_learn)
    learn_rows = [r for r in _rows(cfg) if r["kind"] == "learn"]
    assert learn_rows and all(r["replay_ratio"] == 2 for r in learn_rows)


def test_publish_boundaries_mid_reuse_drain_cleanly(tmp_path):
    """tests/test_replay_reuse.py:305-330: K = 4 with publish, eval and
    checkpoint cadences not divisible by K still fire once per crossing."""
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex

    cfg = _apex_cfg(tmp_path, "reuse_pub", replay_ratio=4, reuse_clip=1.5,
                    weight_publish_interval=6, eval_interval=150, checkpoint_interval=202,
                    guard_snapshot_interval=10, metrics_interval=10, eval_episodes=1)
    summary = train_apex(cfg, max_frames=288, device="cpu")
    assert summary["rollbacks"] == 0
    assert summary["learn_steps"] == 4 * (288 // cfg.frames_per_learn)
    rows = _rows(cfg)
    learn_rows = [r for r in rows if r["kind"] == "learn"]
    assert learn_rows and all(r["replay_ratio"] == 4 and r["reuse_index"] in (None, 3)
                              for r in learn_rows)
    health = [r for r in rows if r["kind"] == "health" and r.get("weights_version") is not None]
    assert health and health[-1]["weights_version"] >= 3
    assert health[-1].get("replay_ratio") == 4
    assert sum(1 for r in rows if r["kind"] == "eval") >= 2


def test_sub_k_cadence_interval_is_rejected(tmp_path):
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex

    cfg = _apex_cfg(tmp_path, "reuse_subk", replay_ratio=4, weight_publish_interval=3)
    with pytest.raises(ValueError, match="replay_ratio"):
        train_apex(cfg, max_frames=64, device="cpu")
