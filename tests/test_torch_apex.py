"""The port's Ape-X driver and loop (rainbow_iqn_apex_tpu_torch.parallel.apex)
against the JAX package's, on the CPU through the plain twins.

The JAX ApexDriver runs on the 8-device virtual CPU platform of the test
harness (lanes and batch split 8 ways); the port's runs on the CPU.  Both
start from the same JAX TrainState (two learn steps in, carried across by
convert.py) and get the same taus and noise: the port through ``draws=``,
the JAX driver by monkeypatching ``jax.random.uniform`` / ``normal`` while
its act and learn executables trace (tests/test_torch_learn.py:_inject).

Tolerances, those of tests/test_torch_learn.py: fp32 q values, loss,
priorities and grad_norm rtol 1e-5; params, target params and Adam moments
after the step rtol 1e-4, atol 1e-6.  The estimator (numpy in both) and the
bf16 publish (one cast each way) are held exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu.parallel.apex import ActorPriorityEstimator as JaxEstimator
from rainbow_iqn_apex_tpu.parallel.apex import ApexDriver as JaxApexDriver
from rainbow_iqn_apex_tpu.parallel.mesh import replicated
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn
from rainbow_iqn_apex_tpu_torch.parallel.apex import (
    ActorPriorityEstimator,
    ApexDriver,
    train_apex,
)
from rainbow_iqn_apex_tpu_torch.train import train
from rainbow_iqn_apex_tpu_torch.utils import hostsync
from test_torch_learn import (
    NOISY,
    STEP_INFO,
    STEP_STATE,
    _adam,
    _close,
    _compare_states,
    _inject,
    _to_np,
    _warm_jax_state,
)

A = 3
L = B = 8  # lanes and batch: split over the 8 virtual CPU devices on the JAX side
SHAPE = (44, 44, 2)


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    """tests/test_torch_learn.py's learner at B 8 with 8 actor lanes."""
    base = dict(compute_dtype="float32", frame_height=SHAPE[0], frame_width=SHAPE[1],
                history_length=SHAPE[2], hidden_size=32, num_cosines=16, num_tau_samples=8,
                num_tau_prime_samples=8, num_quantile_samples=4, batch_size=B,
                learning_rate=1e-3, adam_eps=1.5e-4, max_grad_norm=10.0,
                target_update_period=100, num_envs_per_actor=L, role="apex")
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _drivers(**kw):
    """A JAX and a port driver holding the same warm state, each published."""
    jcfg, pcfg = _cfgs(**kw)
    jd = JaxApexDriver(jcfg, A, state_shape=SHAPE)
    jd.state = jax.device_put(_warm_jax_state(), replicated(jd.lmesh))
    jd.publish_weights()
    js = jd.state
    adam = _adam(js.opt_state)
    host = convert.from_flax_train_state(_to_np(js.params), _to_np(js.target_params),
                                         _to_np(adam.mu), _to_np(adam.nu), adam.count, js.step)
    pd = ApexDriver(pcfg, A, state_shape=SHAPE, device="cpu")
    pd.load_state(host, {})
    return jd, pd, pcfg


def _act_draws(cfg, feat, seed):
    """One act step's taus and per-layer noise."""
    rng = np.random.default_rng(seed)
    dims = [(feat, cfg.hidden_size), (cfg.hidden_size, 1), (feat, cfg.hidden_size),
            (cfg.hidden_size, A)]
    taus = rng.random((L, cfg.num_quantile_samples), dtype=np.float32)
    noise = {layer: (rng.standard_normal(i).astype(np.float32),
                     rng.standard_normal(o).astype(np.float32))
             for layer, (i, o) in zip(NOISY, dims)}
    return taus, noise


def _learn_draws(cfg, feat, seed):
    rng = np.random.default_rng(seed)
    dims = [(feat, cfg.hidden_size), (cfg.hidden_size, 1), (feat, cfg.hidden_size),
            (cfg.hidden_size, A)]
    out = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        out[name] = (rng.random((B, n), dtype=np.float32),
                     {layer: (rng.standard_normal(i).astype(np.float32),
                              rng.standard_normal(o).astype(np.float32))
                      for layer, (i, o) in zip(NOISY, dims)})
    return out


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _feat(pd):
    return pd.state.net.tau_embed.embed.weight.shape[0]


# ---------------------------------------------------------------- estimator
def test_actor_priority_estimator_equals_jax():
    rng = np.random.default_rng(0)
    ours, theirs = ActorPriorityEstimator(6, 3, 0.97), JaxEstimator(6, 3, 0.97)
    emitted = 0
    for _ in range(40):
        q = rng.normal(size=(6, 5)).astype(np.float32)
        a = rng.integers(0, 5, 6)
        r = rng.normal(size=6).astype(np.float32)
        d = rng.random(6) < 0.15
        got, want = ours.push(q, a, r, d), theirs.push(q, a, r, d)
        if want is None:
            assert got is None
            continue
        emitted += 1
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert emitted == 37


# ------------------------------------------------------------------ driver
def test_bf16_publish_equals_the_jax_cast_round_trip():
    jd, pd, _ = _drivers(bf16_weight_sync=True)
    want = convert.from_flax(_to_np(jd.actor_params))
    got = dict(pd.actor_net.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        assert torch.equal(got[name].detach().float(), w.float()), name
    learner = dict(pd.state.net.named_parameters())
    assert any(not torch.equal(learner[n].detach(), got[n].detach().float()) for n in got)


def test_act_frames_and_learn_batch_match_the_jax_driver(monkeypatch):
    jd, pd, pcfg = _drivers()
    feat = _feat(pd)
    taus, noise = _act_draws(pcfg, feat, 1)
    ldraws = _learn_draws(pcfg, feat, 2)
    uniforms = [taus] + [ldraws[k][0] for k in ("select", "target", "online")]
    normals = [a for layer in NOISY for a in noise[layer]]
    normals += [a for k in ("select", "target", "online") for layer in NOISY
                for a in ldraws[k][1][layer]]
    queues = _inject(monkeypatch, uniforms, normals)
    p_act = (_t(taus), {k: (_t(a), _t(b)) for k, (a, b) in noise.items()})
    rng = np.random.default_rng(3)
    cuts = np.zeros(L, bool)
    for tick in range(2):  # the second tick shifts the stack and zeroes cut lanes
        frames = rng.integers(0, 256, (L, *SHAPE[:2]), dtype=np.uint8)
        ja, jq = jd.act_frames(frames, cuts)  # the act executable traces once
        pa, pq = pd.act_frames(frames, cuts, draws=p_act)
        _close(pq, jq, STEP_INFO, f"tick {tick} q")
        top2 = np.sort(jq, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        assert np.array_equal(pa[clear], np.asarray(ja)[clear])
        cuts = rng.random(L) < 0.5
    assert torch.equal(pd.actor_stack, _t(jd.actor_stack))

    batch = dict(
        obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
        action=rng.integers(0, A, B).astype(np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        next_obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
        discount=np.where(rng.random(B) < 0.2, 0.0, 0.9 ** 3).astype(np.float32),
        weight=rng.uniform(0.5, 1.0, B).astype(np.float32),
    )
    jinfo = jd.learn_batch(jlearn.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}))
    pinfo = pd.learn_batch(plearn.Batch(**{k: _t(v) for k, v in batch.items()}),
                           draws={k: (_t(t), {n: (_t(a), _t(b)) for n, (a, b) in nz.items()})
                                  for k, (t, nz) in ldraws.items()})
    assert queues == ([], [])  # every draw was taken exactly once
    for key in ("loss", "priorities", "q_mean", "target_q_mean", "grad_norm"):
        _close(pinfo[key].numpy(), np.asarray(jinfo[key]), STEP_INFO, key)
    assert bool(pinfo["finite"]) and bool(jinfo["finite"])
    assert pd.step == int(jd.state.step)
    _compare_states(pd.state, jd.state, STEP_STATE)


def test_the_actor_copy_is_not_the_learners():
    """A learn step after a publish leaves the actor's actions unchanged
    (Adam updates the learner's tensors in place); the next publish moves
    them."""
    _, pcfg = _cfgs(bf16_weight_sync=False)
    pd = ApexDriver(pcfg, A, state_shape=SHAPE, device="cpu")
    feat = _feat(pd)
    taus, noise = _act_draws(pcfg, feat, 4)
    draws = (_t(taus), {k: (_t(a), _t(b)) for k, (a, b) in noise.items()})
    rng = np.random.default_rng(5)
    stack = rng.integers(0, 256, (L, *SHAPE), dtype=np.uint8)
    _, q0 = pd.act(stack, draws=draws)
    for _ in range(3):
        pd.learn_batch(plearn.Batch(
            obs=_t(rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8)),
            action=_t(rng.integers(0, A, B).astype(np.int32)),
            reward=_t(np.ones(B, np.float32)),
            next_obs=_t(rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8)),
            discount=_t(np.full(B, 0.9, np.float32)), weight=_t(np.ones(B, np.float32))))
    _, q1 = pd.act(stack, draws=draws)
    assert np.array_equal(q0, q1)
    version = pd.weights_version
    assert pd.publish_weights() == version + 1 and pd.actor_weights_version == version + 1
    _, q2 = pd.act(stack, draws=draws)
    assert not np.array_equal(q0, q2)
    for name, p in pd.actor_net.named_parameters():  # fp32 sync: an exact copy
        assert torch.equal(p, dict(pd.state.net.named_parameters())[name].detach())


# -------------------------------------------------------------------- loop
def _loop_cfg(tmp_path, **kw):
    """tests/test_device_sampling.py's _apex_cfg (catch renders 80x80)."""
    base = dict(
        env_id="toy:catch", compute_dtype="float32", frame_height=44, frame_width=44,
        history_length=2, hidden_size=32, num_cosines=8, num_tau_samples=4,
        num_tau_prime_samples=4, num_quantile_samples=4, batch_size=16, learning_rate=1e-3,
        multi_step=3, gamma=0.9, memory_capacity=2048, learn_start=256, frames_per_learn=2,
        target_update_period=100, num_envs_per_actor=8, metrics_interval=20,
        eval_interval=0, checkpoint_interval=0, eval_episodes=2, stall_timeout_s=0.0,
        writeback_depth=2, replay_shards=2, weight_publish_interval=40, seed=3, role="apex",
        sample_ahead_depth=2, results_dir=str(tmp_path / "results"),
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    base.update(kw)
    return Config(**base)


def _learn_rows(cfg):
    path = os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    learn = [(r["step"], r["frames"], r["loss"], r["q_mean"], r["mean_return"])
             for r in rows if r.get("kind") == "learn"]
    health = [r for r in rows if r.get("kind") == "health"]
    publishes = [r for r in rows if r.get("kind") == "publish"]
    return learn, health, publishes


@pytest.mark.parametrize("device_sampling", [False, True], ids=["host_sampling", "frontier"])
def test_seeded_apex_runs_repeat_exactly(tmp_path, device_sampling):
    """Two runs from one seed, both with no host sync on the learner thread
    outside the sanctioned points (with device sampling, host sampling itself
    is forbidden there): learn steps, no rollback, the same learn rows and
    final eval, publishes every 40 steps, the sample-ahead gauges only with
    the frontier.  The first goes through the CLI's route."""
    runs = []
    for name in ("a", "b"):
        cfg = _loop_cfg(tmp_path / name, device_sampling=device_sampling)
        with hostsync.forbid_host_sync():
            if name == "a":
                summary = train(cfg, max_frames=520, device="cpu")
            else:
                summary = train_apex(cfg, max_frames=520, device="cpu")
        assert summary["learn_steps"] > 100 and summary["rollbacks"] == 0
        learn, health, publishes = _learn_rows(cfg)
        # ApexDriver's first publish precedes the run's metrics logger
        assert learn and len(publishes) == summary["learn_steps"] // 40
        pipeline = [r for r in health if "writeback_inflight" in r]
        assert pipeline and all(("sample_ahead_queue_depth" in r) == device_sampling
                                for r in pipeline)
        runs.append((learn, summary["eval_score_mean"], summary["learn_steps"]))
    assert runs[0] == runs[1]


def test_resume_restores_counters_replay_and_mirror_and_beats_leases(tmp_path):
    """A device-sampling run with checkpoints, replay snapshots and lease
    heartbeats, then a resumed run: it starts from the checkpoint's step,
    frames and weight version, with the replay (and so the mirror) restored,
    so it learns on its first tick; the lease carries the weight version."""
    cfg = _loop_cfg(tmp_path, device_sampling=True, checkpoint_interval=50,
                    snapshot_replay=True, heartbeat_interval_s=0.05)
    first = train_apex(cfg, max_frames=400, device="cpu")
    assert first["learn_steps"] == 200
    lease_path = os.path.join(cfg.results_dir, cfg.run_id, "heartbeats", "h0.json")
    with open(lease_path) as f:
        lease = json.load(f)
    assert lease["role"] == "apex" and lease["weight_version"] >= 1
    second = train_apex(cfg.replace(resume=True), max_frames=480, device="cpu")
    assert second["frames"] == 480 and second["learn_steps"] == 240
    rows = [json.loads(line) for line in open(
        os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl"))]
    resume = [r for r in rows if r["kind"] == "resume"]
    assert resume and resume[0]["step"] == 200 and resume[0]["frames"] == 400
    after = rows[rows.index(resume[0]):]
    publishes = [r["version"] for r in after if r["kind"] == "publish"]
    assert publishes and publishes[0] > max(r["version"] for r in rows[:rows.index(resume[0])]
                                            if r["kind"] == "publish")


def test_nan_step_rolls_back_with_the_frontier(tmp_path):
    """The ``nan_loss`` fault point with device sampling: the poisoned step
    quarantines every in-flight id set in the mirror, the learner rolls
    back, and the run ends with finite losses."""
    cfg = _loop_cfg(tmp_path, device_sampling=True, fault_spec="nan_loss@5",
                    guard_snapshot_interval=3, max_nan_strikes=2)
    summary = train_apex(cfg, max_frames=400, device="cpu")
    assert summary["rollbacks"] == 1 and summary["learn_steps"] > 0
    learn, _, _ = _learn_rows(cfg)
    assert learn and all(np.isfinite(r[2]) for r in learn)


@pytest.mark.parametrize("kw", [
    dict(league_dir="league"), dict(league_member_id=0),
    dict(serve_quantize="int8", games="toy:catch,toy:chain"),
    dict(replay_net_remote=True), dict(failover_standby=True),
    dict(device_sampling=True, games="toy:catch,toy:chain"), dict(process_count=2),
    dict(learner_devices=1),
    dict(architecture="r2d2"),
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError):
        train_apex(_loop_cfg(tmp_path, **kw), max_frames=16, device="cpu")
