"""The port's fully fused Anakin (``train_anakin_fused``: act -> K12 env tick
-> K7 append -> learn, all on the device) against the JAX package's: one-tick
segments from the same converted TrainState and carry, past the warm gate
and a target copy; the in-graph eval with injected taus; and the trainer end
to end on the CPU (the JAX tests' lifecycle: learn cadence, metrics, eval,
checkpoint, resume, the refusals).

The env side needs no injection: both packages draw the games' randomness
from JAX's Threefry stream.  The network's taus and noise and the sampler's
uniforms go to the port through ``draws=`` and to the jitted JAX segment by
monkeypatching ``jax.random.uniform`` / ``normal`` (tests/test_torch_anakin.py's
technique; catch draws nothing through the patched ``uniform``).  With
``anakin_segment_ticks`` 1 and ``frames_per_learn`` = lanes each traced draw
is used once per segment.

Tolerances (fp32): env states, frames, the stack and the ring's frames,
actions, rewards, terminals and cuts bit-equal; loss, q_mean, grad_norm, the
ring's priorities and max priority 1e-5 relative; params and target params
1e-4 relative, 1e-6 absolute (as tests/test_torch_anakin.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu import train_anakin as jfused
from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.envs import device_games as jgames
from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from rainbow_iqn_apex_tpu.replay.device import build_device_learn as jax_build_device_learn
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch import train_anakin as pfused
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.envs import device_games as pgames
from rainbow_iqn_apex_tpu_torch.envs import prng
from rainbow_iqn_apex_tpu_torch.kernels import launches
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn
from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, build_device_learn
from rainbow_iqn_apex_tpu_torch.train import main
from test_torch_learn import NOISY, _adam, _to_np

LANES, SEG, HIST = 4, 32, 2
INFO = dict(rtol=1e-5, atol=1e-7)
PARAMS = dict(rtol=1e-4, atol=1e-6)
RING_EXACT = ("frames", "actions", "rewards", "terminals", "cuts")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    base = dict(env_id="jaxgame:catch", role="anakin", compute_dtype="float32",
                history_length=HIST, hidden_size=32, num_cosines=8, num_tau_samples=4,
                num_tau_prime_samples=4, num_quantile_samples=2, batch_size=8, multi_step=2,
                gamma=0.9, learning_rate=1e-3, target_update_period=3,
                num_envs_per_actor=LANES, frames_per_learn=LANES, anakin_segment_ticks=1,
                memory_capacity=LANES * SEG, learn_start=32, t_max=4000, learner_devices=1)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _noise(rng, feat, hidden, actions):
    dims = [(feat, hidden), (hidden, 1), (feat, hidden), (hidden, actions)]
    return {layer: (rng.standard_normal(i).astype(np.float32),
                    rng.standard_normal(o).astype(np.float32))
            for layer, (i, o) in zip(NOISY, dims)}


def _tick_draws(cfg, feat, actions, rng):
    """One tick's draws: the act step's (taus, noise), the sampler's
    uniforms and the learn step's (taus, noise) of its three forwards."""
    act = (rng.random((LANES, cfg.num_quantile_samples), dtype=np.float32),
           _noise(rng, feat, cfg.hidden_size, actions))
    u = rng.random(cfg.batch_size, dtype=np.float32)
    learn = {name: (rng.random((cfg.batch_size, n), dtype=np.float32),
                    _noise(rng, feat, cfg.hidden_size, actions))
             for name, n in (("select", cfg.num_quantile_samples),
                             ("target", cfg.num_tau_prime_samples),
                             ("online", cfg.num_tau_samples))}
    return act, u, learn


def _jax_queues(act, u, learn):
    uniforms = [act[0], u] + [learn[n][0] for n in ("select", "target", "online")]
    normals = [a for layer in NOISY for a in act[1][layer]]
    for n in ("select", "target", "online"):
        normals += [a for layer in NOISY for a in learn[n][1][layer]]
    return uniforms, normals


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_tick(act, u, learn):
    noise = lambda n: {k: (_t(a), _t(b)) for k, (a, b) in n.items()}  # noqa: E731
    return {"act": {"taus": _t(act[0]), "noise": noise(act[1])},
            "learn": [{"u": _t(u), "draws": {k: (_t(t), noise(n)) for k, (t, n) in learn.items()}}]}


def _patch(monkeypatch, queues):
    uq, nq = queues
    real_uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if (minval, maxval) != (0.0, 1.0):
            return real_uniform(key, shape, dtype, minval, maxval)
        arr = uq.pop(0)
        assert arr.shape == tuple(shape)
        return arr.astype(dtype)

    def fake_normal(key, shape=(), dtype=jnp.float32):
        arr = nq.pop(0)
        assert arr.shape == tuple(shape)
        return arr.astype(dtype)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jax.random, "normal", fake_normal)


def test_fused_segment_matches_jax(monkeypatch):
    """16 one-tick segments: warm from the 8th (32 stored), one learn step a
    tick, target copies every 3 steps.  Each tick: lanes, stack and ring
    bit-equal, losses and priorities 1e-5; at the end params 1e-4."""
    jcfg, pcfg = _cfgs()
    jgame, pgame = jgames.make_device_game("catch"), pgames.make_device_game("catch")
    A = jgame.num_actions
    kw = dict(lanes=LANES, seg=SEG, frame_shape=(80, 80), history=HIST, n_step=2, gamma=0.9)
    jdev, pdev = JaxDeviceReplay(**kw), DeviceReplay(**kw, device="cpu")
    jts = jlearn.init_train_state(jcfg, A, jax.random.PRNGKey(0), state_shape=(80, 80, HIST))
    adam = _adam(jts.opt_state)
    pts = plearn.load_host_state(
        plearn.init_train_state(pcfg, A, seed=0, state_shape=(80, 80, HIST), device="cpu"),
        convert.from_flax_train_state(_to_np(jts.params), _to_np(jts.target_params),
                                      _to_np(adam.mu), _to_np(adam.nu), adam.count, jts.step))
    k_env = jax.random.PRNGKey(17)
    jcarry = jfused.init_fused_carry(jcfg, jgame, jdev, jts, jdev.init_state(), k_env)
    env_s, ep, stack, frame, keep = convert.from_jax_fused_carry(
        *jax.device_get(jcarry[2:7]))
    pcarry = (pts, pdev.init_state(), env_s, ep, stack, frame, keep, 0)
    # the port's own init gives the same lanes
    p_init = pfused.init_fused_carry(pcfg, pgame, pdev, pts, None, torch.from_numpy(
        np.asarray(k_env).astype(np.int64)))
    want_lanes = convert.game_state_arrays(env_s)
    for name, got in convert.game_state_arrays(p_init[2]).items():
        np.testing.assert_array_equal(got, want_lanes[name], err_msg=name)
    assert torch.equal(p_init[5], frame)

    queues = ([], [])
    _patch(monkeypatch, queues)
    jsegment = jfused.build_fused_segment(jcfg, jgame, jdev, jax_build_device_learn(jcfg, A, jdev))

    def run(carry, key, uniforms, normals):
        queues[0][:], queues[1][:] = list(uniforms), list(normals)
        out = jsegment(carry, key)
        assert not queues[0] and not queues[1]
        return out

    jrun = jax.jit(run)
    psegment = pfused.build_fused_segment(pcfg, pgame, pdev, build_device_learn(pcfg, A, pdev))
    feat = jts.params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    rng = np.random.default_rng(23)
    warm_ticks = 0
    for t in range(16):
        key = jax.random.fold_in(jax.random.PRNGKey(99), t)
        act, u, learn = _tick_draws(pcfg, feat, A, rng)
        jcarry, jouts = jrun(jcarry, key, *_jax_queues(act, u, learn))
        pcarry, pouts = psegment(pcarry, torch.from_numpy(np.asarray(key).astype(np.int64)),
                                 None, draws=[_port_tick(act, u, learn)])
        what = f"tick {t}"
        jl = jax.device_get(jcarry)
        got = convert.fused_carry_arrays(*pcarry[2:7])
        for name, want in jl[2]._asdict().items():
            np.testing.assert_array_equal(got["env_s"][name], np.asarray(want), err_msg=what)
        for i, name in enumerate(("ep", "stack", "frame", "keep")):
            np.testing.assert_array_equal(got[name], np.asarray(jl[3 + i]), err_msg=f"{what} {name}")
        assert pcarry[7] == int(jl[7])
        for name in RING_EXACT:
            np.testing.assert_array_equal(getattr(pcarry[1], name).numpy(),
                                          np.asarray(getattr(jl[1], name)), err_msg=f"{what} {name}")
        assert (pcarry[1].pos, pcarry[1].filled) == (int(jl[1].pos), int(jl[1].filled))
        np.testing.assert_allclose(pcarry[1].priority.numpy(), np.asarray(jl[1].priority),
                                   err_msg=f"{what} priority", **INFO)
        np.testing.assert_allclose(pcarry[1].max_priority.numpy(), np.asarray(jl[1].max_priority),
                                   **INFO)
        np.testing.assert_array_equal(pouts[0].numpy(), np.asarray(jouts[0]), err_msg=what)
        for p_out, j_out in zip(pouts[1:], jouts[1:]):
            np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), err_msg=what, **INFO)
        warm_ticks += int(np.isfinite(np.asarray(jouts[1])).all())
    assert warm_ticks == 9 and pcarry[0].step == int(jcarry[0].step) == 9
    want = convert.from_flax(_to_np(jcarry[0].params))
    want_target = convert.from_flax(_to_np(jcarry[0].target_params))
    for name, got in pcarry[0].net.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), err_msg=name, **PARAMS)
    for name, got in pcarry[0].target.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want_target[name].numpy(), err_msg=name, **PARAMS)


def test_fused_beta_is_the_graphs_fp32():
    _, pcfg = _cfgs(t_max=3_000_000, priority_weight=0.4)
    for frames in (0, 16, 123_456, 2_999_999, 4_000_000):
        want = jnp.float32(0.4 + (1.0 - 0.4) * jnp.minimum(jnp.int32(frames) / 3_000_000.0, 1.0))
        assert np.float32(pfused.fused_beta(pcfg, frames)) == np.asarray(want)


def test_fused_eval_matches_jax_at_injected_taus(monkeypatch):
    """build_fused_eval: greedy lanes of catch for a 24-tick budget, the same
    taus every tick on both sides: equal first-episode returns."""
    jcfg, pcfg = _cfgs()
    jgame, pgame = jgames.make_device_game("catch"), pgames.make_device_game("catch")
    jts = jlearn.init_train_state(jcfg, 3, jax.random.PRNGKey(2), state_shape=(80, 80, HIST))
    pts = plearn.init_train_state(pcfg, 3, seed=0, state_shape=(80, 80, HIST), device="cpu")
    pts.net.load_state_dict(convert.from_flax(_to_np(jts.params)))
    episodes, ticks = 6, 24
    taus = np.random.default_rng(1).random((episodes, pcfg.num_quantile_samples),
                                           dtype=np.float32)
    _patch(monkeypatch, ([taus], []))
    jeval = jfused.build_fused_eval(jcfg, jgame, episodes, max_ticks=ticks)
    key = jax.random.PRNGKey(977)
    want = np.asarray(jeval(jts.params, key))
    peval = pfused.build_fused_eval(pcfg, pgame, episodes, max_ticks=ticks, device="cpu")
    got = peval(pts.net, torch.from_numpy(np.asarray(key).astype(np.int64)),
                taus=[torch.from_numpy(taus)] * ticks)
    np.testing.assert_array_equal(got.numpy(), want)
    scores = pfused.fused_eval_scores(
        lambda net, k, g: peval(net, k, g, taus=[torch.from_numpy(taus)] * ticks), pts.net,
        torch.from_numpy(np.asarray(key).astype(np.int64)))
    assert scores["episodes"] == episodes and scores["score_mean"] == float(want.mean())


# ------------------------------------------------------------- the trainer
def _cfg(tmp_path, **kw):
    """tests/test_anakin_fused.py's scenario, narrowed."""
    base = dict(
        env_id="jaxgame:catch", role="anakin", compute_dtype="float32", history_length=2,
        hidden_size=32, num_cosines=8, num_tau_samples=4, num_tau_prime_samples=4,
        num_quantile_samples=2, batch_size=16, learning_rate=1e-3, multi_step=3, gamma=0.9,
        memory_capacity=4096, learn_start=256, frames_per_learn=4, target_update_period=100,
        num_envs_per_actor=8, anakin_segment_ticks=16, learner_devices=1, metrics_interval=25,
        eval_interval=0, checkpoint_interval=0, eval_episodes=4,
        results_dir=str(tmp_path / "results"), checkpoint_dir=str(tmp_path / "ckpt"), seed=3)
    base.update(kw)
    return Config(**base)


def _rows(cfg):
    with open(os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fused_smoke_end_to_end(tmp_path):
    """The CLI on the CPU: segments of 16 ticks, two learn steps a warm tick
    (warm at tick 32: 256 stored), finite learn rows, an eval row, a
    checkpoint; the plain twin of K12 ran (no launch counted)."""
    cfg = _cfg(tmp_path, checkpoint_interval=100)
    before = launches["K12_device_games"]
    argv = ["--role", "anakin", "--device", "cpu", "--max-frames", "1024"]
    for name in ("env_id", "compute_dtype", "history_length", "hidden_size", "num_cosines",
                 "num_tau_samples", "num_tau_prime_samples", "num_quantile_samples",
                 "batch_size", "learning_rate", "multi_step", "gamma", "memory_capacity",
                 "learn_start", "frames_per_learn", "target_update_period",
                 "num_envs_per_actor", "anakin_segment_ticks", "learner_devices",
                 "metrics_interval", "eval_interval", "checkpoint_interval", "eval_episodes",
                 "results_dir", "checkpoint_dir", "seed"):
        argv += ["--" + name.replace("_", "-"), str(getattr(cfg, name))]
    summary = main(argv)
    assert summary["frames"] == 1024
    assert summary["learn_steps"] == (1024 // 8 - 31) * 2  # 97 warm ticks x 2
    assert np.isfinite(summary["eval_score_mean"]) and summary["eval_episodes"] == 4
    rows = _rows(cfg)
    learn = [r for r in rows if r["kind"] == "learn"]
    assert learn and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in learn)
    assert any(r["kind"] == "eval" for r in rows)
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, cfg.run_id, "step_000000194.pt"))
    assert launches["K12_device_games"] == before


def test_fused_resume_continues_counters(tmp_path):
    """A resumed run continues from the checkpoint's step and frames with the
    ring restored: it learns from its first tick, on the in-graph cadence."""
    cfg = _cfg(tmp_path, checkpoint_interval=50, snapshot_replay=True)
    first = pfused.train_anakin(cfg, max_frames=640, device="cpu")
    assert first["learn_steps"] == (640 // 8 - 31) * 2
    second = pfused.train_anakin(cfg.replace(resume=True), max_frames=1280, device="cpu")
    assert second["frames"] == 1280
    assert second["learn_steps"] == first["learn_steps"] + (1280 - 640) // 8 * 2
    rows = _rows(cfg)
    resume = [r for r in rows if r["kind"] == "resume"]
    assert resume and resume[0]["step"] == first["learn_steps"] and resume[0]["frames"] == 640


def test_fused_refusals(tmp_path):
    with pytest.raises(ValueError, match="divisible by frames_per_learn"):
        pfused.train_anakin(_cfg(tmp_path, num_envs_per_actor=6), max_frames=100, device="cpu")
    with pytest.raises(ValueError, match="not divisible by"):
        pfused.train_anakin(_cfg(tmp_path, memory_capacity=4100), max_frames=100, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        pfused.train_anakin(_cfg(tmp_path, learner_devices=4), max_frames=100, device="cpu")


def test_fused_host_loop_flag(tmp_path):
    """fused_env=False drives the same device game through the host anakin
    loop (JaxGameEnv lanes)."""
    summary = pfused.train_anakin(_cfg(tmp_path, fused_env=False), max_frames=600, device="cpu")
    assert summary["frames"] >= 600 and summary["learn_steps"] > 0


def test_fused_needs_cuda_unless_cpu_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfused.train_anakin(_cfg(tmp_path), max_frames=100)


def test_port_key_stream_of_the_trainer():
    """The trainer's host key schedule is JAX's: PRNGKey(seed) split into
    (key, k_init, k_env), then one split per segment."""
    key = prng.prng_key(3)
    key, _, k_env = prng.split(key, 3)
    jkey, _, jk_env = jax.random.split(jax.random.PRNGKey(3), 3)
    assert k_env.tolist() == np.asarray(jk_env).astype(np.int64).tolist()
    assert prng.split(key, 2)[1].tolist() == np.asarray(jax.random.split(jkey)[1]).tolist()
