"""The port's Anakin learner against the JAX package's: the fused
sample -> learn -> write-back step (``build_device_learn``) from the same
converted TrainState and replay state, and ``train_anakin`` end to end on
the CPU (learn steps on schedule, metrics, eval, resume with the replay
snapshot).

Both fused steps get the same draws: the port through ``u=`` (the
sampler's uniforms) and ``draws=`` (taus and noise), the jitted JAX step by
monkeypatching ``jax.random.uniform`` / ``normal``, whose queues are fed
from the jitted function's own arguments at trace time (the technique of
tests/test_torch_learn.py ``_jax_step``, whose draw helpers this file
reuses).

Tolerances (fp32): loss, priorities and the replay's priority vector after
the write-back 1e-5 relative; params and target params 1e-4 relative with
an absolute floor of 1e-6 (Adam divides by sqrt(nu), which amplifies the
fp32 differences of small gradients).
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
from rainbow_iqn_apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from rainbow_iqn_apex_tpu.replay.device import build_device_learn as jax_build_device_learn
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn
from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, build_device_learn
from rainbow_iqn_apex_tpu_torch.train import main
from rainbow_iqn_apex_tpu_torch.train_anakin import _maybe_restore_replay, train_anakin
from test_torch_learn import NOISY, _adam, _jax_draws, _port_draws, _to_np

A = 4
L, S = 2, 24
FRAME = (44, 44)
HIST, NSTEP, GAMMA = 3, 2, 0.9
B = 8
INFO = dict(rtol=1e-5, atol=1e-7)
PARAMS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs():
    base = dict(compute_dtype="float32", frame_height=FRAME[0], frame_width=FRAME[1],
                history_length=HIST, hidden_size=32, num_cosines=8, num_tau_samples=4,
                num_tau_prime_samples=4, num_quantile_samples=2, batch_size=B,
                multi_step=NSTEP, gamma=GAMMA, learning_rate=1e-3, target_update_period=2)
    return JaxConfig(**base), Config(**base)


def _jax_replay_state(jdev):
    rng = np.random.default_rng(5)
    append = jax.jit(jdev.append)
    ds = jdev.init_state()
    for _ in range(2 * S):
        term = rng.random(L) < 0.08
        ds = append(ds, jnp.asarray(rng.integers(0, 255, (L, *FRAME), dtype=np.uint8)),
                    jnp.asarray(rng.integers(0, A, L).astype(np.int32)),
                    jnp.asarray(rng.normal(size=L).astype(np.float32)), jnp.asarray(term),
                    jnp.asarray((rng.random(L) < 0.05) & ~term),
                    jnp.asarray(rng.random(L).astype(np.float32) + 0.05))
    return ds


def _draws(cfg, feat, rng):
    """The sampler's uniforms [B] and the learn step's (taus, noise) of the
    select, target and online forwards."""
    dims = [(feat, cfg.hidden_size), (cfg.hidden_size, 1), (feat, cfg.hidden_size),
            (cfg.hidden_size, A)]
    u = rng.random(B, dtype=np.float32)
    out = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        taus = rng.random((B, n), dtype=np.float32)
        noise = {layer: (rng.standard_normal(i).astype(np.float32),
                         rng.standard_normal(o).astype(np.float32))
                 for layer, (i, o) in zip(NOISY, dims)}
        out[name] = (taus, noise)
    return u, out


def _jax_fused(jcfg, jdev, monkeypatch):
    """The jitted JAX fused step; the draws go in as arguments and the
    monkeypatched jax.random functions hand them out while it traces."""
    uq, nq = [], []
    real_uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if (minval, maxval) != (0.0, 1.0):  # flax's initialiser shape checks
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
    fused = jax_build_device_learn(jcfg, A, jdev)

    def run(ts, ds, key, beta, uniforms, normals):
        uq[:], nq[:] = list(uniforms), list(normals)
        out = fused(ts, ds, key, beta)
        assert not uq and not nq  # every draw consumed exactly once
        return out

    return jax.jit(run)


def _jax_args(u, draws):
    """The fused step's draws in call order: the sampler's, then the learn step's."""
    uniforms, normals = _jax_draws(draws)
    return [u, *uniforms], normals


@pytest.mark.parametrize("steps", [1, 3])
def test_fused_learn_matches_jax(monkeypatch, steps):
    """One and three fused steps (the third crosses a target copy) from the
    same states and draws: loss, priorities, the replay's priority vector
    and max priority after each write-back, then params and target params."""
    jcfg, pcfg = _cfgs()
    jdev = JaxDeviceReplay(lanes=L, seg=S, frame_shape=FRAME, history=HIST, n_step=NSTEP,
                           gamma=GAMMA)
    pdev = DeviceReplay(lanes=L, seg=S, frame_shape=FRAME, history=HIST, n_step=NSTEP,
                        gamma=GAMMA, device="cpu")
    jds = _jax_replay_state(jdev)
    jts = jlearn.init_train_state(jcfg, A, jax.random.PRNGKey(0), state_shape=(*FRAME, HIST))
    adam = _adam(jts.opt_state)
    pts = plearn.load_host_state(
        plearn.init_train_state(pcfg, A, seed=0, state_shape=(*FRAME, HIST), device="cpu"),
        convert.from_flax_train_state(_to_np(jts.params), _to_np(jts.target_params),
                                      _to_np(adam.mu), _to_np(adam.nu), adam.count, jts.step))
    pds = convert.from_jax_device_replay_state(jax.device_get(jds), device="cpu")
    jfused = _jax_fused(jcfg, jdev, monkeypatch)
    pfused = build_device_learn(pcfg, A, pdev)
    feat = jts.params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    rng = np.random.default_rng(11)
    for k in range(steps):
        u, draws = _draws(pcfg, feat, rng)
        beta = 0.4 + 0.1 * k
        jts, jds, jinfo = jfused(jts, jds, jax.random.PRNGKey(k), jnp.float32(beta),
                                 *_jax_args(u, draws))
        pts, pds, pinfo = pfused(pts, pds, None, beta, u=torch.from_numpy(u),
                                 draws=_port_draws(draws))
        for key in ("loss", "priorities", "q_mean", "grad_norm"):
            np.testing.assert_allclose(pinfo[key].numpy(), np.asarray(jinfo[key]),
                                       err_msg=f"step {k}: {key}", **INFO)
        np.testing.assert_allclose(pds.priority.numpy(), np.asarray(jds.priority),
                                   err_msg=f"step {k}: replay priority", **INFO)
        np.testing.assert_allclose(pds.max_priority.numpy(), np.asarray(jds.max_priority),
                                   **INFO)
    assert pts.step == int(jts.step) == steps
    want = convert.from_flax(_to_np(jts.params))
    want_target = convert.from_flax(_to_np(jts.target_params))
    for name, got in pts.net.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), err_msg=name, **PARAMS)
    for name, got in pts.target.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want_target[name].numpy(), err_msg=name,
                                   **PARAMS)


# ------------------------------------------------------------- the trainer
def _cfg(tmp_path, **kw):
    """tests/test_anakin.py's scenario, narrowed."""
    base = dict(
        env_id="toy:catch", role="anakin", compute_dtype="float32", frame_height=44,
        frame_width=44, history_length=2, hidden_size=32, num_cosines=16, num_tau_samples=8,
        num_tau_prime_samples=8, num_quantile_samples=4, batch_size=16, learning_rate=1e-3,
        multi_step=3, gamma=0.9, memory_capacity=4096, learn_start=256, frames_per_learn=4,
        target_update_period=100, num_envs_per_actor=8, metrics_interval=25,
        eval_interval=0, checkpoint_interval=0, eval_episodes=2,
        results_dir=str(tmp_path / "results"), checkpoint_dir=str(tmp_path / "ckpt"), seed=3,
    )
    base.update(kw)
    return Config(**base)


def _rows(cfg):
    with open(os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_anakin_smoke_end_to_end(tmp_path):
    """The CLI on the CPU: learn steps on the frames_per_learn schedule,
    finite learn rows, an eval row, a checkpoint at the last step."""
    cfg = _cfg(tmp_path)
    argv = ["--role", "anakin", "--device", "cpu", "--max-frames", "1000"]
    for name in ("env_id", "compute_dtype", "frame_height", "frame_width", "history_length",
                 "hidden_size", "num_cosines", "num_tau_samples", "num_tau_prime_samples",
                 "num_quantile_samples", "batch_size", "learning_rate", "multi_step", "gamma",
                 "memory_capacity", "learn_start", "frames_per_learn", "target_update_period",
                 "num_envs_per_actor", "metrics_interval", "eval_interval",
                 "checkpoint_interval", "eval_episodes", "results_dir", "checkpoint_dir",
                 "seed"):
        argv += ["--" + name.replace("_", "-"), str(getattr(cfg, name))]
    summary = main(argv)
    assert summary["frames"] == 1000
    # warm at tick 33 (256 stored, appends lag a tick), then on schedule
    assert summary["learn_steps"] == 1000 // cfg.frames_per_learn
    assert np.isfinite(summary["eval_score_mean"])
    rows = _rows(cfg)
    learn = [r for r in rows if r["kind"] == "learn"]
    assert [r["step"] for r in learn] == list(range(25, 251, 25))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in learn)
    assert any(r["kind"] == "eval" for r in rows)
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, cfg.run_id, "step_000000250.pt"))


def test_anakin_resume_continues_counters_and_replay(tmp_path):
    """A resumed run starts from the checkpoint's step and frames with the
    ring restored from its snapshot: it learns on its first tick, where a
    cold ring would wait ~33 ticks to warm up again."""
    cfg = _cfg(tmp_path, checkpoint_interval=50, snapshot_replay=True, metrics_interval=1)
    first = train_anakin(cfg, max_frames=600, device="cpu")
    assert first["learn_steps"] == 150
    # catch renders 80 x 80 frames whatever the config's frame size
    pdev = DeviceReplay(lanes=8, seg=512, frame_shape=(80, 80), history=2, n_step=3,
                        gamma=0.9, device="cpu")
    restored = pdev.init_state()
    # 75 ticks, 74 appends: each tick appends the one before it
    assert _maybe_restore_replay(cfg, restored) == 600 // 8 - 1
    assert (restored.pos, restored.filled) == (74, 74) and float(restored.priority.sum()) > 0

    second = train_anakin(cfg.replace(resume=True), max_frames=1000, device="cpu")
    assert second["frames"] == 1000 and second["learn_steps"] == 250
    rows = _rows(cfg)
    resume = [r for r in rows if r["kind"] == "resume"]
    assert resume and resume[0]["step"] == 150 and resume[0]["frames"] == 600
    after = [r for r in rows[rows.index(resume[0]):] if r["kind"] == "learn"]
    assert after[0]["frames"] == 600 + 8 and after[0]["step"] == 151
