"""The port's R2D2 Anakin trainer (rainbow_iqn_apex_tpu_torch.
train_anakin_r2d2) against the JAX package's train_anakin_r2d2.py, on the
CPU: the geometry and cadence helpers equal JAX's, the ring snapshot crosses
both ways under the JAX file name and fields, and the host-fed loop runs end
to end at tests/test_anakin_r2d2_fused.py's host-fed sizes (learn steps,
finite eval, checkpoint, resume, the CLI), with the unported options
refused.  The fused steps of the loop are held to JAX in
tests/test_torch_device_sequence.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu import train_anakin_r2d2 as jtrain
from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu_torch import train_anakin_r2d2 as ptrain
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.train import main, train
from test_torch_device_sequence import _assert_same_ring, _drive, _pair


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(tmp_path, cls=Config, **kw):
    """tests/test_anakin_r2d2_fused.py's configuration, host-fed on toy:catch."""
    base = dict(
        env_id="toy:catch", architecture="r2d2", role="anakin", compute_dtype="float32",
        history_length=2, hidden_size=32, lstm_size=16, r2d2_burn_in=2, r2d2_seq_len=8,
        r2d2_overlap=4, batch_size=16, learning_rate=1e-3, multi_step=2, gamma=0.9,
        memory_capacity=2_000, learn_start=200, frames_per_learn=2, target_update_period=100,
        num_envs_per_actor=8, metrics_interval=10, eval_interval=0, checkpoint_interval=0,
        eval_episodes=4, results_dir=str(tmp_path / "results"),
        checkpoint_dir=str(tmp_path / "ckpt"), seed=3)
    base.update(kw)
    return cls(**base)


def _rows(cfg):
    with open(os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------- pure helpers
@pytest.mark.parametrize("kw", [
    {}, dict(memory_capacity=1_000_000, learn_start=20_000, r2d2_burn_in=40, r2d2_seq_len=80,
             r2d2_overlap=40), dict(memory_capacity=100, learn_start=5, r2d2_overlap=0),
    dict(r2d2_overlap=20)], ids=["test", "reference", "tiny", "overlap_past_L"])
def test_seq_geometry_matches_jax(tmp_path, kw):
    assert ptrain._seq_geometry(_cfg(tmp_path, **kw)) == jtrain._seq_geometry(
        _cfg(tmp_path, JaxConfig, **kw))


@pytest.mark.parametrize("kw", [{}, dict(num_envs_per_actor=32), dict(num_envs_per_actor=16),
                                dict(num_envs_per_actor=12), dict(num_envs_per_actor=7)],
                         ids=["period", "per_tick", "one", "indivisible", "prime"])
def test_learn_cadence_matches_jax(tmp_path, kw):
    pcfg, jcfg = _cfg(tmp_path, **kw), _cfg(tmp_path, JaxConfig, **kw)
    try:
        want = jtrain._learn_cadence(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ptrain._learn_cadence(pcfg)
        assert str(got.value) == str(e) and "divide one another" in str(e)
        return
    assert ptrain._learn_cadence(pcfg) == want


# --------------------------------------------------------------- snapshot
def _snap_cfg(tmp_path, cls):
    cfg = _cfg(tmp_path, cls, snapshot_replay=True)
    os.makedirs(os.path.join(cfg.checkpoint_dir, cfg.run_id), exist_ok=True)  # as the trainers do
    return cfg


def test_a_jax_snapshot_loads_into_the_port_and_back(tmp_path):
    jdev, pdev = _pair()
    js, ps_want = _drive(jdev, pdev, 30, seed=21)
    jtrain._save_replay(_snap_cfg(tmp_path, JaxConfig), js)
    path = ptrain._replay_snapshot_path(_snap_cfg(tmp_path, Config))
    assert os.path.basename(path) == "replay_anakin_r2d2.npz" and os.path.exists(path)
    ps = ptrain._maybe_restore_replay(_snap_cfg(tmp_path, Config), pdev.init_state())
    _assert_same_ring(js, ps)

    # the port's snapshot, read by JAX
    os.remove(path)
    ptrain._save_replay(_snap_cfg(tmp_path, Config), ps_want)
    back = jtrain._maybe_restore_replay(_snap_cfg(tmp_path, JaxConfig), jdev.init_state())
    _assert_same_ring(back, ps_want)
    assert int(back.pos) == ps_want.pos and back.buf_len.dtype == jnp.int32


def test_a_snapshot_of_another_geometry_leaves_the_ring_cold(tmp_path):
    jdev, pdev = _pair()
    js, _ = _drive(jdev, pdev, 30, seed=22)
    jtrain._save_replay(_snap_cfg(tmp_path, JaxConfig), js)
    _, other = _pair(seq_len=7, stride=3)
    ps = ptrain._maybe_restore_replay(_snap_cfg(tmp_path, Config), other.init_state())
    assert ps.filled == 0 and float(ps.priority.sum()) == 0.0


# ------------------------------------------------------------- the trainer
def test_hostfed_trainer_learns_checkpoints_and_resumes(tmp_path):
    """tests/test_anakin_r2d2_fused.py::test_hostfed_anakin_r2d2_smoke's run
    (1,200 frames, more than 20 learn steps, a finite eval), with a
    checkpoint and a ring snapshot; the resumed run starts from that step,
    frame count and ring and continues."""
    cfg = _cfg(tmp_path, checkpoint_interval=20, snapshot_replay=True)
    first = ptrain.train_anakin_r2d2(cfg, max_frames=1_200, device="cpu")
    assert first["frames"] == 1_200 and first["learn_steps"] > 20
    assert np.isfinite(first["eval_score_mean"])
    rows = _rows(cfg)
    learn = [r for r in rows if r["kind"] == "learn"]
    assert learn and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in learn)
    assert [r["step"] for r in learn] == list(range(10, first["learn_steps"] + 1, 10))
    snapshot = jtrain._maybe_restore_replay(_snap_cfg(tmp_path, JaxConfig),
                                            jtrain.DeviceSequenceReplay(
                                                capacity=200, seq_len=10, frame_shape=(80, 80),
                                                lstm_size=16, lanes=8, stride=6).init_state())
    assert int(snapshot.filled) >= 20  # the port's ring, read by the JAX loader

    second = ptrain.train_anakin_r2d2(cfg.replace(resume=True), max_frames=1_600, device="cpu")
    resume = [r for r in _rows(cfg) if r["kind"] == "resume"]
    assert resume and resume[0]["step"] == first["learn_steps"]
    assert resume[0]["frames"] == 1_200
    assert second["frames"] == 1_600 and second["learn_steps"] > first["learn_steps"]


def test_cli_routes_r2d2_anakin_to_the_hostfed_loop(tmp_path):
    cfg = _cfg(tmp_path)
    argv = ["--role", "anakin", "--architecture", "r2d2", "--device", "cpu",
            "--max-frames", "800"]
    for name in ("env_id", "compute_dtype", "history_length", "hidden_size", "lstm_size",
                 "r2d2_burn_in", "r2d2_seq_len", "r2d2_overlap", "batch_size", "learning_rate",
                 "multi_step", "gamma", "memory_capacity", "learn_start", "frames_per_learn",
                 "target_update_period", "num_envs_per_actor", "metrics_interval",
                 "eval_interval", "checkpoint_interval", "eval_episodes", "results_dir",
                 "checkpoint_dir", "seed"):
        argv += ["--" + name.replace("_", "-"), str(getattr(cfg, name))]
    summary = main(argv)
    assert summary["frames"] == 800 and summary["learn_steps"] > 0
    assert np.isfinite(summary["eval_score_mean"])
    assert any(r["kind"] == "learn" for r in _rows(cfg))


@pytest.mark.parametrize("kw,err,match", [
    (dict(env_id="jaxgame:catch", fused_env=True), NotImplementedError, "A18"),
    (dict(learner_devices=2), NotImplementedError, "A13, more than one GPU"),
    (dict(replay_ratio=2), ValueError, "replay_ratio")], ids=["fused", "devices", "reuse"])
def test_unported_options_raise(tmp_path, kw, err, match):
    with pytest.raises(err, match=match):
        train(_cfg(tmp_path, **kw), max_frames=8, device="cpu")


@pytest.mark.parametrize("fn,nargs", [("build_fused_r2d2_segment", 4), ("init_fused_r2d2_carry", 5),
                                      ("build_fused_r2d2_eval", 3)])
def test_fused_helpers_raise_naming_the_device_games(fn, nargs):
    with pytest.raises(NotImplementedError, match="A18"):
        getattr(ptrain, fn)(*[None] * nargs)


def test_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_cfg(tmp_path), max_frames=8)
