"""The port's ``--role single`` trainer (rainbow_iqn_apex_tpu_torch.train)
end to end on the CPU: metrics, checkpoint and resume, the NaN/Inf rollback,
the CLI entry, and replay parity with the JAX package.

The runs are short and narrow (toy:catch, hidden 32, 8 taus) so the file
stays a few seconds of CPU per test; the learning check at the JAX test's
own bar (catch eval mean > 0.2 after 4,000 frames) runs on the card in
``chip_smoke.py``'s ``train`` phase.
"""

import json
import os

import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.replay.buffer import PrioritizedReplay as JaxReplay
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay
from rainbow_iqn_apex_tpu_torch.train import main, priority_beta, train
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import Checkpointer


def _cfg(tmp_path, **kw):
    """tests/test_train_integration.py's catch scenario, narrowed."""
    base = dict(
        env_id="toy:catch", compute_dtype="float32", frame_height=44, frame_width=44,
        history_length=2, hidden_size=32, num_cosines=16, num_tau_samples=8,
        num_tau_prime_samples=8, num_quantile_samples=8, batch_size=8,
        learning_rate=1e-3, adam_eps=1e-8, multi_step=3, gamma=0.9, memory_capacity=2048,
        learn_start=128, frames_per_learn=2, target_update_period=50,
        num_envs_per_actor=4, metrics_interval=20, eval_interval=0, checkpoint_interval=0,
        eval_episodes=2, stall_timeout_s=0.0,
        results_dir=str(tmp_path / "results"), checkpoint_dir=str(tmp_path / "ckpt"), seed=7,
    )
    base.update(kw)
    return Config(**base)


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rows(tmp_path, cfg):
    with open(tmp_path / "results" / cfg.run_id / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_short_run_checkpoint_resume(tmp_path):
    """A short run writes metrics, a checkpoint whose step is the run's
    learn_steps and a replay snapshot; a resumed run starts from that step,
    frame count and replay."""
    cfg = _cfg(tmp_path, snapshot_replay=True)
    s1 = train(cfg, max_frames=240, device="cpu")
    assert s1["learn_steps"] > 0 and s1["frames"] == 240
    assert np.isfinite(s1["eval_score_mean"])
    rows = _rows(tmp_path, cfg)
    assert any(r["kind"] == "learn" and np.isfinite(r["loss"]) for r in rows)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    state, extra = ckpt.restore()
    assert state["step"] == s1["learn_steps"] == ckpt.latest_step()
    assert extra["frames"] == s1["frames"]
    assert state["adam"]["count"] == s1["learn_steps"]

    s2 = train(cfg.replace(resume=True), max_frames=280, device="cpu")
    resumed = [r for r in _rows(tmp_path, cfg) if r["kind"] == "resume"]
    assert resumed and resumed[0]["step"] == s1["learn_steps"]
    assert resumed[0]["frames"] == s1["frames"]
    assert s2["learn_steps"] > s1["learn_steps"]


def test_nan_step_rolls_back_and_training_continues(tmp_path):
    """The ``nan_loss`` fault point through the real loop, as the JAX
    supervisor test drives it: the poisoned batch gives a non-finite step,
    the supervisor rolls params, Adam state and generator back, and the run
    ends with finite losses."""
    cfg = _cfg(tmp_path, fault_spec="nan_loss@5", guard_snapshot_interval=3,
               max_nan_strikes=2, metrics_interval=10)
    summary = train(cfg, max_frames=240, device="cpu")
    assert summary["rollbacks"] == 1
    assert summary["learn_steps"] > 0
    assert np.isfinite(summary["eval_score_mean"])
    rows = _rows(tmp_path, cfg)
    events = [r["event"] for r in rows if r["kind"] == "fault"]
    assert {"injected_nan_batch", "nonfinite_step", "rollback"} <= set(events)
    learn_rows = [r for r in rows if r["kind"] == "learn"]
    assert learn_rows and all(np.isfinite(r["loss"]) for r in learn_rows)


def test_cli_entry_runs_a_short_single_role_training(tmp_path, capsys):
    argv = ["--role", "single", "--env-id", "toy:catch", "--device", "cpu",
            "--max-frames", "200", "--compute-dtype", "float32", "--hidden-size", "32",
            "--num-cosines", "16", "--num-tau-samples", "8", "--num-tau-prime-samples", "8",
            "--num-quantile-samples", "8", "--batch-size", "8", "--learn-start", "100",
            "--memory-capacity", "1024", "--num-envs-per-actor", "4", "--eval-episodes", "1",
            "--history-length", "2", "--eval-interval", "0", "--checkpoint-interval", "0",
            "--results-dir", str(tmp_path / "r"), "--checkpoint-dir", str(tmp_path / "c")]
    summary = main(argv)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["frames"] == summary["frames"] == 200
    assert last["learn_steps"] == summary["learn_steps"] > 0


@pytest.mark.parametrize("kw", [dict(role="apex"), dict(league_dir="x"), dict(replay_ratio=2),
                                dict(architecture="r2d2"), dict(trace_dir="t"),
                                dict(obs_net=True)],
                         ids=["role", "league", "reuse", "r2d2", "trace_dir", "obs_net"])
def test_unported_parts_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError):
        train(_cfg(tmp_path, **kw), max_frames=8, device="cpu")


def test_train_runs_on_cuda_unless_asked_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_cfg(tmp_path), max_frames=8)


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
def test_replay_samples_what_the_jax_package_samples(use_native):
    """Same seed, same appends, same priority updates: the port's replay
    (a copy) draws the same indices and IS weights and assembles the same
    batches as the JAX package's."""
    rng = np.random.default_rng(3)
    kw = dict(history=2, n_step=3, gamma=0.9, lanes=2, priority_exponent=0.5,
              priority_eps=1e-6, seed=5, use_native=use_native)
    mine, ref = PrioritizedReplay(256, (8, 8), **kw), JaxReplay(256, (8, 8), **kw)
    for t in range(150):
        frames = rng.integers(0, 256, (2, 8, 8), dtype=np.uint8)
        actions = rng.integers(0, 3, 2)
        rewards = rng.normal(size=2).astype(np.float32)
        terminals = rng.random(2) < 0.05
        for mem in (mine, ref):
            mem.append_batch(frames, actions, rewards, terminals)
    for k in range(3):
        a, b = mine.sample(16, 0.4 + 0.2 * k), ref.sample(16, 0.4 + 0.2 * k)
        for field in ("idx", "obs", "action", "reward", "next_obs", "discount", "weight"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        td = rng.random(16)
        mine.update_priorities(a.idx, td)
        ref.update_priorities(b.idx, td)


def test_priority_beta_anneals_like_the_jax_loop():
    cfg = Config(priority_weight=0.4, t_max=100)
    assert priority_beta(cfg, 0) == pytest.approx(0.4)
    assert priority_beta(cfg, 50) == pytest.approx(0.7)
    assert priority_beta(cfg, 1000) == pytest.approx(1.0)


# ------------------------------------------------- the loop's host pieces
def test_hostsync_forbids_unsanctioned_reads_on_this_thread_only():
    import threading

    from rainbow_iqn_apex_tpu_torch.utils import hostsync

    t = torch.arange(3.0)
    with hostsync.forbid_host_sync():
        for read in (lambda: hostsync.to_host(t), lambda: hostsync.scalar(t[0]),
                     lambda: hostsync.check_host_work("replay_sample")):
            with pytest.raises(hostsync.HostSyncError):
                read()
        with hostsync.sanctioned():
            assert hostsync.to_host(t).tolist() == [0.0, 1.0, 2.0]
            assert hostsync.scalar(t[2]) == 2.0
        seen = []
        worker = threading.Thread(target=lambda: seen.append(hostsync.to_host(t)))
        worker.start()
        worker.join()
        assert seen and seen[0].tolist() == [0.0, 1.0, 2.0]
    assert hostsync.scalar(t[1]) == 1.0


def _info(step, finite=True, rows=2):
    loss = torch.tensor(float(step) if finite else float("nan"))
    return {"loss": loss, "priorities": torch.full((rows,), float(step)),
            "q_mean": torch.tensor(0.5), "target_q_mean": torch.tensor(0.25),
            "grad_norm": torch.tensor(1.0),
            "finite": torch.isfinite(loss) & torch.tensor(True)}


def test_writeback_ring_retires_the_oldest_step_past_its_depth():
    from rainbow_iqn_apex_tpu_torch.utils.writeback import WritebackRing

    ring = WritebackRing(2)
    assert ring.push(1, np.array([0, 1]), _info(1)) is None
    assert ring.push(2, np.array([2, 3]), _info(2)) is None
    retired = ring.push(3, np.array([4, 5]), _info(3))
    assert retired.step == 1 and retired.lag == 2 and retired.finite
    assert retired.idx.tolist() == [0, 1] and retired.priorities.tolist() == [1.0, 1.0]
    assert retired.scalars == {"loss": 1.0, "q_mean": 0.5, "target_q_mean": 0.25,
                               "grad_norm": 1.0}
    assert [s for s, _ in ring.flush()] == [2, 3] and len(ring) == 0
    assert WritebackRing(0).push(7, np.array([0]), _info(7)).step == 7  # depth 0: at once


def test_ring_committer_quarantines_every_inflight_step_and_rolls_back():
    from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
    from rainbow_iqn_apex_tpu_torch.utils.writeback import RingCommitter, WritebackRing

    sup = TrainSupervisor(Config(stall_timeout_s=0.0, guard_snapshot_interval=1))
    sup.snapshot_if_due(0, lambda: ({"w": torch.ones(2)}, torch.zeros(4, dtype=torch.uint8)))
    updates, loaded = [], []
    ring = WritebackRing(1)
    committer = RingCommitter(ring, lambda idx, pri: updates.append((idx.tolist(), list(pri))),
                              sup, lambda state, key: loaded.append(state))
    assert committer.commit(ring.push(1, np.array([0]), _info(1, rows=1)))
    assert committer.commit(ring.push(2, np.array([1]), _info(2, finite=False, rows=1)))
    assert updates == [([0], [1.0])] and committer.scalars["loss"] == 1.0  # step 1 retired
    assert not committer.commit(ring.push(3, np.array([2]), _info(3, rows=1)))  # the NaN
    assert updates[1:] == [([1], [0.0]), ([2], [0.0])]  # quarantined, step 3 included
    assert len(loaded) == 1 and sup.rollbacks == 1 and len(ring) == 0


def test_checkpointer_prunes_after_saving_and_skips_a_corrupt_step(tmp_path):
    from rainbow_iqn_apex_tpu_torch.utils.checkpoint import Checkpointer

    ckpt = Checkpointer(str(tmp_path / "c"), max_to_keep=3)
    for step in range(1, 5):
        ckpt.save(step, {"step": step, "w": torch.full((2,), float(step))}, {"frames": 10 * step})
    ckpt.wait()
    assert ckpt.all_steps() == (2, 3, 4)
    ckpt.save(4, {"step": 99}, {})  # an existing step is kept as it is
    ckpt.wait()
    assert ckpt.restore(4)[0]["step"] == 4
    with open(tmp_path / "c" / "step_000000004.pt", "wb") as f:
        f.write(b"torn")
    assert ckpt.latest_valid_step() == 3
    state, extra, step = ckpt.restore_latest_valid()
    assert step == 3 and extra == {"frames": 30} and state["w"].tolist() == [3.0, 3.0]
