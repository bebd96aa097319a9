"""The PyTorch port's serving path (rainbow_iqn_apex_tpu_torch.serving) on
the CPU: the counterparts of tests/test_serving.py for the engine and the
server, the not-ported options that must raise, and the act step held
against the JAX package's act path at the same weights and taus.

Small shapes (44x44x2 frames, hidden 64, 16 cosines, K = 4, A = 4), fp32,
``device="cpu"``: there the kernels' plain twins run.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.ops.learn import build_act_step as jax_build_act_step
from rainbow_iqn_apex_tpu.ops.learn import make_network as jax_make_network
from rainbow_iqn_apex_tpu.models.iqn import greedy_action as jax_greedy_action
from rainbow_iqn_apex_tpu.models.iqn import q_values as jax_q_values
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.models import init_params
from rainbow_iqn_apex_tpu_torch.ops import build_act_step, load_network
from rainbow_iqn_apex_tpu_torch.serving import (
    InferenceEngine,
    PolicyServer,
    ServerClosed,
    fit_buckets,
    parse_buckets,
    pick_bucket,
)

CFG = Config(
    compute_dtype="float32",
    frame_height=44,
    frame_width=44,
    history_length=2,
    hidden_size=64,
    num_cosines=16,
    num_tau_samples=8,
    num_tau_prime_samples=8,
    num_quantile_samples=4,
    serve_batch_buckets="4,16",
    serve_deadline_ms=3.0,
    serve_queue_bound=256,
)
A = 4
OBS_SHAPE = (44, 44, 2)
CPU = "cpu"


def _obs(n=1, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *OBS_SHAPE), dtype=np.uint8)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, A, seed=0)


@pytest.fixture(scope="module")
def engine(params):
    return InferenceEngine(CFG, A, params, device=CPU)


def _zeros(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


# ------------------------------------------------------------ bucket helpers
def test_bucket_helpers():
    assert pick_bucket([4, 16], 5) == 16
    assert fit_buckets([16, 4, 4], 1) == [4, 16]
    assert parse_buckets("8,16,32,64") == [8, 16, 32, 64]
    with pytest.raises(ValueError):
        parse_buckets(" , ")


# ------------------------------------------------------------------- engine
def test_engine_infer_shapes_and_padding(engine):
    for n in (1, 3, 4, 9, 16):
        a, q = engine.infer(_obs(n))
        assert a.shape == (n,) and q.shape == (n, A)
        assert a.dtype == np.int32 and q.dtype == np.float32
    with pytest.raises(ValueError):
        engine.infer(_obs(17))  # above the largest bucket


def test_engine_padding_repeats_row_zero_without_changing_live_rows(params):
    """Greedy q depends on the taus, so compare the padded 3-row dispatch with
    a full 4-row dispatch that draws the same taus from a same-seeded engine."""
    eng_a = InferenceEngine(CFG, A, params, device=CPU)
    eng_b = InferenceEngine(CFG, A, params, device=CPU)
    obs = _obs(3, seed=9)
    _, q_pad = eng_a.infer(obs)
    _, q_full = eng_b.infer(np.concatenate([obs, obs[:1]]))
    np.testing.assert_allclose(q_pad, q_full[:3], atol=1e-6, rtol=1e-6)


def test_engine_hot_swap_changes_output_and_bumps_version(params):
    engine = InferenceEngine(CFG, A, params, device=CPU)
    _, q_before = engine.infer(_obs(8))
    assert np.abs(q_before).sum() > 0
    assert engine.load_params(_zeros(params)) == 1 == engine.params_version
    a, q_after = engine.infer(_obs(8))
    np.testing.assert_array_equal(q_after, 0.0)
    np.testing.assert_array_equal(a, 0)  # argmax of all-equal q
    assert engine.load_params(params) == 2


def test_serve_mode_validation(params):
    with pytest.raises(ValueError):
        InferenceEngine(CFG, A, params, device=CPU, mode="epsilon")


def test_noisy_mode_draws_fresh_noise_per_dispatch(params):
    engine = InferenceEngine(CFG, A, params, device=CPU, mode="noisy")
    obs = _obs(4, seed=3)
    _, q1 = engine.infer(obs)
    _, q2 = engine.infer(obs)
    assert np.all(np.isfinite(q1)) and not np.allclose(q1, q2)


def test_not_ported_options_raise(params):
    with pytest.raises(NotImplementedError):
        PolicyServer(CFG, A, params, device=CPU, checkpointer=object())
    with pytest.raises(NotImplementedError):
        PolicyServer(CFG.replace(obs_net=True), A, params, device=CPU)
    with pytest.raises(NotImplementedError):
        PolicyServer.from_checkpoint(CFG, A, "ckpt")
    with pytest.raises(NotImplementedError):
        InferenceEngine(CFG, A, params, device=[CPU, CPU])
    server = PolicyServer(CFG, A, params, device=CPU)
    with pytest.raises(NotImplementedError):
        server.reload()
    server.stop()


# ------------------------------------------------------------------- server
@pytest.mark.serve
def test_server_smoke_start_request_shutdown(params, tmp_path):
    metrics_path = str(tmp_path / "serve.jsonl")
    server = PolicyServer(CFG, A, params, device=CPU, metrics_path=metrics_path)
    with server:
        action, q = server.act_values(_obs()[0])
        assert 0 <= action < A and q.shape == (A,)
        assert 0 <= server.act(_obs()[0]) < A
    stats = server.stats()
    assert stats["total_requests"] == 2 and stats["total_shed"] == 0
    with pytest.raises(ServerClosed):
        server.submit(_obs()[0])
    rows = [json.loads(line) for line in open(metrics_path)]
    final = [r for r in rows if r.get("final")]
    assert final and "latency_p50_ms" in final[0]


@pytest.mark.serve
def test_server_batches_concurrent_clients(params):
    server = PolicyServer(CFG, A, params, device=CPU)
    server.start()

    def client(i):
        for r in range(6):
            server.act(_obs(seed=i * 100 + r)[0], timeout=60)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    stats = server.stop()
    assert stats["total_requests"] == 96
    assert stats["batch_occupancy_lifetime"] > 1.5
    assert stats["total_shed"] == 0


@pytest.mark.serve
def test_server_hot_swap_and_drain_on_stop(params):
    server = PolicyServer(CFG, A, params, device=CPU)
    server.start()
    _, q0 = server.act_values(_obs()[0])
    assert server.load_params(_zeros(params)) == 1
    _, q1 = server.act_values(_obs()[0])
    np.testing.assert_array_equal(q1, 0.0)
    assert not np.array_equal(q0, q1)
    futures = [server.submit(_obs(seed=s)[0]) for s in range(10)]
    server.stop(drain=True)
    assert all(f.done() for f in futures)
    assert all(0 <= f.result(timeout=0)[0] < A for f in futures)


def test_start_reraises_a_failed_warmup_and_stays_unstarted(params, monkeypatch):
    server = PolicyServer(CFG, A, params, device=CPU)

    def broken(obs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(server.engine, "infer", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        server.start()
    assert server._worker is None and server.healthz()["status"] == "ok"
    server.stop()


@pytest.mark.serve
def test_submit_rejects_malformed_observations(params):
    server = PolicyServer(CFG, A, params, device=CPU)
    with server:
        with pytest.raises(ValueError):
            server.submit(np.zeros((10, 10, 2), np.uint8))
        with pytest.raises(TypeError):
            server.submit(np.zeros(OBS_SHAPE, np.float32))
        assert 0 <= server.act(_obs()[0]) < A  # worker unharmed


@pytest.mark.serve
def test_healthz_reports_weights_version_and_age(params):
    server = PolicyServer(CFG, A, params, device=CPU)
    h0 = server.healthz()
    assert h0["weights_version"] == 0 and h0["weights_age_s"] >= 0.0
    assert h0["device"] == "cpu"
    time.sleep(0.05)
    aged = server.healthz()["weights_age_s"]
    assert aged >= 0.05
    v = server.load_params(params)
    h1 = server.healthz()
    assert h1["weights_version"] == v == 1
    assert h1["weights_age_s"] < aged
    server.stop()


def test_serve_defaults_config_loads_in_the_port():
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "serve_defaults.json")
    with open(path) as f:
        cfg = Config.from_json(f.read())
    assert Config.from_json(cfg.to_json()) == cfg
    assert cfg.state_shape == (84, 84, 4) and cfg.compute_dtype == "bfloat16"
    assert parse_buckets(cfg.serve_batch_buckets) == [8, 16, 32, 64]


# ------------------------------------------- act step vs the JAX act path
@pytest.mark.parametrize("batch", [1, 6])
def test_act_step_matches_jax_at_injected_taus(batch):
    """The port's act step draws its taus from the generator it is given;
    the same draw from a same-seeded generator is handed to the JAX network
    as ``taus=``, and its greedy_action / q_values must match."""
    key = jax.random.PRNGKey(0)
    jnet = jax_make_network(CFG, A, use_noise=False)
    flax_params = jnet.init({"params": key, "taus": key, "noise": key},
                            jnp.zeros((1, *OBS_SHAPE), jnp.uint8), 8)["params"]
    flax_params = jax.tree.map(np.asarray, flax_params)
    obs = _obs(batch, seed=11)

    net = load_network(CFG, A, convert.from_flax(flax_params), torch.device(CPU),
                       use_noise=False)
    act = build_act_step(CFG, A, use_noise=False)
    actions, q = act(net, torch.from_numpy(obs), torch.Generator().manual_seed(7))
    taus = torch.rand((batch, CFG.num_quantile_samples),
                      generator=torch.Generator().manual_seed(7))

    quantiles, _ = jnet.apply({"params": flax_params}, jnp.asarray(obs),
                              CFG.num_quantile_samples, taus=jnp.asarray(taus.numpy()))
    np.testing.assert_allclose(q.numpy(), np.asarray(jax_q_values(quantiles)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(actions.numpy(), np.asarray(jax_greedy_action(quantiles)))
    assert actions.dtype == torch.int32 and q.dtype == torch.float32
    # and the JAX package's own act step agrees on shapes and dtypes
    a_j, q_j = jax_build_act_step(CFG, A, use_noise=False)(flax_params, jnp.asarray(obs), key)
    assert a_j.shape == tuple(actions.shape) and q_j.shape == tuple(q.shape)


def test_act_step_refuses_a_mismatched_network(params):
    net = load_network(CFG, A, params, torch.device(CPU), use_noise=True)
    with pytest.raises(ValueError):
        build_act_step(CFG, A, use_noise=False)(net, torch.from_numpy(_obs(1)), None)
