"""The port's quantized act path (K10) against the JAX package's, on the CPU
through the plain twins: the quantizer (``utils/quantize.py`` twins of
``quantize_tree_jax`` and ``cast_tree_fp8``), the act step on quantized
weights (``models/quantized.py`` against ``wrap_act_quantized``), the
serving engine's agreement gate, the Ape-X driver's gated publish, a seeded
quantized ``train_apex`` run, and ``convert``'s quantized trees.

Inputs come from seeded numpy draws; weights cross through ``convert.py``;
taus are injected through ``taus=`` and noise through ``noise=`` on the
port's side and by monkeypatching ``jax.random`` while the JAX executables
trace (tests/test_torch_model.py, tests/test_torch_learn.py).

Tolerances: q and s bit-equal (the twin repeats XLA's fp32 division, its
half-to-even rounding and its e4m3 cast, NaN past 464 included); quantiles
of the quantized act step 1e-5 abs/rel in fp32 (summation order only) and
3e-2 abs in bf16 (``PATH_TOL``: bf16 rounding at the model's rounding
points); the gate's agreement and decision equal; the apex publish's bytes
and mode equal, and its quantized actor's q within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.serving.engine import InferenceEngine as JaxEngine
from rainbow_iqn_apex_tpu.utils import quantize as JQ
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels import launches
from rainbow_iqn_apex_tpu_torch.kernels.quantize import quantize_plain
from rainbow_iqn_apex_tpu_torch.models.quantized import QuantizedIQN
from rainbow_iqn_apex_tpu_torch.ops import build_act_step
from rainbow_iqn_apex_tpu_torch.parallel.apex import ApexDriver, train_apex
from rainbow_iqn_apex_tpu_torch.serving import InferenceEngine, PolicyServer
from rainbow_iqn_apex_tpu_torch.utils import hostsync
from rainbow_iqn_apex_tpu_torch.utils import quantize as PQ
from test_torch_apex import _act_draws, _cfgs, _drivers, _feat, _learn_rows, _loop_cfg
from test_torch_apex import L as LANES
from test_torch_apex import SHAPE as APEX_SHAPE
from test_torch_learn import _inject
from test_torch_model import (
    COSINES,
    HIDDEN,
    NOISY,
    SHAPE,
    _flax_params,
    _inject_jax_normals,
    _jax_net,
    _normals,
    _obs,
    _taus,
)
from test_torch_model import A as MODEL_A

FP32 = dict(atol=1e-5, rtol=1e-5)
PATH_TOL = 3e-2
MODES = ["int8", "fp8"]
TOY = dict(compute_dtype="float32", frame_height=44, frame_width=44, history_length=2,
           hidden_size=32, num_cosines=8, num_tau_samples=4, num_tau_prime_samples=4,
           num_quantile_samples=4, quant_calib_batch=16, num_envs_per_actor=8)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bits(a) -> np.ndarray:
    """A numpy array's raw bits: q and s are compared bit for bit."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _jax_qtree(params, mode):
    qtree = jax.jit(lambda p: JQ.quantize_for_mode(p, mode))(params)
    return jax.tree.map(np.asarray, qtree)


def _assert_qtrees_equal(got, want):
    flat_got, flat_want = JQ.flatten_tree(got), JQ.flatten_tree(want)
    assert sorted(flat_got) == sorted(flat_want)
    for path, w in flat_want.items():
        g = flat_got[path]
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path)


# ------------------------------------------------------------- the quantizer
@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_twin_equals_jax_on_a_converted_tree(mode):
    """The port's K10q twin on ``convert.from_flax`` weights, carried back
    with ``to_flax_quantized``: q and s bit-equal to JAX's."""
    params = _flax_params()
    want = _jax_qtree(params, mode)
    qp = PQ.quantize_params(convert.from_flax(params), mode)
    assert qp.mode == mode and launches["K10q_quantize"] == 0  # the twin ran
    _assert_qtrees_equal(convert.to_flax_quantized(qp), want)
    # the publish bytes JAX counts for the same tree
    assert qp.wire_bytes() == sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want))


def _edge_kernel() -> np.ndarray:
    """A flax-layout [in 24, out 5] kernel: a zero channel, a channel whose
    scale is 1 (max 127) with half-way ties, one of tiny values near fp8's
    subnormals, and e4m3's overflow edges."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((24, 5)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5] + [0.25 * i for i in range(16)]
    w[:, 2] = rng.standard_normal(24).astype(np.float32) * 2.0 ** -9
    w[:12, 3] = [448.0, 455.0, 463.99, 464.0, 464.01, 500.0, 1e4, -1e4, -464.0, -464.5,
                 np.inf, np.nan]
    return w


@pytest.mark.parametrize("mode", MODES)
def test_quantize_twin_edge_cases_equal_jax(mode):
    """Zero channels, ties, subnormals and (fp8) NaN past 464: the twin's q
    and s bit-equal to ``quantize_tree_jax`` / ``cast_tree_fp8``."""
    w = _edge_kernel()
    if mode == "int8":
        w = np.where(np.isfinite(w) & (np.abs(w) < 1e3), w, 0.0).astype(np.float32)
    tree = {"layer": {"kernel": w, "bias": w[:, 4].copy()}}
    want = _jax_qtree(tree, mode)
    q, s = quantize_plain(torch.from_numpy(np.ascontiguousarray(w.T)), mode,
                          w.shape[1] if mode == "int8" else 1)
    qb, sb = quantize_plain(torch.from_numpy(w[:, 4].copy()), mode, 1)
    for got, ref in ((q.T, want["layer"]["kernel"]), (qb, want["layer"]["bias"])):
        got = got.contiguous()
        got = got.view(torch.uint8).numpy() if mode == "fp8" else got.numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref["q"]))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(want["layer"]["kernel"]["s"]))
    np.testing.assert_array_equal(_bits(sb.numpy()), _bits(want["layer"]["bias"]["s"]))
    if mode == "fp8":  # and ml_dtypes' cast, which JAX's agrees with
        ref = w.T.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(), ref)
        nan = q.float().isnan().numpy()
        assert nan[3, 4:8].all() and nan[3, 9:12].all()
        assert not nan[3, :4].any() and not nan[3, 8]  # 464 and -464 round to +-448
    else:
        assert (s[0] == 1.0) and (s[1] == 1.0)  # zero channel; max 127
        np.testing.assert_array_equal(q[1, 1:7].numpy(), [2, -4, 0, 0, 2, 126])


def test_numpy_half_equals_jax_module():
    rng = np.random.default_rng(4)
    tree = {"a": {"kernel": rng.standard_normal((6, 3)).astype(np.float32),
                  "bias": rng.standard_normal(3).astype(np.float32)}}
    _assert_qtrees_equal(PQ.quantize_tree(tree), JQ.quantize_tree(tree))
    q = PQ.quantize_tree(tree)
    assert PQ.is_quantized_tree(q) and not PQ.is_quantized_tree(tree)
    _assert_qtrees_equal(PQ.dequantize_tree(q), JQ.dequantize_tree(q))
    assert PQ.tree_bytes(tree) == JQ.tree_bytes(tree)
    assert PQ.greedy_agreement([1, 2, 3, 4], [1, 2, 0, 4]) == 0.75
    assert PQ.fp8_available() and PQ.check_mode("fp8") == "fp8"
    with pytest.raises(ValueError):
        PQ.check_mode("int4")


def test_convert_quantized_round_trip():
    """JAX tree -> QuantizedParams -> JAX tree is exact in both modes, and
    the port's QuantizedParams survive the trip back."""
    params = _flax_params()
    for mode in MODES:
        want = _jax_qtree(params, mode)
        qp = convert.from_flax_quantized(want)
        assert qp.mode == mode
        _assert_qtrees_equal(convert.to_flax_quantized(qp), want)
        again = convert.from_flax_quantized(convert.to_flax_quantized(qp)) if mode == "int8" \
            else qp
        assert torch.equal(again.q_flat, qp.q_flat) and torch.equal(again.s_flat, qp.s_flat)
        assert qp.wire_bytes() == PQ.quantize_params(convert.from_flax(params), mode).wire_bytes()


# ------------------------------------------------------ the quantized act step
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("mode", MODES)
def test_quantized_act_matches_wrap_act_quantized(monkeypatch, mode, use_noise, dtype):
    """``QuantizedIQN`` against ``jax.jit(wrap_act_quantized(apply))`` on the
    same quantized tree, taus and noise: quantiles within 1e-5 in fp32 and
    PATH_TOL in bf16."""
    params = _flax_params()
    qtree = _jax_qtree(params, mode)
    batch, n = 5, 8
    obs, taus = _obs(batch), _taus(batch, n)
    feat = params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    pairs = _normals([(feat, HIDDEN), (HIDDEN, 1), (feat, HIDDEN), (HIDDEN, MODEL_A)])
    if use_noise:
        left = _inject_jax_normals(monkeypatch, pairs)
    jnet = _jax_net(dtype, use_noise)

    def apply(p, o, t):
        return jnet.apply({"params": p}, o, n, taus=t, rngs={"noise": jax.random.PRNGKey(0)})[0]

    ref = np.asarray(jax.jit(JQ.wrap_act_quantized(apply))(qtree, jnp.asarray(obs),
                                                            jnp.asarray(taus)))
    if use_noise:
        assert not left
    cfg = Config(compute_dtype=dtype, hidden_size=HIDDEN, num_cosines=COSINES,
                 frame_height=SHAPE[0], frame_width=SHAPE[1], history_length=SHAPE[2],
                 num_quantile_samples=n)
    qnet = QuantizedIQN(convert.from_flax_quantized(qtree), MODEL_A, use_noise=use_noise,
                        compute_dtype=getattr(torch, dtype))
    noise = {name: tuple(map(torch.from_numpy, p)) for name, p in zip(NOISY, pairs)}
    out = qnet(torch.from_numpy(obs), n, taus=torch.from_numpy(taus),
               noise=noise if use_noise else None)
    assert out.quantiles.shape == ref.shape == (batch, n, MODEL_A)
    if dtype == "float32":
        np.testing.assert_allclose(out.quantiles.numpy(), ref, **FP32)
        np.testing.assert_array_equal(out.action.numpy(), np.argmax(ref.mean(1), -1))
    else:
        np.testing.assert_allclose(out.quantiles.numpy(), ref, atol=PATH_TOL, rtol=0)
    # build_act_step drives the holder as it drives a RainbowIQN
    a, q = build_act_step(cfg, MODEL_A, use_noise)(
        qnet, torch.from_numpy(obs), None, torch.from_numpy(taus),
        noise if use_noise else None)
    assert torch.equal(q, out.q) and torch.equal(a, out.action)


# -------------------------------------------------------------- serving gate
def _engines(monkeypatch, mode, threshold, calib, params_np):
    """A JAX and a port engine on the same weights and calibration frames,
    the gate's taus injected into both; each records its quant rows."""
    bucket = 16
    taus = np.random.default_rng(13).random((bucket, TOY["num_quantile_samples"]),
                                            dtype=np.float32)
    kw = dict(TOY, serve_quantize=mode, quant_agreement_min=threshold,
              serve_batch_buckets=str(bucket))
    j_rows, p_rows = [], []
    uq = _inject(monkeypatch, [taus, taus], [])[0]  # the fp32 and quantized executables
    jeng = JaxEngine(JaxConfig(**kw), 6, params_np, buckets=[bucket], calib_obs=calib,
                     quant_log=lambda k, **f: j_rows.append((k, f)))
    assert uq == []  # each executable traced once, on the injected taus
    monkeypatch.undo()
    monkeypatch.setattr(InferenceEngine, "_gate_draws",
                        lambda self, b: (torch.from_numpy(taus[:b]), None))
    peng = InferenceEngine(Config(**kw), 6, convert.from_flax(params_np), device="cpu",
                           calib_obs=calib, quant_log=lambda k, **f: p_rows.append((k, f)))
    return jeng, peng, j_rows, p_rows


def _toy_params():
    """TOY-width JAX weights whose advantage head has near-identical columns,
    so the greedy actions are near-ties that quantization can flip."""
    from rainbow_iqn_apex_tpu.ops.learn import init_train_state

    params = jax.tree.map(lambda x: np.array(x, np.float32),
                          init_train_state(JaxConfig(**TOY), 6, jax.random.PRNGKey(0)).params)
    rng = np.random.default_rng(2)
    head = params["advantage_out"]
    w = head["w_mu"]
    head["w_mu"] = (w[:, :1] + 1e-4 * np.abs(w).max() * rng.standard_normal(w.shape)).astype(
        np.float32)
    head["b_mu"] = np.full_like(head["b_mu"], head["b_mu"][0])
    return params


@pytest.mark.parametrize("threshold", [0.0, 0.99, 1.01], ids=["pass", "config", "fail"])
@pytest.mark.parametrize("mode", MODES)
def test_engine_gate_matches_jax(monkeypatch, mode, threshold):
    """The same calibration frames, taus and weights: the port's gate gives
    JAX's agreement and decision and the same quant / quant_fallback row."""
    calib = np.random.default_rng(7).integers(0, 255, (12, *APEX_SHAPE), dtype=np.uint8)
    jeng, peng, j_rows, p_rows = _engines(monkeypatch, mode, threshold, calib, _toy_params())
    assert peng.quant_agreement == pytest.approx(jeng.quant_agreement, abs=1e-12)
    assert peng.quant_active == jeng.quant_active == (jeng.quant_agreement >= threshold)
    assert peng.quant_fallbacks == jeng.quant_fallbacks
    assert peng.quant_state() == jeng.quant_state()
    assert p_rows == j_rows and len(p_rows) == 1
    assert p_rows[0][0] == ("quant" if jeng.quant_active else "quant_fallback")
    assert p_rows[0][1]["calib_batch"] == 12


def test_engine_gate_sees_disagreement_like_jax(monkeypatch):
    """At the config's 0.99 the near-tied toy policy fails the int8 gate in
    both frameworks, with the same agreement below 1."""
    calib = np.random.default_rng(7).integers(0, 255, (16, *APEX_SHAPE), dtype=np.uint8)
    jeng, peng, _, _ = _engines(monkeypatch, "int8", 0.99, calib, _toy_params())
    assert peng.quant_agreement == jeng.quant_agreement < 1.0
    assert not peng.quant_active and not jeng.quant_active


@pytest.mark.parametrize("mode", MODES)
def test_engine_fallback_serves_full_precision(mode):
    """A failed gate serves exactly what an off-mode engine serves, and the
    quantized network stays built but idle."""
    params = convert.from_flax(_toy_params())
    calib = np.random.default_rng(0).integers(0, 255, (8, *APEX_SHAPE), dtype=np.uint8)
    kw = dict(TOY, serve_batch_buckets="8")
    eng = InferenceEngine(Config(**kw, serve_quantize=mode, quant_agreement_min=1.01), 6,
                          params, device="cpu", calib_obs=calib)
    ref = InferenceEngine(Config(**kw), 6, params, device="cpu")
    assert not eng.quant_active and eng.quant_fallbacks == 1 and eng.quantized is not None
    for _ in range(2):  # the dispatch generator is untouched by the gate
        a, q = eng.infer(calib)
        a0, q0 = ref.infer(calib)
        assert np.array_equal(a, a0) and np.array_equal(q, q0)
    # set_calibration re-gates the staged weights; load_params re-stages
    eng.quant_agreement_min = 0.0
    eng.set_calibration(calib[:4])
    assert eng.quant_active and eng.quant_fallbacks == 1
    _, q = eng.infer(calib)
    assert not np.array_equal(q, q0)
    assert eng.load_params(params) == 1 and eng.quant_active


def test_engine_without_calibration_stays_quietly_full_precision():
    rows = []
    params = convert.from_flax(_toy_params())
    eng = InferenceEngine(Config(**TOY, serve_quantize="int8", serve_batch_buckets="8"), 6,
                          params, device="cpu", quant_log=lambda k, **f: rows.append(k))
    assert not eng.quant_active and rows == [] and eng.quant_agreement is None


@pytest.mark.parametrize("mode", MODES)
def test_server_gates_on_seeded_frames_and_reports_quant_state(mode, tmp_path):
    """The server's calibration frames are the JAX server's (seed + 7), its
    rows and gauges land in the metrics log and registry, and healthz and
    stats carry quant_state()."""
    params = convert.from_flax(_toy_params())
    cfg = Config(**TOY, serve_quantize=mode, quant_agreement_min=0.0, serve_batch_buckets="8")
    path = str(tmp_path / "serve.jsonl")
    server = PolicyServer(cfg, 6, params, device="cpu", metrics_path=path)
    want = np.random.default_rng(cfg.seed + 7).integers(
        0, 255, (cfg.quant_calib_batch, *APEX_SHAPE), dtype=np.uint8)
    assert np.array_equal(server.engine._calib_obs, want)
    with server:
        action = server.act(np.zeros(APEX_SHAPE, np.uint8))
        assert 0 <= action < 6
        health, stats = server.healthz(), server.stats()
    for surface in (health, stats):
        assert surface["quant_mode"] == mode and surface["quant_active"] is True
    reg = server.metrics.registry
    assert reg.gauge("quant_action_agreement", "serve").get() == server.engine.quant_agreement
    with open(path) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert "quant" in kinds


# ------------------------------------------------------ the apex gated publish
class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, kind, **fields):
        self.rows.append((kind, fields))

    def last(self, kind):
        return [f for k, f in self.rows if k == kind][-1]


@pytest.mark.parametrize("mode", MODES)
def test_apex_gated_publish_matches_jax(monkeypatch, mode):
    """JAX's ApexDriver and the port's on the same warm state and
    calibration batch: the publish's bytes and mode equal, the quant row
    equal in kind and mode, and act_frames on the quantized actor within
    1e-5 of JAX's at the same taus and noise."""
    jd, pd, pcfg = _drivers(serve_quantize=mode, quant_agreement_min=0.0)
    assert not pd._actor_quant and not jd._actor_quant  # no calibration yet
    j_rows, p_rows = _Rows(), _Rows()
    jd.attach_obs(j_rows, None)
    pd.attach_obs(p_rows, None)
    calib = np.random.default_rng(0).integers(0, 255, (LANES, *APEX_SHAPE), dtype=np.uint8)
    for d in (jd, pd):
        assert d.wants_calibration()
        d.set_calibration(calib)
        d.publish_weights()
    assert pd._actor_quant and jd._actor_quant
    jpub, ppub = j_rows.last("publish"), p_rows.last("publish")
    for key in ("bytes", "bytes_fp32", "mode", "quant_active"):
        assert ppub[key] == jpub[key], key
    assert ppub["mode"] == mode and ppub["bytes"] * 3 < ppub["bytes_fp32"]
    assert [k for k, _ in p_rows.rows] == [k for k, _ in j_rows.rows] == ["quant", "publish"]
    assert p_rows.last("quant")["mode"] == j_rows.last("quant")["mode"] == mode
    # the actor's weights are the quantizer's, in its own buffers
    learner_ptrs = {p.data_ptr() for p in pd.state.net.parameters()}
    assert pd.actor_qnet.qparams.q_flat.data_ptr() not in learner_ptrs

    taus, noise = _act_draws(pcfg, _feat(pd), 1)
    normals = [a for layer in NOISY for a in noise[layer]]
    queues = _inject(monkeypatch, [taus], normals)
    draws = (torch.from_numpy(taus), {k: (torch.from_numpy(a), torch.from_numpy(b))
                                      for k, (a, b) in noise.items()})
    frames = np.random.default_rng(3).integers(0, 256, (LANES, *APEX_SHAPE[:2]), dtype=np.uint8)
    before = launches["K10g_noisy_linear_q"]
    ja, jq = jd.act_frames(frames, np.zeros(LANES, bool))
    pa, pq = pd.act_frames(frames, np.zeros(LANES, bool), draws=draws)
    assert queues == ([], [])
    np.testing.assert_allclose(pq, np.asarray(jq), **FP32)
    assert np.array_equal(pa, np.asarray(ja))
    assert launches["K10g_noisy_linear_q"] == before  # the CPU ran the twins


def test_apex_fallback_publishes_bf16_with_a_reasoned_row_like_jax():
    jd, pd, _ = _drivers(serve_quantize="int8", quant_agreement_min=1.01, bf16_weight_sync=True)
    j_rows, p_rows = _Rows(), _Rows()
    jd.attach_obs(j_rows, None)
    pd.attach_obs(p_rows, None)
    calib = np.random.default_rng(0).integers(0, 255, (LANES, *APEX_SHAPE), dtype=np.uint8)
    for d in (jd, pd):
        d.set_calibration(calib)
        d.publish_weights()
        assert not d._actor_quant and d.quant_fallbacks == 1
    assert [k for k, _ in p_rows.rows] == [k for k, _ in j_rows.rows] == [
        "quant_fallback", "publish"]
    assert p_rows.last("quant_fallback")["reason"] == "agreement_below_min"
    for key in ("bytes", "bytes_fp32", "mode", "quant_active"):
        assert p_rows.last("publish")[key] == j_rows.last("publish")[key], key
    assert p_rows.last("publish")["mode"] == "bf16" and pd.actor is pd.actor_net


@pytest.mark.parametrize("device_sampling", [False, True], ids=["host_sampling", "frontier"])
def test_seeded_quantized_apex_runs_repeat_exactly(tmp_path, device_sampling):
    """Two int8 runs from one seed under ``forbid_host_sync()``: the
    calibration draw at warm-up, then every publish gated and shipped int8,
    the same learn rows and final eval."""
    runs = []
    for name in ("a", "b"):
        cfg = _loop_cfg(tmp_path / name, device_sampling=device_sampling,
                        serve_quantize="int8", quant_agreement_min=0.0)
        with hostsync.forbid_host_sync():
            summary = train_apex(cfg, max_frames=520, device="cpu")
        assert summary["learn_steps"] > 100 and summary["rollbacks"] == 0
        learn, _, publishes = _learn_rows(cfg)
        assert publishes and all(p["mode"] == "int8" and p["quant_active"] for p in publishes)
        with open(os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")) as f:
            gates = [r for r in map(json.loads, f) if r["kind"] == "quant"]
        assert len(gates) == len(publishes)
        runs.append((learn, summary["eval_score_mean"], [p["bytes"] for p in publishes]))
    assert runs[0] == runs[1]


def test_each_gated_publish_ships_the_learners_current_weights():
    """The actor's quantized weights after a publish are the quantization of
    the learner's weights at that publish, in the actor's own buffers; an
    in-place learner update reaches the actor only through a publish."""
    _, pcfg = _cfgs(serve_quantize="int8", quant_agreement_min=0.0)
    pd = ApexDriver(pcfg, 3, state_shape=APEX_SHAPE, device="cpu")
    pd.set_calibration(np.random.default_rng(0).integers(0, 255, (LANES, *APEX_SHAPE),
                                                         dtype=np.uint8))
    for round_ in range(2):
        pd.publish_weights()
        want = PQ.quantize_params(pd.state.net, "int8")
        assert torch.equal(pd.actor_qnet.qparams.q_flat, want.q_flat), round_
        assert torch.equal(pd.actor_qnet.qparams.s_flat, want.s_flat), round_
        with torch.no_grad():  # Adam's in-place update, in miniature
            for p in pd.state.net.parameters():
                p.add_(0.01 * torch.randn_like(p))
        assert not torch.equal(pd.actor_qnet.qparams.q_flat,
                               PQ.quantize_params(pd.state.net, "int8").q_flat)
