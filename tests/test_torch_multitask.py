"""Multi-game Ape-X in the port (rainbow_iqn_apex_tpu_torch.multitask) against
the JAX package's (rainbow_iqn_apex_tpu.multitask), on the CPU.

- The copied jax-free modules (spec, lanes, replay, obs) behave as
  tests/test_multitask.py says, and the port's MultiGameReplay draws the
  JAX one's indices, weights and game ids at a fixed seed.
- K2g (the game embedding in the tau merge, forward and backward), K4m (the
  per-game action mask) and K4l (the log-softmax at the taken action),
  through their plain twins, against the JAX expressions they replace.
- MultiGameIQN: bit-equal to the single-game RainbowIQN at one game and a
  zero embedding; against JAX's MultiGameIQN with a random embedding.
- One multi-game learn step at replay_ratio 1 and 2 from a converted JAX
  state, with the JAX step's draws injected (tests/test_torch_learn.py's
  scheme), and the two-game toy Ape-X run of tests/test_multitask.py
  through the port's ``train_apex``.

Tolerances: fp32 1e-5 (summation order only); learn-step state 1e-4 (Adam
divides by sqrt(nu)); bf16 results 4 bf16 ulps (2^-6) of the largest
element, as tests/test_torch_learn.py states.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.models.layers import CosineTauEmbedding as JaxCosEmbed
from rainbow_iqn_apex_tpu.multitask import model as jmodel
from rainbow_iqn_apex_tpu.multitask import ops as jops
from rainbow_iqn_apex_tpu.multitask.replay import MultiGameReplay as JaxMultiGameReplay
from rainbow_iqn_apex_tpu.multitask.spec import MultiGameSpec as JaxSpec
from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
    MASK_FILL,
    dueling_head,
    dueling_logp,
)
from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import TauEmbedFn, tau_embed
from rainbow_iqn_apex_tpu_torch.models.init import init_network_, make_network
from rainbow_iqn_apex_tpu_torch.multitask import model as pmodel
from rainbow_iqn_apex_tpu_torch.multitask import ops as pops
from rainbow_iqn_apex_tpu_torch.multitask.lanes import GameLaneEnv, build_game_lanes, lane_games
from rainbow_iqn_apex_tpu_torch.multitask.obs import GamesObs, aggregate_human_normalized
from rainbow_iqn_apex_tpu_torch.multitask.replay import (
    InterleaveSchedule,
    MultiGameReplay,
    apportion,
)
from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec, parse_games
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn

TOY2 = MultiGameSpec(games=("toy:catch", "toy:chain"), num_actions=(3, 2), frame_shape=(80, 80))
FP32 = dict(rtol=1e-5, atol=1e-5)
STEP_INFO = dict(rtol=1e-5, atol=1e-6)
STEP_STATE = dict(rtol=1e-4, atol=1e-6)
NOISY = ("value_hidden", "value_out", "advantage_hidden", "advantage_out")
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the learn-step parity suite: three games of 5, 3 and 4 actions on 44x44 frames
SPEC3 = MultiGameSpec(games=("a", "b", "c"), num_actions=(5, 3, 4), frame_shape=(44, 44))
B = 6


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


def _bf16_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -6 * scale, err_msg=what)


def _inject(monkeypatch, uniforms, normals):
    """jax.random.uniform hands out ``uniforms`` (U[0, 1) draws: the taus)
    and jax.random.normal ``normals`` in call order; returns both queues."""
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


# ------------------------------------------------------------------ copies
def test_parse_games_rejects_duplicates():
    assert parse_games("a, b ,c") == ("a", "b", "c")
    assert parse_games("") == ()
    with pytest.raises(ValueError):
        parse_games("a,b,a")


def test_spec_probe_and_lane_blocks():
    spec = MultiGameSpec.probe(("toy:catch", "toy:chain"), device="cpu")
    assert spec == TOY2 and spec.max_actions == 3
    env = build_game_lanes(spec, 3, seed=0, device="cpu")
    assert len(env) == 6 and env.num_actions == 3 and env.frame_shape == (80, 80)
    np.testing.assert_array_equal(lane_games(spec, 3), [0, 0, 0, 1, 1, 1])
    obs = env.reset()
    assert obs.shape == (6, 80, 80)
    assert obs[3:, 40:, :].max() == 0 and obs[3:, :40, :40].max() > 0


def test_spec_probe_of_device_games_on_the_cpu():
    """The four-game suite of the chip's apex_mt phase: 3, 5, 4 and 3
    actions, 80x80 frames everywhere."""
    spec = MultiGameSpec.probe(("jaxgame:breakout", "jaxgame:asterix", "jaxgame:invaders",
                                "jaxgame:freeway"), device="cpu")
    assert spec.num_actions == (3, 5, 4, 3) and spec.max_actions == 5
    assert spec.frame_shape == (80, 80)
    table = pops.action_mask_table(spec)
    assert table.sum(axis=1).tolist() == [3, 5, 4, 3]


def test_game_lane_env_maps_out_of_range_actions():
    from rainbow_iqn_apex_tpu_torch.envs import make_env

    env = GameLaneEnv(make_env("toy:chain", seed=0), TOY2, 1)
    env.reset()
    assert env.step(2).obs.shape == (80, 80)  # chain has 2 actions; 2 % 2 == 0


def test_apportion_and_interleave_schedule_modes():
    np.testing.assert_array_equal(apportion(16, np.asarray([0.5, 0.5])), [8, 8])
    counts = apportion(10, np.asarray([0.34, 0.33, 0.33]))
    assert counts.sum() == 10 and counts[0] == 4
    np.testing.assert_array_equal(apportion(5, np.asarray([1.0, 1.0])), [3, 2])
    sched = InterleaveSchedule("uniform", 2)
    np.testing.assert_allclose(sched.shares(np.asarray([10.0, 1000.0])), [0.5, 0.5])
    np.testing.assert_allclose(sched.shares(np.asarray([0.0, 7.0])), [0.0, 1.0])
    np.testing.assert_allclose(InterleaveSchedule("mass", 2).shares(np.asarray([1.0, 3.0])),
                               [0.25, 0.75])
    loss = InterleaveSchedule("loss", 2)
    for _ in range(60):
        loss.note_td(np.asarray([0, 0, 1, 1]), np.asarray([4.0, 4.0, 1.0, 1.0]))
    assert loss.shares(np.asarray([1.0, 1.0]))[0] > 0.7
    with pytest.raises(ValueError):
        InterleaveSchedule("nope", 2)


def _fill(mem, ticks=48, lanes=8, seed=0):
    rng = np.random.default_rng(seed)
    h, w = mem.spec.frame_shape
    for _ in range(ticks):
        mem.append_batch(rng.integers(0, 255, (lanes, h, w), np.uint8),
                         rng.integers(0, 2, lanes).astype(np.int32),
                         rng.normal(size=lanes).astype(np.float32), rng.random(lanes) < 0.05,
                         np.abs(rng.normal(size=lanes)) + 0.1)


def _build(cls=MultiGameReplay, spec=TOY2, schedule="uniform", shards_per_game=1, seed=11):
    return cls.build_games(spec, shards_per_game, 2048, 8, schedule=schedule, history=2,
                           n_step=3, gamma=0.9, seed=seed)


@pytest.mark.parametrize("schedule", ["uniform", "loss", "mass"])
def test_interleaved_sample_matches_the_jax_replay(schedule):
    """Same seed and appends: the port's sample stream (ids, weights, game
    ids, obs) is the JAX MultiGameReplay's, write-backs included."""
    jspec = JaxSpec(games=TOY2.games, num_actions=TOY2.num_actions, frame_shape=TOY2.frame_shape)
    port, ref = _build(schedule=schedule), _build(JaxMultiGameReplay, jspec, schedule)
    _fill(port, seed=5)
    _fill(ref, seed=5)
    for draw in range(6):
        sp, sj = port.sample(16, 0.6), ref.sample(16, 0.6)
        np.testing.assert_array_equal(sp.idx, sj.idx)
        np.testing.assert_array_equal(sp.game, sj.game)
        np.testing.assert_array_equal(sp.obs, sj.obs)
        np.testing.assert_allclose(sp.weight, sj.weight, rtol=1e-6)
        td = np.abs(np.sin(np.arange(16) + draw)) + 0.1
        port.update_priorities(sp.idx, td)
        ref.update_priorities(sj.idx, td)
    np.testing.assert_array_equal(port.learn_rows_by_game, ref.learn_rows_by_game)
    if schedule == "uniform":
        np.testing.assert_array_equal(np.bincount(sp.game, minlength=2), [8, 8])


def test_per_game_shard_drop_never_starves_siblings():
    mem = _build(shards_per_game=2)
    _fill(mem, ticks=48)
    rng = np.random.default_rng(0)

    def traffic_tick():
        h, w = mem.spec.frame_shape
        mem.append_batch(rng.integers(0, 255, (8, h, w), np.uint8),
                         rng.integers(0, 2, 8).astype(np.int32),
                         rng.normal(size=8).astype(np.float32), rng.random(8) < 0.05,
                         np.abs(rng.normal(size=8)) + 0.1)
        batch = mem.sample(16, 0.6)
        mem.update_priorities(batch.idx, np.abs(rng.normal(size=len(batch.idx))) + 0.1)
        return batch

    for _ in range(4):
        traffic_tick()
    for k in mem.game_shards(0):
        mem.drop_shard(k)
    assert mem.dead_games() == [0] and mem.sampleable
    for _ in range(6):
        batch = traffic_tick()
        assert (batch.game == 1).all() and len(batch.idx) == 16
    for k in mem.game_shards(0):
        mem.readmit_shard(k)
    assert mem.dead_games() == []
    for _ in range(6):
        batch = traffic_tick()
    np.testing.assert_array_equal(np.bincount(batch.game, minlength=2), [8, 8])
    with pytest.raises(RuntimeError):
        other = _build()
        for k in range(2):
            other.drop_shard(k)


def test_device_batch_threads_game_ids():
    from rainbow_iqn_apex_tpu_torch.agents.agent import to_device_batch

    mem = _build()
    _fill(mem)
    sample = mem.sample(16, 0.5)
    batch = to_device_batch(sample, torch.device("cpu"))
    assert batch.game.dtype == torch.int32
    np.testing.assert_array_equal(batch.game.numpy(), sample.game)
    np.testing.assert_array_equal(sample.game, mem.games_of(sample.idx))


def test_games_obs_row_and_aggregates():
    from rainbow_iqn_apex_tpu_torch.obs.schema import validate_row

    gobs = GamesObs(TOY2)
    gobs.note_eval({"games": {"toy:catch": {"score_mean": -1.0, "human_normalized": -0.111}}})
    payload = gobs.row(learn_shares=np.asarray([0.25, 0.75]), learn_rows=np.asarray([25, 75]),
                       game_sizes=np.asarray([100, 300]), game_occupancy=np.asarray([0.1, 0.3]),
                       dead_games=[])
    assert payload["games"]["toy:catch"]["learn_share"] == 0.25
    assert payload["games"]["toy:chain"]["replay_size"] == 300 and payload["hn_games"] == 1
    row = {"kind": "games", "schema": 1, "ts": 0.0, "host": 0, "run": "r", "step": 5, **payload}
    assert validate_row(row) == []
    agg = aggregate_human_normalized({"toy:catch": 0.5, "toy:chain": 0.25, "x": None})
    assert agg == {"hn_games": 2, "hn_median": 0.375, "hn_mean": 0.375}


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2g_forward_and_backward_match_jax(dtype):
    """phi + E[game] merged with psi, and its vjp (dphi, dW_e, db_e, dE),
    with a random non-zero E: a wrong game index would show."""
    jdt, tdt = DT[dtype]
    feat, cos_n, batch, n, games = 40, 16, 5, 8, 3
    rng = np.random.default_rng(21)
    kernel = (rng.standard_normal((cos_n, feat)) * 0.3).astype(np.float32)
    bias = rng.normal(0, 0.1, feat).astype(np.float32)
    taus = rng.random((batch, n), dtype=np.float32)
    phi = np.asarray(jnp.asarray(rng.random((batch, feat), dtype=np.float32), jdt)
                     .astype(jnp.float32))
    emb = rng.normal(0, 0.5, (games, feat)).astype(np.float32)
    game = np.asarray([2, 0, 2, 1, 0], np.int32)
    g = rng.standard_normal((batch * n, feat)).astype(np.float32)
    mod = JaxCosEmbed(features=feat, num_cosines=cos_n, compute_dtype=jdt)

    def f(params, ph, e):
        ph = ph + e[jnp.asarray(game)].astype(ph.dtype)  # multitask/model.py:89
        psi = mod.apply({"params": params}, jnp.asarray(taus))
        return (ph[:, None, :].astype(jdt) * psi).reshape(batch * n, feat)

    params = {"embed": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    h_ref, vjp = jax.vjp(f, params, jnp.asarray(phi, jdt), jnp.asarray(emb))
    gp, gphi, gemb = vjp(jnp.asarray(g).astype(h_ref.dtype))
    w = _t(kernel.T).to(tdt).requires_grad_()
    b = _t(bias).requires_grad_()
    pt = _t(phi).to(tdt).requires_grad_()
    et = _t(emb).requires_grad_()
    gt = _t(game)
    h = TauEmbedFn.apply(_t(taus), w, b, pt, gt, et)
    h.backward(_t(g).to(tdt))
    with torch.no_grad():
        assert torch.equal(tau_embed(_t(taus), w, b, pt, gt, et), h)
    pairs = [(h.detach().float(), h_ref, "h"), (pt.grad.float(), gphi, "dphi"),
             (w.grad.float().T, gp["embed"]["kernel"], "dW_e"),
             (b.grad, gp["embed"]["bias"], "db_e"), (et.grad, gemb, "dE")]
    assert et.grad.dtype == torch.float32
    for got, want, what in pairs:
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dtype == "float32":
            _close(got.numpy(), want, FP32, what)
        else:
            _bf16_close(got.numpy(), want, what)


def _dueling_inputs(seed, batch=4, n=6, actions=5):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((batch * n, 1)).astype(np.float32)
    adv = rng.standard_normal((batch * n, actions)).astype(np.float32)
    return value, adv


def _jax_quantiles(value, adv, n):
    q = value + adv - adv.mean(axis=-1, keepdims=True)
    return jnp.asarray(q.reshape(-1, n, adv.shape[1]))


def test_k4m_matches_masked_q_values_and_greedy_action():
    """Three games of 5, 3 and 4 actions; rows 1 and 3 would take a pad
    slot without the mask."""
    n = 6
    value, adv = _dueling_inputs(31)
    adv[1 * n:2 * n, 4] += 10.0  # row 1 (game 1: 3 actions) prefers slot 4
    adv[3 * n:4 * n, 4] += 10.0  # row 3 (game 2: 4 actions) too
    game = np.asarray([0, 1, 0, 2], np.int32)
    table = pops.action_mask_table(SPEC3)
    quantiles = _jax_quantiles(value, adv, n)
    assert int(jnp.argmax(jlearn.q_values(quantiles)[1])) == 4  # unmasked: a pad slot
    q_ref = jmodel.masked_q_values(quantiles, jnp.asarray(game), jnp.asarray(table))
    a_ref = jmodel.masked_greedy_action(quantiles, jnp.asarray(game), jnp.asarray(table))
    got_quant, got_q, got_a = dueling_head(_t(value), _t(adv), n, _t(game), _t(table))
    _close(got_quant.numpy(), quantiles, FP32, "quantiles (unmasked)")
    _close(got_q.numpy(), q_ref, FP32, "masked q")
    assert got_q[1, 3].item() == MASK_FILL == jmodel.MASK_FILL
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(a_ref))
    assert got_a[1].item() < 3 and got_a[3].item() < 4
    # the model-level helpers agree with the kernel's twin
    np.testing.assert_array_equal(
        pmodel.masked_greedy_action(got_quant, _t(game), _t(table)).numpy(), got_a.numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_k4l_matches_the_policy_log_softmax(masked):
    n = 6
    value, adv = _dueling_inputs(32)
    game = np.asarray([1, 2, 0, 1], np.int32)
    take = np.asarray([2, 3, 4, 0], np.int32)
    table = pops.action_mask_table(SPEC3)
    quantiles = _jax_quantiles(value, adv, n)
    if masked:
        q = jmodel.masked_q_values(quantiles, jnp.asarray(game), jnp.asarray(table))
    else:
        q = jlearn.q_values(quantiles)
    ref = jnp.take_along_axis(jax.nn.log_softmax(q, axis=-1), jnp.asarray(take)[:, None],
                              axis=-1)[..., 0]
    args = (_t(game), _t(table)) if masked else ()
    logp, q_got = dueling_logp(_t(value), _t(adv), n, _t(take), *args)
    _close(logp.numpy(), ref, FP32, "logp")
    _close(q_got.numpy(), q, FP32, "q")
    again, _ = dueling_logp(_t(value), _t(adv), n, _t(take), *args)
    assert torch.equal(again, logp)  # a zero-drift reuse pass: ratio exactly 1


# ------------------------------------------------------------------ model
def _cfgs(dtype="float32", **kw):
    base = dict(compute_dtype=dtype, frame_height=44, frame_width=44, history_length=2,
                hidden_size=32, num_cosines=16, num_tau_samples=8, num_tau_prime_samples=8,
                num_quantile_samples=4, batch_size=B, learning_rate=1e-3, adam_eps=1.5e-4,
                max_grad_norm=10.0, target_update_period=100)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _jspec(spec):
    return JaxSpec(games=spec.games, num_actions=spec.num_actions, frame_shape=spec.frame_shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_game_zero_embedding_is_the_single_game_network(dtype):
    """JAX's N = 1 parity (tests/test_multitask.py:216-254) in the port:
    same trunk and heads, zero game embedding -> bit-equal quantiles, q
    and actions."""
    _, pcfg = _cfgs(dtype)
    spec1 = MultiGameSpec(games=("toy:catch",), num_actions=(3,), frame_shape=(44, 44))
    single = init_network_(make_network(pcfg, 3), torch.Generator().manual_seed(0))
    mt = pops.make_mt_network(pcfg, spec1)
    missing = mt.load_state_dict(single.state_dict(), strict=False)
    assert missing.missing_keys == ["game_embed"] and not missing.unexpected_keys
    assert float(mt.game_embed.detach().abs().max()) == 0.0
    obs = _t(np.random.default_rng(1).integers(0, 255, (4, 44, 44, 2), dtype=np.uint8))
    with torch.no_grad():
        a = single(obs, 8, generator=torch.Generator().manual_seed(2))
        b = mt(obs, 8, generator=torch.Generator().manual_seed(2),
               game=torch.zeros(4, dtype=torch.int32))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_multigame_forward_matches_jax_with_a_random_embedding(monkeypatch):
    jcfg, pcfg = _cfgs()
    jspec = _jspec(SPEC3)
    params = jops.init_mt_train_state(jcfg, jspec, jax.random.PRNGKey(0)).params
    rng = np.random.default_rng(3)
    emb = rng.normal(0, 0.5, np.shape(params["game_embed"]["embedding"])).astype(np.float32)
    params = {**params, "game_embed": {"embedding": jnp.asarray(emb)}}
    feat = emb.shape[1]
    obs = rng.integers(0, 255, (B, 44, 44, 2), dtype=np.uint8)
    game = np.asarray([0, 1, 2, 2, 1, 0], np.int32)
    taus = rng.random((B, 8), dtype=np.float32)
    noise = {layer: (rng.standard_normal(i).astype(np.float32),
                     rng.standard_normal(o).astype(np.float32))
             for layer, (i, o) in zip(NOISY, [(feat, 32), (32, 1), (feat, 32), (32, 5)])}
    _inject(monkeypatch, [taus], [a for layer in NOISY for a in noise[layer]])
    net = jops.make_mt_network(jcfg, jspec)
    q_ref, _ = net.apply({"params": params}, obs, game, 8,
                         rngs={"taus": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)})
    table = jnp.asarray(jops.action_mask_table(jspec))
    pnet = pops.make_mt_network(pcfg, SPEC3)
    pnet.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = pnet(_t(obs), 8, taus=_t(taus), game=_t(game),
                   noise={k: (_t(a), _t(b)) for k, (a, b) in noise.items()})
    _close(out.quantiles.numpy(), q_ref, FP32, "quantiles")
    _close(out.q.numpy(), jmodel.masked_q_values(q_ref, jnp.asarray(game), table), FP32, "q")
    np.testing.assert_array_equal(
        out.action.numpy(), np.asarray(jmodel.masked_greedy_action(q_ref, jnp.asarray(game), table)))
    # the flax tree comes back whole
    back = convert.to_flax(pnet.state_dict())
    np.testing.assert_array_equal(back["game_embed"]["embedding"], emb)


# ------------------------------------------------------------- learn step
def _batch(seed):
    rng = np.random.default_rng(seed)
    game = np.asarray([0, 1, 2, 0, 1, 2], np.int32)
    return dict(
        obs=rng.integers(0, 256, (B, 44, 44, 2), dtype=np.uint8),
        action=np.asarray([rng.integers(0, SPEC3.num_actions[g]) for g in game], np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        next_obs=rng.integers(0, 256, (B, 44, 44, 2), dtype=np.uint8),
        discount=np.asarray([0.9, 0.9, 0.0, 0.81, 0.9, 0.9], np.float32),
        weight=rng.uniform(0.5, 1.5, B).astype(np.float32),
        game=game,
    )


def _forward_draws(rng, feat, hidden, n, actions):
    dims = [(feat, hidden), (hidden, 1), (feat, hidden), (hidden, actions)]
    return (rng.random((B, n), dtype=np.float32),
            {layer: (rng.standard_normal(i).astype(np.float32),
                     rng.standard_normal(o).astype(np.float32))
             for layer, (i, o) in zip(NOISY, dims)})


def _pass_draws(cfg, feat, rng):
    return {name: _forward_draws(rng, feat, cfg.hidden_size, n, SPEC3.max_actions)
            for name, n in (("select", cfg.num_quantile_samples),
                            ("target", cfg.num_tau_prime_samples),
                            ("online", cfg.num_tau_samples))}


def _flat(draws_list):
    """(uniforms, normals) of JAX forwards in call order."""
    uniforms, normals = [], []
    for taus, noise in draws_list:
        uniforms.append(taus)
        normals += [a for layer in NOISY for a in noise[layer]]
    return uniforms, normals


def _pass_forwards(d):
    return [d["select"], d["target"], d["online"]]


def _port_forward(draw):
    taus, noise = draw
    return _t(taus), {k: (_t(a), _t(b)) for k, (a, b) in noise.items()}


@functools.lru_cache(maxsize=None)
def _warm_mt_state():
    """A JAX multi-game TrainState two fp32 steps in: Adam moments non-zero
    and the game embedding moved off zero."""
    jcfg, _ = _cfgs()
    jspec = _jspec(SPEC3)
    # eager: compiling the whole step would cost more than the two steps
    state = jops.init_mt_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    step = jops.build_mt_learn_step(jcfg, jspec)
    for k in range(2):
        batch = jlearn.Batch(**{n: jnp.asarray(v) for n, v in _batch(20 + k).items()})
        state, _ = step(state, batch, jax.random.PRNGKey(100 + k))
    assert float(jnp.abs(state.params["game_embed"]["embedding"]).max()) > 0
    return state


def _adam(opt_state):
    import optax

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


def _port_state(pcfg, jstate):
    st = pops.init_mt_train_state(pcfg, SPEC3, seed=0, device="cpu")
    adam = _adam(jstate.opt_state)
    host = convert.from_flax_train_state(_np(jstate.params), _np(jstate.target_params),
                                         _np(adam.mu), _np(adam.nu), adam.count, jstate.step)
    return plearn.load_host_state(st, host)


def compare_states(pstate, jstate, tol):
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


@pytest.mark.parametrize("ratio", [1, 2])
def test_multigame_learn_step_matches_jax(monkeypatch, ratio):
    """build_mt_learn_step from one converted state: info, then params
    (game_embed included), target and Adam state.  At replay_ratio 2 the
    JAX step draws the ratio forward, pass 1, the ratio forward again (the
    same arrays: one shared ratio key) and pass 2."""
    jcfg, pcfg = _cfgs(replay_ratio=ratio)
    jstate = _warm_mt_state()
    pstate = _port_state(pcfg, jstate)
    feat = jstate.params["game_embed"]["embedding"].shape[1]
    rng = np.random.default_rng(50 + ratio)
    passes = [_pass_draws(pcfg, feat, rng) for _ in range(ratio)]
    ratio_draw = _forward_draws(rng, feat, pcfg.hidden_size, pcfg.num_quantile_samples,
                                SPEC3.max_actions)
    seq = _pass_forwards(passes[0]) if ratio == 1 else (
        [ratio_draw] + _pass_forwards(passes[0]) + [ratio_draw] + _pass_forwards(passes[1]))
    uq, nq = _inject(monkeypatch, *_flat(seq))
    b = _batch(60)
    jstate2, jinfo = jops.build_mt_learn_step(jcfg, _jspec(SPEC3))(
        jstate, jlearn.Batch(**{n: jnp.asarray(v) for n, v in b.items()}), jax.random.PRNGKey(7))
    assert not uq and not nq  # every JAX forward drew exactly once
    pbatch = plearn.Batch(**{n: _t(v) for n, v in b.items()})
    pdraws = {k: _port_forward(v) for k, v in passes[0].items()}
    if ratio > 1:
        pdraws = {"ratio": _port_forward(ratio_draw),
                  "passes": [{k: _port_forward(v) for k, v in d.items()} for d in passes]}
    pstate, pinfo = pops.build_mt_learn_step(pcfg, SPEC3)(pstate, pbatch, draws=pdraws)
    keys = ["loss", "priorities", "q_mean", "target_q_mean", "grad_norm"]
    if ratio > 1:
        keys.append("clip_frac")
        assert pinfo["replay_ratio"] == 2 and pinfo["reuse_index"] == 1
    for key in keys:
        _close(pinfo[key].numpy(), jinfo[key], STEP_INFO, key)
    assert bool(pinfo["finite"]) and bool(jinfo["finite"])
    assert pstate.step == int(jstate2.step) == int(jstate.step) + ratio
    compare_states(pstate, jstate2, STEP_STATE)


def test_reuse_clip_engages_as_composed_by_hand():
    """Port only: a K = 2 multi-game step with a large learning rate and a
    tight clip equals pass 1, then the masked ratio clipped by hand, then
    pass 2 with the clipped ratio as the weight scale."""
    _, pcfg = _cfgs(replay_ratio=2, reuse_clip=1.01, learning_rate=0.5)
    single = pops.build_mt_learn_step(pcfg.replace(replay_ratio=1), SPEC3)
    b = plearn.Batch(**{n: _t(v) for n, v in _batch(61).items()})
    feat = _warm_mt_state().params["game_embed"]["embedding"].shape[1]
    rng = np.random.default_rng(9)
    passes = [{k: _port_forward(v) for k, v in _pass_draws(pcfg, feat, rng).items()}
              for _ in range(2)]
    ratio_draw = _port_forward(_forward_draws(rng, feat, 32, 4, 5))
    fused_state = pops.init_mt_train_state(pcfg, SPEC3, seed=4, device="cpu")
    fused_state, info = pops.build_mt_learn_step(pcfg, SPEC3)(
        fused_state, b, draws={"ratio": ratio_draw, "passes": passes})
    st = pops.init_mt_train_state(pcfg, SPEC3, seed=4, device="cpu")
    logp = plearn.make_policy_logp(pcfg)
    behav = logp(st.net, b, *ratio_draw)
    st, _ = single(st, b, draws=passes[0])
    ratio = torch.exp(logp(st.net, b, *ratio_draw) - behav)
    clipped = ratio.clamp(1 / 1.01, 1.01)
    st, info2 = single(st, b, draws=passes[1], weight_scale=clipped)
    frac = float((ratio != clipped).float().mean())
    assert frac > 0 and float(info["clip_frac"]) == frac
    assert fused_state.step == st.step == 2
    assert torch.equal(info["priorities"], info2["priorities"])
    for p, q in zip(fused_state.net.parameters(), st.net.parameters()):
        assert torch.equal(p, q)


# ------------------------------------------------------------------- loop
def _rows(cfg):
    path = os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_two_game_apex_run_end_to_end(tmp_path):
    """tests/test_multitask.py's acceptance run (:389-437) through the
    port's train_apex on the CPU, with that test's own assertions."""
    from rainbow_iqn_apex_tpu_torch.obs.schema import validate_row
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex
    from scripts.lint_jsonl import lint_line

    cfg = Config(
        compute_dtype="float32", history_length=2, hidden_size=64, num_cosines=16,
        num_tau_samples=8, num_tau_prime_samples=8, num_quantile_samples=4, multi_step=3,
        gamma=0.9, games="toy:catch,toy:chain", batch_size=16, learning_rate=1e-3,
        memory_capacity=4096, learn_start=256, frames_per_learn=4, target_update_period=200,
        num_envs_per_actor=8, metrics_interval=50, eval_interval=0, checkpoint_interval=0,
        eval_episodes=2, run_id="mt_e2e", results_dir=str(tmp_path / "results"),
        checkpoint_dir=str(tmp_path / "ckpt"))
    summary = train_apex(cfg, max_frames=768, device="cpu")
    assert summary["frames"] == 768 and summary["learn_steps"] > 0
    assert summary["eval_hn_games"] == 2 and np.isfinite(summary["eval_hn_median"])
    path = os.path.join(cfg.results_dir, cfg.run_id, "metrics.jsonl")
    rows = []
    for line in open(path):
        assert lint_line(line) is None, line
        row = json.loads(line)
        assert validate_row(row) == [], row
        rows.append(row)
    eval_games = {r["game"] for r in rows if r["kind"] == "eval" and r.get("game")}
    assert eval_games == {"toy:catch", "toy:chain"}
    games_rows = [r for r in rows if r["kind"] == "games"]
    assert games_rows and set(games_rows[-1]["games"]) == eval_games
    shares = [g["learn_share"] for g in games_rows[-1]["games"].values()]
    assert all(s == pytest.approx(0.5, abs=0.05) for s in shares)
    mt_rows = [r for r in rows if r["kind"] == "eval_mt"]
    assert mt_rows and mt_rows[-1]["hn_median"] is not None


def test_multigame_rejects_lanes_that_do_not_divide(tmp_path):
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex

    cfg = Config(games="toy:catch,toy:chain", num_envs_per_actor=3, compute_dtype="float32",
                 results_dir=str(tmp_path / "r"), checkpoint_dir=str(tmp_path / "c"))
    with pytest.raises(ValueError, match="divide across"):
        train_apex(cfg, max_frames=64, device="cpu")
