"""The port's kernels (rainbow_iqn_apex_tpu_torch.kernels): K2 tau embed,
K3 noisy linear, K4 dueling head, and the learner's K1 quantile-Huber and
the backward kernels of K2, K3 and K4 (their twins are held against
jax.grad in tests/test_torch_learn.py and tests/test_torch_losses.py).

On the CPU each wrapper must run its plain twin (and count no launch), and
each plain twin must match its JAX counterpart: K2 against
CosineTauEmbedding plus the Hadamard merge, K3 against NoisyLinear, K4
against the dueling combine with q_values / greedy_action.  K3's and
K3-bwd's launch plans (tile height, dW's tile width and split over M,
workspace sizes) are checked on the CPU at every main-path shape.  Inputs come from
seeded numpy draws; noise is injected on the JAX side by monkeypatching
``jax.random.normal`` in this process only.

The ``cuda``-marked tests hold each CUDA kernel against its plain twin on
the card and skip where there is none.  Tolerances: fp32 paths 1e-5 abs/rel
(summation order only); bf16 twin-vs-JAX 1e-2 abs/rel (one bf16 ulp is
2^-8 relative); on the card, K2's bf16 output within 1e-2 abs/rel (a
different fp32 accumulation order can move a bf16 rounding by one ulp),
K3's fp32 output within 2e-3 abs/rel (tensor-core fp32 accumulation over up
to 3136 terms in another order), K4 within 1e-5.  The learner's kernels on
the card: K1 1e-5 (fp32, summation order); K2-bwd and K3-bwd 1e-2 abs/rel
on their bf16 results (fp32 sums in another order move a bf16 rounding by
one ulp; K3-bwd splits the fp32 dy into two bf16 halves, exact to ~2^-17,
and dys into three planes in the noisy dx product),
and K3-bwd bit-equal on a repeat (no atomics);
K4's gather mode and K4-bwd 1e-6 (one fp32 product and subtraction).
R2D2's kernels on the card: K9 and K9-bwd 1e-4 abs/rel (fp32 products of
512 (2048) terms per step summed in another order, carried through up to 120
steps of the recurrence); K11 1e-5 (fp32, summation order); K8s-stack
bit-equal (a byte copy).  The R2D2 Anakin sequence replay's kernels on the
card: K7s bit-equal (ring rows [0, C), priorities, counters and each
builder's valid prefix; byte and fp32 copies); K5s equal on dyadic
priorities and a cold ring, and against an fp64 cdf within 1e-5 of the
total at a boundary; K8s's gathers bit-equal, prob and weights 1e-6 relative
(one division and powf against torch's); K6s 1e-6 relative (powf).  The
multi-game modes: K2g's bf16 output 1e-2 abs/rel as K2's; K2g-bwd 4 bf16
ulps (2^-6) of each element and of its output's largest (the CPU tests'
bound for bf16 gradients: dphi sums products with psi, whose bf16 rounding
can differ by an ulp under another fp32 order of the Dense product, and the
sum can cancel); K4m and K4l 1e-5 (fp32).
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; where JAX is not installed only the cuda tests run
    import jax
    import jax.numpy as jnp

    from rainbow_iqn_apex_tpu.models.iqn import greedy_action as jax_greedy_action
    from rainbow_iqn_apex_tpu.models.iqn import q_values as jax_q_values
    from rainbow_iqn_apex_tpu.models.layers import CosineTauEmbedding as JaxCosEmbed
    from rainbow_iqn_apex_tpu.models.layers import NoisyLinear as JaxNoisyLinear
except ImportError:
    jax = None
from rainbow_iqn_apex_tpu_torch.kernels import launches
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
    dueling_gather,
    dueling_gather_bwd,
    dueling_gather_bwd_plain,
    dueling_gather_plain,
    dueling_head,
    dueling_head_plain,
    DuelingGatherFn,
    dueling_learn,
    dueling_learn_plain,
    dueling_logp,
    dueling_logp_plain,
    dueling_loss_bwd,
    dueling_loss_bwd_plain,
    learn_smem,
    row_plan,
)
from rainbow_iqn_apex_tpu_torch.kernels import noisy_linear as noisy_linear_module
from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
    noisy_linear,
    noisy_linear_bwd,
    noisy_linear_bwd_plain,
    noisy_linear_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.learn_loss import learn_loss
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import (
    QuantileHuberFn,
    loss_plan,
    quantile_huber,
    quantile_huber_plain,
    quantile_huber_weighted,
    quantile_huber_weighted_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels import tau_embed as tau_embed_module
from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
    TauEmbedFn,
    tau_embed,
    tau_embed_bwd,
    tau_embed_bwd_plain,
    tau_embed_plain,
)
from rainbow_iqn_apex_tpu_torch.models.layers import _f

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX package as the reference")
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rng(seed):
    return np.random.default_rng(seed)


def _k2_inputs(batch=3, n=8, feat=96, cos=16, seed=0):
    r = _rng(seed)
    return (r.random((batch, n), dtype=np.float32),
            (r.standard_normal((cos, feat)) * cos ** -0.5).astype(np.float32),  # flax [in, out]
            (r.standard_normal(feat) * 0.1).astype(np.float32),
            r.random((batch, feat), dtype=np.float32))


def _k3_inputs(m=12, k=48, n=20, seed=1):
    r = _rng(seed)
    return (r.standard_normal((m, k)).astype(np.float32),
            {"w_mu": (r.uniform(-1, 1, (k, n)) * k ** -0.5).astype(np.float32),
             "b_mu": (r.standard_normal(n) * 0.1).astype(np.float32),
             "w_sigma": (r.uniform(0.2, 1.0, (k, n)) * k ** -0.5).astype(np.float32),
             "b_sigma": (r.uniform(0.2, 1.0, n) * 0.1).astype(np.float32)},
            r.standard_normal(k).astype(np.float32),
            r.standard_normal(n).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# ------------------------------------------------ CPU: wrapper -> plain twin
def test_wrappers_run_plain_twin_on_cpu_without_counting():
    before = dict(launches)
    taus, w, b, phi = _k2_inputs()
    h = tau_embed(_t(taus), _t(w.T), _t(b), _t(phi))
    assert torch.equal(h, tau_embed_plain(_t(taus), _t(w.T), _t(b), _t(phi)))
    x, p, e_in, e_out = _k3_inputs()
    args = (_t(x), _t(p["w_mu"].T), _t(p["b_mu"]), _t(p["w_sigma"].T), _t(p["b_sigma"]),
            _f(_t(e_in)), _f(_t(e_out)))
    assert torch.equal(noisy_linear(*args, relu=True), noisy_linear_plain(*args, relu=True))
    v, a = _t(_rng(2).standard_normal((16, 1))), _t(_rng(3).standard_normal((16, 5)))
    for got, want in zip(dueling_head(v, a, 8), dueling_head_plain(v, a, 8)):
        assert torch.equal(got, want)
    assert dict(launches) == before  # the CPU path launched no kernel


def test_learner_wrappers_run_plain_twins_on_cpu_without_counting():
    before = dict(launches)
    r = _rng(9)
    o, t, tg = (_t(r.standard_normal((3, 8))), _t(r.random((3, 8))), _t(r.standard_normal((3, 6))))
    for got, want in zip(quantile_huber(o, t, tg, 1.0), quantile_huber_plain(o, t, tg, 1.0)):
        assert torch.equal(got, want)
    taus, w, b, phi = _k2_inputs()
    dh = _t(r.standard_normal((taus.size, w.shape[1])))
    k2 = (_t(taus), _t(w.T), _t(b), _t(phi), dh)
    for got, want in zip(tau_embed_bwd(*k2), tau_embed_bwd_plain(*k2)):
        assert torch.equal(got, want)
    x, p, e_in, e_out = _k3_inputs()
    g = _t(r.standard_normal((x.shape[0], p["w_mu"].shape[1])))
    k3 = (g, None, _t(x), _t(p["w_mu"].T), _t(p["w_sigma"].T), _f(_t(e_in)), _f(_t(e_out)))
    for got, want in zip(noisy_linear_bwd(*k3), noisy_linear_bwd_plain(*k3)):
        assert torch.equal(got, want)
    v, a = _t(r.standard_normal((16, 1))), _t(r.standard_normal((16, 5)))
    take = torch.tensor([1, 4], dtype=torch.int32)
    for got, want in zip(dueling_gather(v, a, 8, take), dueling_gather_plain(v, a, 8, take)):
        assert torch.equal(got, want)
    dz = _t(r.standard_normal((2, 8)))
    for got, want in zip(dueling_gather_bwd(dz, take, 5, True),
                         dueling_gather_bwd_plain(dz, take, 5, True)):
        assert torch.equal(got, want)
    assert dict(launches) == before


# --------------------------------------------- plain twins vs the JAX package
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_jax_embedding_and_merge(jax_ref, dtype):
    jdt, tdt = jax_ref[dtype], TORCH_DTYPES[dtype]
    taus, w, b, phi = _k2_inputs()
    psi = JaxCosEmbed(features=w.shape[1], num_cosines=w.shape[0], compute_dtype=jdt).apply(
        {"params": {"embed": {"kernel": w, "bias": b}}}, jnp.asarray(taus))
    want = (jnp.asarray(phi)[:, None, :].astype(jdt) * psi).reshape(-1, w.shape[1])
    got = tau_embed_plain(_t(taus), _t(w.T, tdt), _t(b), _t(phi, tdt))
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(FP32 if dtype == "float32" else BF16))


# the shapes the kernels take since their limits were lifted: any num_cosines
# (8, 24, 72: off the MMA's 16, past one 64-wide box; 13: a row stride TMA
# cannot take, so W_e is copied by the producer warp), 200 taus a row, batch 1
# and an odd batch, F off the 64-feature tile
K2_LIFTED = [(1, 200, 200, 72), (3, 5, 200, 24), (2, 16, 256, 8), (5, 8, 96, 72),
             (3, 8, 200, 13)]


@pytest.mark.parametrize("batch,n,feat,cos", K2_LIFTED)
def test_k2_plain_matches_jax_at_the_lifted_shapes(jax_ref, batch, n, feat, cos):
    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    jdt = jax_ref["float32"]
    psi = JaxCosEmbed(features=feat, num_cosines=cos, compute_dtype=jdt).apply(
        {"params": {"embed": {"kernel": w, "bias": b}}}, jnp.asarray(taus))
    want = (jnp.asarray(phi)[:, None, :] * psi).reshape(-1, feat)
    got = tau_embed_plain(_t(taus), _t(w.T), _t(b), _t(phi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
def test_k3_plain_matches_jax_noisy_linear(jax_ref, monkeypatch, use_noise, relu, dtype):
    jdt, tdt = jax_ref[dtype], TORCH_DTYPES[dtype]
    x, p, e_in, e_out = _k3_inputs()
    queue = [e_in, e_out]
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(queue.pop(0), dtype))
    want = JaxNoisyLinear(p["w_mu"].shape[1], use_noise=use_noise, compute_dtype=jdt).apply(
        {"params": p}, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(0)})
    if relu:
        want = jax.nn.relu(want)
    noise = (_t(p["w_sigma"].T, tdt), _t(p["b_sigma"]), _f(_t(e_in)), _f(_t(e_out)))
    got = noisy_linear_plain(_t(x, tdt), _t(p["w_mu"].T, tdt), _t(p["b_mu"]),
                             *(noise if use_noise else ()), relu=relu)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def _jax_dueling(value, adv, n):
    """models/iqn.py:97 (the combine) and :105-111 (q_values, greedy_action)."""
    q = value + adv - adv.mean(axis=-1, keepdims=True)
    quantiles = q.reshape(-1, n, adv.shape[-1]).astype(jnp.float32)
    return quantiles, jax_q_values(quantiles), jax_greedy_action(quantiles)


def test_k4_plain_matches_jax_dueling_q_values_greedy(jax_ref):
    v = _rng(4).standard_normal((5 * 8, 1)).astype(np.float32)
    a = _rng(5).standard_normal((5 * 8, 6)).astype(np.float32)
    want = _jax_dueling(jnp.asarray(v), jnp.asarray(a), 8)
    got = dueling_head_plain(_t(v), _t(a), 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FP32)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **FP32)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32


def test_k4_plain_first_index_wins_a_forced_tie(jax_ref):
    a = np.zeros((2 * 4, 5), np.float32)
    a[:, 1] = a[:, 3] = 1.0  # actions 1 and 3 tie exactly in every row
    v = np.full((2 * 4, 1), 0.5, np.float32)
    want = _jax_dueling(jnp.asarray(v), jnp.asarray(a), 4)
    _, q, action = dueling_head_plain(_t(v), _t(a), 4)
    assert q[0, 1] == q[0, 3]
    assert action.tolist() == [1, 1] == np.asarray(want[2]).tolist()
    _, _, no_duel = dueling_head_plain(None, _t(a), 4)
    assert no_duel.tolist() == [1, 1]


# ----------------------------------------- CPU: K3 / K3-bwd launch plans
# every (M, K, N) the main paths give K3: the IQN learner (M 2048 at s and s',
# 1024 for the online pass at s' with K 32), serving buckets 8-64 x K 32, the
# act tick (16 lanes x 32 taus) on Atari and jaxgame frames, multi-game heads,
# R2D2's heads over B x T rows and at a 16-lane tick, and the catch widths
PLAN_SHAPES = [(m, k, n) for m in (2048, 1024, 512, 256) for k, n in
               ((3136, 512), (2304, 512), (512, 1), (512, 18), (512, 5))] + [
    (m, 512, n) for m in (2560, 3840, 16) for n in (512, 1, 18)] + [
    (256, 2304, 128), (1024, 2304, 128), (256, 128, 3), (33, 40, 70), (64, 200, 512)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_k3_launch_plans_cover_the_shape(m, k, n):
    nl = noisy_linear_module
    cd = nl._cdiv
    nwg = nl.forward_plan(m, n)
    if n <= nl.NARROW_N:
        assert nwg == 0  # the mma.sync path: 16 rows a block, all N columns
    else:
        assert nwg in (1, 2)
        big = cd(m, 128) * cd(n, 64) >= nl.FULL_WAVE
        assert (nwg == 2) == big  # the taller tile only where it still fills a wave
        assert cd(m, 64 * nwg) * 64 * nwg >= m and cd(n, 64) * 64 >= n
    for noisy in (False, True):
        plan = nl.backward_plan(m, n, k, noisy)
        n8, mp, planes = cd(n, 8) * 8, cd(m, 8) * 8, 4 if noisy else 2  # as the C entry pads
        p_planes = 5 if noisy else 2  # dx's planes: dys gets a third (its lo2)
        assert plan.bn_w in (8, 24, 64) and (plan.bn_w >= n8 or plan.bn_w == 64)
        m_tiles = cd(m, 64)
        chunks = [range(c * m_tiles // plan.splits, (c + 1) * m_tiles // plan.splits)
                  for c in range(plan.splits)]  # as csrc/noisy_linear_bwd.cu cuts them
        assert all(len(c) > 0 for c in chunks)  # no chunk is empty
        assert [t for c in chunks for t in c] == list(range(m_tiles))  # each depth tile once
        tiles = cd(k, nl.BK_BWD) * cd(n, plan.bn_w)
        assert tiles * plan.splits >= min(nl.FULL_WAVE, tiles * m_tiles)
        partials = (2 if noisy else 1) * plan.splits * n * k if plan.splits > 1 else 0
        assert plan.ws_bf16 == p_planes * m * n8 + planes * n8 * mp
        assert plan.ws_f32 == cd(mp, 32) * n + partials



@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
@pytest.mark.parametrize("noisy", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("clusters", [tuple(132 // s for s in range(1, 9)),
                                      (132, 66, 30, 16, 12, 10, 8, 7)],
                         ids=["every_sm", "gpc_bound"])
def test_k10g_launch_plan_splits_k_in_order_only_where_tiles_leave_the_card_idle(m, k, n, noisy,
                                                                                 clusters):
    from rainbow_iqn_apex_tpu_torch.kernels import noisy_linear_q as q

    splits = q.forward_plan(m, n, k, noisy, clusters)
    if n <= noisy_linear_module.NARROW_N:
        assert splits == 0  # K3's mma.sync path, bytes converted in registers
        return
    tiles = q._cdiv(m, q.TILE_T[noisy]) * q._cdiv(n, q.TILE_W)
    k_steps = q._cdiv(k, q.TILE_K)
    assert 1 <= splits <= min(q.MAX_SPLITS, k_steps)  # a portable cluster, no empty rank
    if tiles >= noisy_linear_module.FULL_WAVE:
        assert splits == 1
    elif splits > 1:  # every cluster on the card at once, one wave
        assert tiles * splits <= noisy_linear_module.SMS and tiles <= clusters[splits - 1]
    ranks = [range(r * k_steps // splits, (r + 1) * k_steps // splits) for r in range(splits)]
    assert [t for r in ranks for t in r] == list(range(k_steps))  # each k step once, in order


def test_k10g_plan_at_the_serving_and_act_tick_shapes():
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q import forward_plan

    every_sm = tuple(132 // s for s in range(1, 9))
    # (M, N, K, noisy): serving's buckets 64, 32 and 8, greedy (128-token tiles)
    assert [forward_plan(m, 512, 3136, False, every_sm) for m in (2048, 1024, 256)] == [2, 4, 8]
    # the act tick, noisy (64-token tiles), and the *_out layers
    assert forward_plan(512, 512, 3136, True, every_sm) == 4
    assert forward_plan(2048, 18, 512, False, every_sm) == 0
    assert forward_plan(512, 1, 512, True, every_sm) == 0
    # where 32 clusters of four do not fit at once, the act tick splits in three
    assert forward_plan(512, 512, 3136, True, (132, 66, 40, 30, 24, 20, 16, 14)) == 3

def test_k3_bwd_plan_splits_the_narrow_layers_and_not_the_hidden_ones():
    nl = noisy_linear_module
    hidden = nl.backward_plan(2048, 512, 3136, True)  # (M, N, K)
    assert (hidden.bn_w, hidden.splits) == (64, 1)  # 200 tiles: no partials
    assert hidden.ws_f32 == 64 * 512
    for n, bn in ((1, 8), (18, 24)):
        out = nl.backward_plan(2048, n, 512, True)
        assert (out.bn_w, out.splits) == (bn, 32)
    head = nl.backward_plan(3840, 512, 512, True)
    assert head.splits * 32 >= nl.FULL_WAVE and head.splits > 1


# ----------------------------------------------- CPU: K2 / K2-bwd launch plans
# (B, N, F, C): the learner (B 32, N = N' 64, K 32 at s'), serving bucket 64 x
# K 32, the act tick (16 lanes x 32 taus), jaxgame frames (F 2304), the reuse
# scenario (N 4, 8; F 256), and the lifted shapes
K2_PLAN_SHAPES = [(32, 64, 3136, 64), (32, 32, 3136, 64), (64, 32, 3136, 64),
                  (16, 32, 3136, 64), (32, 64, 2304, 64), (16, 32, 2304, 64), (16, 4, 256, 8),
                  (32, 8, 256, 8), *K2_LIFTED, (3, 7, 200, 32), (128, 64, 3136, 128)]


@pytest.mark.parametrize("batch,n,feat,cos", K2_PLAN_SHAPES)
def test_k2_plans_cover_every_row_and_feature(batch, n, feat, cos):
    te = tau_embed_module
    rows, cd = batch * n, te._cdiv
    tiles = cd(feat, 64)
    for limit in (None, lambda size: 8 * (48 // size)):  # a card of 8 groups of 16 SMs
        splits, cluster = te.forward_plan(rows, feat, cos, False, limit)
        assert 1 <= splits <= tiles and 1 <= cluster <= 8 and splits % cluster == 0
        runs = [range(tiles * s // splits, tiles * (s + 1) // splits) for s in range(splits)]
        assert all(len(r) > 0 for r in runs)  # as csrc/tau_embed.cu cuts them: no idle block
        assert [t for r in runs for t in r] == list(range(tiles))  # each feature tile once
        assert cluster == max(d for d in range(1, 9) if splits % d == 0)

    def room(size):  # a card of 8 groups of 16 SMs, three blocks an SM
        return 8 * (48 // size)

    for limit in (None, room):
        per_block, clusters = te.backward_plan(rows, n, tiles, limit)
        assert 1 <= clusters <= 8 and per_block % 64 == 0 and per_block % n == 0
        assert (clusters - 1) * per_block < rows <= clusters * per_block  # no empty block
        if limit is not None:  # one wave where any split gives one
            assert tiles <= room(clusters) or clusters == 1
    assert te.cos_shape(rows, cos) == (cd(cos, 16) * 16, cd(rows, 64) * 64)


def test_k2_autograd_saves_no_cos_features_on_the_cpu():
    """The CPU path recomputes the cos features in the plain backward:
    ``save_cos`` gives None beside h, and ``TauEmbedFn``'s gradients are
    the plain twin's."""
    taus, w, b, phi = _k2_inputs(3, 5, 200, 24)
    args = (_t(taus), _t(w.T), _t(b), _t(phi))
    h, cos_t = tau_embed(*args, save_cos=True)
    assert cos_t is None and torch.equal(h, tau_embed_plain(*args))
    leaves = [a.clone().requires_grad_(True) for a in args[1:]]
    out = TauEmbedFn.apply(args[0], *leaves)
    dh = _t(_rng(23).standard_normal(out.shape))
    out.backward(dh)
    dphi, dw, db = tau_embed_bwd_plain(*args, dh)
    for leaf, want in zip(leaves, (dw, db, dphi)):
        assert torch.equal(leaf.grad, want)


# --------------------------------------------------- CPU: K9 / K9-bwd launch plans
# (B, T, H): the R2D2 learner's burn-in, train slice and whole sequence, the
# act tick, the catch scenario (LSTM 64, B 16, burn-in 2, 8 trained steps, 8
# lanes), the card tests' boundaries, one row, and wide batches of lanes
K9_PLAN_SHAPES = [(32, 40, 512), (32, 80, 512), (32, 120, 512), (16, 1, 512), (16, 2, 64),
                  (16, 8, 64), (8, 1, 64), *[(b, t, h) for b in (8, 9, 31, 32, 33)
                                             for t in (1, 2, 40) for h in (40, 512)],
                  (1, 5, 512), (256, 1, 512), (256, 80, 512), (64, 80, 480)]


@pytest.mark.parametrize("clusters", [8, 7, 1])
@pytest.mark.parametrize("batch,steps,hidden", K9_PLAN_SHAPES)
def test_k9_plans_cover_every_row_and_unit(batch, steps, hidden, clusters):
    """As csrc/lstm.cu cuts the launch: groups of R rows cover the batch
    with none empty, a group's blocks cover the hidden units, a block fits
    shared memory; T > 1 is clusters of at most 16 blocks and 8 rows, in one
    wave of the card's ``clusters`` wherever the batch allows it."""
    from rainbow_iqn_apex_tpu_torch.kernels import lstm

    cd = lstm._cdiv
    for plan in (lstm.forward_plan(batch, steps, hidden, clusters),
                 lstm.backward_plan(batch, steps, hidden, clusters)):
        assert (plan.groups - 1) * plan.rows < batch <= plan.groups * plan.rows
        assert (plan.unit_blocks - 1) * plan.units < hidden <= plan.unit_blocks * plan.units
        assert 0 < plan.shared <= lstm.SHARED_LIMIT
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        if plan.cluster:
            assert plan.unit_blocks <= lstm.MAX_BLOCKS and plan.rows <= lstm.MAX_ROWS
            assert plan.units == lstm.UNITS and plan.threads == lstm.THREADS
            if batch <= lstm.MAX_ROWS * clusters:
                assert plan.groups <= clusters  # every group runs at once
    assert lstm.forward_plan(batch, steps, hidden, clusters).cluster == (steps > 1)
    assert lstm.backward_plan(batch, steps, hidden, clusters).cluster
    assert lstm.forward_plan(batch, 1, hidden, clusters).units == lstm.TICK_UNITS


def test_k9_plan_gives_the_learner_batch_eight_clusters_of_sixteen_blocks():
    """At B 32, LSTM 512: 16 blocks of 32 units a cluster, 4 rows a cluster
    on a card that runs 8 such clusters at once (5 rows on one that runs
    7); the act tick runs 128 blocks of 4 units over the 16 lanes, no
    cluster."""
    from rainbow_iqn_apex_tpu_torch.kernels import lstm

    for plan in (lstm.forward_plan(32, 120, 512, 8), lstm.forward_plan(32, 40, 512, 8),
                 lstm.backward_plan(32, 80, 512, 8)):
        assert (plan.units, plan.unit_blocks, plan.groups, plan.rows) == (32, 16, 8, 4)
    assert (lstm.forward_plan(32, 80, 512, 7).groups, lstm.forward_plan(32, 80, 512, 7).rows) == (7, 5)
    tick = lstm.forward_plan(16, 1, 512, 0)
    assert (tick.units, tick.unit_blocks, tick.groups, tick.rows, tick.cluster) == (
        4, 128, 1, 16, False)
    many = lstm.forward_plan(256, 1, 512, 0)  # h of 256 lanes overflows one block: more groups
    assert many.groups > 1 and many.shared <= lstm.SHARED_LIMIT
    assert lstm.forward_plan(33, 80, 512, 8).rows == 5  # 7 groups: 5 rows each, 3 in the last
    assert lstm.forward_plan(256, 80, 512, 8).groups == 32  # 8 rows a cluster, four waves


def test_k9_plan_refuses_what_the_kernels_do_not_take():
    from rainbow_iqn_apex_tpu_torch.kernels import lstm

    with pytest.raises(ValueError):
        lstm.forward_plan(32, 80, 513, 8)  # wider than a cluster of 16 blocks
    with pytest.raises(ValueError):
        lstm.backward_plan(32, 1, 1024, 8)
    with pytest.raises(ValueError):
        lstm.forward_plan(0, 80, 512, 8)
    with pytest.raises(RuntimeError):
        lstm.forward_plan(32, 80, 512, 0)  # the card runs no such cluster


# ------------------------------------------- on the card: kernel vs plain twin
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,feat,cos", [(64, 32, 3136, 64), (5, 8, 256, 16),
                                              (3, 7, 200, 32), *K2_LIFTED,
                                              (5, 64, 3136, 64), (1, 32, 2304, 64)])
def test_k2_kernel_matches_plain(cuda, batch, n, feat, cos):
    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    args = (_t(taus).to(cuda), _t(w.T, torch.bfloat16).to(cuda), _t(b).to(cuda),
            _t(phi, torch.bfloat16).to(cuda))
    before = launches["K2_tau_embed"]
    got = tau_embed(*args)
    torch.cuda.synchronize()
    assert launches["K2_tau_embed"] == before + 1
    torch.testing.assert_close(got.float(), tau_embed_plain(*args).float(), **BF16)


# K3 / K3-bwd shapes on the card: the main paths' (hidden, value_out,
# advantage_out at M 2048), ragged edges, K off the k-tile (200, 2304), N on
# either side of the narrow path's limit (24, 40, 64), M below one tile (16)
# and the R2D2 head (512 -> 512 over B x T rows)
K3_SHAPES = [(2048, 3136, 512), (2048, 512, 18), (2048, 512, 1), (40, 256, 20), (33, 40, 70),
             (64, 200, 512), (512, 2304, 512), (256, 512, 24), (256, 512, 40), (256, 512, 64),
             (16, 512, 512), (3840, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", K3_SHAPES)
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("relu", [False, True])
def test_k3_kernel_matches_plain(cuda, m, k, n, use_noise, relu):
    x, p, e_in, e_out = _k3_inputs(m, k, n)
    bf = torch.bfloat16
    args = [_t(x, bf).to(cuda), _t(p["w_mu"].T, bf).to(cuda), _t(p["b_mu"]).to(cuda)]
    if use_noise:
        args += [_t(p["w_sigma"].T, bf).to(cuda), _t(p["b_sigma"]).to(cuda),
                 _f(_t(e_in)).to(cuda), _f(_t(e_out)).to(cuda)]
    before = launches["K3_noisy_linear"]
    got = noisy_linear(*args, relu=relu)
    torch.cuda.synchronize()
    assert launches["K3_noisy_linear"] == before + 1
    torch.testing.assert_close(got, noisy_linear_plain(*args, relu=relu), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dueling", [True, False])
def test_k4_kernel_matches_plain(cuda, dueling):
    v = _t(_rng(6).standard_normal((64 * 32, 1))).to(cuda) if dueling else None
    a = _t(_rng(7).standard_normal((64 * 32, 18))).to(cuda)
    before = launches["K4_dueling_head"]
    quantiles, q, action = dueling_head(v, a, 32)
    torch.cuda.synchronize()
    assert launches["K4_dueling_head"] == before + 1
    p_quantiles, p_q, p_action = dueling_head_plain(v, a, 32)
    torch.testing.assert_close(quantiles, p_quantiles, **FP32)
    torch.testing.assert_close(q, p_q, **FP32)
    top2 = torch.sort(p_q, dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    assert torch.equal(action[clear], p_action[clear])


@pytest.mark.cuda
def test_k4_kernel_first_index_wins_a_forced_tie(cuda):
    a = torch.zeros((3 * 4, 5), device=cuda)
    a[:, 2] = a[:, 4] = 1.0
    _, _, action = dueling_head(torch.full((3 * 4, 1), 0.5, device=cuda), a, 4)
    assert action.tolist() == [2, 2, 2]


@pytest.mark.cuda
def test_kernels_refuse_fp32_operands_on_the_card(cuda):
    x = torch.zeros((8, 16), device=cuda)
    w = torch.zeros((4, 16), device=cuda)
    with pytest.raises(TypeError):
        noisy_linear(x, w, torch.zeros(4, device=cuda))


# -------------------------------- the learner's kernels on the card vs twins
def _counted(name, fn):
    before = launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_t", [(32, 64, 64), (3, 8, 5), (4, 100, 33)])
@pytest.mark.parametrize("kappa", [0.5, 1.0])
def test_k1_kernel_matches_plain(cuda, b, n, n_t, kappa):
    r = _rng(20)
    online, target = _t(r.standard_normal((b, n))).to(cuda), _t(r.standard_normal((b, n_t))).to(cuda)
    target[0, :1] = online[0, :1]  # u == 0
    target[-1, :1] = online[-1, :1] + kappa  # |u| == kappa: the quadratic branch
    args = (online, _t(r.random((b, n))).to(cuda), target, kappa)
    got = _counted("K1_quantile_huber", lambda: quantile_huber(*args))
    for g, w in zip(got, quantile_huber_plain(*args)):
        torch.testing.assert_close(g, w, **FP32)


# K1's weighted mode: (B, N, N') at the learner's shapes and off them
K1_SHAPES = [(64, 64), (8, 32), (64, 200)]


@pytest.mark.parametrize("batch,want", [
    (32, 2), (1, 1), (7, 1), (64, 4), (256, 16), (33, 3), (17, 2), (16, 1), (5, 1), (255, 16)])
def test_k1_plan_covers_the_batch_with_no_empty_block(batch, want):
    samples = loss_plan(batch, 64, 64)
    assert samples == want
    blocks = -(-batch // samples)  # one cluster: at most 16 blocks
    assert blocks <= 16 and blocks * samples >= batch and (blocks - 1) * samples < batch


def test_k1_plan_refuses_what_the_kernel_does_not_take():
    assert loss_plan(256, 64, 200) == 16  # 16 x (200 + 4 x 64) + 256 floats: 30 KB
    with pytest.raises(ValueError):
        loss_plan(4096, 64, 200)  # 256 samples a block: 472 KB
    for bad in ((0, 64, 64), (32, 0, 64), (32, 64, 0), (-1, 64, 64)):
        with pytest.raises(ValueError):
            loss_plan(*bad)


def _k1_weighted_args(cuda, b, n, n_t, kappa, scaled, seed=24):
    r = _rng(seed)
    online = _t(r.standard_normal((b, n))).to(cuda)
    target = _t(r.standard_normal((b, n_t))).to(cuda)
    target[0, :2] = online[0, :2]  # u == 0
    target[-1, :2] = online[-1, :2] + kappa  # |u| == kappa: the quadratic branch
    target[-1, 2:4] = online[-1, 2:4] - kappa
    weight = _t(r.uniform(0.1, 1.0, b)).to(cuda)
    scale = _t(r.uniform(0.5, 2.0, b)).to(cuda) if scaled else None
    return online, _t(r.random((b, n))).to(cuda), target, weight, scale, kappa


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 32, 64, 256])
@pytest.mark.parametrize("n,n_t", K1_SHAPES)
@pytest.mark.parametrize("scaled", [False, True])
def test_k1_weighted_kernel_matches_plain_and_repeats_bit_equal(cuda, b, n, n_t, scaled):
    args = _k1_weighted_args(cuda, b, n, n_t, 1.0, scaled)
    got = _counted("K1_quantile_huber", lambda: quantile_huber_weighted(*args))
    for g, w in zip(got, quantile_huber_weighted_plain(*args)):
        torch.testing.assert_close(g, w, **FP32)
    again = quantile_huber_weighted(*args)
    torch.cuda.synchronize()
    for g, a in zip(got, again):  # the mean's order is fixed: equal bits
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 32])
@pytest.mark.parametrize("kappa", [0.5, 1.0])
def test_k1_weighted_mode_survives_graph_replay(cuda, batch, kappa):
    """The weighted mode against the twin, eagerly and over two replays of a
    CUDA graph that captured three launches, the inputs rewritten between
    the replays."""
    args = list(_k1_weighted_args(cuda, batch, 64, 64, kappa, True, seed=25))
    want = quantile_huber_weighted_plain(*args)
    for g, w in zip(quantile_huber_weighted(*args), want):
        torch.testing.assert_close(g, w, **FP32)
    quantile_huber_weighted(*args)  # warm, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [quantile_huber_weighted(*args) for _ in range(3)]
    r = _rng(26)
    for _ in range(2):
        args[0].copy_(_t(r.standard_normal((batch, 64))).to(cuda))
        args[3].copy_(_t(r.uniform(0.1, 1.0, batch)).to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        want = quantile_huber_weighted_plain(*args)
        for out in outs:
            for g, w in zip(out, want):
                torch.testing.assert_close(g, w, **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("actions", [3, 5, 18])
@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("scaled", [False, True])
def test_k4_bwd_loss_mode_matches_the_twin_chain(cuda, actions, dueling, scaled):
    r = _rng(27)
    batch, n = 32, 64
    grad = _t(r.standard_normal((batch, n))).to(cuda)
    take = torch.from_numpy(r.integers(0, actions, batch).astype(np.int32)).to(cuda)
    weight = _t(r.uniform(0.1, 1.0, batch)).to(cuda)
    scale = _t(r.uniform(0.5, 2.0, batch)).to(cuda) if scaled else None
    d_loss = torch.tensor(2.5, device=cuda)
    args = (d_loss, weight, scale, grad, take, actions, dueling)
    got = _counted("K4_dueling_head_bwd", lambda: dueling_loss_bwd(*args))
    for g, w in zip(got, dueling_loss_bwd_plain(*args)):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,taus,actions", [(80, 32, 18), (3, 5, 3), (7, 1, 5)])
def test_k4_bwd_dz_mode_matches_plain_at_ragged_sizes(cuda, batch, taus, actions):
    """R2D2's shape (one tau a row over B x T rows) and sizes whose element
    count is not a multiple of four (the vector stores' ragged tail); 1e-6,
    as K4-bwd's other tests (torch's CUDA twin divides by A as a product
    with 1 / A)."""
    r = _rng(28)
    dz = _t(r.standard_normal((batch, taus))).to(cuda)
    take = torch.from_numpy(r.integers(0, actions, batch).astype(np.int32)).to(cuda)
    for dueling in (True, False):
        got = _counted("K4_dueling_head_bwd",
                       lambda: dueling_gather_bwd(dz, take, actions, dueling))
        for g, w in zip(got, dueling_gather_bwd_plain(dz, take, actions, dueling)):
            if w is None:
                assert g is None
            else:
                torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("scaled", [False, True])
def test_learn_loss_gradients_match_the_parent_route(cuda, dueling, scaled):
    """LearnLossFn (heads launch, K1 weighted, K4-bwd loss mode) against the
    route it replaced: the heads launch for td_target, K4's gather with
    K4-bwd's dz mode for z_online, K1 per-sample, the product and torch.mean
    through autograd; loss scaled by 2.5 before the backward."""
    select, target, online, take, reward, discount, game, mask = _k4_heads(cuda, dueling, False)
    r = _rng(31)
    taus = _t(r.random((32, online[2]))).to(cuda)
    weight = _t(r.uniform(0.1, 1.0, 32)).to(cuda)
    scale = _t(r.uniform(0.5, 2.0, 32)).to(cuda) if scaled else None
    leaves = [t.clone().requires_grad_(True) for t in online[:2] if t is not None]
    on = (leaves[0] if dueling else None, leaves[-1], online[2])
    before = {k: launches[k] for k in ("K1_quantile_huber", "K4_dueling_head_bwd")}
    loss, per_sample, td_abs, _, _ = learn_loss(on, take, select, target, reward, discount,
                                                taus, weight, scale, 1.0)
    got = torch.autograd.grad(2.5 * loss, leaves)
    torch.cuda.synchronize()
    assert {k: launches[k] - v for k, v in before.items()} == {
        "K1_quantile_huber": 1, "K4_dueling_head_bwd": 1}
    td_target = dueling_learn(select, target, online, take, reward, discount)[4]
    z_online, _ = DuelingGatherFn.apply(on[0], on[1], take, on[2])
    ps, td = QuantileHuberFn.apply(z_online, taus, td_target, 1.0)
    w = weight if scale is None else weight * scale
    parent = torch.mean(w * ps)
    want = torch.autograd.grad(2.5 * parent, leaves)
    torch.testing.assert_close(loss, parent, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(per_sample, ps.detach(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(td_abs, td, atol=1e-6, rtol=1e-6)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,feat,cos", [(64, 32, 3136, 64), (5, 8, 256, 16),
                                              (3, 7, 200, 32), *K2_LIFTED,
                                              (5, 64, 3136, 64), (1, 32, 2304, 64)])
def test_k2_saves_the_cos_features_k2_bwd_reads(cuda, batch, n, feat, cos):
    """cos_t is bf16(cos(pi i tau)) transposed to [Cp, Mp], zeros in the pads,
    and h is the same with and without it."""
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import _cos_features

    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    bf = torch.bfloat16
    args = (_t(taus).to(cuda), _t(w.T, bf).to(cuda), _t(b).to(cuda), _t(phi, bf).to(cuda))
    h, cos_t = tau_embed(*args, save_cos=True)
    rows = batch * n
    want = torch.zeros(tau_embed_module.cos_shape(rows, cos), dtype=bf, device=cuda)
    want[:cos, :rows] = _cos_features(args[0], cos, bf).reshape(rows, cos).t()
    assert torch.equal(cos_t, want)
    assert torch.equal(h, tau_embed(*args))


def _k2b_args(cuda, batch, n, feat, cos):
    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    bf = torch.bfloat16
    dh = _t(_rng(21).standard_normal((batch * n, feat)), bf).to(cuda)
    args = (_t(taus).to(cuda), _t(w.T, bf).to(cuda), _t(b).to(cuda), _t(phi, bf).to(cuda), dh)
    return args, tau_embed(*args[:4], save_cos=True)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,feat,cos", [(32, 64, 3136, 64), (5, 8, 256, 16),
                                              (3, 7, 200, 32), *K2_LIFTED,
                                              (5, 64, 3136, 64), (32, 8, 256, 8)])
def test_k2_bwd_kernel_matches_plain(cuda, batch, n, feat, cos):
    args, cos_t = _k2b_args(cuda, batch, n, feat, cos)
    got = _counted("K2_tau_embed_bwd", lambda: tau_embed_bwd(*args, cos_t=cos_t))
    for g, w_ in zip(got, tau_embed_bwd_plain(*args)):
        torch.testing.assert_close(g.float(), w_.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,feat,cos", [(32, 64, 3136, 64), (1, 200, 200, 72)])
@pytest.mark.parametrize("games", [0, 4])
def test_k2_bwd_repeats_bit_equal(cuda, batch, n, feat, cos, games):
    """No atomics: the cluster sums its partials in rank order, so two calls
    (K2-bwd, and K2g-bwd with dE) give the same bits."""
    args, cos_t = _k2b_args(cuda, batch, n, feat, cos)
    extra = {}
    if games:
        extra = dict(game=torch.arange(batch, device=cuda, dtype=torch.int32) % games,
                     emb=_t(_rng(42).normal(0, 0.5, (games, feat))).to(cuda))
    first = tau_embed_bwd(*args, cos_t=cos_t, **extra)
    for _ in range(3):
        for a, b in zip(first, tau_embed_bwd(*args, cos_t=cos_t, **extra)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k2_bwd_refuses_a_call_without_the_saved_cos_features(cuda):
    args, cos_t = _k2b_args(cuda, 2, 8, 64, 16)
    with pytest.raises(ValueError, match="cos_t"):
        tau_embed_bwd(*args)
    with pytest.raises(ValueError, match="cos_t"):
        tau_embed_bwd(*args, cos_t=cos_t[:, :64].contiguous()[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("games", [0, 3])
def test_k2_autograd_runs_k2_then_k2_bwd_on_the_card(cuda, games):
    """TauEmbedFn: one K2 launch that saves the cos features, one K2-bwd
    launch that reads them, and the kernels' own gradients."""
    args, _ = _k2b_args(cuda, 4, 16, 200, 24)
    taus, w, b, phi, dh = args
    extra = ()
    if games:
        extra = (torch.arange(4, device=cuda, dtype=torch.int32) % games,
                 _t(_rng(43).normal(0, 0.5, (games, 200))).to(cuda))
    fwd, bwd = (("K2_tau_embed", "K2_tau_embed_bwd") if not games
                else ("K2g_tau_embed_game", "K2g_tau_embed_game_bwd"))
    leaves = [t.clone().requires_grad_(True) for t in (w, b, phi)]
    emb = extra[1].clone().requires_grad_(True) if games else None
    before = dict(launches)
    out = TauEmbedFn.apply(taus, *leaves, *((extra[0], emb) if games else ()))
    out.backward(dh)
    torch.cuda.synchronize()
    assert launches[fwd] == before[fwd] + 1 and launches[bwd] == before[bwd] + 1
    h, cos_t = tau_embed(taus, w, b, phi, *extra, save_cos=True)
    want = tau_embed_bwd(taus, w, b, phi, dh, *extra, cos_t=cos_t)
    assert torch.equal(out.detach(), h)
    for leaf, g in zip(leaves + ([emb] if games else []), (want[1], want[2], want[0], *want[3:])):
        assert torch.equal(leaf.grad, g)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", K3_SHAPES)
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("relu", [False, True])
def test_k3_bwd_kernel_matches_plain(cuda, m, k, n, use_noise, relu):
    x, p, e_in, e_out = _k3_inputs(m, k, n)
    bf = torch.bfloat16
    xc, w_mu = _t(x, bf).to(cuda), _t(p["w_mu"].T, bf).to(cuda)
    g = _t(_rng(22).standard_normal((m, n))).to(cuda)
    y = noisy_linear_plain(xc, w_mu, _t(p["b_mu"]).to(cuda), relu=True) if relu else None
    args = [g, y, xc, w_mu]
    if use_noise:
        args += [_t(p["w_sigma"].T, bf).to(cuda), _f(_t(e_in)).to(cuda), _f(_t(e_out)).to(cuda)]
    got = _counted("K3_noisy_linear_bwd", lambda: noisy_linear_bwd(*args))
    for g_, w_ in zip(got, noisy_linear_bwd_plain(*args)):
        if w_ is None:
            assert g_ is None
        else:
            torch.testing.assert_close(g_.float(), w_.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 3136, 512), (2048, 512, 18), (3840, 512, 512),
                                   (33, 40, 70)])
def test_k3_bwd_kernel_is_bit_equal_on_a_repeat(cuda, m, k, n):
    """No atomics: dW's split over M is summed in chunk order, db in tile order."""
    x, p, e_in, e_out = _k3_inputs(m, k, n)
    bf = torch.bfloat16
    xc, w_mu = _t(x, bf).to(cuda), _t(p["w_mu"].T, bf).to(cuda)
    g = _t(_rng(23).standard_normal((m, n))).to(cuda)
    y = noisy_linear_plain(xc, w_mu, _t(p["b_mu"]).to(cuda), relu=True)
    args = [g, y, xc, w_mu, _t(p["w_sigma"].T, bf).to(cuda), _f(_t(e_in)).to(cuda),
            _f(_t(e_out)).to(cuda)]
    first = _counted("K3_noisy_linear_bwd", lambda: noisy_linear_bwd(*args))
    second = _counted("K3_noisy_linear_bwd", lambda: noisy_linear_bwd(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 3136, 512), (2048, 512, 18), (2048, 512, 1),
                                   (3840, 512, 512), (33, 40, 70)])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
def test_k3_bwd_stays_inside_the_planned_workspace(cuda, m, k, n, use_noise):
    """The C entry's own offsets (dy planes, their transpose, db's tile sums,
    dW's partials) against ``backward_plan``'s sizes: each of the two regions
    is followed by a canary that the kernel must leave as it was, and the
    results equal the wrapper's."""
    import ctypes

    from rainbow_iqn_apex_tpu_torch.kernels import build

    nl = noisy_linear_module
    x, p, e_in, e_out = _k3_inputs(m, k, n)
    bf = torch.bfloat16
    xc, w_mu = _t(x, bf).to(cuda), _t(p["w_mu"].T, bf).to(cuda)
    g = _t(_rng(24).standard_normal((m, n))).to(cuda)
    y = noisy_linear_plain(xc, w_mu, _t(p["b_mu"]).to(cuda), relu=True)
    w_sg, f_in, f_out = ((_t(p["w_sigma"].T, bf).to(cuda), _f(_t(e_in)).to(cuda),
                          _f(_t(e_out)).to(cuda)) if use_noise else (None, None, None))
    plan = nl.backward_plan(m, n, k, use_noise)
    canary = 4096
    f32_at = nl._cdiv(2 * plan.ws_bf16 + canary, 256) * 256
    end = f32_at + 4 * plan.ws_f32
    workspace = torch.full((end + canary,), 0xA5, dtype=torch.uint8, device=cuda)
    dxc = torch.empty((m, k), dtype=bf, device=cuda)
    dw_mu = torch.empty((n, k), dtype=bf, device=cuda)
    db_mu = torch.empty((n,), dtype=torch.float32, device=cuda)
    dw_sg = torch.empty((n, k), dtype=bf, device=cuda) if use_noise else None
    db_sg = torch.empty((n,), dtype=torch.float32, device=cuda) if use_noise else None
    code = nl._bwd_entry()(
        build.ptr(g), build.ptr(y), build.ptr(xc), build.ptr(w_mu), build.ptr(w_sg),
        build.ptr(f_in), build.ptr(f_out), build.ptr(dxc), build.ptr(dw_mu), build.ptr(dw_sg),
        build.ptr(db_mu), build.ptr(db_sg), build.ptr(workspace),
        ctypes.c_void_p(workspace.data_ptr() + f32_at), m, n, k, plan.bn_w, plan.splits,
        build.stream_of(cuda))
    assert code == 0
    torch.cuda.synchronize()
    assert bool((workspace[2 * plan.ws_bf16:f32_at] == 0xA5).all())
    assert bool((workspace[end:] == 0xA5).all())
    want = noisy_linear_bwd(g, y, xc, w_mu, w_sg, f_in, f_out)
    for a, b in zip((dxc, dw_mu, db_mu, dw_sg, db_sg), want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dueling", [True, False])
def test_k4_gather_and_bwd_kernels_match_plain(cuda, dueling):
    r = _rng(23)
    v = _t(r.standard_normal((32 * 64, 1))).to(cuda) if dueling else None
    a = _t(r.standard_normal((32 * 64, 18))).to(cuda)
    take = torch.from_numpy(r.integers(0, 18, 32).astype(np.int32)).to(cuda)
    got = _counted("K4_dueling_head", lambda: dueling_gather(v, a, 64, take))
    for g, w in zip(got, dueling_gather_plain(v, a, 64, take)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    dz = _t(r.standard_normal((32, 64))).to(cuda)
    got = _counted("K4_dueling_head_bwd", lambda: dueling_gather_bwd(dz, take, 18, dueling))
    for g, w in zip(got, dueling_gather_bwd_plain(dz, take, 18, dueling)):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def _k4_heads(device, dueling, masked, batch=32, k=32, n_prime=64, n=64, actions=18):
    """The learn step's three heads at the learn shapes, with planted cases:
    row 0 ties actions 3 and A - 1 in the select head, row 1 holds a NaN at
    action 2 of its select head, row 2 takes action A - 1 (row 2's game
    masks it in the masked case: the gathers do not mask)."""
    r = _rng(29)

    def head(taus):
        v = _t(r.standard_normal((batch * taus, 1))).to(device) if dueling else None
        return v, _t(r.standard_normal((batch * taus, actions))).to(device), taus

    select, target, online = head(k), head(n_prime), head(n)
    sel_adv = select[1].view(batch, k, actions)
    sel_adv[0, :, 3] = sel_adv[0, :, actions - 1] = 9.0
    sel_adv[1, k // 2, 2] = float("nan")
    take = torch.from_numpy(r.integers(0, actions, batch).astype(np.int32)).to(device)
    take[2] = actions - 1
    reward = _t(r.standard_normal(batch)).to(device)
    discount = _t(r.choice([0.0, 0.9, 0.99 ** 3], batch).astype(np.float32)).to(device)
    game = mask = None
    if masked:
        game = torch.from_numpy((np.arange(batch) % 3).astype(np.int32)).to(device)
        mask = torch.ones((3, actions), dtype=torch.bool, device=device)
        mask[1, actions // 3:] = False
        mask[2, actions // 2:] = False
    return select, target, online, take, reward, discount, game, mask


def test_k4_row_plan_fits_shared_memory():
    assert row_plan(32, 18) == 4 and row_plan(64, 18) == 4 and row_plan(1, 18) == 4
    assert row_plan(200, 18) == 3 and row_plan(600, 18) == 1  # 14.5 KB and 43 KB a row
    with pytest.raises(ValueError):
        row_plan(700, 18)
    assert learn_smem(32, 64, 64, 18) == (576 + 1152 + 1152 + 2 * 20) * 4
    with pytest.raises(ValueError):
        learn_smem(200, 200, 300, 18)


@pytest.mark.parametrize("masked", [False, True])
def test_k4_heads_wrapper_runs_its_twin_on_cpu_without_counting(masked):
    before = dict(launches)
    args = _k4_heads(torch.device("cpu"), True, masked, batch=6, k=4, n_prime=8, n=8, actions=5)
    got = dueling_learn(*args[:3], *args[3:6], *args[6:])
    want = dueling_learn_plain(*args[:3], *args[3:6], *args[6:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][0].item() == 3 and got[2][1].item() == 0  # the tie, then NaN's row (all NaN)
    assert dict(launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_k4_heads_mode_matches_plain(cuda, dueling, masked):
    """One launch of K4's heads mode against its twin at the learn shapes:
    a* equal (the planted tie to the first index, NaN as maximal, inside
    each row's game when masked), z_next, td_target, z_online and on_q
    within 1e-5; an out-of-range action gathers NaN in z_online's row."""
    select, target, online, take, reward, discount, game, mask = _k4_heads(cuda, dueling, masked)
    name = "K4m_dueling_head_mask" if masked else "K4_dueling_head"
    got = _counted(name, lambda: dueling_learn(select, target, online, take, reward, discount,
                                               game, mask))
    want = dueling_learn_plain(select, target, online, take, reward, discount, game, mask)
    _, q_sel, _ = dueling_head_plain(*select, game, mask)
    top2 = torch.sort(q_sel.nan_to_num(nan=1e30), dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    clear[0] = True  # the exact tie
    assert torch.equal(got[2][clear], want[2][clear])
    assert got[2][0].item() == 3
    assert got[2][1].item() == (0 if dueling else 2)  # dueling: the NaN spreads over the tau row
    if masked:
        assert bool(mask[game.long(), got[2].long()].all())
    for g, w in zip((got[0], got[1]), (want[0], want[1])):
        torch.testing.assert_close(g, w, **FP32)
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g[clear], w[clear], **FP32)
    bad = take.clone()
    bad[5] = 18
    z_bad = dueling_learn(select, target, online, bad, reward, discount, game, mask)[0]
    assert bool(z_bad[5].isnan().all()) and torch.equal(z_bad[:5], got[0][:5])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_k4l_twice_on_one_input_is_bit_equal(cuda, masked):
    """K4l at bucket 64's shape: two calls give the same bits (a zero-drift
    reuse pass's ratio is exactly 1)."""
    r = _rng(31)
    value = _t(r.standard_normal((64 * 32, 1))).to(cuda)
    adv = _t(r.standard_normal((64 * 32, 18))).to(cuda)
    take = torch.from_numpy(r.integers(0, 18, 64).astype(np.int32)).to(cuda)
    margs = ()
    if masked:
        margs = (torch.from_numpy((np.arange(64) % 4).astype(np.int32)).to(cuda),
                 torch.from_numpy(np.arange(18)[None, :] < np.array([[18], [3], [5], [9]])).to(cuda))
        take = take % 3
    first = _counted("K4l_dueling_head_logp", lambda: dueling_logp(value, adv, 32, take, *margs))
    second = dueling_logp(value, adv, 32, take, *margs)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    want = dueling_logp_plain(value, adv, 32, take, *margs)
    torch.testing.assert_close(first[0], want[0], **FP32)


# ------------------------------------- the quantized act path (K10) on the card
def _quant_tree(seed=30):
    """Full-width shapes of every kind K10q meets (a hidden layer, an *_out
    layer of one row, a conv kernel, the embedding, biases), with a zero
    row, half-way ties and e4m3's overflow edges planted."""
    r = _rng(seed)
    tree = {"hidden": r.standard_normal((512, 3136)), "out": r.standard_normal((1, 512)),
            "conv": r.standard_normal((32, 4, 8, 8)), "embed": r.standard_normal((3136, 64)),
            "bias": r.standard_normal(512), "edges": r.standard_normal((3, 32))}
    tree = {k: _t(v) for k, v in tree.items()}
    tree["hidden"][7] = 0.0
    tree["edges"][0, :8] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5])
    tree["edges"][1, :10] = torch.tensor([448.0, 455.0, 463.99, 464.0, 464.01, 500.0, 1e4,
                                          -1e4, -464.0, float("nan")])
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_k10q_kernel_equals_plain(cuda, mode):
    """One launch over every tensor; q and s bit-equal to the twin on the
    CPU (which tests/test_torch_quantize.py holds bit-equal to JAX)."""
    from rainbow_iqn_apex_tpu_torch.utils.quantize import QuantizedParams, quantize_params

    tree = _quant_tree()
    if mode == "int8":
        tree["edges"] = torch.nan_to_num(tree["edges"], nan=0.0)
    want = quantize_params(tree, mode)
    out = QuantizedParams.like(tree, mode, device=cuda)
    _counted("K10q_quantize", lambda: quantize_params({k: v.to(cuda) for k, v in tree.items()},
                                                      mode, out=out))
    assert torch.equal(out.q_flat.cpu(), want.q_flat)
    assert torch.equal(out.s_flat.cpu().view(torch.int32), want.s_flat.view(torch.int32))
    if mode == "fp8":
        nan = out.q["edges"].float().isnan().cpu()[1]
        assert nan[4:8].all() and nan[9] and not nan[:4].any() and not nan[8]


def _q_layer(mode, n, k, seed):
    from rainbow_iqn_apex_tpu_torch.kernels.quantize import quantize_plain

    r = _rng(seed)
    w_mu, w_sg = r.uniform(-1, 1, (n, k)) * k ** -0.5, r.uniform(0, 1, (n, k)) * k ** -0.5
    b_mu, b_sg = r.uniform(-0.1, 0.1, n), r.uniform(0, 0.1, n)
    rows = n if mode == "int8" else 1
    out = []
    for w in (w_mu, b_mu, w_sg, b_sg):
        q, s = quantize_plain(_t(w), mode, rows if w.ndim == 2 else 1)
        out += [q, s]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 3136, 512), (2048, 512, 18), (2048, 512, 1),
                                   (512, 3136, 512), (33, 48, 70),
                                   # serving's other bucket rows (8 and 32 requests x 32 taus)
                                   (256, 3136, 512), (1024, 3136, 512),
                                   # the catch scenario's act tick: 8 lanes x 8 taus, F 2304
                                   # (80x80x2), hidden 128, 3 actions
                                   (64, 2304, 128), (64, 128, 3), (64, 128, 1)])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_k10g_kernel_matches_plain(cuda, m, k, n, use_noise, mode):
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q import (
        noisy_linear_q,
        noisy_linear_q_plain,
    )

    qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg = [
        t.to(cuda) for t in _q_layer(mode, n, k, 31)]
    x = _t(np.maximum(_rng(32).standard_normal((m, k)), 0), torch.bfloat16).to(cuda)
    args = [x, qw_mu, sw_mu, qb_mu, sb_mu]
    if use_noise:
        r = _rng(33)
        args += [qw_sg, sw_sg, qb_sg, sb_sg, _f(_t(r.standard_normal(k))).to(cuda),
                 _f(_t(r.standard_normal(n))).to(cuda)]
    for relu in (False, True):
        got = _counted("K10g_noisy_linear_q", lambda: noisy_linear_q(*args, relu=relu))
        torch.testing.assert_close(got, noisy_linear_q_plain(*args, relu=relu),
                                   atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 3136, 512), (512, 3136, 512), (256, 3136, 512),
                                   (2048, 512, 18)])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_k10g_kernel_keeps_zero_rows_and_nan_weights_and_repeats_bit_equal(cuda, m, k, n,
                                                                            use_noise, mode):
    """int8: a row of zero bytes with scale 0 gives that column's bias alone;
    fp8: NaN bytes (K10q's overflow above 464) make their column NaN, through
    the ReLU as in the twin (jax.nn.relu keeps NaN); and a second call gives
    the same bits (in-order sums, no atomics)."""
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q import (
        noisy_linear_q,
        noisy_linear_q_plain,
    )

    qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg = _q_layer(mode, n, k, 35)
    row = n // 2
    if mode == "int8":
        qw_mu[row], sw_mu[row] = 0, 0.0
        qw_sg[row], sw_sg[row] = 0, 0.0
    else:  # e4m3fn's NaN is 0x7f / 0xff
        qw_mu.view(torch.uint8)[row, 3:9] = 0x7F
        qw_sg.view(torch.uint8)[row, k - 5] = 0xFF
    x = _t(np.maximum(_rng(36).standard_normal((m, k)), 0), torch.bfloat16).to(cuda)
    args = [x] + [t.to(cuda) for t in (qw_mu, sw_mu, qb_mu, sb_mu)]
    if use_noise:
        r = _rng(37)
        args += [t.to(cuda) for t in (qw_sg, sw_sg, qb_sg, sb_sg)]
        args += [_f(_t(r.standard_normal(k))).to(cuda), _f(_t(r.standard_normal(n))).to(cuda)]
    for relu in (False, True):
        got = _counted("K10g_noisy_linear_q", lambda: noisy_linear_q(*args, relu=relu))
        want = noisy_linear_q_plain(*args, relu=relu)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3, equal_nan=True)
        nan_col = got[:, row].isnan()
        assert bool(nan_col.all()) if mode == "fp8" else not bool(nan_col.any())
        assert int(got.isnan().sum()) == (m if mode == "fp8" else 0)
        again = noisy_linear_q(*args, relu=relu)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_k10d_kernel_equals_plain(cuda, mode):
    """Bit-equal to the twin: one fp32 product, one rounding to bf16 (or
    none, for the fp32 output)."""
    from rainbow_iqn_apex_tpu_torch.kernels.dequantize import dequantize, dequantize_plain
    from rainbow_iqn_apex_tpu_torch.utils.quantize import quantize_params

    tree = {k: v for k, v in _quant_tree(34).items() if k != "edges"}
    qp = quantize_params(tree, mode).to(cuda)
    names = list(tree)
    outs = [torch.empty(tree[n].shape, device=cuda,
                        dtype=torch.float32 if n == "bias" else torch.bfloat16) for n in names]
    _counted("K10d_dequantize", lambda: dequantize([qp.q[n] for n in names],
                                                   [qp.s[n] for n in names], outs))
    for n, got in zip(names, outs):
        want = dequantize_plain(qp.q[n], qp.s[n], got.dtype)
        assert torch.equal(got, want), n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
def test_quantized_network_runs_k10_kernels_and_matches_the_cpu(cuda, mode, use_noise):
    """``QuantizedIQN`` at small widths on the card: K10d 1, K2 1, K10g 4, K4
    1 and K3 0 launches per forward, quantiles within the bf16 model's
    3e-2 of the same network's plain path on the CPU."""
    from rainbow_iqn_apex_tpu_torch.config import Config
    from rainbow_iqn_apex_tpu_torch.models import init_params
    from rainbow_iqn_apex_tpu_torch.models.quantized import make_quantized_network
    from rainbow_iqn_apex_tpu_torch.utils.quantize import quantize_params

    cfg = Config(frame_height=44, frame_width=44, history_length=2, hidden_size=64,
                 num_cosines=16, num_quantile_samples=8)
    qp = quantize_params(init_params(cfg, 6, seed=3), mode)
    nets = [make_quantized_network(cfg, 6, qp.to(dev), use_noise) for dev in (cuda, "cpu")]
    obs = torch.from_numpy(_rng(35).integers(0, 256, (16, 44, 44, 2), dtype=np.uint8))
    taus = _t(_rng(36).random((16, 8)))
    noise = nets[1].sample_noise(torch.Generator().manual_seed(0)) if use_noise else None
    before = dict(launches)
    with torch.inference_mode():
        got = nets[0](obs.to(cuda), 8, taus=taus.to(cuda),
                      noise={k: (a.to(cuda), b.to(cuda)) for k, (a, b) in noise.items()}
                      if use_noise else None)
        torch.cuda.synchronize()
        want = nets[1](obs, 8, taus=taus, noise=noise)
    per_call = {k: launches[k] - before[k] for k in launches}
    assert per_call["K10d_dequantize"] == 1 and per_call["K2_tau_embed"] == 1
    assert per_call["K10g_noisy_linear_q"] == 4 and per_call["K4_dueling_head"] == 1
    assert per_call["K3_noisy_linear"] == 0
    torch.testing.assert_close(got.quantiles.cpu(), want.quantiles, atol=3e-2, rtol=0)


# ------------------------------------------------- R2D2's kernels on the card
K9_TOL = dict(atol=1e-4, rtol=1e-4)


def _lstm_inputs(batch, steps, hidden, seed, p_reset=0.05):
    r = _rng(seed)
    xw = _t(r.standard_normal((batch, steps, 4 * hidden)) * 0.5)
    w_h = _t(r.standard_normal((hidden, 4 * hidden)) * hidden ** -0.5)
    b = _t(r.standard_normal(4 * hidden) * 0.1)
    reset = torch.from_numpy(r.random((batch, steps)) < p_reset)
    c0, h0 = _t(r.standard_normal((batch, hidden)) * 0.5), _t(r.standard_normal((batch, hidden)) * 0.5)
    return xw, w_h, b, reset, c0, h0


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", [(32, 120, 512), (32, 40, 512), (16, 1, 512),
                                                (5, 7, 40)])
def test_k9_kernel_matches_plain(cuda, batch, steps, hidden):
    """The learner's unrolls (T 120 whole, 40 burn-in), an act tick (T 1)
    and an odd shape, ~5 % resets planted: h_seq, the final (c, h) and what
    the backward keeps (gate activations, c per step), against the twin run
    on the card's tensors."""
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import lstm_forward, lstm_forward_plain

    args = [t.to(cuda) for t in _lstm_inputs(batch, steps, hidden, 40)]
    got = _counted("K9_lstm", lambda: lstm_forward(*args, save=True))
    want = lstm_forward_plain(*args, save=True)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        torch.testing.assert_close(g, w, **K9_TOL)
    unsaved = lstm_forward(*args)  # nothing saved for a backward: the same outputs
    torch.testing.assert_close(unsaved[0], got[0], atol=0, rtol=0)
    assert unsaved[3] is None


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", [(32, 80, 512), (5, 7, 40)])
@pytest.mark.parametrize("final_grads", [False, True], ids=["seq_only", "with_final_state"])
def test_k9_bwd_kernel_matches_plain(cuda, batch, steps, hidden, final_grads):
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import (
        lstm_backward,
        lstm_backward_plain,
        lstm_forward_plain,
    )

    xw, w_h, b, reset, c0, h0 = [t.to(cuda) for t in _lstm_inputs(batch, steps, hidden, 41)]
    _, _, _, (gates, c_seq) = lstm_forward_plain(xw, w_h, b, reset, c0, h0, save=True)
    r = _rng(42)
    dh_seq = _t(r.standard_normal((batch, steps, hidden))).to(cuda)
    dh_last = _t(r.standard_normal((batch, hidden))).to(cuda) if final_grads else None
    dc_last = _t(r.standard_normal((batch, hidden))).to(cuda) if final_grads else None
    args = (dh_seq, dh_last, dc_last, w_h, reset, gates, c_seq, c0)
    got = _counted("K9_lstm_bwd", lambda: lstm_backward(*args))
    torch.testing.assert_close(got, lstm_backward_plain(*args), **K9_TOL)


K9_BATCHES, K9_STEPS, K9_HIDDEN = (8, 9, 31, 32, 33), (1, 2, 40, 80, 120), (40, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", K9_HIDDEN)
@pytest.mark.parametrize("steps", K9_STEPS)
@pytest.mark.parametrize("batch", K9_BATCHES)
def test_k9_kernel_matches_plain_at_the_plan_boundaries(cuda, batch, steps, hidden):
    """Batch sizes on both sides of the groups' edges (on 7 clusters at
    once, B 8 and 9: 2 rows a group; 31, 32, 33: 5 rows, the last group
    partial), LSTM 40 (two blocks of 32 units, the second mostly empty) and
    512 (16 blocks), the act tick's T 1 (a plain grid) and the learner's
    unrolls; ~5 % resets planted."""
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import lstm_forward, lstm_forward_plain

    args = [t.to(cuda) for t in _lstm_inputs(batch, steps, hidden, 48)]
    got = _counted("K9_lstm", lambda: lstm_forward(*args, save=True))
    want = lstm_forward_plain(*args, save=True)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        torch.testing.assert_close(g, w, **K9_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", K9_HIDDEN)
@pytest.mark.parametrize("steps", K9_STEPS)
@pytest.mark.parametrize("batch", K9_BATCHES)
@pytest.mark.parametrize("final_grads", [False, True], ids=["seq_only", "with_final_state"])
def test_k9_bwd_kernel_matches_plain_at_the_plan_boundaries(cuda, batch, steps, hidden,
                                                            final_grads):
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import (
        lstm_backward,
        lstm_backward_plain,
        lstm_forward_plain,
    )

    xw, w_h, b, reset, c0, h0 = [t.to(cuda) for t in _lstm_inputs(batch, steps, hidden, 49)]
    _, _, _, (gates, c_seq) = lstm_forward_plain(xw, w_h, b, reset, c0, h0, save=True)
    r = _rng(50)
    dh_seq = _t(r.standard_normal((batch, steps, hidden))).to(cuda)
    dh_last = _t(r.standard_normal((batch, hidden))).to(cuda) if final_grads else None
    dc_last = _t(r.standard_normal((batch, hidden))).to(cuda) if final_grads else None
    args = (dh_seq, dh_last, dc_last, w_h, reset, gates, c_seq, c0)
    got = _counted("K9_lstm_bwd", lambda: lstm_backward(*args))
    torch.testing.assert_close(got, lstm_backward_plain(*args), **K9_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["first_step", "every_step"])
@pytest.mark.parametrize("batch,steps,hidden", [(32, 80, 512), (9, 40, 40)])
def test_k9_and_k9_bwd_with_planted_resets(cuda, pattern, batch, steps, hidden):
    """A reset at t = 0 on every row (the stored state is dropped at once),
    and a reset on every step (each step starts from zeros), forward and
    backward with final-state gradients."""
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import (
        lstm_backward,
        lstm_backward_plain,
        lstm_forward,
        lstm_forward_plain,
    )

    xw, w_h, b, reset, c0, h0 = _lstm_inputs(batch, steps, hidden, 51, p_reset=0.0)
    if pattern == "first_step":
        reset[:, 0] = True
    else:
        reset[:] = True
    xw, w_h, b, reset, c0, h0 = [t.to(cuda) for t in (xw, w_h, b, reset, c0, h0)]
    got = lstm_forward(xw, w_h, b, reset, c0, h0, save=True)
    want = lstm_forward_plain(xw, w_h, b, reset, c0, h0, save=True)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        torch.testing.assert_close(g, w, **K9_TOL)
    r = _rng(52)
    dh_seq, dh_last, dc_last = (_t(r.standard_normal(shape)).to(cuda) for shape in
                                ((batch, steps, hidden), (batch, hidden), (batch, hidden)))
    args = (dh_seq, dh_last, dc_last, w_h, reset, *want[3], c0)
    torch.testing.assert_close(lstm_backward(*args), lstm_backward_plain(*args), **K9_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", [(32, 120, 512), (32, 80, 512), (16, 1, 512),
                                                (33, 40, 40)])
def test_k9_and_k9_bwd_are_bit_equal_on_a_repeat(cuda, batch, steps, hidden):
    """Fixed summation orders, no atomics on the numbers: a repeat gives the
    same bits, also with other launches between the two on the stream."""
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import lstm_backward, lstm_forward

    xw, w_h, b, reset, c0, h0 = [t.to(cuda) for t in _lstm_inputs(batch, steps, hidden, 53)]
    first = lstm_forward(xw, w_h, b, reset, c0, h0, save=True)
    lstm_forward(xw[:5].contiguous(), w_h, b, reset[:5].contiguous(), c0[:5], h0[:5])
    again = lstm_forward(xw, w_h, b, reset, c0, h0, save=True)
    for g, w in zip((*first[:3], *first[3]), (*again[:3], *again[3])):
        assert torch.equal(g, w)
    dh_seq = _t(_rng(54).standard_normal((batch, steps, hidden))).to(cuda)
    args = (dh_seq, None, None, w_h, reset, *first[3], c0)
    assert torch.equal(lstm_backward(*args), lstm_backward(*args))


@pytest.mark.cuda
def test_k9_autograd_on_the_card_matches_the_cpu(cuda):
    """``LSTMFn`` (K9 + K9-bwd + the products for dW_h, db) on the card
    against the same Function on the CPU twins."""
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import LSTMFn

    inputs = _lstm_inputs(4, 12, 64, 43, p_reset=0.2)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xw, w_h, b, reset, c0, h0 = [t.to(dev) for t in inputs]
        xw, w_h, b = (t.clone().requires_grad_() for t in (xw, w_h, b))
        h_seq, c, _ = LSTMFn.apply(xw, w_h, b, reset, c0, h0)
        (h_seq.square().sum() + c.sum()).backward()
        grads.append([t.grad.cpu() for t in (xw, w_h, b)])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **K9_TOL)


def _td_inputs(batch, steps, actions, seed):
    r = _rng(seed)
    q_sel = _t(r.standard_normal((batch, steps, actions)) * 3)
    q_sel[0, 0, :] = 1.0  # a tie: the first index wins
    done = torch.from_numpy(r.random((batch, steps)) < 0.05)
    valid = torch.ones((batch, steps), dtype=torch.bool)
    valid[0, steps // 2:] = False  # a cut sequence
    valid[-1] = False  # an empty one
    done[1, steps // 3] = True
    return (_t(r.standard_normal((batch, steps)) * 3), q_sel,
            _t(r.standard_normal((batch, steps, actions)) * 3),
            _t(r.standard_normal((batch, steps))), done, valid, _t(r.uniform(0.3, 1, batch)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,actions,n", [(32, 80, 18, 3), (5, 9, 4, 2)])
def test_k11_kernel_matches_plain(cuda, batch, steps, actions, n):
    from rainbow_iqn_apex_tpu_torch.kernels.r2d2_td import TDParams, r2d2_td, r2d2_td_plain

    p = TDParams(n, 0.99, 0.9, 1e-3)
    args = [t.to(cuda) for t in _td_inputs(batch, steps, actions, 44)]
    got = _counted("K11_r2d2_td", lambda: r2d2_td(*args, p))
    want = r2d2_td_plain(*args, p)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    assert float(got[1][-1]) == 0.0 and not got[3][-1].any()  # the empty sequence


@pytest.mark.cuda
@pytest.mark.parametrize("shape,history", [((32, 120, 84, 84), 4), ((3, 5, 7, 9), 3),
                                           ((2, 6, 4, 5), 4), ((2, 6, 4, 4), 1)])
def test_k8s_stack_kernel_equals_plain(cuda, shape, history):
    from rainbow_iqn_apex_tpu_torch.kernels.seq_stack import seq_stack, seq_stack_plain

    obs = torch.from_numpy(_rng(45).integers(0, 256, (*shape, 1), dtype=np.uint8)).to(cuda)
    got = _counted("K8s_seq_stack", lambda: seq_stack(obs, history))
    assert torch.equal(got, seq_stack_plain(obs, history))


@pytest.mark.cuda
def test_r2d2_kernels_refuse_what_they_do_not_take(cuda):
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import lstm_forward
    from rainbow_iqn_apex_tpu_torch.kernels.r2d2_td import TDParams, r2d2_td
    from rainbow_iqn_apex_tpu_torch.kernels.seq_stack import seq_stack

    xw, w_h, b, reset, c0, h0 = [t.to(cuda) for t in _lstm_inputs(2, 3, 8, 46)]
    with pytest.raises(ValueError):
        lstm_forward(xw, w_h, b, reset.float(), c0, h0)
    with pytest.raises(ValueError):
        lstm_forward(xw[:, :, :8], w_h, b, reset, c0, h0)
    args = [t.to(cuda) for t in _td_inputs(2, 5, 3, 47)]
    with pytest.raises(ValueError):
        r2d2_td(*args, TDParams(5, 0.99, 0.9, 1e-3))
    with pytest.raises(ValueError):
        seq_stack(torch.zeros((2, 3, 4, 4, 2), dtype=torch.uint8, device=cuda), 4)


# ------------------------------- R2D2 anakin: the sequence replay's kernels
SEQ_REL = dict(rtol=1e-6, atol=0.0)  # prob, weights, priorities: one powf / division vs torch's


def _seq_replay(device, lanes, seq_len, stride, frame, lstm, capacity):
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import DeviceSequenceReplay

    return DeviceSequenceReplay(capacity, seq_len, frame, lstm, lanes, stride,
                                priority_exponent=0.9, device=device)


def _seq_tick(rng, lanes, frame, lstm, p_term=0.03, p_trunc=0.02):
    term = rng.random(lanes) < p_term
    return (rng.integers(0, 256, (lanes, *frame), dtype=np.uint8),
            rng.integers(0, 18, lanes).astype(np.int32), rng.normal(size=lanes).astype(np.float32),
            term, (rng.random(lanes) < p_trunc) & ~term,
            rng.normal(size=(lanes, lstm)).astype(np.float32),
            rng.normal(size=(lanes, lstm)).astype(np.float32))


def _same_seq_state(got, want):
    """Ring rows [0, C), the counters and each builder's valid prefix."""
    capacity = want.priority.shape[0]
    assert (got.pos, got.filled) == (want.pos, want.filled)
    np.testing.assert_array_equal(got.buf_len, want.buf_len)
    for name in ("frames", "actions", "rewards", "dones", "valids", "init_c", "init_h"):
        assert torch.equal(getattr(got, name)[:capacity], getattr(want, name)[:capacity]), name
    assert torch.equal(got.priority, want.priority) and torch.equal(got.max_priority,
                                                                    want.max_priority)
    for lane, n in enumerate(want.buf_len):
        for name in ("buf_frames", "buf_actions", "buf_rewards", "buf_dones", "buf_c", "buf_h"):
            assert torch.equal(getattr(got, name)[lane, :n], getattr(want, name)[lane, :n]), name


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,seq_len,stride,frame,lstm,capacity,ticks", [
    (16, 120, 80, (84, 84), 512, 64, 700),  # the reference config's widths, the ring wrapped
    (3, 7, 2, (5, 7), 4, 16, 90),  # stride < L - stride, frames not a multiple of 16 bytes
    (4, 6, 3, (8, 8), 8, 8, 60)])
def test_k7s_kernel_matches_twin(cuda, lanes, seq_len, stride, frame, lstm, capacity, ticks):
    from rainbow_iqn_apex_tpu_torch.kernels.seq_append import plan_append, seq_append_plain

    replay = _seq_replay(cuda, lanes, seq_len, stride, frame, lstm, capacity)
    got, want = replay.init_state(), replay.init_state()
    rng = _rng(50)
    before = launches["K7s_seq_append"]
    for _ in range(ticks):
        f, a, r, term, trunc, c, h = _seq_tick(rng, lanes, frame, lstm)
        f, a, c, h = (torch.from_numpy(x).to(cuda) for x in (f, a, c, h))
        replay.append(got, f, a, r, term, trunc, c, h)
        plan = plan_append(want.buf_len, term, trunc, want.pos, want.filled, capacity, seq_len,
                           stride)
        seq_append_plain(want, f, a, r, term, c, h, plan, stride)
        want.buf_len, want.pos, want.filled = plan.buf_len, plan.pos, plan.filled
    torch.cuda.synchronize()
    assert launches["K7s_seq_append"] == before + ticks
    assert got.filled == capacity  # wrapped
    _same_seq_state(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [8333, 5000, 100])
@pytest.mark.parametrize("groups", [1, 4])
def test_k5s_kernel_matches_twin(cuda, capacity, groups):
    from rainbow_iqn_apex_tpu_torch.kernels.seq_draw import seq_draw, seq_draw_plain

    gen = torch.Generator(device=cuda).manual_seed(capacity + groups)
    u = torch.rand((groups, 32), generator=gen, device=cuda)
    u[-1, -1] = 1.0 - 2.0 ** -24  # rounds u up to the total: clipped onto C - 1
    # dyadic priorities: every cdf exact, so the draws are equal
    p = torch.randint(0, 9, (capacity,), generator=gen, device=cuda).float() / 8
    idx, meta = _counted("K5s_seq_draw", lambda: seq_draw(p, capacity // 2, u))
    want_idx, want_meta = seq_draw_plain(p, capacity // 2, u)
    assert torch.equal(idx, want_idx) and torch.equal(meta, want_meta)
    assert bool((p[idx.reshape(-1)[:-1].long()] > 0).all())
    # the cold ring: uniform over the filled prefix, exact
    zero = torch.zeros_like(p)
    for filled in (0, 37 % capacity, capacity):
        idx, meta = seq_draw(zero, filled, u)
        want_idx, want_meta = seq_draw_plain(zero, filled, u)
        assert torch.equal(idx, want_idx) and torch.equal(meta, want_meta)
        assert float(meta[1]) == 1.0 and int(idx.reshape(-1)[:-1].max()) < max(filled, 1)
    # random priorities: the kernel's monotone cdf against an fp64 one, equal
    # but where u lies within fp32 rounding of a cdf boundary
    p = torch.rand((capacity,), generator=gen, device=cuda)
    p[torch.rand((capacity,), generator=gen, device=cuda) < 0.3] = 0.0
    idx, meta = seq_draw(p, capacity, u)
    k = torch.arange(32, device=cuda, dtype=torch.float32)
    u_abs = ((k + u) / 32 * meta[0]).double()
    cdf64 = torch.cumsum(p.double(), 0)
    ref = torch.searchsorted(cdf64, u_abs, right=True).clamp(0, capacity - 1)
    differ = idx.long() != ref
    lo = torch.minimum(idx.long(), ref)[differ]
    assert bool(((u_abs[differ] - cdf64[lo]).abs() <= 1e-5 * float(meta[0])).all())
    assert bool((p[idx.reshape(-1)[:-1].long()] > 0).all())  # all but the clipped draw
    assert abs(float(meta[0]) - float(cdf64[-1])) <= 1e-5 * float(cdf64[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("frame,seq_len,lstm", [((84, 84), 120, 512), ((5, 7), 7, 4)])
@pytest.mark.parametrize("groups", [1, 4])
def test_k8s_assemble_kernel_matches_twin(cuda, frame, seq_len, lstm, groups):
    from rainbow_iqn_apex_tpu_torch.kernels.seq_assemble import seq_assemble, seq_assemble_plain
    from rainbow_iqn_apex_tpu_torch.kernels.seq_draw import seq_draw

    lanes, capacity, batch = 4, 40, 8
    replay = _seq_replay(cuda, lanes, seq_len, max(seq_len // 3, 1), frame, lstm, capacity)
    state = replay.init_state()
    rng = _rng(51)
    for _ in range(3 * seq_len):
        f, a, r, term, trunc, c, h = _seq_tick(rng, lanes, frame, lstm, 0.05, 0.05)
        replay.append(state, *(torch.from_numpy(x).to(cuda) for x in (f, a)), r, term, trunc,
                      *(torch.from_numpy(x).to(cuda) for x in (c, h)))
    state.priority[: state.filled] = torch.from_numpy(
        rng.uniform(0.1, 2.0, state.filled).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, state.filled, groups * batch).astype(np.int32)).to(cuda)
    for priority in (state.priority.clone(), torch.zeros_like(state.priority)):
        state.priority.copy_(priority)
        _, meta = seq_draw(state.priority, state.filled, state.priority.new_empty((0, 1)))
        for with_weight in (True, False):
            got = _counted("K8s_seq_assemble", lambda: seq_assemble(
                state, idx, meta, 0.6, state.filled, batch, with_weight))
            want = seq_assemble_plain(state, idx, meta, 0.6, state.filled, batch, with_weight)
            for name in ("obs", "action", "reward", "done", "valid", "init_c", "init_h"):
                assert torch.equal(getattr(got, name), getattr(want, name)), name
            torch.testing.assert_close(got.prob, want.prob, **SEQ_REL)
            torch.testing.assert_close(got.weight, want.weight, **SEQ_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("omega", [0.5, 0.9])
@pytest.mark.parametrize("groups", [1, 4])
def test_k6s_kernel_matches_twin_with_repeats_and_no_fence(cuda, groups, omega):
    from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import seq_writeback, seq_writeback_plain

    gen = torch.Generator(device=cuda).manual_seed(groups)
    p = torch.rand((8333,), generator=gen, device=cuda)
    p[:20] = 0.0  # no fence: zero slots are written too
    idx = torch.randint(0, 40, (groups, 32), generator=gen, device=cuda, dtype=torch.int32)
    td = torch.rand((groups * 32,), generator=gen, device=cuda) * 3
    got, got_max = p.clone(), torch.tensor(1.5, device=cuda)
    want, want_max = p.clone(), torch.tensor(1.5, device=cuda)
    _counted("K6s_seq_writeback", lambda: seq_writeback(got, got_max, idx, td, 1e-6, omega))
    seq_writeback_plain(want, want_max, idx, td, 1e-6, omega)
    torch.testing.assert_close(got, want, **SEQ_REL)
    torch.testing.assert_close(got_max, want_max, **SEQ_REL)
    assert bool((got[idx.reshape(-1).long()] > 0).all())


# ------------------------------------------------- K12: the device games' tick
GAME_NAMES = ("catch", "breakout", "freeway", "asterix", "invaders",
              "catch@var", "breakout@var", "freeway@var", "asterix@var", "invaders@var-test")


def _game_states_equal(got, want, what):
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), f"{what}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [16, 4096])
@pytest.mark.parametrize("name", GAME_NAMES)
def test_k12_kernel_matches_twin_bit_for_bit(cuda, name, lanes):
    """batched_init (K12's init mode), then 500 auto-reset ticks with random
    actions: K12's states, frames, rewards, flags, returns and episode
    returns equal to the plain twins run on the same card, every tick."""
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import (
        game_init, game_init_plain, game_render, game_tick, game_tick_plain)

    game = make_device_game(name)
    key = prng.prng_key(lanes + len(name))
    keys = prng.split(key, 501)
    before = launches["K12_device_games"]
    state, frames = game_init(game, keys[0], lanes, cuda)
    want, want_frames = game_init_plain(game, keys[0], lanes, cuda)
    _game_states_equal(state, want, "init")
    assert torch.equal(frames, want_frames) and torch.equal(game_render(game, state), frames)
    ep = torch.zeros(lanes, device=cuda)
    want_ep = ep.clone()
    gen = torch.Generator(device=cuda).manual_seed(lanes)
    cuts = 0
    for t in range(1, 501):
        a = torch.randint(0, game.num_actions, (lanes,), generator=gen, device=cuda,
                          dtype=torch.int32)
        got = game_tick(game, state, ep, a, keys[t])
        want, want_ep, *want_out = game_tick_plain(game, want, want_ep, a, keys[t])
        _game_states_equal(state, want, f"tick {t}")
        assert torch.equal(ep, want_ep), f"tick {t}: ep_ret"
        for field, g, w in zip(("frames", "reward", "term", "trunc", "out_ret"), got, want_out):
            assert torch.equal(g, w) or (field == "out_ret" and torch.equal(g.isnan(), w.isnan())
                                         and torch.equal(g.nan_to_num(), w.nan_to_num())), \
                f"tick {t}: {field}"
        cuts += int((got[2] | got[3]).sum())
    torch.cuda.synchronize()
    assert launches["K12_device_games"] - before == 502  # init, render, 500 ticks
    assert cuts > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", GAME_NAMES)
def test_k12_one_lane_step_matches_twin_bit_for_bit(cuda, name):
    """K12's reset-free step mode at one lane (the host adapter's shape), 500
    steps with a fresh key each: states, frames, rewards and flags equal to
    the twin's step on the same card; a cut re-initialises both from the key
    itself (the adapter's reset, K12's direct init mode)."""
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init, game_step

    game = make_device_game(name)
    keys = prng.split(prng.prng_key(7 + len(name)), 501)
    before = launches["K12_device_games"]
    state, _ = game_init(game, keys[0], 1, cuda, direct=True)
    want = game.init(keys[0].to(cuda)[None])
    _game_states_equal(state, want, "init")
    gen = torch.Generator(device=cuda).manual_seed(11)
    cuts, inits = 0, 1
    for t in range(1, 501):
        a = torch.randint(0, game.num_actions, (1,), generator=gen, device=cuda, dtype=torch.int32)
        got = game_step(game, state, a, keys[t])
        want, *want_out = game.step(want, a, keys[t].to(cuda)[None])
        _game_states_equal(state, want, f"step {t}")
        assert torch.equal(got[0], game.render(want)), f"step {t}: frame"
        for field, g, w in zip(("reward", "term", "trunc"), got[1:], want_out):
            assert torch.equal(g, w), f"step {t}: {field}"
        if bool(got[2] | got[3]):
            cuts += 1
            inits += 1
            state, _ = game_init(game, keys[t], 1, cuda, direct=True)
            want = game.init(keys[t].to(cuda)[None])
            _game_states_equal(state, want, f"reset {t}")
    torch.cuda.synchronize()
    assert launches["K12_device_games"] - before == 500 + inits
    assert cuts > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["breakout", "asterix@var"])
def test_k12_host_adapter_step_matches_twin(cuda, name):
    """The reset-free step mode with the key itself (JaxGameEnv on the card)
    against the same adapter on the CPU."""
    from rainbow_iqn_apex_tpu_torch.envs.device_games import JaxGameEnv

    card, cpu = JaxGameEnv(name, seed=3, device=cuda), JaxGameEnv(name, seed=3, device="cpu")
    np.testing.assert_array_equal(card.reset(), cpu.reset())
    rng = _rng(8)
    for _ in range(200):
        a = int(rng.integers(0, card.num_actions))
        got, want = card.step(a), cpu.step(a)
        np.testing.assert_array_equal(got.obs, want.obs)
        assert (got.reward, got.terminal, got.truncated, got.info) == (
            want.reward, want.terminal, want.truncated, want.info)
        if got.terminal or got.truncated:
            np.testing.assert_array_equal(card.reset(), cpu.reset())


# -------------------- the multi-game modes: K2g, K2g-bwd, K4m, K4l (slice 9)
def _mt_inputs(device, batch=6, n=4, feat=64, cos=16, games=3, actions=5):
    r = _rng(41)
    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    game = torch.from_numpy((np.arange(batch) % games).astype(np.int32)).to(device)
    emb = _t(r.normal(0, 0.5, (games, feat))).to(device)
    dh = _t(r.standard_normal((batch * n, feat)), torch.bfloat16).to(device)
    k2 = (_t(taus).to(device), _t(w.T, torch.bfloat16).to(device), _t(b).to(device),
          _t(phi, torch.bfloat16).to(device))
    value = _t(r.standard_normal((batch * n, 1))).to(device)
    adv = _t(r.standard_normal((batch * n, actions))).to(device)
    mask = torch.ones((games, actions), dtype=torch.bool, device=device)
    mask[1, 3:] = False
    mask[2, 4:] = False
    adv[n:2 * n, 4] += 8.0  # row 1 (game 1, 3 actions) prefers the pad slot 4 unmasked
    take = torch.tensor([0, 2, 3, 1, 1, 0][:batch], dtype=torch.int32, device=device)
    return k2, game, emb, dh, value, adv, mask, take


def test_multigame_wrappers_run_plain_twins_on_cpu_without_counting():
    before = dict(launches)
    k2, game, emb, dh, value, adv, mask, take = _mt_inputs(torch.device("cpu"))
    assert torch.equal(tau_embed(*k2, game, emb), tau_embed_plain(*k2, game, emb))
    for got, want in zip(tau_embed_bwd(*k2, dh, game, emb), tau_embed_bwd_plain(*k2, dh, game, emb)):
        assert torch.equal(got, want)
    quantiles, q, action = dueling_head(value, adv, 4, game, mask)
    assert action[1].item() < 3 and q[1, 4].item() == -1e9
    assert dueling_head_plain(value, adv, 4)[2][1].item() == 4  # unmasked: the pad slot
    logp, _ = dueling_logp(value, adv, 4, take, game, mask)
    assert torch.equal(logp, dueling_logp_plain(value, adv, 4, take, game, mask)[0])
    assert dict(launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,feat,cos", [(32, 64, 2304, 64), (5, 3, 200, 64),
                                              (3, 200, 200, 24), (1, 64, 256, 8),
                                              (7, 5, 200, 72), (32, 4, 256, 8), (2, 8, 64, 13)])
def test_k2g_kernels_match_plain(cuda, batch, n, feat, cos):
    k2, game, emb, dh, *_ = _mt_inputs(cuda, batch, n, feat, cos, 4)
    got = _counted("K2g_tau_embed_game", lambda: tau_embed(*k2, game, emb))
    torch.testing.assert_close(got.float(), tau_embed_plain(*k2, game, emb).float(), **BF16)
    cos_t = tau_embed(*k2, game, emb, save_cos=True)[1]
    got = _counted("K2g_tau_embed_game_bwd", lambda: tau_embed_bwd(*k2, dh, game, emb, cos_t))
    want = tau_embed_bwd_plain(*k2, dh, game, emb)
    for g, w in zip(got, want):  # 4 bf16 ulps of the element and of the largest element
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=2 ** -6 * scale, rtol=2 ** -6)


@pytest.mark.cuda
def test_k4m_and_k4l_kernels_match_plain(cuda):
    _, game, _, _, value, adv, mask, take = _mt_inputs(cuda)
    got = _counted("K4m_dueling_head_mask", lambda: dueling_head(value, adv, 4, game, mask))
    want = dueling_head_plain(value, adv, 4, game, mask)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **FP32)
    assert got[2][1].item() < 3
    for margs in ((game, mask), ()):
        got = _counted("K4l_dueling_head_logp", lambda: dueling_logp(value, adv, 4, take, *margs))
        for g, w in zip(got, dueling_logp_plain(value, adv, 4, take, *margs)):
            torch.testing.assert_close(g, w, **FP32)
        assert torch.equal(dueling_logp(value, adv, 4, take, *margs)[0], got[0])
