"""The port's kernels (rainbow_iqn_apex_tpu_torch.kernels): K2 tau embed,
K3 noisy linear, K4 dueling head, and the learner's K1 quantile-Huber and
the backward kernels of K2, K3 and K4 (their twins are held against
jax.grad in tests/test_torch_learn.py and tests/test_torch_losses.py).

On the CPU each wrapper must run its plain twin (and count no launch), and
each plain twin must match its JAX counterpart: K2 against
CosineTauEmbedding plus the Hadamard merge, K3 against NoisyLinear, K4
against the dueling combine with q_values / greedy_action.  Inputs come from
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
one ulp; K3-bwd splits the fp32 dy into two bf16 halves, exact to ~2^-17);
K4's gather mode and K4-bwd 1e-6 (one fp32 product and subtraction).
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
)
from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
    noisy_linear,
    noisy_linear_bwd,
    noisy_linear_bwd_plain,
    noisy_linear_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import quantile_huber, quantile_huber_plain
from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
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
                                              (3, 7, 200, 32)])
def test_k2_kernel_matches_plain(cuda, batch, n, feat, cos):
    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    args = (_t(taus).to(cuda), _t(w.T, torch.bfloat16).to(cuda), _t(b).to(cuda),
            _t(phi, torch.bfloat16).to(cuda))
    before = launches["K2_tau_embed"]
    got = tau_embed(*args)
    torch.cuda.synchronize()
    assert launches["K2_tau_embed"] == before + 1
    torch.testing.assert_close(got.float(), tau_embed_plain(*args).float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 3136, 512), (2048, 512, 18), (2048, 512, 1),
                                   (40, 256, 20), (33, 40, 70)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,feat,cos", [(32, 64, 3136, 64), (5, 8, 256, 16),
                                              (3, 7, 200, 32)])
def test_k2_bwd_kernel_matches_plain(cuda, batch, n, feat, cos):
    taus, w, b, phi = _k2_inputs(batch, n, feat, cos)
    bf = torch.bfloat16
    dh = _t(_rng(21).standard_normal((batch * n, feat)), bf).to(cuda)
    args = (_t(taus).to(cuda), _t(w.T, bf).to(cuda), _t(b).to(cuda), _t(phi, bf).to(cuda), dh)
    got = _counted("K2_tau_embed_bwd", lambda: tau_embed_bwd(*args))
    for g, w_ in zip(got, tau_embed_bwd_plain(*args)):
        torch.testing.assert_close(g.float(), w_.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 3136, 512), (2048, 512, 18), (2048, 512, 1),
                                   (40, 256, 20), (33, 40, 70)])
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
