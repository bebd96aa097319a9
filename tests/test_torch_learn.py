"""The port's learner (rainbow_iqn_apex_tpu_torch.ops.learn) against the JAX
package's, from the gradient of each differentiable module to whole learn
steps, on the CPU through the plain twins of the kernels.

Both frameworks get the same weights (a JAX TrainState carried across by
convert.py, a few steps in so the Adam moments are non-zero), the same
batch, and the same taus and noise: the port takes them through ``draws=``;
the JAX side gets them by monkeypatching ``jax.random.uniform`` (taus) and
``jax.random.normal`` (noise) in call order, in this process only.

Tolerances:
- fp32 modules: rtol/atol 1e-5 (summation order only).
- fp32 learn steps: loss, priorities, q means, grad_norm rtol 1e-5; params,
  target params and Adam moments after the update rtol 1e-4, atol 1e-6
  (Adam divides by sqrt(nu), which amplifies the fp32 differences of small
  gradients; one step of lr 1e-3 moves a parameter by at most ~1e-3).
- bf16 modules: cotangents of bf16 operands are rounded to bf16 by both
  sides, but XLA on the CPU sums some bf16 cotangents (the merge's
  broadcast, two heads' inputs) with bf16 partial sums, where the port sums
  in fp32 and rounds once; BF16_GRAD: rtol 2^-6 (4 bf16 ulps) and atol 2^-6
  of the largest reference element.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rainbow_iqn_apex_tpu.config import Config as JaxConfig
from rainbow_iqn_apex_tpu.models.layers import CosineTauEmbedding as JaxCosEmbed
from rainbow_iqn_apex_tpu.models.layers import NoisyLinear as JaxNoisyLinear
from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import DuelingGatherFn
from rainbow_iqn_apex_tpu_torch.models import CosineTauEmbedding, NoisyLinear
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn

A = 3
B = 4
SHAPE = (44, 44, 2)
FP32 = dict(rtol=1e-5, atol=1e-5)
STEP_INFO = dict(rtol=1e-5, atol=1e-6)
STEP_STATE = dict(rtol=1e-4, atol=1e-6)
NOISY = ("value_hidden", "value_out", "advantage_hidden", "advantage_out")
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=what, **tol)


def _bf16_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -6 * scale, err_msg=what)


def _inject(monkeypatch, uniforms, normals):
    """jax.random.uniform hands out ``uniforms`` (the taus draws: U[0, 1))
    and jax.random.normal ``normals`` in call order; returns both queues
    (empty when used up).  Other uniform draws (flax checks the NoisyLinear
    initialiser's shapes on apply) go to the real function."""
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


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------- module gradients
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_noise", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("layer", ["hidden", "out"])
def test_noisy_linear_gradient_matches_jax_grad(monkeypatch, dtype, use_noise, layer):
    """hidden: compute-dtype input and ReLU (as value/advantage_hidden);
    out: fp32 input, no ReLU (as *_out, fed by the fp32 ReLU output)."""
    jdt, tdt = DT[dtype]
    fan_in, out = (48, 16) if layer == "hidden" else (16, 3)
    relu = layer == "hidden"
    rng = np.random.default_rng(11)
    p = {"w_mu": rng.uniform(-0.2, 0.2, (fan_in, out)).astype(np.float32),
         "b_mu": rng.normal(0, 0.1, out).astype(np.float32),
         "w_sigma": rng.uniform(0.0, 0.1, (fan_in, out)).astype(np.float32),
         "b_sigma": rng.uniform(0.0, 0.1, out).astype(np.float32)}
    x = rng.standard_normal((24, fan_in)).astype(np.float32)
    if relu:
        x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))  # exact in the compute dtype
    g = rng.standard_normal((24, out)).astype(np.float32)
    eps = (rng.standard_normal(fan_in).astype(np.float32), rng.standard_normal(out).astype(np.float32))
    _inject(monkeypatch, [], list(eps) * 2)
    mod = JaxNoisyLinear(out, use_noise=use_noise, compute_dtype=jdt)
    x_j = jnp.asarray(x, jdt if relu else jnp.float32)

    def f(params, xx):
        y = mod.apply({"params": params}, xx, rngs={"noise": jax.random.PRNGKey(0)})
        return jnp.sum((jax.nn.relu(y) if relu else y) * jnp.asarray(g))

    gp, gx = jax.grad(f, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), x_j)

    lyr = NoisyLinear(fan_in, out, compute_dtype=tdt)
    lyr.load_state_dict({"w_mu": _t(p["w_mu"].T), "b_mu": _t(p["b_mu"]),
                         "w_sigma": _t(p["w_sigma"].T), "b_sigma": _t(p["b_sigma"])})
    xt = _t(x).to(tdt if relu else torch.float32).requires_grad_()
    y = lyr(xt, tuple(map(_t, eps)) if use_noise else None, relu=relu)
    (y * _t(g)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    pairs = [(xt.grad.float(), gx, "dx"), (lyr.w_mu.grad.T, gp["w_mu"], "dW_mu"),
             (lyr.b_mu.grad, gp["b_mu"], "db_mu")]
    if use_noise:
        pairs += [(lyr.w_sigma.grad.T, gp["w_sigma"], "dW_sigma"),
                  (lyr.b_sigma.grad, gp["b_sigma"], "db_sigma")]
    else:
        assert lyr.w_sigma.grad is None  # unused when greedy; zero on the JAX side
        assert not np.any(np.asarray(gp["w_sigma"]))
    for got, want, what in pairs:
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dtype == "float32":
            _close(got.numpy(), want, FP32, what)
        else:
            _bf16_close(got.numpy(), want, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tau_embedding_with_merge_gradient_matches_jax_grad(dtype):
    jdt, tdt = DT[dtype]
    feat, cos_n, batch, n = 40, 16, 3, 8
    rng = np.random.default_rng(12)
    kernel = (rng.standard_normal((cos_n, feat)) * 0.3).astype(np.float32)
    bias = rng.normal(0, 0.1, feat).astype(np.float32)
    taus = rng.random((batch, n), dtype=np.float32)
    phi = np.asarray(jnp.asarray(rng.random((batch, feat), dtype=np.float32), jdt).astype(jnp.float32))
    g = rng.standard_normal((batch * n, feat)).astype(np.float32)
    mod = JaxCosEmbed(features=feat, num_cosines=cos_n, compute_dtype=jdt)

    def f(params, ph):
        psi = mod.apply({"params": params}, jnp.asarray(taus))
        h = (ph[:, None, :].astype(jdt) * psi).reshape(batch * n, feat)
        return jnp.sum(h.astype(jnp.float32) * jnp.asarray(g))

    gp, gphi = jax.grad(f, argnums=(0, 1))(
        {"embed": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jnp.asarray(phi, jdt))

    emb = CosineTauEmbedding(feat, cos_n, tdt)
    emb.embed.weight.data = _t(kernel.T)
    emb.embed.bias.data = _t(bias)
    pt = _t(phi).to(tdt).requires_grad_()
    h = emb(_t(taus), pt)
    (h.float() * _t(g)).sum().backward()
    pairs = [(pt.grad.float(), gphi, "dphi"), (emb.embed.weight.grad.T, gp["embed"]["kernel"], "dW_e"),
             (emb.embed.bias.grad, gp["embed"]["bias"], "db_e")]
    for got, want, what in pairs:
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dtype == "float32":
            _close(got.numpy(), want, FP32, what)
        else:
            _bf16_close(got.numpy(), want, what)


@pytest.mark.parametrize("dueling", [True, False])
def test_dueling_gather_gradient_matches_jax_grad(dueling):
    batch, n = 4, 8
    rng = np.random.default_rng(13)
    value = rng.standard_normal((batch * n, 1)).astype(np.float32)
    adv = rng.standard_normal((batch * n, A)).astype(np.float32)
    action = rng.integers(0, A, batch).astype(np.int32)
    g = rng.standard_normal((batch, n)).astype(np.float32)

    def f(v, a):
        q = v + a - a.mean(axis=-1, keepdims=True) if dueling else a
        quantiles = q.reshape(batch, n, A)
        z = jnp.take_along_axis(quantiles, jnp.asarray(action)[:, None, None], axis=-1)[..., 0]
        return jnp.sum(z * jnp.asarray(g)), (z, quantiles.mean(axis=1))

    (gv, ga), (z_ref, q_ref) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(value), jnp.asarray(adv))
    vt, at = _t(value).requires_grad_(), _t(adv).requires_grad_()
    z, q = DuelingGatherFn.apply(vt if dueling else None, at, _t(action), n)
    assert not q.requires_grad
    (z * _t(g)).sum().backward()
    _close(z.detach().numpy(), z_ref, FP32, "z")
    _close(q.numpy(), q_ref, FP32, "q")
    _close(at.grad.numpy(), ga, FP32, "dadv")
    if dueling:
        _close(vt.grad.numpy(), gv, FP32, "dvalue")


# ------------------------------------------------------------ optimizer
def _grads(scale, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    grads = _grads(scale)
    max_norm = 2.0
    tx = optax.clip_by_global_norm(max_norm)
    ref, _ = tx.update([jnp.asarray(x) for x in grads], tx.init(grads))
    ts = [_t(x) for x in grads]
    norm = plearn.clip_by_global_norm_(ts, max_norm)
    _close(norm.item(), float(optax.global_norm([jnp.asarray(x) for x in grads])), FP32)
    assert (norm.item() > max_norm) == (scale > 1)
    for got, want in zip(ts, ref):
        _close(got.numpy(), want, dict(rtol=1e-6, atol=1e-7))


def test_adam_adds_eps_outside_the_square_root_as_optax_does():
    """A large eps makes eps-inside and eps-outside differ visibly; three
    steps from zero moments through torch's fused Adam and optax.adam."""
    eps, lr = 0.1, 0.01
    params = _grads(1.0, seed=1)
    tx = optax.adam(lr, eps=eps)
    jp = [jnp.asarray(x) for x in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(_t(x)) for x in params]
    opt = torch.optim.Adam(tp, lr=lr, betas=(0.9, 0.999), eps=eps, fused=True)
    for k in range(3):
        grads = _grads(0.5, seed=10 + k)
        upd, st = tx.update([jnp.asarray(x) for x in grads], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = _t(g)
        opt.step()
    for got, want in zip(tp, jp):
        _close(got.detach().numpy(), want, dict(rtol=1e-6, atol=1e-7))


# ------------------------------------------------------------ learn steps
def _cfgs(dtype="float32", **kw):
    base = dict(compute_dtype=dtype, frame_height=SHAPE[0], frame_width=SHAPE[1],
                history_length=SHAPE[2], hidden_size=32, num_cosines=16, num_tau_samples=8,
                num_tau_prime_samples=8, num_quantile_samples=4, batch_size=B,
                learning_rate=1e-3, adam_eps=1.5e-4, max_grad_norm=10.0,
                target_update_period=100)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
        action=rng.integers(0, A, B).astype(np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        next_obs=rng.integers(0, 256, (B, *SHAPE), dtype=np.uint8),
        discount=np.array([0.9, 0.9, 0.0, 0.81], np.float32),
        weight=rng.uniform(0.5, 1.5, B).astype(np.float32),
    )


def _draws(cfg, feat, seed):
    """taus and noise of the select, target and online forwards."""
    rng = np.random.default_rng(seed)
    dims = [(feat, cfg.hidden_size), (cfg.hidden_size, 1), (feat, cfg.hidden_size),
            (cfg.hidden_size, A)]
    out = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        taus = rng.random((B, n), dtype=np.float32)
        noise = {layer: (rng.standard_normal(i).astype(np.float32),
                         rng.standard_normal(o).astype(np.float32))
                 for layer, (i, o) in zip(NOISY, dims)}
        out[name] = (taus, noise)
    return out


def _jax_inject(monkeypatch, draws_list):
    uniforms, normals = [], []
    for draws in draws_list:
        u, n = _jax_draws(draws)
        uniforms += u
        normals += n
    return _inject(monkeypatch, uniforms, normals)


def _port_draws(draws):
    return {k: (_t(taus), {layer: (_t(a), _t(b)) for layer, (a, b) in noise.items()})
            for k, (taus, noise) in draws.items()}


def _adam(opt_state):
    """The optax ScaleByAdamState inside the chain's state."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


def _to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@functools.lru_cache(maxsize=None)
def _warm_jax_state():
    """A JAX TrainState two fp32 learn steps in (random draws, no target
    copy): Adam moments and count non-zero.  The state is fp32 whatever the
    compute dtype, so the bf16 test starts from it too.  Cached: read-only
    in every test."""
    jcfg, _ = _cfgs("float32")
    state = jax.jit(functools.partial(jlearn.init_train_state, jcfg, A, state_shape=SHAPE))(
        jax.random.PRNGKey(0))
    step = jax.jit(jlearn.build_learn_step(jcfg, A))
    for k in range(2):
        state, _ = step(state, jlearn.Batch(**{k2: jnp.asarray(v) for k2, v in _batch(20 + k).items()}),
                        jax.random.PRNGKey(100 + k))
    return state


def _jax_step(jcfg, queues):
    """The JAX learn step, traced and compiled once for all the steps of a
    test: the draws of a step go in as arguments, and while it traces the
    monkeypatched ``jax.random`` functions hand those (traced) arrays out of
    ``queues``, so every later call uses its own arguments' draws."""
    uq, nq = queues
    step = jlearn.build_learn_step(jcfg, A)

    def run(state, batch, key, uniforms, normals):
        uq[:], nq[:] = list(uniforms), list(normals)
        out = step(state, batch, key)
        assert not uq and not nq  # every forward drew exactly once
        return out

    return jax.jit(run)


def _jax_draws(draws):
    """The (uniforms, normals) that one JAX learn step draws, in call order."""
    uniforms, normals = [], []
    for name in ("select", "target", "online"):
        taus, noise = draws[name]
        uniforms.append(taus)
        normals += [a for layer in NOISY for a in noise[layer]]
    return uniforms, normals


def _port_state(pcfg, jstate):
    st = plearn.init_train_state(pcfg, A, seed=0, state_shape=SHAPE, device="cpu")
    adam = _adam(jstate.opt_state)
    host = convert.from_flax_train_state(_to_np(jstate.params), _to_np(jstate.target_params),
                                         _to_np(adam.mu), _to_np(adam.nu), adam.count, jstate.step)
    return plearn.load_host_state(st, host)


def _port_batch(b):
    return plearn.Batch(**{k: _t(v) for k, v in b.items()})


def _feat(jstate):
    return jstate.params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]


def _compare_states(pstate, jstate, tol):
    host = plearn.host_state(pstate)
    want = convert.to_flax_train_state(host)
    adam = _adam(jstate.opt_state)
    assert int(want["step"]) == int(jstate.step)
    assert int(want["count"]) == int(adam.count)
    for key, ref in (("params", jstate.params), ("target_params", jstate.target_params),
                     ("mu", adam.mu), ("nu", adam.nu)):
        flat_w = jax.tree_util.tree_flatten_with_path(_to_np(ref))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(want[key])[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            _close(g, w, tol, f"{key} {jax.tree_util.keystr(path)}")


def test_loss_and_priorities_match_jax(monkeypatch):
    jcfg, pcfg = _cfgs()
    jstate = _warm_jax_state()
    draws = _draws(pcfg, _feat(jstate), seed=5)
    b = _batch(1)
    uq, nq = _jax_inject(monkeypatch, [draws])
    net = jlearn.make_network(jcfg, A)
    loss, aux = jax.jit(functools.partial(jlearn.loss_and_priorities, net, jcfg))(
        jstate.params, jstate.target_params,
        jlearn.Batch(**{k: jnp.asarray(v) for k, v in b.items()}), jax.random.PRNGKey(3))
    assert not uq and not nq  # every forward drew exactly once
    pstate = _port_state(pcfg, jstate)
    p_loss, p_aux = plearn.loss_and_priorities(pcfg, pstate, _port_batch(b),
                                               draws=_port_draws(draws))
    _close(p_loss.item(), loss, STEP_INFO, "loss")
    _close(p_aux["td_abs"].numpy(), aux["td_abs"], STEP_INFO, "priorities")
    _close(p_aux["loss_per_sample"].numpy(), aux["loss_per_sample"], STEP_INFO, "per sample")
    _close(p_aux["q_mean"].item(), aux["q_mean"], STEP_INFO, "q_mean")
    _close(p_aux["target_q_mean"].item(), aux["target_q_mean"], STEP_INFO, "target_q_mean")


@pytest.mark.parametrize("steps,period", [(1, 100), (3, 2)], ids=["one_step", "three_steps_copy"])
def test_learn_steps_match_jax(monkeypatch, steps, period):
    """From the same converted state: info of every step, then params,
    target params (a copy falls on step 4 with period 2) and Adam state."""
    jcfg, pcfg = _cfgs(target_update_period=period)
    jstate = _warm_jax_state()
    pstate = _port_state(pcfg, jstate)
    draws = [_draws(pcfg, _feat(jstate), seed=40 + k) for k in range(steps)]
    batches = [_batch(60 + k) for k in range(steps)]
    queues = _jax_inject(monkeypatch, [])
    jstep = _jax_step(jcfg, queues)
    pstep = plearn.build_learn_step(pcfg, A)
    for k in range(steps):
        jstate, jinfo = jstep(jstate, jlearn.Batch(**{n: jnp.asarray(v) for n, v in batches[k].items()}),
                              jax.random.PRNGKey(7), *_jax_draws(draws[k]))
        pstate, pinfo = pstep(pstate, _port_batch(batches[k]), draws=_port_draws(draws[k]))
        for key in ("loss", "priorities", "q_mean", "target_q_mean", "grad_norm"):
            _close(pinfo[key].numpy(), jinfo[key], STEP_INFO, f"step {k} {key}")
        assert bool(pinfo["finite"]) and bool(jinfo["finite"])
    assert queues == ([], [])
    assert pstate.step == int(jstate.step)
    _compare_states(pstate, jstate, STEP_STATE)
    if period == 2:  # the copy at step 4 made the target equal to the params then
        assert int(jstate.step) == 5


def test_bf16_learn_step_matches_jax(monkeypatch):
    """One bf16 step: loss and priorities within bf16 rounding of the
    model's outputs (the quantiles agree to ~3e-2 absolute, as the model
    test states), grad_norm within BF16 rounding of the gradient."""
    jcfg, pcfg = _cfgs("bfloat16")
    jstate = _warm_jax_state()
    pstate = _port_state(pcfg, jstate)
    draws = _draws(pcfg, _feat(jstate), seed=77)
    b = _batch(3)
    jstep = _jax_step(jcfg, _jax_inject(monkeypatch, []))
    jstate, jinfo = jstep(jstate, jlearn.Batch(**{n: jnp.asarray(v) for n, v in b.items()}),
                          jax.random.PRNGKey(1), *_jax_draws(draws))
    pstate, pinfo = plearn.build_learn_step(pcfg, A)(pstate, _port_batch(b),
                                                      draws=_port_draws(draws))
    for key in ("loss", "priorities", "q_mean", "target_q_mean"):
        _close(pinfo[key].numpy(), jinfo[key], dict(rtol=2e-2, atol=3e-2), key)
    _close(pinfo["grad_norm"].numpy(), jinfo["grad_norm"], dict(rtol=2 ** -6, atol=0), "grad_norm")


def test_target_copy_happens_on_the_period():
    _, pcfg = _cfgs(target_update_period=2)
    state = plearn.init_train_state(pcfg, A, seed=0, state_shape=SHAPE, device="cpu")
    step = plearn.build_learn_step(pcfg, A)
    gen = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in state.target.state_dict().items()}
    state, _ = step(state, _port_batch(_batch(1)), gen)
    assert all(torch.equal(v, before[k]) for k, v in state.target.state_dict().items())
    state, _ = step(state, _port_batch(_batch(2)), gen)
    online = state.net.state_dict()
    assert all(torch.equal(v, online[k]) for k, v in state.target.state_dict().items())
    assert not any(p.requires_grad for p in state.target.parameters())


# ----------------------------------------------------------------- convert
def test_train_state_round_trip_is_exact():
    jstate = _warm_jax_state()
    adam = _adam(jstate.opt_state)
    assert int(adam.count) == 2 and np.any(np.asarray(adam.mu["value_hidden"]["w_mu"]))
    _, pcfg = _cfgs()
    pstate = _port_state(pcfg, jstate)
    back = convert.to_flax_train_state(plearn.host_state(pstate))
    assert int(back["step"]) == int(jstate.step) and int(back["count"]) == int(adam.count)
    for key, ref in (("params", jstate.params), ("target_params", jstate.target_params),
                     ("mu", adam.mu), ("nu", adam.nu)):
        flat_w = jax.tree_util.tree_flatten_with_path(_to_np(ref))[0]
        flat_g = jax.tree_util.tree_flatten_with_path(back[key])[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            np.testing.assert_array_equal(g, w, err_msg=f"{key} {path}")
    # the port's optimizer state holds those moments on the parameters it updates
    names = dict(pstate.net.named_parameters())
    st = pstate.optimizer.state[names["value_hidden.w_mu"]]
    assert float(st["step"]) == 2.0
    np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                  np.asarray(adam.mu["value_hidden"]["w_mu"]).T)


def test_unported_options_raise():
    for kw in (dict(replay_ratio=2), dict(architecture="r2d2")):
        _, pcfg = _cfgs(**kw)
        with pytest.raises(NotImplementedError):
            plearn.build_learn_step(pcfg, A)
