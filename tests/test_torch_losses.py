"""K1, the port's quantile-Huber loss, against the JAX package's.

The plain twin of K1 (``kernels/quantile_huber.py``, what the wrapper runs
for CPU tensors) and its ``torch.autograd.Function`` are held against
``rainbow_iqn_apex_tpu/ops/losses.py:quantile_huber_loss`` and ``jax.grad``
of it, on the same numpy inputs.

Tolerances are those the JAX package's own Pallas kernel of this loss was
held to: loss and td rtol 1e-5, atol 1e-6; gradient rtol 1e-4, atol 1e-7
(fp32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.ops.losses import huber as jax_huber
from rainbow_iqn_apex_tpu.ops.losses import quantile_huber_loss as jax_qh
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import (
    QuantileHuberFn,
    quantile_huber,
    quantile_huber_plain,
)
from rainbow_iqn_apex_tpu_torch.ops.losses import huber, quantile_huber_loss

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, n, n_t, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.random((b, n), dtype=np.float32),
            (rng.standard_normal((b, n_t)) * 2.0).astype(np.float32))


def _boundary():
    """u == 0 (the indicator fires on strict <) and |u| == kappa (the
    quadratic branch is taken at the seam), as in test_loss_torch_oracle."""
    online = np.array([[1.0, 2.0], [0.5, -1.0]], np.float32)
    taus = np.array([[0.25, 0.75], [0.1, 0.9]], np.float32)
    targets = np.array([[1.0, 3.0, 2.0], [1.5, -0.5, 0.0]], np.float32)
    return online, taus, targets


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("b,n,n_t", [(8, 64, 64), (3, 32, 16), (4, 8, 8)])
@pytest.mark.parametrize("kappa", [0.5, 1.0])
def test_forward_matches_jax(b, n, n_t, kappa):
    online, taus, target = _inputs(b, n, n_t)
    ref_loss, ref_td = jax_qh(jnp.asarray(online), jnp.asarray(taus), jnp.asarray(target), kappa)
    loss, td, _ = quantile_huber_plain(_t(online), _t(taus), _t(target), kappa)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **LOSS_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(ref_td), **LOSS_TOL)


def _jax_grad(online, taus, target, w, kappa):
    def f(z):
        return jnp.mean(jnp.asarray(w) * jax_qh(z, jnp.asarray(taus), jnp.asarray(target), kappa)[0])

    return np.asarray(jax.grad(f)(jnp.asarray(online)))


def _port_grad(online, taus, target, w, kappa):
    z = _t(online).clone().requires_grad_()
    per_sample, td = quantile_huber_loss(z, _t(taus), _t(target), kappa)
    torch.mean(_t(w) * per_sample).backward()
    assert not td.requires_grad  # priorities carry no gradient
    return z.grad.numpy()


@pytest.mark.parametrize("kappa", [0.5, 1.0, 2.0])
def test_gradient_matches_jax_grad(kappa):
    online, taus, target = _inputs(8, 64, 64, seed=3)
    w = np.random.default_rng(9).random(8).astype(np.float32) + 0.5
    np.testing.assert_allclose(_port_grad(online, taus, target, w, kappa),
                               _jax_grad(online, taus, target, w, kappa), **GRAD_TOL)


def test_boundary_cases_match_jax_forward_and_gradient():
    online, taus, target = _boundary()
    ref_loss, ref_td = jax_qh(jnp.asarray(online), jnp.asarray(taus), jnp.asarray(target), 1.0)
    loss, td, _ = quantile_huber_plain(_t(online), _t(taus), _t(target), 1.0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **LOSS_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(ref_td), **LOSS_TOL)
    w = np.array([1.0, 0.5], np.float32)
    np.testing.assert_allclose(_port_grad(online, taus, target, w, 1.0),
                               _jax_grad(online, taus, target, w, 1.0), **GRAD_TOL)


def test_gradient_matches_finite_differences():
    """Central differences in float64 (the twin runs in its input dtype)."""
    online, taus, target = (a.astype(np.float64) for a in _inputs(1, 8, 8, seed=5))
    z = _t(online).clone().requires_grad_()
    QuantileHuberFn.apply(z, _t(taus), _t(target), 1.0)[0].sum().backward()
    eps = 1e-6
    for i in range(8):
        e = np.zeros_like(online)
        e[0, i] = eps
        up = quantile_huber_plain(_t(online + e), _t(taus), _t(target), 1.0)[0].sum()
        down = quantile_huber_plain(_t(online - e), _t(taus), _t(target), 1.0)[0].sum()
        fd = float(up - down) / (2 * eps)
        np.testing.assert_allclose(z.grad[0, i].item(), fd, rtol=1e-6, atol=1e-9)


def test_backward_scales_the_saved_gradient_by_the_cotangent():
    online, taus, target = _inputs(4, 8, 6, seed=2)
    _, _, grad = quantile_huber_plain(_t(online), _t(taus), _t(target), 1.0)
    z = _t(online).clone().requires_grad_()
    cot = torch.tensor([1.0, -2.0, 0.0, 0.5])
    loss, _ = QuantileHuberFn.apply(z, _t(taus), _t(target), 1.0)
    loss.backward(cot)
    torch.testing.assert_close(z.grad, cot[:, None] * grad, rtol=0, atol=0)


def test_huber_matches_jax():
    u = np.linspace(-3, 3, 61).astype(np.float32)  # includes 0 and +-1 exactly
    for kappa in (0.5, 1.0):
        np.testing.assert_allclose(huber(_t(u), kappa).numpy(),
                                   np.asarray(jax_huber(jnp.asarray(u), kappa)), **LOSS_TOL)


def test_wrapper_runs_the_twin_on_the_cpu():
    online, taus, target = _inputs(2, 4, 4)
    got = quantile_huber(_t(online), _t(taus), _t(target), 1.0)
    want = quantile_huber_plain(_t(online), _t(taus), _t(target), 1.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
