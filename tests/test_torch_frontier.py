"""The port's device sample frontier (rainbow_iqn_apex_tpu_torch.replay.frontier)
and its kernels K5f / K6f, against the JAX package's DeviceSampleFrontier on
the CPU through the plain twins, and the kernels against their twins on the
card (``cuda``-marked).

Both sides get the same host replay (the port's ShardedReplay is a copy of
the JAX one, filled from the same numpy stream) and the same draws: the
JAX frontier's uniforms are recomputed from its key (``split`` then
``uniform``, as ``frontier.py:126-129`` does) and handed to the port with
``uniforms=``.  JAX is imported inside the tests that use it, so that
``python -m pytest tests/test_torch_frontier.py -m cuda --noconftest`` runs
on a machine without JAX.

Tolerances:
- draw: slot ids exactly on dyadic priorities (every cdf value is exact in
  fp32 in any summation order); prob and weight to 1e-6 relative (K5f's
  total is a chained sum, JAX's a separate reduction).  On random
  priorities an id may differ only where u lies within 1e-6 * sum p of a
  cdf boundary (an fp64 cdf decides), and a chi-square of many draws holds
  the distribution to p / sum p.
- write-back: 1e-6 relative (a square root or power in another library);
  zero and dead slots stay exactly 0; repeated ids write their last
  occurrence (JAX leaves the order open, so its comparison has none).
- staged flushes, drop / readmit / refresh: exact (fp32 copies of host
  leaves).  Reconcile: host trees to 1e-6 relative.
- on the card, K6f's queue (staged segments and write-back batches) applied
  by K5f's first launch or by K6f's own: the mirror bit-equal to the twin's
  apply on the same card tensors (the same fp32 square root), and K5f's
  draw with the queue bit-equal to K5f's draw after the twin's apply.
"""

import math

import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu_torch.kernels import folded, launches
from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import frontier_draw, frontier_draw_plain
from rainbow_iqn_apex_tpu_torch.kernels.frontier_writeback import (
    MirrorQueue,
    frontier_apply,
    frontier_apply_plain,
    frontier_writeback,
    frontier_writeback_plain,
)
from rainbow_iqn_apex_tpu_torch.obs.registry import MetricRegistry
from rainbow_iqn_apex_tpu_torch.parallel.sharded_replay import ShardedReplay
from rainbow_iqn_apex_tpu_torch.replay.frontier import DeviceSampleFrontier, make_batch_assembler
from rainbow_iqn_apex_tpu_torch.utils.prefetch import SampleAheadPusher

FRAME = (12, 12)
REL = dict(rtol=1e-6, atol=0.0)
NAMES = ("K5f_frontier_draw", "K6f_frontier_writeback")


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax():
    """The JAX side, imported here: the ``cuda`` tests run without JAX."""
    import jax
    import jax.numpy as jnp

    from rainbow_iqn_apex_tpu.parallel.sharded_replay import ShardedReplay as JaxShardedReplay
    from rainbow_iqn_apex_tpu.replay.frontier import DeviceSampleFrontier as JaxFrontier

    return jax, jnp, JaxShardedReplay, JaxFrontier


def _fill(cls, shards=2, cap=512, lanes=4, seed=0, ticks=None, use_native=True):
    m = cls.build(shards, cap, lanes, frame_shape=FRAME, history=2, n_step=3, gamma=0.9,
                  seed=seed, use_native=use_native)
    assert all((s._core is not None) == use_native for s in m.shards), "not the core asked for"
    rng = np.random.default_rng(seed + 1)
    for _ in range(ticks if ticks is not None else cap // lanes):
        m.append_batch(
            rng.integers(0, 255, (lanes, *FRAME), dtype=np.uint8),
            rng.integers(0, 4, lanes),
            rng.normal(size=lanes).astype(np.float32),
            rng.random(lanes) < 0.02,
            priorities=rng.random(lanes) + 0.05,
        )
    return m


@pytest.fixture(params=[False, True], ids=["numpy", "native"])
def use_native(request, tmp_path, monkeypatch):
    """Which replay core both sides run, the NumPy one or the C++ one: the
    two sum an n-step return in another order, so a bit-for-bit comparison
    names its core.  ``native`` builds the JAX package's core into
    ``tmp_path`` (its loader builds in the source tree without a lock, and
    under parallel test workers a lost race would fall back to NumPy
    silently)."""
    if request.param:
        from test_torch_train import _jax_native_core_in  # imports JAX: not at module level

        _jax_native_core_in(tmp_path, monkeypatch)
    return request.param


def _pair(use_native, seed=0, dead=(), **kw):
    """(JAX memory + frontier, port memory + frontier) over equal replays,
    both on the NumPy core or both on the C++ one."""
    _, _, JaxShardedReplay, JaxFrontier = _jax()
    mj = _fill(JaxShardedReplay, seed=seed, use_native=use_native, **kw)
    mp = _fill(ShardedReplay, seed=seed, use_native=use_native, **kw)
    fj = JaxFrontier.from_sharded(mj, seed=seed + 7)
    fp = DeviceSampleFrontier.from_sharded(mp, seed=seed + 7, device="cpu")
    for k in dead:
        mj.drop_shard(k)
        mp.drop_shard(k)
    return (mj, fj), (mp, fp)


def _jax_uniforms(seed, groups, batch):
    """The uniforms the JAX frontier's first draw takes from its key."""
    jax, _, _, _ = _jax()
    _key, sub = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.uniform(sub, (groups, batch)))


def _leaves(m):
    return np.concatenate([s.tree.tree[s.tree.span:s.tree.span + s.capacity] for s in m.shards])


# ------------------------------------------------------------ draw parity
@pytest.mark.parametrize("dead", [(), (1,)], ids=["all_alive", "dead_shard"])
def test_draw_matches_jax_exactly_on_dyadic_priorities(dead, use_native):
    (mj, fj), (mp, fp) = _pair(use_native, seed=1, dead=dead)
    _, jnp, _, _ = _jax()
    mirror = fp.mirror_np()
    np.testing.assert_array_equal(mirror, np.asarray(fj.mirror))
    rng = np.random.default_rng(3)
    dyadic = np.where(mirror > 0, rng.integers(1, 9, mirror.shape) / 8, 0.0).astype(np.float32)
    fj.mirror = jnp.asarray(dyadic)
    fp.mirror.copy_(torch.from_numpy(dyadic))
    beta, batch = 0.55, 32
    blk_j = fj.draw(batch, beta, len(mj))
    blk_p = fp.draw(batch, beta, len(mp),
                    uniforms=_jax_uniforms(8, fj.draw_block, batch))
    idx = blk_p.idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(blk_j.idx))
    np.testing.assert_allclose(blk_p.prob.numpy(), np.asarray(blk_j.prob), **REL)
    np.testing.assert_allclose(blk_p.weight.numpy(), np.asarray(blk_j.weight), **REL)
    assert (dyadic[idx] > 0).all(), "a zero slot was drawn"
    if dead:
        assert (idx < mp.shard_capacity).all(), "a dead shard's slot was drawn"
    host_idx, host_w = blk_p.host()
    assert host_idx.dtype == np.int64 and (host_idx == idx).all()
    assert (host_w == blk_p.weight.numpy()).all()


def test_draw_matches_jax_on_random_priorities_within_rounding(use_native):
    """Real tree leaves: prob and weight agree where the ids do, and an id
    differs only where u is within 1e-6 * sum p of an fp64 cdf boundary."""
    (mj, fj), (mp, fp) = _pair(use_native, seed=2)
    batch = 32
    blk_j = fj.draw(batch, 0.4, len(mj))
    u = _jax_uniforms(9, fj.draw_block, batch)
    blk_p = fp.draw(batch, 0.4, len(mp), uniforms=u)
    got, want = blk_p.idx.numpy(), np.asarray(blk_j.idx)
    same = got == want
    assert same.mean() > 0.9
    np.testing.assert_allclose(blk_p.prob.numpy()[same], np.asarray(blk_j.prob)[same], **REL)
    mirror = fp.mirror_np().astype(np.float64)
    cdf = np.cumsum(mirror)
    u_abs = (np.arange(batch)[None, :] + u.astype(np.float64)) / batch * cdf[-1]
    for g, k in zip(*np.nonzero(~same)):
        lo = min(got[g, k], want[g, k])
        assert abs(u_abs[g, k] - cdf[lo]) <= 1e-6 * cdf[-1]


def test_draw_distribution_chi_square():
    """Many K5f-twin draws land within the chi-square band of the exact
    proportional distribution (as tests/test_device_sampling.py holds the
    JAX frontier)."""
    m = _fill(ShardedReplay)
    f = DeviceSampleFrontier.from_sharded(m, seed=7, device="cpu")
    p = _leaves(m) / _leaves(m).sum()
    bins = 32
    bin_of = (np.arange(p.size) * bins) // p.size
    counts = np.zeros(bins)
    batch = 50
    for _ in range(20_000 // (batch * f.draw_block)):
        np.add.at(counts, bin_of[f.draw(batch, 0.5, len(m)).idx.numpy().ravel()], 1)
    expected = np.zeros(bins)
    np.add.at(expected, bin_of, p)
    expected *= counts.sum()
    keep = expected > 0
    chi = float(((counts[keep] - expected[keep]) ** 2 / expected[keep]).sum())
    assert chi < 61.1, f"chi2 {chi:.1f} (df 31, alpha 0.001)"


def test_draw_twin_weights_follow_the_host_formula():
    p = torch.tensor([0.0, 0.5, 0.25, 0.25, 1.0, 0.0], dtype=torch.float32)
    u = torch.tensor([[0.1, 0.6], [0.9, 0.2]], dtype=torch.float32)
    idx, prob, weight = frontier_draw_plain(p, u, 0.5, 10)
    assert idx.dtype == torch.int32 and bool((p[idx.long()] > 0).all())
    want_prob = p[idx.long()].double() / 2.0
    np.testing.assert_allclose(prob.numpy(), want_prob.numpy(), **REL)
    w = (10 * want_prob) ** -0.5
    np.testing.assert_allclose(weight.numpy(), (w / w.max(dim=1, keepdim=True).values).numpy(),
                               **REL)
    assert torch.equal(weight.amax(dim=1), torch.ones(2))


# ------------------------------------------------------------- write-back
def test_update_matches_jax_with_zero_slots_and_dead_shards(use_native):
    (mj, fj), (mp, fp) = _pair(use_native, seed=4, dead=(1,))
    cap = mp.shard_capacity
    mirror = fp.mirror_np()
    rng = np.random.default_rng(5)
    eligible = rng.choice(np.flatnonzero(mirror > 0), 12, replace=False)
    zero = np.flatnonzero(mirror[:cap] == 0)[:4]
    idx = np.concatenate([eligible, zero, cap + np.arange(4)])  # no repeats
    td = (rng.normal(size=idx.size) * 2).astype(np.float32)  # |td| is taken
    fj.update(idx, td)
    fp.update(idx, td)
    got, want = fp.mirror_np(), np.asarray(fj.mirror)
    np.testing.assert_allclose(got, want, **REL)
    assert (got[zero] == 0).all() and (got[cap:] == 0).all()
    np.testing.assert_allclose(got[eligible], (np.abs(td[:12]) + 1e-6) ** 0.5, rtol=1e-6)


def test_update_writes_the_last_of_repeated_ids_and_never_resurrects():
    m = _fill(ShardedReplay, seed=6)
    f = DeviceSampleFrontier.from_sharded(m, device="cpu")
    before = f.mirror_np()
    live = np.flatnonzero(before > 0)[:3]
    dead = np.flatnonzero(before == 0)[:1]
    idx = np.array([live[0], live[1], live[0], dead[0], live[2], live[1]])
    td = np.array([0.5, 1.5, 2.5, 3.0, 0.25, 4.0], np.float32)
    f.update(torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(td))
    after = f.mirror_np()
    want = before.copy()
    for i, t in zip(idx, td):  # the host replay's sequential rule, fence read first
        if before[i] > 0:
            want[i] = np.float32((t + 1e-6) ** 0.5)
    np.testing.assert_allclose(after, want, **REL)
    assert after[dead[0]] == 0.0


# ------------------------------------------------------- staged appends
def test_appends_stage_the_same_mirror_as_jax(use_native):
    (mj, fj), (mp, fp) = _pair(use_native, seed=8, ticks=40)
    rng = np.random.default_rng(9)
    for t in range(100):  # wraps the 64-slot lanes of each shard
        tick = (rng.integers(0, 255, (4, *FRAME), dtype=np.uint8), rng.integers(0, 4, 4),
                rng.normal(size=4).astype(np.float32), rng.random(4) < 0.05)
        pri = None if t % 3 else rng.random(4) + 0.1
        mj.append_batch(*tick, priorities=pri)
        mp.append_batch(*tick, priorities=pri)
    fj.flush_staged()
    fp.flush_staged()
    np.testing.assert_array_equal(fp.mirror_np(), np.asarray(fj.mirror))
    np.testing.assert_array_equal(fp.mirror_np(), _leaves(mp).astype(np.float32))


def test_staged_flush_keeps_the_last_write_and_drops_dead_rows(use_native):
    (mj, fj), (mp, fp) = _pair(use_native, seed=10)
    cap = mp.shard_capacity
    for f in (fj, fp):
        f.on_drop(1)
        f.stage(np.array([3, 5, 3]), np.array([0.25, 0.5, 0.75]))
        f.stage(np.array([5, cap + 2]), np.array([1.25, 9.0]))
        f.flush_staged()
    got = fp.mirror_np()
    assert got[3] == 0.75 and got[5] == 1.25 and got[cap + 2] == 0.0
    np.testing.assert_array_equal(got, np.asarray(fj.mirror))


# ------------------------------------------------------------- elasticity
def test_drop_readmit_and_stale_rows():
    m = _fill(ShardedReplay)
    f = DeviceSampleFrontier.from_sharded(m, seed=9, device="cpu")
    cap = m.shard_capacity
    stamp_before = f.stamp
    shard1 = np.arange(cap, 2 * cap)
    m.drop_shard(1)
    mirror = f.mirror_np()
    assert (mirror[cap:] == 0).all() and (mirror[:cap] > 0).any()
    assert (f.draw(64, 0.5, len(m)).idx.numpy() < cap).all()
    f.update(shard1[:8], np.full(8, 5.0, np.float32))  # lagged: must not resurrect
    assert (f.mirror_np()[cap:] == 0).all()
    assert f.stale_rows(shard1[:8], stamp_before) == 8
    assert f.stale_rows(np.arange(8), stamp_before) == 0
    m.readmit_shard(1)
    s1 = m.shards[1]
    np.testing.assert_array_equal(f.mirror_np()[cap:],
                                  s1.tree.tree[s1.tree.span:s1.tree.span + cap].astype(np.float32))


def test_restore_refreshes_the_mirror(tmp_path):
    m = _fill(ShardedReplay)
    f = DeviceSampleFrontier.from_sharded(m, seed=1, device="cpu")
    f.update(np.arange(32), np.full(32, 3.0, np.float32))  # the mirror diverges
    epochs = f.stamp[0]
    m.snapshot(str(tmp_path / "snap"))
    m.restore(str(tmp_path / "snap"))
    np.testing.assert_array_equal(f.mirror_np(), _leaves(m).astype(np.float32))
    assert all(e == b + 1 for e, b in zip(f.stamp[0], epochs))


def test_reconcile_after_lagged_writebacks_matches_jax(use_native):
    """K = 2 lagged write-backs interleaved with appends, then reconcile on
    both sides: equal host trees and fresh-item defaults."""
    (mj, fj), (mp, fp) = _pair(use_native, seed=11, ticks=96)
    rng = np.random.default_rng(2)
    queue = []
    for step in range(12):
        pool = np.flatnonzero(fp.mirror_np() > 0)
        idx = rng.choice(pool, 16, replace=False)
        queue.append((idx, rng.random(16).astype(np.float32) + 0.01))
        if len(queue) > 2:
            r_idx, r_td = queue.pop(0)
            fj.update(r_idx, r_td)
            fp.update(r_idx, r_td)
        if step % 3 == 0:
            tick = (np.random.default_rng(1000).integers(0, 255, (4, *FRAME), dtype=np.uint8),
                    np.arange(4) % 4, np.ones(4, np.float32), np.zeros(4, bool))
            mj.append_batch(*tick, priorities=np.full(4, 0.3))
            mp.append_batch(*tick, priorities=np.full(4, 0.3))
    for r_idx, r_td in queue:
        fj.update(r_idx, r_td)
        fp.update(r_idx, r_td)
    fj.reconcile()
    assert fp.reconcile() >= 0.0 and fp.reconciles == 1
    np.testing.assert_allclose(_leaves(mp), _leaves(mj), **REL)
    for sp, sj in zip(mp.shards, mj.shards):
        assert sp.max_priority == pytest.approx(sj.max_priority, rel=1e-6)


# ---------------------------------------------------------- batch assembly
def test_batch_assembler_zeroes_invalidated_rows_as_jax_does(use_native):
    """Bit for bit on one core: the n-step reward is summed in the core's order."""
    _, _, JaxShardedReplay, _ = _jax()
    from rainbow_iqn_apex_tpu.replay.frontier import make_batch_assembler as jax_assembler

    mj = _fill(JaxShardedReplay, shards=1, cap=256, use_native=use_native)
    mp = _fill(ShardedReplay, shards=1, cap=256, use_native=use_native)
    reg = MetricRegistry()
    leaves = _leaves(mp)
    bad, good = np.flatnonzero(leaves == 0)[:4], np.flatnonzero(leaves > 0)[:4]
    idx = np.concatenate([good[:2], bad, good[2:]])  # unsorted on purpose
    weight = np.linspace(0.5, 1.0, 8).astype(np.float32)
    sample = make_batch_assembler(mp, registry=reg)(idx, weight)
    j_idx, j_batch = jax_assembler(mj, lambda s: s)(idx, weight)
    np.testing.assert_array_equal(sample.idx, j_idx)
    for field in ("obs", "next_obs", "action", "reward", "discount", "weight"):
        np.testing.assert_array_equal(getattr(sample, field), getattr(j_batch, field), field)
    bad_rows = np.isin(sample.idx, bad)
    assert (sample.weight[bad_rows] == 0).all() and (sample.weight[~bad_rows] > 0).all()
    assert reg.counter("sample_ahead_stale_indices_total", "prefetch").get() == 4


# -------------------------------------------------------------- the pusher
def test_pusher_serves_the_draws_in_request_order():
    """The batches are the ones a plain sequence of draws gives (the same
    generator stream, G rows per block, in order), whatever the worker's
    timing, and ceil(R / G) + draw_ahead blocks were drawn after R
    requests."""
    m, m2 = _fill(ShardedReplay, seed=12), _fill(ShardedReplay, seed=12)
    reg = MetricRegistry()
    f = DeviceSampleFrontier.from_sharded(m, registry=reg, seed=4, device="cpu")
    f2 = DeviceSampleFrontier.from_sharded(m2, seed=4, device="cpu")
    gets, batch, depth = 13, 16, 2
    pusher = SampleAheadPusher(f, make_batch_assembler(m, registry=reg), batch, lambda: 0.5,
                               lambda: len(m), torch.device("cpu"), depth=depth, registry=reg)
    try:
        served = [pusher.get(timeout=30) for _ in range(gets)]
    finally:
        pusher.close()
    requests = gets + depth
    assert pusher.blocks_drawn == math.ceil(requests / f.draw_block) + 2
    blocks = [f2.draw(batch, 0.5, len(m2)) for _ in range(pusher.blocks_drawn)]
    assemble = make_batch_assembler(m2)
    for j, (idx, b) in enumerate(served):
        blk = blocks[j // f.draw_block]
        want = assemble(blk.idx.numpy()[j % f.draw_block].astype(np.int64),
                        blk.weight.numpy()[j % f.draw_block])
        np.testing.assert_array_equal(idx, want.idx)
        assert b.idx.dtype == torch.int32 and (b.idx.numpy() == want.idx).all()
        assert torch.equal(b.obs, torch.from_numpy(want.obs))
        assert torch.equal(b.weight, torch.from_numpy(want.weight))
        assert float(b.weight.max()) == pytest.approx(1.0)
    assert reg.gauge("sample_ahead_queue_depth", "prefetch").get() >= 0


def test_wrappers_run_the_twins_on_cpu_without_counting():
    before = {k: launches[k] for k in NAMES}
    m = _fill(ShardedReplay, seed=13)
    f = DeviceSampleFrontier.from_sharded(m, device="cpu")
    blk = f.draw(8, 0.5, len(m))
    f.update(blk.idx[0], torch.rand(8))
    assert {k: launches[k] for k in NAMES} == before


# ------------------------------------------------- on the card: kernel vs twin
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _counted(name, fn):
    before = launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups", [(1000, 1), (4099, 8), (1_000_000, 8)])
def test_k5f_kernel_matches_twin_on_dyadic_priorities(cuda, n, groups):
    gen = torch.Generator(device=cuda).manual_seed(n + groups)
    p = torch.randint(0, 9, (n,), generator=gen, device=cuda).float() / 8
    p[: n // 2] = 0.0  # a dead shard's slice
    u = torch.rand((groups, 32), generator=gen, device=cuda)
    idx, prob, weight = _counted("K5f_frontier_draw", lambda: frontier_draw(p, u, 0.6, n / 3))
    w_idx, w_prob, w_weight = frontier_draw_plain(p, u, 0.6, n / 3)
    assert torch.equal(idx, w_idx)
    assert bool((p[idx.long()] > 0).all())
    for got, want in ((prob, w_prob), (weight, w_weight)):
        rel = ((got - want).abs() / want.abs()).max().item()
        assert rel <= 1e-6, rel


@pytest.mark.cuda
def test_k5f_kernel_matches_an_fp64_cdf_on_random_priorities(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 1_000_000
    p = torch.rand((n,), generator=gen, device=cuda)
    p[torch.rand((n,), generator=gen, device=cuda) < 0.3] = 0.0
    u = torch.rand((8, 32), generator=gen, device=cuda)
    idx, _, _ = frontier_draw(p, u, 0.4, n)
    cdf = torch.cumsum(p.double(), 0)
    u_abs = (torch.arange(32, device=cuda).double() + u.double()) / 32 * cdf[-1]
    ref = torch.searchsorted(cdf, u_abs, right=True).clamp(0, n - 1)
    differ = idx.long() != ref
    lo = torch.minimum(idx.long(), ref)[differ]
    assert bool(((u_abs[differ] - cdf[lo]).abs() <= 1e-6 * cdf[-1]).all())
    assert bool((p[idx.long()] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("omega", [0.5, 0.6])
def test_k6f_kernel_matches_twin_with_duplicates_and_zero_slots(cuda, omega):
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = torch.rand((4096,), generator=gen, device=cuda)
    idx = torch.randint(0, 40, (32,), generator=gen, device=cuda, dtype=torch.int32)
    p.index_fill_(0, idx[:6].long(), 0.0)
    td = torch.randn((32,), generator=gen, device=cuda) * 3
    got, want = p.clone(), p.clone()
    _counted("K6f_frontier_writeback", lambda: frontier_writeback(got, idx, td, 1e-6, omega))
    frontier_writeback_plain(want, idx, td, 1e-6, omega)
    torch.cuda.synchronize()
    if omega == 0.5:
        assert torch.equal(got, want)
    else:  # powf against torch.pow
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    assert bool((got[p == 0] == 0).all())


@pytest.mark.cuda
def test_frontier_kernels_refuse_what_they_do_not_take(cuda):
    p = torch.rand((100,), device=cuda)
    with pytest.raises(TypeError):
        frontier_draw(p.double(), torch.rand((1, 4), device=cuda), 0.5, 10)
    with pytest.raises(ValueError):
        frontier_draw(p, torch.rand((1, 2000), device=cuda), 0.5, 10)
    with pytest.raises(TypeError):
        frontier_writeback(p, torch.zeros(4, dtype=torch.int64, device=cuda),
                           torch.zeros(4, device=cuda), 1e-6, 0.5)
    with pytest.raises(ValueError):
        frontier_writeback(p, torch.zeros(4, dtype=torch.int32, device=cuda),
                           torch.zeros(5, device=cuda), 1e-6, 0.5)


def _queue(cuda, n, seed, omega=0.5, outside=False, hot=24):
    """8 write-back batches of 32 (repeated ids inside and across batches,
    zero slots, a NaN |td|) and 2 ticks of 16 staged rows, in the
    interleaving of the apex loop, ``hot`` ids a batch in the mirror's first
    chunk (24: 200 entries there, past the 128 that K5f's chunk block applies
    from shared memory; 12: 104, under them)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = MirrorQueue(1e-6, omega)
    for b in range(8):
        ids = torch.randint(0, 40, (32,), generator=gen, device=cuda, dtype=torch.int32)
        ids[hot:] = torch.randint(0, n, (32 - hot,), generator=gen, device=cuda, dtype=torch.int32)
        td = torch.randn((32,), generator=gen, device=cuda) * 3
        if b == 2:
            td[0] = float("nan")
        if outside and b == 5:
            ids[3], ids[9] = n, -2
        q.writeback(ids, td)
        if b in (3, 6):
            ids = torch.randperm(n, generator=gen, device=cuda)[:16].to(torch.int32)
            ids[:4] = torch.arange(4 * b, 4 * b + 4, device=cuda, dtype=torch.int32)
            q.stage(ids, torch.rand((16,), generator=gen, device=cuda) * 2)
    return q


def _in_range(q, n):
    """The queue without its ids outside [0, n) (what the kernels drop)."""
    out = MirrorQueue(q.eps, q.omega)
    for kind, ids, vals in q.segments:
        keep = (ids >= 0) & (ids < n)
        (out.stage if kind == 0 else out.writeback)(ids[keep].contiguous(),
                                                    vals[keep].contiguous())
    return out


def _mirror(cuda, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = torch.rand((n,), generator=gen, device=cuda)
    p[torch.rand((n,), generator=gen, device=cuda) < 0.2] = 0.0
    p[: n // 4] = 0.0
    p[:40:3] = 0.5  # the queue's first chunk: live and zero slots
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [24, 12])
@pytest.mark.parametrize("omega", [0.5, 0.6])
@pytest.mark.parametrize("n", [4099, 1_000_000])
def test_k5f_queue_mode_matches_the_twins_apply_then_draw(cuda, n, omega, hot):
    p, q = _mirror(cuda, n, n), _queue(cuda, n, n + 1, omega, hot=hot)
    u = torch.rand((8, 32), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    got, want = p.clone(), p.clone()
    k5f, k6f, fold = (launches["K5f_frontier_draw"], launches["K6f_frontier_writeback"],
                      folded["K6f_frontier_writeback"])
    drawn = frontier_draw(got, u, 0.6, n / 3, q)
    torch.cuda.synchronize()
    assert launches["K5f_frontier_draw"] == k5f + 1 and folded["K6f_frontier_writeback"] == fold + 1
    assert launches["K6f_frontier_writeback"] == k6f
    frontier_apply_plain(want, q)
    if omega == 0.5:
        assert torch.equal(got, want)
    else:  # powf against torch.pow
        torch.testing.assert_close(got, want, **REL)
        want = got.clone()
    again = frontier_draw(want, u, 0.6, n / 3)
    for a, b in zip(drawn, again):
        assert torch.equal(a, b)
    assert bool((got[drawn[0].long()] > 0).all())  # no zero slot drawn


@pytest.mark.cuda
@pytest.mark.parametrize("outside", [False, True], ids=["in_range", "outside"])
def test_k6f_queue_apply_matches_its_twin(cuda, outside):
    n = 4099
    p, q = _mirror(cuda, n, 11), _queue(cuda, n, 12, outside=outside)
    got, want = p.clone(), p.clone()
    _counted("K6f_frontier_writeback", lambda: frontier_apply(got, q))
    frontier_apply_plain(want, _in_range(q, n))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    chunked = p.clone()  # the same queue through K5f's chunk blocks
    frontier_draw(chunked, torch.rand((1, 4), device=cuda), 0.5, 10.0, q)
    torch.cuda.synchronize()
    assert torch.equal(chunked, got)

