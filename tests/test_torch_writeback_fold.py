"""The folded priority write-backs on the CPU: K6 inside K1's weighted launch
(the fused Anakin step) and K6f's queue of mirror updates inside K5f's draw
(the device sample frontier).

- The fused step with the write-back target (``build_device_learn``) against
  the jitted JAX fused step (1e-5 relative, as tests/test_torch_anakin.py),
  and bit for bit against the parent's route on the same states and draws:
  the learn step, then ``update_priorities_grouped`` (K1's twin, then K6's).
  G 1 and 4, a slot heavy enough to be drawn by several strata (repeated ids
  inside a group, and across groups: every group draws the same uniforms), a
  NaN reward on it (a NaN |TD|, so a later group's fence reads NaN and
  writes 0).
- The frontier, whose flushes and write-backs now queue for the next draw,
  against an eager reference that applies each operation at once as the
  parent did, over random interleavings (``hypothesis``) of appends (staged
  rows), write-backs (repeated ids, zero and dead slots, NaN |TD|), draws,
  shard drops and readmissions, refreshes, reconciles and direct ``.mirror``
  reads: mirrors, draws, weights and host trees bit for bit.  And against
  the JAX frontier on seeded interleavings, on dyadic priorities (omega 1,
  eps 0), where every cdf is exact: mirrors, draw ids, prob and weights.
- A numpy model of how K5f's chunk blocks apply the queue (each chunk's hits
  in shared memory, a write-back batch's last entry of a slot by an atomic
  maximum of (segment, entry), or, past 128 hits, segment by segment), held
  bit for bit to the queue applied segment after segment.  Applying a
  batch's entries one after another instead differs where a repeated id's
  earlier entry has a NaN |TD| (NaN > 0 is false): the kernels keep the
  batch's fence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rainbow_iqn_apex_tpu.ops import learn as jlearn
from rainbow_iqn_apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.kernels import folded, launches
from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import frontier_draw_plain
from rainbow_iqn_apex_tpu_torch.kernels.frontier_writeback import (
    STAGED,
    MirrorQueue,
    frontier_apply_plain,
    frontier_writeback_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import (
    quantile_huber_weighted,
    quantile_huber_weighted_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import (
    Writeback,
    priority_power,
    replay_writeback_plain,
)
from rainbow_iqn_apex_tpu_torch.ops import learn as plearn
from rainbow_iqn_apex_tpu_torch.parallel.sharded_replay import ShardedReplay
from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, build_device_learn
from rainbow_iqn_apex_tpu_torch.replay.frontier import DeviceSampleFrontier
from test_torch_anakin import (
    FRAME,
    GAMMA,
    HIST,
    INFO,
    NSTEP,
    PARAMS,
    A,
    B,
    L,
    S,
    _cfgs,
    _jax_args,
    _jax_fused,
    _jax_replay_state,
)
from test_torch_learn import NOISY, _adam, _port_draws, _to_np


@pytest.fixture(autouse=True)
def _few_threads():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# ------------------------------------------------- K6 in K1: the fused step
def _draws(cfg, feat, rng, rows):
    """The sampler's uniforms [B] (every group draws these) and the learn
    step's (taus, noise) over ``rows`` = G * B samples."""
    dims = [(feat, cfg.hidden_size), (cfg.hidden_size, 1), (feat, cfg.hidden_size),
            (cfg.hidden_size, A)]
    u = rng.random(B, dtype=np.float32)
    out = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        noise = {layer: (rng.standard_normal(i).astype(np.float32),
                         rng.standard_normal(o).astype(np.float32))
                 for layer, (i, o) in zip(NOISY, dims)}
        out[name] = (rng.random((rows, n), dtype=np.float32), noise)
    return u, out


def _heavy_ring(jds, nan_reward):
    """The JAX ring with one eligible slot holding most of the mass (drawn
    by several strata) and, optionally, a NaN reward at it."""
    pri = np.asarray(jds.priority).copy()
    slot = int(np.flatnonzero(pri > 0)[len(np.flatnonzero(pri > 0)) // 2])
    pri[slot] = 3.0 * pri.sum()
    rewards = np.asarray(jds.rewards).copy()
    if nan_reward:
        rewards.reshape(-1)[slot] = np.nan
    return jds.replace(priority=jnp.asarray(pri), rewards=jnp.asarray(rewards)), slot


@pytest.mark.parametrize("groups,nan_reward", [(1, False), (4, False), (1, True), (4, True)],
                         ids=["g1", "g4", "g1_nan", "g4_nan"])
def test_fused_step_with_the_fold_matches_jax_and_the_parents_route(monkeypatch, groups,
                                                                    nan_reward):
    jcfg, pcfg = _cfgs()
    jcfg, pcfg = jcfg.replace(sample_groups=groups), pcfg.replace(sample_groups=groups)
    jdev = JaxDeviceReplay(lanes=L, seg=S, frame_shape=FRAME, history=HIST, n_step=NSTEP,
                           gamma=GAMMA)
    pdev = DeviceReplay(lanes=L, seg=S, frame_shape=FRAME, history=HIST, n_step=NSTEP,
                        gamma=GAMMA, device="cpu")
    jds, heavy = _heavy_ring(_jax_replay_state(jdev), nan_reward)
    jts = jlearn.init_train_state(jcfg, A, jax.random.PRNGKey(0), state_shape=(*FRAME, HIST))
    adam = _adam(jts.opt_state)
    host = convert.from_flax_train_state(_to_np(jts.params), _to_np(jts.target_params),
                                         _to_np(adam.mu), _to_np(adam.nu), adam.count, jts.step)

    def port_state():
        return plearn.load_host_state(
            plearn.init_train_state(pcfg, A, seed=0, state_shape=(*FRAME, HIST), device="cpu"),
            host)

    pts, ref_ts = port_state(), port_state()
    pds = convert.from_jax_device_replay_state(jax.device_get(jds), device="cpu")
    ref_ds = pds.to("cpu")
    feat = jts.params["CosineTauEmbedding_0"]["embed"]["kernel"].shape[1]
    u, draws = _draws(pcfg, feat, np.random.default_rng(3 + groups), groups * B)
    beta = 0.5
    jts, jds, jinfo = _jax_fused(jcfg, jdev, monkeypatch)(
        jts, jds, jax.random.PRNGKey(0), jnp.float32(beta), *_jax_args(u, draws))
    u_all = torch.from_numpy(np.tile(u, (groups, 1)))
    before = (dict(launches), dict(folded))
    pts, pds, pinfo = build_device_learn(pcfg, A, pdev)(pts, pds, None, beta, u=u_all,
                                                        draws=_port_draws(draws))
    assert (dict(launches), dict(folded)) == before  # the CPU runs the twins and counts nothing

    # the parent's route: the learn step, then K6 (update_priorities_grouped)
    if groups > 1:
        idx, batch, _ = pdev.sample_grouped(ref_ds, B, groups, beta, None, u_all)
    else:
        idx, batch, _ = pdev.sample(ref_ds, B, beta, None, u_all)
        idx = idx.reshape(1, -1)
    assert bool((idx == heavy).sum(dim=1).ge(2).all())  # the heavy slot repeats in each group
    ref_ts, ref_info = plearn.build_learn_step(pcfg, A)(ref_ts, batch, None,
                                                        _port_draws(draws))
    pdev.update_priorities_grouped(ref_ds, idx, ref_info["priorities"])
    for key in ("loss", "priorities", "q_mean", "grad_norm"):
        assert _same(pinfo[key], ref_info[key]), key
    assert _same(pds.priority, ref_ds.priority) and _same(pds.max_priority, ref_ds.max_priority)
    for (name, got), want in zip(pts.net.state_dict().items(), ref_ts.net.state_dict().values()):
        assert _same(got, want), name

    # against JAX
    for key in ("loss", "priorities", "q_mean", "grad_norm"):
        np.testing.assert_allclose(pinfo[key].numpy(), np.asarray(jinfo[key]), err_msg=key,
                                   **INFO)
    np.testing.assert_allclose(pds.priority.numpy(), np.asarray(jds.priority), **INFO)
    np.testing.assert_allclose(pds.max_priority.numpy(), np.asarray(jds.max_priority), **INFO)
    want = convert.from_flax(_to_np(jts.params))
    for name, got in pts.net.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), err_msg=name, **PARAMS)
    assert bool(torch.isnan(pds.max_priority)) == nan_reward
    if nan_reward and groups > 1:  # group 0 wrote NaN there; group 1's fence read it: 0
        assert float(pds.priority[heavy]) == 0.0


def test_k1_twin_with_the_target_is_k1_then_k6():
    g = torch.Generator().manual_seed(2)
    online, taus, target = (torch.randn((8, 6), generator=g), torch.rand((8, 6), generator=g),
                            torch.randn((8, 5), generator=g))
    weight = torch.rand(8, generator=g)
    ring = torch.rand(20, generator=g)
    ring[[3, 7]] = 0.0
    ids = torch.tensor([[3, 5, 5, 9], [7, 5, 1, 5]], dtype=torch.int32)
    got, got_max = ring.clone(), torch.tensor(0.5)
    out = quantile_huber_weighted(online, taus, target, weight, None, 1.0,
                                  Writeback(got, got_max, ids, 1e-6, 0.5))
    ref = quantile_huber_weighted_plain(online, taus, target, weight, None, 1.0)
    want, want_max = ring.clone(), torch.tensor(0.5)
    replay_writeback_plain(want, want_max, ids, ref[2], 1e-6, 0.5)
    assert all(_same(a, b) for a, b in zip(out, ref))
    assert _same(got, want) and _same(got_max, want_max)
    assert float(got[3]) == 0.0 and float(got[7]) == 0.0  # fenced


# --------------------------------------------- K6f's queue: the frontier
FRAME_F = (10, 10)
SHARDS, CAP, LANES = 2, 256, 4


def _memory(seed, omega=0.5, eps=1e-6, dyadic=False, cls=ShardedReplay, ticks=40):
    m = cls.build(SHARDS, SHARDS * CAP, LANES, frame_shape=FRAME_F, history=2, n_step=2,
                  gamma=0.9, priority_exponent=omega, priority_eps=eps, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(ticks):
        _append(m, rng, dyadic)
    return m


def _tick(rng, dyadic):
    pri = (rng.integers(1, 9, LANES) / 8.0) if dyadic else rng.random(LANES) + 0.05
    return (rng.integers(0, 255, (LANES, *FRAME_F), dtype=np.uint8), rng.integers(0, 4, LANES),
            rng.normal(size=LANES).astype(np.float32), rng.random(LANES) < 0.05, pri)


def _append(m, rng, dyadic):
    frames, actions, rewards, terms, pri = _tick(rng, dyadic)
    m.append_batch(frames, actions, rewards, terms, priorities=pri)


class EagerFrontier(DeviceSampleFrontier):
    """The parent's frontier: every flush and write-back applied at once
    (an index_copy_ and K6f's twin), the draw on the mirror as it stands."""

    def update(self, idx, td_abs) -> None:
        self.flush_staged()
        frontier_writeback_plain(self._mirror, self._as_device(idx, torch.int32),
                                 self._as_device(td_abs, torch.float32), self.eps, self.omega)

    def flush_staged(self) -> None:
        if not self._pending:
            return
        pending, self._pending, self._pending_rows = self._pending, [], 0
        idx = np.concatenate([i for i, _ in pending])
        vals = np.concatenate([v for _, v in pending])
        _, last_pos = np.unique(idx[::-1], return_index=True)
        keep = idx.size - 1 - last_pos
        idx, vals = idx[keep], vals[keep]
        if self._dead:
            alive = ~np.isin(idx // self.cap, sorted(self._dead))
            idx, vals = idx[alive], vals[alive]
        if idx.size:
            self._mirror.index_copy_(0, torch.from_numpy(idx), torch.from_numpy(vals))

    def draw(self, batch_size, beta, n_items, groups=None, uniforms=None):
        self.flush_staged()
        u = torch.as_tensor(np.asarray(uniforms, np.float32))
        return frontier_draw_plain(self._mirror, u, beta, max(n_items, 1))


def _ops_strategy():
    op = st.one_of(
        st.tuples(st.just("append"), st.integers(1, 3)),
        st.tuples(st.just("update"), st.integers(0, 2 ** 31 - 1)),
        st.tuples(st.just("draw"), st.integers(0, 2 ** 31 - 1)),
        st.tuples(st.just("drop"), st.integers(0, SHARDS - 1)),
        st.tuples(st.just("readmit"), st.integers(0, SHARDS - 1)),
        st.tuples(st.just("refresh"), st.just(0)),
        st.tuples(st.just("reconcile"), st.just(0)),
        st.tuples(st.just("read"), st.just(0)),
    )
    return st.lists(op, min_size=1, max_size=40)


def _update_args(seed, mirror):
    """A write-back batch of 8: repeated ids, live, zero and dead slots, a
    NaN |TD| now and then."""
    rng = np.random.default_rng(seed)
    live, zero = np.flatnonzero(mirror > 0), np.flatnonzero(mirror == 0)
    pool = np.concatenate([rng.choice(live, 5) if live.size else [],
                           rng.choice(zero, 1) if zero.size else [],
                           rng.integers(0, mirror.size, 2)]).astype(np.int32)
    idx = rng.choice(pool, 8)
    td = (rng.normal(size=8) * 2).astype(np.float32)
    if rng.random() < 0.3:
        td[rng.integers(8)] = np.nan
    return idx, td


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_ops_strategy())
def test_queued_frontier_equals_the_eager_reference(ops):
    mq, me = _memory(5), _memory(5)
    fq = DeviceSampleFrontier.from_sharded(mq, seed=1, device="cpu")
    fe = EagerFrontier.from_sharded(me, seed=1, device="cpu")
    rng_q, rng_e = np.random.default_rng(9), np.random.default_rng(9)
    for kind, arg in ops:
        if kind == "append":
            for _ in range(arg):
                _append(mq, rng_q, False)
                _append(me, rng_e, False)
        elif kind == "update":
            idx, td = _update_args(arg, fe.mirror_np())
            # the learner's tensors on the queued side: the queue holds them
            fq.update(torch.from_numpy(idx), torch.from_numpy(td))
            fe.update(idx, td)
        elif kind == "draw":
            u = np.random.default_rng(arg).random((2, 8), dtype=np.float32)
            got = fq.draw(8, 0.5, len(mq), groups=2, uniforms=u)
            idx, prob, weight = fe.draw(8, 0.5, len(me), uniforms=u)
            assert torch.equal(got.idx, idx) and _same(got.prob, prob)
            assert _same(got.weight, weight)
        elif kind == "drop":
            if arg in mq.dead_shards or len(mq.dead_shards) < SHARDS - 1:  # one survives
                mq.drop_shard(arg)
                me.drop_shard(arg)
        elif kind == "readmit":
            if arg in mq.dead_shards:
                mq.readmit_shard(arg)
                me.readmit_shard(arg)
        elif kind == "refresh":
            fq.refresh_from_host()
            fe.refresh_from_host()
        elif kind == "reconcile":
            fq.reconcile()
            fe.reconcile()
            for sq, se in zip(mq.shards, me.shards):
                assert np.array_equal(sq.tree.tree, se.tree.tree)
                assert sq.max_priority == se.max_priority
        else:  # a direct read of the tensor, as the tests and chip_smoke.py do
            assert _same(fq.mirror, fe.mirror)
    assert _same(fq.mirror, fe.mirror)
    assert np.array_equal(fq.mirror_np(), fe.mirror_np(), equal_nan=True)


def _jax_draw_uniforms(fj, groups, batch):
    """The uniforms the JAX frontier's next draw takes from its key."""
    _, sub = jax.random.split(fj._key)
    return np.asarray(jax.random.uniform(sub, (groups, batch)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queued_frontier_matches_jax_on_dyadic_interleavings(seed):
    """omega 1 and eps 0 with dyadic |TD| and append priorities keep every
    priority, sum and cdf exact in fp32 on both sides."""
    from rainbow_iqn_apex_tpu.parallel.sharded_replay import ShardedReplay as JaxShardedReplay
    from rainbow_iqn_apex_tpu.replay.frontier import DeviceSampleFrontier as JaxFrontier

    kw = dict(omega=1.0, eps=0.0, dyadic=True)
    mj, mp = _memory(seed, cls=JaxShardedReplay, **kw), _memory(seed, **kw)
    fj = JaxFrontier.from_sharded(mj, seed=seed)
    fp = DeviceSampleFrontier.from_sharded(mp, seed=seed, device="cpu")
    rng = np.random.default_rng(100 + seed)
    rng_j, rng_p = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
    draws = 0
    for step in range(24):
        kind = rng.choice(["append", "update", "update", "draw", "drop", "readmit", "reconcile"])
        if kind == "append":
            _append(mj, rng_j, True)
            _append(mp, rng_p, True)
        elif kind == "update":
            mirror = fp.mirror_np()
            live = np.flatnonzero(mirror > 0)
            idx = np.concatenate([rng.choice(live, 6), np.flatnonzero(mirror == 0)[:2]])
            idx = idx.astype(np.int32)
            # no repeats: JAX leaves their order open
            idx = np.unique(idx)
            td = (rng.integers(0, 9, idx.size) / 8.0).astype(np.float32)
            fj.update(idx, td)
            fp.update(torch.from_numpy(idx), torch.from_numpy(td))
        elif kind == "draw":
            u = _jax_draw_uniforms(fj, 2, 8)
            bj = fj.draw(8, 0.5, len(mj), groups=2)
            bp = fp.draw(8, 0.5, len(mp), groups=2, uniforms=u)
            np.testing.assert_array_equal(bp.idx.numpy(), np.asarray(bj.idx))
            np.testing.assert_allclose(bp.prob.numpy(), np.asarray(bj.prob), rtol=1e-6)
            np.testing.assert_allclose(bp.weight.numpy(), np.asarray(bj.weight), rtol=1e-6)
            draws += 1
        elif kind == "drop":
            k = int(rng.integers(SHARDS))
            if k in mp.dead_shards or len(mp.dead_shards) < SHARDS - 1:  # one survives
                mj.drop_shard(k)
                mp.drop_shard(k)
        elif kind == "readmit":
            for k in list(mp.dead_shards):
                mj.readmit_shard(k)
                mp.readmit_shard(k)
        else:
            fj.reconcile()
            fp.reconcile()
        if step % 4 == 3:  # a read applies the queue: let it grow in between
            np.testing.assert_array_equal(fp.mirror_np(), np.asarray(fj.mirror_np()),
                                          err_msg=f"step {step} ({kind})")
    np.testing.assert_array_equal(fp.mirror_np(), np.asarray(fj.mirror_np()))
    assert draws >= 1


# ------------------------------------- the chunk blocks' apply, in numpy
def _queue_of(rng, n, batches=8, batch=32, hot=16, staged_every=4):
    """The apex loop's queue between two draws: write-back batches (``hot``
    ids of each in the first 48 slots: repeats inside and across batches),
    a NaN |TD| in one, and a staged tick every ``staged_every`` batches."""
    q = MirrorQueue(1e-6, 0.5)
    for b in range(batches):
        ids = rng.integers(0, n, batch)
        ids[:hot] = rng.integers(0, 48, hot)
        td = (rng.normal(size=batch) * 2).astype(np.float32)
        if b == 2:
            td[1] = np.nan
        q.writeback(torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(td))
        if b % staged_every == staged_every - 1:
            rows = rng.permutation(n)[:16].astype(np.int32)
            rows[:4] = np.arange(4 * b, 4 * b + 4)
            q.stage(torch.from_numpy(rows), torch.from_numpy(rng.random(16).astype(np.float32)))
    return q


def _chunk_model(mirror, q, chunk=1024, cap=128):
    """K5f's first launch in queue mode (csrc/replay_draw.cu), chunk by chunk:
    the hits of a chunk, then apply_hits (at most ``cap`` hits) or
    apply_segment over the touched segments (csrc/writeback.cuh)."""
    p = mirror.numpy().copy()
    # a write-back's values are its priorities, formed as the twin forms them
    # (the twin's rounding: the card's is held to it on card tensors)
    segs = [(kind, ids.numpy(), vals.numpy() if kind == STAGED
             else priority_power(vals.abs() + q.eps, q.omega).numpy())
            for kind, ids, vals in q.segments]
    for lo in range(0, p.size, chunk):
        hi = min(lo + chunk, p.size)
        hits = [(s, k, int(slot)) for s, (_, ids, _) in enumerate(segs)
                for k, slot in enumerate(ids) if lo <= slot < hi]
        if not hits:
            continue
        c = p[lo:hi].copy()
        if len(hits) <= cap:
            owner = np.full(hi - lo, -1, np.int64)
            for s in sorted({h[0] for h in hits}):
                mine = [(k, slot) for hs, k, slot in hits if hs == s]
                kind, _, vals = segs[s]
                if kind == STAGED:
                    for k, slot in mine:
                        c[slot - lo] = vals[k]
                    continue
                cur = {}
                for k, slot in mine:  # every entry's atomic maximum and fence read
                    owner[slot - lo] = max(owner[slot - lo], (s << 16) | k)
                    cur[k] = c[slot - lo]
                for k, slot in mine:
                    if owner[slot - lo] == (s << 16) | k:
                        c[slot - lo] = vals[k] if cur[k] > 0 else np.float32(0)
        else:
            for s in sorted({h[0] for h in hits}):
                kind, ids, vals = segs[s]
                inside = [(k, int(slot)) for k, slot in enumerate(ids) if lo <= slot < hi]
                if kind == STAGED:
                    for k, slot in inside:
                        c[slot - lo] = vals[k]
                    continue
                fence = {k: c[slot - lo] for k, slot in inside}
                for k, slot in inside:  # no later entry of the batch holds the slot
                    if slot not in ids[k + 1:]:
                        c[slot - lo] = vals[k] if fence[k] > 0 else np.float32(0)
        p[lo:hi] = c
    return p


@pytest.mark.parametrize("hot,cap", [(16, 128), (16, 8), (0, 128), (30, 128)],
                         ids=["hits", "past_the_cap", "spread", "hot_chunk_past_the_cap"])
def test_the_chunk_blocks_apply_equals_the_segments_one_after_another(hot, cap):
    rng = np.random.default_rng(hot + cap)
    n = 3000
    mirror = torch.from_numpy(rng.random(n).astype(np.float32))
    mirror[torch.from_numpy(rng.random(n) < 0.3)] = 0.0
    mirror[:48:3] = 0.0  # fenced slots among the hot ids
    q = _queue_of(rng, n, hot=hot)
    want = mirror.clone()
    frontier_apply_plain(want, q)
    assert np.array_equal(_chunk_model(mirror, q, cap=cap), want.numpy(), equal_nan=True)
    # and the draw after it: K5f's twin with the queue is the apply, then the draw
    u = torch.from_numpy(rng.random((2, 8)).astype(np.float32))
    got_m = mirror.clone()
    got = frontier_draw_plain(got_m, u, 0.5, 100.0, q)
    ref = frontier_draw_plain(want.clone(), u, 0.5, 100.0)
    assert _same(got_m, want) and all(_same(a, b) for a, b in zip(got, ref))


def test_entry_by_entry_apply_differs_from_the_batch_fence_on_a_nan():
    """Slot 3 twice in one batch, its first |TD| NaN: the batch fence reads
    the slot from before the batch (> 0) and the last entry writes its
    priority; one entry after another, the first writes NaN, the second's
    fence reads NaN (NaN > 0 is false) and writes 0."""
    mirror = torch.tensor([0.5, 0.5, 0.5, 0.5], dtype=torch.float32)
    ids = torch.tensor([3, 1, 3], dtype=torch.int32)
    td = torch.tensor([float("nan"), 0.25, 0.64], dtype=torch.float32)
    batch = mirror.clone()
    frontier_writeback_plain(batch, ids, td, 0.0, 0.5)
    one_by_one = mirror.clone()
    for k in range(3):
        frontier_writeback_plain(one_by_one, ids[k:k + 1], td[k:k + 1], 0.0, 0.5)
    assert float(batch[3]) == pytest.approx(0.8) and float(one_by_one[3]) == 0.0
    model = _chunk_model(mirror, _one(ids, td), chunk=4)
    assert np.array_equal(model, batch.numpy())


def _one(ids, td):
    q = MirrorQueue(0.0, 0.5)
    q.writeback(ids, td)
    return q


def test_priority_power_is_the_kernels_square_root_at_one_half():
    x = torch.rand(64) + 1e-6
    assert torch.equal(priority_power(x, 0.5), torch.sqrt(x))
