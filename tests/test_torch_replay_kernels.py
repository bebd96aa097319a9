"""The device replay's kernels (rainbow_iqn_apex_tpu_torch.kernels): K5 PER
draw, K6 fenced write-back, K7 append, K8 assembly.  Torch only, so that
the ``cuda`` tests run on a machine without JAX
(``python -m pytest tests/test_torch_replay_kernels.py -m cuda --noconftest``);
the twins are held against the JAX DeviceReplay in
tests/test_torch_device_replay.py.

On the CPU each wrapper runs its plain twin and counts no launch, and the
twins keep the replay's rules against small oracles written out in Python:
the clip of a u that rounds up to the total, zero slots never drawn, the
last occurrence of a duplicate id written, group order, the fence.  K7's
and K8's launch plans (pure Python) are checked there too: every 16-byte
vector covered once, and K8's copy blocks filling the card at B 32.

The ``cuda``-marked tests hold each kernel against its twin on the card:
slot ids exactly on dyadic priorities (an exact cdf in any summation
order), and on random priorities against an fp64 cdf, where an id may
differ only when u lies within 1e-6 * sum p of a cdf boundary; uint8
frames, ids, actions and flags exactly; the priority vector exactly against
the twin run on the same card tensors (the same fp32 square root and the
same fence; torch's CPU square root can round the last bit the other way);
f32 reward, prob and weight to 1e-6 relative (powf against torch.pow, a
different summation order of the priorities).  K7 and K8 also at their
grids' edges (10 x 10 frames, 40 lanes, history 1 and 7, n_step 1 and 5,
groups of 48, draws at the write cursor, a NaN actor priority), and each
repeated launch bit-equal to the first.  K6 folded into K1's weighted
launch (the fused Anakin step's route) bit-equal to the parent's route on
the card, K1's launch and then K6's, and its ring to K6's twin on the
launch's own td_abs (G 1-4, repeated ids, zero slots, a NaN td, ids
outside the ring).
"""

import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu_torch.kernels import folded, launches
from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import frontier_draw
from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import quantile_huber_weighted
from rainbow_iqn_apex_tpu_torch.kernels.replay_append import (
    append_plan,
    replay_append,
    replay_append_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.replay_assemble import (
    VEC_MAX,
    assemble_plan,
    replay_assemble,
    replay_assemble_plain,
)
from rainbow_iqn_apex_tpu_torch.kernels.replay_draw import replay_draw, replay_draw_plain
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import (
    Writeback,
    replay_writeback,
    replay_writeback_plain,
)
from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay

REL = dict(rtol=1e-6, atol=0.0)
NAMES = ("K5_replay_draw", "K6_replay_writeback", "K7_replay_append", "K8_replay_assemble")


def _replay(lanes=3, seg=16, frame=(10, 10), history=3, n_step=2, device="cpu"):
    return DeviceReplay(lanes=lanes, seg=seg, frame_shape=frame, history=history,
                        n_step=n_step, gamma=0.9, device=device)


def _tick(rng, lanes, frame, p_term=0.1, p_trunc=0.08, actor=True):
    term = rng.random(lanes) < p_term
    return (torch.from_numpy(rng.integers(0, 256, (lanes, *frame), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 18, lanes).astype(np.int32)),
            torch.from_numpy(rng.normal(size=lanes).astype(np.float32)),
            torch.from_numpy(term), torch.from_numpy((rng.random(lanes) < p_trunc) & ~term),
            torch.from_numpy(rng.random(lanes).astype(np.float32) * 2) if actor else None)


def _filled(replay, ticks, seed=0, actor=True):
    rng = np.random.default_rng(seed)
    state = replay.init_state()
    for _ in range(ticks):
        replay.append(state, *_tick(rng, replay.lanes, replay.frame_shape, actor=actor))
    return state


# ------------------------------------------------------------ CPU: the twins
def test_wrappers_run_the_twins_on_cpu_without_counting():
    before = {k: launches[k] for k in NAMES}
    replay = _replay()
    state = _filled(replay, 20)
    idx, batch, _prob = replay.sample_grouped(state, 4, 2, 0.5)
    replay.update_priorities_grouped(state, idx, torch.rand(8))
    replay.assemble(state, idx.reshape(-1), 0.5)
    assert batch.obs.shape == (8, 10, 10, 3) and batch.obs.dtype == torch.uint8
    assert {k: launches[k] for k in NAMES} == before


def test_draw_twin_clips_a_u_at_the_total_and_skips_zero_slots():
    p = torch.tensor([0.0, 0.5, 0.0, 0.25, 0.25, 0.0], dtype=torch.float32)
    u = torch.tensor([[0.0, 0.5, 0.99, 1.0 - 2.0 ** -24]], dtype=torch.float32)
    idx, total = replay_draw_plain(p, u)
    # strata of width 0.25: u = 0, 0.375, 0.7475, 1.0 (rounded up to the total)
    assert float(total) == 1.0
    assert idx.tolist() == [[1, 1, 3, 5]]  # the last is the clip onto N - 1 (p = 0 there)
    idx, _ = replay_draw_plain(p, torch.rand((3, 4), generator=torch.Generator().manual_seed(0)))
    assert bool((p[idx[:, :3].long()] > 0).all())


def _writeback_oracle(p, max_p, idx, td, eps, omega):
    """The host replay's rule, group after group, as plain Python."""
    p = [float(x) for x in p]
    pri = [[(float(t) + eps) ** omega for t in row] for row in td]
    max_p = max([max_p] + [x for row in pri for x in row])
    for ids, row in zip(idx, pri):
        fence = [p[i] > 0 for i in ids]  # read before the group writes
        for i, ok, x in zip(ids, fence, row):
            p[i] = np.float32(x) if ok else 0.0
    return np.asarray(p, np.float32), max_p


@pytest.mark.parametrize("omega", [0.5, 0.6])
def test_writeback_twin_keeps_order_fence_and_last_occurrence(omega):
    rng = np.random.default_rng(1)
    p = rng.random(12).astype(np.float32)
    p[[2, 7]] = 0.0
    idx = np.array([[2, 3, 3, 5], [7, 5, 3, 1], [5, 5, 2, 9]], np.int32)
    td = rng.random((3, 4)).astype(np.float32) * 4
    want, want_max = _writeback_oracle(p, 1.25, idx, td, 1e-6, omega)
    got = torch.from_numpy(p.copy())
    got_max = torch.tensor(1.25)
    replay_writeback_plain(got, got_max, torch.from_numpy(idx), torch.from_numpy(td.reshape(-1)),
                           1e-6, omega)
    np.testing.assert_allclose(got.numpy(), want, **REL)
    assert got[2] == 0 and got[7] == 0
    assert float(got_max) == pytest.approx(want_max, rel=1e-6)


def test_append_twin_truncation_window_is_ineligible():
    """A transition whose n-step window's first cut is a truncation stays
    at priority 0; a terminal first keeps it eligible."""
    replay = _replay(lanes=2, seg=24, n_step=2)
    state = replay.init_state()
    rng = np.random.default_rng(2)
    for t in range(24):
        frames, actions, rewards, _, _, pri = _tick(rng, 2, (10, 10))
        term = torch.tensor([False, t == 10])
        trunc = torch.tensor([t == 10, False])
        replay.append(state, frames, actions, rewards, term, trunc, pri)
    pri = state.priority.numpy()
    assert np.all(pri[10 - 2 + 1:11] == 0.0)  # lane 0, windows covering tick 10
    assert np.all(pri[24 + 10 - 2 + 1:24 + 11] > 0.0)  # lane 1, a terminal there


def test_append_twin_max_priority_insertion_and_actor_maximum():
    replay = _replay(n_step=2)
    state = _filled(replay, 10, actor=False)
    assert float(state.max_priority) == 1.0
    eligible = state.priority[state.priority > 0]
    assert eligible.numel() > 0 and bool((eligible == 1.0).all())
    frames, actions, rewards, term, trunc, _ = _tick(np.random.default_rng(3), 3, (10, 10))
    replay.append(state, frames, actions, rewards, term, trunc, torch.tensor([0.0, 8.0, 1.0]))
    assert float(state.max_priority) == pytest.approx((8.0 + 1e-6) ** 0.5, rel=1e-6)


# ------------------------------------------------- K7's and K8's launch plans
def _k8_vectors(plan, vectors):
    """Every 16-pixel vector index each (run, thread, i) of a stack takes, as
    copy_chunk indexes them."""
    chunks, per_chunk, threads = plan
    taken = []
    for c in range(chunks):
        v0, v_end = c * per_chunk, min(c * per_chunk + per_chunk, vectors)
        for t in range(threads):
            taken += [q for q in (v0 + t + i * threads for i in range(VEC_MAX)) if q < v_end]
        assert v_end > v0, "an empty run"
    return taken


@pytest.mark.parametrize("draws,hw", [(32, 84 * 84), (32, 80 * 80), (128, 84 * 84), (48, 100),
                                      (1, 84 * 84), (1, 1), (3, 17), (1024, 84 * 84),
                                      (2, 256 * 256)])
@pytest.mark.parametrize("sms", [132, 1])
def test_k8_plan_covers_every_vector_of_a_stack_once(draws, hw, sms):
    chunks, per_chunk, threads = plan = assemble_plan(draws, hw, sms)
    vectors = -(-hw // 16)
    assert sorted(_k8_vectors(plan, vectors)) == list(range(vectors))
    assert threads % 32 == 0 and 32 <= threads <= 256 and per_chunk <= VEC_MAX * threads


@pytest.mark.parametrize("hw", [84 * 84, 80 * 80])
@pytest.mark.parametrize("groups", [1, 4])
def test_k8_plan_gives_every_sm_two_copy_blocks_at_b32(hw, groups):
    chunks, _, _ = assemble_plan(32 * groups, hw, 132)
    assert 2 * 32 * groups * chunks >= 2 * 132


@pytest.mark.parametrize("lanes,hw", [(16, 84 * 84), (16, 80 * 80), (40, 100), (3, 100), (1, 1),
                                      (256, 84 * 84)])
def test_k7_plan_covers_every_vector_once(lanes, hw):
    blocks, threads, per_thread = append_plan(lanes, hw)
    units = lanes * -(-hw // 16)
    taken = [u for b in range(blocks) for t in range(threads) for i in range(per_thread)
             if (u := b * threads * per_thread + t + i * threads) < units]
    assert sorted(taken) == list(range(units))
    assert threads % 32 == 0 and 32 <= threads <= 256 and 1 <= per_thread <= 4
    assert (blocks - 1) * threads * per_thread < units  # no idle copy block


# ------------------------------------------ K5's cdf, modelled in numpy
F32 = np.float32


def _k5_levels(x):
    """csrc/replay_draw.cu's tile_scan over tiles x [t, 1024] f32: each
    thread's running sum r [t, 256, 4] over its four values, and the offsets
    L (the lanes before it in its warp) and W (the warps before it), each a
    fold from 0 in order, so that a value within the tile is W + (L + r)."""
    t = x.shape[0]
    r = np.cumsum(x.reshape(t, 256, 4), axis=2, dtype=F32)  # add.accumulate: in order
    lane_last = r[:, :, 3].reshape(t, 8, 32)
    lanes = np.cumsum(lane_last, axis=2, dtype=F32)
    L = np.concatenate([np.zeros((t, 8, 1), F32), lanes[:, :, :-1]], axis=2)
    warp_last = L[:, :, 31] + lane_last[:, :, 31]
    W = np.concatenate([np.zeros((t, 1), F32), np.cumsum(warp_last, axis=1, dtype=F32)[:, :-1]],
                       axis=1)
    return r, L.reshape(t, 256), np.repeat(W, 32, axis=1)


def _k5_cdf(p):
    """The kernel's fp32 cdf of p [N] and its total: the chunk-local levels,
    then the same levels over the chunk sums in tiles of 1,024 chunks chained
    by T, cdf = T + (W' + (L' + (R' + local)))."""
    n = p.size
    chunks = -(-n // 1024)
    x = np.zeros(chunks * 1024, F32)
    x[:n] = p
    r, L, W = _k5_levels(x.reshape(chunks, 1024))
    local = (W[:, :, None] + (L[:, :, None] + r)).reshape(chunks, 1024)
    tiles = -(-chunks // 1024)
    sums = np.zeros(tiles * 1024, F32)
    sums[:chunks] = local[:, -1]
    cr, cL, cW = _k5_levels(sums.reshape(tiles, 1024))
    cR = np.concatenate([np.zeros((tiles, 256, 1), F32), cr[:, :, :3]], axis=2)
    ends = cW[:, :, None] + (cL[:, :, None] + cr)
    T = np.zeros(tiles + 1, F32)
    for t in range(tiles):
        T[t + 1] = T[t] + ends[t, -1, -1]
    per_chunk = [np.broadcast_to(a, (tiles, 256, 4)).reshape(-1)[:chunks, None] for a in
                 (T[:tiles, None, None], cW[:, :, None], cL[:, :, None], cR)]
    cT, cW, cL, cR = per_chunk
    cdf = cT + (cW + (cL + (cR + local)))
    return cdf.reshape(-1)[:n], T[tiles]


def _k5_draw(p, u):
    """The kernel's ids for uniforms u [G, B] under the modelled cdf."""
    cdf, total = _k5_cdf(p)
    batch = u.shape[1]
    ua = (np.arange(batch, dtype=F32) + u) / F32(batch) * total
    return np.minimum(np.searchsorted(cdf, ua, side="right"), p.size - 1), total, ua


def _adversarial(n, seed, dyadic=False):
    """Priorities that press on the cdf: log-uniform over 2^-60 .. 2^20 (or
    dyadic eighths), one huge slot followed by tiny ones, and runs of zeros
    across a thread's four slots, a warp's 128, a chunk's 1,024 and the chunk
    level's thread (four chunks) and warp (128 chunks) boundaries, at both
    ends too."""
    rng = np.random.default_rng(seed)
    if dyadic:
        p = rng.integers(0, 9, n).astype(F32) / 8
    else:
        p = np.exp2(rng.uniform(-60, 20, n)).astype(F32)
        big = n // 3
        p[big] = 2.0 ** 20
        p[big + 1:big + 3000] = np.exp2(rng.uniform(-60, -30, 2999)).astype(F32)
    for start, length in ((4 * 37 - 2, 5), (128 * 11 - 3, 7), (1024 * 5 - 9, 20),
                          (1024 * 4 * 3 - 700, 1400), (1024 * 128 - 1500, 2600),
                          (1024 * 9, 1024)):
        p[start % n:start % n + length] = 0.0
    p[:3] = 0.0
    p[-5:] = 0.0
    return p


@pytest.mark.parametrize("n", [5000, 1_000_000, 1_100_000])
@pytest.mark.parametrize("dyadic", [False, True], ids=["log_uniform", "dyadic"])
def test_k5_scan_model_is_monotone_keeps_zero_slots_and_is_exact_on_dyadic(n, dyadic):
    """The kernel's summation order, in numpy on the adversarial priorities:
    the cdf never decreases, a zero slot repeats its left neighbour's value
    (so a right search never lands on it), and on dyadic priorities the cdf
    is the exact cumsum and the searches are replay_draw_plain's.  1,100,000
    slots take two tiles of chunk sums (the T chain)."""
    p = _adversarial(n, n + int(dyadic), dyadic)
    cdf, total = _k5_cdf(p)
    assert cdf.dtype == F32 and total == cdf[-1]
    assert bool(np.all(np.diff(cdf) >= 0))
    zero = np.flatnonzero(p == 0)
    assert cdf[0] == 0.0 and bool(np.all(cdf[zero[zero > 0]] == cdf[zero[zero > 0] - 1]))
    u = np.random.default_rng(n).random((4, 32), dtype=F32)
    u[-1, -1] = 1.0 - 2.0 ** -24  # rounds u up to the total: clipped onto N - 1
    ids, _, ua = _k5_draw(p, u)
    assert ids[-1, -1] == n - 1 and bool((p[ids[:, :-1]] > 0).all())
    exact = np.cumsum(p.astype(np.float64))
    if dyadic:
        assert np.array_equal(cdf.astype(np.float64), exact)
        want, want_total = replay_draw_plain(torch.from_numpy(p), torch.from_numpy(u))
        assert float(want_total) == float(total)
        assert np.array_equal(ids, want.numpy())
    else:  # against an fp64 cdf: ids differ only within K5_BOUNDARY * total of a boundary
        ref = np.minimum(np.searchsorted(exact, ua.astype(np.float64), side="right"), n - 1)
        differ = ids != ref
        lo = np.minimum(ids, ref)[differ]
        assert bool(np.all(np.abs(ua[differ] - exact[lo]) <= 1e-6 * float(total)))


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
@pytest.mark.parametrize("n", [1_000_000, 5000, 700])
@pytest.mark.parametrize("groups", [1, 4])
def test_k5_kernel_matches_twin_exactly_on_dyadic_priorities(cuda, n, groups):
    gen = torch.Generator(device=cuda).manual_seed(n + groups)
    p = torch.randint(0, 9, (n,), generator=gen, device=cuda).float() / 8
    p[-3:] = 0.0
    u = torch.rand((groups, 32), generator=gen, device=cuda)
    u[-1, -1] = 1.0 - 2.0 ** -24  # rounds u up to the total: clipped onto N - 1
    idx, total = _counted("K5_replay_draw", lambda: replay_draw(p, u))
    want_idx, want_total = replay_draw_plain(p, u)
    assert float(total) == float(want_total)
    assert torch.equal(idx, want_idx)
    assert int(idx[-1, -1]) == n - 1
    assert bool((p[idx[:, :-1].long()] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_000, 3001])
def test_k5_kernel_matches_an_fp64_cdf_on_random_priorities(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(7)
    p = torch.rand((n,), generator=gen, device=cuda)
    p[torch.rand((n,), generator=gen, device=cuda) < 0.3] = 0.0
    u = torch.rand((4, 32), generator=gen, device=cuda)
    idx, total = replay_draw(p, u)
    k = torch.arange(32, device=cuda, dtype=torch.float32)
    u_abs = ((k + u) / 32 * total).double()
    cdf = torch.cumsum(p.double(), 0)
    want = torch.searchsorted(cdf, u_abs, right=True).clamp(0, n - 1)
    got = idx.long()
    assert bool((p[got] > 0).all()), "a zero slot was drawn"
    differ = got != want
    lo = torch.minimum(got, want)[differ]
    near = (u_abs[differ] - cdf[lo]).abs() <= 1e-6 * float(total)
    assert bool(near.all()), "an id differs away from a cdf boundary"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_000, 1_100_000])
def test_k5_and_k5f_kernels_on_adversarial_priorities(cuda, n):
    """Log-uniform priorities over 2^-60 .. 2^20, a huge slot followed by tiny
    ones and runs of zeros across lane, warp and chunk boundaries, through K5
    and K5f's wrapper: no zero slot drawn, the clip onto N - 1, ids against an
    fp64 cdf only within 1e-6 * total of a boundary, the numpy model's ids
    and total exactly, and bit-equal repeats; K5f draws K5's ids."""
    p_np = _adversarial(n, 5 + n)
    u_np = np.random.default_rng(6).random((4, 32), dtype=F32)
    u_np[-1, -1] = 1.0 - 2.0 ** -24
    p, u = torch.from_numpy(p_np).to(cuda), torch.from_numpy(u_np).to(cuda)
    idx, total = _counted("K5_replay_draw", lambda: replay_draw(p, u))
    again, total_again = replay_draw(p, u)
    f_idx, prob, weight = _counted("K5f_frontier_draw", lambda: frontier_draw(p, u, 0.4, n))
    f_again = frontier_draw(p, u, 0.4, n)
    torch.cuda.synchronize()
    got = idx.long().cpu().numpy()
    assert torch.equal(idx, again) and torch.equal(total.view(torch.int32),
                                                   total_again.view(torch.int32))
    assert torch.equal(f_idx, idx)
    for a, b in zip((f_idx, prob, weight), f_again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert got[-1, -1] == n - 1 and bool((p_np[got[:, :-1]] > 0).all()), "a zero slot was drawn"
    model, model_total, ua = _k5_draw(p_np, u_np)
    assert float(total) == float(model_total) and np.array_equal(got, model)
    exact = np.cumsum(p_np.astype(np.float64))
    ref = np.minimum(np.searchsorted(exact, ua.astype(np.float64), side="right"), n - 1)
    differ = got != ref
    lo = np.minimum(got, ref)[differ]
    assert bool(np.all(np.abs(ua[differ] - exact[lo]) <= 1e-6 * float(total))), \
        "an id differs away from a cdf boundary"

@pytest.mark.cuda
@pytest.mark.parametrize("omega", [0.5, 0.6])
@pytest.mark.parametrize("groups", [1, 4])
def test_k6_kernel_matches_twin_with_duplicates_and_zero_slots(cuda, groups, omega):
    gen = torch.Generator(device=cuda).manual_seed(groups)
    p = torch.rand((4096,), generator=gen, device=cuda)
    idx = torch.randint(0, 40, (groups, 32), generator=gen, device=cuda, dtype=torch.int32)
    p[idx[0, :4].long()] = 0.0  # fenced slots, some repeated
    td = torch.rand((groups * 32,), generator=gen, device=cuda) * 3
    got, got_max = p.clone(), torch.tensor(1.5, device=cuda)
    want, want_max = p.clone(), torch.tensor(1.5, device=cuda)
    _counted("K6_replay_writeback",
             lambda: replay_writeback(got, got_max, idx, td, 1e-6, omega))
    replay_writeback_plain(want, want_max, idx, td, 1e-6, omega)
    if omega == 0.5:
        assert torch.equal(got, want) and torch.equal(got_max, want_max)
    else:  # powf against torch.pow
        torch.testing.assert_close(got, want, **REL)
        torch.testing.assert_close(got_max, want_max, **REL)
    assert bool((got[p == 0] == 0).all())


def _fold_inputs(cuda, batch, groups, n, seed):
    """A loss's inputs (sample 0's td NaN where the batch has two samples)
    and a ring of 4,096 priorities with zero slots, its ids [G, B / G] with
    repeats inside and across groups."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    online = torch.randn((batch, n), generator=gen, device=cuda)
    taus = torch.rand((batch, n), generator=gen, device=cuda)
    target = torch.randn((batch, n), generator=gen, device=cuda)
    weight = torch.rand((batch,), generator=gen, device=cuda)
    if batch > 1:
        target[0, 3] = float("nan")
    ring = torch.rand((4096,), generator=gen, device=cuda)
    ids = torch.randint(0, 48, (groups, batch // groups), generator=gen, device=cuda,
                        dtype=torch.int32)
    ring[ids[0, :3].long()] = 0.0
    return (online, taus, target, weight), ring, ids


@pytest.mark.cuda
@pytest.mark.parametrize("omega", [0.5, 0.6])
@pytest.mark.parametrize("batch,groups,n", [(32, 1, 64), (128, 4, 64), (1, 1, 64), (256, 1, 8),
                                            (48, 3, 16), (2048, 2, 4)])
def test_k1_with_k6_folded_matches_k1_then_k6(cuda, batch, groups, n, omega):
    args, ring, ids = _fold_inputs(cuda, batch, groups, n, batch + groups)
    got, got_max = ring.clone(), torch.tensor(1.5, device=cuda)
    want, want_max = ring.clone(), torch.tensor(1.5, device=cuda)
    twin, twin_max = ring.clone(), torch.tensor(1.5, device=cuda)
    before, k6_before = launches["K1_quantile_huber"], launches["K6_replay_writeback"]
    fold_before = folded["K6_replay_writeback"]
    out = quantile_huber_weighted(*args, writeback=Writeback(got, got_max, ids, 1e-6, omega))
    torch.cuda.synchronize()
    assert launches["K1_quantile_huber"] == before + 1
    assert launches["K6_replay_writeback"] == k6_before
    assert folded["K6_replay_writeback"] == fold_before + 1
    ref = quantile_huber_weighted(*args)
    replay_writeback(want, want_max, ids, ref[2], 1e-6, omega)
    replay_writeback_plain(twin, twin_max, ids, out[2], 1e-6, omega)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):  # K1's outputs: the same launch's bits
        assert _same_bits(a, b)
    assert _same_bits(got, want) and _same_bits(got_max, want_max)
    if omega == 0.5:
        assert _same_bits(got, twin) and _same_bits(got_max, twin_max)
    else:  # powf against torch.pow
        torch.testing.assert_close(got, twin, equal_nan=True, **REL)
        torch.testing.assert_close(got_max, twin_max, equal_nan=True, **REL)
    assert bool((got[ring == 0] == 0).all())
    assert (batch == 1) != bool(torch.isnan(got_max))


@pytest.mark.cuda
def test_k1_with_k6_folded_drops_ids_outside_the_ring_as_k6_does(cuda):
    args, ring, ids = _fold_inputs(cuda, 64, 2, 64, 7)
    ids[0, 5], ids[1, 0], ids[1, -1] = 4096, -1, 4096 + 9
    got, got_max = ring.clone(), torch.tensor(1.5, device=cuda)
    want, want_max = ring.clone(), torch.tensor(1.5, device=cuda)
    out = quantile_huber_weighted(*args, writeback=Writeback(got, got_max, ids, 1e-6, 0.5))
    replay_writeback(want, want_max, ids, out[2], 1e-6, 0.5)
    torch.cuda.synchronize()
    assert _same_bits(got, want) and _same_bits(got_max, want_max)


@pytest.mark.cuda
def test_k1_with_k6_folded_refuses_what_it_does_not_take(cuda):
    args, ring, ids = _fold_inputs(cuda, 32, 1, 64, 3)
    with pytest.raises(ValueError):  # ids over another batch
        quantile_huber_weighted(*args, writeback=Writeback(
            ring, torch.tensor(1.0, device=cuda), ids[:, :16].contiguous(), 1e-6, 0.5))
    with pytest.raises(TypeError):
        quantile_huber_weighted(*args, writeback=Writeback(
            ring, torch.tensor(1.0, device=cuda), ids.long(), 1e-6, 0.5))
    with pytest.raises(ValueError):  # the ring elsewhere
        quantile_huber_weighted(*args, writeback=Writeback(
            ring.cpu(), torch.tensor(1.0), ids, 1e-6, 0.5))


def _same_bits(a, b):
    """Equal element for element, a NaN equal to a NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _same_state(got, want):
    """Every field exactly, a NaN equal to a NaN (a NaN actor priority)."""
    for name in ("frames", "actions", "rewards", "terminals", "cuts", "priority",
                 "max_priority"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name).cpu(), rtol=0,
                                   atol=0, equal_nan=True, msg=name)
    assert (got.pos, got.filled) == (want.pos, want.filled)


def _k7_run(cuda, lanes, frame, history, n_step, actor=True, nan_at=None, seg=16):
    """2 S + 5 ticks through K7 and through the twin on the card's tensors,
    the actor priorities of lanes 1 and 35 (where there is one) NaN at tick
    ``nan_at``."""
    card = _replay(lanes, seg, frame, history, n_step, cuda)
    got, want = card.init_state(), card.init_state()
    rng = np.random.default_rng(5)
    before = launches["K7_replay_append"]
    for t in range(2 * seg + 5):
        tick = [None if x is None else x.to(cuda) for x in _tick(rng, lanes, frame, actor=actor)]
        if t == nan_at:
            tick[-1][1::34] = float("nan")
        card.append(got, *tick)
        replay_append_plain(want, *tick, want.pos, want.filled, history, n_step, card.eps,
                            card.omega)
        want.pos, want.filled = (want.pos + 1) % seg, min(want.filled + 1, seg)
    torch.cuda.synchronize()
    assert launches["K7_replay_append"] == before + 2 * seg + 5
    return card, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("history,n_step", [(4, 3), (1, 1), (7, 5)])
@pytest.mark.parametrize("lanes,frame", [(16, (84, 84)), (40, (10, 10)), (16, (80, 80))])
@pytest.mark.parametrize("actor", [True, False], ids=["actor_pri", "max_pri"])
def test_k7_kernel_matches_twin_over_a_wrapped_ring(cuda, lanes, frame, actor, history, n_step):
    """84 x 84 and 80 x 80 take the 16-byte frame copy, 10 x 10 the byte
    copy; 40 lanes loop the scalar warp past 32 ring lanes; history 1 and 7
    and n_step 1 and 5 move the dead zone and the window."""
    _, got, want = _k7_run(cuda, lanes, frame, history, n_step, actor)
    _same_state(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,frame", [(16, (84, 84)), (40, (10, 10))])
def test_k7_kernel_propagates_a_nan_actor_priority(cuda, lanes, frame):
    """A NaN actor priority (lane 1; and lane 35, past the scalar warp's
    first 32, at 40 lanes) reaches its slot and max_priority, as the twin's
    maximum propagates it."""
    _, got, want = _k7_run(cuda, lanes, frame, 4, 3, nan_at=20)
    assert bool(torch.isnan(got.max_priority))
    _same_state(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,frame", [(16, (84, 84)), (40, (10, 10))])
def test_k7_kernel_repeats_bit_equal(cuda, lanes, frame):
    card, state, _ = _k7_run(cuda, lanes, frame, 4, 3)
    again = state.to(cuda)
    tick = [x.to(cuda) for x in _tick(np.random.default_rng(9), lanes, frame)]
    for s in (state, again):
        replay_append(s, *tick, state.pos, state.filled, 4, 3, card.eps, card.omega)
    torch.cuda.synchronize()
    _same_state(state, again)


def _k8_pair(cuda, state, on_card, idx, gammas, history, n_step, group, with_weight=True):
    total = state.priority.sum()
    got = _counted("K8_replay_assemble", lambda: replay_assemble(
        on_card, idx.to(cuda), total.to(cuda), gammas.to(cuda), 0.6, state.filled, history,
        n_step, group, with_weight))
    want = replay_assemble_plain(state, idx, total, gammas, 0.6, state.filled, history, n_step,
                                 group, with_weight)
    for name in ("obs", "next_obs", "action", "discount"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    for name in ("reward", "prob", "weight"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name), **REL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("frame,history,n_step", [
    ((84, 84), 4, 3), ((10, 10), 3, 3), ((80, 80), 4, 3), ((84, 84), 4, 1), ((84, 84), 4, 5),
    ((84, 84), 1, 3), ((84, 84), 7, 5), ((10, 10), 7, 1)])
@pytest.mark.parametrize("ticks", [11, 40], ids=["young", "wrapped"])
@pytest.mark.parametrize("groups", [1, 4])
def test_k8_kernel_matches_twin(cuda, frame, history, n_step, ticks, groups):
    """84 x 84 x 4 and 80 x 80 x 4 take the 16-byte transposing store, the
    rest the byte path (10 x 10: hw % 16 != 0); n_step 1 and 5 the return's
    edges; a young ring zeroes frames older than its history."""
    cpu = _replay(4, 32, frame, history, n_step, "cpu")
    state = _filled(cpu, ticks, seed=ticks)
    rng = np.random.default_rng(6)
    idx = torch.from_numpy(rng.integers(0, 4 * 32, groups * 32).astype(np.int32))
    _k8_pair(cuda, state, state.to(cuda), idx, cpu._gammas, history, n_step, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("with_weight", [True, False])
def test_k8_kernel_matches_twin_on_groups_of_48_draws(cuda, groups, with_weight):
    """A group of more than 32 draws: a lane takes two, the weight maximum
    spans both."""
    cpu = _replay(4, 32, (84, 84), 4, 3, "cpu")
    state = _filled(cpu, 40, seed=3)
    idx = torch.from_numpy(np.random.default_rng(8).integers(0, 4 * 32, groups * 48)
                           .astype(np.int32))
    _k8_pair(cuda, state, state.to(cuda), idx, cpu._gammas, 4, 3, 48, with_weight)


@pytest.mark.cuda
@pytest.mark.parametrize("frame,history,n_step", [((84, 84), 4, 3), ((10, 10), 7, 5)])
@pytest.mark.parametrize("ticks", [9, 45], ids=["young", "wrapped"])
def test_k8_kernel_matches_twin_next_to_the_write_cursor(cuda, frame, history, n_step, ticks):
    """Every lane's slots from pos - h - n to pos + h + n: stacks that reach
    behind the written history, into the dead zone and across the seam."""
    seg = 32
    cpu = _replay(4, seg, frame, history, n_step, "cpu")
    state = _filled(cpu, ticks, seed=ticks)
    cols = (state.pos + np.arange(-history - n_step, history + n_step + 1)) % seg
    idx = (np.arange(4)[:, None] * seg + cols[None, :]).reshape(-1).astype(np.int32)
    _k8_pair(cuda, state, state.to(cuda), torch.from_numpy(idx), cpu._gammas, history, n_step,
             idx.size)


@pytest.mark.cuda
@pytest.mark.parametrize("frame,history", [((84, 84), 4), ((10, 10), 3)])
def test_k8_kernel_repeats_bit_equal(cuda, frame, history):
    cpu = _replay(4, 32, frame, history, 3, "cpu")
    state = _filled(cpu, 40, seed=2)
    on_card = state.to(cuda)
    idx = torch.from_numpy(np.random.default_rng(4).integers(0, 4 * 32, 128).astype(np.int32))
    first = _k8_pair(cuda, state, on_card, idx, cpu._gammas, history, 3, 32)
    again = _k8_pair(cuda, state, on_card, idx, cpu._gammas, history, 3, 32)
    for name in first._fields:
        a, b = getattr(first, name), getattr(again, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k6_and_k8_kernels_stay_inside_the_ring_on_out_of_range_ids(cuda):
    """K6 drops an id outside [0, N) (XLA drops such a scatter update), K8
    clamps one into the ring (XLA clamps such a gather)."""
    replay = _replay(device=cuda)
    state = _filled(_replay(), 20).to(cuda)
    n = state.priority.numel()
    before = state.priority.clone()
    idx = torch.tensor([[n, -1, 3, n + 7]], dtype=torch.int32, device=cuda)
    replay_writeback(state.priority, state.max_priority, idx, torch.ones(4, device=cuda),
                     1e-6, 0.5)
    changed = (state.priority != before).nonzero().flatten().tolist()
    assert changed in ([], [3])
    ids = torch.tensor([-5, 2, n + 3, n - 1], dtype=torch.int32, device=cuda)
    _, total = replay_draw(state.priority, state.priority.new_empty((0, 1)))
    got = replay_assemble(state, ids, total, replay._gammas, 0.5, state.filled, 3, 2, 4)
    want = replay_assemble(state, ids.clamp(0, n - 1), total, replay._gammas, 0.5,
                           state.filled, 3, 2, 4)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_replay_kernels_refuse_what_they_do_not_take(cuda):
    p = torch.rand((100,), device=cuda)
    with pytest.raises(TypeError):
        replay_draw(p.double(), torch.rand((1, 4), device=cuda))
    with pytest.raises(ValueError):
        replay_writeback(p, torch.tensor(1.0, device=cuda),
                         torch.zeros((1, 2000), dtype=torch.int32, device=cuda),
                         torch.zeros(2000, device=cuda), 1e-6, 0.5)
    replay = _replay(device=cuda)
    state = replay.init_state()
    with pytest.raises(TypeError):
        replay_append(state, torch.zeros((3, 10, 10), dtype=torch.uint8, device=cuda),
                      torch.zeros(3, dtype=torch.int64, device=cuda), torch.zeros(3, device=cuda),
                      torch.zeros(3, dtype=torch.bool, device=cuda),
                      torch.zeros(3, dtype=torch.bool, device=cuda), None, 0, 0, 3, 2, 1e-6, 0.5)
