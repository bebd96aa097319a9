"""The R2D2 Anakin step's two folds on the CPU: K6s's priority write-back
inside K11's launch, and the act tick's prologue (the append, the
frame-stack shift and pre = lstm * keep) as one K7s launch.

- The fused R2D2 step with the write-back target (``build_device_r2d2_learn``)
  bit for bit against the parent's route on the same states and draws: the
  learn step, then ``update_priorities_grouped`` (K11's twin, then K6s's).
  G 1 and 2, a slot heavy enough to be drawn by several strata (repeated ids
  inside a group, and across groups: every group draws the same uniforms),
  and a NaN reward in its train slice (a NaN |TD|, so a NaN priority is
  written and the running maximum turns NaN).  Against JAX at 1e-5 the
  fused step is held by tests/test_torch_device_sequence.py.
- K11 reading reward, done and valid as column slices of the batch's rows
  (no copy) gives the bits of contiguous copies; ``td_plan``'s blocks.
- The act tick's prologue (``DeviceSequenceReplay.act_prologue``) against
  the JAX act_append's own composition (the jitted JAX
  ``DeviceSequenceReplay.append``, JAX ``shift_stack``, ``lstm * kf``) over
  1 (the first tick: no append), 4, 17 and 60 ticks, with and without cuts
  and truncations, and with a self-overlapping carry: the ring, builders,
  counters, stack and pre bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.parallel.multihost import shift_stack as jax_shift_stack
from rainbow_iqn_apex_tpu_torch.kernels import folded, launches
from rainbow_iqn_apex_tpu_torch.kernels.r2d2_td import (
    MAX_CLUSTER,
    MAX_SEQS,
    SMEM_LIMIT,
    TDParams,
    r2d2_td,
    seq_bytes,
    td_plan,
)
from rainbow_iqn_apex_tpu_torch.ops.r2d2 import build_r2d2_learn_step
from rainbow_iqn_apex_tpu_torch.replay import build_device_r2d2_learn
from test_torch_device_sequence import _assert_same_ring, _learn_ring, _pair, _trace
from test_torch_r2d2 import A, BURN, _port_state, _step_draws, _warm_jax_state


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# ------------------------------------------------------- K6s in K11: the step
def _heavy_ring(groups, nan):
    """The learn ring of tests/test_torch_device_sequence.py with slot 3's
    priority 40 times the rest (every stratum near it draws it), and with
    ``nan`` a NaN reward in slot 3's train slice."""
    _, pcfg, _, pdev, _, ps = _learn_ring(groups)
    ps.priority.copy_(torch.where(ps.priority > 0, torch.full_like(ps.priority, 0.125),
                                  ps.priority))
    ps.priority[3] = 5.0
    if nan:
        ps.rewards[3, BURN + 1] = float("nan")
    return pcfg, pdev, ps


def _parent_route(pcfg, replay):
    """The parent's fused step: the learn step, then K6s's own write-back."""
    learn_step = build_r2d2_learn_step(pcfg, A)
    groups = pcfg.sample_groups

    def fused(ts, ss, generator, beta, *, u=None, draws=None):
        idx, batch, _ = replay.sample_grouped(ss, pcfg.batch_size, groups, beta, generator, u)
        ts, info = learn_step(ts, batch, generator, draws)
        replay.update_priorities_grouped(ss, idx, info["priorities"])
        return ts, ss, info

    return fused


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_td"])
@pytest.mark.parametrize("groups", [1, 2])
def test_fused_step_with_the_fold_equals_the_parent_route(groups, nan):
    pcfg, pdev, ring = _heavy_ring(groups, nan)
    jts = _warm_jax_state()
    states = [_port_state(pcfg, jts) for _ in range(2)]
    rings = [ring, ring.to("cpu")]
    routes = [build_device_r2d2_learn(pcfg, A, pdev), _parent_route(pcfg, pdev)]
    u = torch.from_numpy(np.random.default_rng(5).random((groups, pcfg.batch_size),
                                                         dtype=np.float32))
    idx, _, _ = pdev.sample_grouped(ring, pcfg.batch_size, groups, 0.5, u=u)
    assert ((idx == 3).sum(dim=1) > 1).all(), "slot 3 repeats inside each group"
    before = dict(launches), dict(folded)
    for k in range(2):
        _, draws = _step_draws(80 + k)
        outs = [route(ts, ss, None, 0.5, u=u, draws=draws)
                for route, ts, ss in zip(routes, states, rings)]
        (_, got, info), (_, want, want_info) = outs
        for name in ("loss", "priorities", "q_mean", "grad_norm", "finite"):
            assert _same(info[name], want_info[name]), f"step {k}: {name}"
        assert _same(got.priority, want.priority) and _same(got.max_priority, want.max_priority)
    assert (dict(launches), dict(folded)) == before  # the twins count nothing
    if nan:
        assert torch.isnan(info["priorities"]).any() and torch.isnan(got.max_priority)
        assert torch.isnan(got.priority[3])
    else:
        assert torch.isfinite(got.priority).all()
    for a, b in zip(states[0].net.parameters(), states[1].net.parameters()):
        assert _same(a.detach(), b.detach())


def test_k11_reads_strided_slices_as_contiguous_copies():
    """The learn step hands K11 column slices of the batch's [B, L] rows."""
    rng = np.random.default_rng(3)
    batch, length, burn, actions = 5, 14, 4, 6
    steps = length - burn

    def t(x):
        return torch.from_numpy(np.asarray(x))

    q_taken = t(rng.normal(size=(batch, steps)).astype(np.float32))
    q_sel = t(rng.normal(size=(batch, steps, actions)).astype(np.float32))
    q_tgt = t(rng.normal(size=(batch, steps, actions)).astype(np.float32))
    reward = t(rng.normal(size=(batch, length)).astype(np.float32))
    done = t(rng.random((batch, length)) < 0.1)
    valid = t(rng.random((batch, length)) < 0.9)
    weight = t(rng.uniform(0.3, 1.0, batch).astype(np.float32))
    p = TDParams(3, 0.97, 0.9, 1e-3)
    views = (reward[:, burn:], done[:, burn:], valid[:, burn:])
    assert not views[0].is_contiguous()
    got = r2d2_td(q_taken, q_sel, q_tgt, *views, weight, p)
    want = r2d2_td(q_taken, q_sel, q_tgt, *(v.contiguous() for v in views), weight, p)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rows,steps,actions,want", [
    (32, 80, 18, (2, 16)),  # the reference learner: a cluster of 16 blocks of two warps
    (1, 80, 18, (1, 1)),
    (5, 80, 18, (1, 5)),
    (33, 80, 18, (3, 11)),
    (128, 80, 18, (8, 16)),  # G 4
    (288, 80, 18, (18, 16)),  # the most that fits at T 80, A 18
    (32, 256, 18, (2, 16)),
])
def test_k11_plan(rows, steps, actions, want):
    per_block, blocks = td_plan(rows, steps, actions)
    assert (per_block, blocks) == want
    assert per_block <= MAX_SEQS and blocks <= MAX_CLUSTER and per_block * blocks >= rows
    assert per_block * seq_bytes(steps, actions) + 16 * rows <= SMEM_LIMIT


@pytest.mark.parametrize("rows,steps,actions", [(513, 80, 18), (0, 80, 18), (32, 257, 18),
                                                (289, 80, 18)])
def test_k11_plan_refuses_what_the_kernel_cannot_take(rows, steps, actions):
    with pytest.raises(ValueError):
        td_plan(rows, steps, actions)


# ------------------------------------------------ the act tick's prologue
def _jax_prologue(jdev):
    """The JAX act_append's graph up to the act
    (rainbow_iqn_apex_tpu/train_anakin_r2d2.py:act_append)."""

    def run(ss, stack, frame, keep, lstm, prev):
        if prev is not None:
            ss = jdev.append(ss, *prev)
        stack = jax_shift_stack(stack, frame, keep)
        kf = keep.astype(jnp.float32)[:, None]
        return ss, stack, (lstm[0] * kf, lstm[1] * kf)

    return jax.jit(run)


def _drive_prologue(jdev, pdev, ticks, history, seed=0, **kw):
    """``ticks`` act ticks through both prologues from one numpy trace: each
    tick's frame, the act's next LSTM state, its actions and the env's
    rewards and cuts; the next tick appends this tick's frame and pre.
    Returns both (ring, stack, pre) after the last tick."""
    lanes, frame, lstm = pdev.lanes, pdev.frame_shape, pdev.lstm_size
    run = _jax_prologue(jdev)
    js, ps = jdev.init_state(), pdev.init_state()
    jstack = jnp.zeros((lanes, *frame, history), jnp.uint8)
    pstack = torch.zeros((lanes, *frame, history), dtype=torch.uint8)
    rng = np.random.default_rng(seed + 100)
    c = rng.normal(size=(lanes, lstm)).astype(np.float32)
    h = rng.normal(size=(lanes, lstm)).astype(np.float32)
    jprev = pprev = None
    cuts = np.zeros(lanes, bool)
    for f, a, r, term, trunc, c_next, h_next in _trace(np.random.default_rng(seed), ticks,
                                                       lanes, frame, lstm, **kw):
        keep = (~cuts).astype(np.uint8)
        js, jstack, jpre = run(js, jstack, jnp.asarray(f), jnp.asarray(keep),
                               (jnp.asarray(c), jnp.asarray(h)), jprev)
        ppre = pdev.act_prologue(ps, pprev, pstack, torch.from_numpy(f), torch.from_numpy(keep),
                                 (torch.from_numpy(c), torch.from_numpy(h)))
        # the env's step on the act's actions; held for the next tick's append
        jprev = tuple(jnp.asarray(x) for x in (f, a, r, term, trunc)) + jpre
        pprev = (torch.from_numpy(f), torch.from_numpy(a), r, term, trunc, *ppre)
        cuts = term | trunc
        c, h = c_next, h_next  # the act's new state
    return (js, jstack, jpre), (ps, pstack, ppre)


def _assert_same_tick(jax_side, port_side):
    (js, jstack, jpre), (ps, pstack, ppre) = jax_side, port_side
    _assert_same_ring(js, ps)
    np.testing.assert_array_equal(pstack.numpy(), np.asarray(jstack))
    for got, want in zip(ppre, jpre):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p_term,p_trunc", [(0.1, 0.07), (0.0, 0.0)], ids=["cuts", "no_cuts"])
@pytest.mark.parametrize("ticks", [1, 4, 17, 60])
def test_prologue_matches_the_jax_act_append(ticks, p_term, p_trunc):
    jdev, pdev = _pair()
    before = dict(launches)
    jax_side, port_side = _drive_prologue(jdev, pdev, ticks, 4, p_term=p_term, p_trunc=p_trunc)
    _assert_same_tick(jax_side, port_side)
    assert dict(launches) == before  # the twin counts nothing
    if ticks == 1:
        assert port_side[0].filled == 0 and not port_side[0].buf_len.any()  # nothing appended
    if ticks == 60:
        assert port_side[0].filled == 16  # the ring wrapped


@pytest.mark.parametrize("history", [2, 3])
def test_prologue_with_a_self_overlapping_carry_matches_jax(history):
    """stride 2 < L - stride 5, and a history other than 4 (the kernel's
    byte path)."""
    jdev, pdev = _pair(seq_len=7, stride=2)
    _assert_same_tick(*_drive_prologue(jdev, pdev, 45, history, seed=3))
