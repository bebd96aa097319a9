#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rainbow_iqn_apex_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rainbow_iqn_apex_tpu_torch/csrc``
and runs every phase, in this order:

- ``kernels``: the serving kernels (K2, K3, K4) against their plain PyTorch
  twins at the full-width serving shapes (bucket 64, K = 32 taus, F = 3136,
  hidden 512, 18 actions, bf16), timed beside the twin, the bound and the
  nearest single PyTorch call (noisy K3: two ``F.linear`` calls and the
  scale), then K3 at each other main-path shape (``K3_EXTRA_SHAPES``: M 512
  and 1024, the jaxgame F 2304, the R2D2 head), one line per layer and mode,
  and the host time of one K3 call;
- ``serve``: the port's ``PolicyServer`` from ``configs/serve_defaults.json``
  with seeded random weights, 512 requests from 8 client threads, launch
  counters that prove the path went through every serving kernel, a
  profile, the kernel path against the plain path (greedy and noisy), a
  weight hot-swap and a draining stop;
- ``kernels_learn``: the learner's kernels (K1 per-sample and weighted,
  held bit-equal on a repeat, K2-bwd, K3-bwd, K4 gather, K4-bwd in its dz
  and loss modes, and K4's heads mode: a learn step's one K4 launch, beside
  the three launches and two elementwise ops it replaces; K1 weighted and
  K4-bwd's loss mode beside the torch ops they absorbed, and the loss
  chain, three launches, beside the parent's eight) against their twins
  at the learner's full-width shapes (B 32, N 64), timed the same way;
  K3-bwd also at ``K3_EXTRA_SHAPES`` with M >= 512,
  held bit-equal on a repeat of the same call, beside the floor of its hi / lo
  split, and the host time of one K3-bwd call;
- ``learn``: 200 full-width learn steps from
  ``configs/reference_atari_defaults.json`` (synthetic frames) through the
  port's ``Agent``, ``PrioritizedReplay`` and write-back ring under
  ``forbid_host_sync()``, with launch counters, then a profile of 20 steps;
- ``learn_parity``: one full-width learn step on the card against the same
  step through the plain twins on the CPU;
- ``train``: ``python -m rainbow_iqn_apex_tpu_torch.train`` on ``toy:catch``
  for 4,000 frames at seeds 7, 56, 57 and 58 (fixed before any run of 56-58
  was read), one process each, all at once, their mean evaluation held
  above 0.2 and every run above 1,500 learn steps;
- ``kernels_replay``: the device replay's kernels (K5 PER draw over
  1,000,000 priorities, K6 write-back, K7 append of 16 lanes of 84x84, K8
  assembly at B 32, h 4, n 3) against their twins, timed the same way, then
  K6 folded into K1's weighted launch (the fused step's route: G 1 and 4,
  repeated ids, zero slots, a NaN td, ids outside the ring) bit-equal to K1's
  launch then K6's and to K6's twin, timed beside those two launches, and
  K7 and K8 at the edges of their grids, each launch repeated bit-equal;
- ``anakin``: ``DeviceReplay`` at the reference config's uncut 1,000,000
  slots (16 lanes x 62,500, 7.06 GB of frames in device memory) filled
  through K7 with synthetic frames, then 200 full-width fused
  sample -> learn -> write-back steps (``build_device_learn``) under
  ``forbid_host_sync()`` with exact launch counts per step (no K6 launch:
  its write-back runs inside K1's, once a step, counted in ``folded``), and
  a profile;
- ``anakin_parity``: one fused step on the card against the same step
  through the plain twins on the CPU;
- ``train_anakin``: ``python -m rainbow_iqn_apex_tpu_torch.train --role
  anakin`` on ``toy:catch`` for 4,000 frames, at the same seeds and bar;
- ``kernels_frontier``: the device sample frontier's kernels (K5f draw with
  IS weights over the 1,000,000-slot mirror of two shards, one of them
  dead, G 8, B 32; K6f write-back at B 32 with repeated ids and zero slots)
  against their twins, timed the same way, then K6f's queue between two
  draws of the apex loop (8 write-back batches of 32 and two ticks of staged
  rows, repeated ids, zero slots, a NaN |td|) applied by K5f's first launch
  and by K6f's own (ids outside the mirror too), against the twins' apply
  and the draw after it, timed beside the parent's route;
- ``apex``: the Ape-X loop of ``configs/reference_atari_defaults.json`` at
  full width with synthetic frames: ``ApexDriver`` acting on 16 lanes with
  actor-side priorities into a 1,000,000-slot ``ShardedReplay`` filled to
  32,000 transitions, then 200 learn steps with host sampling and 200 with
  the device frontier (``SampleAheadPusher``, K5f applying K6f's queue of
  write-backs and staged appends, reconcile at drains), publishes every 100
  steps, under ``forbid_host_sync()``, with the exact launches of each run
  (K6f: one a reconcile that finds queued updates), and a profile;
- ``kernels_quant``: the quantized act path's kernels (K10q int8 and fp8
  over the full-width tree with a zero channel, ties and e4m3's overflow
  edges planted, bit-equal; K10g int8 and e4m3, greedy at serving's M 2048
  and noisy at apex acting's M 512, and int8 at the catch scenario's act
  tick, M 64, F 2304, hidden 128, 3 actions; K10d bit-equal) against their twins,
  timed the same way (K10g's yardstick is two calls: the dequantize into
  bf16, then ``F.linear``);
- ``apex_quant``: the ``apex`` phase's device-sampling loop over its filled
  replay with int8 actors (``serve_quantize`` int8, ``quant_agreement_min``
  0): calibration drawn from the replay, 120 learn steps with a gated
  publish every 40 under ``forbid_host_sync()``, the exact launches of
  K10q, K10d and K10g, learn steps/s, act ms and publish bytes against the
  bf16 run;
- ``serve_quant``: ``PolicyServer`` with ``serve_quantize`` int8, then fp8:
  the gate at the config's 0.99, a forced pass serving 512 requests from 8
  clients with exact launches per dispatch (K10d 1, K2 1, K10g 4, K4 1, K3
  0), a forced fail with its one ``quant_fallback`` row, and the card's
  quantized path against the CPU's;
- ``apex_parity``: one frontier draw and one learn step on the card against
  the same through the plain twins on the CPU;
- ``train_apex``: ``python -m rainbow_iqn_apex_tpu_torch.train --role apex``
  with device sampling on ``toy:catch`` for 4,000 frames, at the same seeds,
  held to the bar the JAX ``train_apex`` clears on the same scenario;
- ``train_apex_quant``: the same with ``--serve-quantize int8
  --quant-agreement-min 0`` at seeds 33-36 (fixed before any run read them),
  one process each, all at once, their mean evaluation held to the same
  bar, with the count of publishes that shipped int8;
- ``kernels_r2d2``: R2D2's kernels (K9, the resettable LSTM recurrence, at
  [32, 120, 512] with planted resets, the learner's burn-in [32, 40, 512]
  and train slice [32, 80, 512], and an act tick's [16, 1, 512]; K9-bwd at
  [32, 80, 512]; K11, the TD and priority epilogue,
  at [32, 80, 18], n 3, reading the train slice of [32, 120] rows in place,
  and at G 4's [128, 80, 18]; K11 with K6s's write-back
  folded in, bit-equal to K11 then K6s; K8s-stack at [32, 120, 84, 84], h 4)
  against their twins, timed the same way (K9's yardstick: cuDNN's LSTM
  layer);
- ``learn_r2d2``: the R2D2 learner of the reference config (``--role single
  --architecture r2d2``: 84x84x4, LSTM 512, burn-in 40, 80 trained steps,
  B 32, n 3, 8,621,254 parameters) through ``R2D2Agent`` on a
  ``SequenceReplay`` of 256 synthetic sequences, 50 learn steps with the
  per-step priority write-back and exact launches per step, and a profile;
- ``r2d2_parity``: one full-width R2D2 learn step and one act tick on the
  card against the same through the plain twins on the CPU;
- ``train_r2d2``: the CLI with ``--architecture r2d2`` on ``toy:catch`` with
  the JAX package's own R2D2 catch configuration, 20,000 frames, at seeds
  3-6 in four processes, held to that test's bar (eval mean > 0.3);
- ``kernels_r2d2_anakin``: the device sequence replay's kernels (K7s as the
  act tick's prologue: the append of 16 lanes of 120 x 84x84 steps and LSTM
  512 into the config's uncut ring of 8,333 sequences, wrapping, with the
  frame stack's shift and pre = lstm * keep; K5s draw over 8,333 priorities, dyadic, cold
  and random, G 1 and 4, B 32; K8s gather and IS weights at B 32, G 1 and 4;
  K6s write-back with repeated ids) against their twins, timed the same way;
- ``anakin_r2d2``: ``--role anakin --architecture r2d2`` of the reference
  config through the trainer's ``DeviceSequenceReplay`` at the uncut 8,333
  sequences (~7.12 GB of device memory) and its ``act_append`` tick (one K7s
  prologue launch, then the act's K9, K3, K4) on 16 lanes of synthetic
  frames until past the warm gate, with the one sanctioned read per tick,
  and a profile of act ticks, then 50 fused draw -> gather -> learn ->
  write-back steps (``build_device_r2d2_learn``: K6s inside K11's launch)
  under ``forbid_host_sync()`` with exact launches per step, and a profile;
- ``anakin_r2d2_parity``: one fused step on the card against the same step
  through the plain twins on the CPU, over a 300-sequence ring;
- ``train_anakin_r2d2``: the CLI with ``--role anakin --architecture r2d2``
  on the same catch configuration at seeds 3-6 in four processes, held to
  the same bar.
- ``kernels_games``: K12, the device games' tick, bit-equal to its plain
  twins on the card for all ten games (the five games and their seeded-level
  variants) at 16 and 4,096 lanes over 100 auto-reset ticks, and at one
  lane over 100 steps of the host adapter's reset-free step, each timed
  beside its twin and its byte bound;
- ``anakin_fused``: the fully fused ``--role anakin`` of the reference config
  on ``jaxgame:breakout`` (80x80 frames) through ``init_fused_carry`` and
  ``build_fused_segment``: the uncut 1,000,000-slot ring (~6.41 GB), cold
  64-tick segments up to the warm gate of 20,000 stored frames (tick 1,250),
  then a warm-up and 6 timed warm segments (act, K12, K7 and four learn
  steps a tick), each under ``forbid_host_sync()`` and read once, with the
  exact launches of every segment, and a profile of one more;
- ``anakin_fused_parity``: one 24-tick segment on the card against the same
  segment on the CPU through the twins (same state, key and draws; one learn
  step on its last tick);
- ``train_anakin_fused``: the CLI on ``jaxgame:catch`` with
  tests/test_anakin_fused.py's catch configuration in bf16 at seeds 7,
  53-55 in four processes, each held to that test's bar (eval > 0.5, more
  than 2,500 learn steps);
- ``kernels_mt``: the multi-game modes, K2g (the game embedding in K2, and
  K2g-bwd with dE), K4m (the per-game action mask) and K4l (the log-softmax
  at the taken action, masked and not), against their twins at the
  multi-game path's shapes (B 32, N 64, K 32, F 2304, A 5, G 4) and at
  serving's (B 64, F 3136, A 18), and the masked heads mode at the
  multi-game learn pass's, timed the same way (dE's yardstick
  ``index_add_``, K4l's ``log_softmax`` + ``gather``);
- ``apex_mt``: ``train_apex`` with ``games`` = four jaxgame games (3, 5, 4
  and 3 actions, 80x80, 4 lanes each) and ``replay_ratio`` 2 over the
  reference config: a ``MultiGameReplay`` of the uncut 1,000,000 slots,
  ``learn_start`` cut to 2,000 frames, the loop's backlog of sampled
  batches at the first warm tick, then a window of 40 ticks, with exact
  launches per act, env step and sampled batch, no masked action taken,
  per-game learn shares and occupancy, clip_frac, a profile and peak
  memory;
- ``apex_mt_parity``: one full-width multi-game K = 2 step (a pad-slot a*
  planted) and one single-game K = 2 step on the card against the CPU;
- ``train_apex_mt``: the JAX acceptance runs of multi-game Ape-X and of
  multi-game reuse (``tests/test_multitask.py``, ``tests/test_replay_reuse.py``)
  on the card with their own assertions.

One JSON object per line; the line before the last is the card's name and
power limit from ``nvidia-smi``, and the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines.  Without a CUDA device, or without the port beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 123
BUCKET = 64
REQUESTS = 512
CLIENTS = 8
REPS = 60  # timed replays per measurement (median reported)
CALLS_PER_REPLAY = 10  # launches captured per CUDA-graph replay
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16, published
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, published
K2_TOL = dict(atol=1e-2, rtol=1e-2)  # bf16 output: one ulp is 2^-8 relative
K3_TOL = dict(atol=2e-3, rtol=2e-3)  # fp32 sums of up to 3136 products, other order
K4_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32, summation order only
PATH_TOL = 3e-2  # quantiles, kernel path (card) vs plain path (CPU), bf16 model
PATH_Q_TOL = 2e-3  # their means over tau; actions must agree where the gap > 2x this
K1_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 loss, td and gradient, summation order only
K1_OPS_PER_PAIR = 16  # flops per (i, j) pair in the loss, |u|, weight and gradient
K2B_TOL = dict(atol=1e-2, rtol=1e-2)  # bf16 results of fp32 sums in another order: ~1 ulp
# K2's other main-path shapes (B, N, F, C), beside bucket 64's [64 x 32, 3136,
# 64]: the learner's online pass at s' (32 x 32) and the act tick (16 lanes x
# 32 taus) on F 3136, the jaxgame trunk (F 2304) at 32 x 64 and at its tick,
# and num_cosines 8 (the reuse scenario's depth, off the MMA's 16); K2-bwd
# takes the learner's shape at num_cosines 64 and 8
K2_EXTRA_SHAPES = ((32, 32, 3136, 64), (16, 32, 3136, 64), (32, 64, 2304, 64),
                   (16, 32, 2304, 64), (64, 32, 3136, 8))
K3B_TOL = dict(atol=1e-2, rtol=1e-2)  # bf16 dx / dW (fp32 sums, split dy); db fp32
# K3's other main-path shapes (layer, M, K, N, ReLU), beside bucket 64's: the
# act tick (16 lanes x 32 taus) and the learner's online pass at s' (K 32) on
# F 3136, the jaxgame trunk (F 2304) at M 2048 and 512, and the R2D2 head over
# B x T = 32 x 80 rows and at a 16-lane tick; K3-bwd takes those with M >= 512
K3_EXTRA_SHAPES = (("hidden", 512, 3136, 512, True), ("value_out", 512, 512, 1, False),
                   ("advantage_out", 512, 512, 18, False), ("hidden", 1024, 3136, 512, True),
                   ("value_out", 1024, 512, 1, False), ("advantage_out", 1024, 512, 18, False),
                   ("hidden_jaxgame", 2048, 2304, 512, True),
                   ("hidden_jaxgame", 512, 2304, 512, True),
                   ("r2d2_hidden", 2560, 512, 512, True), ("r2d2_hidden", 16, 512, 512, True),
                   ("r2d2_advantage_out", 2560, 512, 18, False))
HOST_CALLS = 100  # eager calls per host-time reading
HOST_ROUNDS = 5  # readings per host time (median reported)
K4B_TOL = dict(atol=1e-6, rtol=1e-6)  # fp32, one product and one subtraction per element
# K2g-bwd: the CPU tests' bound for bf16 gradients, 4 bf16 ulps (2^-6) of each
# element and of the output's largest element: dphi sums 64 products of dh and
# psi, and psi = bf16(Dense) can round one ulp apart under two fp32 orders of
# the Dense product, which an elementwise 1e-2 misses where the sum cancels
GRAD_BF16_REL = 2.0 ** -6
SERVE_KERNELS = ("K2_tau_embed", "K3_noisy_linear", "K4_dueling_head")  # the serving path's
# per learn step: three forwards (K2, K3 x4 each), one heads launch (K4: a*,
# both gathers and td_target), K1, and the backward (K4-bwd, K3-bwd x4, K2-bwd)
LEARN_PER_STEP = {"K1_quantile_huber": 1, "K2_tau_embed": 3, "K2_tau_embed_bwd": 1,
                  "K3_noisy_linear": 12, "K3_noisy_linear_bwd": 4, "K4_dueling_head": 1,
                  "K4_dueling_head_bwd": 1}
LEARN_STEPS = 200  # steady-state learn steps of the `learn` phase
LEARN_WARMUP = 10  # steps before it (first-call costs, pinned buffers)
LEARN_LANES = 16  # replay lanes, as configs/reference_atari_defaults.json
LEARN_FILL = 512  # env ticks of synthetic frames per lane (8,192 transitions)
LEARN_CAPACITY = 16 * 1024  # replay slots (the config's 1,000,000 is 7 GB of host RAM)
LEARN_TARGET_PERIOD = 100  # so a target copy falls inside the run (config: 8,000)
PROFILE_STEPS = 20
# learn_parity: one full-width step, kernels (card) vs plain twins (CPU), bf16
# model: loss, priorities and q means within the model's quantile tolerance
LEARN_PATH_TOL = dict(rtol=2e-2, atol=PATH_TOL)
LEARN_GNORM_RTOL = 2e-2  # the gradient's global norm, bf16 cotangents
LEARN_UPDATE_RTOL = 5e-2  # each tensor's Adam update, relative L2 (bf16 gradients)
REPLAY_REL = 1e-6  # K8's f32 reward, prob and weight; K6 at omega != 0.5 (powf vs torch.pow)
K5_BOUNDARY = 1e-6  # K5 vs an fp64 cdf: ids may differ only within this * sum p of a boundary
REPLAY_BATCH = 32  # B of the replay kernels, as the reference config
ANAKIN_STEPS = 200  # fused steps of the `anakin` phase
ANAKIN_FILL = 2000  # append ticks of 16 lanes before it (32,000 transitions)
ANAKIN_FRAME_POOL = 64  # distinct synthetic ticks cycled through the fill
# per fused step at sample_groups 1: one K5 and K8 plus the learn step's kernels;
# the write-back (K6) runs inside the learn step's K1 launch
ANAKIN_PER_STEP = {"K1_quantile_huber": 1, "K2_tau_embed": 3, "K2_tau_embed_bwd": 1,
                   "K3_noisy_linear": 12, "K3_noisy_linear_bwd": 4, "K4_dueling_head": 1,
                   "K4_dueling_head_bwd": 1, "K5_replay_draw": 1, "K6_replay_writeback": 0,
                   "K7_replay_append": 0, "K8_replay_assemble": 1, "K5f_frontier_draw": 0,
                   "K6f_frontier_writeback": 0, "K10q_quantize": 0, "K10g_noisy_linear_q": 0,
                   "K10d_dequantize": 0, "K9_lstm": 0, "K9_lstm_bwd": 0, "K11_r2d2_td": 0,
                   "K8s_seq_stack": 0, "K7s_seq_append": 0, "K5s_seq_draw": 0,
                   "K8s_seq_assemble": 0, "K6s_seq_writeback": 0, "K12_device_games": 0,
                   "K2g_tau_embed_game": 0, "K2g_tau_embed_game_bwd": 0,
                   "K4m_dueling_head_mask": 0, "K4l_dueling_head_logp": 0}
ANAKIN_FOLDED_PER_STEP = {"K6_replay_writeback": 1, "K6f_frontier_writeback": 0,
                          "K6s_seq_writeback": 0}
FRONTIER_SHARDS = 2  # kernels_frontier: the mirror of 2 shards, the second one dead
FRONTIER_REL = 1e-6  # K5f prob and weight: K5's chained total against torch's sum
APEX_FILL = 2000  # append ticks of 16 lanes before the apex runs (32,000 transitions)
APEX_STEPS = 200  # learn steps of each apex run (host sampling, then device sampling)
APEX_WARMUP = 8  # learn steps before each run's timed window
APEX_PUBLISH = 100  # weight_publish_interval of the apex phases (config: 400)
APEX_FRAME_POOL = 64  # distinct synthetic ticks of frames cycled through the fill
REPLAY_KERNELS = ("K5_replay_draw", "K6_replay_writeback", "K7_replay_append",
                  "K8_replay_assemble")
QUANT_KERNELS = ("K10q_quantize", "K10g_noisy_linear_q", "K10d_dequantize")
# a quantized dispatch: K10d, K2, K10g x4 (two heads of two layers), K4, and no K3
QUANT_PER_DISPATCH = {"K10d_dequantize": 1, "K2_tau_embed": 1, "K10g_noisy_linear_q": 4,
                      "K4_dueling_head": 1, "K3_noisy_linear": 0, "K10q_quantize": 0}
QUANT_REQUESTS = 512  # serve_quant: requests per mode, from CLIENTS clients
APEX_QUANT_STEPS = 120  # learn steps of the apex_quant run, publishes every APEX_QUANT_PUBLISH
APEX_QUANT_PUBLISH = 40
# train_apex_quant: four seeds fixed before any run read them (ROADMAP.md C1 step 1)
QUANT_CATCH_SEEDS = (33, 34, 35, 36)
# train, train_anakin, train_apex: seed 7 is the JAX tests' own; 56-58 were
# fixed before any run of them was read.  One seed is one draw from a spread
# that correct changes of rounding move (PERF.md, C5), so the bar takes four.
IQN_CATCH_SEEDS = (7, 56, 57, 58)
# R2D2 (--role single --architecture r2d2), the reference config's widths
R2D2_KERNELS = ("K9_lstm", "K9_lstm_bwd", "K11_r2d2_td", "K8s_seq_stack")
R2D2_PARAMS = 8_621_254  # R2D2Net at 84x84x4, LSTM 512, hidden 512, 18 actions
R2D2_SEQS = 256  # sequences of the learn_r2d2 replay (the config's 1,000,000 // 120 is 7 GB)
R2D2_FILL_TICKS = 1400  # append ticks of 16 lanes: 120 + 15 x 80 fill every slot, then wrap
R2D2_FRAME_POOL = 64  # distinct synthetic ticks of frames cycled through the fill
R2D2_WARMUP = 5
R2D2_STEPS = 50
R2D2_TARGET_PERIOD = 20  # so target copies fall inside the run (config: 8,000)
R2D2_PROFILE_STEPS = 10
R2D2_RESET_P = 0.05  # kernels_r2d2: share of steps with a planted LSTM reset
R2D2_REPS = 20  # kernels_r2d2: timed repetitions of the ms-long K9 / K9-bwd / cuDNN calls
# per learn step: K8s-stack 1; K9 4 (online and target, burn-in and train);
# K9-bwd 1; K3 8 (two nets x four head layers); K3-bwd 4; K4 2 (online
# gather, target combine); K4-bwd 1; K11 1; nothing else
R2D2_PER_STEP = {"K9_lstm": 4, "K9_lstm_bwd": 1, "K11_r2d2_td": 1, "K8s_seq_stack": 1,
                 "K3_noisy_linear": 8, "K3_noisy_linear_bwd": 4, "K4_dueling_head": 2,
                 "K4_dueling_head_bwd": 1}
K9_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums of 512 (2048) products per step, other order, 120 steps
K11_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32, summation order only
R2D2_PARITY_BATCH = 32
R2D2_CATCH_SEEDS = (3, 4, 5, 6)  # train_r2d2: fixed before any run read them
# R2D2 anakin (--role anakin --architecture r2d2): the device sequence replay
SEQ_KERNELS = ("K7s_seq_append", "K5s_seq_draw", "K8s_seq_assemble", "K6s_seq_writeback")
SEQ_P_TERM, SEQ_P_TRUNC = 0.002, 0.001  # synthetic ticks: rare terminals and truncations
SEQ_KERNEL_TICKS = 400  # kernels_r2d2_anakin: K7s ticks of kernel and twin (the ring wraps)
ANAKIN_R2D2_PAST_GATE = 16  # anakin_r2d2: sequences filled past the warm gate
ANAKIN_R2D2_WARMUP = 5
ANAKIN_R2D2_STEPS = 50
ANAKIN_R2D2_PROFILE_STEPS = 10
RING_R2D2_MIN_BYTES = 7_000_000_000  # the uncut ring of 8,333 sequences: ~7.12 GB
# per learn step: R2D2_PER_STEP's learner, plus one draw (K5s) and one gather
# (K8s); the write-back (K6s) runs inside K11's launch; nothing else
ANAKIN_R2D2_PER_STEP = {**R2D2_PER_STEP, "K5s_seq_draw": 1, "K8s_seq_assemble": 1,
                        "K6s_seq_writeback": 0}
ANAKIN_R2D2_FOLDED_PER_STEP = {"K6_replay_writeback": 0, "K6f_frontier_writeback": 0,
                               "K6s_seq_writeback": 1}
ACT_PROFILE_TICKS = 10  # anakin_r2d2: act_append ticks in the tick profile
ANAKIN_R2D2_PARITY_SEQS = 300  # anakin_r2d2_parity: ring of the step against the CPU
ANAKIN_R2D2_PARITY_TICKS = 1700  # 16 lanes: the 300 rows wrap
R2D2_ANAKIN_CATCH_SEEDS = (3, 4, 5, 6)  # train_anakin_r2d2: fixed before any run read them
# device games (K12) and the fully fused anakin (jaxgame:breakout)
GAME_NAMES = ("catch", "breakout", "freeway", "asterix", "invaders",
              "catch@var", "breakout@var", "freeway@var", "asterix@var", "invaders@var")
GAME_LANES = (16, 4096)  # the training width, and a width where the bytes count
GAME_CHECK_TICKS = 100  # kernels_games: auto-reset ticks of kernel and twin per game and width
GAME_PLAIN_REPS = 5  # kernels_games: timed repetitions of the twin's ms-long eager tick
FUSED_SEGMENTS = 6  # anakin_fused: timed warm segments after one warm-up segment
# per fused tick: the act (K2 1, K3 4, K4 1), the games' tick (K12 1), the append (K7 1)
FUSED_PER_TICK = {"K2_tau_embed": 1, "K3_noisy_linear": 4, "K4_dueling_head": 1,
                  "K12_device_games": 1, "K7_replay_append": 1}
RING_FUSED_MIN_BYTES = 6_400_000_000  # 16 lanes x 62,500 slots of 80x80 frames
FUSED_PARITY_TICKS = 24  # anakin_fused_parity: one segment, warm on its last tick
FUSED_CATCH_SEEDS = (7, 53, 54, 55)  # train_anakin_fused: fixed before any run read them
# multi-game Ape-X (--games) with replay reuse: the four-game suite of 3, 5, 4 and 3 actions
MT_GAMES = "jaxgame:breakout,jaxgame:asterix,jaxgame:invaders,jaxgame:freeway"
MT_KERNELS = ("K2g_tau_embed_game", "K2g_tau_embed_game_bwd", "K4m_dueling_head_mask",
              "K4l_dueling_head_logp")
MT_REPLAY_RATIO = 2
MT_METRICS = 50  # apex_mt: metrics_interval, so games and learn rows fall in the run (config: 1,000)
MT_WINDOW_TICKS = 40  # apex_mt: env ticks after the learn_start backlog's tick
# apex_mt: learn_start, cut from the reference's 20,000 frames so that the
# backlog at the first warm tick is 500 sampled batches, not 5,000 (printed
# in the phase's cuts): the same learn step repeated, ~200 s of the script
MT_LEARN_START = 2_000
MT_PROFILE_FROM = 24  # apex_mt: the profiler spans window ticks 24 .. 24 + MT_PROFILE_TICKS
MT_PROFILE_TICKS = 8
# per sampled batch at K = 2: two logp forwards (K2g, K3 x4, K4l) and two
# learn passes (select, target and online: K2g, K3 x4 each; one heads launch,
# counted as K4m since its select head is masked; K1; backward: K4-bwd,
# K3-bwd x4, K2g-bwd); nothing else (no unmasked K4)
MT_PER_BATCH = {"K2g_tau_embed_game": 8, "K3_noisy_linear": 32, "K4m_dueling_head_mask": 2,
                "K4l_dueling_head_logp": 2, "K1_quantile_huber": 2, "K4_dueling_head_bwd": 2,
                "K3_noisy_linear_bwd": 8, "K2g_tau_embed_game_bwd": 2}
# per act tick: K2g, K3 x4, K4m (the env's K12 launches are per lane step and reset)
MT_PER_ACT = {"K2g_tau_embed_game": 1, "K3_noisy_linear": 4, "K4m_dueling_head_mask": 1}


def with_folded(counts, folded):
    """A phase's launch counts for the kernels line, with each folded
    kernel's runs inside another launch under "folded:<name>"."""
    return {**counts, **{f"folded:{name}": n for name, n in folded.items()}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
def time_ms(torch, fn, graph: bool = True, reps: int = REPS) -> float:
    """Median device time of one ``fn()`` in ms: CALLS_PER_REPLAY calls are
    captured in a CUDA graph (so host launch overhead is not timed), and each
    of ``reps`` replays is bracketed by CUDA events.  ``graph=False`` brackets
    CALLS_PER_REPLAY eager calls instead (K9's unrolls, cuDNN's LSTM): fair
    where one call keeps the device busy longer than its launch takes."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if not graph:
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS_PER_REPLAY):
                fn()
            end.record()
            samples.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) / CALLS_PER_REPLAY for s, e in samples)
        return times[len(times) // 2]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS_PER_REPLAY):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        samples.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) / CALLS_PER_REPLAY for s, e in samples)
    return times[len(times) // 2]


def host_us(torch, fn) -> float:
    """Host time of one wrapper call in us: the median over HOST_ROUNDS of
    HOST_CALLS eager calls enqueued back to back on the host clock, each
    round followed by a sync that is not timed."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(HOST_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        rounds.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return sorted(rounds)[HOST_ROUNDS // 2]


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def errors(torch, got, want, tol):
    diff = (got.float() - want.float()).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.float().abs().clamp_min(1e-6)).max().item()
    ok = bool(torch.all(diff <= tol["atol"] + tol["rtol"] * want.float().abs()).item())
    return max_abs, max_rel, ok


# ------------------------------------------------------------------ phases
def phase_kernels(torch, cfg):
    """Each kernel against its plain twin at the bucket-64 full-width shapes."""
    from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import dueling_head, dueling_head_plain
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
        forward_plan,
        noisy_linear,
        noisy_linear_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import tau_embed, tau_embed_plain
    from rainbow_iqn_apex_tpu_torch.models.layers import _f, trunk_features

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    batch, taus_n = BUCKET, cfg.num_quantile_samples
    m, feat, cos_n = batch * taus_n, trunk_features(cfg.frame_height, cfg.frame_width), cfg.num_cosines
    hidden, actions = cfg.hidden_size, 18

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}

    # K2: bucket 64's shape, then each other main-path shape (K2_EXTRA_SHAPES)
    for b_, n_, f_, c_ in ((batch, taus_n, feat, cos_n),) + K2_EXTRA_SHAPES:
        rows_ = b_ * n_
        taus = torch.rand((b_, n_), generator=gen, device=dev)
        w_e = randn(f_, c_, scale=c_ ** -0.5, dtype=bf)
        b_e = randn(f_, scale=0.1)
        phi = randn(b_, f_).relu().to(bf)
        args = (taus, w_e, b_e, phi)
        got, want = tau_embed(*args), tau_embed_plain(*args)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(torch, got, want, K2_TOL)
        nbytes = rows_ * 4 + f_ * c_ * 2 + f_ * 4 + b_ * f_ * 2 + rows_ * f_ * 2
        bms, by = bound_ms(nbytes, 2 * rows_ * f_ * c_, BF16_FLOPS)
        k_ms = time_ms(torch, lambda: tau_embed(*args))
        p_ms = time_ms(torch, lambda: tau_embed_plain(*args))
        emit({"phase": "kernels", "kernel": "K2_tau_embed", "shape": [rows_, f_, c_],
              "batch": b_, "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K2_TOL,
              "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None,
              "bound_ms": bms, "bound_by": by})
        check(ok, f"K2 {[rows_, f_, c_]} disagrees with its plain twin: max abs {max_abs}")
        if (b_, n_, f_, c_) == (batch, taus_n, feat, cos_n):
            results["K2_tau_embed"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                           bound_ms=bms, bound_by=by, library_ms=None)

    # K3: every (N, noise, ReLU) the serving path can ask for, then each other
    # main-path shape (K3_EXTRA_SHAPES) in both modes ------------------------
    x_hidden = randn(m, feat, dtype=bf)
    x_out = randn(m, hidden).relu().to(bf)

    def k3_layer(x, n):
        k = x.shape[1]
        return dict(x=x, w_mu=randn(n, k, scale=k ** -0.5, dtype=bf), b_mu=randn(n, scale=0.1),
                    w_sigma=(randn(n, k).abs() * 0.5 * k ** -0.5).to(bf),
                    b_sigma=randn(n).abs() * 0.5 * k ** -0.5, f_in=_f(randn(k)), f_out=_f(randn(n)))

    def k3_case(p, layer, noisy, relu):
        x = p["x"]
        rows, k = x.shape
        n = p["w_mu"].shape[0]
        a = [x, p["w_mu"], p["b_mu"]]
        if noisy:
            a += [p["w_sigma"], p["b_sigma"], p["f_in"], p["f_out"]]
        got = noisy_linear(*a, relu=relu)
        want = noisy_linear_plain(*a, relu=relu)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(torch, got, want, K3_TOL)
        products = 2 if noisy else 1
        nbytes = (rows * k * 2 + products * n * k * 2 + products * n * 4 + rows * n * 4
                  + (k * 4 + n * 4 if noisy else 0))
        bms, by = bound_ms(nbytes, products * 2 * rows * n * k, BF16_FLOPS)
        k_ms = time_ms(torch, lambda: noisy_linear(*a, relu=relu))
        p_ms = time_ms(torch, lambda: noisy_linear_plain(*a, relu=relu))
        if noisy:  # two calls and the scale; x * f_in formed outside the timing
            xe, b_bf = x * p["f_in"].to(bf), (p["b_mu"] + p["b_sigma"] * p["f_out"]).to(bf)
            fo_bf, w_sg = p["f_out"].to(bf), p["w_sigma"]
            lib = "F.linear(x, W_mu, b) + F.linear(x * f_in, W_sigma) * f_out (two calls)"

            def lib_fn():
                return torch.addcmul(torch.nn.functional.linear(x, p["w_mu"], b_bf),
                                     torch.nn.functional.linear(xe, w_sg), fo_bf)
        else:
            b_bf, lib = p["b_mu"].to(bf), "F.linear"

            def lib_fn():
                return torch.nn.functional.linear(x, p["w_mu"], b_bf)
        lib_ms = time_ms(torch, lib_fn)
        emit({"phase": "kernels", "kernel": "K3_noisy_linear", "layer": layer,
              "shape": [rows, k, n], "noisy": noisy, "relu": relu, "path": forward_plan(rows, n),
              "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K3_TOL, "ok": ok,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "library": lib,
              "bound_ms": bms, "bound_by": by})
        check(ok, f"K3 ({layer} {[rows, k, n]}, noisy={noisy}, relu={relu}) disagrees: "
              f"max abs {max_abs}")
        return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                    max_abs_err=max_abs)

    layers = {hidden: ("hidden", k3_layer(x_hidden, hidden)),
              actions: ("advantage_out", k3_layer(x_out, actions)),
              1: ("value_out", k3_layer(x_out, 1))}
    k3 = {}
    for n, (layer, p) in layers.items():
        for noisy in (False, True):
            for relu in (False, True):
                k3[(n, noisy, relu)] = k3_case(p, layer, noisy, relu)
    for layer, rows, k, n, relu in K3_EXTRA_SHAPES:
        x = randn(rows, k).relu().to(bf) if k <= hidden else randn(rows, k, dtype=bf)
        p = k3_layer(x, n)
        for noisy in (False, True):
            k3[(layer, rows, noisy)] = k3_case(p, layer, noisy, relu)
    for noisy in (False, True):  # the wrapper's host time per call (launch plan, maps, ctypes)
        p = layers[hidden][1]
        a = [p["x"], p["w_mu"], p["b_mu"]] + (
            [p["w_sigma"], p["b_sigma"], p["f_in"], p["f_out"]] if noisy else [])
        emit({"phase": "kernels", "kernel": "K3_noisy_linear", "noisy": noisy,
              "shape": [m, feat, hidden],
              "host_us_per_call": host_us(torch, lambda: noisy_linear(*a, relu=True))})
    k3_max_abs = max(c["max_abs_err"] for c in k3.values())
    # the greedy main path per dispatch: two hidden layers (ReLU), value_out, advantage_out
    path = [k3[(hidden, False, True)], k3[(hidden, False, True)],
            k3[(1, False, False)], k3[(actions, False, False)]]
    results["K3_noisy_linear"] = dict(
        max_abs_err=k3_max_abs,
        **{key: sum(c[key] for c in path) for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=path[0]["bound_by"])

    # K4 -----------------------------------------------------------------
    value, adv = randn(m, 1), randn(m, actions)
    got, want = dueling_head(value, adv, taus_n), dueling_head_plain(value, adv, taus_n)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = 0.0, 0.0, True
    for g, w in zip(got[:2], want[:2]):
        a_err, r_err, good = errors(torch, g, w, K4_TOL)
        max_abs, max_rel, ok = max(max_abs, a_err), max(max_rel, r_err), ok and good
    top2 = torch.sort(want[1], dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > K4_TOL["atol"]
    ok = ok and bool(torch.equal(got[2][clear], want[2][clear]))
    tie = torch.zeros((4 * 3, 5), device=dev)
    tie[:, 2] = tie[:, 4] = 1.0
    ok = ok and dueling_head(torch.zeros((4 * 3, 1), device=dev), tie, 3)[2].tolist() == [2] * 4
    nbytes = m * 4 + 2 * m * actions * 4 + batch * actions * 4 + batch * 4
    bms, by = bound_ms(nbytes, 4 * m * actions, FP32_FLOPS)
    k_ms = time_ms(torch, lambda: dueling_head(value, adv, taus_n))
    p_ms = time_ms(torch, lambda: dueling_head_plain(value, adv, taus_n))
    emit({"phase": "kernels", "kernel": "K4_dueling_head", "shape": [batch, taus_n, actions],
          "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K4_TOL, "ok": ok,
          "kernel_ms": k_ms,
          "plain_ms": p_ms, "library_ms": None, "bound_ms": bms})
    check(ok, f"K4 disagrees with its plain twin (max abs {max_abs}) or breaks a tie wrongly")
    results["K4_dueling_head"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=bms, bound_by=by, library_ms=None)
    return results


def check_heads(torch, where, batch, taus, actions, gen, counts=None, gamma_n=0.99 ** 3):
    """K4's heads mode against its twin on the learn step's three heads
    (``taus`` = (K, N', N)): a* equal where the select q's top two are apart
    (and on a planted tie, to its first index), inside each row's game when
    masked (``counts``: the games' action counts), z_online, on_q, z_next
    and td_target within K4_TOL; an out-of-range action gathers NaN.  Emits
    and returns its row: the heads launch beside its twin, the three K4
    launches and two elementwise ops it replaces, and the bound."""
    from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
        dueling_gather,
        dueling_head,
        dueling_head_plain,
        dueling_learn,
        dueling_learn_plain,
    )

    dev = torch.device("cuda", 0)
    k, n_prime, n = taus

    def head(t):
        return (torch.randn((batch * t, 1), generator=gen, device=dev),
                torch.randn((batch * t, actions), generator=gen, device=dev), t)

    select, target, online = head(k), head(n_prime), head(n)
    select[1].view(batch, k, actions)[0, :, 1] = 7.0  # row 0: actions 1 and 2 tie
    select[1].view(batch, k, actions)[0, :, 2] = 7.0
    take = torch.randint(0, actions, (batch,), generator=gen, device=dev, dtype=torch.int32)
    reward = torch.randn((batch,), generator=gen, device=dev)
    discount = torch.full((batch,), gamma_n, device=dev)
    discount[1] = 0.0  # a terminal row
    margs = (None, None)
    if counts is not None:
        game = (torch.arange(batch, device=dev, dtype=torch.int32) % len(counts)).contiguous()
        margs = (game, _mt_mask(torch, counts, actions, dev))
        take = (take % torch.tensor(counts, device=dev)[game.long()]).to(torch.int32)
    args = (select, target, online, take, reward, discount, *margs)
    got, want = dueling_learn(*args), dueling_learn_plain(*args)
    torch.cuda.synchronize()
    q_sel = dueling_head_plain(*select, *[x for x in margs if x is not None])[1]
    top2 = torch.sort(q_sel, dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > K4_TOL["atol"]
    clear[0] = True
    a_ok = bool(torch.equal(got[2][clear], want[2][clear])) and int(got[2][0]) == 1
    if counts is not None:
        a_ok = a_ok and bool(margs[1][margs[0].long(), got[2].long()].all())
    max_abs, ok = 0.0, True
    for g, w in [(got[0], want[0]), (got[1], want[1])] + [(g[clear], w[clear])
                                                         for g, w in zip(got[3:], want[3:])]:
        a_err, _, good = errors(torch, g, w, K4_TOL)
        max_abs, ok = max(max_abs, a_err), ok and good
    bad = take.clone()
    bad[0] = actions  # out of range: NaN, as jnp's take_along_axis fill mode gives
    nan_row = bool(torch.isnan(dueling_learn(select, target, online, bad, *args[4:])[0][0]).all())

    def three_launches():  # the parent's route: a*, both gathers, td_target's two ops
        a_star = dueling_head(*select, *[x for x in margs if x is not None])[2]
        z_next, _ = dueling_gather(*target, a_star)
        return dueling_gather(*online, take), reward[:, None] + discount[:, None] * z_next

    rows = batch * (k + n_prime + n)
    nbytes = (rows * 4 * (1 + actions) + 3 * batch * 4 + (batch * 4 + 4 * actions if counts else 0)
              + 2 * batch * n_prime * 4 + batch * n * 4 + batch * actions * 4 + batch * 4)
    bms, by = bound_ms(nbytes, 4 * rows * actions, FP32_FLOPS)
    row = dict(max_abs_err=max_abs, ms=time_ms(torch, lambda: dueling_learn(*args)),
               plain_ms=time_ms(torch, lambda: dueling_learn_plain(*args)),
               three_launch_ms=time_ms(torch, three_launches), bound_ms=bms, bound_by=by,
               library_ms=None, shape=[batch, k, n_prime, n, actions])
    emit({"phase": where, "kernel": "K4m_dueling_head_mask" if counts else "K4_dueling_head",
          "mode": "heads", "a_star_equal": a_ok, "out_of_range_gives_nan": nan_row, "tol": K4_TOL,
          "ok": ok, **row})
    check(ok and a_ok and nan_row, f"K4's heads mode disagrees with its twin at {where} (max abs "
          f"{max_abs}, a* equal {a_ok}) or an out-of-range action did not give NaN")
    return row


def phase_kernels_learn(torch, cfg):
    """Each learner kernel (K1 in both modes, K2-bwd, K3-bwd, K4 gather, K4-bwd
    in both modes) against its plain twin at the full-width learner shapes:
    B = 32, N = N' = 64, F = 3136, C = 64, hidden 512, 18 actions, M = B * N
    = 2048; the loss chain (K1 weighted, the seed, K4-bwd's loss mode) beside
    the parent's eight ops."""
    from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
        dueling_gather,
        dueling_gather_bwd,
        dueling_gather_bwd_plain,
        dueling_gather_plain,
        dueling_loss_bwd,
        dueling_loss_bwd_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear import (
        backward_plan,
        noisy_linear_bwd,
        noisy_linear_bwd_plain,
        noisy_linear_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import (
        quantile_huber,
        quantile_huber_plain,
        quantile_huber_weighted,
        quantile_huber_weighted_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
        _cos_features,
        tau_embed,
        tau_embed_bwd,
        tau_embed_bwd_plain,
    )
    from rainbow_iqn_apex_tpu_torch.models.layers import _f, trunk_features

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16
    batch, n, n_t = cfg.batch_size, cfg.num_tau_samples, cfg.num_tau_prime_samples
    m, feat, cos_n = batch * n, trunk_features(cfg.frame_height, cfg.frame_width), cfg.num_cosines
    hidden, actions = cfg.hidden_size, 18

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def check_all(pairs, tol):
        worst_abs, worst_rel, ok = 0.0, 0.0, True
        for got, want in pairs:
            a, r, good = errors(torch, got, want, tol)
            worst_abs, worst_rel, ok = max(worst_abs, a), max(worst_rel, r), ok and good
        return worst_abs, worst_rel, ok

    def worst_element(pairs):
        """|reference| where the largest absolute error sits, and that error
        in units of the bf16 spacing there (bf16 outputs only)."""
        worst, at, ulps = -1.0, None, None
        for got, want in pairs:
            diff = (got.float() - want.float()).abs().flatten()
            i = int(diff.argmax())
            if float(diff[i]) > worst:
                worst, at = float(diff[i]), float(want.float().flatten()[i].abs())
                ulps = (worst / 2.0 ** (math.floor(math.log2(at)) - 7)
                        if got.dtype == bf and at > 0 else None)
        return at, ulps

    def report(name, shape, tol, fn, plain, lib, nbytes, ops, peak, extra=None):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = check_all(zip(got, want), tol)
        err_at, err_ulps = worst_element(zip(got, want))
        bms, by = bound_ms(nbytes, ops, peak)
        k_ms, p_ms = time_ms(torch, fn), time_ms(torch, plain)
        lib_ms = None if lib is None else time_ms(torch, lib)
        emit({"phase": "kernels_learn", "kernel": name, "shape": shape, **(extra or {}),
              "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": tol, "ok": ok,
              "max_err_at_abs_ref": err_at, "max_err_bf16_ulps": err_ulps,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bms,
              "bound_by": by})
        check(ok, f"{name} {extra or ''} disagrees with its plain twin: max abs {max_abs}")
        return dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by)

    results = {}

    # K1 ------------------------------------------------------------------
    online, taus_o = randn(batch, n), torch.rand((batch, n), generator=gen, device=dev)
    target = randn(batch, n_t)
    target[0, :8] = online[0, :8]  # u == 0 pairs
    target[1, :8] = online[1, :8] + cfg.kappa  # |u| == kappa pairs (the quadratic branch)
    k1 = (online, taus_o, target, cfg.kappa)
    k1_bytes = (2 * batch * n + batch * n_t) * 4 + (2 * batch + batch * n) * 4
    per_sample_row = report(
        "K1_quantile_huber", [batch, n, n_t], K1_TOL,
        lambda: quantile_huber(*k1), lambda: quantile_huber_plain(*k1), None,
        nbytes=k1_bytes, ops=K1_OPS_PER_PAIR * batch * n * n_t, peak=FP32_FLOPS,
        extra={"mode": "per_sample"})
    # the weighted mode, the learn step's: pass 1 (no scale), then a reuse pass's
    weight = torch.rand((batch,), generator=gen, device=dev) + 0.1
    scale = torch.rand((batch,), generator=gen, device=dev) + 0.5
    k1w = {}
    for name, sc in (("weighted", None), ("weighted_scaled", scale)):
        args_w = (online, taus_o, target, weight, sc, cfg.kappa)
        first, second = quantile_huber_weighted(*args_w), quantile_huber_weighted(*args_w)
        torch.cuda.synchronize()
        repeat_equal = all(torch.equal(u, v) for u, v in zip(first, second))
        check(repeat_equal, f"K1's {name} mode differs on a repeat of one input")

        def parent(sc=sc):  # the parent's route: K1 per-sample, (w * scale,) w * loss, mean
            loss_b, td, grad = quantile_huber(*k1)
            w = weight if sc is None else weight * sc
            return torch.mean(w * loss_b), loss_b, td, grad
        k1w[name] = report(
            "K1_quantile_huber", [batch, n, n_t], K1_TOL,
            lambda args_w=args_w: quantile_huber_weighted(*args_w),
            lambda args_w=args_w: quantile_huber_weighted_plain(*args_w), None,
            nbytes=k1_bytes + batch * 4 * (1 if sc is None else 2) + 4,
            ops=K1_OPS_PER_PAIR * batch * n * n_t, peak=FP32_FLOPS,
            extra={"mode": name, "repeat_bit_equal": repeat_equal,
                   "parent_route_ms": time_ms(torch, parent)})
    results["K1_quantile_huber"] = dict(k1w["weighted"], per_sample=per_sample_row,
                                        scaled=k1w["weighted_scaled"])

    # K2-bwd: the learner's shape at the config's num_cosines and at 8 --------
    for c_ in (cos_n, 8):
        taus = torch.rand((batch, n), generator=gen, device=dev)
        w_e = randn(feat, c_, scale=c_ ** -0.5, dtype=bf)
        b_e = randn(feat, scale=0.1)
        phi = randn(batch, feat).relu().to(bf)
        dh = randn(m, feat, dtype=bf)
        k2 = (taus, w_e, b_e, phi, dh)
        cos_t = tau_embed(*k2[:4], save_cos=True)[1]  # what K2 saves for the backward
        dpre = randn(m, feat, dtype=bf)
        cos_m = _cos_features(taus, c_, bf).reshape(m, c_)
        res = report(
            "K2_tau_embed_bwd", [m, feat, c_], K2B_TOL,
            lambda: tau_embed_bwd(*k2, cos_t=cos_t), lambda: tau_embed_bwd_plain(*k2),
            lambda: torch.matmul(dpre.t(), cos_m),
            nbytes=(m * 4 + feat * c_ * 2 + feat * 4 + batch * feat * 2
                    + m * feat * 2 + batch * feat * 2 + feat * c_ * 2 + feat * 4),
            ops=2 * 2 * m * feat * c_, peak=BF16_FLOPS)
        if c_ == cos_n:
            results["K2_tau_embed_bwd"] = res

    # K3-bwd: the learner's noisy layers, then K3's other main-path shapes ----
    k3 = {}
    k3_max_abs = 0.0
    x_hidden = randn(m, feat, dtype=bf)
    x_out = randn(m, hidden).relu().to(bf)
    cases = [("hidden", x_hidden, hidden, True), ("value_out", x_out, 1, False),
             ("advantage_out", x_out, actions, False)]
    cases += [(layer, randn(rows, k).relu().to(bf) if k <= hidden else randn(rows, k, dtype=bf),
               n_out, relu) for layer, rows, k, n_out, relu in K3_EXTRA_SHAPES if rows >= 512]
    for name, x, n_out, relu in cases:
        rows, k = x.shape
        w_mu = randn(n_out, k, scale=k ** -0.5, dtype=bf)
        w_sigma = (randn(n_out, k).abs() * 0.5 * k ** -0.5).to(bf)
        f_in, f_out = _f(randn(k)), _f(randn(n_out))
        g = randn(rows, n_out)
        y = noisy_linear_plain(x, w_mu, randn(n_out, scale=0.1), w_sigma,
                               randn(n_out).abs() * 0.5 * k ** -0.5, f_in, f_out,
                               relu=True) if relu else None
        args = (g, y, x, w_mu, w_sigma, f_in, f_out)
        g_b, dys_b = g.to(bf), (g * f_out).to(bf)
        xe = (x * f_in.to(bf))

        def lib(g_b=g_b, dys_b=dys_b, x=x, xe=xe, w_mu=w_mu, w_sigma=w_sigma):
            torch.matmul(g_b, w_mu)
            torch.matmul(dys_b, w_sigma)
            torch.matmul(g_b.t(), x)
            torch.matmul(dys_b.t(), xe)

        plan = backward_plan(rows, n_out, k, True)
        # no atomics: a repeat of the same call gives the same bits
        first, second = noisy_linear_bwd(*args), noisy_linear_bwd(*args)
        torch.cuda.synchronize()
        repeat_equal = all(torch.equal(u, v) for u, v in zip(first, second))
        ops = 4 * 2 * rows * n_out * k
        res = report(
            "K3_noisy_linear_bwd", [rows, k, n_out], K3B_TOL,
            lambda: noisy_linear_bwd(*args), lambda: noisy_linear_bwd_plain(*args), lib,
            nbytes=(rows * n_out * 4 * (2 if relu else 1) + rows * k * 2 + 2 * n_out * k * 2
                    + (k + n_out) * 4 + rows * k * 2 + 2 * n_out * k * 2 + 2 * n_out * 4),
            ops=ops, peak=BF16_FLOPS,
            extra={"layer": name, "noisy": True, "relu": relu, "bn_w": plan.bn_w,
                   "splits": plan.splits, "repeat_bit_equal": repeat_equal,
                   # the hi / lo split's floor: twice the products at the card's peak
                   "split_floor_ms": 2 * ops / BF16_FLOPS * 1e3})
        check(repeat_equal, f"K3-bwd ({name} {[rows, k, n_out]}) differs on a repeat")
        k3_max_abs = max(k3_max_abs, res["max_abs_err"])
        k3[(name, rows)] = res
    host_args = (randn(m, hidden), None, x_hidden, randn(hidden, feat, dtype=bf),
                 randn(hidden, feat, dtype=bf), _f(randn(feat)), _f(randn(hidden)))
    emit({"phase": "kernels_learn", "kernel": "K3_noisy_linear_bwd", "shape": [m, feat, hidden],
          "host_us_per_call": host_us(torch, lambda: noisy_linear_bwd(*host_args))})
    # one learn step runs it on two hidden layers and the two out layers
    path = [k3[("hidden", m)], k3[("hidden", m)], k3[("value_out", m)], k3[("advantage_out", m)]]
    results["K3_noisy_linear_bwd"] = dict(
        max_abs_err=k3_max_abs,
        **{key: sum(c[key] for c in path) for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=k3[("hidden", m)]["bound_by"])

    # K4: gather mode (checked here, timed in K4's row) and K4-bwd -------------
    value, adv = randn(m, 1), randn(m, actions)
    take = torch.randint(0, actions, (batch,), generator=gen, device=dev, dtype=torch.int32)
    got, want = dueling_gather(value, adv, n, take), dueling_gather_plain(value, adv, n, take)
    torch.cuda.synchronize()
    g_abs, g_rel, g_ok = check_all(zip(got, want), K4_TOL)
    bad = take.clone()
    bad[0] = actions  # out of range: NaN, as jnp's take_along_axis fill mode gives
    nan_row = bool(torch.isnan(dueling_gather(value, adv, n, bad)[0][0]).all().item())
    emit({"phase": "kernels_learn", "kernel": "K4_dueling_head", "mode": "gather",
          "max_abs_err": g_abs, "max_rel_err": g_rel, "tol": K4_TOL, "ok": g_ok,
          "out_of_range_gives_nan": nan_row})
    check(g_ok and nan_row, f"K4 gather mode disagrees with its twin (max abs {g_abs}) "
          "or an out-of-range action did not give NaN")
    dz = randn(batch, n)
    k4 = (dz, take, actions, True)
    dz_row = report(
        "K4_dueling_head_bwd", [batch, n, actions], K4B_TOL,
        lambda: dueling_gather_bwd(*k4), lambda: dueling_gather_bwd_plain(*k4), None,
        nbytes=batch * n * 4 + batch * 4 + m * 4 + m * actions * 4,
        ops=2 * m * actions, peak=FP32_FLOPS, extra={"mode": "dz"})
    # the loss mode, the learn step's: dz from the loss's cotangent (a reuse
    # pass's 2.5, say), the IS weights and K1's saved gradient
    d_loss = torch.full((), 2.5, device=dev)
    grad_k1 = quantile_huber_weighted(online, taus_o, target, weight, None, cfg.kappa)[3]
    k4l = (d_loss, weight, None, grad_k1, take, actions, True)

    def parent_bwd():  # MeanBackward, MulBackward, QuantileHuberFn's scale, K4-bwd
        d_ps = d_loss.expand(batch) / batch * weight
        return dueling_gather_bwd(d_ps[:, None] * grad_k1, take, actions, True)
    results["K4_dueling_head_bwd"] = dict(report(
        "K4_dueling_head_bwd", [batch, n, actions], K4B_TOL,
        lambda: dueling_loss_bwd(*k4l), lambda: dueling_loss_bwd_plain(*k4l), None,
        nbytes=4 + 2 * batch * 4 + batch * n * 4 + m * 4 + m * actions * 4,
        ops=2 * m * actions + 3 * m, peak=FP32_FLOPS,
        extra={"mode": "loss", "parent_route_ms": time_ms(torch, parent_bwd)}), dz=dz_row)

    # the chain between the heads launch and K3-bwd, forward and backward,
    # as the learn step runs it (the seed: autograd's ones_like of the loss)
    def chain():
        loss, _, _, grad = quantile_huber_weighted(online, taus_o, target, weight, None,
                                                   cfg.kappa)
        return dueling_loss_bwd(torch.ones_like(loss), weight, None, grad, take, actions, True)

    def parent_chain():
        loss_b, _, grad = quantile_huber(*k1)
        loss = torch.mean(weight * loss_b)
        d_ps = torch.ones_like(loss).expand(batch) / batch * weight
        return dueling_gather_bwd(d_ps[:, None] * grad, take, actions, True)
    got_c, want_c = chain(), parent_chain()
    torch.cuda.synchronize()
    c_abs, _, c_ok = check_all(zip(got_c, want_c), K4B_TOL)
    row = {"ms": time_ms(torch, chain), "parent_ms": time_ms(torch, parent_chain),
           "launches": 3, "parent_launches": 8, "max_abs_err": c_abs}
    emit({"phase": "kernels_learn", "kernel": "loss_chain", "shape": [batch, n, n_t, actions],
          "tol": K4B_TOL, "ok": c_ok, **row})
    check(c_ok, f"the loss chain's gradient differs from the parent route's: max abs {c_abs}")
    results["K1_quantile_huber"]["chain"] = row
    # K4's heads mode: the learn step's one K4 launch (timed in K4's row)
    results["K4_dueling_head_heads"] = check_heads(
        torch, "kernels_learn", batch, (cfg.num_quantile_samples, n_t, n), actions, gen,
        gamma_n=cfg.gamma ** cfg.multi_step)
    return results


def _learn_cfg(cfg):
    """The reference Atari config with the `learn` phase's cuts (printed)."""
    return cfg.replace(memory_capacity=LEARN_CAPACITY, learn_start=LEARN_LANES * LEARN_FILL // 2,
                       target_update_period=LEARN_TARGET_PERIOD, stall_timeout_s=0.0,
                       role="single")


def _fill_replay(cfg, np):
    """The port's PrioritizedReplay filled across the lanes with seeded
    random 84x84 uint8 frames, actions, rewards and terminals."""
    from rainbow_iqn_apex_tpu_torch.replay import PrioritizedReplay

    memory = PrioritizedReplay(
        cfg.memory_capacity, (cfg.frame_height, cfg.frame_width), history=cfg.history_length,
        n_step=cfg.multi_step, gamma=cfg.gamma, lanes=LEARN_LANES,
        priority_exponent=cfg.priority_exponent, priority_eps=cfg.priority_eps, seed=cfg.seed,
        use_native=cfg.use_native_sumtree)
    rng = np.random.default_rng(SEED)
    for _ in range(LEARN_FILL):
        memory.append_batch(
            rng.integers(0, 256, (LEARN_LANES, cfg.frame_height, cfg.frame_width), dtype=np.uint8),
            rng.integers(0, 18, LEARN_LANES), rng.normal(size=LEARN_LANES).astype(np.float32),
            rng.random(LEARN_LANES) < 0.01)
    return memory


def phase_learn(torch, cfg):
    """The full-width learner through the port's entry points: Agent,
    PrioritizedReplay, the prefetcher and the write-back ring, LEARN_STEPS
    steps with the steady state under forbid_host_sync(), then a profile of
    PROFILE_STEPS more."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.agents import Agent
    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.utils import hostsync
    from rainbow_iqn_apex_tpu_torch.utils.prefetch import make_replay_prefetcher
    from rainbow_iqn_apex_tpu_torch.utils.writeback import RingCommitter, WritebackRing

    cfg = _learn_cfg(cfg)
    cuts = {"frames": "synthetic seeded uint8 (no emulator on the machine)",
            "memory_capacity": cfg.memory_capacity, "learn_start": cfg.learn_start,
            "target_update_period": cfg.target_update_period}
    t0 = time.perf_counter()
    memory = _fill_replay(cfg, np)
    fill_s = time.perf_counter() - t0
    agent = Agent(cfg, 18, cfg.seed)  # cuda:0 by default
    check(agent.device.type == "cuda", "the agent did not pick the card by default")
    sup = TrainSupervisor(cfg)
    ring = WritebackRing(cfg.writeback_depth)
    prefetcher = make_replay_prefetcher(memory, cfg, lambda: priority_beta(cfg, 0), agent.device)
    committer = RingCommitter(ring, prefetcher.update_priorities, sup, agent.load_snapshot)
    losses, finite = [], []

    def one_step():
        idx, batch = prefetcher.get()
        info = agent.learn_batch(batch)
        retired = ring.push(agent.step, idx, info)
        if retired is not None:
            losses.append(retired.scalars["loss"])
            finite.append(retired.finite)
        return committer.commit(retired)

    try:
        for _ in range(LEARN_WARMUP):
            check(one_step(), "a warm-up learn step was not finite")
        check(committer.drain(), "a warm-up learn step was not finite")
        torch.cuda.synchronize()
        with torch.no_grad():
            target_before = torch.cat([p.flatten() for p in agent.state.target.parameters()])
        step0 = agent.step
        reset_launches()
        lat_ms = []
        t_run = time.perf_counter()
        try:
            with hostsync.forbid_host_sync():
                for _ in range(LEARN_STEPS):
                    t = time.perf_counter()
                    check(one_step(), "a learn step was not finite (rolled back)")
                    lat_ms.append((time.perf_counter() - t) * 1e3)
        except RuntimeError as e:  # CUDA's sync debug mode, or a HostSyncError
            raise SmokeFailure(f"a host sync in the steady-state learn loop: {e}")
        check(committer.drain(), "a learn step was not finite at the drain")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_run
        counts = dict(launches)
        with torch.no_grad():
            target_after = torch.cat([p.flatten() for p in agent.state.target.parameters()])
        copies = agent.step // cfg.target_update_period - step0 // cfg.target_update_period
        target_moved = not torch.equal(target_before, target_after)
        lat = np.sort(np.asarray(lat_ms))
        emit({"phase": "learn", "steps": LEARN_STEPS, "batch": cfg.batch_size,
              "taus": [cfg.num_quantile_samples, cfg.num_tau_prime_samples, cfg.num_tau_samples],
              "learn_steps_per_s": LEARN_STEPS / elapsed, "seconds": elapsed,
              "step_host_p50_ms": float(lat[len(lat) // 2]),
              "step_host_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
              "launches": counts,
              "launches_per_step": {k: v / LEARN_STEPS for k, v in counts.items()},
              "losses_finite": bool(all(np.isfinite(losses)) and all(finite)),
              "retired": len(losses), "target_copies": copies, "target_moved": target_moved,
              "rollbacks": sup.rollbacks, "replay_fill_s": fill_s, "cuts": cuts})
        for name, n in LEARN_PER_STEP.items():
            check(counts[name] == n * LEARN_STEPS,
                  f"{name} launched {counts[name]} times in {LEARN_STEPS} learn steps, want "
                  f"{n} a step")
        check(all(np.isfinite(losses)) and all(finite) and len(losses) >= LEARN_STEPS,
              "a non-finite loss in the learn phase")
        check(copies >= 1 and target_moved, "no target copy happened in the learn phase")
        check(sup.rollbacks == 0, "the learn phase rolled back")
        profile_learn(torch, agent, prefetcher, ring, committer)
    finally:
        prefetcher.close()
    return counts


def profile_learn(torch, agent, prefetcher, ring, committer):
    """Where the time of a full-width learn step goes: device time by kernel
    name from torch.profiler over PROFILE_STEPS steps, the device ops a step
    (kernels, copies and fills), and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            idx, batch = prefetcher.get()
            info = agent.learn_batch(batch)
            committer.commit(ring.push(agent.step, idx, info))
        committer.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile_learn", "steps": PROFILE_STEPS,
          "wall_us_per_step": wall_us / PROFILE_STEPS,
          "device_ops_per_step": sum(r[2] for r in rows) / PROFILE_STEPS if rows
          else "not measured",
          "device_us_per_step": device_us / PROFILE_STEPS if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_step": t / PROFILE_STEPS, "calls_per_step": c / PROFILE_STEPS}
                  for k, t, c in rows[:15]]})


def _learn_draws(torch, cfg, net, g):
    """The taus and noise of one learn step's select, target and online
    forwards, drawn on the CPU from ``g``: (for the CPU, for the card)."""
    dev = torch.device("cuda", 0)
    draws = {}
    for name, n in (("select", cfg.num_quantile_samples), ("target", cfg.num_tau_prime_samples),
                    ("online", cfg.num_tau_samples)):
        taus = torch.rand((cfg.batch_size, n), generator=g)
        noise = {k: (torch.randn(layer.in_features, generator=g),
                     torch.randn(layer.out_features, generator=g))
                 for k, layer in ((k, getattr(net, k)) for k in net.noisy_names)}
        draws[name] = (taus, noise)
    on_card = {k: (t.to(dev), {n: (a.to(dev), b.to(dev)) for n, (a, b) in nz.items()})
               for k, (t, nz) in draws.items()}
    return draws, on_card


def phase_learn_parity(torch, cfg):
    """One full-width learn step through the kernels on the card against the
    same step through the plain twins on the CPU: same state (a few steps
    in, so Adam's moments are not zero), batch, taus and noise."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.ops.learn import (
        build_learn_step,
        host_state,
        init_train_state,
        load_host_state,
    )
    from rainbow_iqn_apex_tpu_torch.agents import to_device_batch

    cfg = _learn_cfg(cfg)
    memory = _fill_replay(cfg, np)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    card = init_train_state(cfg, 18, cfg.seed)
    step = build_learn_step(cfg, 18)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(3):  # warm the moments on the card
        card, _ = step(card, to_device_batch(memory.sample(cfg.batch_size, 0.4), dev), gen)
    host = host_state(card)
    plain = load_host_state(init_train_state(cfg, 18, cfg.seed, device="cpu"), host)
    sample = memory.sample(cfg.batch_size, 0.4)
    draws, on_card = _learn_draws(torch, cfg, plain.net, torch.Generator().manual_seed(SEED + 1))
    card, k_info = step(card, to_device_batch(sample, dev), draws=on_card)
    t0 = time.perf_counter()
    plain, p_info = step(plain, to_device_batch(sample, cpu), draws=draws)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {}
    for key in ("loss", "priorities", "q_mean", "target_q_mean"):
        got, want = k_info[key].cpu().double(), p_info[key].double()
        err = (got - want).abs()
        out[key] = float(err.max())
        check(bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs())),
              f"learn_parity: {key} differs by {out[key]}")
    gn_rel = abs(k_info["grad_norm"].item() - p_info["grad_norm"].item()) / p_info["grad_norm"].item()
    check(gn_rel <= LEARN_GNORM_RTOL, f"learn_parity: grad_norm differs by {gn_rel} relative")
    before = host["params"]
    after_k = {k: v.cpu() for k, v in card.net.state_dict().items()}
    after_p = plain.net.state_dict()
    worst, worst_name = 0.0, ""
    for k in before:
        dk, dp = after_k[k] - before[k], after_p[k] - before[k]
        rel = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, k
    emit({"phase": "learn_parity", "batch": cfg.batch_size, "max_abs_err": out,
          "tol": LEARN_PATH_TOL, "grad_norm_rel_err": gn_rel, "grad_norm_rtol": LEARN_GNORM_RTOL,
          "update_rel_l2_worst": worst, "update_worst_tensor": worst_name,
          "update_rtol": LEARN_UPDATE_RTOL, "finite": [bool(k_info["finite"]), bool(p_info["finite"])],
          "cpu_step_s": cpu_s})
    check(worst <= LEARN_UPDATE_RTOL, f"learn_parity: the update of {worst_name} differs by {worst} (rel L2)")
    check(bool(k_info["finite"]) and bool(p_info["finite"]), "learn_parity: a non-finite step")


def phase_train(torch):
    """The port's training CLI: toy:catch with the scenario of
    tests/test_train_integration.py (_cfg), bf16 (the card's path takes no
    other compute dtype), 4,000 frames; the JAX test's own bar, over
    IQN_CATCH_SEEDS."""
    _catch_over_seeds("train", "single", IQN_CATCH_SEEDS)


def _catch_over_seeds(phase, role, seeds, env="toy:catch", every_run=False, **run_kw):
    """``role``'s catch scenario (``catch_bar``) at ``seeds``, one trainer
    process each, all at once (``catch_bar.run``; ``run_kw`` are its
    options); held to the scenario's bar: the mean of the evaluations above
    it (each of them with ``every_run``), and every run above its least
    count of learn steps.  Returns the runs."""
    from concurrent.futures import ThreadPoolExecutor

    from rainbow_iqn_apex_tpu_torch import catch_bar

    bar = catch_bar.BARS.get(role, catch_bar.BAR)
    min_steps = catch_bar.MIN_STEPS.get(role, catch_bar.MIN_LEARN_STEPS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(seeds)) as pool:
        runs = list(pool.map(lambda seed: catch_bar.run(role, seed, "cuda:0", **run_kw), seeds))
    elapsed = time.perf_counter() - t0
    failed = [r for r in runs if r["rc"] != 0]
    check(not failed, f"{phase}: a trainer failed: {failed[:1]}")
    evals = [r["eval_score_mean"] for r in runs]
    mean = sum(evals) / len(evals)
    row = {"phase": phase, "env": env, **run_kw, "seeds": list(seeds), "evals": evals,
           "eval_by_seed": {str(seed): e for seed, e in zip(seeds, evals)}, "eval_mean": mean,
           "bar": bar, "rule": "each run" if every_run else "mean",
           "train_returns": [r["train_return_mean"] for r in runs],
           "learn_steps": [r["learn_steps"] for r in runs], "seconds": elapsed}
    if "quant_publishes" in runs[0]:
        row["quant_publishes"] = [r["quant_publishes"] for r in runs]
    emit(row)
    if every_run:
        check(all(e > bar for e in evals), f"{phase}: a catch eval at or below {bar}: {evals}")
    else:
        check(mean > bar, f"{phase}: mean catch eval {mean} <= {bar}")
    check(all(r["learn_steps"] > min_steps for r in runs), f"{phase}: too few learn steps")
    return runs


# ------------------------------------------------------------ device replay
def _replay_ticks(np, rng, ticks, lanes, frame, p_term=0.05, p_trunc=0.02):
    """Seeded synthetic experience for ``ticks`` append ticks, made in bulk:
    (frames [ticks, L, H, W] uint8, actions, rewards, terminals,
    truncations, actor |TD|)."""
    terms = rng.random((ticks, lanes)) < p_term
    return (rng.integers(0, 256, (ticks, lanes, *frame), dtype=np.uint8),
            rng.integers(0, 18, (ticks, lanes)).astype(np.int32),
            rng.normal(size=(ticks, lanes)).astype(np.float32), terms,
            (rng.random((ticks, lanes)) < p_trunc) & ~terms,
            (rng.random((ticks, lanes)) * 2).astype(np.float32))


def _replay_of(cfg, seg, device):
    from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay

    return DeviceReplay(
        lanes=cfg.num_envs_per_actor, seg=seg, frame_shape=(cfg.frame_height, cfg.frame_width),
        history=cfg.history_length, n_step=cfg.multi_step, gamma=cfg.gamma,
        priority_exponent=cfg.priority_exponent, priority_eps=cfg.priority_eps, device=device)


def phase_kernels_replay(torch, cfg):
    """K5-K8 against their twins (on the same card tensors) at the replay's
    full-size shapes: K5 over the config's 1,000,000 priorities (G 1 and 4,
    B 32), K6 at B 32 with G 1 and 4, duplicate ids and zero slots, and
    folded into K1's weighted launch (N = N' = 64), K7 with 16 lanes of
    84x84 over a wrapping ring, K8 at B 32, h 4, n 3 (G 1 and 4, young and
    wrapped rings), then K7 and K8 at their grids' edges (``_replay_edges``).
    The kernels line takes the main path's shapes (G 1)."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels.replay_append import (
        replay_append,
        replay_append_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.replay_assemble import (
        replay_assemble,
        replay_assemble_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.quantile_huber import quantile_huber_weighted
    from rainbow_iqn_apex_tpu_torch.kernels.replay_draw import replay_draw, replay_draw_plain
    from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import (
        Writeback,
        replay_writeback,
        replay_writeback_plain,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n, batch = cfg.memory_capacity, REPLAY_BATCH
    eps, omega = cfg.priority_eps, cfg.priority_exponent
    lanes, h, n_step = cfg.num_envs_per_actor, cfg.history_length, cfg.multi_step
    hw = cfg.frame_height * cfg.frame_width
    results = {}

    # K5 ------------------------------------------------------------------
    k = torch.arange(batch, device=dev, dtype=torch.float32)
    for groups in (1, 4):
        dyadic = torch.randint(0, 9, (n,), generator=gen, device=dev).float() / 8
        u = torch.rand((groups, batch), generator=gen, device=dev)
        u[-1, -1] = 1.0 - 2.0 ** -24  # rounds u up to the total: clipped onto N - 1
        idx, total = replay_draw(dyadic, u)
        want, want_total = replay_draw_plain(dyadic, u)
        exact = bool(torch.equal(idx, want)) and float(total) == float(want_total)
        clipped = int(idx[-1, -1]) == n - 1
        dyadic_zero = not bool((dyadic[idx.reshape(-1)[:-1].long()] > 0).all())
        p = torch.rand((n,), generator=gen, device=dev)
        p[torch.rand((n,), generator=gen, device=dev) < 0.3] = 0.0
        u = torch.rand((groups, batch), generator=gen, device=dev)
        idx, total = replay_draw(p, u)
        twin, _ = replay_draw_plain(p, u)
        u_abs = (k + u) / batch * total
        cdf64 = torch.cumsum(p.double(), 0)
        ref = torch.searchsorted(cdf64, u_abs.double(), right=True).clamp(0, n - 1)
        differ = idx.long() != ref
        lo = torch.minimum(idx.long(), ref)[differ]
        near = (u_abs.double()[differ] - cdf64[lo]).abs() <= K5_BOUNDARY * float(total)
        random_zero = not bool((p[idx.long()] > 0).all())
        torch.cuda.synchronize()
        ok = exact and clipped and not dyadic_zero and not random_zero and bool(near.all())
        nbytes = n * 4 + 2 * groups * batch * 4 + 4
        bms, by = bound_ms(nbytes, n, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: replay_draw(p, u))
        p_ms = time_ms(torch, lambda: replay_draw_plain(p, u))
        lib_ms = time_ms(torch, lambda: torch.searchsorted(torch.cumsum(p, 0), u_abs, right=True))
        emit({"phase": "kernels_replay", "kernel": "K5_replay_draw", "shape": [n, groups, batch],
              "dyadic_exact": exact, "clip_to_last": clipped,
              "zero_slot_drawn": dyadic_zero or random_zero,
              "fp64_mismatches": int(differ.sum()),
              "fp64_mismatches_near_boundary": int(near.sum()),
              "twin_mismatches": int((idx != twin).sum()), "boundary_tol": K5_BOUNDARY,
              "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
              "bound_ms": bms, "bound_by": by})
        check(ok, f"K5 (G={groups}) disagrees: dyadic exact {exact}, clip {clipped}, zero slot "
                  f"drawn {dyadic_zero or random_zero}, far mismatches {int((~near).sum())}")
        if groups == 1:
            results["K5_replay_draw"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                             library_ms=lib_ms, bound_ms=bms, bound_by=by)

    # K6 ------------------------------------------------------------------
    base = torch.rand((n,), generator=gen, device=dev)
    ids = torch.randint(0, 64, (4, batch), generator=gen, device=dev, dtype=torch.int32)
    base[ids[0, :6].long()] = 0.0  # fenced slots, several of them drawn again
    td = torch.rand((4 * batch,), generator=gen, device=dev) * 3
    for groups in (4, 1):
        got, got_max = base.clone(), torch.tensor(1.5, device=dev)
        want, want_max = base.clone(), torch.tensor(1.5, device=dev)
        args = (ids[:groups].contiguous(), td[:groups * batch].contiguous(), eps, omega)
        replay_writeback(got, got_max, *args)
        replay_writeback_plain(want, want_max, *args)
        torch.cuda.synchronize()
        ok = (bool(torch.equal(got, want)) and bool(torch.equal(got_max, want_max))
              and bool((got[base == 0] == 0).all()))
        nbytes = groups * batch * 4 * 4 + 8
        bms, by = bound_ms(nbytes, 2 * groups * batch, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: replay_writeback(got, got_max, *args))
        p_ms = time_ms(torch, lambda: replay_writeback_plain(want, want_max, *args))
        emit({"phase": "kernels_replay", "kernel": "K6_replay_writeback",
              "shape": [groups, batch],
              "repeated_ids": int(groups * batch - ids[:groups].unique().numel()),
              "exact": ok, "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None,
              "bound_ms": bms, "bound_by": by})
        check(ok, f"K6 (G={groups}) disagrees with its twin or resurrected a zero slot")
        if groups == 1:
            results["K6_replay_writeback"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                                  library_ms=None, bound_ms=bms, bound_by=by)

    # K6 folded into K1's weighted launch, the fused step's route: bit-equal to
    # K1's launch then K6's, and to K6's twin on the launch's own td_abs
    n_tau, kappa = cfg.num_tau_samples, cfg.kappa
    failed, cases, timed = [], 0, None
    for groups, nan_td, outside in ((1, False, False), (4, True, False), (1, True, True),
                                    (4, False, True)):
        m = groups * batch
        loss_in = (torch.randn((m, n_tau), generator=gen, device=dev),
                   torch.rand((m, n_tau), generator=gen, device=dev),
                   torch.randn((m, n_tau), generator=gen, device=dev),
                   torch.rand((m,), generator=gen, device=dev))
        if nan_td:
            loss_in[2][1, 5] = float("nan")
        ids = torch.randint(0, 64, (groups, batch), generator=gen, device=dev,
                            dtype=torch.int32)  # repeats, and base's zero slots
        if outside:
            ids[0, 3], ids[-1, -1] = n, -1
        got, got_max = base.clone(), torch.tensor(1.5, device=dev)
        want, want_max = base.clone(), torch.tensor(1.5, device=dev)
        twin, twin_max = base.clone(), torch.tensor(1.5, device=dev)
        target = Writeback(got, got_max, ids, eps, omega)
        out = quantile_huber_weighted(*loss_in, None, kappa, target)
        ref = quantile_huber_weighted(*loss_in, None, kappa)
        replay_writeback(want, want_max, ids, ref[2], eps, omega)
        if not outside:
            replay_writeback_plain(twin, twin_max, ids, out[2], eps, omega)
        torch.cuda.synchronize()
        name = f"G {groups}{' NaN td' if nan_td else ''}{' ids outside' if outside else ''}"
        cases += 1
        if not (all(_same_bits(torch, a, b) for a, b in zip(out, ref))
                and _same_bits(torch, got, want) and _same_bits(torch, got_max, want_max)):
            failed.append(name + ": not K1 then K6")
        if not outside and not (_same_bits(torch, got, twin)
                                and _same_bits(torch, got_max, twin_max)):
            failed.append(name + ": not K6's twin")
        if not bool((got[base == 0] == 0).all()) or bool(torch.isnan(got_max)) != nan_td:
            failed.append(name + ": a zero slot resurrected or the maximum's NaN")
        if groups == 1 and not (nan_td or outside):
            timed = (loss_in, ids)
    loss_in, ids = timed
    ring, ring_max = base.clone(), torch.tensor(1.5, device=dev)
    target = Writeback(ring, ring_max, ids, eps, omega)

    def two_launches():
        out = quantile_huber_weighted(*loss_in, None, kappa)
        replay_writeback(ring, ring_max, ids, out[2], eps, omega)

    fold = dict(into="K1_quantile_huber", cases=cases, failed=failed,
                ms=time_ms(torch, lambda: quantile_huber_weighted(*loss_in, None, kappa, target)),
                two_launch_ms=time_ms(torch, two_launches),
                k1_weighted_ms=time_ms(torch, lambda: quantile_huber_weighted(*loss_in, None,
                                                                              kappa)))
    emit({"phase": "kernels_replay", "kernel": "K6_replay_writeback", "mode": "folded into K1",
          "shape": [1, batch, n_tau], "ok": not failed, **fold})
    check(not failed, f"K6 folded into K1: {failed}")
    results["K6_replay_writeback"]["folded"] = fold

    # K7 over a small wrapping ring of the config's lanes and frames --------
    seg = 64
    ring = _replay_of(cfg, seg, dev)
    got, want = ring.init_state(), ring.init_state()
    rng = np.random.default_rng(SEED + 12)
    ticks = 2 * seg + 5
    data = [torch.from_numpy(a).to(dev) for a in _replay_ticks(
        np, rng, ticks, lanes, (cfg.frame_height, cfg.frame_width))]
    for t in range(ticks):
        tick = [a[t] for a in data]
        if t % 3 == 0:
            tick[-1] = None  # max-priority insertion on every third tick
        ring.append(got, *tick)
        replay_append_plain(want, *tick, want.pos, want.filled, h, n_step, eps, omega)
        want.pos, want.filled = (want.pos + 1) % seg, min(want.filled + 1, seg)
    torch.cuda.synchronize()
    differing = [name for name in ("frames", "actions", "rewards", "terminals", "cuts",
                                   "priority", "max_priority")
                 if not torch.equal(getattr(got, name), getattr(want, name))]
    tick = [a[0] for a in data]
    pos, filled = got.pos, got.filled
    k_ms = time_ms(torch, lambda: replay_append(got, *tick, pos, filled, h, n_step, eps, omega))
    p_ms = time_ms(torch, lambda: replay_append_plain(want, *tick, pos, filled, h, n_step, eps,
                                                      omega))
    nbytes = lanes * (2 * hw + 2 * (4 + 4 + 1 + 1) + 4 + (h + 2) * 4 + 4)
    bms, by = bound_ms(nbytes, lanes * 8, FP32_FLOPS)
    emit({"phase": "kernels_replay", "kernel": "K7_replay_append",
          "shape": [lanes, seg, cfg.frame_height, cfg.frame_width], "ticks": ticks,
          "fields_differing": differing, "ok": not differing, "kernel_ms": k_ms,
          "plain_ms": p_ms, "library_ms": None, "bound_ms": bms, "bound_by": by})
    check(not differing, f"K7 disagrees with its twin on {differing}")
    results["K7_replay_append"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                       library_ms=None, bound_ms=bms, bound_by=by)

    # K8 on that (wrapped) ring and on a young one ---------------------------
    young = ring.init_state()
    for t in range(20):
        ring.append(young, *[a[t] for a in data])
    worst = 0.0
    for name, state, groups in (("wrapped", got, 1), ("wrapped", got, 4), ("young", young, 1)):
        ids = torch.randint(0, lanes * seg, (groups * batch,), generator=gen, device=dev,
                            dtype=torch.int32)
        _, total = replay_draw(state.priority, state.priority.new_empty((0, 1)))
        args = (state, ids, total, ring._gammas, 0.6, state.filled, h, n_step, batch)
        a, b = replay_assemble(*args), replay_assemble_plain(*args)
        torch.cuda.synchronize()
        exact = all(torch.equal(getattr(a, f), getattr(b, f))
                    for f in ("obs", "next_obs", "action", "discount"))
        rel = max(float(((getattr(a, f) - getattr(b, f)).abs()
                         / getattr(b, f).abs().clamp_min(1e-30)).max())
                  for f in ("reward", "prob", "weight"))
        abs_err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
                      for f in ("reward", "prob", "weight"))
        worst = max(worst, abs_err)
        ok = exact and rel <= REPLAY_REL
        m = groups * batch
        frames_read = min(2 * h, h + n_step)  # obs and next_obs share h - n frames
        nbytes = m * (frames_read * hw + 2 * h * hw + 4 + n_step * (4 + 1) + 2 * (h - 1)
                      + 4 + 4 * 4 + 4)
        bms, by = bound_ms(nbytes, m * n_step * 4, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: replay_assemble(*args))
        p_ms = time_ms(torch, lambda: replay_assemble_plain(*args))
        emit({"phase": "kernels_replay", "kernel": "K8_replay_assemble", "ring": name,
              "shape": [groups, batch, cfg.frame_height, cfg.frame_width, h], "n_step": n_step,
              "stacks_exact": exact, "max_rel_err": rel, "max_abs_err": abs_err,
              "rel_tol": REPLAY_REL, "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms,
              "library_ms": None, "bound_ms": bms, "bound_by": by})
        check(ok, f"K8 ({name}, G={groups}) disagrees with its twin: stacks exact {exact}, "
                  f"max rel {rel}")
        if groups == 1 and name == "wrapped":
            results["K8_replay_assemble"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                                 bound_ms=bms, bound_by=by)
    results["K8_replay_assemble"]["max_abs_err"] = worst
    _replay_edges(torch, np, dev)
    return results


def _same_bits(torch, a, b) -> bool:
    """Equal element for element, a NaN equal to a NaN."""
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _replay_edges(torch, np, dev):
    """K7 and K8 against their twins at the edges of their grids, each launch
    repeated and held bit-equal to the first: K7 at 40 lanes of 10 x 10 (the
    scalar warp past 32 lanes, the byte copy, history 7, n_step 5, a NaN actor
    priority on lanes 1 and 35), 16 of 84 x 84 at history 1, n_step 1, and 16
    of 80 x 80; K8 on those rings (wrapped and young) at every lane's slots
    around the write cursor, and in groups of 48 draws."""
    from rainbow_iqn_apex_tpu_torch.kernels.replay_append import replay_append_plain
    from rainbow_iqn_apex_tpu_torch.kernels.replay_assemble import (
        replay_assemble,
        replay_assemble_plain,
    )
    from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay

    ring_fields = ("frames", "actions", "rewards", "terminals", "cuts", "priority",
                   "max_priority")
    failed = []
    cases = 0
    for lanes, frame, h, n in ((40, (10, 10), 7, 5), (16, (84, 84), 1, 1), (16, (80, 80), 4, 3)):
        seg = 16
        ring = DeviceReplay(lanes=lanes, seg=seg, frame_shape=frame, history=h, n_step=n,
                            gamma=0.99, device=dev)
        got, want, young = ring.init_state(), ring.init_state(), ring.init_state()
        ticks = 2 * seg + 5
        data = [torch.from_numpy(a).to(dev) for a in _replay_ticks(
            np, np.random.default_rng(SEED + 13), ticks, lanes, frame, p_term=0.1, p_trunc=0.08)]
        nan = lanes > 32
        if nan:
            data[-1][20, 1::34] = float("nan")
        for t in range(ticks):
            tick = [a[t] for a in data]
            ring.append(got, *tick)
            replay_append_plain(want, *tick, want.pos, want.filled, h, n, ring.eps, ring.omega)
            want.pos, want.filled = (want.pos + 1) % seg, min(want.filled + 1, seg)
            if t < 9:
                ring.append(young, *tick)
        again = got.to(dev)
        tick = [a[0] for a in data]
        for state in (got, again):
            ring.append(state, *tick)
        replay_append_plain(want, *tick, want.pos, want.filled, h, n, ring.eps, ring.omega)
        torch.cuda.synchronize()
        name = f"K7 {lanes}x{frame[0]}x{frame[1]} h{h} n{n}"
        cases += 1
        if not all(_same_bits(torch, getattr(got, f), getattr(want, f)) for f in ring_fields):
            failed.append(name)
        if not all(_same_bits(torch, getattr(got, f), getattr(again, f)) for f in ring_fields):
            failed.append(name + " repeat")
        if nan and not bool(torch.isnan(got.max_priority)):
            failed.append(name + " NaN maximum")
        if nan:
            continue  # K8 on priorities without NaN
        for label, state in (("wrapped", got), ("young", young)):
            at = (state.pos + np.arange(-h - n, h + n + 1)) % seg
            around = (np.arange(lanes)[:, None] * seg + at[None, :]).reshape(-1)
            spread = np.random.default_rng(SEED + 14).integers(0, lanes * seg, 96)
            total = state.priority.sum()
            for kind, ids, group in (("cursor", around, around.size), ("groups of 48", spread, 48)):
                idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
                args = (state, idx, total, ring._gammas, 0.6, state.filled, h, n, group)
                a, b = replay_assemble(*args), replay_assemble(*args)
                c = replay_assemble_plain(*args)
                torch.cuda.synchronize()
                name = f"K8 {lanes}x{frame[0]}x{frame[1]} h{h} n{n} {label} {kind}"
                cases += 1
                if not (all(torch.equal(getattr(a, f), getattr(c, f))
                            for f in ("obs", "next_obs", "action", "discount"))
                        and all(bool(((getattr(a, f) - getattr(c, f)).abs()
                                      <= REPLAY_REL * getattr(c, f).abs()).all())
                                for f in ("reward", "prob", "weight"))):
                    failed.append(name)
                if not all(_same_bits(torch, getattr(a, f), getattr(b, f)) for f in a._fields):
                    failed.append(name + " repeat")
    emit({"phase": "kernels_replay", "kernel": "K7_K8_edges", "cases": cases, "failed": failed,
          "ok": not failed})
    check(not failed, f"K7 / K8 at their grids' edges: {failed}")


def phase_kernels_frontier(torch, cfg):
    """K5f and K6f against their twins on the card's tensors at the apex
    path's shapes: K5f over the config's 1,000,000-slot mirror (two shards,
    the second one dead, some zero slots), G = 8 (``draw_block``), B 32;
    K6f at B 32 with repeated ids and zero slots; K6f's queue between two
    draws, applied by K5f's first launch and by K6f's own.  Timed the same
    way."""
    from rainbow_iqn_apex_tpu_torch.kernels.frontier_draw import (
        frontier_draw,
        frontier_draw_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.frontier_writeback import (
        MirrorQueue,
        frontier_apply,
        frontier_apply_plain,
        frontier_writeback,
        frontier_writeback_plain,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    n, batch, groups = cfg.memory_capacity, cfg.batch_size, 8
    live = n // FRONTIER_SHARDS  # slots of the one live shard
    beta, n_items = 0.4, APEX_FILL * cfg.num_envs_per_actor
    results = {}

    # K5f: dyadic priorities (an exact cdf in any order), then random ones
    dyadic = torch.randint(0, 9, (n,), generator=gen, device=dev).float() / 8
    dyadic[live:] = 0.0
    u = torch.rand((groups, batch), generator=gen, device=dev)
    idx, prob, weight = frontier_draw(dyadic, u, beta, n_items)
    w_idx, w_prob, w_weight = frontier_draw_plain(dyadic, u, beta, n_items)
    exact = bool(torch.equal(idx, w_idx))
    rel = max(float(((a - b).abs() / b.abs()).max()) for a, b in ((prob, w_prob),
                                                                   (weight, w_weight)))
    zero_drawn = not bool((dyadic[idx.long()] > 0).all())
    dead_drawn = bool((idx >= live).any())
    p = torch.rand((n,), generator=gen, device=dev)
    p[torch.rand((n,), generator=gen, device=dev) < 0.3] = 0.0
    p[live:] = 0.0
    r_idx, r_prob, r_weight = frontier_draw(p, u, beta, n_items)
    t_idx, t_prob, t_weight = frontier_draw_plain(p, u, beta, n_items)
    cdf64 = torch.cumsum(p.double(), 0)
    k = torch.arange(batch, device=dev, dtype=torch.float64)
    u_abs = (k + u.double()) / batch * cdf64[-1]
    ref = torch.searchsorted(cdf64, u_abs, right=True).clamp(0, n - 1)
    differ = r_idx.long() != ref
    lo = torch.minimum(r_idx.long(), ref)[differ]
    near = (u_abs[differ] - cdf64[lo]).abs() <= K5_BOUNDARY * float(cdf64[-1])
    same = r_idx == t_idx
    r_rel = float(((r_prob - t_prob).abs() / t_prob.abs())[same].max())
    random_zero = not bool((p[r_idx.long()] > 0).all())
    torch.cuda.synchronize()
    ok = (exact and rel <= FRONTIER_REL and r_rel <= FRONTIER_REL and bool(near.all())
          and not (zero_drawn or dead_drawn or random_zero))
    nbytes = n * 4 + groups * batch * 4 + 3 * groups * batch * 4
    bms, by = bound_ms(nbytes, n, FP32_FLOPS)
    kf = torch.arange(batch, device=dev, dtype=torch.float32)

    def library():
        cdf = torch.cumsum(p, 0)
        ids = torch.searchsorted(cdf, (kf + u) / batch * cdf[-1], right=True).clamp_(max=n - 1)
        w = torch.pow(n_items * (p[ids] / cdf[-1]), -beta)
        return w / w.amax(dim=1, keepdim=True)

    k_ms = time_ms(torch, lambda: frontier_draw(p, u, beta, n_items))
    p_ms = time_ms(torch, lambda: frontier_draw_plain(p, u, beta, n_items))
    lib_ms = time_ms(torch, library)
    emit({"phase": "kernels_frontier", "kernel": "K5f_frontier_draw",
          "shape": [n, groups, batch], "dead_slots": n - live, "dyadic_exact": exact,
          "max_rel_err": max(rel, r_rel), "rel_tol": FRONTIER_REL,
          "zero_or_dead_slot_drawn": zero_drawn or dead_drawn or random_zero,
          "fp64_mismatches": int(differ.sum()), "fp64_mismatches_near_boundary": int(near.sum()),
          "twin_mismatches": int((~same).sum()), "boundary_tol": K5_BOUNDARY, "ok": ok,
          "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bms,
          "bound_by": by})
    check(ok, f"K5f disagrees: dyadic exact {exact}, rel {max(rel, r_rel)}, zero/dead slot "
              f"drawn {zero_drawn or dead_drawn or random_zero}, far mismatches "
              f"{int((~near).sum())}")
    results["K5f_frontier_draw"] = dict(max_abs_err=float((weight - w_weight).abs().max()),
                                        ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                        bound_ms=bms, bound_by=by)

    # K6f: one learn step's write-back, repeated ids and zero slots
    base = torch.rand((n,), generator=gen, device=dev)
    ids = torch.randint(0, 64, (batch,), generator=gen, device=dev, dtype=torch.int32)
    base.index_fill_(0, ids[:6].long(), 0.0)
    td = torch.randn((batch,), generator=gen, device=dev) * 3
    got, want = base.clone(), base.clone()
    args = (ids, td, cfg.priority_eps, cfg.priority_exponent)
    frontier_writeback(got, *args)
    frontier_writeback_plain(want, *args)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, want)) and bool((got[base == 0] == 0).all())
    bms, by = bound_ms(batch * 4 * 4, 2 * batch, FP32_FLOPS)
    k_ms = time_ms(torch, lambda: frontier_writeback(got, *args))
    p_ms = time_ms(torch, lambda: frontier_writeback_plain(want, *args))
    emit({"phase": "kernels_frontier", "kernel": "K6f_frontier_writeback", "shape": [batch],
          "repeated_ids": int(batch - ids.unique().numel()), "exact": ok, "ok": ok,
          "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bms,
          "bound_by": by})
    check(ok, "K6f disagrees with its twin or resurrected a zero slot")
    results["K6f_frontier_writeback"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                             library_ms=None, bound_ms=bms, bound_by=by)

    # K6f's queue between two draws of the apex loop (8 write-back batches of
    # B, a tick of 16 staged rows every 4 of them: repeated ids inside and
    # across batches, zero slots, a NaN |td|), applied by K5f's first launch
    # (the draw's route) and by K6f's own launch (ids outside the mirror too)
    eps, omega = cfg.priority_eps, cfg.priority_exponent

    def queue(outside):
        q, plain, parent = MirrorQueue(eps, omega), MirrorQueue(eps, omega), []
        for b in range(8):
            ids = torch.randint(0, 48, (batch,), generator=gen, device=dev, dtype=torch.int32)
            ids[batch // 2:] = torch.randint(0, live, (batch - batch // 2,), generator=gen,
                                             device=dev, dtype=torch.int32)
            td = torch.randn((batch,), generator=gen, device=dev) * 3
            if b == 2:
                td[0] = float("nan")
            keep = torch.ones_like(ids, dtype=torch.bool)
            if outside and b == 5:
                ids[3], ids[9] = n, -2
                keep[3] = keep[9] = False
            q.writeback(ids, td)
            plain.writeback(ids[keep].contiguous(), td[keep].contiguous())
            parent.append(("w", ids, td))
            if b % 4 == 3:
                rows = torch.randperm(live, generator=gen, device=dev)[:16].to(torch.int32)
                rows[:4] = torch.arange(4 * b, 4 * b + 4, device=dev, dtype=torch.int32)
                vals = torch.rand((16,), generator=gen, device=dev) * 2
                for qq in (q, plain):
                    qq.stage(rows, vals)
                parent.append(("s", rows.long(), vals))
        return q, plain, parent

    mirror = p.clone()
    mirror[:48:3] = 0.5  # the batches' first ids: live and zero slots
    q, _, parent = queue(False)
    got, want = mirror.clone(), mirror.clone()
    drawn = frontier_draw(got, u, beta, n_items, q)
    frontier_apply_plain(want, q)
    again = frontier_draw(want.clone(), u, beta, n_items)
    q_out, q_in, _ = queue(True)
    applied, applied_twin = mirror.clone(), mirror.clone()
    frontier_apply(applied, q_out)
    frontier_apply_plain(applied_twin, q_in)
    torch.cuda.synchronize()
    checks = {"draw_mirror_equals_twin": bool(torch.equal(got, want)),
              "draw_equals_apply_then_draw": all(bool(torch.equal(a, b))
                                                 for a, b in zip(drawn, again)),
              "apply_equals_twin": bool(torch.equal(applied, applied_twin)),
              "no_zero_slot_drawn": bool((got[drawn[0].long()] > 0).all())}
    ok = all(checks.values())
    ring = mirror.clone()

    def parent_route():
        for kind, ids, vals in parent:
            if kind == "w":
                frontier_writeback(ring, ids, vals, eps, omega)
            else:
                ring.index_copy_(0, ids, vals)
        return frontier_draw(ring, u, beta, n_items)

    entries = sum(int(ids.numel()) for _, ids, _ in parent)
    fold = dict(into="K5f_frontier_draw", queue="8 write-back batches of 32, 2 x 16 staged rows",
                **checks, ms=time_ms(torch, lambda: frontier_draw(ring, u, beta, n_items, q)),
                parent_route_ms=time_ms(torch, parent_route),
                k5f_ms=time_ms(torch, lambda: frontier_draw(ring, u, beta, n_items)),
                apply_ms=time_ms(torch, lambda: frontier_apply(ring, q)),
                bound_ms=bound_ms(n * 4 + entries * 4 * 4 + groups * batch * 4 * 4, n,
                                  FP32_FLOPS)[0])
    emit({"phase": "kernels_frontier", "kernel": "K6f_frontier_writeback",
          "mode": "queue folded into K5f", "shape": [n, groups, batch], "ok": ok, **fold})
    check(ok, f"K6f's queue: {checks}")
    results["K6f_frontier_writeback"]["folded"] = fold
    return results


def _anakin_cfg(cfg):
    """The reference config with the `anakin` phases' one cut (printed)."""
    return cfg.replace(target_update_period=LEARN_TARGET_PERIOD, role="anakin")


def phase_anakin(torch, cfg):
    """The full-width Anakin learner through the port's entry points:
    ``DeviceReplay`` at the config's uncut capacity filled through
    ``append`` (K7), then ANAKIN_STEPS ``build_device_learn`` steps under
    ``forbid_host_sync()`` with the launch counts of every step, then a
    profile of PROFILE_STEPS more."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames
    from rainbow_iqn_apex_tpu_torch.kernels import folded, launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.ops.learn import init_train_state
    from rainbow_iqn_apex_tpu_torch.replay.device import build_device_learn
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.utils import hostsync

    cfg = _anakin_cfg(cfg)
    lanes = cfg.num_envs_per_actor
    seg = cfg.memory_capacity // lanes
    frame = (cfg.frame_height, cfg.frame_width)
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    replay = _replay_of(cfg, seg, None)  # cuda:0 by default
    check(replay.device.type == "cuda", "the device replay did not pick the card by default")
    ds = replay.init_state()
    ring_bytes = torch.cuda.memory_allocated() - mem0
    rng = np.random.default_rng(SEED + 13)
    pool = rng.integers(0, 256, (ANAKIN_FRAME_POOL, lanes, *frame), dtype=np.uint8)
    # per-tick scalars for every tick; the frames cycle through the pool
    _, actions, rewards, terms, truncs, _ = _replay_ticks(np, rng, ANAKIN_FILL, lanes, (1, 1),
                                                          p_term=0.01, p_trunc=0.002)
    stored = ANAKIN_FILL * lanes
    cuts = {"frames": "synthetic seeded uint8 (no emulator on the machine)",
            "target_update_period": cfg.target_update_period,
            "filled": f"{stored} of {cfg.memory_capacity} slots ({ANAKIN_FILL} ticks)",
            "learn_start": f"{cfg.learn_start} (met: {stored} stored)"}

    reset_launches()  # the main path: the fill, the warm-up and the steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(ANAKIN_FILL):
        replay.append(ds, put_frames(pool[t % ANAKIN_FRAME_POOL], dev),
                      put_frames(actions[t], dev), put_frames(rewards[t], dev),
                      put_frames(terms[t], dev), put_frames(truncs[t], dev))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    check(ds.filled == ANAKIN_FILL and launches["K7_replay_append"] == ANAKIN_FILL,
          "the fill did not append every tick through K7")

    ts = init_train_state(cfg, 18, cfg.seed)  # cuda:0 by default
    fused = build_device_learn(cfg, 18, replay)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    beta = priority_beta(cfg, stored)
    for _ in range(LEARN_WARMUP):
        ts, ds, info = fused(ts, ds, gen, beta)
    torch.cuda.synchronize()
    with torch.no_grad():
        target_before = torch.cat([p.flatten() for p in ts.target.parameters()])
    step0 = ts.step
    before, folded_before = dict(launches), dict(folded)
    losses, finite, lat_ms = [], [], []
    t_run = time.perf_counter()
    try:
        with hostsync.forbid_host_sync():
            for _ in range(ANAKIN_STEPS):
                t = time.perf_counter()
                ts, ds, info = fused(ts, ds, gen, beta)
                losses.append(info["loss"])
                finite.append(info["finite"])
                lat_ms.append((time.perf_counter() - t) * 1e3)
    except RuntimeError as e:  # CUDA's sync debug mode, or a HostSyncError
        raise SmokeFailure(f"a host sync in the fused anakin steps: {e}")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_run
    counts = dict(launches)
    per_step = {name: (counts[name] - before[name]) / ANAKIN_STEPS for name in counts}
    folded_per_step = {name: (n - folded_before[name]) / ANAKIN_STEPS
                       for name, n in folded.items()}
    loss_t = torch.stack(losses)
    all_finite = bool(torch.isfinite(loss_t).all()) and bool(torch.stack(finite).all())
    with torch.no_grad():
        target_after = torch.cat([p.flatten() for p in ts.target.parameters()])
    copies = ts.step // cfg.target_update_period - step0 // cfg.target_update_period
    target_moved = not torch.equal(target_before, target_after)
    lat = np.sort(np.asarray(lat_ms))
    emit({"phase": "anakin", "steps": ANAKIN_STEPS, "batch": cfg.batch_size,
          "capacity": cfg.memory_capacity, "lanes": lanes, "seg": seg,
          "ring_bytes": ring_bytes, "memory_allocated": torch.cuda.memory_allocated(),
          "append_ticks": ANAKIN_FILL, "append_us_per_tick": fill_s / ANAKIN_FILL * 1e6,
          "learn_steps_per_s": ANAKIN_STEPS / elapsed, "seconds": elapsed,
          "step_host_p50_ms": float(lat[len(lat) // 2]),
          "step_host_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
          "launches": counts, "launches_per_step": per_step,
          "folded_per_step": folded_per_step,
          "losses_finite": all_finite, "loss_last": float(loss_t[-1]),
          "target_copies": copies, "target_moved": target_moved, "cuts": cuts})
    check(per_step == {k: float(v) for k, v in ANAKIN_PER_STEP.items()},
          f"launches per fused step {per_step}, want {ANAKIN_PER_STEP}")
    check(folded_per_step == {k: float(v) for k, v in ANAKIN_FOLDED_PER_STEP.items()},
          f"write-backs folded per fused step {folded_per_step}, want {ANAKIN_FOLDED_PER_STEP}")
    check(all_finite, "a non-finite loss in the anakin phase")
    check(copies >= 1 and target_moved, "no target copy happened in the anakin phase")
    counts = with_folded(counts, folded)
    profile_anakin(torch, fused, ts, ds, gen, beta)
    del ds, replay, ts, fused
    torch.cuda.empty_cache()
    return counts


def profile_anakin(torch, fused, ts, ds, gen, beta):
    """Where the time of a full-width fused anakin step goes: device time by
    kernel name from torch.profiler over PROFILE_STEPS steps, and the
    device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            ts, ds, _info = fused(ts, ds, gen, beta)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile_anakin", "steps": PROFILE_STEPS,
          "wall_us_per_step": wall_us / PROFILE_STEPS,
          "device_us_per_step": device_us / PROFILE_STEPS if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_step": t / PROFILE_STEPS,
                   "calls_per_step": c / PROFILE_STEPS} for k, t, c in rows[:15]]})


def phase_anakin_parity(torch, cfg):
    """One full-width fused step on the card (kernels) against the same
    step on the CPU (plain twins): same train state (a few steps in), replay
    state, sampler uniforms, taus and noise.  The ring is 16 lanes x 1,024
    (a CPU copy of the 1,000,000-slot ring would only slow the twin), and
    its eligible priorities are set to multiples of 1/8 before the step, so
    that both sides' fp32 cdfs are exact and draw the same slots; K5 on
    random priorities is held to an fp64 cdf in `kernels_replay`."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.ops.learn import host_state, init_train_state, load_host_state
    from rainbow_iqn_apex_tpu_torch.replay.device import build_device_learn

    cfg = _anakin_cfg(cfg)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    seg = 1024
    replay, cpu_replay = _replay_of(cfg, seg, dev), _replay_of(cfg, seg, cpu)
    lanes = replay.lanes
    ds = replay.init_state()
    rng = np.random.default_rng(SEED + 14)
    data = [torch.from_numpy(a).to(dev) for a in _replay_ticks(
        np, rng, 300, lanes, (cfg.frame_height, cfg.frame_width))]
    for t in range(300):
        replay.append(ds, *[a[t] for a in data[:5]])
    card = init_train_state(cfg, 18, cfg.seed)
    fused = build_device_learn(cfg, 18, replay)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(3):  # warm the Adam moments
        card, ds, _ = fused(card, ds, gen, 0.4)
    g = torch.Generator().manual_seed(SEED + 1)
    dyadic = torch.randint(1, 9, ds.priority.shape, generator=g).float() / 8
    ds.priority.copy_(torch.where(ds.priority.cpu() > 0, dyadic, 0.0).to(dev))
    host = host_state(card)
    plain = load_host_state(init_train_state(cfg, 18, cfg.seed, device="cpu"), host)
    ds_cpu = ds.to(cpu)
    beta = 0.5
    u = torch.rand((1, cfg.batch_size), generator=g)
    draws, on_card = _learn_draws(torch, cfg, plain.net, g)

    # the sample alone: the same slots, stacks and scalars
    idx_k, batch_k, prob_k = replay.sample(ds, cfg.batch_size, beta, u=u.to(dev))
    idx_p, batch_p, prob_p = cpu_replay.sample(ds_cpu, cfg.batch_size, beta, u=u)
    same_idx = bool(torch.equal(idx_k.cpu(), idx_p))
    same_batch = all(torch.equal(getattr(batch_k, f).cpu(), getattr(batch_p, f))
                     for f in ("obs", "next_obs", "action", "discount"))
    scalar_rel = max(float(((a.cpu() - b).abs() / b.abs().clamp_min(1e-30)).max())
                     for a, b in ((batch_k.reward, batch_p.reward),
                                  (batch_k.weight, batch_p.weight), (prob_k, prob_p)))
    # the fused step
    card, ds, k_info = fused(card, ds, None, beta, u=u.to(dev), draws=on_card)
    t0 = time.perf_counter()
    plain, ds_cpu, p_info = build_device_learn(cfg, 18, cpu_replay)(
        plain, ds_cpu, None, beta, u=u, draws=draws)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    errs = {}
    for key, got, want in (("loss", k_info["loss"], p_info["loss"]),
                           ("priorities", k_info["priorities"], p_info["priorities"]),
                           ("replay_priority", ds.priority, ds_cpu.priority),
                           ("max_priority", ds.max_priority, ds_cpu.max_priority)):
        got, want = got.cpu().double(), want.double()
        err = (got - want).abs()
        errs[key] = float(err.max())
        check(bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs())),
              f"anakin_parity: {key} differs by {errs[key]}")
    emit({"phase": "anakin_parity", "batch": cfg.batch_size, "ring": [lanes, seg],
          "same_idx": same_idx, "same_stacks_actions_discounts": same_batch,
          "reward_weight_prob_max_rel_err": scalar_rel, "rel_tol": REPLAY_REL,
          "max_abs_err": errs, "tol": LEARN_PATH_TOL,
          "finite": [bool(k_info["finite"]), bool(p_info["finite"])], "cpu_step_s": cpu_s})
    check(same_idx and same_batch, "anakin_parity: the card and the CPU sampled different batches")
    check(scalar_rel <= REPLAY_REL, f"anakin_parity: reward/weight/prob differ by {scalar_rel} rel")
    check(bool(k_info["finite"]) and bool(p_info["finite"]), "anakin_parity: a non-finite step")


def phase_train_anakin(torch):
    """The port's training CLI with ``--role anakin``: toy:catch with the
    scenario of tests/test_anakin.py (test_anakin_learns_catch), bf16, 4,000
    frames; the JAX test's own bar, over IQN_CATCH_SEEDS."""
    _catch_over_seeds("train_anakin", "anakin", IQN_CATCH_SEEDS)


def _apex_cfg(cfg):
    """The reference config with the apex phases' cuts (printed)."""
    return cfg.replace(target_update_period=LEARN_TARGET_PERIOD,
                       weight_publish_interval=APEX_PUBLISH, stall_timeout_s=0.0, role="apex")


def phase_apex(torch, cfg):
    """The full-width Ape-X loop of ``configs/reference_atari_defaults.json``
    through the port's entry points, with synthetic frames: ``ApexDriver``
    acting on the device frame stack with actor-side initial priorities,
    ``ShardedReplay`` at the config's uncut 1,000,000 slots filled to
    32,000 transitions, then per tick 16 lanes acted and appended and 4
    learn steps (``frames_per_learn`` 4): the prefetcher (host sampling) or
    ``SampleAheadPusher`` over the device frontier (K5f), ``learn_batch``,
    the write-back ring and committer (K6f into the mirror, reconcile at
    drains), ``publish_weights`` every APEX_PUBLISH steps.  APEX_STEPS
    steps in each mode under ``forbid_host_sync()``, with the launch counts
    of each run, then a profile of the device-sampling loop."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels import folded, launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.parallel.apex import ActorPriorityEstimator, ApexDriver
    from rainbow_iqn_apex_tpu_torch.parallel.sharded_replay import ShardedReplay
    from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
    from rainbow_iqn_apex_tpu_torch.replay.frontier import (
        DeviceSampleFrontier,
        make_batch_assembler,
    )
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.utils import hostsync
    from rainbow_iqn_apex_tpu_torch.utils.prefetch import (
        SampleAheadPusher,
        make_replay_prefetcher,
    )
    from rainbow_iqn_apex_tpu_torch.utils.writeback import RingCommitter, WritebackRing

    cfg = _apex_cfg(cfg)
    lanes = cfg.num_actors * cfg.num_envs_per_actor
    frame = (cfg.frame_height, cfg.frame_width)
    dev = torch.device("cuda", 0)
    per_tick = lanes // cfg.frames_per_learn  # learn steps due per tick
    run_ticks = (APEX_WARMUP + APEX_STEPS) // per_tick
    t0 = time.perf_counter()
    memory = ShardedReplay.build(
        max(cfg.replay_shards, 1), cfg.memory_capacity, lanes, frame_shape=frame,
        history=cfg.history_length, n_step=cfg.multi_step, gamma=cfg.gamma,
        priority_exponent=cfg.priority_exponent, priority_eps=cfg.priority_eps, seed=cfg.seed,
        use_native=cfg.use_native_sumtree)
    driver = ApexDriver(cfg, 18, state_shape=(*frame, cfg.history_length))  # cuda:0 by default
    check(driver.device.type == "cuda", "the apex driver did not pick the card by default")
    estimator = ActorPriorityEstimator(lanes, cfg.multi_step, cfg.gamma)
    rng = np.random.default_rng(SEED + 15)
    pool = rng.integers(0, 256, (APEX_FRAME_POOL, lanes, *frame), dtype=np.uint8)
    _, _, rewards, terms, truncs, _ = _replay_ticks(np, rng, APEX_FILL + 3 * run_ticks, lanes,
                                                    (1, 1), p_term=0.01, p_trunc=0.002)
    beta = priority_beta(cfg, APEX_FILL * lanes)
    state = {"tick": 0, "cuts": np.zeros(lanes, bool), "driver": driver}
    act_ms = []

    def tick(settle):
        t = state["tick"]
        frames = pool[t % APEX_FRAME_POOL]
        ta = time.perf_counter()
        actions, q = state["driver"].act_frames(frames, state["cuts"])
        act_ms.append((time.perf_counter() - ta) * 1e3)
        pri = estimator.push(q, actions, rewards[t], terms[t] | truncs[t])
        settle()
        memory.append_batch(frames, actions, rewards[t], terms[t], pri, truncations=truncs[t])
        state["cuts"], state["tick"] = terms[t] | truncs[t], t + 1

    for _ in range(APEX_FILL):
        tick(lambda: None)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    check(len(memory) == APEX_FILL * lanes and memory.sampleable,
          "the fill did not store every transition")
    cuts = {"frames": "synthetic seeded uint8 (no emulator on the machine)",
            "target_update_period": cfg.target_update_period,
            "weight_publish_interval": cfg.weight_publish_interval,
            "filled": f"{len(memory)} of {cfg.memory_capacity} slots ({APEX_FILL} ticks)",
            "learn_start": f"{cfg.learn_start} (met)"}
    counts_all = {}

    def run(device_sampling, steps=APEX_STEPS, phase="apex"):
        """One mode's loop of the driver in ``state``; returns its feed
        (pusher or prefetcher), ring, committer, frontier (None with host
        sampling) and the row it emitted."""
        driver = state["driver"]
        publish_interval = driver.cfg.weight_publish_interval
        reset_launches()  # the main path: this mode's whole run
        frontier = None
        if device_sampling:
            frontier = DeviceSampleFrontier.from_sharded(memory, seed=cfg.seed + 31)
            check(frontier.device.type == "cuda", "the frontier did not pick the card")
            feed = SampleAheadPusher(frontier, make_batch_assembler(memory), cfg.batch_size,
                                     lambda: beta, lambda: len(memory), dev,
                                     depth=cfg.sample_ahead_depth)
        else:
            feed = make_replay_prefetcher(memory, cfg, lambda: beta, dev)
        reconcile_ms, publish_ms, publish_events = [], [], []
        flush_due = []  # per reconcile: whether mirror updates waited (one K6f launch)

        def write_back(idx, td_abs):
            if frontier is not None:
                frontier.update(idx, td_abs)
            else:
                feed.update_priorities(idx, td_abs)

        def reconcile():
            feed.settle()
            flush_due.append(frontier.queued)
            reconcile_ms.append(frontier.reconcile() * 1e3)

        sup = TrainSupervisor(cfg)
        ring = WritebackRing(cfg.writeback_depth, materialize_priorities=frontier is None)
        committer = RingCommitter(ring, write_back, sup, driver.load_snapshot,
                                  on_drain=reconcile if frontier is not None else None)
        losses, finite = [], []
        last_pub = [driver.step]

        def learn_one():
            idx, batch = feed.get()
            info = driver.learn_batch(batch)
            retired = ring.push(driver.step, batch.idx if frontier is not None else idx, info)
            if retired is not None:
                losses.append(retired.scalars["loss"])
                finite.append(retired.finite)
            check(committer.commit(retired), "an apex learn step was not finite")
            if driver.step - last_pub[0] >= publish_interval:
                # host clock over the drain (ring retirement and, with the
                # frontier, the reconcile) and the publish; CUDA events
                # around the publish's copies
                tp = time.perf_counter()
                check(committer.drain(), "an apex learn step was not finite at a publish")
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                driver.publish_weights()
                ev[1].record()
                publish_ms.append((time.perf_counter() - tp) * 1e3)
                publish_events.append(ev)
                last_pub[0] = driver.step

        try:
            for _ in range(APEX_WARMUP // per_tick):
                tick(feed.settle)
                for _ in range(per_tick):
                    learn_one()
            torch.cuda.synchronize()
            with torch.no_grad():
                target_before = torch.cat([p.flatten() for p in driver.state.target.parameters()])
            step0, tick0, act0 = driver.step, state["tick"], len(act_ms)
            t_run = time.perf_counter()
            try:
                with hostsync.forbid_host_sync():
                    for _ in range(steps // per_tick):
                        tick(feed.settle)
                        for _ in range(per_tick):
                            learn_one()
                    check(committer.drain(), "an apex learn step was not finite at the drain")
            except RuntimeError as e:  # CUDA's sync debug mode, or a HostSyncError
                raise SmokeFailure(f"a host sync in the apex loop: {e}")
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t_run
            counts = with_folded(dict(launches), folded)
            steps = driver.step - step0
            with torch.no_grad():
                target_after = torch.cat([p.flatten() for p in driver.state.target.parameters()])
            requests = cfg.sample_ahead_depth + APEX_WARMUP + steps
            want = {"K5f_frontier_draw": 0, "K6f_frontier_writeback": 0}
            if frontier is not None:  # draw_ahead 2 blocks behind the current one; the
                # queue goes into the draws, and out of a draw only at the reconciles
                want = {"K5f_frontier_draw": math.ceil(requests / frontier.draw_block) + 2,
                        "K6f_frontier_writeback": sum(flush_due)}
            mode = "device" if device_sampling else "host"
            lat = np.sort(np.asarray(act_ms[act0:]))
            row = {"phase": phase, "sampling": mode, "steps": steps, "batch": cfg.batch_size,
                  "lanes": lanes, "capacity": cfg.memory_capacity, "replay_size": len(memory),
                  "learn_steps_per_s": steps / elapsed, "seconds": elapsed,
                  "env_frames_per_s": (state["tick"] - tick0) * lanes / elapsed,
                  "act_ms_per_tick_p50": float(lat[len(lat) // 2]),
                  "act_ms_per_tick_p99": float(lat[int(0.99 * (len(lat) - 1))]),
                  "drain_and_publish_host_ms": publish_ms,
                  "publish_device_ms": [a.elapsed_time(b) for a, b in publish_events],
                  "reconcile_ms": reconcile_ms,
                  "launches": counts,
                  "launches_per_learn_step": {k: v / (APEX_WARMUP + steps)
                                              for k, v in counts.items()},
                  "frontier_launches_want": want,
                  "k5f_formula": "ceil((sample_ahead_depth + gets) / draw_block) + draw_ahead"
                                 f" = ceil(({cfg.sample_ahead_depth} + "
                                 f"{APEX_WARMUP + steps}) / 8) + 2",
                  "k6f_formula": "one per reconcile that found queued mirror updates (the "
                                 "only flushes outside a draw)",
                  "k6f_flushes": None if frontier is None else frontier.flushes,
                  "k6f_folded_into_k5f": counts["folded:K6f_frontier_writeback"],
                  "losses_finite": bool(all(np.isfinite(losses)) and all(finite)),
                  "retired": ring.retired_total, "target_moved": not torch.equal(target_before,
                                                                          target_after),
                  "weights_version": driver.weights_version, "fill_s": fill_s, "cuts": cuts,
                  "act_ticks": state["tick"] - tick0 + APEX_WARMUP // per_tick}
            emit(row)
            for name, n in want.items():
                check(counts[name] == n, f"apex ({mode}): {name} launched {counts[name]} times, "
                                         f"want {n}")
            check(counts["K6_replay_writeback"] == 0 == counts["folded:K6_replay_writeback"],
                  f"apex ({mode}): the device ring's write-back ran")
            if frontier is not None:
                k6f_folds = counts["folded:K6f_frontier_writeback"]
                check(frontier.flushes == sum(flush_due) and 0 < k6f_folds
                      <= counts["K5f_frontier_draw"],
                      f"apex ({mode}): {frontier.flushes} flushes outside a draw for "
                      f"{sum(flush_due)} reconciles with queued updates; {k6f_folds} queues "
                      f"folded into {counts['K5f_frontier_draw']} draws")
            for name in (*LEARN_PER_STEP, *REPLAY_KERNELS):
                check((counts[name] > 0) == (name in LEARN_PER_STEP),
                      f"apex ({mode}): {name} launched {counts[name]} times")
            if driver.quant_mode == "off":  # full-precision actors: no K10
                for name in QUANT_KERNELS:
                    check(counts[name] == 0, f"apex ({mode}): {name} launched {counts[name]} "
                                             "times without serve_quantize")
            check(all(np.isfinite(losses)) and all(finite) and sup.rollbacks == 0
                  and ring.retired_total == APEX_WARMUP + steps,
                  f"apex ({mode}): a non-finite loss or a step not retired")
            check(not torch.equal(target_before, target_after), f"apex ({mode}): no target copy")
            check(len(publish_ms) >= 2, f"apex ({mode}): fewer than 2 publishes")
            if frontier is not None:
                check(len(reconcile_ms) >= 3, "apex (device): reconcile did not run at drains")
            if phase == "apex":
                for name, v in counts.items():
                    counts_all[name] = counts_all.get(name, 0) + v
            return feed, ring, committer, frontier, row
        except BaseException:  # stop the worker, then let the failure through
            feed.close()
            raise

    feed, _, _, _, _ = run(False)
    feed.close()
    feed, ring, committer, frontier, bf16_row = run(True)
    try:
        profile_apex(torch, driver, feed, ring, committer, tick, per_tick)
    finally:
        feed.close()
    quant = {"memory": memory, "state": state, "run": run, "bf16_row": bf16_row,
             "bf16_bytes": driver._params_bytes() // (2 if cfg.bf16_weight_sync else 1),
             "beta": beta, "per_tick": per_tick}
    return counts_all, quant


def phase_apex_quant(torch, cfg, ctx):
    """The ``apex`` phase's device-sampling loop over its filled replay with
    an int8 actor: a new ``ApexDriver`` with ``serve_quantize`` int8 and
    ``quant_agreement_min`` 0, its calibration batch drawn from the replay
    as ``train_apex`` draws it at warm-up, one gated publish so that every
    tick acts quantized, then APEX_QUANT_STEPS learn steps under
    ``forbid_host_sync()`` with a gated publish every APEX_QUANT_PUBLISH.
    Exact launches: K10q one per gated publish; K10d one and K10g four per
    act tick and per gate's quantized act; K3 only in the learn steps and
    the gates' full-precision act."""
    from rainbow_iqn_apex_tpu_torch.parallel.apex import ApexDriver

    class Rows:
        def __init__(self):
            self.rows = []

        def log(self, kind, **fields):
            self.rows.append((kind, fields))

    cfg = _apex_cfg(cfg).replace(serve_quantize="int8", quant_agreement_min=0.0,
                                 weight_publish_interval=APEX_QUANT_PUBLISH)
    frame = (cfg.frame_height, cfg.frame_width)
    memory, state, per_tick = ctx["memory"], ctx["state"], ctx["per_tick"]
    driver = ApexDriver(cfg, 18, state_shape=(*frame, cfg.history_length))
    rows = Rows()
    driver.attach_obs(rows)
    calib = memory.sample(min(cfg.quant_calib_batch, cfg.batch_size), ctx["beta"])
    driver.set_calibration(calib.obs)
    driver.publish_weights()  # gated: the actor acts on int8 weights from the first tick
    check(driver._actor_quant, "apex_quant: the first gated publish did not pass at 0.0")
    state["driver"] = driver
    feed, _, _, _, row = ctx["run"](True, steps=APEX_QUANT_STEPS, phase="apex_quant")
    feed.close()
    counts = row["launches"]
    publishes = [f for k, f in rows.rows if k == "publish"]
    gated = len(publishes) - 1  # the ones inside the counted run
    ticks, steps = row["act_ticks"], APEX_WARMUP + APEX_QUANT_STEPS
    # per gate: one full-precision act (K2, K3 x4, K4), one quantized (K10d, K2, K10g x4, K4)
    want = {"K10q_quantize": gated, "K10d_dequantize": ticks + gated,
            "K10g_noisy_linear_q": 4 * (ticks + gated),
            "K3_noisy_linear": 12 * steps + 4 * gated,
            "K2_tau_embed": 3 * steps + ticks + 2 * gated,
            "K4_dueling_head": steps + ticks + 2 * gated}
    bf16 = ctx["bf16_row"]
    emit({"phase": "apex_quant_summary", "mode": "int8", "gated_publishes": gated,
          "publish_modes": [f["mode"] for f in publishes],
          "publish_bytes": publishes[-1]["bytes"], "publish_bytes_bf16": ctx["bf16_bytes"],
          "publish_bytes_fp32": publishes[-1]["bytes_fp32"],
          "agreement": driver.quant_agreement,
          "learn_steps_per_s": row["learn_steps_per_s"],
          "learn_steps_per_s_bf16": bf16["learn_steps_per_s"],
          "act_ms_per_tick_p50": row["act_ms_per_tick_p50"],
          "act_ms_per_tick_p50_bf16": bf16["act_ms_per_tick_p50"],
          "drain_and_publish_host_ms": row["drain_and_publish_host_ms"],
          "drain_and_publish_host_ms_bf16": bf16["drain_and_publish_host_ms"],
          "publish_device_ms": row["publish_device_ms"],
          "publish_device_ms_bf16": bf16["publish_device_ms"],
          "act_ticks": ticks, "launches_want": want})
    check(gated >= 2 and all(f["mode"] == "int8" and f["quant_active"] for f in publishes),
          f"apex_quant: publishes {[f['mode'] for f in publishes]}, want int8 only")
    for name, n in want.items():
        check(counts[name] == n, f"apex_quant: {name} launched {counts[name]} times, want {n}")
    del driver
    state["driver"] = None
    torch.cuda.empty_cache()
    return counts


def profile_apex(torch, driver, feed, ring, committer, tick, per_tick):
    """Where the time of the device-sampling apex loop goes: device time by
    kernel name from torch.profiler over PROFILE_STEPS learn steps (with
    their acting ticks), and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS // per_tick):
            tick(feed.settle)
            for _ in range(per_tick):
                _, batch = feed.get()
                info = driver.learn_batch(batch)
                committer.commit(ring.push(driver.step, batch.idx, info))
        committer.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile_apex", "steps": PROFILE_STEPS,
          "wall_us_per_step": wall_us / PROFILE_STEPS,
          "device_us_per_step": device_us / PROFILE_STEPS if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_step": t / PROFILE_STEPS,
                   "calls_per_step": c / PROFILE_STEPS} for k, t, c in rows[:15]]})


def phase_apex_parity(torch, cfg):
    """One frontier draw and one learn step on the card (kernels) against
    the same on the CPU (plain twins): a two-shard replay of 16 lanes x
    1,024 slots at full width, mirrors set to the same dyadic priorities
    (so both sides' cdfs are exact and draw the same slots), the same
    uniforms, the same learner state (a few steps in), taus and noise; then
    each side's K6f write-back of its priorities."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.agents.agent import to_device_batch
    from rainbow_iqn_apex_tpu_torch.ops.learn import host_state
    from rainbow_iqn_apex_tpu_torch.parallel.apex import ApexDriver
    from rainbow_iqn_apex_tpu_torch.parallel.sharded_replay import ShardedReplay
    from rainbow_iqn_apex_tpu_torch.replay.frontier import (
        DeviceSampleFrontier,
        make_batch_assembler,
    )

    cfg = _apex_cfg(cfg)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    lanes, frame = cfg.num_envs_per_actor, (cfg.frame_height, cfg.frame_width)
    memory = ShardedReplay.build(2, 2 * lanes * 1024, lanes, frame_shape=frame,
                                 history=cfg.history_length, n_step=cfg.multi_step,
                                 gamma=cfg.gamma, priority_exponent=cfg.priority_exponent,
                                 priority_eps=cfg.priority_eps, seed=cfg.seed)
    rng = np.random.default_rng(SEED + 16)
    frames, actions, rewards, terms, truncs, pri = _replay_ticks(np, rng, 300, lanes, frame)
    for t in range(300):
        memory.append_batch(frames[t], actions[t], rewards[t], terms[t], pri[t].astype(np.float64),
                            truncations=truncs[t])
    trees = [s.tree for s in memory.shards]
    args = (trees, memory.shard_capacity, cfg.priority_eps, cfg.priority_exponent)
    f_card = DeviceSampleFrontier(*args, device=dev)
    f_cpu = DeviceSampleFrontier(*args, device=cpu)
    g = torch.Generator().manual_seed(SEED + 17)
    mirror = f_cpu.mirror_np()
    dyadic = torch.where(torch.from_numpy(mirror) > 0,
                         torch.randint(1, 9, mirror.shape, generator=g).float() / 8, 0.0)
    f_cpu.mirror.copy_(dyadic)
    f_card.mirror.copy_(dyadic.to(dev))
    beta, batch = 0.5, cfg.batch_size
    u = torch.rand((f_cpu.draw_block, batch), generator=g)
    blk_k = f_card.draw(batch, beta, len(memory), uniforms=u.to(dev))
    blk_p = f_cpu.draw(batch, beta, len(memory), uniforms=u)
    same_idx = bool(torch.equal(blk_k.idx.cpu(), blk_p.idx))
    draw_rel = max(float(((a.cpu() - b).abs() / b.abs()).max())
                   for a, b in ((blk_k.prob, blk_p.prob), (blk_k.weight, blk_p.weight)))

    card = ApexDriver(cfg, 18, state_shape=(*frame, cfg.history_length))
    idx_k, w_k = blk_k.host()
    sample = make_batch_assembler(memory)(idx_k[0], w_k[0])
    for _ in range(3):  # warm the Adam moments
        card.learn_batch(to_device_batch(sample, dev))
    plain = ApexDriver(cfg, 18, state_shape=(*frame, cfg.history_length), device=cpu)
    plain.load_state(host_state(card.state), {})
    draws, on_card = _learn_draws(torch, cfg, plain.state.net, g)
    b_k, b_p = to_device_batch(sample, dev), to_device_batch(sample, cpu)
    k_info = card.learn_batch(b_k, draws=on_card)
    t0 = time.perf_counter()
    p_info = plain.learn_batch(b_p, draws=draws)
    cpu_s = time.perf_counter() - t0
    ids = torch.from_numpy(sample.idx.astype(np.int32))
    f_card.update(ids.to(dev), k_info["priorities"])
    f_cpu.update(ids, p_info["priorities"])
    errs = {}
    for key, got, want in (("loss", k_info["loss"], p_info["loss"]),
                           ("priorities", k_info["priorities"], p_info["priorities"]),
                           ("q_mean", k_info["q_mean"], p_info["q_mean"]),
                           ("mirror", f_card.mirror_np(), f_cpu.mirror_np())):
        got, want = torch.as_tensor(got).cpu().double(), torch.as_tensor(want).double()
        err = (got - want).abs()
        errs[key] = float(err.max())
        check(bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs())),
              f"apex_parity: {key} differs by {errs[key]}")
    emit({"phase": "apex_parity", "batch": batch, "groups": f_cpu.draw_block,
          "mirror": [2, memory.shard_capacity], "same_idx": same_idx,
          "prob_weight_max_rel_err": draw_rel, "rel_tol": FRONTIER_REL, "max_abs_err": errs,
          "tol": LEARN_PATH_TOL, "finite": [bool(k_info["finite"]), bool(p_info["finite"])],
          "cpu_step_s": cpu_s})
    check(same_idx, "apex_parity: the card and the CPU drew different slots")
    check(draw_rel <= FRONTIER_REL, f"apex_parity: prob/weight differ by {draw_rel} rel")
    check(bool(k_info["finite"]) and bool(p_info["finite"]), "apex_parity: a non-finite step")


def phase_train_apex(torch):
    """The port's training CLI with ``--role apex`` and device sampling:
    toy:catch with ``catch_bar``'s apex scenario (the single scenario as an
    Ape-X run), bf16, 4,000 frames; the bar the JAX ``train_apex`` clears on
    the same scenario (PERF.md), over IQN_CATCH_SEEDS."""
    _catch_over_seeds("train_apex", "apex", IQN_CATCH_SEEDS)


# ---------------------------------------------------- quantized act path (K10)
def _plant_edges(torch, params):
    """Rows of the full-width tree that hold K10q's edge cases: a zero
    output channel, one with scale 1 (max 127) and half-way ties, and one
    with e4m3's overflow edges (464 rounds to 448, above it is NaN)."""
    w = params["advantage_hidden.w_mu"]
    w[5] = 0.0
    w[6, :8] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5])
    w[6, 8:] = w[6, 8:].clamp(-100.0, 100.0)
    w[7, :8] = torch.tensor([448.0, 460.0, 464.0, 464.01, 500.0, -1e4, -464.0, float("nan")])
    return params


def phase_kernels_quant(torch, cfg):
    """K10q (int8, fp8) on the full-width tree, K10g (int8, e4m3) greedy at
    serving's M 2048 and noisy at apex acting's M 512, and K10d, each
    against its plain twin, timed as the other rows are."""
    from rainbow_iqn_apex_tpu_torch.kernels.dequantize import dequantize, dequantize_plain
    from rainbow_iqn_apex_tpu_torch.kernels.noisy_linear_q import (
        noisy_linear_q,
        noisy_linear_q_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.quantize import quantize_plain
    from rainbow_iqn_apex_tpu_torch.models import init_params
    from rainbow_iqn_apex_tpu_torch.models.layers import _f
    from rainbow_iqn_apex_tpu_torch.models.quantized import make_quantized_network
    from rainbow_iqn_apex_tpu_torch.utils.quantize import QuantizedParams, quantize_params

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    clean = init_params(cfg, 18, seed=SEED + 20)
    params = _plant_edges(torch, {k: v.clone() for k, v in clean.items()})
    numel = sum(v.numel() for v in params.values())
    results, qps = {}, {}

    # K10q -----------------------------------------------------------------
    for mode in ("int8", "fp8"):
        ref = params
        if mode == "int8":  # the overflow row is fp8's case; int8 takes finite weights
            ref = {k: v.nan_to_num(nan=0.0) for k, v in params.items()}
        src = {k: v.to(dev) for k, v in ref.items()}
        out = QuantizedParams.like(src, mode)
        quantize_params(src, mode, out=out)
        torch.cuda.synchronize()
        want = quantize_params(ref, mode)  # the twin on the CPU, bit-equal to JAX (CPU tests)
        q_equal = bool(torch.equal(out.q_flat.cpu(), want.q_flat))
        s_equal = bool(torch.equal(out.s_flat.cpu().view(torch.int32),
                                   want.s_flat.view(torch.int32)))
        row7 = out.q["advantage_hidden.w_mu"][7, :8].float().cpu()
        edges = {"zero_row_scale": float(out.s["advantage_hidden.w_mu"][5])
                 if mode == "int8" else None,
                 "ties_row_q": out.q["advantage_hidden.w_mu"][6, :8].float().cpu().tolist(),
                 "overflow_row": [None if math.isnan(v) else v for v in row7.tolist()]}
        names = list(src)
        rows = [s.numel() for s in want.s.values()]
        k_ms = time_ms(torch, lambda: quantize_params(src, mode, out=out))
        p_ms = time_ms(torch, lambda: [quantize_plain(src[n], mode, r) for n, r in
                                       zip(names, rows)])
        nbytes = 4 * numel + numel + 4 * sum(rows)
        bms, by = bound_ms(nbytes, 3 * numel, FP32_FLOPS)
        emit({"phase": "kernels_quant", "kernel": "K10q_quantize", "mode": mode,
              "tensors": len(names), "values": numel, "q_bit_equal": q_equal,
              "s_bit_equal": s_equal, "edges": edges, "kernel_ms": k_ms, "plain_ms": p_ms,
              "library_ms": None, "bound_ms": bms, "bound_by": by})
        check(q_equal and s_equal, f"K10q ({mode}) differs from its twin")
        if mode == "fp8":
            nan = [v is None for v in edges["overflow_row"]]
            check(nan == [False, False, False, True, True, True, False, True],
                  f"K10q (fp8) overflow row {edges['overflow_row']}")
        # K10g and K10d below run on the quantized clean tree
        qps[mode] = quantize_params({k: v.to(dev) for k, v in clean.items()}, mode)
        if mode == "int8":
            results["K10q_quantize"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                            bound_ms=bms, bound_by=by, library_ms=None)

    # K10g: the greedy serving shapes and the noisy acting shapes -----------
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    feat, hidden, taus_n = 3136, cfg.hidden_size, cfg.num_quantile_samples
    k10g_max, path = 0.0, []
    for mode in ("int8", "fp8"):
        qp = qps[mode]
        for m, noisy in ((BUCKET * taus_n, False), (16 * taus_n, True)):
            x_h = torch.randn((m, feat), generator=g, device=dev).relu().to(bf)
            x_o = torch.randn((m, hidden), generator=g, device=dev).relu().to(bf)
            for layer, x, relu in (("value_hidden", x_h, True), ("advantage_out", x_o, False),
                                   ("value_out", x_o, False)):
                n, k = qp.shapes[f"{layer}.w_mu"]
                a = [x] + [t for p in ("w_mu", "b_mu") for t in (qp.q[f"{layer}.{p}"],
                                                                  qp.s[f"{layer}.{p}"])]
                if noisy:
                    a += [t for p in ("w_sigma", "b_sigma") for t in (qp.q[f"{layer}.{p}"],
                                                                      qp.s[f"{layer}.{p}"])]
                    a += [_f(torch.randn(k, generator=g, device=dev)),
                          _f(torch.randn(n, generator=g, device=dev))]
                got = noisy_linear_q(*a, relu=relu)
                want = noisy_linear_q_plain(*a, relu=relu)
                torch.cuda.synchronize()
                max_abs, max_rel, ok = errors(torch, got, want, K3_TOL)
                k10g_max = max(k10g_max, max_abs)
                products = 2 if noisy else 1
                nbytes = (m * k * 2 + products * (n * k + n + 4 * qp.s[f"{layer}.w_mu"].numel()
                                                  + 4) + m * n * 4 + (4 * (k + n) if noisy else 0))
                bms, by = bound_ms(nbytes, products * 2 * m * n * k, BF16_FLOPS)
                k_ms = time_ms(torch, lambda: noisy_linear_q(*a, relu=relu))
                p_ms = time_ms(torch, lambda: noisy_linear_q_plain(*a, relu=relu))
                lib_ms = None
                if not noisy:  # two calls: the dequantize into bf16, then F.linear
                    w_buf = torch.empty((n, k), dtype=bf, device=dev)
                    q_w, s_w = qp.q[f"{layer}.w_mu"], qp.s[f"{layer}.w_mu"].view(-1, 1)
                    b_bf = dequantize_plain(qp.q[f"{layer}.b_mu"], qp.s[f"{layer}.b_mu"], bf)
                    if mode == "int8":
                        def lib():
                            torch.mul(q_w, s_w, out=w_buf)
                            return torch.nn.functional.linear(x, w_buf, b_bf)
                    else:  # s = 1: the cast is the dequantize
                        def lib():
                            return torch.nn.functional.linear(x, q_w.to(bf), b_bf)
                    lib_ms = time_ms(torch, lib)
                emit({"phase": "kernels_quant", "kernel": "K10g_noisy_linear_q", "mode": mode,
                      "shape": [m, k, n], "noisy": noisy, "relu": relu, "max_abs_err": max_abs,
                      "max_rel_err": max_rel, "tol": K3_TOL, "ok": ok, "kernel_ms": k_ms,
                      "plain_ms": p_ms, "library_ms": lib_ms,
                      "library": "torch.mul into bf16 + F.linear (two calls)"
                      if mode == "int8" else "q.to(bf16) + F.linear (two calls)",
                      "bound_ms": bms, "bound_by": by})
                check(ok, f"K10g ({mode}, {layer}, noisy={noisy}) disagrees: max abs {max_abs}")
                if mode == "int8" and not noisy:
                    path.append(dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bms,
                                     bound_by=by, times=2 if layer == "value_hidden" else 1))
    # the greedy serving dispatch: two hidden layers, value_out, advantage_out
    results["K10g_noisy_linear_q"] = dict(
        max_abs_err=k10g_max,
        **{key: sum(c[key] * c["times"] for c in path)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=path[0]["bound_by"])

    # K10g at the catch scenario's act tick (train_apex_quant's actors: 8
    # lanes x 8 taus, 80x80x2 frames -> F 2304, hidden 128, 3 actions),
    # int8, greedy and noisy; held to the twin, timed, not in the kernels line
    from rainbow_iqn_apex_tpu_torch.models.layers import trunk_features

    ccfg = cfg.replace(frame_height=80, frame_width=80, history_length=2, hidden_size=128,
                       num_cosines=32, num_quantile_samples=8)
    cqp = quantize_params({k: v.to(dev) for k, v in init_params(ccfg, 3, seed=SEED + 22).items()},
                          "int8")
    m, cfeat = 8 * ccfg.num_quantile_samples, trunk_features(80, 80)
    for noisy in (False, True):
        for layer, k, relu in (("value_hidden", cfeat, True), ("advantage_out", 128, False),
                               ("value_out", 128, False)):
            n = cqp.shapes[f"{layer}.w_mu"][0]
            x = torch.randn((m, k), generator=g, device=dev).relu().to(bf)
            a = [x] + [t for p in ("w_mu", "b_mu") for t in (cqp.q[f"{layer}.{p}"],
                                                              cqp.s[f"{layer}.{p}"])]
            if noisy:
                a += [t for p in ("w_sigma", "b_sigma") for t in (cqp.q[f"{layer}.{p}"],
                                                                  cqp.s[f"{layer}.{p}"])]
                a += [_f(torch.randn(k, generator=g, device=dev)),
                      _f(torch.randn(n, generator=g, device=dev))]
            got = noisy_linear_q(*a, relu=relu)
            want = noisy_linear_q_plain(*a, relu=relu)
            torch.cuda.synchronize()
            max_abs, max_rel, ok = errors(torch, got, want, K3_TOL)
            products = 2 if noisy else 1
            nbytes = (m * k * 2 + products * (n * k + n + 4 * n + 4) + m * n * 4
                      + (4 * (k + n) if noisy else 0))
            bms, by = bound_ms(nbytes, products * 2 * m * n * k, BF16_FLOPS)
            emit({"phase": "kernels_quant", "kernel": "K10g_noisy_linear_q", "mode": "int8",
                  "scenario": "catch act tick", "shape": [m, k, n], "noisy": noisy, "relu": relu,
                  "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K3_TOL, "ok": ok,
                  "kernel_ms": time_ms(torch, lambda: noisy_linear_q(*a, relu=relu)),
                  "plain_ms": time_ms(torch, lambda: noisy_linear_q_plain(*a, relu=relu)),
                  "library_ms": None, "bound_ms": bms, "bound_by": by})
            check(ok, f"K10g (int8, catch {layer}, noisy={noisy}) disagrees: max abs {max_abs}")

    # K10d: the conv and embedding leaves of one quantized network --------
    for mode in ("int8", "fp8"):
        net = make_quantized_network(cfg, 18, qps[mode], use_noise=False)
        d_q, d_s, d_out = net._d_args
        dequantize(d_q, d_s, d_out)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(o, dequantize_plain(q, s_, o.dtype)))
                    for q, s_, o in zip(d_q, d_s, d_out))
        values = sum(q.numel() for q in d_q)
        nbytes = values + 4 * sum(s_.numel() for s_ in d_s) + sum(
            o.numel() * o.element_size() for o in d_out)
        bms, by = bound_ms(nbytes, values, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: dequantize(d_q, d_s, d_out))
        p_ms = time_ms(torch, lambda: [o.copy_(dequantize_plain(q, s_, o.dtype))
                                       for q, s_, o in zip(d_q, d_s, d_out)])
        emit({"phase": "kernels_quant", "kernel": "K10d_dequantize", "mode": mode,
              "leaves": len(d_q), "values": values, "bit_equal": equal, "kernel_ms": k_ms,
              "plain_ms": p_ms, "library_ms": None, "bound_ms": bms, "bound_by": by})
        check(equal, f"K10d ({mode}) differs from its twin")
        if mode == "int8":
            results["K10d_dequantize"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                              bound_ms=bms, bound_by=by, library_ms=None)
    return results


def _serve_requests(server, frames, requests):
    """``requests`` blocking requests from CLIENTS client threads; returns
    (answers, sorted latencies in ms, seconds, failures)."""
    import numpy as np

    answers, latency_ms, failures = [None] * requests, [0.0] * requests, []

    def client(i):
        try:
            for r in range(i, requests, CLIENTS):
                t = time.perf_counter()
                answers[r] = server.act_values(frames[r], timeout=120)
                latency_ms[r] = (time.perf_counter() - t) * 1e3
        except Exception as e:  # recorded and failed below
            failures.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "client threads did not finish")
    return answers, np.sort(np.asarray(latency_ms)), time.perf_counter() - t0, failures


def phase_serve_quant(torch, cfg):
    """The ``PolicyServer`` of ``configs/serve_defaults.json`` with
    ``serve_quantize`` int8, then fp8: the gate at the config's
    ``quant_agreement_min``; a forced pass (0.0) serving QUANT_REQUESTS
    requests from CLIENTS clients with the exact launches of every dispatch
    (K10d, K2, K10g x4, K4; no K3); a forced fail (1.01) that falls back and
    writes one ``quant_fallback`` row; and the card's quantized path against
    the same quantized network's plain path on the CPU."""
    import json as _json
    import tempfile

    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.models import init_params
    from rainbow_iqn_apex_tpu_torch.models.quantized import make_quantized_network
    from rainbow_iqn_apex_tpu_torch.serving import PolicyServer

    actions_n = 18
    params = init_params(cfg, actions_n, seed=SEED)
    frames = np.random.default_rng(SEED + 22).integers(
        0, 256, (QUANT_REQUESTS, *cfg.state_shape), dtype=np.uint8)
    counts_all = {}
    for mode in ("int8", "fp8"):
        qcfg = cfg.replace(serve_quantize=mode)
        # the gate at the config's threshold, on the server's seeded frames
        reset_launches()
        gated = PolicyServer(qcfg, actions_n, params)
        gate_launches = {k: v for k, v in launches.items() if v}
        state = gated.engine.quant_state()
        emit({"phase": "serve_quant_gate", "mode": mode,
              "threshold": qcfg.quant_agreement_min, "calib_batch": qcfg.quant_calib_batch,
              **state, "launches": gate_launches})
        check(state["quant_active"] == (state["quant_agreement"] >= qcfg.quant_agreement_min)
              and state["quant_fallbacks"] == int(not state["quant_active"]),
              f"serve_quant ({mode}): the gate's decision disagrees with its agreement")
        check(gate_launches.get("K10q_quantize") == 1, f"serve_quant ({mode}): K10q "
              f"launched {gate_launches.get('K10q_quantize')} times for one stage")
        gated.stop()

        # forced pass: the quantized network serves every request
        server = PolicyServer(qcfg.replace(quant_agreement_min=0.0), actions_n, params)
        check(server.engine.quant_active, f"serve_quant ({mode}): the forced pass did not pass")
        reset_launches()  # the main path: warm-up and the requests
        server.start()
        answers, lat, elapsed, failures = _serve_requests(server, frames, QUANT_REQUESTS)
        counts = dict(launches)
        stats = server.stats()
        dispatches = stats["total_batches"] + len(server.engine.buckets)  # + warm-up
        check(not failures, f"serve_quant ({mode}): requests failed: {failures[:3]}")
        acts = np.array([a for a, _ in answers])
        qs = np.stack([q for _, q in answers])
        check(bool(np.all((acts >= 0) & (acts < actions_n))) and bool(np.all(np.isfinite(qs))),
              f"serve_quant ({mode}): an action out of range or a non-finite q")
        want = {k: v * dispatches for k, v in QUANT_PER_DISPATCH.items()}
        emit({"phase": "serve_quant", "mode": mode, "requests": QUANT_REQUESTS,
              "clients": CLIENTS, "seconds": elapsed, "requests_per_s": QUANT_REQUESTS / elapsed,
              "request_p50_ms": float(lat[len(lat) // 2]),
              "request_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
              "dispatches": dispatches, "launches": counts, "launches_want": want,
              "batch_occupancy": stats["batch_occupancy_lifetime"]})
        for name, n in want.items():
            check(counts[name] == n, f"serve_quant ({mode}): {name} launched {counts[name]} "
                                     f"times in {dispatches} dispatches, want {n}")
        for name, v in counts.items():
            counts_all[name] = counts_all.get(name, 0) + v

        # the card's quantized path against the same network's plain path
        engine = server.engine
        obs = torch.from_numpy(frames[:BUCKET])
        taus = torch.rand((BUCKET, cfg.num_quantile_samples),
                          generator=torch.Generator().manual_seed(SEED))
        cpu_net = make_quantized_network(cfg, actions_n, engine.quantized.qparams.to("cpu"),
                                         use_noise=False)
        with torch.inference_mode():
            k_out = engine.quantized(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda())
            p_out = cpu_net(obs, cfg.num_quantile_samples, taus=taus)
        max_abs = (k_out.quantiles.cpu() - p_out.quantiles).abs().max().item()
        q_err = (k_out.q.cpu() - p_out.q).abs().max().item()
        top2 = torch.sort(p_out.q, dim=-1).values[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * PATH_Q_TOL
        same = bool(torch.equal(k_out.action.cpu()[clear], p_out.action[clear]))
        server.stop()

        # forced fail: the full-precision network serves, one reasoned row
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_quant_", dir=ROOT) as tmp:
            path = os.path.join(tmp, "serve.jsonl")
            failed = PolicyServer(qcfg.replace(quant_agreement_min=1.01), actions_n, params,
                                  metrics_path=path)
            a_fail, _ = failed.engine.infer(frames[:8])
            fstate = failed.engine.quant_state()
            failed.stop()
            with open(path) as f:
                rows = [_json.loads(line) for line in f]
        fallback = [r for r in rows if r["kind"] == "quant_fallback"]
        emit({"phase": "serve_quant_parity", "mode": mode, "batch": BUCKET,
              "max_abs_err": max_abs, "tol": PATH_TOL, "q_max_abs_err": q_err,
              "q_tol": PATH_Q_TOL, "clear_rows": int(clear.sum()), "actions_agree": same,
              "forced_fail": {**fstate, "fallback_rows": len(fallback),
                              "reason": fallback[0]["reason"] if fallback else None}})
        check(max_abs <= PATH_TOL and q_err <= PATH_Q_TOL,
              f"serve_quant ({mode}): card vs CPU quantized path max abs {max_abs}, q {q_err}")
        check(int(clear.sum()) > 0 and same,
              f"serve_quant ({mode}): greedy actions differ where the Q gap is clear")
        check(not fstate["quant_active"] and fstate["quant_fallbacks"] == 1
              and len(fallback) == 1 and fallback[0]["reason"] == "agreement_below_min"
              and a_fail.shape == (8,),
              f"serve_quant ({mode}): the forced fail did not fall back with one row")
    return counts_all


def phase_train_apex_quant(torch):
    """``phase_train_apex``'s scenario with int8 actors (``--serve-quantize
    int8 --quant-agreement-min 0``: every publish after the warm-up's
    calibration draw ships int8) at QUANT_CATCH_SEEDS, one trainer process
    each, all at once; the mean of their evaluations is held to the bar.
    One seed is one draw from a wide spread (PERF.md §6), so the bar takes
    four; the seeds were fixed before any run of them was read."""
    runs = _catch_over_seeds("train_apex_quant", "apex", QUANT_CATCH_SEEDS,
                             serve_quantize="int8")
    check(all(r["quant_publishes"] > 0 for r in runs),
          "train_apex_quant: a run shipped no int8 publish")


# --------------------------------------------------------------------- R2D2
def _r2d2_cfg(cfg):
    """The reference Atari config as an R2D2 learner (``--role single
    --architecture r2d2``, the Config's R2D2 defaults), with the
    ``learn_r2d2`` phase's cut of the target period (printed)."""
    return cfg.replace(role="single", architecture="r2d2", stall_timeout_s=0.0,
                       target_update_period=R2D2_TARGET_PERIOD)


def _lstm_args(torch, gen, batch, steps, hidden, p_reset):
    dev = torch.device("cuda", 0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (randn(batch, steps, 4 * hidden, scale=0.5), randn(hidden, 4 * hidden, scale=hidden ** -0.5),
            randn(4 * hidden, scale=0.1),
            torch.rand((batch, steps), generator=gen, device=dev) < p_reset,
            randn(batch, hidden, scale=0.5), randn(batch, hidden, scale=0.5))


def _max_errors(torch, pairs, tol):
    max_abs, max_rel, ok = 0.0, 0.0, True
    for got, want in pairs:
        a, r, good = errors(torch, got, want, tol)
        max_abs, max_rel, ok = max(max_abs, a), max(max_rel, r), ok and good
    return max_abs, max_rel, ok


def phase_kernels_r2d2(torch, cfg):
    """R2D2's kernels against their plain twins on the card at the learner's
    and the actor's shapes: K9 at [32, 120, 512] with ~5 % planted resets
    and at an act tick's [16, 1, 512]; K9-bwd at the train slice's
    [32, 80, 512]; K11 at [32, 80, 18], n 3; K8s-stack at [32, 120, 84, 84],
    h 4.  The library yardstick of K9 and K9-bwd is cuDNN's LSTM layer over
    phi [B, T, 3136] (no reset in its data), which also does the input
    product that the port leaves to one matmul; that matmul is timed too."""
    from rainbow_iqn_apex_tpu_torch.kernels.lstm import (
        lstm_backward,
        lstm_backward_plain,
        lstm_forward,
        lstm_forward_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.r2d2_td import TDParams, r2d2_td, r2d2_td_plain
    from rainbow_iqn_apex_tpu_torch.kernels.seq_stack import seq_stack, seq_stack_plain
    from rainbow_iqn_apex_tpu_torch.models.layers import trunk_features

    cfg = _r2d2_cfg(cfg)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    hidden, batch, burn, steps = cfg.lstm_size, cfg.batch_size, cfg.r2d2_burn_in, cfg.r2d2_seq_len
    seq, feat, actions = burn + steps, trunk_features(cfg.frame_height, cfg.frame_width), 18
    results = {}

    def cudnn_lstm(b, t):
        """cuDNN's LSTM layer at [b, t, hidden] over phi [b, t, feat], and the
        port's input product phi @ W_i at the same shapes."""
        lstm = torch.nn.LSTM(feat, hidden, batch_first=True).to(dev)
        phi = torch.randn((b, t, feat), generator=gen, device=dev)
        w_i = torch.randn((feat, 4 * hidden), generator=gen, device=dev) * feat ** -0.5
        return lstm, phi, w_i

    # K9 forward: the whole sequence, the burn-in and train unrolls, an act tick
    for b, t, save in ((batch, seq, True), (batch, burn, False), (batch, steps, True),
                       (cfg.num_envs_per_actor, 1, False)):
        args = _lstm_args(torch, gen, b, t, hidden, R2D2_RESET_P)
        got = lstm_forward(*args, save=save)
        want = lstm_forward_plain(*args, save=save)
        torch.cuda.synchronize()
        pairs = list(zip(got[:3], want[:3])) + (list(zip(got[3], want[3])) if save else [])
        max_abs, max_rel, ok = _max_errors(torch, pairs, K9_TOL)
        outs = b * t * hidden + 2 * b * hidden + (b * t * 5 * hidden if save else 0)
        nbytes = 4 * (b * t * 4 * hidden + 4 * hidden * hidden + 4 * hidden + 2 * b * hidden
                      + outs) + b * t
        bms, by = bound_ms(nbytes, t * (2 * b * hidden * 4 * hidden + 30 * b * hidden), FP32_FLOPS)
        # an act tick (T 1) is a plain launch, captured in a CUDA graph like its twin
        k_ms = time_ms(torch, lambda: lstm_forward(*args, save=save), graph=t == 1,
                       reps=R2D2_REPS)
        p_ms = time_ms(torch, lambda: lstm_forward_plain(*args, save=save), reps=R2D2_REPS)
        lstm, phi, w_i = cudnn_lstm(b, t)
        with torch.no_grad():
            lib_ms = time_ms(torch, lambda: lstm(phi), graph=False, reps=R2D2_REPS)
            xw_ms = time_ms(torch, lambda: phi.reshape(b * t, feat) @ w_i)
        emit({"phase": "kernels_r2d2", "kernel": "K9_lstm", "shape": [b, t, hidden],
              "saves_for_backward": save, "resets": int(args[3].sum()),
              "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K9_TOL, "ok": ok,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
              "library": "nn.LSTM (cuDNN) over phi [B, T, 3136], input product included",
              "input_matmul_ms": xw_ms, "kernel_plus_input_matmul_ms": k_ms + xw_ms,
              "bound_ms": bms, "bound_by": by})
        check(ok, f"K9 [{b}, {t}, {hidden}] disagrees with its twin: max abs {max_abs}")
        if t == seq:
            results["K9_lstm"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                      bound_by=by, library_ms=lib_ms)

    # K9-bwd over the train slice --------------------------------------------
    xw, w_h, b_h, reset, c0, h0 = _lstm_args(torch, gen, batch, steps, hidden, R2D2_RESET_P)
    _, _, _, (gates, c_seq) = lstm_forward_plain(xw, w_h, b_h, reset, c0, h0, save=True)
    dh_seq = torch.randn((batch, steps, hidden), generator=gen, device=dev)
    args = (dh_seq, None, None, w_h, reset, gates, c_seq, c0)
    got, want = lstm_backward(*args), lstm_backward_plain(*args)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = errors(torch, got, want, K9_TOL)
    nbytes = 4 * (batch * steps * hidden * 2 + 4 * hidden * hidden + batch * steps * 4 * hidden * 2
                  + batch * hidden) + batch * steps
    bms, by = bound_ms(nbytes, steps * (2 * batch * 4 * hidden * hidden + 40 * batch * hidden),
                       FP32_FLOPS)
    k_ms = time_ms(torch, lambda: lstm_backward(*args), graph=False, reps=R2D2_REPS)
    p_ms = time_ms(torch, lambda: lstm_backward_plain(*args), reps=R2D2_REPS)
    lstm, phi, _ = cudnn_lstm(batch, steps)
    phi.requires_grad_(True)
    out, _ = lstm(phi)
    g_out = torch.randn(out.shape, generator=gen, device=dev)
    wrt = [phi, *lstm.parameters()]
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(out, wrt, g_out, retain_graph=True),
                     graph=False, reps=R2D2_REPS)
    emit({"phase": "kernels_r2d2", "kernel": "K9_lstm_bwd", "shape": [batch, steps, hidden],
          "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K9_TOL, "ok": ok,
          "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
          "library": "the backward of nn.LSTM (cuDNN) over phi [B, T, 3136], input and "
                     "weight gradients included",
          "bound_ms": bms, "bound_by": by})
    check(ok, f"K9-bwd disagrees with its twin: max abs {max_abs}")
    results["K9_lstm_bwd"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                  bound_by=by, library_ms=lib_ms)
    del lstm, phi, out, g_out, wrt

    # K11 ----------------------------------------------------------------------
    from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback
    from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import seq_writeback

    n = cfg.multi_step
    p = TDParams(n, cfg.gamma, cfg.r2d2_eta, cfg.value_rescale_eps)
    capacity = max(cfg.memory_capacity // seq, 64)  # the R2D2 Anakin ring's priorities

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def td_args(rows):
        """K11's inputs at ``rows`` sequences: reward, done and valid as the
        train slice of [rows, burn-in + T] rows, as the learn step passes them."""
        valid = torch.ones((rows, seq), dtype=torch.bool, device=dev)
        valid[0, burn + steps // 2:] = False  # a sequence cut by a time limit
        done = torch.rand((rows, seq), generator=gen, device=dev) < 0.02
        return (rnd(rows, steps, scale=3.0), rnd(rows, steps, actions, scale=3.0),
                rnd(rows, steps, actions, scale=3.0), rnd(rows, seq)[:, burn:], done[:, burn:],
                valid[:, burn:], torch.rand((rows,), generator=gen, device=dev) * 0.7 + 0.3)

    def td_bytes(rows):
        return 4 * rows * steps * (2 + 2 * actions) + 2 * rows * steps + 4 * rows + 4 * (
            rows * steps + rows + 2)

    worst, k11 = 0.0, {}
    for groups in (1, 4):  # G 4: 128 sequences, eight a block of the cluster
        args = td_args(groups * batch)
        got, want = r2d2_td(*args, p), r2d2_td_plain(*args, p)
        again = r2d2_td(*args, p)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = _max_errors(torch, zip(got, want), K11_TOL)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        worst = max(worst, max_abs)
        bms, by = bound_ms(td_bytes(groups * batch), groups * batch * steps * (actions + 60),
                           FP32_FLOPS)
        k_ms = time_ms(torch, lambda: r2d2_td(*args, p))
        p_ms = time_ms(torch, lambda: r2d2_td_plain(*args, p))
        emit({"phase": "kernels_r2d2", "kernel": "K11_r2d2_td",
              "shape": [groups * batch, steps, actions], "n": n, "strided_slice": True,
              "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K11_TOL, "ok": ok,
              "repeat_bit_equal": repeat, "loss": float(got[0]), "kernel_ms": k_ms,
              "plain_ms": p_ms, "library_ms": None, "bound_ms": bms, "bound_by": by})
        check(ok and repeat, f"K11 (G={groups}) disagrees with its twin: max abs {max_abs}, "
                             f"repeat bit-equal {repeat}")
        k11[groups] = dict(args=args, ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by)
    one = td_args(1)  # a cluster of one block
    max_abs, max_rel, ok = _max_errors(torch, zip(r2d2_td(*one, p), r2d2_td_plain(*one, p)),
                                       K11_TOL)
    worst = max(worst, max_abs)
    emit({"phase": "kernels_r2d2", "kernel": "K11_r2d2_td", "shape": [1, steps, actions], "n": n,
          "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K11_TOL, "ok": ok})
    check(ok, f"K11 at one sequence disagrees with its twin: max abs {max_abs}")

    # K6s folded into K11, the R2D2 Anakin step's route: bit-equal to K11's
    # launch then K6s's, with repeated ids (inside and across groups) and a
    # NaN |TD|
    eps, omega = cfg.priority_eps, cfg.priority_exponent
    base = torch.rand((capacity,), generator=gen, device=dev) + 0.05
    failed, cases = [], 0
    for groups, nan_td in ((1, False), (4, True), (1, True), (4, False)):
        args = list(td_args(groups * batch))
        if nan_td:
            args[3][1, 5] = float("nan")
        ids = torch.randint(0, 64, (groups, batch), generator=gen, device=dev, dtype=torch.int32)
        got_p, got_max = base.clone(), torch.tensor(1.5, device=dev)
        want_p, want_max = base.clone(), torch.tensor(1.5, device=dev)
        out = r2d2_td(*args, p, Writeback(got_p, got_max, ids, eps, omega))
        ref = r2d2_td(*args, p)
        seq_writeback(want_p, want_max, ids, ref[1], eps, omega)
        torch.cuda.synchronize()
        cases += 1
        if not (all(_same_bits(torch, a, b) for a, b in zip(out, ref))
                and _same_bits(torch, got_p, want_p) and _same_bits(torch, got_max, want_max)):
            failed.append(f"G {groups}{' NaN td' if nan_td else ''}: not K11 then K6s")
        if bool(torch.isnan(got_max)) != nan_td:
            failed.append(f"G {groups}{' NaN td' if nan_td else ''}: the maximum's NaN")
    args = k11[1]["args"]
    ids = torch.randint(0, capacity, (1, batch), generator=gen, device=dev, dtype=torch.int32)
    ring, ring_max = base.clone(), torch.tensor(1.5, device=dev)
    target = Writeback(ring, ring_max, ids, eps, omega)

    def two_launches():
        out = r2d2_td(*args, p)
        seq_writeback(ring, ring_max, ids, out[1], eps, omega)

    # the fold: K11's bytes, the ids and each slot's priority written, max_priority
    fold_bms, fold_by = bound_ms(td_bytes(batch) + batch * 2 * 4 + 8,
                                 batch * steps * (actions + 60), FP32_FLOPS)
    fold = dict(into="K11_r2d2_td", cases=cases, failed=failed,
                ms=time_ms(torch, lambda: r2d2_td(*args, p, target)),
                two_launch_ms=time_ms(torch, two_launches),
                k11_ms=k11[1]["ms"], bound_ms=fold_bms, bound_by=fold_by)
    emit({"phase": "kernels_r2d2", "kernel": "K6s_seq_writeback", "mode": "folded into K11",
          "shape": [1, batch, steps, actions], "ring": capacity, "ok": not failed, **fold})
    check(not failed, f"K6s folded into K11: {failed}")
    results["K11_r2d2_td"] = dict(max_abs_err=worst, **{
        key: k11[1][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, cluster=dict(shape=[4 * batch, steps, actions], **{
            key: k11[4][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}))
    k6s_fold = fold
    del k11, args, base, ring

    # K8s-stack ----------------------------------------------------------------
    history = cfg.history_length
    obs = torch.randint(0, 256, (batch, seq, cfg.frame_height, cfg.frame_width, 1),
                        generator=gen, device=dev, dtype=torch.uint8)
    equal = bool(torch.equal(seq_stack(obs, history), seq_stack_plain(obs, history)))
    nbytes = obs.numel() * (1 + history)
    bms, by = bound_ms(nbytes, 0, FP32_FLOPS)
    k_ms = time_ms(torch, lambda: seq_stack(obs, history))
    p_ms = time_ms(torch, lambda: seq_stack_plain(obs, history))
    emit({"phase": "kernels_r2d2", "kernel": "K8s_seq_stack", "shape": list(obs.shape[:4]),
          "history": history, "bit_equal": equal, "kernel_ms": k_ms, "plain_ms": p_ms,
          "library_ms": None, "bound_ms": bms, "bound_by": by})
    check(equal, "K8s-stack differs from its twin")
    results["K8s_seq_stack"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                                    bound_by=by, library_ms=None)
    del obs
    torch.cuda.empty_cache()
    return results, k6s_fold


def _fill_sequences(cfg, np, lanes):
    """The port's SequenceReplay of R2D2_SEQS sequences filled through
    ``append_batch`` with seeded synthetic 84x84 frames (a pool of
    R2D2_FRAME_POOL ticks cycled), actions, rewards, rare terminals and
    stored LSTM states, as the actor would write them."""
    from rainbow_iqn_apex_tpu_torch.replay import SequenceReplay

    seq = cfg.r2d2_burn_in + cfg.r2d2_seq_len
    memory = SequenceReplay(R2D2_SEQS, seq, (cfg.frame_height, cfg.frame_width), cfg.lstm_size,
                            lanes=lanes, stride=max(seq - cfg.r2d2_overlap, 1),
                            priority_exponent=cfg.priority_exponent,
                            priority_eps=cfg.priority_eps, seed=cfg.seed)
    rng = np.random.default_rng(SEED + 31)
    pool = rng.integers(0, 256, (R2D2_FRAME_POOL, lanes, cfg.frame_height, cfg.frame_width),
                        dtype=np.uint8)
    for tick in range(R2D2_FILL_TICKS):
        state = (rng.standard_normal((2, lanes, cfg.lstm_size)) * 0.3).astype(np.float32)
        memory.append_batch(pool[tick % R2D2_FRAME_POOL], rng.integers(0, 18, lanes),
                            rng.normal(size=lanes).astype(np.float32),
                            rng.random(lanes) < 0.002, state[0], state[1],
                            truncations=rng.random(lanes) < 0.001)
    return memory


def phase_learn_r2d2(torch, cfg):
    """The full-width R2D2 learner through the port's entry points, as
    ``train_r2d2`` drives it: ``R2D2Agent`` (cuda:0 by default) learning on
    ``SequenceReplay`` samples with the per-step priority write-back, after
    R2D2_WARMUP steps R2D2_STEPS steps with exact launches per step, then a
    profile of R2D2_PROFILE_STEPS more."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.train_r2d2 import R2D2Agent
    from rainbow_iqn_apex_tpu_torch.utils import hostsync

    cfg = _r2d2_cfg(cfg)
    lanes = cfg.num_envs_per_actor
    seq = cfg.r2d2_burn_in + cfg.r2d2_seq_len
    cuts = {"frames": "synthetic seeded uint8 (no emulator on the machine)",
            "sequences": R2D2_SEQS, "config_sequences": cfg.memory_capacity // seq,
            "target_update_period": cfg.target_update_period}
    t0 = time.perf_counter()
    memory = _fill_sequences(cfg, np, lanes)
    fill_s = time.perf_counter() - t0
    agent = R2D2Agent(cfg, 18, (cfg.frame_height, cfg.frame_width), cfg.seed)
    check(agent.device.type == "cuda", "the R2D2 agent did not pick the card by default")
    n_params = sum(p.numel() for p in agent.state.net.parameters())
    beta = priority_beta(cfg, 0)
    losses, finite = [], []

    def one_step():
        sample = memory.sample(cfg.batch_size, beta)
        info = agent.learn(sample)
        memory.update_priorities(sample.idx, hostsync.to_host(info["priorities"]))
        losses.append(info["loss"])
        finite.append(info["finite"])

    for _ in range(R2D2_WARMUP):
        one_step()
    torch.cuda.synchronize()
    with torch.no_grad():
        target_before = torch.cat([p.flatten() for p in agent.state.target.parameters()])
    step0 = agent.step
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lat_ms = []
    t_run = time.perf_counter()
    for _ in range(R2D2_STEPS):
        t = time.perf_counter()
        one_step()
        lat_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_run
    counts = dict(launches)
    with torch.no_grad():
        target_after = torch.cat([p.flatten() for p in agent.state.target.parameters()])
    copies = agent.step // cfg.target_update_period - step0 // cfg.target_update_period
    loss_t = torch.stack(losses)
    all_finite = bool(torch.isfinite(loss_t).all()) and bool(torch.stack(finite).all())
    per_step = {name: counts[name] / R2D2_STEPS for name in counts}
    want = {name: float(R2D2_PER_STEP.get(name, 0)) for name in counts}
    lat = np.sort(np.asarray(lat_ms))
    emit({"phase": "learn_r2d2", "steps": R2D2_STEPS, "batch": cfg.batch_size,
          "sequence": [cfg.r2d2_burn_in, cfg.r2d2_seq_len], "lstm": cfg.lstm_size,
          "params": n_params, "learn_steps_per_s": R2D2_STEPS / elapsed, "seconds": elapsed,
          "step_host_p50_ms": float(lat[len(lat) // 2]),
          "step_host_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
          "launches": counts, "launches_per_step": per_step,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "memory_allocated": torch.cuda.memory_allocated(),
          "losses_finite": all_finite, "loss_first": float(loss_t[0]),
          "loss_last": float(loss_t[-1]), "target_copies": copies,
          "target_moved": not torch.equal(target_before, target_after),
          "replay_sequences": len(memory), "replay_fill_s": fill_s, "cuts": cuts})
    check(n_params == R2D2_PARAMS, f"R2D2Net has {n_params} parameters, want {R2D2_PARAMS}")
    check(per_step == want, f"launches per R2D2 learn step {per_step}, want {want}")
    check(all_finite, "a non-finite loss in the learn_r2d2 phase")
    check(copies >= 1 and not torch.equal(target_before, target_after),
          "no target copy happened in the learn_r2d2 phase")
    profile_r2d2(torch, one_step)
    ctx = {"memory": memory, "agent": agent}
    return counts, ctx


def profile_r2d2(torch, one_step):
    """Where the time of a full-width R2D2 learn step goes: device time by
    kernel name from torch.profiler over R2D2_PROFILE_STEPS steps (sample,
    upload, learn, priority read-back), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(R2D2_PROFILE_STEPS):
            one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile_r2d2", "steps": R2D2_PROFILE_STEPS,
          "wall_us_per_step": wall_us / R2D2_PROFILE_STEPS,
          "device_us_per_step": device_us / R2D2_PROFILE_STEPS if rows else "not measured",
          "device_busy_share": device_us / wall_us if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_step": t / R2D2_PROFILE_STEPS,
                   "calls_per_step": c / R2D2_PROFILE_STEPS} for k, t, c in rows[:15]]})


def phase_r2d2_parity(torch, cfg, ctx):
    """One full-width R2D2 learn step and one act tick through the kernels on
    the card against the same through the plain twins on the CPU, from the
    same state (the ``learn_r2d2`` agent's, Adam moments warm), batch and
    noise."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.ops.learn import host_state, load_host_state
    from rainbow_iqn_apex_tpu_torch.ops.r2d2 import (
        build_r2d2_act_step,
        build_r2d2_learn_step,
        init_r2d2_state,
        to_device_seq_batch,
    )

    cfg = _r2d2_cfg(cfg)
    memory, card = ctx["memory"], ctx["agent"].state
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    frame = (cfg.frame_height, cfg.frame_width)
    host = host_state(card)
    plain = load_host_state(init_r2d2_state(cfg, 18, cfg.seed, frame, device="cpu"), host)
    step = build_r2d2_learn_step(cfg, 18)
    g = torch.Generator().manual_seed(SEED + 32)
    draws = {k: plain.net.sample_noise(g) for k in ("online", "target")}
    on_card = {k: {n: (a.to(dev), b.to(dev)) for n, (a, b) in nz.items()}
               for k, nz in draws.items()}
    sample = memory.sample(R2D2_PARITY_BATCH, 0.4)
    card, k_info = step(card, to_device_seq_batch(sample, dev), draws=on_card)
    t0 = time.perf_counter()
    plain, p_info = step(plain, to_device_seq_batch(sample, cpu), draws=draws)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {}
    for key in ("loss", "priorities", "q_mean"):
        got, want = k_info[key].cpu().double(), p_info[key].double()
        err = (got - want).abs()
        out[key] = float(err.max())
        check(bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs())),
              f"r2d2_parity: {key} differs by {out[key]}")
    gn_rel = abs(k_info["grad_norm"].item() - p_info["grad_norm"].item()) / p_info["grad_norm"].item()
    check(gn_rel <= LEARN_GNORM_RTOL, f"r2d2_parity: grad_norm differs by {gn_rel} relative")
    before = host["params"]
    after_k = {k: v.cpu() for k, v in card.net.state_dict().items()}
    after_p = plain.net.state_dict()
    worst, worst_name = 0.0, ""
    for k in before:
        dk, dp = after_k[k] - before[k], after_p[k] - before[k]
        rel = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, k

    # one act tick of the 16 lanes from a stored state, the same noise
    lanes = cfg.num_envs_per_actor
    rng = np.random.default_rng(SEED + 33)
    obs = torch.from_numpy(rng.integers(0, 256, (lanes, *frame, cfg.history_length),
                                        dtype=np.uint8))
    state = tuple(torch.from_numpy((rng.standard_normal((lanes, cfg.lstm_size)) * 0.3)
                                   .astype(np.float32)) for _ in range(2))
    act = build_r2d2_act_step(cfg, 18)
    noise = plain.net.sample_noise(g)
    a_k, q_k, s_k = act(card.net, obs.to(dev), tuple(t.to(dev) for t in state), None,
                        noise={n: (a.to(dev), b.to(dev)) for n, (a, b) in noise.items()})
    a_p, q_p, s_p = act(plain.net, obs, state, None, noise=noise)
    torch.cuda.synchronize()
    q_err = float((q_k.cpu() - q_p).abs().max())
    state_err = max(float((x.cpu() - y).abs().max()) for x, y in zip(s_k, s_p))
    top2 = torch.sort(q_p, dim=-1).values[:, -2:]
    # the two q vectors are within q_err of each other, so a gap above twice
    # that leaves only one possible argmax
    clear = (top2[:, 1] - top2[:, 0]) > 2 * q_err
    same_actions = bool(torch.equal(a_k.cpu()[clear], a_p[clear]))
    emit({"phase": "r2d2_parity", "batch": R2D2_PARITY_BATCH, "max_abs_err": out,
          "tol": LEARN_PATH_TOL, "grad_norm_rel_err": gn_rel, "grad_norm_rtol": LEARN_GNORM_RTOL,
          "update_rel_l2_worst": worst, "update_worst_tensor": worst_name,
          "update_rtol": LEARN_UPDATE_RTOL,
          "finite": [bool(k_info["finite"]), bool(p_info["finite"])], "cpu_step_s": cpu_s,
          "act_lanes": lanes, "act_q_max_abs_err": q_err, "act_state_max_abs_err": state_err,
          "act_tol": PATH_TOL, "act_clear_rows": int(clear.sum()),
          "act_actions_agree": same_actions})
    check(worst <= LEARN_UPDATE_RTOL,
          f"r2d2_parity: the update of {worst_name} differs by {worst} (rel L2)")
    check(bool(k_info["finite"]) and bool(p_info["finite"]), "r2d2_parity: a non-finite step")
    check(q_err <= PATH_TOL and state_err <= PATH_TOL,
          f"r2d2_parity: act tick q differs by {q_err}, state by {state_err}")
    check(int(clear.sum()) > 0, "r2d2_parity: no act row has a clear Q gap")
    check(same_actions, "r2d2_parity: greedy actions differ where the Q gap is clear")


def phase_train_r2d2(torch):
    """``python -m rainbow_iqn_apex_tpu_torch.train --role single
    --architecture r2d2`` on toy:catch with the JAX package's own R2D2 catch
    configuration (``catch_bar``'s r2d2 scenario: tests/test_r2d2.py's
    test_r2d2_learns_catch, 20,000 frames) at R2D2_CATCH_SEEDS, one trainer
    process each, all at once; the JAX test's bar: more than 100 learn steps
    each and an evaluation mean above 0.3."""
    _catch_over_seeds("train_r2d2", "r2d2", R2D2_CATCH_SEEDS)


# ------------------------------------- R2D2 anakin: the device sequence replay
def _r2d2_anakin_cfg(cfg):
    """The reference Atari config as the R2D2 Anakin learner (``--role
    anakin --architecture r2d2``), with the R2D2 phases' one cut of the
    target period (printed)."""
    return cfg.replace(role="anakin", architecture="r2d2", stall_timeout_s=0.0,
                       target_update_period=R2D2_TARGET_PERIOD)


def _seq_tick_data(np, rng, lanes, frame, lstm, p_term=SEQ_P_TERM, p_trunc=SEQ_P_TRUNC):
    """One tick's synthetic appends: frames, actions, rewards, terminals,
    truncations and pre-act (c, h), all host numpy."""
    term = rng.random(lanes) < p_term
    return (rng.integers(0, 256, (lanes, *frame), dtype=np.uint8),
            rng.integers(0, 18, lanes).astype(np.int32), rng.normal(size=lanes).astype(np.float32),
            term, (rng.random(lanes) < p_trunc) & ~term,
            (rng.standard_normal((lanes, lstm)) * 0.3).astype(np.float32),
            (rng.standard_normal((lanes, lstm)) * 0.3).astype(np.float32))


def _fill_seq_ring(torch, np, replay, ss, ticks, seed):
    """``ticks`` K7s appends of synthetic data into ``ss`` on the card."""
    dev = replay.device
    rng = np.random.default_rng(seed)
    for _ in range(ticks):
        f, a, r, term, trunc, c, h = _seq_tick_data(np, rng, replay.lanes, replay.frame_shape,
                                                    replay.lstm_size)
        replay.append(ss, torch.from_numpy(f).to(dev), torch.from_numpy(a).to(dev), r, term,
                      trunc, torch.from_numpy(c).to(dev), torch.from_numpy(h).to(dev))
    return ss


def phase_kernels_r2d2_anakin(torch, cfg):
    """K7s, K5s, K8s and K6s against their plain twins on the card at the
    R2D2 Anakin learner's full width: the config's uncut ring of 8,333
    sequences of L 120 (84x84, LSTM 512, 16 lanes, stride 80, history 4), B
    32, G 1 and 4.  K7s as the act tick's prologue: two rings and frame
    stacks (kernel, twin) driven through the same ticks from a cursor 5
    slots before the end, so emissions wrap past C inside one tick, the
    first tick appending nothing; then timed on a tick where no lane emits
    and one where all 16 emit full windows (its bytes go in the kernels
    line), beside the parent's route (K7s's append, then shift_stack's three
    ops and pre's three: seven device ops); K5s on dyadic priorities
    (exact), a cold ring (exact) and random priorities (against an fp64
    cdf); K8s and K6s on the filled ring.  The kernels line takes G 1."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels.seq_append import (
        act_prologue,
        act_prologue_plain,
        plan_append,
        seq_append,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.seq_assemble import seq_assemble, seq_assemble_plain
    from rainbow_iqn_apex_tpu_torch.parallel.multihost import shift_stack
    from rainbow_iqn_apex_tpu_torch.kernels.seq_draw import seq_draw, seq_draw_plain
    from rainbow_iqn_apex_tpu_torch.kernels.seq_writeback import (
        seq_writeback,
        seq_writeback_plain,
    )
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import DeviceSequenceReplay
    from rainbow_iqn_apex_tpu_torch.train_anakin_r2d2 import _seq_geometry

    cfg = _r2d2_anakin_cfg(cfg)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    seq, stride, capacity, _ = _seq_geometry(cfg)
    lanes, lstm, batch = cfg.num_envs_per_actor, cfg.lstm_size, cfg.batch_size
    frame = (cfg.frame_height, cfg.frame_width)
    hw = frame[0] * frame[1]
    eps, omega = cfg.priority_eps, cfg.priority_exponent
    replay = DeviceSequenceReplay(capacity, seq, frame, lstm, lanes, stride, omega, eps,
                                  device=dev)
    results = {}

    # K7s, as the act tick's prologue ----------------------------------------
    history = cfg.history_length
    got, want = replay.init_state(), replay.init_state()
    for s in (got, want):
        s.pos = s.filled = capacity - 5
    stacks = [torch.zeros((lanes, *frame, history), dtype=torch.uint8, device=dev)
              for _ in range(2)]
    rng = np.random.default_rng(SEED + 41)

    def tick_inputs(p_term=SEQ_P_TERM, p_trunc=SEQ_P_TRUNC):
        """A tick's frame, keep and act state on the card, and the
        transition it leaves for the next tick's append."""
        f, a, r, term, trunc, c, h = _seq_tick_data(np, rng, lanes, frame, lstm, p_term, p_trunc)
        f, a, c, h = (torch.from_numpy(x).to(dev) for x in (f, a, c, h))
        keep = torch.from_numpy((rng.random(lanes) > 0.01).astype(np.uint8)).to(dev)
        return (f, keep, c, h), (a, r, term, trunc)

    prev, prev_twin, stack_or_pre_differ = None, None, 0
    for tick in range(SEQ_KERNEL_TICKS):
        (f, keep, c, h), (a, r, term, trunc) = tick_inputs()
        plan = None
        if prev is not None:
            plan = plan_append(want.buf_len, prev[3], prev[4], want.pos, want.filled, capacity,
                               seq, stride)
        pre = replay.act_prologue(got, prev, stacks[0], f, keep, (c, h))
        pre_twin = act_prologue_plain(want, prev_twin, plan, stride, stacks[1], f, keep, c, h)
        if plan is not None:
            want.buf_len, want.pos, want.filled = plan.buf_len, plan.pos, plan.filled
        stack_or_pre_differ += not (torch.equal(stacks[0], stacks[1]) and all(
            torch.equal(x, y) for x, y in zip(pre, pre_twin)))
        prev = (f, a, r, term, trunc, *pre)
        prev_twin = (f, a, r, term, *pre_twin)
    torch.cuda.synchronize()
    differing = [n for n in ("frames", "actions", "rewards", "dones", "valids", "init_c",
                             "init_h") if not torch.equal(getattr(got, n)[:capacity],
                                                          getattr(want, n)[:capacity])]
    differing += [n for n in ("priority", "max_priority")
                  if not torch.equal(getattr(got, n), getattr(want, n))]
    if (got.pos, got.filled) != (want.pos, want.filled) or not np.array_equal(got.buf_len,
                                                                             want.buf_len):
        differing.append("counters")
    for lane, n in enumerate(want.buf_len):
        differing += [f"{b}[{lane}]" for b in ("buf_frames", "buf_actions", "buf_rewards",
                                               "buf_dones", "buf_c", "buf_h")
                      if not torch.equal(getattr(got, b)[lane, :n], getattr(want, b)[lane, :n])]
    if stack_or_pre_differ:
        differing.append(f"stack or pre on {stack_or_pre_differ} ticks")
    wrapped = got.filled == capacity and got.pos < capacity - 5
    # a quiet tick (no lane emits) and a tick where all 16 lanes emit full
    # windows, bit-equal to the twin and timed: the prologue, its twin, and
    # the parent's route (K7s's append, then shift_stack and the two
    # multiplies of pre as torch ops)
    (f, keep, c, h), (a, r, term, trunc) = tick_inputs(0.0, 0.0)
    keep.fill_(1)
    ticks = {"no_lane_emits": np.zeros(lanes, np.int32),
             "all_lanes_emit": np.full(lanes, seq - 1, np.int32)}
    times = {}
    for name, buf_len in ticks.items():
        plan = plan_append(buf_len, term, trunc, 0, capacity, capacity, seq, stride)
        check(bool((plan.slot >= 0).all()) if name == "all_lanes_emit"
              else bool((plan.slot < 0).all()), f"K7s's {name} tick plan")
        args = (f, a, r, term, c, h)

        def prologue():
            return act_prologue(got, args, plan, stride, stacks[0], f, keep, c, h)

        def twin():
            return act_prologue_plain(want, args, plan, stride, stacks[1], f, keep, c, h)

        def parent_route():
            seq_append(got, *args, plan, stride)
            shift_stack(stacks[0], f, keep)
            kf = keep.to(torch.float32)[:, None]
            return c * kf, h * kf

        for s in (got, want):
            s.buf_len = buf_len.copy()
        k_pre, w_pre = prologue(), twin()
        torch.cuda.synchronize()
        if not (torch.equal(stacks[0], stacks[1])
                and all(torch.equal(x, y) for x, y in zip(k_pre, w_pre))):
            differing.append(f"{name}: stack or pre")
        times[name] = dict(ms=time_ms(torch, prologue), plain_ms=time_ms(torch, twin),
                           parent_route_ms=time_ms(torch, parent_route),
                           append_alone_ms=time_ms(torch, lambda: seq_append(
                               got, *args, plan, stride)))
    step_bytes = hw + 4 + 4 + 1 + 2 * lstm * 4  # one builder step
    window_read = (seq - 1) * (hw + 9) + (seq - stride) * 2 * lstm * 4 + 2 * lstm * 4
    window_written = seq * (hw + 10) + 2 * lstm * 4 + 4 + (seq - stride) * step_bytes
    # the prologue's own parts: the stack read and written, this tick's frame
    # and keep read, the act's state read and pre written
    prologue_bytes = lanes * (2 * hw * history + hw + 1 + 4 * lstm * 4)
    nbytes = lanes * (2 * step_bytes + window_read + window_written) + 4 + prologue_bytes
    bms, by = bound_ms(nbytes, lanes * (seq + 2 * lstm), FP32_FLOPS)
    quiet_bms, quiet_by = bound_ms(lanes * 2 * step_bytes + prologue_bytes,
                                   lanes * (1 + 2 * lstm), FP32_FLOPS)
    times["all_lanes_emit"].update(bound_ms=bms, bound_by=by)
    times["no_lane_emits"].update(bound_ms=quiet_bms, bound_by=quiet_by)
    emit({"phase": "kernels_r2d2_anakin", "kernel": "K7s_seq_append", "mode": "act prologue",
          "shape": [lanes, seq, *frame, lstm], "history": history, "capacity": capacity,
          "stride": stride, "ticks": SEQ_KERNEL_TICKS, "wrapped": wrapped,
          "fields_differing": differing, "ok": not differing and wrapped,
          "kernel_ms": times["all_lanes_emit"]["ms"],
          "plain_ms": times["all_lanes_emit"]["plain_ms"], "bound_ms": bms, "bound_by": by,
          "library_ms": None, **times})
    check(not differing and wrapped, f"K7s's prologue disagrees with its twin on "
                                     f"{differing[:8]} (wrapped {wrapped})")
    results["K7s_seq_append"] = dict(max_abs_err=0.0, ms=times["all_lanes_emit"]["ms"],
                                     plain_ms=times["all_lanes_emit"]["plain_ms"], bound_ms=bms,
                                     bound_by=by, library_ms=None, prologue=times)
    del want, stacks
    torch.cuda.empty_cache()
    ss = got  # the kernel's ring: K8s and K6s below read it

    # K5s ------------------------------------------------------------------
    k = torch.arange(batch, device=dev, dtype=torch.float32)
    for groups in (1, 4):
        u = torch.rand((groups, batch), generator=gen, device=dev)
        u[-1, -1] = 1.0 - 2.0 ** -24  # rounds u up to the total: clipped onto C - 1
        dyadic = torch.randint(0, 9, (capacity,), generator=gen, device=dev).float() / 8
        idx, meta = seq_draw(dyadic, capacity, u)
        w_idx, w_meta = seq_draw_plain(dyadic, capacity, u)
        exact = bool(torch.equal(idx, w_idx)) and bool(torch.equal(meta, w_meta))
        zero = torch.zeros((capacity,), device=dev)
        c_idx, c_meta = seq_draw(zero, 37, u)
        w_idx, w_meta = seq_draw_plain(zero, 37, u)
        cold = bool(torch.equal(c_idx, w_idx)) and bool(torch.equal(c_meta, w_meta)) and int(
            c_idx.reshape(-1)[:-1].max()) < 37
        p = torch.rand((capacity,), generator=gen, device=dev)
        p[torch.rand((capacity,), generator=gen, device=dev) < 0.3] = 0.0
        idx, meta = seq_draw(p, capacity, u)
        u_abs = ((k + u) / batch * meta[0]).double()
        cdf64 = torch.cumsum(p.double(), 0)
        ref = torch.searchsorted(cdf64, u_abs, right=True).clamp(0, capacity - 1)
        differ = idx.long() != ref
        lo = torch.minimum(idx.long(), ref)[differ]
        near = (u_abs[differ] - cdf64[lo]).abs() <= K5_BOUNDARY * float(meta[0])
        zero_drawn = not bool((p[idx.reshape(-1)[:-1].long()] > 0).all())
        torch.cuda.synchronize()
        ok = exact and cold and bool(near.all()) and not zero_drawn
        nbytes = capacity * 4 + groups * batch * (4 + 4) + 8
        bms, by = bound_ms(nbytes, capacity, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: seq_draw(p, capacity, u))
        p_ms = time_ms(torch, lambda: seq_draw_plain(p, capacity, u))
        lib_ms = time_ms(torch, lambda: torch.searchsorted(torch.cumsum(p, 0), u_abs.float(),
                                                           right=True))
        emit({"phase": "kernels_r2d2_anakin", "kernel": "K5s_seq_draw",
              "shape": [capacity, groups, batch], "dyadic_exact": exact, "cold_ring_exact": cold,
              "fp64_mismatches": int(differ.sum()),
              "fp64_mismatches_near_boundary": int(near.sum()), "zero_slot_drawn": zero_drawn,
              "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
              "library": "cumsum + searchsorted", "bound_ms": bms, "bound_by": by})
        check(ok, f"K5s (G={groups}) disagrees: dyadic exact {exact}, cold ring {cold}, far "
                  f"mismatches {int((~near).sum())}, zero slot drawn {zero_drawn}")
        if groups == 1:
            results["K5s_seq_draw"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                                           library_ms=lib_ms, bound_ms=bms, bound_by=by)

    # K8s on the filled ring ------------------------------------------------
    filled = ss.filled
    ss.priority.copy_(torch.rand((capacity,), generator=gen, device=dev) + 0.05)
    _, meta = seq_draw(ss.priority, filled, ss.priority.new_empty((0, 1)))
    worst = 0.0
    for groups in (1, 4):
        idx = torch.randint(0, filled, (groups * batch,), generator=gen, device=dev,
                            dtype=torch.int32)
        args = (ss, idx, meta, 0.6, filled, batch, True)
        got_g, want_g = seq_assemble(*args), seq_assemble_plain(*args)
        torch.cuda.synchronize()
        exact = all(torch.equal(getattr(got_g, n), getattr(want_g, n))
                    for n in ("obs", "action", "reward", "done", "valid", "init_c", "init_h"))
        rel = max(float(((getattr(got_g, n) - getattr(want_g, n)).abs()
                         / getattr(want_g, n).abs().clamp_min(1e-30)).max())
                  for n in ("prob", "weight"))
        abs_err = max(float((getattr(got_g, n) - getattr(want_g, n)).abs().max())
                      for n in ("prob", "weight"))
        worst = max(worst, abs_err)
        ok = exact and rel <= REPLAY_REL
        m = groups * batch
        nbytes = m * (2 * seq * (hw + 4 + 4 + 1 + 1) + 2 * 2 * lstm * 4 + 4 + 4 + 4 + 4) + 8
        bms, by = bound_ms(nbytes, m * 4, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: seq_assemble(*args))
        p_ms = time_ms(torch, lambda: seq_assemble_plain(*args))
        emit({"phase": "kernels_r2d2_anakin", "kernel": "K8s_seq_assemble",
              "shape": [groups, batch, seq, *frame], "ring_filled": filled,
              "fields_exact": exact, "prob_weight_max_rel_err": rel, "max_abs_err": abs_err,
              "rel_tol": REPLAY_REL, "ok": ok, "kernel_ms": k_ms, "plain_ms": p_ms,
              "library_ms": None, "bound_ms": bms, "bound_by": by})
        check(ok, f"K8s (G={groups}) disagrees with its twin: fields exact {exact}, rel {rel}")
        if groups == 1:
            results["K8s_seq_assemble"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                               bound_ms=bms, bound_by=by)
        del got_g, want_g
    results["K8s_seq_assemble"]["max_abs_err"] = worst

    # K6s ------------------------------------------------------------------
    base = ss.priority.clone()
    ids = torch.randint(0, 64, (4, batch), generator=gen, device=dev, dtype=torch.int32)
    td = torch.rand((4 * batch,), generator=gen, device=dev) * 3
    for groups in (4, 1):
        got_p, got_max = base.clone(), torch.tensor(1.5, device=dev)
        want_p, want_max = base.clone(), torch.tensor(1.5, device=dev)
        args = (ids[:groups].contiguous(), td[:groups * batch].contiguous(), eps, omega)
        seq_writeback(got_p, got_max, *args)
        seq_writeback_plain(want_p, want_max, *args)
        torch.cuda.synchronize()
        err = float(((got_p - want_p).abs() / want_p.abs().clamp_min(1e-30)).max())
        err = max(err, abs(float(got_max) - float(want_max)) / float(want_max))
        ok = err <= REPLAY_REL
        nbytes = groups * batch * 4 * 3 + 8
        bms, by = bound_ms(nbytes, 2 * groups * batch, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: seq_writeback(got_p, got_max, *args))
        p_ms = time_ms(torch, lambda: seq_writeback_plain(want_p, want_max, *args))
        emit({"phase": "kernels_r2d2_anakin", "kernel": "K6s_seq_writeback",
              "shape": [groups, batch], "omega": omega,
              "repeated_ids": int(groups * batch - ids[:groups].unique().numel()),
              "max_rel_err": err, "rel_tol": REPLAY_REL, "ok": ok, "kernel_ms": k_ms,
              "plain_ms": p_ms, "library_ms": None, "bound_ms": bms, "bound_by": by})
        check(ok, f"K6s (G={groups}) disagrees with its twin: max rel {err}")
        if groups == 1:
            results["K6s_seq_writeback"] = dict(max_abs_err=float((got_p - want_p).abs().max()),
                                                ms=k_ms, plain_ms=p_ms, library_ms=None,
                                                bound_ms=bms, bound_by=by)
    del ss, got, base, replay
    torch.cuda.empty_cache()
    return results


def phase_anakin_r2d2(torch, cfg):
    """The R2D2 Anakin learner through the port's entry points: the trainer's
    ``DeviceSequenceReplay`` at the config's uncut 8,333 sequences, filled
    through the trainer's own ``act_append`` tick (one K7s prologue launch,
    then the act's K9, K3, K4) from 16 lanes of seeded synthetic frames,
    under ``forbid_host_sync()`` but for the one sanctioned read of the
    actions, until past the warm gate, and a profile of ACT_PROFILE_TICKS
    ticks; then ANAKIN_R2D2_STEPS ``build_device_r2d2_learn`` steps (K6s in
    K11's launch) under ``forbid_host_sync()`` with exact launches and
    folded write-backs per step, and a profile."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames
    from rainbow_iqn_apex_tpu_torch.kernels import folded, launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.ops.r2d2 import init_r2d2_state
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import (
        DeviceSequenceReplay,
        build_device_r2d2_learn,
    )
    from rainbow_iqn_apex_tpu_torch.train import priority_beta
    from rainbow_iqn_apex_tpu_torch.train_anakin_r2d2 import _seq_geometry, build_act_append
    from rainbow_iqn_apex_tpu_torch.utils import hostsync

    cfg = _r2d2_anakin_cfg(cfg)
    lanes, lstm = cfg.num_envs_per_actor, cfg.lstm_size
    frame = (cfg.frame_height, cfg.frame_width)
    seq, stride, capacity, learn_start_seqs = _seq_geometry(cfg)
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    replay = DeviceSequenceReplay(capacity, seq, frame, lstm, lanes, stride,
                                  cfg.priority_exponent, cfg.priority_eps)  # cuda:0 by default
    check(replay.device.type == "cuda", "the sequence replay did not pick the card by default")
    ss = replay.init_state()
    torch.cuda.synchronize()
    ring_bytes = torch.cuda.memory_allocated() - mem0
    ts = init_r2d2_state(cfg, 18, cfg.seed, frame)  # cuda:0 by default
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    act_append = build_act_append(cfg, 18, replay, gen)
    rng = np.random.default_rng(SEED + 43)
    pool = rng.integers(0, 256, (R2D2_FRAME_POOL, lanes, *frame), dtype=np.uint8)
    stack = torch.zeros((lanes, *frame, cfg.history_length), dtype=torch.uint8, device=dev)
    state = (torch.zeros((lanes, lstm), device=dev), torch.zeros((lanes, lstm), device=dev))
    prev, cuts, ticks, tick_us = None, np.zeros(lanes, bool), 0, []
    k7s_ticks = {"emitting": 0, "none_emitting": 0}  # K7s launches by whether a lane emitted
    cut_info = {"frames": "synthetic seeded uint8 (no emulator on the machine)",
                "target_update_period": cfg.target_update_period,
                "ring": f"uncut: {capacity} sequences of {seq}"}

    reset_launches()  # the main path: the ticks, the warm-up and the learn steps
    torch.cuda.synchronize()
    t_fill = time.perf_counter()
    try:
        with hostsync.forbid_host_sync():
            while ss.filled < learn_start_seqs + ANAKIN_R2D2_PAST_GATE:
                t = time.perf_counter()
                frame_d = put_frames(pool[ticks % R2D2_FRAME_POOL], dev)
                keep_d = put_frames((~cuts).astype(np.uint8), dev)
                filled0 = ss.filled
                actions_d, state, pre = act_append(ts.net, stack, ss, state, frame_d, keep_d,
                                                   prev)
                if prev is not None:  # this tick appended: K7s ran (filled stays under capacity)
                    k7s_ticks["emitting" if ss.filled > filled0 else "none_emitting"] += 1
                with hostsync.sanctioned():
                    hostsync.to_host(actions_d)  # the loop's one read: the env needs them
                tick_us.append((time.perf_counter() - t) * 1e6)
                rewards = rng.normal(size=lanes).astype(np.float32)
                terms = rng.random(lanes) < SEQ_P_TERM
                truncs = (rng.random(lanes) < SEQ_P_TRUNC) & ~terms
                prev = (frame_d, actions_d, rewards, terms, truncs, pre[0], pre[1])
                cuts = terms | truncs
                ticks += 1
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync in the act_append ticks: {e}")
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t_fill
    tick_counts = dict(launches)
    want_ticks = {name: 0 for name in tick_counts}
    # one K7s a tick: the prologue (on the first tick the stack shift and pre alone)
    want_ticks.update({"K7s_seq_append": ticks, "K9_lstm": ticks, "K3_noisy_linear": 4 * ticks,
                       "K4_dueling_head": ticks})
    check(tick_counts == want_ticks, f"launches of {ticks} act_append ticks {tick_counts}, "
                                     f"want {want_ticks}")
    check(sum(k7s_ticks.values()) == ticks - 1 and ss.filled < capacity,
          f"K7s ticks {k7s_ticks} of {ticks - 1} appends")
    act_profile = profile_act_r2d2(torch, np, act_append, ts, stack, ss, state, prev, pool, rng)

    fused = build_device_r2d2_learn(cfg, 18, replay)
    beta = priority_beta(cfg, ticks * lanes)
    for _ in range(ANAKIN_R2D2_WARMUP):
        ts, ss, info = fused(ts, ss, gen, beta)
    torch.cuda.synchronize()
    with torch.no_grad():
        target_before = torch.cat([p.flatten() for p in ts.target.parameters()])
    step0 = ts.step
    before, folded_before = dict(launches), dict(folded)
    torch.cuda.reset_peak_memory_stats()
    losses, finite, lat_ms = [], [], []
    t_run = time.perf_counter()
    try:
        with hostsync.forbid_host_sync():
            for _ in range(ANAKIN_R2D2_STEPS):
                t = time.perf_counter()
                ts, ss, info = fused(ts, ss, gen, beta)
                losses.append(info["loss"])
                finite.append(info["finite"])
                lat_ms.append((time.perf_counter() - t) * 1e3)
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync in the R2D2 anakin learn steps: {e}")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_run
    counts = dict(launches)
    per_step = {name: (counts[name] - before[name]) / ANAKIN_R2D2_STEPS for name in counts}
    want = {name: float(ANAKIN_R2D2_PER_STEP.get(name, 0)) for name in counts}
    folded_per_step = {name: (n - folded_before[name]) / ANAKIN_R2D2_STEPS
                       for name, n in folded.items()}
    loss_t = torch.stack(losses)
    all_finite = bool(torch.isfinite(loss_t).all()) and bool(torch.stack(finite).all())
    with torch.no_grad():
        target_after = torch.cat([p.flatten() for p in ts.target.parameters()])
    copies = ts.step // cfg.target_update_period - step0 // cfg.target_update_period
    lat = np.sort(np.asarray(lat_ms))
    ticks_sorted = np.sort(np.asarray(tick_us))
    emit({"phase": "anakin_r2d2", "steps": ANAKIN_R2D2_STEPS, "batch": cfg.batch_size,
          "sequence": [cfg.r2d2_burn_in, cfg.r2d2_seq_len], "stride": stride, "lanes": lanes,
          "capacity": capacity, "ring_bytes": ring_bytes, "ring_filled": ss.filled,
          "warm_gate": learn_start_seqs, "append_ticks": ticks, "fill_seconds": fill_s,
          "act_append_us_per_tick_p50": float(ticks_sorted[len(ticks_sorted) // 2]),
          "act_append_us_per_tick_mean": float(ticks_sorted.mean()),
          "tick_launches": tick_counts, "k7s_ticks": k7s_ticks, "act_profile": act_profile,
          "learn_steps_per_s": ANAKIN_R2D2_STEPS / elapsed,
          "seconds": elapsed, "step_host_p50_ms": float(lat[len(lat) // 2]),
          "step_host_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
          "launches_per_step": per_step, "folded_per_step": folded_per_step,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "memory_allocated": torch.cuda.memory_allocated(),
          "losses_finite": all_finite, "loss_first": float(loss_t[0]),
          "loss_last": float(loss_t[-1]), "target_copies": copies,
          "target_moved": not torch.equal(target_before, target_after), "cuts": cut_info})
    check(ring_bytes >= RING_R2D2_MIN_BYTES, f"the sequence ring holds {ring_bytes} bytes")
    check(per_step == want, f"launches per R2D2 anakin learn step {per_step}, want {want}")
    check(folded_per_step == {k: float(v) for k, v in ANAKIN_R2D2_FOLDED_PER_STEP.items()},
          f"write-backs folded per R2D2 anakin step {folded_per_step}, want "
          f"{ANAKIN_R2D2_FOLDED_PER_STEP}")
    check(all_finite, "a non-finite loss in the anakin_r2d2 phase")
    check(copies >= 1 and not torch.equal(target_before, target_after),
          "no target copy happened in the anakin_r2d2 phase")
    counts = with_folded(counts, folded)
    profile_anakin_r2d2(torch, fused, ts, ss, gen, beta)
    del ss, replay, ts, fused, stack, state, prev
    torch.cuda.empty_cache()
    return counts


def profile_act_r2d2(torch, np, act_append, ts, stack, ss, state, prev, pool, rng):
    """Where the time of an R2D2 act tick goes (ACT_PROFILE_TICKS of the
    trainer's ``act_append`` ticks, each ending in the loop's read of the
    actions): device ops and device time a tick, by kernel name.  The ticks
    append to the phase's ring, and their launches are in the counts the
    phase returns."""
    from torch.profiler import ProfilerActivity, profile

    from rainbow_iqn_apex_tpu_torch.agents.agent import put_frames
    from rainbow_iqn_apex_tpu_torch.kernels import launches

    lanes = stack.shape[0]
    dev = stack.device
    before = dict(launches)
    cuts = np.zeros(lanes, bool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tick in range(ACT_PROFILE_TICKS):
            frame_d = put_frames(pool[tick % len(pool)], dev)
            keep_d = put_frames((~cuts).astype(np.uint8), dev)
            actions_d, state, pre = act_append(ts.net, stack, ss, state, frame_d, keep_d, prev)
            actions_d.cpu()
            terms = rng.random(lanes) < SEQ_P_TERM
            prev = (frame_d, actions_d, rng.normal(size=lanes).astype(np.float32), terms,
                    np.zeros(lanes, bool), pre[0], pre[1])
            cuts = terms
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    n = ACT_PROFILE_TICKS
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    out = {"ticks": n, "wall_us_per_tick": wall_us / n,
           "device_ops_per_tick": sum(r[2] for r in rows) / n if rows else "not measured",
           "device_us_per_tick": device_us / n if rows else "not measured",
           "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
           "k7s_per_tick": (launches["K7s_seq_append"] - before["K7s_seq_append"]) / n,
           "top": [{"name": k[:80], "us_per_tick": t / n, "calls_per_tick": c / n}
                   for k, t, c in rows[:12]]}
    emit({"phase": "profile_act_r2d2", **out})
    return out


def profile_anakin_r2d2(torch, fused, ts, ss, gen, beta):
    """Where the time of a full-width R2D2 anakin learn step goes: device
    time by kernel name over ANAKIN_R2D2_PROFILE_STEPS steps, and the
    device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ANAKIN_R2D2_PROFILE_STEPS):
            ts, ss, _info = fused(ts, ss, gen, beta)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    n = ANAKIN_R2D2_PROFILE_STEPS
    emit({"phase": "profile_anakin_r2d2", "steps": n, "wall_us_per_step": wall_us / n,
          "device_us_per_step": device_us / n if rows else "not measured",
          "device_busy_share": device_us / wall_us if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_step": t / n, "calls_per_step": c / n}
                  for k, t, c in rows[:15]]})


def phase_anakin_r2d2_parity(torch, cfg):
    """One full-width fused R2D2 anakin step on the card (kernels) against
    the same step through the plain twins on the CPU: the same learner state
    (three steps in), ring (ANAKIN_R2D2_PARITY_SEQS sequences filled through
    K7s, its priorities set to multiples of 1/8 so that both sides' fp32 cdfs
    are exact and draw the same slots), sampler uniforms and head noise."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.ops.learn import host_state, load_host_state
    from rainbow_iqn_apex_tpu_torch.ops.r2d2 import init_r2d2_state
    from rainbow_iqn_apex_tpu_torch.replay.device_sequence import (
        DeviceSequenceReplay,
        build_device_r2d2_learn,
    )
    from rainbow_iqn_apex_tpu_torch.train_anakin_r2d2 import _seq_geometry

    cfg = _r2d2_anakin_cfg(cfg)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    lanes, lstm = cfg.num_envs_per_actor, cfg.lstm_size
    frame = (cfg.frame_height, cfg.frame_width)
    seq, stride, _, _ = _seq_geometry(cfg)
    kw = dict(capacity=ANAKIN_R2D2_PARITY_SEQS, seq_len=seq, frame_shape=frame, lstm_size=lstm,
              lanes=lanes, stride=stride, priority_exponent=cfg.priority_exponent,
              priority_eps=cfg.priority_eps)
    replay, cpu_replay = DeviceSequenceReplay(**kw, device=dev), DeviceSequenceReplay(**kw,
                                                                                        device=cpu)
    ss = _fill_seq_ring(torch, np, replay, replay.init_state(), ANAKIN_R2D2_PARITY_TICKS,
                        SEED + 44)
    card = init_r2d2_state(cfg, 18, cfg.seed, frame)
    fused = build_device_r2d2_learn(cfg, 18, replay)
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    for _ in range(3):  # warm the Adam moments
        card, ss, _ = fused(card, ss, gen, 0.4)
    g = torch.Generator().manual_seed(SEED + 46)
    dyadic = torch.randint(1, 9, ss.priority.shape, generator=g).float() / 8
    ss.priority.copy_(torch.where(ss.priority.cpu() > 0, dyadic, 0.0).to(dev))
    host = host_state(card)
    plain = load_host_state(init_r2d2_state(cfg, 18, cfg.seed, frame, device="cpu"), host)
    ss_cpu = ss.to(cpu)
    beta = 0.5
    u = torch.rand((1, cfg.batch_size), generator=g)
    draws = {k: plain.net.sample_noise(g) for k in ("online", "target")}
    on_card = {k: {n: (a.to(dev), b.to(dev)) for n, (a, b) in nz.items()}
               for k, nz in draws.items()}

    # the sample alone: the same slots, sequences and scalars
    idx_k, batch_k, prob_k = replay.sample_grouped(ss, cfg.batch_size, 1, beta, u=u.to(dev))
    idx_p, batch_p, prob_p = cpu_replay.sample_grouped(ss_cpu, cfg.batch_size, 1, beta, u=u)
    same_idx = bool(torch.equal(idx_k.cpu(), idx_p))
    same_batch = all(torch.equal(getattr(batch_k, f).cpu(), getattr(batch_p, f))
                     for f in ("obs", "action", "reward", "done", "valid", "init_c", "init_h"))
    scalar_rel = max(float(((a.cpu() - b).abs() / b.abs().clamp_min(1e-30)).max())
                     for a, b in ((batch_k.weight, batch_p.weight), (prob_k, prob_p)))
    del batch_k, batch_p
    # the fused step
    card, ss, k_info = fused(card, ss, None, beta, u=u.to(dev), draws=on_card)
    t0 = time.perf_counter()
    plain, ss_cpu, p_info = build_device_r2d2_learn(cfg, 18, cpu_replay)(
        plain, ss_cpu, None, beta, u=u, draws=draws)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    errs = {}
    for key, got, want in (("loss", k_info["loss"], p_info["loss"]),
                           ("priorities", k_info["priorities"], p_info["priorities"]),
                           ("q_mean", k_info["q_mean"], p_info["q_mean"]),
                           ("replay_priority", ss.priority, ss_cpu.priority),
                           ("max_priority", ss.max_priority, ss_cpu.max_priority)):
        got, want = got.cpu().double(), want.double()
        err = (got - want).abs()
        errs[key] = float(err.max())
        check(bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs())),
              f"anakin_r2d2_parity: {key} differs by {errs[key]}")
    gn_rel = abs(k_info["grad_norm"].item() - p_info["grad_norm"].item()) / p_info["grad_norm"].item()
    before = host["params"]
    after_k = {k: v.cpu() for k, v in card.net.state_dict().items()}
    after_p = plain.net.state_dict()
    worst, worst_name = 0.0, ""
    for k in before:
        dk, dp = after_k[k] - before[k], after_p[k] - before[k]
        rel = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, k
    emit({"phase": "anakin_r2d2_parity", "batch": cfg.batch_size, "ring": ANAKIN_R2D2_PARITY_SEQS,
          "ring_filled": ss.filled, "same_idx": same_idx, "same_sequences": same_batch,
          "weight_prob_max_rel_err": scalar_rel, "rel_tol": REPLAY_REL, "max_abs_err": errs,
          "tol": LEARN_PATH_TOL, "grad_norm_rel_err": gn_rel, "grad_norm_rtol": LEARN_GNORM_RTOL,
          "update_rel_l2_worst": worst, "update_worst_tensor": worst_name,
          "update_rtol": LEARN_UPDATE_RTOL,
          "finite": [bool(k_info["finite"]), bool(p_info["finite"])], "cpu_step_s": cpu_s})
    check(same_idx and same_batch, "anakin_r2d2_parity: the card and the CPU sampled differently")
    check(scalar_rel <= REPLAY_REL, f"anakin_r2d2_parity: weight/prob differ by {scalar_rel} rel")
    check(gn_rel <= LEARN_GNORM_RTOL, f"anakin_r2d2_parity: grad_norm differs by {gn_rel} relative")
    check(worst <= LEARN_UPDATE_RTOL,
          f"anakin_r2d2_parity: the update of {worst_name} differs by {worst} (rel L2)")
    check(bool(k_info["finite"]) and bool(p_info["finite"]), "anakin_r2d2_parity: a non-finite step")
    del ss, ss_cpu, card, plain, replay
    torch.cuda.empty_cache()


def phase_train_anakin_r2d2(torch):
    """``python -m rainbow_iqn_apex_tpu_torch.train --role anakin
    --architecture r2d2`` on toy:catch with the JAX package's R2D2 catch
    configuration (``catch_bar``'s r2d2_anakin scenario: tests/test_r2d2.py's
    test_r2d2_learns_catch with ``--role anakin``, 20,000 frames) at
    R2D2_ANAKIN_CATCH_SEEDS, one trainer process each, all at once; the JAX
    test's bar: more than 100 learn steps each and an evaluation mean above
    0.3."""
    _catch_over_seeds("train_anakin_r2d2", "r2d2_anakin", R2D2_ANAKIN_CATCH_SEEDS)


# ------------------------------------------------ device games, fused anakin
def _fused_cfg(cfg):
    """The reference config as the fully fused Anakin on jaxgame:breakout,
    with the `anakin` phases' one cut (printed)."""
    return cfg.replace(role="anakin", env_id="jaxgame:breakout",
                       target_update_period=LEARN_TARGET_PERIOD)


def _game_bytes(torch, game, lanes):
    """K12's bytes of one auto-reset tick: the frames written, the state read
    and written, the actions and episode returns read, the returns and the
    five [L] outputs written."""
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import field_spec

    state = 0
    for name in game.state_type._fields:
        dtype, shape = field_spec(name)
        state += math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    frame = game.frame_shape[0] * game.frame_shape[1]
    return lanes * (frame + 2 * state + 4 + 2 * 4 + 4 + 1 + 1 + 4)


def _states_equal(torch, got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _same_returns(torch, got, want):
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(), want.nan_to_num())


def phase_kernels_games(torch):
    """K12 against its plain twins on the card, bit for bit, for all ten
    games at 16 and 4,096 lanes: init, then GAME_CHECK_TICKS auto-reset
    ticks with random actions; each game's tick timed beside its twin and
    its byte bound.  Then the host adapter's one-lane step (STEP mode, the
    key itself, a direct init on a cut) for GAME_CHECK_TICKS steps, bit for
    bit, timed as the adapter's reset and a step less the reset alone (a
    reset-free step run on and on walks catch's ball off its grid).  The
    kernel line's K12 row is breakout at 16 lanes, the `anakin_fused`
    phase's shape, with breakout's one-lane step beside it."""
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import (
        game_init,
        game_init_plain,
        game_step,
        game_tick,
        game_tick_plain,
    )

    dev = torch.device("cuda", 0)
    rows, failures, main_row, step_row = [], [], None, None
    for name in GAME_NAMES:
        game = make_device_game(name)
        for lanes in GAME_LANES:
            keys = prng.split(prng.prng_key(SEED + lanes), GAME_CHECK_TICKS + 1)
            state, frames = game_init(game, keys[0], lanes, dev)
            want, want_frames = game_init_plain(game, keys[0], lanes, dev)
            equal = _states_equal(torch, state, want) and torch.equal(frames, want_frames)
            ep, want_ep = (torch.zeros(lanes, device=dev) for _ in range(2))
            gen = torch.Generator(device=dev).manual_seed(SEED)
            cuts = 0
            for t in range(1, GAME_CHECK_TICKS + 1):
                a = torch.randint(0, game.num_actions, (lanes,), generator=gen, device=dev,
                                  dtype=torch.int32)
                got = game_tick(game, state, ep, a, keys[t])
                want, want_ep, *outs = game_tick_plain(game, want, want_ep, a, keys[t])
                equal = (equal and _states_equal(torch, state, want) and torch.equal(ep, want_ep)
                         and all(torch.equal(g, w) for g, w in zip(got[:4], outs[:4]))
                         and _same_returns(torch, got[4], outs[4]))
                cuts += int((got[2] | got[3]).sum())
            if not equal:
                failures.append(f"{name} at {lanes} lanes")
            ms = time_ms(torch, lambda: game_tick(game, state, ep, a, keys[1]))
            plain_ms = time_ms(torch, lambda: game_tick_plain(game, want, want_ep, a, keys[1]),
                               graph=False, reps=GAME_PLAIN_REPS)
            b_ms, b_by = bound_ms(_game_bytes(torch, game, lanes), 0.0, FP32_FLOPS)
            row = {"game": name, "lanes": lanes, "bit_equal": equal, "cuts": cuts,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            if name == "breakout" and lanes == GAME_LANES[0]:
                main_row = row
        keys = prng.split(prng.prng_key(SEED + 1), GAME_CHECK_TICKS + 1)
        state, _ = game_init(game, keys[0], 1, dev, direct=True)
        want = game.init(keys[0].to(dev)[None])
        equal, cuts = _states_equal(torch, state, want), 0
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for t in range(1, GAME_CHECK_TICKS + 1):
            a = torch.randint(0, game.num_actions, (1,), generator=gen, device=dev,
                              dtype=torch.int32)
            got = game_step(game, state, a, keys[t])
            want, *outs = game.step(want, a, keys[t].to(dev)[None])
            equal = (equal and _states_equal(torch, state, want)
                     and torch.equal(got[0], game.render(want))
                     and all(torch.equal(g, w) for g, w in zip(got[1:], outs)))
            if bool(got[2] | got[3]):  # the adapter's reset: a direct init from the key
                cuts += 1
                state, _ = game_init(game, keys[t], 1, dev, direct=True)
                want = game.init(keys[t].to(dev)[None])
                equal = equal and _states_equal(torch, state, want)
        if not equal:
            failures.append(f"{name} at one lane (step)")
        k1 = keys[1].to(dev)[None]

        def reset_and_step():
            fresh, _ = game_init(game, keys[2], 1, dev, direct=True)
            return game_step(game, fresh, a, keys[3])

        reset_ms = time_ms(torch, lambda: game_init(game, keys[2], 1, dev, direct=True))
        both_ms = time_ms(torch, reset_and_step)
        plain_ms = time_ms(torch, lambda: game.render(game.step(want, a, k1)[0]), graph=False,
                           reps=GAME_PLAIN_REPS)
        b_ms, b_by = bound_ms(_game_bytes(torch, game, 1), 0.0, FP32_FLOPS)
        row = {"game": name, "lanes": 1, "mode": "step", "bit_equal": equal, "cuts": cuts,
               "ms": both_ms - reset_ms, "reset_and_step_ms": both_ms, "reset_ms": reset_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if name == "breakout":
            step_row = row
    emit({"phase": "kernels_games", "ticks": GAME_CHECK_TICKS, "rows": rows})
    check(not failures, f"K12 differs from its twin: {failures}")
    return {"K12_device_games": {"max_abs_err": 0.0, "ms": main_row["ms"],
                                 "plain_ms": main_row["plain_ms"],
                                 "bound_ms": main_row["bound_ms"],
                                 "bound_by": main_row["bound_by"], "library_ms": None,
                                 "one_lane_step": {k: step_row[k] for k in (
                                     "ms", "reset_and_step_ms", "reset_ms", "plain_ms",
                                     "bound_ms")}}}


def _fused_expected(per_tick_kernels, ticks, learns):
    """Launches of `ticks` fused ticks with `learns` learn steps in all."""
    want = {name: 0 for name in ANAKIN_PER_STEP}
    for name, n in FUSED_PER_TICK.items():
        want[name] += n * ticks
    for name, n in ANAKIN_PER_STEP.items():
        want[name] += n * learns
    return want


def phase_anakin_fused(torch, cfg):
    """The fully fused Anakin at full width on jaxgame:breakout through the
    port's entry points (``init_fused_carry``, ``build_fused_segment`` over
    ``build_device_learn``): the uncut 1,000,000-slot ring of 80x80 frames,
    cold segments up to the config's warm gate of 20,000 stored frames, then
    one warm-up and FUSED_SEGMENTS timed warm segments, each under
    ``forbid_host_sync()`` and read once, with the exact launches of every
    segment; then a profile of one more segment."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game
    from rainbow_iqn_apex_tpu_torch.kernels import folded, launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.ops.learn import init_train_state
    from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, build_device_learn
    from rainbow_iqn_apex_tpu_torch.train_anakin import build_fused_segment, init_fused_carry
    from rainbow_iqn_apex_tpu_torch.utils import hostsync

    cfg = _fused_cfg(cfg)
    game = make_device_game(cfg.env_id.split(":", 1)[1])
    lanes, T = cfg.num_envs_per_actor, cfg.anakin_segment_ticks
    seg = cfg.memory_capacity // lanes
    learns_per_tick = lanes // cfg.frames_per_learn
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    replay = DeviceReplay(lanes=lanes, seg=seg, frame_shape=game.frame_shape,
                          history=cfg.history_length, n_step=cfg.multi_step, gamma=cfg.gamma,
                          priority_exponent=cfg.priority_exponent,
                          priority_eps=cfg.priority_eps)  # cuda:0 by default
    ds = replay.init_state()
    ring_bytes = torch.cuda.memory_allocated() - mem0
    ts = init_train_state(cfg, game.num_actions, cfg.seed,
                          state_shape=(*game.frame_shape, cfg.history_length))
    segment = build_fused_segment(cfg, game, replay,
                                  build_device_learn(cfg, game.num_actions, replay))
    key = prng.prng_key(cfg.seed)
    key, _, k_env = prng.split(key, 3)
    carry = init_fused_carry(cfg, game, replay, ts, ds, k_env)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cuts = {"target_update_period": cfg.target_update_period,
            "window": f"{FUSED_SEGMENTS} warm segments of {T} ticks after the warm gate, not t_max"}

    reset_launches()  # the main path: every segment of this phase
    cold_ms, warm_ms, cold_ok, warm_ok, losses, returns = [], [], [], [], [], []
    folds_ok = []  # each segment: one write-back folded into K1 a learn step
    first_warm_tick, segments, warm_seen = None, 0, 0
    try:
        while warm_seen < FUSED_SEGMENTS + 1:
            key, k = prng.split(key, 2)
            before, steps0, folds0 = dict(launches), carry[0].step, dict(folded)
            t0 = time.perf_counter()
            with hostsync.forbid_host_sync():
                carry, (out_ret, loss, _q, _g) = segment(carry, k, gen)
            ret_h = hostsync.to_host(out_ret)  # the segment's one read
            dt_ms = (time.perf_counter() - t0) * 1e3
            segments += 1
            learned = carry[0].step - steps0
            per = {name: launches[name] - before[name] for name in launches}
            want = _fused_expected(FUSED_PER_TICK, T, learned)
            folds_ok.append({n: folded[n] - folds0[n] for n in folded}
                            == {n: v * learned for n, v in ANAKIN_FOLDED_PER_STEP.items()})
            returns += [float(r) for r in ret_h[~np.isnan(ret_h)]]
            if learned and first_warm_tick is None:
                first_warm_tick = segments * T - learned // learns_per_tick + 1
            if learned == 0:
                cold_ms.append(dt_ms)
                cold_ok.append(per == want)
            elif learned == T * learns_per_tick:
                warm_seen += 1
                if warm_seen > 1:  # the first warm segment is the warm-up
                    warm_ms.append(dt_ms)
                    warm_ok.append(per == want)
                    losses.append(hostsync.to_host(loss))
    except RuntimeError as e:  # CUDA's sync debug mode, or a HostSyncError
        raise SmokeFailure(f"a host sync inside a fused segment: {e}")
    counts = dict(launches)
    timed_s = sum(warm_ms) / 1e3
    loss_all = np.concatenate([x.ravel() for x in losses])
    lat = np.sort(np.asarray(warm_ms))
    stored_at_warm = (first_warm_tick or 0) * lanes
    row = {"phase": "anakin_fused", "env": cfg.env_id, "lanes": lanes, "capacity": cfg.memory_capacity,
           "seg": seg, "frame": list(game.frame_shape), "ring_bytes": ring_bytes,
           "segment_ticks": T, "learns_per_tick": learns_per_tick,
           "learn_start": cfg.learn_start, "ticks_to_warm": first_warm_tick,
           "stored_at_first_learn": stored_at_warm, "segments": segments,
           "cold_segment_p50_ms": float(np.median(cold_ms)) if cold_ms else None,
           "cold_frames_per_s": lanes * T * len(cold_ms) / (sum(cold_ms) / 1e3) if cold_ms else None,
           "segments_per_s": len(warm_ms) / timed_s,
           "learn_steps_per_s": len(warm_ms) * T * learns_per_tick / timed_s,
           "frames_per_s": len(warm_ms) * T * lanes / timed_s,
           "segment_host_p50_ms": float(lat[len(lat) // 2]),
           "segment_host_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
           "peak_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "per_tick": FUSED_PER_TICK,
           "launches_exact_cold": all(cold_ok), "launches_exact_warm": all(warm_ok),
           "folded": dict(folded), "folded_exact": all(folds_ok),
           "losses_finite": bool(np.isfinite(loss_all).all()), "episodes_ended": len(returns),
           "return_mean": float(np.mean(returns)) if returns else None,
           "learn_steps": carry[0].step, "cuts": cuts}
    emit(row)
    check(ring_bytes >= RING_FUSED_MIN_BYTES, f"the fused ring holds only {ring_bytes} B")
    check(first_warm_tick == -(-cfg.learn_start // lanes),
          f"first learn at tick {first_warm_tick}, want {-(-cfg.learn_start // lanes)}")
    check(cold_ok and all(cold_ok), "launches of a cold fused segment differ from the prediction")
    check(warm_ok and all(warm_ok), "launches of a warm fused segment differ from the prediction")
    check(all(folds_ok), "a fused segment's write-backs folded into K1 differ from its learn steps")
    check(row["losses_finite"], "a non-finite loss in a fused segment")
    check(all(math.isfinite(r) for r in returns) and returns, "no finite episode return")
    counts = with_folded(counts, folded)
    profile_fused(torch, segment, carry, key, gen)
    del carry, ds, replay, ts, segment
    torch.cuda.empty_cache()
    return counts


def profile_fused(torch, segment, carry, key, gen):
    """Where the time of a warm full-width fused segment goes: device time by
    kernel name from torch.profiler, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from rainbow_iqn_apex_tpu_torch.envs import prng

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _outs = segment(carry, prng.split(key, 2)[1], gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile_anakin_fused", "segments": 1, "wall_us_per_segment": wall_us,
          "device_us_per_segment": device_us if rows else "not measured",
          "device_busy_share": device_us / wall_us if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_segment": t, "calls": c} for k, t, c in rows[:15]]})


def phase_anakin_fused_parity(torch, cfg):
    """One fused segment on the card (kernels) against the same segment on
    the CPU (plain twins): the same train state, lanes, key and injected
    taus, noise and sampler uniforms.  The segment is FUSED_PARITY_TICKS
    ticks over a 16 x 1,024 ring with the warm gate on its last tick and
    one learn step there (frames_per_learn 16), so the learn step draws from
    priorities that are equal on both sides.  The advantage head's output
    layer is planted (weights and noise scales zero, biases 0, 0.5, 1.0) so
    that every greedy action is clear by far more than the bf16 tolerance:
    both sides take the same actions, and lanes, frames and the ring's
    integer fields are compared exactly."""
    from rainbow_iqn_apex_tpu_torch.envs import prng
    from rainbow_iqn_apex_tpu_torch.envs.device_games import make_device_game
    from rainbow_iqn_apex_tpu_torch.ops.learn import host_state, init_train_state, load_host_state
    from rainbow_iqn_apex_tpu_torch.replay.device import DeviceReplay, build_device_learn
    from rainbow_iqn_apex_tpu_torch.train_anakin import build_fused_segment, init_fused_carry

    lanes = 16
    cfg = _fused_cfg(cfg).replace(frames_per_learn=lanes, anakin_segment_ticks=FUSED_PARITY_TICKS,
                                  learn_start=lanes * FUSED_PARITY_TICKS,
                                  memory_capacity=lanes * 1024)
    game = make_device_game("breakout")
    A = game.num_actions
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    kw = dict(lanes=lanes, seg=1024, frame_shape=game.frame_shape, history=cfg.history_length,
              n_step=cfg.multi_step, gamma=cfg.gamma, priority_exponent=cfg.priority_exponent,
              priority_eps=cfg.priority_eps)
    replay, cpu_replay = DeviceReplay(**kw, device=dev), DeviceReplay(**kw, device=cpu)
    card = init_train_state(cfg, A, cfg.seed, state_shape=(*game.frame_shape, cfg.history_length))
    with torch.no_grad():
        for net in (card.net, card.target):
            head = net.advantage_out
            for p in (head.w_mu, head.w_sigma, head.b_sigma):
                p.zero_()
            head.b_mu.copy_(torch.tensor([0.0, 0.5, 1.0], device=dev))
    plain = load_host_state(init_train_state(cfg, A, cfg.seed, device=cpu,
                                             state_shape=(*game.frame_shape, cfg.history_length)),
                            host_state(card))
    k_env = prng.split(prng.prng_key(cfg.seed), 3)[2]
    card_carry = init_fused_carry(cfg, game, replay, card, replay.init_state(), k_env)
    cpu_carry = init_fused_carry(cfg, game, cpu_replay, plain, cpu_replay.init_state(), k_env)
    init_equal = (_states_equal(torch, [t.cpu() for t in card_carry[2]], cpu_carry[2])
                  and torch.equal(card_carry[5].cpu(), cpu_carry[5]))
    g = torch.Generator().manual_seed(SEED + 31)
    draws_cpu, draws_card = [], []
    for t in range(FUSED_PARITY_TICKS):
        taus = torch.rand((lanes, cfg.num_quantile_samples), generator=g)
        noise = {k: (torch.randn(getattr(plain.net, k).in_features, generator=g),
                     torch.randn(getattr(plain.net, k).out_features, generator=g))
                 for k in plain.net.noisy_names}
        tick_cpu = {"act": {"taus": taus, "noise": noise}}
        tick_card = {"act": {"taus": taus.to(dev),
                             "noise": {k: (a.to(dev), b.to(dev)) for k, (a, b) in noise.items()}}}
        if t == FUSED_PARITY_TICKS - 1:
            u = torch.rand(cfg.batch_size, generator=g)
            learn_cpu, learn_card = _learn_draws(torch, cfg, plain.net, g)
            tick_cpu["learn"] = [{"u": u, "draws": learn_cpu}]
            tick_card["learn"] = [{"u": u.to(dev), "draws": learn_card}]
        draws_cpu.append(tick_cpu)
        draws_card.append(tick_card)
    key = prng.prng_key(SEED + 32)
    card_seg = build_fused_segment(cfg, game, replay, build_device_learn(cfg, A, replay))
    cpu_seg = build_fused_segment(cfg, game, cpu_replay, build_device_learn(cfg, A, cpu_replay))
    card_carry, card_out = card_seg(card_carry, key, None, draws=draws_card)
    t0 = time.perf_counter()
    cpu_carry, cpu_out = cpu_seg(cpu_carry, key, None, draws=draws_cpu)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    lanes_equal = (_states_equal(torch, [t.cpu() for t in card_carry[2]], cpu_carry[2])
                   and all(torch.equal(card_carry[i].cpu(), cpu_carry[i]) for i in (3, 4, 5, 6)))
    ring_equal = all(torch.equal(getattr(card_carry[1], f).cpu(), getattr(cpu_carry[1], f))
                     for f in ("frames", "actions", "rewards", "terminals", "cuts"))
    returns_equal = _same_returns(torch, card_out[0].cpu(), cpu_out[0])
    errs = {}
    for name, got, want in (("loss", card_out[1], cpu_out[1]), ("q_mean", card_out[2], cpu_out[2]),
                            ("replay_priority", card_carry[1].priority, cpu_carry[1].priority),
                            ("max_priority", card_carry[1].max_priority, cpu_carry[1].max_priority)):
        got, want = got.cpu().double(), want.double()
        finite = torch.isfinite(want)
        err = (got[finite] - want[finite]).abs()
        errs[name] = float(err.max()) if err.numel() else 0.0
        check(torch.equal(torch.isfinite(got), finite) and bool(torch.all(
            err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want[finite].abs())),
            f"anakin_fused_parity: {name} differs by {errs[name]}")
    learned = (card_carry[0].step, cpu_carry[0].step)
    emit({"phase": "anakin_fused_parity", "env": cfg.env_id, "ticks": FUSED_PARITY_TICKS,
          "ring": [lanes, 1024], "learn_steps": list(learned), "init_equal": init_equal,
          "lanes_equal": lanes_equal, "ring_fields_equal": ring_equal,
          "returns_equal": returns_equal,
          "actions": sorted(set(card_carry[1].actions[:, :FUSED_PARITY_TICKS].flatten().tolist())),
          "max_abs_err": errs, "tol": LEARN_PATH_TOL, "cpu_segment_s": cpu_s})
    check(learned == (1, 1), f"anakin_fused_parity: learn steps {learned}, want one each")
    check(init_equal and lanes_equal and ring_equal and returns_equal,
          "anakin_fused_parity: lanes, frames or the ring differ between the card and the CPU")


def phase_train_anakin_fused(torch):
    """``python -m rainbow_iqn_apex_tpu_torch.train --role anakin`` on
    jaxgame:catch, the fully fused path (``catch_bar``'s anakin_fused
    scenario: tests/test_anakin_fused.py's test_fused_learns_catch in bf16,
    8,000 frames) at FUSED_CATCH_SEEDS, one trainer process each, all at
    once; the JAX test's bar in every run: eval above 0.5 and more than
    2,500 learn steps."""
    _catch_over_seeds("train_anakin_fused", "anakin_fused", FUSED_CATCH_SEEDS, env="jaxgame:catch",
                      every_run=True)


# ------------------------------------------------- multi-game Ape-X (slice 9)
def _mt_spec():
    from rainbow_iqn_apex_tpu_torch.multitask.spec import MultiGameSpec

    return MultiGameSpec.probe(tuple(MT_GAMES.split(",")), device="cuda")


def _mt_mask(torch, counts, actions, dev):
    mask = torch.zeros((len(counts), actions), dtype=torch.bool, device=dev)
    for g, n in enumerate(counts):
        mask[g, :n] = True
    return mask


def phase_kernels_mt(torch, cfg):
    """K2g (forward and backward), K4m and K4l against their plain twins at
    the multi-game path's shapes (learn B 32, N 64 and K 32, F 2304 of 80x80
    frames, A 5, G 4) and at serving's (B 64, K 32, F 3136, A 18), timed
    beside the twin, the bound and the nearest PyTorch call."""
    from rainbow_iqn_apex_tpu_torch.kernels.dueling_head import (
        dueling_head,
        dueling_head_plain,
        dueling_logp,
        dueling_logp_plain,
    )
    from rainbow_iqn_apex_tpu_torch.kernels.tau_embed import (
        game_embed_grad,
        tau_embed,
        tau_embed_bwd,
        tau_embed_bwd_plain,
        tau_embed_plain,
    )
    from rainbow_iqn_apex_tpu_torch.models.layers import trunk_features

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    bf = torch.bfloat16
    cos_n, games = cfg.num_cosines, 4
    shapes = {  # name: (B, N of K2g, K of K4m / K4l, F, A, per-game action counts)
        "path": (cfg.batch_size, cfg.num_tau_samples, cfg.num_quantile_samples,
                 trunk_features(80, 80), 5, (3, 5, 4, 3)),
        "serving": (BUCKET, cfg.num_quantile_samples, cfg.num_quantile_samples,
                    trunk_features(84, 84), 18, (18, 9, 6, 4)),
    }
    results = {}
    for where, (batch, n, k, feat, actions, counts) in shapes.items():
        m = batch * n
        game = torch.arange(batch, device=dev, dtype=torch.int32) % games
        game = game[torch.randperm(batch, generator=gen, device=dev)].contiguous()
        taus = torch.rand((batch, n), generator=gen, device=dev)
        w_e = (torch.randn((feat, cos_n), generator=gen, device=dev) * cos_n ** -0.5).to(bf)
        b_e = torch.randn((feat,), generator=gen, device=dev) * 0.1
        phi = torch.randn((batch, feat), generator=gen, device=dev).relu().to(bf)
        emb = torch.randn((games, feat), generator=gen, device=dev) * 0.3  # non-zero: routing shows
        args = (taus, w_e, b_e, phi, game, emb)
        got, want = tau_embed(*args), tau_embed_plain(*args)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(torch, got, want, K2_TOL)
        nbytes = (m * 4 + feat * cos_n * 2 + feat * 4 + batch * feat * 2 + games * feat * 4
                  + batch * 4 + m * feat * 2)
        bms, by = bound_ms(nbytes, 2 * m * feat * cos_n, BF16_FLOPS)
        k_ms, p_ms = time_ms(torch, lambda: tau_embed(*args)), time_ms(torch, lambda: tau_embed_plain(*args))
        emit({"phase": "kernels_mt", "kernel": "K2g_tau_embed_game", "shape": [m, feat, cos_n, games],
              "at": where, "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": K2_TOL, "ok": ok,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bms,
              "bound_by": by})
        check(ok, f"K2g disagrees with its plain twin at {where}: max abs {max_abs}")
        if where == "path":
            results["K2g_tau_embed_game"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                                 bound_ms=bms, bound_by=by, library_ms=None)

        dh = torch.randn((m, feat), generator=gen, device=dev).to(bf)
        cos_t = tau_embed(*args, save_cos=True)[1]  # what K2g saves for the backward
        got = tau_embed_bwd(*args[:4], dh, game, emb, cos_t)
        want = tau_embed_bwd_plain(*args[:4], dh, game, emb)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for name, g_, w_ in zip(("dphi", "dW_e", "db_e", "dE"), got, want):
            scale = w_.float().abs().max().item()
            tol = dict(atol=GRAD_BF16_REL * scale, rtol=GRAD_BF16_REL)
            a_err, _, good = errors(torch, g_, w_, tol)
            errs[name], ok = a_err, ok and good
        # dE is the per-game fp32 sum of the kernel's own bf16 dphi
        de_err, _, de_ok = errors(torch, got[3], game_embed_grad(got[0], game, games), K4_TOL)
        ok = ok and de_ok
        nbytes = (m * 4 + feat * cos_n * 2 + feat * 4 + batch * feat * 2
                  + m * feat * 2 + games * feat * 4 + batch * 4 + batch * feat * 2
                  + feat * cos_n * 2 + feat * 4 + games * feat * 4)
        bms, by = bound_ms(nbytes, 4 * m * feat * cos_n, BF16_FLOPS)
        k_ms = time_ms(torch, lambda: tau_embed_bwd(*args[:4], dh, game, emb, cos_t))
        p_ms = time_ms(torch, lambda: tau_embed_bwd_plain(*args[:4], dh, game, emb))
        dphi32, game64 = got[0].float(), game.long()
        out = torch.zeros((games, feat), device=dev)
        lib_ms = time_ms(torch, lambda: out.zero_().index_add_(0, game64, dphi32))
        emit({"phase": "kernels_mt", "kernel": "K2g_tau_embed_game_bwd",
              "shape": [m, feat, cos_n, games], "at": where, "max_abs_err": errs,
              "dE_vs_own_dphi_max_abs": de_err,
              "tol": "4 bf16 ulps (2^-6) of each element and of the output's largest",
              "ok": ok, "kernel_ms": k_ms,
              "plain_ms": p_ms, "library_ms": lib_ms, "library": "index_add_ of dE alone",
              "bound_ms": bms, "bound_by": by})
        check(ok, f"K2g-bwd disagrees with its plain twin at {where}: {errs}, dE {de_err}")
        if where == "path":
            results["K2g_tau_embed_game_bwd"] = dict(
                max_abs_err=max(errs.values()), ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)

        # K4m: rows whose unmasked argmax is a pad slot are planted
        mk = batch * k
        mask = _mt_mask(torch, counts, actions, dev)
        value = torch.randn((mk, 1), generator=gen, device=dev)
        adv = torch.randn((mk, actions), generator=gen, device=dev)
        pad_rows = [b for b in range(batch) if counts[int(game[b])] < actions][:4]
        for b in pad_rows:
            adv[b * k:(b + 1) * k, actions - 1] += 8.0
        got, want = dueling_head(value, adv, k, game, mask), dueling_head_plain(value, adv, k, game, mask)
        torch.cuda.synchronize()
        max_abs, ok = 0.0, True
        for g_, w_ in zip(got[:2], want[:2]):
            a_err, _, good = errors(torch, g_, w_, K4_TOL)
            max_abs, ok = max(max_abs, a_err), ok and good
        ok = ok and bool(torch.equal(got[2], want[2]))
        limit = torch.tensor(counts, device=dev)[game.long()]
        inside = bool((got[2] < limit).all())
        unmasked = want[0].mean(dim=1).argmax(dim=-1)
        planted = all(int(unmasked[b]) == actions - 1 for b in pad_rows)
        nbytes = mk * 4 + mk * actions * 4 + batch * 4 + games * actions + mk * actions * 4 \
            + batch * actions * 4 + batch * 4
        bms, by = bound_ms(nbytes, 4 * mk * actions, FP32_FLOPS)
        k_ms = time_ms(torch, lambda: dueling_head(value, adv, k, game, mask))
        p_ms = time_ms(torch, lambda: dueling_head_plain(value, adv, k, game, mask))
        emit({"phase": "kernels_mt", "kernel": "K4m_dueling_head_mask", "shape": [batch, k, actions],
              "at": where, "pad_rows_planted": len(pad_rows), "pad_rows_unmasked_argmax_pad": planted,
              "actions_inside_game": inside, "max_abs_err": max_abs, "tol": K4_TOL, "ok": ok,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bms,
              "bound_by": by})
        check(ok and inside and planted and pad_rows,
              f"K4m disagrees with its twin, or takes a masked action, at {where}")
        if where == "path":
            results["K4m_dueling_head_mask"] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                                    bound_ms=bms, bound_by=by, library_ms=None)

        # K4l: masked (the multi-game reuse ratio) and unmasked (single-game)
        take = (torch.randint(0, 1 << 20, (batch,), generator=gen, device=dev) % limit).to(torch.int32)
        row = {}
        for masked in (True, False):
            margs = (game, mask) if masked else ()
            got, want = dueling_logp(value, adv, k, take, *margs), dueling_logp_plain(value, adv, k, take, *margs)
            again = dueling_logp(value, adv, k, take, *margs)
            torch.cuda.synchronize()
            a_err, _, ok = errors(torch, got[0], want[0], K4_TOL)
            q_err, _, q_ok = errors(torch, got[1], want[1], K4_TOL)
            repeat = bool(torch.equal(again[0], got[0]))
            k_ms = time_ms(torch, lambda: dueling_logp(value, adv, k, take, *margs))
            p_ms = time_ms(torch, lambda: dueling_logp_plain(value, adv, k, take, *margs))
            q_in, take64 = want[1].clone(), take.long()[:, None]
            lib_ms = time_ms(torch, lambda: torch.log_softmax(q_in, dim=-1).gather(1, take64))
            nbytes = mk * 4 + mk * actions * 4 + batch * 4 + (batch * 4 + games * actions
                                                              if masked else 0) \
                + batch * actions * 4 + batch * 4
            bms, by = bound_ms(nbytes, 4 * mk * actions + 3 * batch * actions, FP32_FLOPS)
            row[masked] = dict(max_abs_err=max(a_err, q_err), ms=k_ms, plain_ms=p_ms,
                               bound_ms=bms, bound_by=by, library_ms=lib_ms)
            emit({"phase": "kernels_mt", "kernel": "K4l_dueling_head_logp",
                  "shape": [batch, k, actions], "at": where, "masked": masked,
                  "max_abs_err": a_err, "q_max_abs_err": q_err, "tol": K4_TOL,
                  "repeat_bit_equal": repeat, "ok": ok and q_ok and repeat, "kernel_ms": k_ms,
                  "plain_ms": p_ms, "library_ms": lib_ms,
                  "library": "log_softmax + gather on K4's q", "bound_ms": bms, "bound_by": by})
            check(ok and q_ok and repeat, f"K4l (masked={masked}) disagrees at {where}")
        if where == "path":
            results["K4l_dueling_head_logp"] = row[True]
            # the multi-game learn pass's one heads launch (K4m: its select head is masked)
            results["K4m_dueling_head_mask"]["heads"] = check_heads(
                torch, "kernels_mt", batch, (k, cfg.num_tau_prime_samples, n), actions, gen,
                counts, cfg.gamma ** cfg.multi_step)
    return results


def phase_apex_mt(torch, cfg):
    """Multi-game Ape-X at full width through ``train_apex``: the reference
    config with ``games`` = the four-game jaxgame suite (16 lanes, 4 a
    game, one ``JaxGameEnv`` each: K12 per lane step), ``replay_ratio`` 2,
    ``multitask_schedule`` uniform, a ``MultiGameReplay`` of four game shard
    blocks over the uncut 1,000,000 slots of 80x80 frames, past
    ``learn_start`` cut to MT_LEARN_START frames: the loop's backlog of sampled batches
    (frames // frames_per_learn at the first warm tick), then a window of
    MT_WINDOW_TICKS ticks.  Hooks on ``ApexDriver`` and ``VectorEnv`` read
    the launch counters around each act, env step and learn call (exact per
    call), the clocks, and whether any masked action was taken; a profile
    spans MT_PROFILE_TICKS window ticks."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rainbow_iqn_apex_tpu_torch.envs.base import VectorEnv
    from rainbow_iqn_apex_tpu_torch.envs.device_games import JaxGameEnv
    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.parallel.apex import ApexDriver, train_apex

    spec = _mt_spec()
    lanes = cfg.num_actors * cfg.num_envs_per_actor
    limit = np.repeat(np.asarray(spec.num_actions), lanes // spec.num_games)
    work = tempfile.mkdtemp(prefix="apex_mt-")
    run = cfg.replace(games=MT_GAMES, replay_ratio=MT_REPLAY_RATIO, multitask_schedule="uniform",
                      learn_start=MT_LEARN_START, target_update_period=LEARN_TARGET_PERIOD,
                      weight_publish_interval=APEX_PUBLISH,
                      metrics_interval=MT_METRICS, eval_episodes=1, stall_timeout_s=0.0,
                      run_id="apex_mt", results_dir=os.path.join(work, "results"),
                      checkpoint_dir=os.path.join(work, "ckpt"))
    ticks_to_warm = -(-run.learn_start // lanes)
    max_frames = (ticks_to_warm + MT_WINDOW_TICKS) * lanes
    rec = {"tick_t": [], "tick_batches": [], "batches": 0, "batch_launch_bad": [],
           "act_launch_bad": [], "env_launch_bad": [], "masked_taken": 0, "acts": 0,
           "resets": 0, "prof": None, "prof_t": None, "prof_wall": None, "learn_t": []}
    names = sorted(set(MT_PER_BATCH) | set(MT_PER_ACT) | {"K12_device_games"} | set(launches))
    orig = (ApexDriver.learn_batch, ApexDriver.act_frames, ApexDriver.act, VectorEnv.step,
            JaxGameEnv.reset)

    def delta(before):
        return {n: launches[n] - before[n] for n in names if launches[n] != before[n]}

    def learn_batch(self, batch, draws=None):
        before = dict(launches)
        info = orig[0](self, batch, draws)
        got = delta(before)
        if got != MT_PER_BATCH:
            rec["batch_launch_bad"].append(got)
        rec["batches"] += 1
        rec["learn_t"].append(time.perf_counter())
        return info

    def acted(self, fn, *a):
        before = dict(launches)
        actions, q = fn(self, *a)
        if delta(before) != MT_PER_ACT:
            rec["act_launch_bad"].append(delta(before))
        rec["acts"] += 1
        rec["masked_taken"] += int((np.asarray(actions) >= limit).sum())
        return actions, q

    def env_step(self, actions):
        tick = len(rec["tick_t"])
        window = tick - ticks_to_warm  # 0 on the backlog's tick
        if window == MT_PROFILE_FROM:
            torch.cuda.synchronize()
            rec["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            rec["prof"].__enter__()
            rec["prof_t"] = time.perf_counter()
        elif window == MT_PROFILE_FROM + MT_PROFILE_TICKS and rec["prof"] is not None:
            torch.cuda.synchronize()
            rec["prof_wall"] = time.perf_counter() - rec["prof_t"]
            rec["prof"].__exit__(None, None, None)
        rec["tick_t"].append(time.perf_counter())
        rec["tick_batches"].append(rec["batches"])
        before, resets = dict(launches), rec["resets"]
        out = orig[3](self, actions)
        want = {"K12_device_games": len(self.envs) + rec["resets"] - resets}
        if delta(before) != want:
            rec["env_launch_bad"].append(delta(before))
        return out

    def reset(self):
        rec["resets"] += 1
        return orig[4](self)

    ApexDriver.learn_batch = learn_batch
    ApexDriver.act_frames = lambda self, *a: acted(self, orig[1], *a)
    ApexDriver.act = lambda self, *a: acted(self, orig[2], *a)
    VectorEnv.step = env_step
    JaxGameEnv.reset = reset
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        summary = train_apex(run, max_frames=max_frames)  # cuda:0 by default
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        (ApexDriver.learn_batch, ApexDriver.act_frames, ApexDriver.act, VectorEnv.step,
         JaxGameEnv.reset) = orig
    peak = torch.cuda.max_memory_allocated()
    tick_t, tick_b = np.asarray(rec["tick_t"]), np.asarray(rec["tick_batches"])
    # tick_b[i]: batches dispatched before env step i.  The first warm tick
    # (the learn_start backlog's) is the last with none before its successor
    warm = int(np.argmax(tick_b[1:] > 0)) if rec["batches"] else -1
    backlog = int(tick_b[warm + 1] if warm + 1 < len(tick_b) else rec["batches"])
    learn_t = np.asarray(rec["learn_t"])
    backlog_s = float(learn_t[backlog - 1] - learn_t[0]) if backlog > 1 else float("nan")
    w0, w1 = warm + 1, len(tick_t) - 1  # window: the ticks after the backlog's tick
    window_s = float(tick_t[w1] - tick_t[w0])
    window_batches = int(tick_b[w1] - tick_b[w0])
    window_ticks = w1 - w0
    fill_s = float(tick_t[warm] - tick_t[0]) if warm > 0 else float("nan")
    prof_rows = device_rows(torch, rec["prof"]) if rec["prof"] is not None else []
    busy_us = sum(r[1] for r in prof_rows)
    idle = (1.0 - busy_us / (rec["prof_wall"] * 1e6)) if prof_rows and rec["prof_wall"] else None
    prof_rows.sort(key=lambda r: -r[1])
    rows = [json.loads(line) for line in open(os.path.join(run.results_dir, run.run_id,
                                                            "metrics.jsonl"))]
    games_rows = [r for r in rows if r["kind"] == "games"]
    learn_rows = [r for r in rows if r["kind"] == "learn"]
    evals = {r["game"]: r["score_mean"] for r in rows if r["kind"] == "eval" and r.get("game")}
    last = games_rows[-1]["games"] if games_rows else {}
    shares = {g: e.get("learn_share") for g, e in last.items()}
    occupancy = {g: e.get("replay_occupancy") for g, e in last.items()}
    emit({"phase": "apex_mt", "games": list(spec.games), "num_actions": list(spec.num_actions),
          "lanes": lanes, "replay_ratio": MT_REPLAY_RATIO, "capacity": run.memory_capacity,
          "frame": list(spec.frame_shape), "learn_start": run.learn_start,
          "cuts": {"learn_start": run.learn_start,
                   "target_update_period": run.target_update_period,
                   "weight_publish_interval": run.weight_publish_interval,
                   "metrics_interval": run.metrics_interval, "eval_episodes": run.eval_episodes,
                   "max_frames": max_frames},
          "frames": summary["frames"], "learn_steps": summary["learn_steps"],
          "sampled_batches": rec["batches"], "seconds": total_s,
          "fill_ticks": warm + 1, "fill_seconds": fill_s,
          "fill_env_frames_per_s": warm * lanes / fill_s if warm > 0 else None,
          "backlog_batches": backlog, "backlog_seconds": backlog_s,
          "backlog_batches_per_s": (backlog - 1) / backlog_s if backlog > 1 else None,
          "backlog_sgd_steps_per_s": MT_REPLAY_RATIO * (backlog - 1) / backlog_s
          if backlog > 1 else None,
          "window_ticks": window_ticks, "window_batches": window_batches, "window_seconds": window_s,
          "window_env_frames_per_s": window_ticks * lanes / window_s,
          "window_batches_per_s": window_batches / window_s,
          "window_sgd_steps_per_s": MT_REPLAY_RATIO * window_batches / window_s,
          "learn_share": shares, "replay_occupancy": occupancy,
          "clip_frac": [r.get("clip_frac") for r in learn_rows],
          "device_idle_share": idle if idle is not None else "not measured",
          **kernel_fields(prof_rows),
          "profile_ticks": MT_PROFILE_TICKS, "peak_memory_allocated": peak,
          "launches": counts, "launches_per_batch": MT_PER_BATCH, "launches_per_act": MT_PER_ACT,
          "batch_launch_mismatches": rec["batch_launch_bad"][:3],
          "act_launch_mismatches": rec["act_launch_bad"][:3],
          "env_launch_mismatches": rec["env_launch_bad"][:3], "lane_resets": rec["resets"],
          "masked_actions_taken": rec["masked_taken"], "acts": rec["acts"],
          "eval": evals, "eval_hn_games": summary.get("eval_hn_games"),
          "rollbacks": summary["rollbacks"],
          "top": [{"name": k_[:80], "us_per_tick": t_ / MT_PROFILE_TICKS,
                   "calls_per_tick": c_ / MT_PROFILE_TICKS} for k_, t_, c_ in prof_rows[:12]]})
    check(summary["rollbacks"] == 0, "apex_mt rolled back")
    check(summary["learn_steps"] == MT_REPLAY_RATIO * rec["batches"],
          "apex_mt: the step counter does not advance K per sampled batch")
    check(rec["batches"] == max_frames // run.frames_per_learn,
          f"apex_mt: {rec['batches']} sampled batches, want {max_frames // run.frames_per_learn}")
    check(window_ticks >= MT_WINDOW_TICKS - 2 and window_batches > 0, "apex_mt: no window")
    check(not rec["batch_launch_bad"], f"apex_mt: launches per batch {rec['batch_launch_bad'][:1]}")
    check(not rec["act_launch_bad"], f"apex_mt: launches per act {rec['act_launch_bad'][:1]}")
    check(not rec["env_launch_bad"], f"apex_mt: K12 launches per env step {rec['env_launch_bad'][:1]}")
    check(rec["masked_taken"] == 0, f"apex_mt: {rec['masked_taken']} masked actions taken")
    check(len(shares) == spec.num_games and all(
        s is not None and abs(s - 1.0 / spec.num_games) <= 0.05 for s in shares.values()),
        f"apex_mt: per-game learn shares {shares}")
    check(set(evals) == set(spec.games), f"apex_mt: eval rows for {sorted(evals)}")
    check(all(MT_PER_BATCH.get(n, 0) == 0 or counts[n] > 0 for n in MT_KERNELS),
          "apex_mt: a multi-game kernel was never launched")
    return counts


def _mt_batch(torch, np, spec, cfg, rng, dev):
    """A synthetic full-width multi-game batch (8 rows a game, actions in
    each row's own game) on ``dev``."""
    from rainbow_iqn_apex_tpu_torch.ops.learn import Batch

    b = cfg.batch_size
    game = np.repeat(np.arange(spec.num_games, dtype=np.int32), b // spec.num_games)
    h, w = spec.frame_shape
    host = dict(
        obs=rng.integers(0, 256, (b, h, w, cfg.history_length), dtype=np.uint8),
        action=np.asarray([rng.integers(0, spec.num_actions[g]) for g in game], np.int32),
        reward=rng.normal(size=b).astype(np.float32),
        next_obs=rng.integers(0, 256, (b, h, w, cfg.history_length), dtype=np.uint8),
        discount=np.where(rng.random(b) < 0.1, 0.0, cfg.gamma ** cfg.multi_step).astype(np.float32),
        weight=rng.uniform(0.3, 1.0, b).astype(np.float32), game=game)
    return Batch(**{k: torch.from_numpy(v).to(dev) for k, v in host.items()})


def _reuse_parity(torch, cfg, card, plain, batch_card, batch_cpu, what):
    """One K-pass learn step on the card (kernels) and on the CPU (twins)
    from equal states, under the same draws; returns the comparison row."""
    from rainbow_iqn_apex_tpu_torch.ops.learn import build_learn_step, host_state, make_policy_logp

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(SEED + 93)
    passes, passes_card = [], []
    for _ in range(cfg.replay_ratio):
        d, dc = _learn_draws(torch, cfg, plain.net, g)
        passes.append(d)
        passes_card.append(dc)
    taus = torch.rand((cfg.batch_size, cfg.num_quantile_samples), generator=g)
    noise = plain.net.sample_noise(g)
    ratio = (taus, noise)
    ratio_card = (taus.to(dev), {k: (a.to(dev), b.to(dev)) for k, (a, b) in noise.items()})
    logp = make_policy_logp(cfg)
    lp_card = logp(card.net, batch_card, *ratio_card)
    lp_cpu = logp(plain.net, batch_cpu, *ratio)
    before = host_state(card)["params"]
    step = build_learn_step(cfg, card.net.num_actions)
    card, k_info = step(card, batch_card, draws={"ratio": ratio_card, "passes": passes_card})
    plain, p_info = step(plain, batch_cpu, draws={"ratio": ratio, "passes": passes})
    torch.cuda.synchronize()
    out = {"logp": float((lp_card.cpu() - lp_cpu).abs().max())}
    ok = bool(torch.all((lp_card.cpu() - lp_cpu).abs()
                        <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * lp_cpu.abs()))
    for key in ("loss", "priorities", "q_mean", "target_q_mean"):
        got, want = k_info[key].cpu().double(), p_info[key].double()
        err = (got - want).abs()
        out[key] = float(err.max())
        ok = ok and bool(torch.all(err <= LEARN_PATH_TOL["atol"] + LEARN_PATH_TOL["rtol"] * want.abs()))
    clip = [float(k_info["clip_frac"]), float(p_info["clip_frac"])]
    gn_rel = abs(k_info["grad_norm"].item() - p_info["grad_norm"].item()) / p_info["grad_norm"].item()
    after_k = {k: v.cpu() for k, v in card.net.state_dict().items()}
    after_p = plain.net.state_dict()
    worst, worst_name = 0.0, ""
    for k in before:
        dk, dp = after_k[k] - before[k], after_p[k] - before[k]
        rel = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, k
    row = {"what": what, "replay_ratio": cfg.replay_ratio, "max_abs_err": out,
           "clip_frac": clip, "grad_norm_rel_err": gn_rel, "update_rel_l2_worst": worst,
           "update_worst_tensor": worst_name, "step": [card.step, plain.step],
           "finite": [bool(k_info["finite"]), bool(p_info["finite"])], "tol": LEARN_PATH_TOL,
           "update_rtol": LEARN_UPDATE_RTOL}
    if "game_embed" in before:
        de_k, de_p = after_k["game_embed"] - before["game_embed"], after_p["game_embed"] - before["game_embed"]
        row["game_embed_update_rel_l2"] = float((de_k - de_p).norm() / de_p.norm().clamp_min(1e-30))
    check(ok, f"apex_mt_parity ({what}): {out}")
    check(clip[0] == clip[1], f"apex_mt_parity ({what}): clip_frac {clip}")
    check(gn_rel <= LEARN_GNORM_RTOL and worst <= LEARN_UPDATE_RTOL,
          f"apex_mt_parity ({what}): grad_norm {gn_rel}, update of {worst_name} {worst}")
    check(card.step == plain.step and all(row["finite"]), f"apex_mt_parity ({what}): steps or finite")
    return row


def phase_apex_mt_parity(torch, cfg):
    """One full-width multi-game learn step at replay_ratio 2 through the
    kernels on the card against the same step through the plain twins on
    the CPU (same state, batch and draws), with a row planted whose
    unmasked greedy a* is a pad slot; then one single-game K = 2 step
    (replay reuse without masks) the same way."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.multitask.ops import init_mt_train_state
    from rainbow_iqn_apex_tpu_torch.ops.learn import host_state, init_train_state, load_host_state

    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    spec = _mt_spec()
    mcfg = cfg.replace(games=MT_GAMES, replay_ratio=MT_REPLAY_RATIO, target_update_period=100)
    card = init_mt_train_state(mcfg, spec, cfg.seed)
    with torch.no_grad():  # a moved embedding, and a pad slot every game's greedy pass prefers
        card.net.game_embed.normal_(0.0, 0.05, generator=torch.Generator(device=dev).manual_seed(5))
        card.net.advantage_out.b_mu[spec.max_actions - 1] += 4.0
    host = host_state(card)
    plain = load_host_state(init_mt_train_state(mcfg, spec, cfg.seed, device="cpu"), host)
    rng = np.random.default_rng(SEED + 94)
    batch_card = _mt_batch(torch, np, spec, mcfg, rng, dev)
    batch_cpu = type(batch_card)(**{k: None if v is None else v.cpu()
                                    for k, v in vars(batch_card).items()})
    g = torch.Generator().manual_seed(SEED + 95)
    taus = torch.rand((mcfg.batch_size, mcfg.num_quantile_samples), generator=g)
    noise = plain.net.sample_noise(g)
    with torch.no_grad():
        out_k = card.net(batch_card.next_obs, mcfg.num_quantile_samples, taus=taus.to(dev),
                         noise={k: (a.to(dev), b.to(dev)) for k, (a, b) in noise.items()},
                         game=batch_card.game)
        out_p = plain.net(batch_cpu.next_obs, mcfg.num_quantile_samples, taus=taus, noise=noise,
                          game=batch_cpu.game)
    unmasked = out_p.quantiles.mean(dim=1).argmax(dim=-1)
    limit = torch.tensor(spec.num_actions)[batch_cpu.game.long()]
    planted = int(((unmasked == spec.max_actions - 1) & (limit < spec.max_actions)).sum())
    top2 = torch.sort(out_p.q, dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * PATH_Q_TOL
    a_star_equal = bool(torch.equal(out_k.action.cpu()[clear], out_p.action[clear]))
    inside = bool((out_k.action.cpu() < limit).all() and (out_p.action < limit).all())
    rows = [_reuse_parity(torch, mcfg, card, plain, batch_card, batch_cpu, "multi-game")]
    rows[0].update({"pad_rows_planted": planted, "a_star_equal_where_clear": a_star_equal,
                    "a_star_clear_rows": int(clear.sum()), "a_star_inside_game": inside})
    check(planted > 0, "apex_mt_parity: no row's unmasked a* is a pad slot")
    check(inside and a_star_equal, "apex_mt_parity: a* left its game or differs card vs CPU")

    scfg = cfg.replace(replay_ratio=MT_REPLAY_RATIO, target_update_period=100)
    card = init_train_state(scfg, 18, cfg.seed)
    host = host_state(card)
    plain = load_host_state(init_train_state(scfg, 18, cfg.seed, device="cpu"), host)
    rng = np.random.default_rng(SEED + 96)
    sspec = type(spec)(games=("x",), num_actions=(18,), frame_shape=(84, 84))
    batch_card = _mt_batch(torch, np, sspec, scfg, rng, dev)
    batch_card.game = None
    batch_cpu = type(batch_card)(**{k: None if v is None else v.cpu()
                                    for k, v in vars(batch_card).items()})
    rows.append(_reuse_parity(torch, scfg, card, plain, batch_card, batch_cpu, "single-game"))
    emit({"phase": "apex_mt_parity", "rows": rows})


def phase_train_apex_mt(torch):
    """On the card, the two JAX acceptance runs of multi-game Ape-X:
    tests/test_multitask.py's two-game toy run (:389-437) and
    tests/test_replay_reuse.py's reuse run (:284-302), each config field
    for field but bf16 (the card's path takes no other compute dtype), the
    reuse run at the test's 8 cosines, with those tests' own assertions (the JSONL lint of scripts/lint_jsonl.py
    against the port's schema: the script imports the JAX package's)."""
    import tempfile

    import numpy as np

    from rainbow_iqn_apex_tpu_torch.config import Config
    from rainbow_iqn_apex_tpu_torch.obs.schema import validate_row
    from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex

    work = tempfile.mkdtemp(prefix="train_apex_mt-")
    t0 = time.perf_counter()
    e2e = Config(
        compute_dtype="bfloat16", history_length=2, hidden_size=64, num_cosines=16,
        num_tau_samples=8, num_tau_prime_samples=8, num_quantile_samples=4, multi_step=3,
        gamma=0.9, games="toy:catch,toy:chain", batch_size=16, learning_rate=1e-3,
        memory_capacity=4096, learn_start=256, frames_per_learn=4, target_update_period=200,
        num_envs_per_actor=8, metrics_interval=50, eval_interval=0, checkpoint_interval=0,
        eval_episodes=2, run_id="mt_e2e", results_dir=os.path.join(work, "results"),
        checkpoint_dir=os.path.join(work, "ckpt"))
    summary = train_apex(e2e, max_frames=768)

    def lint(line):  # scripts/lint_jsonl.py's lint_line over the port's schema
        def non_finite(token):
            raise ValueError(f"non-finite JSON constant {token!r}")

        try:
            row = json.loads(line, parse_constant=non_finite)
        except ValueError as e:
            return str(e)
        if not isinstance(row, dict):
            return "not an object"
        errs = validate_row(row, require_known_kind=True) if "kind" in row else []
        return "; ".join(errs) or None

    lines = [line for line in open(os.path.join(e2e.results_dir, "mt_e2e", "metrics.jsonl"))
             if line.strip()]
    bad_rows = [err for err in map(lint, lines) if err is not None]
    rows = [json.loads(line) for line in lines]
    eval_games = {r["game"] for r in rows if r["kind"] == "eval" and r.get("game")}
    games_rows = [r for r in rows if r["kind"] == "games"]
    shares = ([g["learn_share"] for g in games_rows[-1]["games"].values()] if games_rows else [])
    mt_rows = [r for r in rows if r["kind"] == "eval_mt"]
    e2e_ok = (summary["frames"] == 768 and summary["learn_steps"] > 0
              and summary["eval_hn_games"] == 2 and np.isfinite(summary["eval_hn_median"])
              and not bad_rows and eval_games == {"toy:catch", "toy:chain"}
              and bool(games_rows) and set(games_rows[-1]["games"]) == eval_games
              and all(abs(s - 0.5) <= 0.05 for s in shares)
              and bool(mt_rows) and mt_rows[-1]["hn_median"] is not None)
    reuse = Config(
        env_id="toy:catch", compute_dtype="bfloat16", frame_height=44, frame_width=44,
        history_length=2, hidden_size=32, num_cosines=8, num_tau_samples=4,
        num_tau_prime_samples=4, num_quantile_samples=4, batch_size=16, learning_rate=1e-3,
        multi_step=3, gamma=0.9, memory_capacity=4096, learn_start=256, frames_per_learn=4,
        target_update_period=100, num_envs_per_actor=8, metrics_interval=50, eval_interval=0,
        checkpoint_interval=0, eval_episodes=2, stall_timeout_s=0.0, writeback_depth=2,
        replay_shards=1, weight_publish_interval=100, seed=3, run_id="reuse_mt",
        games="toy:catch,toy:chain", replay_ratio=2,
        results_dir=os.path.join(work, "reuse", "results"),
        checkpoint_dir=os.path.join(work, "reuse", "ckpt"))
    r_summary = train_apex(reuse, max_frames=768)
    r_rows = [json.loads(line) for line in open(os.path.join(reuse.results_dir, "reuse_mt",
                                                              "metrics.jsonl"))]
    r_learn = [r for r in r_rows if r["kind"] == "learn"]
    reuse_ok = (r_summary["rollbacks"] == 0
                and r_summary["learn_steps"] == 2 * (768 // reuse.frames_per_learn)
                and bool(r_learn) and all(r["replay_ratio"] == 2 for r in r_learn)
                and any(r["kind"] == "games" for r in r_rows))
    emit({"phase": "train_apex_mt", "runs": [
        {"test": "tests/test_multitask.py::test_two_game_apex_run_end_to_end", "ok": e2e_ok,
         "frames": summary["frames"], "learn_steps": summary["learn_steps"],
         "eval_hn_games": summary["eval_hn_games"], "eval_hn_median": summary["eval_hn_median"],
         "learn_shares": shares, "invalid_rows": bad_rows[:5]},
        {"test": "tests/test_replay_reuse.py::test_reuse_composes_with_multitask",
         "ok": reuse_ok, "learn_steps": r_summary["learn_steps"],
         "rollbacks": r_summary["rollbacks"]}],
        "compute_dtype": "bfloat16", "reuse_num_cosines": reuse.num_cosines,
        "seconds": time.perf_counter() - t0})
    check(e2e_ok, "train_apex_mt: the two-game acceptance run failed its assertions")
    check(reuse_ok, "train_apex_mt: the multi-game reuse run failed its assertions")


def kernel_fields(rows):
    """K3's, K3-bwd's, K2's, K2-bwd's, K9's and K9-bwd's device time among
    profile rows (name, us, calls): each share of the window's device time,
    and the window's total us.  The kernels are named k3_*
    (csrc/noisy_linear.cu), k3b_* (its backward), tau_embed_kernel and
    tau_embed_bwd_kernel (K2g's modes included), lstm_fwd_kernel and
    lstm_tick_kernel (K9), lstm_bwd_kernel (K9-bwd)."""
    busy = sum(t for _, t, _ in rows)
    fields = {}
    for name, match in (("k3", lambda k: "k3_wide_kernel" in k or "k3_narrow_kernel" in k),
                        ("k3_bwd", lambda k: "k3b_" in k),
                        ("k2", lambda k: "tau_embed_kernel" in k),
                        ("k2_bwd", lambda k: "tau_embed_bwd_kernel" in k),
                        ("k9", lambda k: "lstm_fwd_kernel" in k or "lstm_tick_kernel" in k),
                        ("k9_bwd", lambda k: "lstm_bwd_kernel" in k)):
        us = sum(t for k, t, _ in rows if match(k))
        fields[f"{name}_device_us"] = us
        fields[f"{name}_share_of_device"] = us / busy if busy else None
    return fields


def device_rows(torch, prof):
    """(name, device us, calls) of the device-side events: kernels and
    copies.  CPU-side op rows carry the same device time again, and user
    annotations (``Optimizer.step``) span kernels already counted, so both
    would count it twice."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def profile_dispatch(torch, engine, obs, dispatches=20):
    """Where the time of a bucket-64 ``infer`` goes: device time by kernel
    name from torch.profiler, and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    engine.infer(obs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            engine.infer(obs)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof)
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "profile", "bucket": len(obs), "dispatches": dispatches,
          "wall_us_per_dispatch": wall_us / dispatches,
          "device_us_per_dispatch": device_us / dispatches if rows else "not measured",
          "device_idle_share": 1.0 - device_us / wall_us if rows else "not measured",
          **kernel_fields(rows),
          "top": [{"name": k[:80], "us_per_dispatch": t / dispatches, "calls": c}
                  for k, t, c in rows[:10]]})


def phase_serve(torch, cfg):
    """The port's main path: PolicyServer at full width, 512 requests."""
    import numpy as np

    from rainbow_iqn_apex_tpu_torch.kernels import launches, reset_launches
    from rainbow_iqn_apex_tpu_torch.models import init_params
    from rainbow_iqn_apex_tpu_torch.ops import load_network
    from rainbow_iqn_apex_tpu_torch.serving import InferenceEngine, PolicyServer

    actions_n = 18
    params = init_params(cfg, actions_n, seed=SEED)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (REQUESTS, *cfg.state_shape), dtype=np.uint8)

    server = PolicyServer(cfg, actions_n, params)  # cuda:0 by default
    check(server.engine.device.type == "cuda", "server did not pick the card by default")
    reset_launches()
    t_start = time.perf_counter()
    server.start()  # warms every bucket
    warm_s = time.perf_counter() - t_start
    answers = [None] * REQUESTS
    latency_ms = [0.0] * REQUESTS
    failures = []

    def client(i):
        try:
            for r in range(i, REQUESTS, CLIENTS):
                t = time.perf_counter()
                answers[r] = server.act_values(frames[r], timeout=120)
                latency_ms[r] = (time.perf_counter() - t) * 1e3
        except Exception as e:  # recorded and failed below
            failures.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t0
    counts = dict(launches)  # the main path: start() + 512 requests
    check(not any(t.is_alive() for t in threads), "client threads did not finish")
    check(not failures, f"requests failed: {failures[:3]}")
    check(all(a is not None for a in answers), "a request got no answer")
    acts = np.array([a for a, _ in answers])
    qs = np.stack([q for _, q in answers])
    check(bool(np.all((acts >= 0) & (acts < actions_n))), "action out of range")
    check(qs.shape == (REQUESTS, actions_n) and bool(np.all(np.isfinite(qs))), "bad q values")
    for name in SERVE_KERNELS:
        check(counts[name] > 0, f"{name} was never launched on the serving path")
    for name in QUANT_KERNELS:
        check(counts[name] == 0, f"{name} launched on the serving path without serve_quantize")
    stats = server.stats()
    lat = np.sort(np.asarray(latency_ms))
    emit({"phase": "serve", "requests": REQUESTS, "clients": CLIENTS, "seconds": elapsed,
          "requests_per_s": REQUESTS / elapsed, "warmup_s": warm_s, "launches": counts,
          "request_p50_ms": float(lat[len(lat) // 2]),
          "request_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]),
          "request_max_ms": float(lat[-1]),
          "batches": stats["total_batches"], "batch_occupancy": stats["batch_occupancy_lifetime"],
          "total_shed": stats["total_shed"]})

    # per-bucket infer latency (host clock around engine.infer, which ends
    # in the device-to-host copy of the answers)
    engine = server.engine
    for bucket in engine.buckets:
        lat = []
        for r in range(40):
            t = time.perf_counter()
            engine.infer(frames[r * 8 % (REQUESTS - bucket):][:bucket])
            lat.append((time.perf_counter() - t) * 1e3)
        lat = sorted(lat[5:])
        emit({"phase": "serve_bucket", "bucket": bucket, "infer_p50_ms": lat[len(lat) // 2],
              "infer_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]})

    profile_dispatch(torch, engine, frames[:BUCKET])

    # kernel path (card) vs plain path (the same weights on the CPU)
    obs = torch.from_numpy(frames[:BUCKET])
    taus = torch.rand((BUCKET, cfg.num_quantile_samples), generator=torch.Generator().manual_seed(SEED))
    net_before = engine.params
    with torch.inference_mode():
        k_out = net_before(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda())
        cpu_net = load_network(cfg, actions_n, params, torch.device("cpu"), use_noise=False)
        p_out = cpu_net(obs, cfg.num_quantile_samples, taus=taus)
    max_abs = (k_out.quantiles.cpu() - p_out.quantiles).abs().max().item()
    q_err = (k_out.q.cpu() - p_out.q).abs().max().item()
    top2 = torch.sort(p_out.q, dim=-1).values[:, -2:]
    # where both q vectors are within PATH_Q_TOL, a gap above twice that
    # leaves only one possible argmax
    clear = (top2[:, 1] - top2[:, 0]) > 2 * PATH_Q_TOL
    same_actions = bool(torch.equal(k_out.action.cpu()[clear], p_out.action[clear]))
    emit({"phase": "serve_parity", "batch": BUCKET, "max_abs_err": max_abs, "tol": PATH_TOL,
          "q_max_abs_err": q_err, "q_tol": PATH_Q_TOL, "clear_rows": int(clear.sum()),
          "actions_agree": same_actions,
          "actions_equal_all_rows": bool(torch.equal(k_out.action.cpu(), p_out.action))})
    check(max_abs <= PATH_TOL, f"kernel path vs plain path: max abs {max_abs}")
    check(q_err <= PATH_Q_TOL, f"kernel path vs plain path: q max abs {q_err}")
    check(int(clear.sum()) > 0, "no row has a clear Q gap: the action check would be empty")
    check(same_actions, "greedy actions differ where the Q gap is clear")

    # noisy mode on the card: the kernel path against the plain path on the
    # CPU at the same taus and eps, then an engine that draws its own noise
    noisy_net = load_network(cfg, actions_n, params, engine.device, use_noise=True)
    cpu_noisy = load_network(cfg, actions_n, params, torch.device("cpu"), use_noise=True)
    noise = noisy_net.sample_noise(torch.Generator(device=engine.device).manual_seed(SEED))
    with torch.inference_mode():
        k_noisy = noisy_net(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda(), noise=noise)
        p_noisy = cpu_noisy(obs, cfg.num_quantile_samples, taus=taus,
                            noise={k: (a.cpu(), b.cpu()) for k, (a, b) in noise.items()})
    n_err = (k_noisy.quantiles.cpu() - p_noisy.quantiles).abs().max().item()
    nq_err = (k_noisy.q.cpu() - p_noisy.q).abs().max().item()
    noisy_engine = InferenceEngine(cfg, actions_n, params, mode="noisy")
    n_acts, n_qs = noisy_engine.infer(frames[:BUCKET])
    noisy_ok = bool(np.all((n_acts >= 0) & (n_acts < actions_n)) and np.all(np.isfinite(n_qs)))
    emit({"phase": "noisy", "batch": BUCKET, "max_abs_err": n_err, "tol": PATH_TOL,
          "q_max_abs_err": nq_err, "q_tol": PATH_Q_TOL,
          "differs_from_greedy": not torch.equal(k_noisy.q, k_out.q), "engine_ok": noisy_ok})
    check(n_err <= PATH_TOL and nq_err <= PATH_Q_TOL,
          f"noisy kernel path vs plain path: max abs {n_err}, q {nq_err}")
    check(not torch.equal(k_noisy.q, k_out.q), "noise changed nothing")
    check(noisy_ok, "the noisy engine gave an action out of range or a non-finite q")

    # hot swap: new weights, new version, new answers
    version = server.load_params(init_params(cfg, actions_n, seed=SEED + 1))
    check(version == 1, f"params_version {version} after the first swap")
    with torch.inference_mode():
        k_after = engine.params(obs.cuda(), cfg.num_quantile_samples, taus=taus.cuda())
    changed = not torch.equal(k_after.q, k_out.q)
    a, q = server.act_values(frames[0], timeout=120)
    check(changed and 0 <= a < actions_n and np.all(np.isfinite(q)), "hot swap did not take")

    # stop() drains what is queued
    futures = [server.submit(frames[r]) for r in range(BUCKET)]
    final = server.stop(drain=True)
    drained = all(f.done() for f in futures) and all(
        0 <= f.result(timeout=0)[0] < actions_n for f in futures)
    emit({"phase": "swap_and_stop", "params_version": version, "answers_changed": changed,
          "drained": drained, "total_requests": final.get("total_requests")})
    check(drained, "stop() did not drain the queue")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "rainbow_iqn_apex_tpu_torch")):
        print("chip_smoke: the port (rainbow_iqn_apex_tpu_torch/) is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from rainbow_iqn_apex_tpu_torch.config import Config
        from rainbow_iqn_apex_tpu_torch.kernels import (
            build,
            device_games,
            dueling_head,
            dequantize,
            frontier_draw,
            frontier_writeback,
            noisy_linear,
            noisy_linear_q,
            quantile_huber,
            quantize,
            replay_append,
            replay_assemble,
            replay_draw,
            lstm,
            r2d2_td,
            replay_writeback,
            seq_append,
            seq_assemble,
            seq_draw,
            seq_stack,
            seq_writeback,
            tau_embed,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # deterministic cuDNN algorithms: the port's kernels use no atomics,
        # so a rerun of the `train` phase on the same card repeats its result
        torch.backends.cudnn.deterministic = True
        smi = nvidia_smi_line()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "cudnn_deterministic": torch.backends.cudnn.deterministic})

        t0 = time.perf_counter()
        build.library()
        ptxas = [line.strip() for out in build.build_log for line in out.splitlines()
                 if "registers" in line or "spill" in line or "error" in line]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": os.path.relpath(build.library_path(), ROOT), "ptxas": ptxas})

        results, counts = {}, {"serve": {}, "learn": {}, "anakin": {}, "apex": {},
                               "serve_quant": {}, "apex_quant": {}, "learn_r2d2": {},
                               "anakin_r2d2": {}, "anakin_fused": {}, "apex_mt": {}}
        with open(os.path.join(ROOT, "configs", "serve_defaults.json")) as f:
            serve_cfg = Config.from_json(f.read())
        with open(os.path.join(ROOT, "configs", "reference_atari_defaults.json")) as f:
            learn_cfg = Config.from_json(f.read())
        by_phase = {}

        def timed(name, fn, *args):
            t_phase = time.perf_counter()
            out = fn(*args)
            by_phase[name] = time.perf_counter() - t_phase
            return out

        results.update(timed("kernels", phase_kernels, torch, serve_cfg))
        counts["serve"] = timed("serve", phase_serve, torch, serve_cfg)
        results.update(timed("kernels_learn", phase_kernels_learn, torch, learn_cfg))
        results["K4_dueling_head"]["heads"] = results.pop("K4_dueling_head_heads")
        counts["learn"] = timed("learn", phase_learn, torch, learn_cfg)
        timed("learn_parity", phase_learn_parity, torch, learn_cfg)
        timed("train", phase_train, torch)
        results.update(timed("kernels_replay", phase_kernels_replay, torch, learn_cfg))
        counts["anakin"] = timed("anakin", phase_anakin, torch, learn_cfg)
        timed("anakin_parity", phase_anakin_parity, torch, learn_cfg)
        timed("train_anakin", phase_train_anakin, torch)
        results.update(timed("kernels_frontier", phase_kernels_frontier, torch, learn_cfg))
        counts["apex"], apex_ctx = timed("apex", phase_apex, torch, learn_cfg)
        results.update(timed("kernels_quant", phase_kernels_quant, torch, serve_cfg))
        counts["apex_quant"] = timed("apex_quant", phase_apex_quant, torch, learn_cfg, apex_ctx)
        del apex_ctx
        counts["serve_quant"] = timed("serve_quant", phase_serve_quant, torch, serve_cfg)
        timed("apex_parity", phase_apex_parity, torch, learn_cfg)
        timed("train_apex", phase_train_apex, torch)
        timed("train_apex_quant", phase_train_apex_quant, torch)
        r2d2_results, k6s_fold = timed("kernels_r2d2", phase_kernels_r2d2, torch, learn_cfg)
        results.update(r2d2_results)
        counts["learn_r2d2"], r2d2_ctx = timed("learn_r2d2", phase_learn_r2d2, torch, learn_cfg)
        timed("r2d2_parity", phase_r2d2_parity, torch, learn_cfg, r2d2_ctx)
        del r2d2_ctx
        timed("train_r2d2", phase_train_r2d2, torch)
        results.update(timed("kernels_r2d2_anakin", phase_kernels_r2d2_anakin, torch, learn_cfg))
        results["K6s_seq_writeback"]["folded"] = k6s_fold
        counts["anakin_r2d2"] = timed("anakin_r2d2", phase_anakin_r2d2, torch, learn_cfg)
        timed("anakin_r2d2_parity", phase_anakin_r2d2_parity, torch, learn_cfg)
        timed("train_anakin_r2d2", phase_train_anakin_r2d2, torch)
        results.update(timed("kernels_games", phase_kernels_games, torch))
        counts["anakin_fused"] = timed("anakin_fused", phase_anakin_fused, torch, learn_cfg)
        timed("anakin_fused_parity", phase_anakin_fused_parity, torch, learn_cfg)
        timed("train_anakin_fused", phase_train_anakin_fused, torch)
        results.update(timed("kernels_mt", phase_kernels_mt, torch, learn_cfg))
        counts["apex_mt"] = timed("apex_mt", phase_apex_mt, torch, learn_cfg)
        timed("apex_mt_parity", phase_apex_mt_parity, torch, learn_cfg)
        timed("train_apex_mt", phase_train_apex_mt, torch)
    except SmokeFailure as e:
        emit({"ok": False, "error": str(e)})
        return 1

    rows = {}
    for mod in (tau_embed, noisy_linear, dueling_head, quantile_huber, replay_draw,
                replay_writeback, replay_append, replay_assemble, frontier_draw,
                frontier_writeback, quantize, noisy_linear_q, dequantize, lstm, r2d2_td,
                seq_stack, seq_append, seq_draw, seq_assemble, seq_writeback, device_games):
        rows[mod.NAME] = (mod.SOURCE, mod.REPLACES)
        if hasattr(mod, "NAME_BWD"):
            rows[mod.NAME_BWD] = (mod.SOURCE_BWD, mod.REPLACES_BWD)
    # the multi-game modes of K2 and K4, each counted under its own name
    rows[tau_embed.NAME_GAME] = (tau_embed.SOURCE, tau_embed.REPLACES_GAME)
    rows[tau_embed.NAME_GAME_BWD] = (tau_embed.SOURCE_BWD, tau_embed.REPLACES_GAME)
    rows[dueling_head.NAME_MASK] = (dueling_head.SOURCE, dueling_head.REPLACES_MASK)
    rows[dueling_head.NAME_LOGP] = (dueling_head.SOURCE, dueling_head.REPLACES_LOGP)
    line = []
    for name, res in results.items():
        by_path = {path: c.get(name, 0) for path, c in counts.items()}
        # K6 and K6f run mostly inside another kernel's launch (build.FOLDED_INTO):
        # their launches count those runs beside their own launches
        folds = {path: c.get(f"folded:{name}", 0) for path, c in counts.items()}
        fold = ({"launches_own": sum(by_path.values()), "launches_folded_by_path": folds,
                 "folded_into": build.FOLDED_INTO[name]} if name in build.FOLDED_INTO else {})
        line.append({"name": name, "route": "cuda", "source": rows[name][0],
                     "replaces": rows[name][1],
                     "launches": sum(by_path.values()) + sum(folds.values()),
                     "launches_by_path": by_path, **fold,
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                     **{key: res[key] for key in ("heads", "one_lane_step", "per_sample",
                                                  "scaled", "chain", "dz", "folded",
                                                  "cluster", "prologue")
                        if key in res}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_script,
          "seconds_by_phase": by_phase})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
