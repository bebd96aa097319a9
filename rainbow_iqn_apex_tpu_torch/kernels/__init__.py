"""The port's hand-written Hopper kernels (CUDA C++ in ``csrc/``).

Each kernel module holds the ctypes wrapper, which launches the kernel for
CUDA tensors and raises on what the kernel does not take, and the plain
PyTorch twin of the same function, which the wrapper runs for CPU tensors
and which tests and ``chip_smoke.py`` hold the kernel against.

    K1  quantile_huber.quantile_huber          quantile-Huber loss and its gradient
        quantile_huber.quantile_huber_weighted   the same with the learn step's IS-weighted mean
    K2  tau_embed.tau_embed                    cos-tau embedding, ReLU, Hadamard with phi
        tau_embed.tau_embed_bwd                its backward
    K3  noisy_linear.noisy_linear              factorised NoisyLinear GEMM (+ReLU)
        noisy_linear.noisy_linear_bwd          its backward
    K4  dueling_head.dueling_head              dueling combine, tau-mean, greedy argmax
        dueling_head.dueling_gather            the combine gathered at given actions
        dueling_head.dueling_gather_bwd        its backward
        dueling_head.dueling_loss_bwd          its backward from the weighted mean loss's cotangent
        dueling_head.dueling_learn             a learn step's three heads in one launch (a*,
                                               the gathers, td_target)
    K2g tau_embed.tau_embed(game=, emb=)       K2 with the multi-game embedding phi + E[game]
        tau_embed.tau_embed_bwd(game=, emb=)   its backward, with dE
    K4m dueling_head.dueling_head(game=, mask=)  K4 with the per-game action mask
    K4l dueling_head.dueling_logp              log-softmax of the (masked) q at taken actions
    K5  replay_draw.replay_draw                stratified proportional PER draw
    K6  replay_writeback.replay_writeback      fenced priority write-back (folded into K1's
                                               weighted mode in the fused Anakin step)
    K7  replay_append.replay_append            one append tick into the replay ring
    K8  replay_assemble.replay_assemble        n-step assembly, stack gathers, IS weights
    K5f frontier_draw.frontier_draw            the sample frontier's draw with IS weights
    K6f frontier_writeback.frontier_apply      the sample frontier's queue of staged appends and
                                               fenced write-backs (folded into K5f's draw)
    K10q quantize.quantize                     int8 / fp8 quantization of every parameter
    K10g noisy_linear_q.noisy_linear_q         K3 on int8 / fp8 weights, dequantized in the tile load
    K10d dequantize.dequantize                 the conv and embedding weights of the quantized path
    K9  lstm.lstm_forward                      R2D2's resettable LSTM recurrence (one launch per unroll)
        lstm.lstm_backward                     its backward through time
    K11 r2d2_td.r2d2_td                        R2D2's n-step TD, value rescale, masked Huber, priorities
                                               (with K6s folded in on the R2D2 Anakin step)
    K8s seq_stack.seq_stack                    R2D2's in-sequence frame stack
    K7s seq_append.seq_append                  one append tick into R2D2's device sequence ring
        seq_append.act_prologue                the R2D2 act tick's prologue: the append, the
                                               frame-stack shift and pre = lstm * keep
    K5s seq_draw.seq_draw                      the sequence ring's draw over its effective priorities
    K8s seq_assemble.seq_assemble              the sequence ring's gather and IS weights
    K6s seq_writeback.seq_writeback            the sequence ring's priority write-back (unfenced K6;
                                               folded into K11 on the R2D2 Anakin step)
    K12 device_games.game_tick                 the device games' auto-reset tick (JAX's Threefry stream)
        device_games.game_init / game_step / game_render   its init, reset-free step and render modes

Each backward has a ``torch.autograd.Function`` beside it in the same
module (``TauEmbedFn``, ``NoisyLinearFn``, ``DuelingGatherFn``,
``QuantileHuberFn``, ``LSTMFn``, ``R2D2TDFn``), which the models and the
learners call; ``learn_loss.LearnLossFn`` chains K4's heads mode, K1's
weighted mode and K4-bwd's loss mode for the IQN learn step.

``launches`` counts kernel launches by name, ``folded`` the runs of K6, K6f
and K6s folded into K1's, K5f's and K11's launches; ``reset_launches``
zeroes both.
"""

from rainbow_iqn_apex_tpu_torch.kernels.build import folded, launches, reset_launches

__all__ = ["folded", "launches", "reset_launches"]
