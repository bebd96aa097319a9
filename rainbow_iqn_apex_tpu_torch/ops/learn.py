"""The learner step of the port: double-Q IQN loss, Adam, hard target copy.

Counterpart of ``rainbow_iqn_apex_tpu/ops/learn.py``: three noisy forwards
(the online net on s' at K taus for the double-Q a*, the target net on s'
at N' taus, the online net on s at N taus), the
quantile-Huber loss (K1) with the IS-weighted mean, the gradient through
the online pass only, optax-style global-norm clipping, Adam, and the hard
target copy every ``target_update_period`` steps.

On CUDA every step after the convolutions is one of the port's kernels:
K2/K3 forward for each of the three heads, then one launch of K4's heads
mode for all three (a*, the gathers and td_target), K1 with the IS-weighted
mean, and the backward K4-bwd (from the loss's cotangent), K3-bwd, K2-bwd
(``kernels/learn_loss.py`` chains K4, K1 and K4-bwd); the convolutions'
backward is cuDNN's, Adam is
``torch.optim.Adam(fused=True)``.  A multi-game batch (``Batch.game``, on a
``multitask.MultiGameIQN`` state) runs K2g and K2g-bwd in place of K2 and
K2-bwd, and the heads launch masks the a* head (counted as K4m).

``replay_ratio`` K > 1 (``make_reuse_learn_step``, IMPACT-style clipped
reuse): one sampled batch drives K passes of the step; passes 2..K scale the
IS weights by clip(pi_now / pi_behaviour, 1/c, c), the policy being
softmax of the tau-mean q at the taken action (``make_policy_logp``, K4l).
JAX fuses the K passes into one executable with ``fori_loop``; here they are
a host loop over the same pass.

TF32 is a process-wide setting of torch and is left to the entry point
(``Agent`` turns it off on CUDA), so that this module changes no global
state.

Differences of form from the JAX step, none of them of value:
- ``TrainState`` holds live modules and the optimizer and is updated in
  place (the JAX step donates its state); ``step`` is a host int, so the
  target-copy schedule reads no device value.
- Randomness: one ``torch.Generator`` on the learner's device draws, in
  order, the taus and per-layer noise of the select, target and online
  forwards.  ``draws=`` injects any of them (tests), as ``taus=`` and
  ``noise=`` do for the model.
- ``info`` stays on the device: no ``.item()`` inside the step.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from rainbow_iqn_apex_tpu_torch.config import Config
from rainbow_iqn_apex_tpu_torch.kernels.learn_loss import learn_loss
from rainbow_iqn_apex_tpu_torch.kernels.replay_writeback import Writeback
from rainbow_iqn_apex_tpu_torch.models.init import init_network_, make_network
from rainbow_iqn_apex_tpu_torch.models.iqn import RainbowIQN
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device

Draws = Dict[str, Tuple[Optional[torch.Tensor], Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]]]


@dataclasses.dataclass
class Batch:
    """One dense learner batch, on the learner's device."""

    obs: torch.Tensor  # [B, H, W, C] uint8
    action: torch.Tensor  # [B] int32
    reward: torch.Tensor  # [B] f32 — n-step discounted return
    next_obs: torch.Tensor  # [B, H, W, C] uint8
    discount: torch.Tensor  # [B] f32 — gamma^n * (1 - done)
    weight: torch.Tensor  # [B] f32 — PER importance-sampling weights
    game: Optional[torch.Tensor] = None  # [B] int32 game ids: multi-game runs only
    idx: Optional[torch.Tensor] = None  # [B] int32 slot ids (device sampling's write-back)


@dataclasses.dataclass
class TrainState:
    net: RainbowIQN  # online network: the fp32 parameters Adam updates
    target: RainbowIQN  # target network (no gradients)
    optimizer: torch.optim.Adam
    step: int = 0  # learner steps taken


def check_supported(cfg: Config) -> None:
    """Raise for what the port's learner does not run yet (ROADMAP.md)."""
    if cfg.architecture != "iqn":
        raise NotImplementedError(
            f"architecture={cfg.architecture!r}: only 'iqn' is ported to the PyTorch package")


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam as optax.adam builds it (b1 0.9, b2 0.999, eps added outside the
    square root); the global-norm clip runs before it, in the learn step."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=cfg.adam_eps, fused=True)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every element of every tensor), on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: scale by max_norm / g_norm only
    when g_norm > max_norm (not ``clip_grad_norm_``'s max_norm / (norm +
    1e-6)).  Returns the norm before clipping.  No host sync."""
    g_norm = global_norm(grads)
    if max_norm > 0:
        scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
        torch._foreach_mul_(list(grads), scale)
    return g_norm


def init_train_state(cfg: Config, num_actions: int, seed: int,
                     state_shape: Optional[Tuple[int, int, int]] = None,
                     device: DeviceLike = None) -> TrainState:
    """Fresh TrainState on ``device`` (``cuda:0`` unless named): params from
    ``seed`` with the JAX model's distributions, target = a copy, Adam
    moments zero.  ``state_shape`` defaults to ``cfg.state_shape``."""
    check_supported(cfg)
    device = resolve_device(device)
    net = make_network(cfg, num_actions, use_noise=True, state_shape=state_shape)
    init_network_(net, torch.Generator().manual_seed(int(seed)))
    net.to(device)
    target = copy.deepcopy(net).requires_grad_(False)
    return TrainState(net=net, target=target, optimizer=make_optimizer(cfg, net.parameters()))


# ----------------------------------------------------------- host copies
def host_state(state: TrainState) -> Dict[str, Any]:
    """A host (CPU) copy of the whole state: params, target params, the Adam
    moments and count, the step.  Blocks until the device values are ready
    (callers wrap it in ``hostsync.sanctioned()``)."""
    names = {p: n for n, p in state.net.named_parameters()}
    mu, nu, count = {}, {}, 0
    for p, st in state.optimizer.state.items():
        if "exp_avg" in st:
            mu[names[p]] = st["exp_avg"].detach().cpu().clone()
            nu[names[p]] = st["exp_avg_sq"].detach().cpu().clone()
            count = int(st["step"].item()) if torch.is_tensor(st["step"]) else int(st["step"])
    return {
        "params": {k: v.detach().cpu().clone() for k, v in state.net.state_dict().items()},
        "target_params": {k: v.detach().cpu().clone()
                          for k, v in state.target.state_dict().items()},
        "adam": {"mu": mu, "nu": nu, "count": count},
        "step": int(state.step),
    }


def load_host_state(state: TrainState, host: Mapping[str, Any]) -> TrainState:
    """Overwrite ``state`` in place from a ``host_state`` dict (rollback,
    resume, conversion from the JAX package).  Empty Adam moments leave the
    optimizer fresh."""
    with torch.no_grad():
        state.net.load_state_dict(host["params"])
        state.target.load_state_dict(host["target_params"])
    opt = state.optimizer
    opt.state.clear()
    adam = host.get("adam") or {}
    if adam.get("mu"):
        for name, p in state.net.named_parameters():
            opt.state[p] = {
                "step": torch.tensor(float(adam["count"]), dtype=torch.float32, device=p.device),
                # in the parameter's layout: the fused Adam reads them as it
                "exp_avg": adam["mu"][name].to(p.device, torch.float32).contiguous().clone(),
                "exp_avg_sq": adam["nu"][name].to(p.device, torch.float32).contiguous().clone(),
            }
    state.step = int(host["step"])
    return state


# ------------------------------------------------------------ the step
def loss_and_priorities(cfg: Config, state: TrainState, batch: Batch,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Draws] = None,
                        weight_scale: Optional[torch.Tensor] = None,
                        writeback: Optional[Writeback] = None,
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Quantile-Huber loss (IS-weighted mean) + diagnostics; the graph runs
    through the online pass on s only.  ``weight_scale`` [B] multiplies the
    IS weights (the clipped reuse ratio of passes 2..K).  ``writeback``: the
    device ring the priorities go to, written by K1's launch (K6 folded in)."""
    draws = draws or {}
    sel_taus, sel_noise = draws.get("select", (None, None))
    tgt_taus, tgt_noise = draws.get("target", (None, None))
    on_taus, on_noise = draws.get("online", (None, None))
    game = batch.game
    net = state.net
    with torch.no_grad():
        # double-Q action selection: the online net on s' (K taus) picks a*,
        # masked to each row's own game in a multi-game run
        select = (*net.heads(batch.next_obs, cfg.num_quantile_samples, taus=sel_taus,
                             generator=generator, noise=sel_noise, game=game)[:2],
                  cfg.num_quantile_samples)
        # target distribution: the target net on s' at a*, N' taus
        target = (*state.target.heads(batch.next_obs, cfg.num_tau_prime_samples, taus=tgt_taus,
                                      generator=generator, noise=tgt_noise, game=game)[:2],
                  cfg.num_tau_prime_samples)
    # online distribution at the taken action, N taus
    on_value, on_adv, taus = net.heads(batch.obs, cfg.num_tau_samples, taus=on_taus,
                                       generator=generator, noise=on_noise, game=game)
    # K4's heads mode (a*, z_next, td_target, z_online and on_q in one
    # launch), then K1's weighted mode (with the write-back, if given);
    # backward, K4-bwd's loss mode
    loss, per_sample, td_abs, on_q, z_next = learn_loss(
        (on_value, on_adv, cfg.num_tau_samples), batch.action, select, target, batch.reward,
        batch.discount, taus, batch.weight, weight_scale, cfg.kappa,
        *(net.mask_args(game) if game is not None else (None, None)), writeback=writeback)
    aux = {
        "td_abs": td_abs,
        "loss_per_sample": per_sample,
        "q_mean": on_q.mean(),
        "target_q_mean": z_next.mean(),
    }
    return loss, aux


def make_policy_logp(cfg: Config):
    """``logp(net, batch, taus, noise) -> [B]``: the detached log-prob of
    each row's taken action under softmax of the tau-mean q at K =
    ``cfg.num_quantile_samples`` taus (K4l; masked to each row's game on a
    multi-game network), the value-based stand-in for IMPACT's pi(a|s).
    Callers hand every call of one reuse step the same taus and noise, so two
    calls with equal parameters give bitwise equal log-probs."""

    def logp(net, batch: Batch, taus: torch.Tensor, noise) -> torch.Tensor:
        return net.logp(batch.obs, cfg.num_quantile_samples, batch.action, taus=taus,
                        noise=noise, game=batch.game)

    return logp


def make_reuse_learn_step(cfg: Config, pass_fn, logp_fn):
    """Replay ratio K > 1: one call runs K passes of ``pass_fn`` on the same
    batch (``rainbow_iqn_apex_tpu/ops/learn.py`` ``make_reuse_learn_step``).

    The behaviour log-probs come from the state before pass 1, under one
    draw of taus and noise (``draws["ratio"]``, else from the generator
    first) that every logp call of the step shares.  Pass 1 is the plain
    step; passes 2..K scale the IS weights by clip(exp(logp_now -
    logp_behaviour), 1/c, c), c = ``cfg.reuse_clip``.  ``info`` is the last
    pass's (its priorities are the write-back's) with ``finite`` the AND of
    every pass's, ``clip_frac`` the mean share of clipped rows over passes
    2..K, and the host ints ``replay_ratio`` = K and ``reuse_index`` = K - 1.
    ``state.step`` advances K.  ``draws["passes"]`` (K learn-step draws)
    replaces the passes' draws."""
    reuse_k = int(cfg.replay_ratio)
    clip_c = float(cfg.reuse_clip)

    def learn_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Any]] = None,
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        draws = draws or {}
        ratio_taus, ratio_noise = draws.get("ratio", (None, None))
        if ratio_taus is None:
            ratio_taus = torch.rand((batch.obs.shape[0], cfg.num_quantile_samples),
                                    generator=generator, device=batch.obs.device)
        if ratio_noise is None and state.net.use_noise:
            ratio_noise = state.net.sample_noise(generator)
        passes = draws.get("passes") or [None] * reuse_k
        behav = logp_fn(state.net, batch, ratio_taus, ratio_noise)
        state, info = pass_fn(state, batch, generator, passes[0])
        finite, clip_sum = info["finite"], None
        for p in range(1, reuse_k):
            ratio = torch.exp(logp_fn(state.net, batch, ratio_taus, ratio_noise) - behav)
            clipped = torch.clamp(ratio, 1.0 / clip_c, clip_c)
            frac = (ratio != clipped).float().mean()
            clip_sum = frac if clip_sum is None else clip_sum + frac
            state, info = pass_fn(state, batch, generator, passes[p], clipped)
            finite = finite & info["finite"]
        info = dict(info)
        info["finite"] = finite
        info["clip_frac"] = clip_sum / max(reuse_k - 1, 1)
        info["replay_ratio"] = reuse_k
        info["reuse_index"] = reuse_k - 1
        return state, info

    return learn_step


def build_learn_step(cfg: Config, num_actions: int):
    """The learn step ``(state, batch, generator=None, draws=None) -> (state,
    info)``; ``state`` is updated in place and returned.  ``replay_ratio``
    K > 1 wraps it in ``make_reuse_learn_step``.  The plain step also takes
    ``writeback=``, a ``Writeback`` target that K1's launch writes the
    step's priorities into (``info["priorities"]`` is returned all the
    same)."""
    check_supported(cfg)
    del num_actions  # the state's networks carry it

    def learn_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None,
                   weight_scale: Optional[torch.Tensor] = None,
                   writeback: Optional[Writeback] = None,
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = list(state.net.parameters())
        loss, aux = loss_and_priorities(cfg, state, batch, generator, draws, weight_scale,
                                        writeback)
        # the conv weights' gradients come back channels-last; the fused
        # Adam reads each gradient in its parameter's (contiguous) layout
        grads = [g.contiguous() for g in torch.autograd.grad(loss, params)]
        grad_norm = clip_by_global_norm_(grads, cfg.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
        for p in params:
            p.grad = None
        # hard target copy on schedule, keyed on the host step counter
        state.step += 1
        if state.step % cfg.target_update_period == 0:
            with torch.no_grad():
                torch._foreach_copy_(list(state.target.parameters()), params)
        loss = loss.detach()
        info = {
            "loss": loss,
            "priorities": aux["td_abs"],
            "q_mean": aux["q_mean"],
            "target_q_mean": aux["target_q_mean"],
            "grad_norm": grad_norm,
            # the NaN/Inf guard, read at write-back ring retirement
            "finite": torch.isfinite(loss) & torch.isfinite(grad_norm),
        }
        return state, info

    if int(cfg.replay_ratio) <= 1:
        return learn_step
    return make_reuse_learn_step(cfg, learn_step, make_policy_logp(cfg))
