"""Single-process Rainbow-IQN training loop of the port (``--role single``).

Counterpart of ``rainbow_iqn_apex_tpu/train.py`` ``train`` (:53-311), line
for line: act and learn interleaved at ``frames_per_learn`` env frames per
learner step, the scheduled target copy (in the learn step), the NaN/Inf
guard with rollback, checkpoints, JSONL metrics and periodic eval, with the
priority write-back pipelined through the depth-K ring so the learn loop
issues no blocking device->host read per step.

``--role anakin`` (``architecture='iqn'``) runs ``train_anakin.train_anakin``
instead: the learner with its replay on the device.  ``--role apex`` runs
``parallel.apex.train_apex``: Ape-X on one card, the replay sampled on the
host or, with ``--device-sampling``, through the device sample frontier.
``--architecture r2d2`` with ``--role single`` runs
``train_r2d2.train_r2d2``: the recurrent learner on sequence replay; with
``--role anakin`` it runs ``train_anakin_r2d2.train_anakin_r2d2``: that
learner with its sequence replay on the device, the envs on the host.

``replay_ratio`` K > 1 (``--role single`` and ``--role apex``) drives K
learn passes per sampled batch (``ops.learn.make_reuse_learn_step``);
``games`` (``--role apex`` only) runs the multi-game Ape-X loop.

Not ported (each raises NotImplementedError; ROADMAP.md lists them):
league membership (``league_dir``), ``obs_net``, ``trace_dir`` device
traces, ``architecture='r2d2'`` with ``--role apex``, and every role other
than ``single``, ``anakin`` and ``apex``.

Run it as ``python -m rainbow_iqn_apex_tpu_torch.train --env-id toy:catch``
(any Config field is a ``--flag``; ``--device cpu`` runs on the CPU, the
default is ``cuda:0``).  The last line printed is the JSON summary.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

from rainbow_iqn_apex_tpu_torch.agents.agent import Agent, FrameStacker
from rainbow_iqn_apex_tpu_torch.config import Config, parse_config
from rainbow_iqn_apex_tpu_torch.envs import make_vector_env
from rainbow_iqn_apex_tpu_torch.eval import evaluate
from rainbow_iqn_apex_tpu_torch.obs import RunObs
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import check_supported, host_state
from rainbow_iqn_apex_tpu_torch.parallel.supervisor import TrainSupervisor
from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay
from rainbow_iqn_apex_tpu_torch.utils import faults
from rainbow_iqn_apex_tpu_torch.utils.checkpoint import (
    Checkpointer,
    maybe_restore_replay,
    maybe_resume,
    rng_extra,
    rng_from_extra,
)
from rainbow_iqn_apex_tpu_torch.utils.logging import MetricsLogger
from rainbow_iqn_apex_tpu_torch.utils.prefetch import (
    BatchPrefetcher,
    make_replay_prefetcher,
)
from rainbow_iqn_apex_tpu_torch.utils.writeback import (
    RingCommitter,
    WritebackRing,
    cadence_hit,
    check_reuse_cadences,
    pipeline_gauges,
    reuse_health,
    reuse_learn_row,
)


def priority_beta(cfg: Config, frames: int) -> float:
    """Linear beta_0 -> 1 anneal of the IS exponent over the training budget."""
    frac = min(frames / max(cfg.t_max, 1), 1.0)
    return cfg.priority_weight + (1.0 - cfg.priority_weight) * frac


def check_single_role(cfg: Config) -> None:
    """Raise for the parts of the JAX loop the port does not run yet."""
    check_supported(cfg)
    if cfg.role != "single":
        raise NotImplementedError(
            f"role={cfg.role!r}: only 'single' (train), 'anakin' "
            "(train_anakin.train_anakin) and 'apex' (parallel.apex.train_apex) are ported yet")
    if cfg.league_dir or cfg.league_member_id >= 0:
        raise NotImplementedError("league membership (league_dir) is not ported yet")
    if cfg.games:
        raise NotImplementedError(
            "multi-game runs (games) are ported for --role apex only")


def train(cfg: Config, max_frames: Optional[int] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Runs training on ``device`` (``cuda:0`` unless named); returns a
    summary dict (final eval, steps, fault counts).  ``--role anakin`` goes
    to ``train_anakin.train_anakin``, ``--role apex`` to
    ``parallel.apex.train_apex``, ``--architecture r2d2`` to
    ``train_r2d2.train_r2d2`` (``--role anakin``:
    ``train_anakin_r2d2.train_anakin_r2d2``)."""
    if cfg.architecture == "r2d2":
        if cfg.role == "anakin":
            from rainbow_iqn_apex_tpu_torch.train_anakin_r2d2 import train_anakin_r2d2

            return train_anakin_r2d2(cfg, max_frames=max_frames, device=device)
        if cfg.role != "single":
            raise NotImplementedError(
                f"architecture='r2d2' with role={cfg.role!r}: only roles 'single' and "
                "'anakin' are ported (ROADMAP.md queue A item 6, R2D2 apex)")
        from rainbow_iqn_apex_tpu_torch.train_r2d2 import train_r2d2

        return train_r2d2(cfg, max_frames=max_frames, device=device)
    if cfg.role == "anakin":
        from rainbow_iqn_apex_tpu_torch.train_anakin import train_anakin

        return train_anakin(cfg, max_frames=max_frames, device=device)
    if cfg.role == "apex":
        from rainbow_iqn_apex_tpu_torch.parallel.apex import train_apex

        return train_apex(cfg, max_frames=max_frames, device=device)
    check_single_role(cfg)
    device = resolve_device(device)
    total_frames = max_frames or cfg.t_max
    lanes = cfg.num_envs_per_actor
    env = make_vector_env(cfg.env_id, lanes, seed=cfg.seed, device=device)

    agent = Agent(cfg, env.num_actions, cfg.seed,
                  state_shape=(*env.frame_shape, cfg.history_length), device=device)
    memory = PrioritizedReplay(
        cfg.memory_capacity,
        env.frame_shape,
        history=cfg.history_length,
        n_step=cfg.multi_step,
        gamma=cfg.gamma,
        lanes=lanes,
        priority_exponent=cfg.priority_exponent,
        priority_eps=cfg.priority_eps,
        seed=cfg.seed,
        use_native=cfg.use_native_sumtree,
    )
    run_dir = os.path.join(cfg.results_dir, cfg.run_id)
    metrics = MetricsLogger(os.path.join(run_dir, "metrics.jsonl"), cfg.run_id)
    ckpt = Checkpointer(os.path.join(cfg.checkpoint_dir, cfg.run_id))
    faults.install_from(cfg)
    obs_run = RunObs(cfg, metrics, role="learner", device=device)
    sup = TrainSupervisor(cfg, metrics=metrics, registry=obs_run.registry)

    frames = 0
    restored = maybe_resume(cfg, ckpt)
    if restored is not None:
        state, extra, _ = restored
        agent.load_snapshot(state, rng_from_extra(extra, agent.generator.get_state()))
        frames = int(extra.get("frames", 0))
        maybe_restore_replay(cfg, memory)
        metrics.log("resume", step=agent.step, frames=frames)

    stacker = FrameStacker(lanes, env.frame_shape, cfg.history_length)
    obs = env.reset()
    returns: collections.deque = collections.deque(maxlen=100)
    last_eval: Dict[str, Any] = {}
    prefetcher: Optional[BatchPrefetcher] = None

    # pipelined priority write-back + deferred in-graph NaN guard: syncs
    # happen only at ring boundaries (snapshot/eval/checkpoint cadence) and
    # on retirement of K-old steps
    ring = WritebackRing(cfg.writeback_depth, registry=obs_run.registry)

    def _settle() -> None:
        # the loop's own replay writes wait for the worker's queue, so a
        # seeded run draws the same batches (utils/prefetch.py)
        if prefetcher is not None:
            prefetcher.settle()

    def _write_back(idx, td_abs) -> None:
        if prefetcher is not None:  # on the worker, in order with its samples
            prefetcher.update_priorities(idx, td_abs)
        else:
            memory.update_priorities(idx, td_abs)

    committer = RingCommitter(ring, _write_back, sup, agent.load_snapshot)
    last_scalars = committer.scalars
    _commit, _drain = committer.commit, committer.drain
    reuse_k = agent.reuse_k
    check_reuse_cadences(cfg, "metrics_interval", "eval_interval",
                         "checkpoint_interval", "guard_snapshot_interval")

    try:
        while frames < total_frames:
            stacked = stacker.push(obs)
            with obs_run.span("act"):
                actions = agent.act(stacked)
            new_obs, rewards, terminals, truncs, ep_returns = env.step(actions)
            # store the pre-step frame with the transition's reward/terminal;
            # truncations cut stack/n-step windows but never fake a terminal
            _settle()
            memory.append_batch(obs, actions, rewards, terminals, truncations=truncs)
            stacker.reset_lanes(terminals | truncs)
            obs = new_obs
            frames += lanes
            for r in ep_returns[~np.isnan(ep_returns)]:
                returns.append(float(r))

            # one learner step per `frames_per_learn` env frames once warm
            if len(memory) >= cfg.learn_start and memory.sampleable:
                if cfg.prefetch_depth > 0 and prefetcher is None:
                    prefetcher = make_replay_prefetcher(
                        memory, cfg, lambda: priority_beta(cfg, frames), device,
                        registry=obs_run.registry,
                    )
                steps_due = frames // cfg.frames_per_learn - agent.step // reuse_k
                for _ in range(max(steps_due, 0)):
                    if sup.snapshot_due(agent.step):
                        # drain first: the rollback target must never hold a
                        # step whose finiteness is still in flight
                        if not _drain():
                            continue
                        sup.snapshot_if_due(
                            agent.step,
                            lambda: (host_state(agent.state), agent.generator.get_state()),
                        )
                    if prefetcher is not None:
                        idx, batch = prefetcher.get()
                        with obs_run.span("learn_step"):
                            info = agent.learn_batch(sup.poison_maybe(batch))
                    else:
                        with obs_run.span("replay_sample"):
                            sample = memory.sample(
                                cfg.batch_size, priority_beta(cfg, frames)
                            )
                        idx = sample.idx
                        with obs_run.span("learn_step"):
                            info = agent.learn(sup.poison_maybe(sample))
                    sup.maybe_stall()
                    # dispatch-only: info stays on the device; step t-K
                    # retires (priority write-back + deferred NaN guard)
                    if not _commit(ring.push(agent.step, idx, info)):
                        continue

                    step = agent.step
                    obs_run.after_learn_step(step, units=reuse_k)
                    if cadence_hit(step, cfg.metrics_interval, reuse_k):
                        metrics.log(
                            "learn",
                            step=step,
                            frames=frames,
                            fps=metrics.fps(frames),
                            loss=last_scalars.get("loss", float("nan")),
                            q_mean=last_scalars.get("q_mean", float("nan")),
                            grad_norm=last_scalars.get("grad_norm", float("nan")),
                            mean_return=float(np.mean(returns)) if returns else float("nan"),
                            **reuse_learn_row(reuse_k, last_scalars),
                        )
                        obs_run.periodic(
                            step,
                            frames,
                            replay_size=len(memory),
                            replay_occupancy=round(
                                len(memory) / max(cfg.memory_capacity, 1), 4
                            ),
                            **pipeline_gauges(
                                ring, obs_run.registry,
                                reuse=reuse_health(reuse_k, last_scalars),
                            ),
                        )
                    if cadence_hit(step, cfg.eval_interval, reuse_k):
                        if not _drain():  # evaluate only verified params
                            continue
                        last_eval = evaluate(cfg, agent, seed=cfg.seed + 977)
                        metrics.log("eval", step=step, **last_eval)
                    if cadence_hit(step, cfg.checkpoint_interval, reuse_k):
                        if not _drain():  # checkpoint only verified params
                            continue
                        sup.save_checkpoint(
                            ckpt, step, agent.state,
                            {"frames": frames, **rng_extra(agent.generator)},
                        )
                        _settle()
                        sup.save_replay(cfg, memory)
        # end of run: retire the in-flight tail before the final eval/save
        _drain()
    finally:
        if prefetcher is not None:
            prefetcher.close()
        sup.close()
        obs_run.close(agent.step, frames)
    final_eval = evaluate(cfg, agent, seed=cfg.seed + 977)
    metrics.log("eval", step=agent.step, **final_eval)
    sup.save_checkpoint(
        ckpt, agent.step, agent.state,
        {"frames": frames, **rng_extra(agent.generator)}, critical=True,
    )
    sup.save_replay(cfg, memory, critical=True)
    ckpt.wait()
    metrics.close()
    return {
        "frames": frames,
        "learn_steps": agent.step,
        "train_return_mean": float(np.mean(returns)) if returns else float("nan"),
        "rollbacks": sup.rollbacks,
        "stalls": sup.stalls,
        "io_faults": sup.io_faults,
        **{f"eval_{k}": v for k, v in final_eval.items()},
    }


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    """CLI entry: every Config field as a ``--flag``, plus ``--device`` and
    ``--max-frames``; prints the summary as one JSON line and returns it."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None, help="torch device (default cuda:0)")
    pre.add_argument("--max-frames", type=int, default=None,
                     help="stop after this many env frames (default cfg.t_max)")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_config(rest)
    summary = train(cfg, max_frames=known.max_frames, device=known.device)
    print(json.dumps(summary, default=float), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
