"""Multi-host helpers of the port.  Ported so far: ``shift_stack``, the
device-resident frame-stack update of ``rainbow_iqn_apex_tpu/parallel/multihost.py``
(:214-220) that the Anakin trainer and the Ape-X actor act on, and
``plan_hosts`` (:107-150) for one process.  The lane carving across
processes, the sharded learn step and the process-group helpers wait for
the multi-GPU slice (ROADMAP.md A13)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HostPlan:
    """One host's carve of an apex run."""

    multihost: bool
    nproc: int
    lanes: int  # this host's env lanes
    lane_lo: int  # global index of this host's first lane (seed offset)
    is_main: bool  # process 0: metrics/eval owner
    local_batch: int  # rows this host feeds into the learn step


def plan_hosts(cfg, lanes_total: int) -> HostPlan:
    """This process's share of an apex run: the whole of it.  More than one
    process raises (multi-GPU is ROADMAP.md A13)."""
    if max(cfg.process_count, 1) > 1:
        raise NotImplementedError(
            f"process_count={cfg.process_count}: multi-process apex (A13) is not ported yet")
    return HostPlan(False, 1, lanes_total, 0, True, cfg.batch_size)


def shift_stack(stack: torch.Tensor, frame: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """In place on the device stack [L, H, W, h]: zero the lanes whose
    episode was cut LAST tick (``keep`` [L] 0/1, the host FrameStacker's
    push-then-reset order), then shift the newest [L, H, W] frame into the
    trailing channel.  Returns ``stack``."""
    stack.mul_(keep.to(stack.dtype)[:, None, None, None])
    stack.copy_(torch.cat([stack[..., 1:], frame[..., None]], dim=-1))
    return stack
