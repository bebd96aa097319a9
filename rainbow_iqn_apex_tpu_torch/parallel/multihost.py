"""Multi-host helpers of the port.  Only ``shift_stack`` is ported yet: the
device-resident frame-stack update of ``rainbow_iqn_apex_tpu/parallel/multihost.py``
(:214-220) that the Anakin trainer acts on.  The lane carving, sharded
replay and process-group helpers wait for the multi-GPU slice."""

from __future__ import annotations

import torch


def shift_stack(stack: torch.Tensor, frame: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """In place on the device stack [L, H, W, h]: zero the lanes whose
    episode was cut LAST tick (``keep`` [L] 0/1, the host FrameStacker's
    push-then-reset order), then shift the newest [L, H, W] frame into the
    trailing channel.  Returns ``stack``."""
    stack.mul_(keep.to(stack.dtype)[:, None, None, None])
    stack.copy_(torch.cat([stack[..., 1:], frame[..., None]], dim=-1))
    return stack
