"""Device-side operations of the port: the act step, the loss and the learn step."""

from rainbow_iqn_apex_tpu_torch.ops.act import build_act_step, load_network, resolve_device
from rainbow_iqn_apex_tpu_torch.ops.learn import (
    Batch,
    TrainState,
    build_learn_step,
    host_state,
    init_train_state,
    load_host_state,
    loss_and_priorities,
    make_optimizer,
)
from rainbow_iqn_apex_tpu_torch.ops.losses import huber, quantile_huber_loss

__all__ = [
    "Batch",
    "TrainState",
    "build_act_step",
    "build_learn_step",
    "host_state",
    "huber",
    "init_train_state",
    "load_host_state",
    "load_network",
    "loss_and_priorities",
    "make_optimizer",
    "quantile_huber_loss",
    "resolve_device",
]
