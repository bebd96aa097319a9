"""Device-side operations of the port: the act step."""

from rainbow_iqn_apex_tpu_torch.ops.act import build_act_step, load_network, resolve_device

__all__ = ["build_act_step", "load_network", "resolve_device"]
