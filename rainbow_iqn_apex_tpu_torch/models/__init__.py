"""The port's Rainbow-IQN network: layers, the model and its initialiser."""

from rainbow_iqn_apex_tpu_torch.models.init import init_params, make_network
from rainbow_iqn_apex_tpu_torch.models.iqn import (
    IQNOutput,
    RainbowIQN,
    greedy_action,
    q_values,
)
from rainbow_iqn_apex_tpu_torch.models.layers import (
    ConvTrunk,
    CosineTauEmbedding,
    NoisyLinear,
)

__all__ = [
    "ConvTrunk",
    "CosineTauEmbedding",
    "IQNOutput",
    "NoisyLinear",
    "RainbowIQN",
    "greedy_action",
    "init_params",
    "make_network",
    "q_values",
]
