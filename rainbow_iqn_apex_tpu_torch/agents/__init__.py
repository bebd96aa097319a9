"""The port's Agent (``agent.py``)."""

from rainbow_iqn_apex_tpu_torch.agents.agent import Agent, FrameStacker, put_frames, to_device_batch

__all__ = ["Agent", "FrameStacker", "put_frames", "to_device_batch"]
