"""Prioritized replay of the port: copies of the JAX package's host
structures (``replay/sumtree.py``, ``buffer.py``, ``native.py``,
``snapshot_io.py``, R2D2's ``sequence.py`` and the C++ core in ``native/``),
the device-resident replay of the Anakin learner (``replay/device.py``,
kernels K5-K8) and R2D2's device-resident sequence replay
(``replay/device_sequence.py``, kernels K7s, K5s, K8s, K6s)."""

from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay, SampledBatch
from rainbow_iqn_apex_tpu_torch.replay.device_sequence import (
    DeviceSeqState,
    DeviceSequenceReplay,
    build_device_r2d2_learn,
)
from rainbow_iqn_apex_tpu_torch.replay.native import NativeSumTree, native_available
from rainbow_iqn_apex_tpu_torch.replay.sequence import SequenceReplay, SequenceSample
from rainbow_iqn_apex_tpu_torch.replay.sumtree import SumTree

__all__ = ["DeviceSeqState", "DeviceSequenceReplay", "NativeSumTree", "PrioritizedReplay",
           "SampledBatch", "SequenceReplay", "SequenceSample", "SumTree",
           "build_device_r2d2_learn", "native_available"]
