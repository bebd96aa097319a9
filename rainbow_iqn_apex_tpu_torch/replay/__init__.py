"""Prioritized replay of the port: copies of the JAX package's host
structures (``replay/sumtree.py``, ``buffer.py``, ``native.py``,
``snapshot_io.py``, R2D2's ``sequence.py`` and the C++ core in ``native/``),
and the device-resident replay of the Anakin learner (``replay/device.py``,
kernels K5-K8)."""

from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay, SampledBatch
from rainbow_iqn_apex_tpu_torch.replay.native import NativeSumTree, native_available
from rainbow_iqn_apex_tpu_torch.replay.sequence import SequenceReplay, SequenceSample
from rainbow_iqn_apex_tpu_torch.replay.sumtree import SumTree

__all__ = ["NativeSumTree", "PrioritizedReplay", "SampledBatch", "SequenceReplay",
           "SequenceSample", "SumTree", "native_available"]
