"""Prioritized replay of the port: copies of the JAX package's host
structures (``replay/sumtree.py``, ``buffer.py``, ``native.py``,
``snapshot_io.py`` and the C++ core in ``native/``)."""

from rainbow_iqn_apex_tpu_torch.replay.buffer import PrioritizedReplay, SampledBatch
from rainbow_iqn_apex_tpu_torch.replay.native import NativeSumTree, native_available
from rainbow_iqn_apex_tpu_torch.replay.sumtree import SumTree

__all__ = ["NativeSumTree", "PrioritizedReplay", "SampledBatch", "SumTree", "native_available"]
