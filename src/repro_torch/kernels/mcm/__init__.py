"""The maximum cardinality matching kernel: every MCM phase of one
instance in one cooperative launch (``persistent``, the wrapper of
``csrc/mcm_persistent.cu``); its plain version is
``core.single.mcm_plain``."""
from repro_torch.kernels.mcm.persistent import mcm_persistent

__all__ = ["mcm_persistent"]
