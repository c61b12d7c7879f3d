"""The cycle-gain kernels: the AWAC per-round sweep (``awac_sweep``, K1),
the persistent whole-loop kernel (``persistent``, K2) and the dense
cycle-gain tile (``cycle_gain``, K3, with its plain version in ``ref``);
``ops`` holds the public entries into them. The JAX package's
``awac_sweep`` (its B = 1 slice of ``awac_sweep_batched``, with TPU
tiling arguments) has no counterpart: the single-instance entry is
``awac_sweep_winners``."""
from repro_torch.kernels.cycle_gain.awac_sweep import awac_sweep_batched
from repro_torch.kernels.cycle_gain.cycle_gain import cycle_gain
from repro_torch.kernels.cycle_gain.ops import (
    awac_sweep_winners,
    awac_sweep_winners_batched,
    cycle_gain_padded,
)
from repro_torch.kernels.cycle_gain.ref import cycle_gain_plain

__all__ = [
    "awac_sweep_batched",
    "awac_sweep_winners",
    "awac_sweep_winners_batched",
    "cycle_gain",
    "cycle_gain_padded",
    "cycle_gain_plain",
]
