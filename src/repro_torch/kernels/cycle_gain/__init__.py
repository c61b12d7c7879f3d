"""The cycle-gain kernels: the AWAC per-round sweep (``awac_sweep``, K1),
the persistent whole-loop kernel (``persistent``, K2) and the dense
cycle-gain tile (``cycle_gain``, K3, with its plain version in ``ref``);
``ops`` holds the public entries into them."""
