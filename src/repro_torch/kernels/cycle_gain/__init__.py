"""The AWAC kernels: the per-round sweep (``awac_sweep``) and the
persistent whole-loop kernel (``persistent``); ``ops`` holds the engines'
entry points into them."""
