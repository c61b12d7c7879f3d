"""Guarded execution around the matching facade: deadlines, retries, the
backend degradation chain and post-solve verification
(:mod:`~repro_torch.runtime.resilient`); the fault-injection harness
(:mod:`~repro_torch.runtime.chaos`); the fleet of grid ranks and its
shrinking after a loss (:mod:`~repro_torch.runtime.elastic`); and the
step-time straggler monitor (:mod:`~repro_torch.runtime.straggler`)."""
