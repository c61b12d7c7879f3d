"""Elastic recovery of the process grid after rank loss.

The grid's fleet is its ranks: ``FleetState.devices`` is the [pr, pc]
array of the global ranks that own the grid's blocks (``make_grid``
puts rank a * pc + b at block (a, b)), ``alive`` a mask over them. The
recovery protocol:

  1. the coordinator learns which ranks died (heartbeat timeouts;
     here :func:`fail_hosts` masks them);
  2. :func:`surviving_grid` folds the grid down to the largest full
     rectangle the survivors form: every grid row whose ranks are ALL
     alive is kept (a dead rank's row peers hold blocks of a row band
     that nobody else holds), and the kept rows form a new grid over a
     process group of their ranks alone (``core.dist.make_subgrid``);
  3. ``runtime.resilient`` runs the request on that grid, labelled
     ``"grid {pr}x{pc} ({backend}, shrunk)"``, or goes straight to the
     local chain when no full row survived.

Every rank of the default group calls :func:`surviving_grid` with the same
fleet, dead ranks too: building the new groups is collective. A rank
outside the surviving rectangle (a dead one, or a live one in a row that
lost a peer) gets None and does not enter the grid rung: it serves the
request from its own local chain (``"local ..."`` rungs), which gives the
same matching bit for bit, as every route does. On one card (a 1x1 grid)
losing the one rank leaves no row, and the request goes to the local
chain.

Re-placing a training state onto the shrunk grid (JAX's
``reshard_state``) belongs with the checkpoint restore of the training
stack, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dist as _dist


@dataclasses.dataclass
class FleetState:
    devices: np.ndarray  # [pr, pc] global ranks of the grid's blocks
    alive: np.ndarray  # bool mask over devices.reshape(-1)

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())


def initial_fleet(grid: _dist.GridSpec) -> FleetState:
    """Every rank of a :func:`core.dist.make_grid` grid, alive."""
    ranks = np.arange(grid.pr * grid.pc, dtype=np.int64).reshape(grid.pr,
                                                                 grid.pc)
    return FleetState(ranks, np.ones(ranks.size, bool))


def fail_hosts(fleet: FleetState, dead_ranks) -> FleetState:
    alive = fleet.alive.copy()
    dead = {int(r) for r in dead_ranks}
    for i, r in enumerate(fleet.devices.reshape(-1)):
        if int(r) in dead:
            alive[i] = False
    return FleetState(fleet.devices, alive)


def surviving_ranks(fleet: FleetState) -> np.ndarray:
    """[pr', pc] ranks of the grid rows whose ranks are all alive. Raises
    RuntimeError when no full row survived."""
    alive = fleet.alive.reshape(fleet.devices.shape)
    kept = fleet.devices[alive.all(axis=1)]
    if kept.shape[0] == 0:
        raise RuntimeError("no complete grid row survived")
    return kept


def surviving_grid(fleet: FleetState, device=None):
    """The grid over the surviving rows (:func:`surviving_ranks`), for
    this rank: its ``GridSpec``, or None for a rank outside the rectangle
    (module docstring). Collective: every rank of the default group calls
    it with the same fleet. Raises RuntimeError, on every rank and before
    any group is built, when no full row survived."""
    return _dist.make_subgrid(surviving_ranks(fleet), device=device)
