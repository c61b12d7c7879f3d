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

A training state goes onto the shrunk grid in JAX's step 3: restored
whole from the latest checkpoint (``checkpoint.CheckpointManager``), then
cut by :func:`reshard_state` into this rank's block of every leaf, by the
same per-dimension specs as before the loss. A spec is the port's
counterpart of a ``PartitionSpec``: a tuple, one entry per leading
dimension, of None (whole), ``"data"`` (split over the grid's rows) or
``"model"`` (over its columns). Blocks are held by grid position (a, b),
as JAX's mesh holds its shards by mesh position, whatever the ranks'
numbers. The data pipeline skips ahead deterministically
(``data.tokens.TokenPipeline`` is keyed on (seed, step)).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

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


def _split(spec, grid) -> tuple[int, int]:
    """(parts, this rank's part) of a dimension under a spec entry."""
    if spec == "data":
        return grid.pr, grid.a
    if spec == "model":
        return grid.pc, grid.b
    raise ValueError(f"a spec entry is None, 'data' or 'model', got "
                     f"{spec!r}")


def _block(x, spec, grid) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec``, a copy on
    the grid's device."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a leaf "
                         f"of shape {tuple(x.shape)}")
    index = []
    for dim, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        parts, at = _split(entry, grid)
        size = x.shape[dim]
        if size % parts:
            raise ValueError(
                f"spec {spec} on the {grid.pr}x{grid.pc} grid implies that "
                f"the global size of dimension {dim} should be divisible by "
                f"{parts}, but it is equal to {size} (full shape: "
                f"{tuple(x.shape)})")
        w = size // parts
        index.append(slice(at * w, (at + 1) * w))
    return x[tuple(index)].to(grid.device, copy=True)


def reshard_state(state, old_specs, new_grid):
    """This rank's blocks of a whole state on the shrunk grid.

    ``state`` is a tree (mappings, tuples, lists) of whole tensors or
    numpy arrays, as a checkpoint restore gives it; ``old_specs`` holds a
    spec (module docstring) at each of its leaves. ``new_grid`` is the
    ``GridSpec`` that :func:`surviving_grid` gave this rank, or None.
    Returns the tree of this rank's blocks on the grid's device, or None
    for a rank outside the grid. A dimension split over an axis whose new
    size does not divide it raises ValueError, as JAX's ``device_put``
    refuses such a sharding: a batch stays a multiple of the new number
    of rows."""
    if new_grid is None:
        return None

    def place(x, spec):
        if isinstance(x, Mapping):
            return {k: place(x[k], spec[k]) for k in x}
        if isinstance(x, (tuple, list)):
            if len(spec) != len(x):
                raise ValueError(f"{len(x)} subtrees, {len(spec)} specs")
            vals = [place(v, s) for v, s in zip(x, spec)]
            return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
        return _block(x, spec, new_grid)

    return place(state, old_specs)
