"""Activation-sharding hook (the port of the JAX package's
``models/act_sharding.py``).

Model code calls ``constrain(x, key)`` at the points where the JAX
package pins an activation's sharding, with the same keys; the dry run
installs a per-family policy (key -> spec, a tuple of mesh-axis names or
None per dimension) while it traces a cell. On one device there is no
sharding to impose: ``constrain`` returns ``x`` itself, always. Under a
policy it also records (key, shape, dtype, spec) in the policy's log,
from which the dry run reckons the collectives a mesh would run
(``launch.dryrun``). Without a policy it does nothing else.

Keys:
  lm_act        [B, S, d]       transformer residual stream
  lm_qkv        [B, S, H, D]    per-head projections
  lm_kv         [B, S, Hkv, D]  key / value projections
  lm_logits     [B, S, V] / [B, V]
  mlp_hidden    [..., ff]       FFN hidden
  moe_buf4      [G, E, C, d]    expert dispatch buffers
  w_fsdp        a dense weight at use (the ``fsdp_gather`` variant)
  w_expert      the stacked expert weights at use (``fsdp_gather``)
  nodes, nodes3 [N, ...]        GNN node states
  edges, edges3 [E, ...]        GNN edge messages
  rec_act       [B, S, d]       bert4rec stream

A spec may be a dict keyed by rank (``mlp_hidden`` is [B, S, ff] or
[T, ff]); the entry for ``x.dim()`` applies. A key the policy does not
map is recorded with spec None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

_tls = threading.local()


@dataclasses.dataclass
class Policy:
    """A mesh (``launch.mesh.MeshSpec``), its key -> spec mapping, and the
    log of the ``constrain`` calls made under it."""

    mesh: object
    mapping: dict
    log: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def policy(mesh, mapping: dict):
    """Install a policy for the block; yields it, with its log."""
    prev = getattr(_tls, "policy", None)
    pol = Policy(mesh, mapping)
    _tls.policy = pol
    try:
        yield pol
    finally:
        _tls.policy = prev


def with_policy(mesh, mapping: dict):
    """Wrap fn so the policy is active while it runs."""

    def deco(fn):
        def wrapped(*a, **k):
            with policy(mesh, mapping):
                return fn(*a, **k)

        return wrapped

    return deco


def constrain(x, key: str):
    pol = getattr(_tls, "policy", None)
    if pol is None:
        return x
    spec = pol.mapping.get(key)
    if isinstance(spec, dict):  # rank-dispatched specs (mlp_hidden 2D/3D)
        spec = spec.get(x.dim())
    pol.log.append((key, tuple(x.shape), x.dtype, spec))
    return x
