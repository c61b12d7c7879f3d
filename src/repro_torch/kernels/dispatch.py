"""Measured backend dispatch table for ``backend="auto"`` (the port of the
JAX package's ``kernels/dispatch.py``).

``tools/dispatch_table.py`` times every local AWAC backend in each shape
class, on the card and on its host's CPU, and writes the winners into the
table this module reads, ``dispatch_table.json`` beside it (the port's
own file; ``REPRO_TORCH_DISPATCH_TABLE`` points elsewhere).

Table schema (one entry per ``<platform>/<shape class>``, the platform
being the device type, "cuda" or "cpu")::

    {"entries": {"cuda/single_large": {
         "winner": "cuda_persistent",
         "us_per_iter": {"reference": ..., "torch": ..., ...},
         ...},
      ...},
     "metadata": {...}}

Shape classes are coarse, ``{single|batched}_{small|large}`` with the split
at ``n <= SMALL_N``. Lookup falls back class -> same-kind class -> any
class of the platform -> None; None means "unmeasured here", and the caller
(``core.single.resolve_backend``) falls back to its heuristic, labeled as
such (``ExecutionInfo.source``).
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any

#: the committed table, beside this module
DEFAULT_TABLE_PATH = pathlib.Path(__file__).resolve().parent \
    / "dispatch_table.json"

#: env override for tests and other deployments
TABLE_ENV_VAR = "REPRO_TORCH_DISPATCH_TABLE"

#: boundary of the {small, large} shape-class split (inclusive small side)
SMALL_N = 256

#: backends the measurement times in each class (in its order)
MEASURED_BACKENDS = ("reference", "torch", "cuda", "cuda_persistent")

_CACHE: dict[str, dict | None] = {}


def table_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(TABLE_ENV_VAR, DEFAULT_TABLE_PATH))


def shape_class(n: int | None, batch: int | None = None) -> str:
    """Coarse shape class: ``{single|batched}_{small|large}``.

    ``n=None`` (the shape unknown where the backend is resolved, as in the
    resilience layer's chain) maps to the large single-instance class."""
    kind = "batched" if batch is not None and batch > 1 else "single"
    size = "large" if n is None or n > SMALL_N else "small"
    return f"{kind}_{size}"


def load_table(path: str | os.PathLike | None = None) -> dict | None:
    """Load (and cache) the dispatch table; None when absent or
    unreadable."""
    p = str(path if path is not None else table_path())
    if p in _CACHE:
        return _CACHE[p]
    try:
        with open(p) as f:
            table = json.load(f)
        if not isinstance(table.get("entries"), dict):
            table = None
    except (OSError, ValueError, AttributeError):
        table = None
    _CACHE[p] = table
    return table


def clear_cache() -> None:
    _CACHE.clear()


def _entry(table: dict, platform: str, klass: str) -> dict | None:
    entries = table["entries"]
    hit = entries.get(f"{platform}/{klass}")
    if hit is not None:
        return hit
    # same kind (single/batched), other size
    kind = klass.split("_")[0]
    for key, e in sorted(entries.items()):
        plat, _, kl = key.partition("/")
        if plat == platform and kl.startswith(kind):
            return e
    # any class measured on this platform
    for key, e in sorted(entries.items()):
        if key.partition("/")[0] == platform:
            return e
    return None


def choose_backend(n: int | None = None, batch: int | None = None,
                   platform: str | None = None,
                   path: str | os.PathLike | None = None) -> str | None:
    """The measured winner for (platform, shape class), or None where the
    table has none. ``platform`` is a device type ("cuda" or "cpu");
    None means "cuda" when a card is present, else "cpu"."""
    table = load_table(path)
    if table is None:
        return None
    if platform is None:
        import torch

        platform = "cuda" if torch.cuda.is_available() else "cpu"
    entry = _entry(table, platform, shape_class(n, batch))
    if entry is None:
        return None
    winner = entry.get("winner")
    return winner if isinstance(winner, str) and winner else None


def save_table(entries: dict[str, Any], metadata: dict[str, Any],
               path: str | os.PathLike | None = None) -> pathlib.Path:
    """Write a measured table and drop the cache."""
    p = pathlib.Path(path if path is not None else table_path())
    with open(p, "w") as f:
        json.dump({"entries": entries, "metadata": metadata}, f, indent=1)
        f.write("\n")
    clear_cache()
    return p
