"""Atomic checkpoint manager (the port of the JAX package's
``checkpoint/manager.py``), with its layout.

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per flattened leaf and
``manifest.json`` (the leaves' paths, shapes and dtypes, the step). A save
writes ``step_<N>.tmp``, fsyncs it and renames it, so a crashed save never
corrupts the latest checkpoint; ``keep`` bounds how many stay. An async
mode copies the state to the host, then writes it on a worker thread so
the loop overlaps the IO with compute.

A state is a tree of mappings (keys in sorted order, as ``jax.tree``
flattens them), lists, tuples and named tuples (``OptState``) over
tensors, arrays and scalars. Restore needs a ``like`` prototype of the
same structure, and puts each leaf on its prototype's device and dtype.
The JAX package's ``shardings=`` re-places leaves on another mesh; with
one device there is nothing to re-place, so it is left out.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] in a fixed order: sorted mapping keys, sequence
    positions, named-tuple fields."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for k in tree._fields:
            out += _flatten(getattr(tree, k), f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with the leaf at each path taken from
    ``leaves`` (numpy), placed as its prototype leaf is."""
    if isinstance(like, Mapping):
        return {k: _unflatten(like[k], leaves, f"{prefix}{k}/")
                for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, k), leaves,
                                       f"{prefix}{k}/")
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves, f"{prefix}{i}/")
                          for i, x in enumerate(like))
    arr = leaves[prefix.rstrip("/")]
    if torch.is_tensor(like):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return arr


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread = None

    # ------------------------------ save ---------------------------------

    def save(self, step: int, params, opt_state=None,
             extra: dict | None = None):
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        host = [(path, _host(x)) for path, x in _flatten(state)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, extra: dict):
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {
            "step": step,
            "paths": [p for p, _ in host_leaves],
            "n_leaves": len(host_leaves),
            "shapes": [list(x.shape) for _, x in host_leaves],
            "dtypes": [str(x.dtype) for _, x in host_leaves],
            "extra": extra,
        }
        for i, (_, leaf) in enumerate(host_leaves):
            np.save(tmp / f"leaf_{i:05d}.npy", leaf)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ----------------------------- restore --------------------------------

    def list_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like=None):
        """Returns (params, opt_state or None, step). ``like`` is a
        prototype of the saved state ({"params": ..., "opt": ...}) whose
        structure and leaf placement the result takes."""
        if like is None:
            raise ValueError("restore requires a `like` prototype tree")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        paths = manifest["paths"]
        want = [p for p, _ in _flatten(like)]
        if paths != want:
            first = next((a, b) for a, b in zip(paths + [None], want + [None])
                         if a != b)
            raise ValueError(
                f"checkpoint step {step} holds {len(paths)} leaves that do "
                f"not match the prototype's {len(want)} (first difference: "
                f"{first})")
        leaves = {p: np.load(d / f"leaf_{i:05d}.npy")
                  for i, p in enumerate(paths)}
        state = _unflatten(like, leaves)
        return state["params"], state.get("opt"), manifest["step"]

    def restore_latest(self, like=None):
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], like=like)
