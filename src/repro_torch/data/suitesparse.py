"""Opt-in SuiteSparse Matrix Collection downloader (a copy of the JAX
package's ``data/suitesparse.py``).

The paper evaluates AWPM on SuiteSparse instances (Table 6.2-style circuit
/ device / PDE families); the checked-in ``tests/data/*.mtx`` fixtures are
small synthetic stand-ins so CI never touches the network. This module is
the explicit escape hatch: :func:`fetch` and :func:`fetch_paper_instances`
put the named instances into a local cache, whose ``.mtx`` files
``experiments.paper_eval`` sweeps like any other case. No runner calls
it: nothing downloads unless a user asks for it.

Design constraints, in order:

- **Opt-in only.** Nothing in this package imports urllib at module scope
  or downloads implicitly; CI stays on fixtures. A download happens only
  when a user calls :func:`fetch`.
- **Checksummed.** Every download is sha256-hashed. Instances with a
  pinned hash in :data:`PAPER_INSTANCES` are verified against it;
  unpinned instances are pinned trust-on-first-use into
  ``<cache>/checksums.json`` so any later re-download (or a tampered
  cache) fails loudly instead of silently shifting results.
- **Offline-friendly errors.** A network failure raises
  :class:`SuiteSparseUnavailable` naming the URL, the cache dir, and the
  fact that the fixture path needs no network — never a bare URLError
  half-way through a sweep.

Cache layout: ``<cache>/<Group>/<name>.tar.gz`` (as served) plus the
extracted ``<cache>/<Group>/<name>/<name>.mtx``. Default cache dir is
``$REPRO_SUITESPARSE_CACHE`` or ``~/.cache/repro-suitesparse``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tarfile

__all__ = [
    "PAPER_INSTANCES",
    "SuiteSparseInstance",
    "SuiteSparseUnavailable",
    "cache_dir",
    "fetch",
    "fetch_paper_instances",
    "local_path",
]

BASE_URL = "https://sparse.tamu.edu/MM"


class SuiteSparseUnavailable(RuntimeError):
    """Download failed (offline runner, proxy, bad URL) or a checksum
    mismatched. The message always says how to proceed without the
    network (the checked-in fixtures need none)."""


@dataclasses.dataclass(frozen=True)
class SuiteSparseInstance:
    """One collection entry: ``group/name`` plus an optional pinned
    sha256 of the ``.tar.gz`` as served. ``sha256=None`` means
    trust-on-first-use: the first verified download records the hash in
    the cache's ``checksums.json``."""

    name: str
    group: str
    sha256: str | None = None

    @property
    def url(self) -> str:
        return f"{BASE_URL}/{self.group}/{self.name}.tar.gz"


#: The paper's evaluation families (Azad et al. §6, Table 6.2-style):
#: circuit-simulation matrices (the MC64-hard family with magnitudes
#: spanning many decades), device/EM, and large PDE instances. Hashes are
#: pinned trust-on-first-use per cache (the collection serves stable
#: tarballs but republishes occasionally; a pin here would rot, a pin in
#: the user's cache is exactly as fresh as their data).
PAPER_INSTANCES = (
    SuiteSparseInstance("Freescale1", "Freescale"),
    SuiteSparseInstance("memchip", "Freescale"),
    SuiteSparseInstance("rajat31", "Rajat"),
    SuiteSparseInstance("circuit5M", "Freescale"),
    SuiteSparseInstance("cage14", "vanHeukelum"),
    SuiteSparseInstance("torso1", "Norris"),
    SuiteSparseInstance("dielFilterV3real", "Dziekonski"),
    SuiteSparseInstance("nlpkkt80", "Schenk_IBMNA"),
    SuiteSparseInstance("Serena", "Janna"),
    SuiteSparseInstance("audikw_1", "GHS_psdef"),
    SuiteSparseInstance("ldoor", "GHS_psdef"),
    SuiteSparseInstance("HV15R", "Fluorem"),
)

_BY_NAME = {inst.name: inst for inst in PAPER_INSTANCES}


def cache_dir(override=None) -> pathlib.Path:
    """Resolve the cache directory (override > env > default)."""
    if override is not None:
        return pathlib.Path(override)
    env = os.environ.get("REPRO_SUITESPARSE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro-suitesparse"


def _resolve(name) -> SuiteSparseInstance:
    if isinstance(name, SuiteSparseInstance):
        return name
    if name in _BY_NAME:
        return _BY_NAME[name]
    if "/" in str(name):
        group, base = str(name).split("/", 1)
        return SuiteSparseInstance(base, group)
    raise KeyError(
        f"unknown SuiteSparse instance {name!r}: expected one of "
        f"{sorted(_BY_NAME)} or an explicit 'Group/name' spec")


def local_path(name, cache=None) -> pathlib.Path:
    """Where the extracted ``.mtx`` for ``name`` lives (existing or not)."""
    inst = _resolve(name)
    return cache_dir(cache) / inst.group / inst.name / f"{inst.name}.mtx"


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _checksum_store(cache: pathlib.Path) -> pathlib.Path:
    return cache / "checksums.json"


def _verify(inst: SuiteSparseInstance, tarball: pathlib.Path,
            cache: pathlib.Path) -> None:
    """Registry pin > cached trust-on-first-use pin > record new pin."""
    digest = _sha256(tarball)
    store_path = _checksum_store(cache)
    store = {}
    if store_path.exists():
        store = json.loads(store_path.read_text())
    expected = inst.sha256 or store.get(f"{inst.group}/{inst.name}")
    if expected is not None:
        if digest != expected:
            raise SuiteSparseUnavailable(
                f"sha256 mismatch for {inst.group}/{inst.name}: got "
                f"{digest}, pinned {expected}. The collection republished "
                f"the tarball or the download was corrupted — delete "
                f"{tarball} (and the pin in {store_path} if you trust the "
                f"new file) to re-fetch.")
        return
    store[f"{inst.group}/{inst.name}"] = digest
    store_path.parent.mkdir(parents=True, exist_ok=True)
    store_path.write_text(json.dumps(store, indent=1, sort_keys=True))


def _download(url: str, dest: pathlib.Path, timeout: float) -> None:
    import urllib.error
    import urllib.request

    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                open(tmp, "wb") as out:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        tmp.replace(dest)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        tmp.unlink(missing_ok=True)
        raise SuiteSparseUnavailable(
            f"could not download {url}: {e}. If this runner is offline "
            f"(CI is, by design), skip --download — the checked-in "
            f"tests/data fixtures cover the pipeline without any network. "
            f"A pre-populated cache at {dest.parent.parent} also works: "
            f"drop the extracted <name>.mtx files in place.") from e


def _extract_mtx(inst: SuiteSparseInstance, tarball: pathlib.Path,
                 out: pathlib.Path) -> None:
    """Pull ``<name>/<name>.mtx`` out of the collection tarball (which may
    also carry auxiliary ``<name>_b.mtx``-style files we ignore)."""
    want = f"{inst.name}/{inst.name}.mtx"
    with tarfile.open(tarball, "r:gz") as tf:
        member = next((m for m in tf.getmembers()
                       if m.isfile() and m.name.lstrip("./") == want), None)
        if member is None:
            names = [m.name for m in tf.getmembers()][:8]
            raise SuiteSparseUnavailable(
                f"{tarball} does not contain {want!r} (members: {names}...)")
        member.name = pathlib.Path(member.name).name  # no path traversal
        tf.extract(member, path=out.parent)


def fetch(name, cache=None, timeout: float = 120.0) -> pathlib.Path:
    """Return the local ``.mtx`` path for ``name``, downloading + verifying
    + extracting if the cache misses. ``name`` is a registry name, a
    ``Group/name`` spec, or a :class:`SuiteSparseInstance`."""
    inst = _resolve(name)
    cache_root = cache_dir(cache)
    mtx = local_path(inst, cache_root)
    if mtx.exists():
        return mtx
    mtx.parent.mkdir(parents=True, exist_ok=True)
    tarball = cache_root / inst.group / f"{inst.name}.tar.gz"
    if not tarball.exists():
        _download(inst.url, tarball, timeout)
    _verify(inst, tarball, cache_root)
    _extract_mtx(inst, tarball, mtx)
    if not mtx.exists():
        raise SuiteSparseUnavailable(
            f"extraction of {tarball} produced no {mtx}")
    return mtx


def fetch_paper_instances(names=None, cache=None) -> dict[str, pathlib.Path]:
    """Fetch several instances (default: the whole paper registry) and
    return ``{name: mtx_path}``. Failures are collected so one offline
    instance doesn't abort the rest — but if EVERY fetch failed, raise."""
    insts = [
        _resolve(n) for n in (names or [i.name for i in PAPER_INSTANCES])]
    out, errors = {}, []
    for inst in insts:
        try:
            out[inst.name] = fetch(inst, cache=cache)
        except SuiteSparseUnavailable as e:
            errors.append(str(e))
    if errors and not out:
        raise SuiteSparseUnavailable(
            "every SuiteSparse fetch failed:\n" + "\n".join(errors))
    for msg in errors:
        print(f"# suitesparse: SKIPPED — {msg}")
    return out
