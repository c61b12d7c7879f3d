"""Dependency-light Matrix Market (``.mtx``) reader/writer.

The paper evaluates AWPM on SuiteSparse instances, which ship in Matrix
Market coordinate format; this module is the ingestion path from those
files into :class:`repro_torch.core.MatchingProblem` — pure numpy + text parsing,
no scipy.io dependency, so the data layer works wherever the engine does.

Supported dialect (the one every SuiteSparse sparse matrix uses):

  %%MatrixMarket matrix coordinate {real|integer|pattern|complex}
                 {general|symmetric|skew-symmetric|hermitian}

- ``coordinate`` only (the dense ``array`` format is rejected — a dense
  dump is not a sparse-solver workload).
- ``complex`` entries carry four tokens (i j re im) and parse into a
  complex128 value array; matching weights stay real via the magnitude
  pre-transform in :func:`load_problem` (``w = |a_ij|`` feeds the weight
  transform) while the complex values ride along for the solver path
  (``repro_torch.solver`` factorizes them as-is). ``hermitian`` storage
  requires the complex field, must keep a real diagonal, and expands by
  mirroring with the conjugate.
- symmetric storage holds one triangle; :func:`read_mtx` expands it to
  general by mirroring off-diagonal entries (skew-symmetric mirrors with
  negated value and must not carry diagonal entries).
- repeated coordinates are legal on read and assembled by summation
  (:func:`repro_torch.sparse.csr.dedupe_coo_sum`) in :func:`load_problem`, the
  Matrix Market assembly convention.

Values are parsed into float64 exactly as written; :func:`write_mtx` emits
shortest round-tripping reprs, so read -> write -> read is bit-equal
(tests/test_torch_mtx.py pins this).
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

BANNER = "%%MatrixMarket"
FIELDS = ("real", "integer", "pattern", "complex")
SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")

__all__ = [
    "FIELDS",
    "SYMMETRIES",
    "CooMatrix",
    "MatrixMarketError",
    "load_problem",
    "read_mtx",
    "write_mtx",
]


class MatrixMarketError(ValueError):
    """Malformed or unsupported .mtx content (always names the file/line)."""


@dataclasses.dataclass
class CooMatrix:
    """Parsed coordinate matrix: 0-based indices, float64 values.

    ``field``/``symmetry`` record the header as stored in the file;
    ``expanded`` says whether symmetric storage has already been mirrored
    into general form (the default on read). Entries keep file order —
    sorting/dedup happens in :func:`load_problem` via the repo's canonical
    COO pipeline.
    """

    nrows: int
    ncols: int
    row: np.ndarray  # [nnz] int64, 0-based
    col: np.ndarray  # [nnz] int64, 0-based
    val: np.ndarray  # [nnz] float64 (complex128 for the 'complex' field;
    # pattern entries read as 1.0)
    field: str
    symmetry: str
    expanded: bool

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def is_square(self) -> bool:
        return self.nrows == self.ncols


def _err(path, lineno, msg) -> MatrixMarketError:
    return MatrixMarketError(f"{path}:{lineno}: {msg}")


def _parse_header(path, line: str) -> tuple[str, str]:
    tokens = line.split()
    if not line.startswith(BANNER) or len(tokens) != 5:
        raise _err(path, 1, f"bad Matrix Market banner {line.strip()!r}: "
                            f"expected '{BANNER} matrix coordinate "
                            f"<field> <symmetry>'")
    _, obj, fmt, field, symmetry = (t.lower() for t in tokens)
    if obj != "matrix":
        raise _err(path, 1, f"unsupported object {obj!r} (only 'matrix')")
    if fmt != "coordinate":
        raise _err(path, 1, f"unsupported format {fmt!r}: only the sparse "
                            f"'coordinate' format is supported (dense "
                            f"'array' dumps are not a sparse workload)")
    if field not in FIELDS:
        raise _err(path, 1, f"unsupported field {field!r}: expected one of "
                            f"{FIELDS}")
    if symmetry not in SYMMETRIES:
        raise _err(path, 1, f"unsupported symmetry {symmetry!r}: expected "
                            f"one of {SYMMETRIES}")
    if symmetry == "hermitian" and field != "complex":
        raise _err(path, 1, f"'hermitian' symmetry requires the 'complex' "
                            f"field (got {field!r}); real hermitian IS "
                            f"symmetric — declare it so")
    if field == "pattern" and symmetry == "skew-symmetric":
        raise _err(path, 1, "'pattern' entries carry no sign, so "
                            "'skew-symmetric' storage is meaningless")
    return field, symmetry


def read_mtx(path, expand_symmetry: bool = True) -> CooMatrix:
    """Parse a Matrix Market coordinate file (see module docstring for the
    supported dialect). With ``expand_symmetry`` (default), symmetric /
    skew-symmetric storage is mirrored into explicit general-form entries."""
    path = pathlib.Path(path)
    lines = path.read_text().splitlines()
    if not lines:
        raise _err(path, 1, "empty file (missing Matrix Market banner)")
    field, symmetry = _parse_header(path, lines[0])

    want = {"pattern": 2, "complex": 4}.get(field, 3)
    size = None
    rows, cols, vals = [], [], []
    for lineno, line in enumerate(lines[1:], start=2):
        stripped = line.strip()
        if not stripped or stripped.startswith("%"):
            continue
        tokens = stripped.split()
        if size is None:  # size line: nrows ncols nnz
            try:
                nrows, ncols, nnz = (int(t) for t in tokens)
            except ValueError:
                raise _err(path, lineno, f"bad size line {stripped!r}: "
                                         f"expected 'nrows ncols nnz'") from None
            if len(tokens) != 3 or min(nrows, ncols) < 0 or nnz < 0:
                raise _err(path, lineno, f"bad size line {stripped!r}: "
                                         f"expected 'nrows ncols nnz'")
            size = (nrows, ncols, nnz)
            continue
        if len(rows) >= size[2]:
            raise _err(path, lineno, f"more than the declared {size[2]} "
                                     f"entries (unexpected line {stripped!r})")
        if len(tokens) != want:
            raise _err(path, lineno, f"expected {want} tokens per "
                                     f"{field!r} entry, got {stripped!r}")
        try:
            i, j = int(tokens[0]), int(tokens[1])
            if field == "pattern":
                v = 1.0
            elif field == "integer":
                v = float(int(tokens[2]))
            elif field == "complex":
                v = complex(float(tokens[2]), float(tokens[3]))
            else:
                v = float(tokens[2])
        except ValueError:
            raise _err(path, lineno, f"bad {field!r} entry {stripped!r}") from None
        parts = (v.real, v.imag) if field == "complex" else (v,)
        if any(p != p or p in (float("inf"), float("-inf")) for p in parts):
            # python's float() happily parses 'nan'/'inf'; a non-finite
            # weight poisons every downstream comparison (preflight would
            # flag it later, but the file position is only known here)
            bad = next(t for p, t in zip(parts, tokens[2:])
                       if p != p or p in (float("inf"), float("-inf")))
            raise _err(path, lineno, f"non-finite value {bad!r}: matching "
                                     f"weights must be finite")
        if not (1 <= i <= size[0] and 1 <= j <= size[1]):
            raise _err(path, lineno, f"index ({i}, {j}) outside the declared "
                                     f"{size[0]} x {size[1]} shape (Matrix "
                                     f"Market indices are 1-based)")
        rows.append(i - 1)
        cols.append(j - 1)
        vals.append(v)
    if size is None:
        raise _err(path, len(lines), "missing size line 'nrows ncols nnz'")
    if len(rows) != size[2]:
        raise _err(path, len(lines), f"declared {size[2]} entries but "
                                     f"found {len(rows)}")

    row = np.asarray(rows, np.int64)
    col = np.asarray(cols, np.int64)
    val = np.asarray(vals,
                     np.complex128 if field == "complex" else np.float64)
    expanded = False
    if expand_symmetry and symmetry != "general":
        if size[0] != size[1]:
            raise _err(path, 1, f"{symmetry!r} matrix must be square, "
                                f"got {size[0]} x {size[1]}")
        # one-triangle storage is the contract (the MM spec says lower; we
        # accept either, but MIXED triangles would silently double every
        # mirrored weight after expansion + duplicate assembly)
        if (row > col).any() and (row < col).any():
            lo = int(np.nonzero(row > col)[0][0])
            up = int(np.nonzero(row < col)[0][0])
            raise _err(path, 1,
                       f"{symmetry!r} storage must hold ONE triangle, but "
                       f"both carry entries (lower: ({int(row[lo]) + 1}, "
                       f"{int(col[lo]) + 1}), upper: ({int(row[up]) + 1}, "
                       f"{int(col[up]) + 1})) — expanding would double "
                       f"mirrored weights")
        off = row != col
        if symmetry == "skew-symmetric":
            if (~off).any():
                k = int(np.nonzero(~off)[0][0])
                raise _err(path, 1, f"skew-symmetric file stores an explicit "
                                    f"diagonal entry ({int(row[k]) + 1}, "
                                    f"{int(col[k]) + 1}) — the diagonal is "
                                    f"implicitly zero")
            mirror_val = -val[off]
        elif symmetry == "hermitian":
            # A = A^H forces a real diagonal; a complex one is a malformed
            # file, not a representable matrix
            bad_diag = (~off) & (val.imag != 0.0)
            if bad_diag.any():
                k = int(np.nonzero(bad_diag)[0][0])
                raise _err(path, 1, f"hermitian diagonal entry "
                                    f"({int(row[k]) + 1}, {int(col[k]) + 1}) "
                                    f"has a nonzero imaginary part "
                                    f"({val[k].imag!r}) — A = A^H forces a "
                                    f"real diagonal")
            mirror_val = np.conj(val[off])
        else:
            mirror_val = val[off]
        row, col = (np.concatenate([row, col[off]]),
                    np.concatenate([col, row[off]]))
        val = np.concatenate([val, mirror_val])
        expanded = True
    return CooMatrix(nrows=size[0], ncols=size[1], row=row, col=col, val=val,
                     field=field, symmetry=symmetry, expanded=expanded)


def _fmt_value(v: float) -> str:
    # repr(float) is the shortest string that parses back to the same bits,
    # so the read -> write -> read round trip is exact
    return repr(float(v))


def write_mtx(path, row, col, val=None, shape=None, field: str | None = None,
              symmetry: str = "general", comment: str | None = None) -> None:
    """Write COO triples (0-based) as a Matrix Market coordinate file.

    ``val=None`` (or ``field="pattern"``) writes a pattern matrix. For
    symmetric/skew-symmetric output the caller passes one triangle — the
    entries are written exactly as given (matching how :func:`read_mtx`
    returns them under ``expand_symmetry=False``).
    """
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    if field is None:
        field = "pattern" if val is None else (
            "complex" if np.iscomplexobj(np.asarray(val)) else "real")
    if field not in FIELDS:
        raise MatrixMarketError(f"unsupported field {field!r}: expected one "
                                f"of {FIELDS}")
    if symmetry not in SYMMETRIES:
        raise MatrixMarketError(f"unsupported symmetry {symmetry!r}: "
                                f"expected one of {SYMMETRIES}")
    if symmetry == "hermitian" and field != "complex":
        raise MatrixMarketError(
            f"'hermitian' symmetry requires the 'complex' field (got "
            f"{field!r}) — read_mtx would reject the file")
    if field != "pattern":
        if val is None:
            raise MatrixMarketError(f"field {field!r} needs values")
        val = np.asarray(val)
        if val.shape != row.shape:
            raise MatrixMarketError(
                f"val shape {val.shape} != index shape {row.shape}")
        if not np.isfinite(val).all():
            k = int(np.nonzero(~np.isfinite(val))[0][0])
            raise MatrixMarketError(
                f"non-finite value {val[k]!r} at entry {k} — read_mtx "
                f"would reject the file")
        if field == "integer" and not np.all(val == np.trunc(val)):
            raise MatrixMarketError("field 'integer' needs integral values")
        if symmetry == "hermitian":
            bad = (row == col) & (np.asarray(val).imag != 0.0)
            if bad.any():
                k = int(np.nonzero(bad)[0][0])
                raise MatrixMarketError(
                    f"hermitian diagonal entry ({int(row[k]) + 1}, "
                    f"{int(col[k]) + 1}) has a nonzero imaginary part — "
                    f"read_mtx would reject the file")
    if shape is None:
        shape = (int(row.max()) + 1 if row.size else 0,
                 int(col.max()) + 1 if col.size else 0)
    nrows, ncols = (int(s) for s in shape)
    if row.size and (row.min() < 0 or col.min() < 0 or
                     row.max() >= nrows or col.max() >= ncols):
        raise MatrixMarketError(f"indices outside shape {nrows} x {ncols}")
    if symmetry != "general" and (row > col).any() and (row < col).any():
        raise MatrixMarketError(
            f"{symmetry!r} output must store ONE triangle, got entries in "
            f"both (read_mtx would reject the file)")

    out = [f"{BANNER} matrix coordinate {field} {symmetry}"]
    for line in (comment or "").splitlines():
        out.append(f"% {line}".rstrip())
    out.append(f"{nrows} {ncols} {row.shape[0]}")
    if field == "pattern":
        out.extend(f"{i + 1} {j + 1}" for i, j in zip(row, col))
    elif field == "integer":
        out.extend(f"{i + 1} {j + 1} {int(v)}"
                   for i, j, v in zip(row, col, val))
    elif field == "complex":
        out.extend(
            f"{i + 1} {j + 1} {_fmt_value(v.real)} {_fmt_value(v.imag)}"
            for i, j, v in zip(row, col, val))
    else:
        out.extend(f"{i + 1} {j + 1} {_fmt_value(v)}"
                   for i, j, v in zip(row, col, val))
    pathlib.Path(path).write_text("\n".join(out) + "\n")


def load_problem(path, transform="abs", capacity: int | None = None,
                 drop_zeros: bool = True, device=None):
    """Read ``path`` and build a :class:`repro_torch.core.MatchingProblem`
    on ``device`` (None: the card; ``"cpu"`` on the host).

    Pipeline: parse (+ symmetric/hermitian expansion) -> assemble
    duplicates by summation -> drop explicit / cancelled zeros (MC64
    treats them as non-edges, and the log-scaled metric is undefined on
    them) -> magnitude pre-transform for complex fields (matching weights
    are ``|a_ij|``; the complex values stay on the returned ``coo`` for
    the solver path) -> apply the weight ``transform`` (a name from
    :data:`repro_torch.data.weight_transforms.TRANSFORMS`, a callable
    ``(row, col, val, n) -> val``, or None for raw values) -> pad/sort via
    ``MatchingProblem.from_coo``.

    Returns ``(problem, coo)`` — the problem plus the parsed
    :class:`CooMatrix`. For real fields ``coo`` holds the file's values
    verbatim (pre-transform); for complex fields ``coo.val`` is
    complex128 after assembly, and only the matching-side weights are
    collapsed to magnitudes.
    """
    from repro_torch.core.api import MatchingProblem
    from repro_torch.data.weight_transforms import get_transform
    from repro_torch.sparse.csr import dedupe_coo_sum

    coo = read_mtx(path, expand_symmetry=True)
    if not coo.is_square:
        raise MatrixMarketError(
            f"{path}: perfect matching needs a square matrix, got "
            f"{coo.nrows} x {coo.ncols}")
    n = coo.nrows
    row, col, val = dedupe_coo_sum(coo.row, coo.col, coo.val, n_cols=n)
    if drop_zeros:
        keep = val != 0.0
        row, col, val = row[keep], col[keep], val[keep]
    if np.iscomplexobj(val):
        # magnitude pre-transform: the matching engine needs real weights,
        # the solver path keeps the complex values (returned on coo after
        # assembly so downstream consumers see what load_problem matched on)
        coo = dataclasses.replace(coo, row=row, col=col, val=val)
        weights = np.abs(val)
    else:
        weights = val
    if transform is not None:
        weights = get_transform(transform)(row, col, weights, n)
    problem = MatchingProblem.from_coo(row, col, weights, n,
                                       capacity=capacity, device=device)
    return problem, coo
