"""Data readers (counterpart of ``eftpipe_tpu/likelihood/reader.py``, upstream
eftpipe/reader.py:13-131), NumPy only: the JAX package reads through pandas,
which the port does not need.

``read_pkl`` reads a commented-header whitespace table into a
:class:`PklTable` (column names + a 2-D array, first column k), auto-naming
columns P0/P2/... when no header is present.  ``average_reader`` and
``mock_cov_reader`` average mock measurements into a data vector and their
sample covariance.  Custom readers are resolved by dotted path.
"""

from __future__ import annotations

import glob as _glob
import importlib
import numpy as np
from dataclasses import dataclass
from pathlib import Path


class NoHeaderError(ValueError):
    pass


@dataclass
class PklTable:
    """Columns of a multipole file; ``k`` is the first column."""

    columns: list[str]
    values: np.ndarray  # (nrows, ncols)

    @property
    def k(self) -> np.ndarray:
        return self.values[:, 0]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]


def read_commented_csv(path, names=None) -> PklTable:
    """A whitespace table whose column names come from ``names`` or from a
    leading ``#`` header line; :class:`NoHeaderError` when neither names
    them."""
    if not names:
        with open(path) as f:
            header = f.readline()
        if header.startswith("#"):
            names = header[1:].strip().split()
    if not names:
        raise NoHeaderError(f"no commented header found in {path}")
    values = np.atleast_2d(np.loadtxt(path, comments="#"))
    if len(names) != values.shape[1]:
        raise ValueError(
            f"{path}: {len(names)} column names for {values.shape[1]} columns")
    return PklTable(columns=list(names), values=values)


def read_pkl(path, names=None) -> PklTable:
    try:
        return read_commented_csv(path, names=names)
    except NoHeaderError:
        ncols = np.atleast_2d(np.loadtxt(path)).shape[1]
        names = ["k"] + [f"P{2 * i}" for i in range(ncols - 1)]
        return read_commented_csv(path, names=names)


def find_reader(name: str | None, default, **kwargs):
    if not name or name == "default":
        return default
    module_name, fn_name = name.rsplit(".", 1)
    fn = getattr(importlib.import_module(module_name), fn_name)
    return lambda path: fn(path, **kwargs)


def _files(paths) -> list:
    if isinstance(paths, (str, Path)):
        return sorted(_glob.glob(str(paths)))
    return list(paths)


def average_reader(paths, **kwargs) -> PklTable:
    """Mean multipoles over a set of mock files — the ``elephant_reader``
    pattern (upstream reader.py:65-131: average EZmock measurements into a
    data vector).  ``paths``: list of files or a glob pattern."""
    paths = _files(paths)
    if not paths:
        raise FileNotFoundError("average_reader: no files matched")
    tables = [read_pkl(p, **kwargs) for p in paths]
    first = tables[0]
    total = first.values.copy()
    for t in tables[1:]:
        if not np.allclose(t.k, first.k):
            raise ValueError("average_reader: mock files have different k grids")
        total += t.values
    total /= len(tables)
    total[:, 0] = first.k
    return PklTable(columns=list(first.columns), values=total)


def mock_cov_reader(paths, ls=None, rescale_mean: float = 1.0, **kwargs):
    """Sample covariance of the flattened (ℓ-stacked) multipole vectors over
    mock files — the ``elephant_cov_reader`` pattern (reader.py:65-131).

    Returns (cov, nmocks); feed nmocks as ``Nreal`` for the Hartlap factor.
    """
    paths = _files(paths)
    if len(paths) < 2:
        raise ValueError("mock_cov_reader needs at least two mock files")
    vecs = []
    for p in paths:
        table = read_pkl(p, **kwargs)
        cols = table.columns[1:]
        if ls is not None:
            cols = [f"{cols[0][0]}{ell}" for ell in ls]
        vecs.append(np.hstack([table[c] for c in cols]))
    x = np.stack(vecs)
    cov = np.cov(x, rowvar=False) / rescale_mean
    return cov, x.shape[0]


def load_covariance(spec) -> tuple[np.ndarray, dict]:
    """Covariance from a path / list of paths / config dict
    (upstream likelihood.py:337-363).  Returns (cov, options)."""
    from scipy.linalg import block_diag

    if not isinstance(spec, dict):
        spec = {"path": spec}
    reader = find_reader(spec.get("reader"), np.loadtxt, **spec.get("reader_kwargs", {}))
    path = spec["path"]
    if isinstance(path, (list, tuple)):
        cov = block_diag(*[reader(Path(p)) for p in path])
    else:
        cov = reader(Path(path))
    return np.asarray(cov, dtype=np.float64), spec
