"""Data readers (counterpart of ``eftpipe_tpu/likelihood/reader.py``, upstream
eftpipe/reader.py:13-62), NumPy only.

``read_pkl`` reads a commented-header whitespace table into a
:class:`PklTable` (column names + a 2-D array, first column k), auto-naming
columns P0/P2/... when no header is present.
"""

from __future__ import annotations

import importlib
import numpy as np
from dataclasses import dataclass
from pathlib import Path


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


def read_pkl(path, names=None) -> PklTable:
    values = np.atleast_2d(np.loadtxt(path, comments="#"))
    if not names:
        with open(path) as f:
            header = f.readline()
        if header.startswith("#"):
            names = header[1:].strip().split()
    if not names:
        names = ["k"] + [f"P{2 * i}" for i in range(values.shape[1] - 1)]
    if len(names) != values.shape[1]:
        raise ValueError(
            f"{path}: {len(names)} column names for {values.shape[1]} columns")
    return PklTable(columns=list(names), values=values)


def find_reader(name: str | None, default, **kwargs):
    if not name or name == "default":
        return default
    module_name, fn_name = name.rsplit(".", 1)
    fn = getattr(importlib.import_module(module_name), fn_name)
    return lambda path: fn(path, **kwargs)


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
