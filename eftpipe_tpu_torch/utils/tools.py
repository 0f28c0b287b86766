"""Small host-side utilities (a copy of ``eftpipe_tpu/utils/tools.py``)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
import numpy as np
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Mapping


@contextlib.contextmanager
def timer(name: str = "block", logger: logging.Logger | None = None):
    """Wall-time context manager (tools.py:147-153)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f"{name}: {dt:.3f} s"
    (logger or logging.getLogger("eftpipe_tpu_torch")).info(msg)


@contextlib.contextmanager
def PathContext(path):
    """chdir guard (tools.py:209-216): relative data paths in configs resolve
    against the config's directory."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def group_lists(*lists) -> list:
    """Sorted union of multiple lists (tools.py:125)."""
    out: set = set()
    for x in lists:
        out.update(x)
    return sorted(out)


@dataclass
class RandomParams:
    """Multivariate-normal parameter sampler for randomized A/B tests
    (reference tools.py:227-351: draws around a reference covariance from a
    chain so comparison points are 'production-shaped').

    Parameters
    ----------
    mean : name → central value
    cov : (n, n) covariance over ``names`` (defaults to diag of ``scale``²)
    """

    mean: Mapping[str, float]
    cov: np.ndarray | None = None
    scale: Mapping[str, float] | None = None
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self.names = list(self.mean)
        n = len(self.names)
        if self.cov is None:
            sig = np.array([
                (self.scale or {}).get(p, 0.1 * max(abs(self.mean[p]), 1.0))
                for p in self.names
            ])
            self.cov = np.diag(sig**2)
        self.cov = np.asarray(self.cov, dtype=np.float64)
        if self.cov.shape != (n, n):
            raise ValueError(f"cov shape {self.cov.shape} != ({n}, {n})")
        self._rng = np.random.default_rng(self.seed)

    @classmethod
    def from_covmat_file(cls, path, mean: Mapping[str, float] | None = None,
                         seed: int = 0) -> "RandomParams":
        """Load a Cobaya-style .covmat (header line '# name1 name2 ...')."""
        path = Path(path)
        with open(path) as f:
            header = f.readline().lstrip("#").split()
        cov = np.atleast_2d(np.loadtxt(path))
        if mean is None:
            mean = {p: 0.0 for p in header}
        return cls(mean={p: mean.get(p, 0.0) for p in header}, cov=cov, seed=seed)

    def draw(self, n: int | None = None):
        """One dict (n=None) or a list of dicts of sampled parameter values."""
        mu = np.array([self.mean[p] for p in self.names])
        x = self._rng.multivariate_normal(mu, self.cov, size=n or 1)
        rows = [dict(zip(self.names, row)) for row in x]
        return rows[0] if n is None else rows
