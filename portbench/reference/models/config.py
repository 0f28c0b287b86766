"""Static configuration of the EFT pipeline (the ``Common`` analogue).

Everything in :class:`EFTConfig` is known before any evaluation: grid sizes, number
of multipoles, counterterm convention, cross-spectrum normalisations.  The
config is hashable so it can key the Phase-A table cache and be passed freely
to the ``build_*`` functions.

Mirrors upstream pybird/pybird.py:486-585.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field, replace
from functools import cached_property


def kbird_grid(kmax: float = 0.3) -> np.ndarray:
    """Internal k grid [h/Mpc] on which multipoles are evaluated
    (pybird.py:472-479)."""
    base = np.array([0.001, 0.005, 0.0075, 0.01, 0.0125, 0.015, 0.0175, 0.02])
    if kmax > 0.30:
        ext = np.arange(base[-1], kmax + 1e-3, 0.005)
        return np.concatenate([base, ext[1:]])
    # fixed 50-point grid used for all kmax <= 0.3 (pybird.py:478-479)
    return np.array([
        0.001, 0.005, 0.0075, 0.01, 0.0125, 0.015, 0.0175, 0.02, 0.025, 0.03,
        0.035, 0.04, 0.045, 0.05, 0.055, 0.06, 0.065, 0.07, 0.075, 0.08, 0.085,
        0.09, 0.095, 0.1, 0.105, 0.11, 0.115, 0.12, 0.125, 0.13, 0.135, 0.14,
        0.145, 0.15, 0.155, 0.16, 0.17, 0.18, 0.19, 0.2, 0.21, 0.22, 0.23,
        0.24, 0.25, 0.26, 0.27, 0.28, 0.29, 0.3,
    ])


# internal s grid [Mpc/h] for the correlation-function side (pybird.py:481-482)
SBIRD = np.array([
    1.000e+00, 1.124e+00, 1.264e+00, 1.421e+00, 1.597e+00, 1.796e+00, 2.019e+00,
    2.270e+00, 2.551e+00, 2.868e+00, 3.225e+00, 3.625e+00, 4.075e+00, 4.582e+00,
    5.151e+00, 5.790e+00, 6.510e+00, 7.318e+00, 8.227e+00, 9.249e+00, 1.040e+01,
    1.169e+01, 1.314e+01, 1.477e+01, 1.661e+01, 1.867e+01, 2.099e+01, 2.360e+01,
    2.653e+01, 2.982e+01, 3.353e+01, 3.769e+01, 4.238e+01, 4.764e+01, 5.356e+01,
    6.000e+01, 6.021e+01, 6.526e+01, 6.769e+01, 7.053e+01, 7.579e+01, 7.609e+01,
    8.105e+01, 8.555e+01, 8.632e+01, 9.158e+01, 9.617e+01, 9.684e+01, 1.021e+02,
    1.074e+02, 1.081e+02, 1.126e+02, 1.179e+02, 1.215e+02, 1.232e+02, 1.284e+02,
    1.337e+02, 1.366e+02, 1.389e+02, 1.442e+02, 1.495e+02, 1.536e+02, 1.547e+02,
    1.600e+02, 1.727e+02, 1.941e+02, 2.183e+02, 2.454e+02, 2.759e+02, 3.101e+02,
    3.486e+02, 3.919e+02, 4.406e+02, 4.954e+02, 5.569e+02, 6.261e+02, 7.038e+02,
    7.912e+02, 8.895e+02, 1.000e+03,
])


@dataclass(frozen=True)
class EFTConfig:
    """Static shape/convention hub shared by all pipeline stages."""

    nl: int = 2            # number of internal multipoles (ℓ = 0, 2, ...)
    no: int = 2            # number of output multipoles (no ≤ nl)
    kmax: float = 0.3
    optiresum: bool = False
    with_nnlo: bool = False
    counterform: str = "westcoast"  # or "eastcoast"
    # counterterm / stochastic normalisations; B-variants for cross spectra
    km_a: float = 0.7
    kr_a: float = 0.25
    nd_a: float = 3e-4
    km_b: float | None = None
    kr_b: float | None = None
    nd_b: float | None = None
    # IR cutoff handling ("all" | "loop" | "resum" | False)
    ir_cutoff: str | bool = False
    k_ir: float | None = None
    # FFTLog sizes
    nfft_loop: int = 256
    nfft_resum: int = 192
    nfft_irfilter: int = 32
    # fixed input grid for the linear power spectrum (theory.py:562)
    kin_min: float = 1e-5
    kin_max: float = 1.0
    nkin: int = 200

    # structure counts (pybird.py:545-550)
    n11: int = field(default=3, init=False)
    nct: int = field(default=6, init=False)
    nct_nnlo: int = field(default=3, init=False)
    n22: int = field(default=28, init=False)
    n13: int = field(default=10, init=False)
    nloop: int = field(default=12, init=False)

    def __post_init__(self):
        if self.no > self.nl:
            raise ValueError("no must be <= nl")
        if self.counterform not in ("westcoast", "eastcoast"):
            raise ValueError(f"unknown counterform {self.counterform!r}")
        if self.ir_cutoff and self.k_ir is None:
            raise ValueError("k_ir must be set when ir_cutoff is enabled")
        if self.ir_cutoff is True:
            object.__setattr__(self, "ir_cutoff", "all")
        for name, a in (("km_b", self.km_a), ("kr_b", self.kr_a), ("nd_b", self.nd_a)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, a)

    # -- grids (cached, derived) -------------------------------------------
    @cached_property
    def k(self) -> np.ndarray:
        return kbird_grid(self.kmax)

    @cached_property
    def s(self) -> np.ndarray:
        if self.optiresum:
            return np.arange(70.0, 200.0, 2.5)
        return SBIRD.copy()

    @cached_property
    def kin(self) -> np.ndarray:
        """Fixed input grid for P_lin (log-spaced; theory.py:562)."""
        return np.logspace(np.log10(self.kin_min), np.log10(self.kin_max), self.nkin)

    @property
    def nk(self) -> int:
        return self.k.size

    @property
    def ns(self) -> int:
        return self.s.size

    @cached_property
    def nklow(self) -> int:
        """Number of leading k-grid rows excluded from IR corrections
        (k < 0.02; pybird.py:558-560)."""
        return int(np.sum(self.k < 0.02))

    @property
    def kr(self) -> np.ndarray:
        return self.k[self.nklow:]

    def with_updates(self, **kw) -> "EFTConfig":
        return replace(self, **kw)

    def cache_key(self) -> str:
        import hashlib
        import json

        payload = {k: v for k, v in self.__dict__.items() if not k.startswith("_")}
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]
