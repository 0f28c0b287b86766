"""Cosmology input providers (counterpart of ``eftpipe_tpu/boltzmann/providers.py``).

The pipeline consumes :class:`~eftpipe_tpu_torch.models.pipeline.CosmoInputs`
(P_lin on the fixed kin grid, growth rate f, AP distortions), batched over
walkers.  Providers map named (W,) parameter tensors to those inputs:

* ``FixedTemplateProvider`` — the template-fit mode of upstream's
  ``LinearPowerFile`` (eftpipe/boltzmann.py:246-315): P_lin is fixed from
  disk (optionally rescaled by a sampled amplitude ``A``), and f, α⊥, α∥ are
  sampled directly.
* ``TabulatedProvider`` — per-evaluation P_lin / background passed in as
  tensors (a Boltzmann code run outside the port feeds a batch of tables).
* The on-device providers live in ``eh98.py`` and ``emulator.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass, field

from ..models.config import EFTConfig
from ..models.pipeline import CosmoInputs


def resample_loglog(kin_src, pin_src, kin_dst) -> np.ndarray:
    """Host: cubic interpolation of log P vs log k with power-law
    extrapolation (upstream boltzmann.py:262-276 equivalent)."""
    from scipy.interpolate import CubicSpline

    cs = CubicSpline(np.log(kin_src), np.log(pin_src), extrapolate=True)
    return np.exp(cs(np.log(kin_dst)))


def _param(params, name, default, like):
    """params[name] as a tensor like ``like`` (the default where absent); a
    number becomes a fill on the device, not a copy, which would synchronise
    the stream."""
    value = params.get(name, default)
    if not isinstance(value, torch.Tensor):
        return torch.full_like(like, float(value))
    return value.to(dtype=like.dtype, device=like.device).expand_as(like)


@dataclass
class FixedTemplateProvider:
    """Sampled params: f, alperp, alpara, and optionally a linear amplitude
    rescale ``A`` multiplying the template."""

    cfg: EFTConfig
    plin: np.ndarray  # on cfg.kin
    _plin: dict = field(default_factory=dict, repr=False)  # (device, dtype) → plin

    @classmethod
    def from_file(cls, cfg: EFTConfig, path, with_hubble_unit: bool = True,
                  h: float = 1.0) -> "FixedTemplateProvider":
        raw = np.loadtxt(path)
        k, p = raw[:, 0], raw[:, 1]
        if not with_hubble_unit:
            k, p = k / h, p * h**3
        return cls(cfg=cfg, plin=resample_loglog(k, p, cfg.kin))

    def inputs(self, params) -> CosmoInputs:
        f = params["f"]
        key = (f.device, f.dtype)
        if key not in self._plin:
            self._plin[key] = torch.as_tensor(self.plin, dtype=f.dtype, device=f.device)
        plin = self._plin[key]
        return CosmoInputs(
            plin=_param(params, "A", 1.0, f)[..., None] * plin,
            f=f,
            qperp=_param(params, "alperp", 1.0, f),
            qpar=_param(params, "alpara", 1.0, f),
        )


@dataclass
class TabulatedProvider:
    """Pass-through of externally computed tables: ``plin`` (W, nkin) on
    cfg.kin, ``f`` (W,), optional ``qperp``/``qpar`` (W,)."""

    cfg: EFTConfig
    da_fid: float | None = None
    h_fid: float | None = None

    def inputs(self, params) -> CosmoInputs:
        f = params["f"]
        return CosmoInputs(plin=params["plin"], f=f,
                           qperp=_param(params, "qperp", 1.0, f),
                           qpar=_param(params, "qpar", 1.0, f))
