"""Analytic marginalization over linearly-entering EFT parameters
(counterpart of ``eftpipe_tpu/likelihood/marginal.py``; upstream
eftpipe/marginal.py:31-232):

    F2_ij = PG_i C⁻¹ PG_j + Σ⁻¹_ij
    F1_i  = -PG_i C⁻¹ (PNG - D) + Σ⁻¹_ij µ_j
    F0    = (PNG - D) C⁻¹ (PNG - D) + µ Σ⁻¹ µ
    -2 ln P = -F1 F2⁻¹ F1 + F0 + ln det(F2 / 2π)   (logdet dropped for Jeffreys)

Batched over walkers: ``pg`` is (W, nmarg, ndata), ``png`` (W, ndata); the
solves and log-determinants are batched ``torch.linalg`` calls on
(nmarg × nmarg) systems.  Prior locations/scales are floats, callables of
the parameter dict, or strings that evaluate to such callables (upstream's
``eval_callable`` pattern, marginal.py:13-19), parsed against the AST
whitelist of ``utils/safe_expr.py``.
"""

from __future__ import annotations

import inspect
import math
import numpy as np
import torch
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping


def _compile_prior_entry(x) -> Callable[[Mapping], Any] | float:
    if x is None:
        return 0.0
    if isinstance(x, str):
        from ..utils.safe_expr import safe_eval_expr

        fn = safe_eval_expr(x)
        argnames = inspect.getfullargspec(fn).args
        return lambda params: fn(*(params[a] for a in argnames))
    if callable(x):
        return x
    return float(x)


@dataclass
class MarginalSetup:
    """Ordered prior over the marginalized (gaussian) parameters."""

    names: list[str]
    locs: list[Any]
    scales: list[Any]
    jeffreys: bool = False
    # constant entries as tensors, made once per (value, device, dtype): a
    # number put on the card per call is a copy that synchronises the stream
    _consts: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_config(cls, prior: Mapping[str, Mapping | None], ordering: list[str],
                    jeffreys: bool = False) -> "MarginalSetup":
        """``prior`` maps param name -> {loc, scale}; sorted by ``ordering``
        (marginal.py:198-232)."""
        for name in prior:
            if name not in ordering:
                raise ValueError(f"parameter {name!r} is not marginalizable")
        items = sorted(prior.items(), key=lambda kv: ordering.index(kv[0]))
        names, locs, scales = [], [], []
        for name, cfgd in items:
            cfgd = cfgd or {}
            loc = cfgd.get("loc")
            scale = cfgd.get("scale")
            if scale is None or scale == np.inf:
                scale = np.inf
            names.append(name)
            locs.append(_compile_prior_entry(loc))
            scales.append(scale if scale == np.inf else _compile_prior_entry(scale))
        return cls(names=names, locs=locs, scales=scales, jeffreys=jeffreys)

    @property
    def nmarg(self) -> int:
        return len(self.names)

    def mu_sigma_inv(self, params: Mapping, like):
        """(µ_G, Σ⁻¹): µ (..., nmarg), Σ⁻¹ (..., nmarg, nmarg), on the device
        and in the dtype of ``like``; entries that are callables of the
        parameters carry the walker axis (marginal.py:60-77)."""
        def value(entry):
            if callable(entry):
                return torch.as_tensor(entry(params), dtype=like.dtype, device=like.device)
            key = (entry, like.device, like.dtype)
            if key not in self._consts:
                self._consts[key] = torch.as_tensor(entry, dtype=like.dtype, device=like.device)
            return self._consts[key]

        mu = torch.stack(torch.broadcast_tensors(*[value(loc) for loc in self.locs]), dim=-1)
        # upstream parity (marginal.py:69-77): a single infinite scale zeroes
        # the ENTIRE prior matrix — any mix of finite/infinite is accepted
        if any(isinstance(s, float) and math.isinf(s) for s in self.scales):
            sigma_inv = mu.new_zeros(mu.shape + (self.nmarg,))
        else:
            inv = torch.stack(torch.broadcast_tensors(
                *[1.0 / value(s) ** 2 for s in self.scales]), dim=-1)
            sigma_inv = torch.diag_embed(inv)
        return mu, sigma_inv


def _f2_f1_f0(pg, png, invcov, data, mu, sigma_inv):
    res = png - data                              # (W, ndata)
    pgc = pg @ invcov                             # (W, nmarg, ndata)
    f2 = pgc @ pg.transpose(-1, -2) + sigma_inv
    f1 = -(pgc @ res[..., None])[..., 0] + (sigma_inv @ mu[..., None])[..., 0]
    f0 = torch.einsum("...i,ij,...j->...", res, invcov, res) + torch.einsum(
        "...i,...ij,...j->...", mu, sigma_inv, mu)
    return f2, f1, f0


def _solve(f2, f1):
    # solve_ex: a singular F2 yields inf/NaN for the guard below, not a raise
    return torch.linalg.solve_ex(f2, f1[..., None], check_errors=False).result[..., 0]


def marginalized_logp(pg, png, invcov, data, mu, sigma_inv, jeffreys: bool = False):
    """Marginalized log-posterior (marginal.py:79-127), batched.

    Returns (logp, fullchi2, bg_best): the chi² at the analytic best-fit
    nuisance values and those values themselves come for free.
    """
    f2, f1, f0 = _f2_f1_f0(pg, png, invcov, data, mu, sigma_inv)
    sign, logdet = torch.linalg.slogdet(f2 / (2.0 * math.pi))
    bg_best = _solve(f2, f1)
    chi2 = -(f1 * bg_best).sum(-1) + f0
    if not jeffreys:
        chi2 = chi2 + logdet
    res_full = (bg_best[..., None, :] @ pg)[..., 0, :] + png - data
    fullchi2 = torch.einsum("...i,ij,...j->...", res_full, invcov, res_full)
    # upstream raises on a non-positive-definite F2 (marginal.py:110-116);
    # here a degenerate PG matrix rejects the walker with -inf instead of
    # poisoning the chain with NaNs.  The isfinite clause catches the
    # near-singular case where rounding leaves sign > 0 but the solve already
    # produced inf/NaN.
    ok = (sign > 0) & torch.isfinite(chi2)
    logp = torch.where(ok, -0.5 * chi2, torch.full_like(chi2, -math.inf))
    return logp, fullchi2, bg_best


def bg_bestfit(pg, png, invcov, data, mu, sigma_inv):
    """Analytic best-fit of the marginalized parameters (marginal.py:155-165)."""
    f2, f1, _ = _f2_f1_f0(pg, png, invcov, data, mu, sigma_inv)
    return _solve(f2, f1)
