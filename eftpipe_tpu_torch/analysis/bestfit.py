"""Bestfit theory reconstruction — the ``BestfitModel`` analogue
(counterpart of ``eftpipe_tpu/analysis/bestfit.py``; upstream
eftpipe/analysis.py:726-880).

Given a built :class:`~eftpipe_tpu_torch.api.orchestrate.Analysis` and a
chain (or an explicit parameter point), reconstructs the *full*
(un-marginalized) bestfit model: the analytically-marginalized gaussian EFT
parameters are restored from their conditional bestfit b_G = F2⁻¹F1 (the
likelihood's ``bg_bestfit`` output), and theory multipoles are evaluated per
tracer.  ``matplotlib`` is imported inside the plotting methods only.
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass, field
from typing import Any

from .multipole import Multipole


def _host(x) -> np.ndarray:
    return x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class BestfitModel:
    analysis: Any                       # api.orchestrate.Analysis
    theta: np.ndarray                   # bestfit sampled vector
    # evaluate the bestfit theory without the survey window / at a different
    # zeff (upstream analysis.py:726-734, 778-784): bG restoration and chi2
    # stay tied to the ORIGINAL windowed analysis, only the theory products
    # are served from the rebuilt variant
    remove_window: bool = False
    zeff: float | None = None
    params: dict = field(init=False)    # full named params incl. restored bG

    @classmethod
    def from_chains(cls, analysis, chains, **options) -> "BestfitModel":
        """Bestfit point from a ChainProducts (global fullchi2 rule when
        available, analysis.py:425-445).  Burn-in is applied where the chains
        are loaded (``ChainProducts.from_prefix(burn_in=...)``), not here."""
        best = chains.global_bestfit()
        theta = np.array([best[p] for p in analysis.space.sampled])
        return cls(analysis=analysis, theta=theta, **options)

    def _loglike(self) -> dict:
        with torch.no_grad():
            return self.analysis.loglike(np.asarray(self.theta, np.float64)[None])

    def __post_init__(self):
        space = self.analysis.space
        self.params = dict(space.fixed)
        for i, p in enumerate(space.sampled):
            self.params[p] = float(self.theta[i])
        likes = getattr(self.analysis, "likes", None) or (
            {"like": self.analysis.like} if self.analysis.like is not None else {}
        )
        if any(lk.marginal is not None for lk in likes.values()):
            # restore the marginalized parameters: bG = F2⁻¹ F1 (per block)
            blocks = self._loglike()["blocks"]
            for name, lk in likes.items():
                if lk.marginal is None:
                    continue
                bg = _host(blocks[name]["bg_bestfit"][0])
                for pname, value in zip(lk.marginal.names, bg):
                    self.params[pname] = float(value)
        self.eval_analysis = self.analysis
        if self.remove_window or self.zeff is not None:
            self.eval_analysis = self.analysis.rebuilt(
                remove_window=self.remove_window, zeff=self.zeff
            )

    # -- evaluation -----------------------------------------------------------
    def multipoles(self, tracer: str, chained: bool = False,
                   binned: bool = False, kout=None) -> Multipole:
        with torch.no_grad():
            ls, k, plk = self.eval_analysis.nonlinear_Plk_grid(
                tracer, self.params, chained=chained, binned=binned, kout=kout
            )
        return Multipole.from_arrays(np.asarray(k), _host(plk), ls)

    def interpolator(self, tracer: str, chained: bool = False):
        return self.eval_analysis.nonlinear_Plk_interpolator(
            tracer, self.params, chained=chained
        )

    # -- plotting (upstream analysis.py:826-880; gated matplotlib) ------------
    def plot_theory(self, tracer: str, ax=None, compact: bool = False,
                    k=None, **style):
        """Smooth bestfit multipole curves k·P_ell(k) on a fine grid."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        k = np.linspace(5e-4, 0.3, 1000) if k is None else np.asarray(k)
        itp = self.interpolator(tracer)
        with torch.no_grad():
            rows = np.stack([_host(itp(ell, k)) for ell in itp.ls])
        mp = Multipole.from_arrays(k, rows, itp.ls)
        return mp.plot_pk(ax=ax, compact=compact, **style)

    def plot(self, tracer: str, data: Multipole | None = None, cov=None,
             ax=None, compact: bool = False, **style):
        """Data points (with errorbars when ``cov`` given) + bestfit curves."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        if data is not None:
            data.plot_pk(ax=ax, compact=compact, cov=cov, **style)
        self.plot_theory(tracer, ax=ax, compact=compact, **style)
        ax.text(0.94, 0.90, tracer.replace("_", " "), fontsize=12,
                transform=ax.transAxes, ha="right", va="center")
        return ax

    def plot_component(self, tracer: str, ax=None):
        """|k·P| of the linear / loop / counterterm pieces separately."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        with torch.no_grad():
            ls, kraw, comp = self.eval_analysis.bird_component(tracer, self.params)
        k = np.asarray(kraw)
        for name, part in (("linear", comp.plin), ("loop", comp.ploop),
                           ("counter", comp.pct)):
            mp = Multipole.from_arrays(k, np.abs(_host(part)), ls)
            mp.plot_pk(ax=ax, label=name)
        ax.legend(frameon=False)
        ax.set_ylabel(r"$|kP_\ell(k)|$ $[h^{-1}\,\mathrm{Mpc}]^2$")
        return ax

    def chi2(self) -> dict:
        res = self._loglike()
        return {k: float(v[0]) for k, v in res.items() if isinstance(v, torch.Tensor)
                and v.dim() == 1}

    def eft_params(self, tracer: str) -> dict:
        return self.analysis.eft_params_values_dict(tracer, self.params)

    # -- synthetic data / covariance (upstream bestfit_reader /
    #    bestfit_cov_reader, reader.py:132-195) -------------------------------
    def write_data(self, tracer: str, path, kout, binned: bool = True):
        """Theory multipoles at the bestfit written as a data file."""
        mp = self.multipoles(tracer, binned=binned, kout=kout if binned else None)
        cols = [np.asarray(kout)] + [mp(ell) for ell in mp.ells]
        header = "k " + " ".join(f"P{ell}" for ell in mp.ells)
        np.savetxt(path, np.column_stack(cols), header=header)
        return mp

    def gaussian_covariance(self, tracer: str, kout, volume: float,
                            shot: float = 0.0, ells=None) -> np.ndarray:
        """Analytic Gaussian covariance around the bestfit theory (the
        bestfit_cov_reader pattern: unwindowed multipoles + shot noise fed to
        GaussianCovariance)."""
        from ..likelihood.covariance import GaussianCovariance, Multipole as CovMultipole

        kout = np.asarray(kout)
        mp = self.multipoles(tracer, binned=True, kout=kout)
        ells = list(ells or mp.ells)
        dk = kout[1] - kout[0]
        kedges = np.concatenate([kout - dk / 2.0, [kout[-1] + dk / 2.0]])
        gcov = GaussianCovariance(kedges, volume=volume)
        cmp = CovMultipole(
            p0=mp(0) + shot,
            p2=mp(2) if 2 in mp.ells else np.zeros_like(kout),
            p4=mp(4) if 4 in mp.ells else None,
        )
        return gcov(ells, ells, "aa->aaaa", cmp)
