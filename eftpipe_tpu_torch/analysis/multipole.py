"""Multipole container with covariance-aware errorbars — the ``Multipole``
analogue (counterpart of ``eftpipe_tpu/analysis/multipole.py``; upstream
eftpipe/analysis.py:457-698), NumPy in place of pandas: an x grid (k or s)
and named columns (``P0``/``P2``/... or ``xi0``/..., errorbars as
``<symbol><ell>err``).

Handles both Fourier-space P_ell(k) and configuration-space xi_ell(s)
products: the x-axis semantics are inferred the way upstream does
(``maybe_power_spectrum``, analysis.py:564-569), and ``plot`` dispatches to
the k·P / k^1.5·P or the s²·xi style (analysis.py:581-647).  ``matplotlib``
is imported inside the plotting methods only.
"""

from __future__ import annotations

import copy
import re
import numpy as np
from dataclasses import dataclass, field


# Per-ell matplotlib kwargs: {"line": {...}, "errorbar": {...}} keyed by ell,
# plus a "default" entry merged under every ell (analysis.py:59-102 pattern).
STYLES: dict[str, dict] = {
    "classical": {
        0: {"line": {"c": "k"}, "errorbar": {"c": "k"}},
        2: {"line": {"c": "b"}, "errorbar": {"c": "b"}},
        4: {"line": {"c": "g"}, "errorbar": {"c": "g"}},
        "default": {"line": {}, "errorbar": {"fmt": ".", "capsize": 2}},
    },
    "modern": {
        0: {"line": {"c": "#b2432f"},
            "errorbar": {"fmt": "o", "c": "#b2432f", "mfc": "#edb152"}},
        2: {"line": {"c": "#3c6e9f"},
            "errorbar": {"fmt": "D", "c": "#3c6e9f", "mfc": "#86c3ee"}},
        4: {"line": {"c": "#6f6f6f"},
            "errorbar": {"fmt": "s", "c": "#6f6f6f", "mfc": "#cccccc"}},
        "default": {"line": {"alpha": 0.75},
                    "errorbar": {"capsize": 1.5, "markersize": 4}},
    },
}


def resolve_style(style, **overrides) -> dict:
    """A style name or dict -> per-ell kwargs with "default" merged in and
    ``overrides`` applied on top (update_style analogue, analysis.py:104-115)."""
    style = copy.deepcopy(STYLES.get(style, style) if isinstance(style, str)
                          else (style or STYLES["modern"]))
    base = style.pop("default", {"line": {}, "errorbar": {}})
    for kind in ("line", "errorbar"):
        base.setdefault(kind, {})
        base[kind].update(overrides)
    resolved = {}
    for ell, element in style.items():
        resolved[ell] = {
            kind: {**base[kind], **element.get(kind, {})}
            for kind in ("line", "errorbar")
        }
    resolved["default"] = base
    return resolved


@dataclass
class Multipole:
    x: np.ndarray                       # the k (or s) grid
    columns: dict = field(default_factory=dict)  # name → (nx,) column
    symbol: str = "P"
    style: dict | str = "modern"
    xname: str = "k"

    # -- construction ------------------------------------------------------
    @classmethod
    def from_arrays(cls, k, plk, ls, symbol: str = "P", style="modern") -> "Multipole":
        cols = {f"{symbol}{ell}": np.asarray(plk)[i] for i, ell in enumerate(ls)}
        return cls(x=np.asarray(k), columns=cols, symbol=symbol, style=style,
                   xname="k" if symbol == "P" else "s")

    @classmethod
    def loadtxt(cls, path, cov_path=None, symbol: str | None = None,
                style="modern") -> "Multipole":
        from ..likelihood.reader import read_pkl

        table = read_pkl(path)
        cols = {name: table[name] for name in table.columns[1:]}
        sym = symbol or cls._infer_symbol(cols)
        mp = cls(x=table.k, columns=cols, symbol=sym, style=style, xname=table.columns[0])
        if cov_path is not None:
            mp.apply_covariance(np.loadtxt(cov_path))
        return mp

    @staticmethod
    def _infer_symbol(names) -> str:
        """Most common alphabetic prefix of ``<letters><digits>`` columns
        (infer_symbol_and_ells analogue, analysis.py:498-508)."""
        pat = re.compile(r"([A-Za-z]+)(\d+)$")
        counts: dict[str, int] = {}
        for name in names:
            if m := pat.match(str(name)):
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        return max(counts, key=counts.get) if counts else "P"

    # -- introspection -------------------------------------------------------
    @property
    def k(self) -> np.ndarray:
        return self.x

    @property
    def s(self) -> np.ndarray:
        """Configuration-space alias of the x grid."""
        return self.x

    @property
    def ells(self) -> list[int]:
        out = []
        for c in self.columns:
            if c.startswith(self.symbol) and c[len(self.symbol):].isdigit():
                out.append(int(c[len(self.symbol):]))
        return sorted(out)

    def __call__(self, ell: int) -> np.ndarray:
        return self.columns[f"{self.symbol}{ell}"]

    def err(self, ell: int) -> np.ndarray | None:
        return self.columns.get(f"{self.symbol}{ell}err")

    def data_vector(self) -> np.ndarray:
        return np.concatenate([self(ell) for ell in self.ells])

    def maybe_power_spectrum(self) -> bool:
        """Fourier heuristic (analysis.py:564-569): a "P" symbol, or an x
        grid that never extends past 10."""
        return self.symbol == "P" or float(self.x.max()) < 10.0

    # -- covariance → errorbars (analysis.py:571-578) -------------------------
    def errorbars(self, cov: np.ndarray) -> dict[int, np.ndarray]:
        """Split a joint (nl·nk × nl·nk) covariance diagonal per multipole."""
        sig = np.sqrt(np.diag(np.asarray(cov)))
        nk = self.x.size
        return {ell: sig[i * nk:(i + 1) * nk] for i, ell in enumerate(self.ells)}

    def apply_covariance(self, cov: np.ndarray) -> "Multipole":
        """Store per-ell errorbars as ``<symbol><ell>err`` columns."""
        for ell, sig in self.errorbars(cov).items():
            self.columns[f"{self.symbol}{ell}err"] = sig
        return self

    # -- persistence ---------------------------------------------------------
    def savetxt(self, path, fmt: str = "%.18e") -> None:
        cols = [self.x] + list(self.columns.values())
        header = " ".join([self.xname or "k"] + list(self.columns))
        np.savetxt(path, np.column_stack(cols), header=header, fmt=fmt)

    # -- plotting (gated matplotlib) ------------------------------------------
    def _draw(self, ax, ell, x, y, yerr, style, label):
        kw = style.get(ell, style["default"])
        extra = {"label": label} if label and ell == min(self.ells) else {}
        if yerr is None:
            ax.plot(x, y, **{k: v for k, v in kw["line"].items()
                             if k != "fmt"}, **extra)
        else:
            ax.errorbar(x, y, yerr=yerr, **kw["errorbar"], **extra)

    def plot_pk(self, ax=None, label=None, compact: bool = False,
                cov=None, **overrides):
        """Fourier style: k·P_ell (or k^1.5·P_ell when ``compact``,
        analysis.py:590-612)."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        if cov is not None:
            self.apply_covariance(cov)
        style = resolve_style(self.style, **overrides)
        k = self.k
        w = k ** 1.5 if compact else k
        for ell in reversed(self.ells):
            yerr = self.err(ell)
            self._draw(ax, ell, k, w * self(ell),
                       None if yerr is None else w * yerr, style, label)
        ax.set_xlabel(r"$k$ $[h\,\mathrm{Mpc}^{-1}]$")
        ax.set_ylabel(
            rf"$k^{{3/2}}{self.symbol}_\ell(k)$ $[h^{{-1}}\,\mathrm{{Mpc}}]^{{3/2}}$"
            if compact else
            rf"$k\,{self.symbol}_\ell(k)$ $[h^{{-1}}\,\mathrm{{Mpc}}]^2$")
        return ax

    def plot_xi(self, ax=None, label=None, cov=None, **overrides):
        """Configuration style: s²·xi_ell(s) (analysis.py:615-630)."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        if cov is not None:
            self.apply_covariance(cov)
        style = resolve_style(self.style, **overrides)
        s = self.s
        for ell in reversed(self.ells):
            yerr = self.err(ell)
            self._draw(ax, ell, s, s ** 2 * self(ell),
                       None if yerr is None else s ** 2 * yerr, style, label)
        ax.set_xlabel(r"$s$ $[h^{-1}\,\mathrm{Mpc}]$")
        ax.set_ylabel(rf"$s^2{self.symbol}_\ell(s)$ $[h^{{-1}}\,\mathrm{{Mpc}}]^2$")
        return ax

    def plot(self, ax=None, label=None, compact: bool = False, cov=None,
             **overrides):
        """Dispatch on the x-axis semantics (analysis.py:632-647)."""
        if self.maybe_power_spectrum():
            return self.plot_pk(ax, label, compact=compact, cov=cov, **overrides)
        return self.plot_xi(ax, label, cov=cov, **overrides)
