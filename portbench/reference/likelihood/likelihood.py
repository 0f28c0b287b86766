"""Multi-tracer Gaussian EFT likelihood with analytic marginalization
(counterpart of ``eftpipe_tpu/likelihood/likelihood.py``).

Host-side initialisation mirrors upstream ``EFTLike``
(eftpipe/likelihood.py:275-615): per-tracer multipole data loading with
per-ℓ k-masks, block-diagonal covariance assembly with rescale + Hartlap
correction and joint masking, and the bookkeeping that groups the
marginalized (gaussian) parameters across tracers.  The per-evaluation path —
theory vectors, ∂P/∂b_G tables, χ² or marginalized log-posterior — runs on a
walker batch: every parameter is a (W,) tensor, the result is (W,).
A tracer's product may be binned, chained, or unbinned and interpolated in
k·P onto the data's k (``with_interp``, one constant matrix per tracer).
"""

from __future__ import annotations

import re
import numpy as np
import torch
from dataclasses import dataclass, field
from typing import Any, Mapping

from ..models.pipeline import TracerPipeline, CosmoInputs
from ..ops.interp import spline_matrix
from ..ops.precision import stage_precision
from .parambasis import BirdComponent
from .marginal import MarginalSetup, marginalized_logp
from .reader import read_pkl, find_reader, load_covariance


def extract_multipole_info(names) -> tuple[str, list[int]]:
    """Infer the multipole symbol and available ells from column names
    (likelihood.py:48-62)."""
    pattern = re.compile(r"^([A-Za-z]+)(\d+)$")
    symbols, ells = set(), []
    for x in names:
        if m := pattern.match(x):
            s, e = m.groups()
            symbols.add(s)
            ells.append(int(e))
    if len(symbols) != 1:
        raise ValueError(f"could not infer a unique multipole symbol from {names}")
    return symbols.pop(), sorted(ells)


def _bound_list(x, n: int, default: float) -> list[float]:
    if x is None:
        return [default] * n
    if isinstance(x, (int, float)):
        return [float(x)] * n
    if len(x) != n:
        raise ValueError(f"bound length {len(x)} does not match {n} multipoles")
    return [float(v) for v in x]


def parse_kmask(kall, ells, kmin, kmax) -> dict[int, slice]:
    """Per-ℓ k-selection slices (likelihood.py:78-113)."""
    kall = np.asarray(kall)
    kmins = _bound_list(kmin, len(ells), -1.0)
    kmaxs = _bound_list(kmax, len(ells), 1e10)
    out = {}
    for ell, lo, hi in zip(sorted(ells), kmins, kmaxs):
        out[ell] = slice(
            int(np.searchsorted(kall, lo)), int(np.searchsorted(kall, hi, side="right"))
        )
    return out


def mask_covariance(cov: np.ndarray, *args) -> np.ndarray:
    """Joint per-tracer masking of the covariance (likelihood.py:122-160).

    args: repeated (ls, ls_tot, kall, kmin, kmax) per tracer.
    """
    mask1d = np.array([], dtype=bool)
    rest = list(args)
    while rest:
        ls, ls_tot, kall, kmin, kmax, *rest = rest
        kmask = parse_kmask(kall, ls, kmin, kmax)
        mask = np.zeros((len(ls_tot), len(kall)), dtype=bool)
        for i, ell in enumerate(ls_tot):
            if ell in kmask:
                mask[i, kmask[ell]] = True
        mask1d = np.hstack([mask1d, mask.ravel()])
    if cov.shape[0] != mask1d.size:
        raise ValueError(
            f"covariance shape {cov.shape} does not match data layout ({mask1d.size})"
        )
    return cov[np.ix_(mask1d, mask1d)]


def hartlap(nreal: int, ndata: int) -> float:
    """Inverse-covariance debiasing factor (likelihood.py:163-164)."""
    return (nreal - ndata - 2) / (nreal - 1)


def regularize_prior(prior: Mapping[str, Any]) -> dict[str, Any]:
    """Accept both flat ``name: {loc, scale}`` and nested
    ``prefix: {name: {loc, scale}}`` forms (likelihood.py:198-224)."""
    out: dict[str, Any] = {}
    for p, cfg in prior.items():
        if cfg is None or (isinstance(cfg, dict) and ("loc" in cfg or "scale" in cfg)):
            out[p] = cfg
        elif isinstance(cfg, dict):
            for name, sub in cfg.items():
                out[f"{p}{name}"] = sub
        else:
            raise ValueError(f"invalid prior config for {p!r}: {cfg!r}")
    return out


@dataclass
class TracerSpec:
    pipeline: TracerPipeline
    basis: Any
    data: dict
    chained: bool = False
    with_binning: bool = True
    with_interp: bool = False
    binning: dict = field(default_factory=dict)


@dataclass
class _TracerRuntime:
    spec: TracerSpec
    ls: list[int]
    ls_tot: list[int]
    kall: np.ndarray
    kmin: Any
    kmax: Any
    kout: np.ndarray
    data_vector: np.ndarray
    rows: np.ndarray  # flatten gather rows into the product plk
    cols: np.ndarray  # flatten gather cols
    binning_tables: dict | None
    interp_png: np.ndarray | None = None  # (nkout, nk) matrix acting on k·P
    interp_pg: np.ndarray | None = None


class EFTLikelihood:
    """Multi-tracer likelihood over pre-built tracer pipelines; lives on the
    device and in the dtype of its pipelines."""

    def __init__(
        self,
        tracers: Mapping[str, TracerSpec],
        cov,
        marg: Mapping[str, Any] | None = None,
        jeffreys: bool = False,
    ):
        self.tracers = dict(tracers)
        self.runtimes: dict[str, _TracerRuntime] = {}
        pieces = []
        cov_args: tuple = ()
        for name, spec in self.tracers.items():
            rt = self._load_tracer(name, spec)
            self.runtimes[name] = rt
            pieces.append(rt.data_vector)
            cov_args += (rt.ls, rt.ls_tot, rt.kall, rt.kmin, rt.kmax)
        self.data_vector = np.hstack(pieces)
        self.ndata = self.data_vector.size
        offsets = np.cumsum([0] + [rt.data_vector.size for rt in self.runtimes.values()])
        self.segments = {
            name: (int(offsets[i]), int(offsets[i + 1]))
            for i, name in enumerate(self.runtimes)
        }

        full_cov, cov_opts = load_covariance(cov)
        full_cov = full_cov / cov_opts.get("rescale", 1)
        self.hartlap: float | None = None
        if (nreal := cov_opts.get("Nreal")) is not None:
            self.hartlap = hartlap(nreal, self.ndata)
            full_cov = full_cov / self.hartlap
        self.full_covmat = full_cov
        masked = mask_covariance(full_cov, *cov_args)
        self.invcov = np.linalg.inv(masked)
        self.covmat = masked

        self.jeffreys = jeffreys
        self.marginal: MarginalSetup | None = None
        self._bg_groups: dict[str, list[str]] = {}
        self._bg_index: dict[str, int] = {}
        if marg:
            prior = regularize_prior(marg)
            ordering: list[str] = []
            for spec in self.tracers.values():
                for p in spec.basis.gaussian_params():
                    if p not in ordering:
                        ordering.append(p)
            self.marginal = MarginalSetup.from_config(prior, ordering, jeffreys=jeffreys)
            # assign each marginalized parameter to the tracers that provide it
            for name, spec in self.tracers.items():
                allowed = set(spec.basis.gaussian_params())
                self._bg_groups[name] = [p for p in self.marginal.names if p in allowed]
            counter = 0
            for group in self._bg_groups.values():
                for p in group:
                    if p not in self._bg_index:
                        self._bg_index[p] = counter
                        counter += 1
        self._to_device()

    def _to_device(self):
        """Data vector, inverse covariance and gather indices as tensors on
        the pipelines' device (set once; also after ``convert`` replaced the
        NumPy constants)."""
        pipe = next(iter(self.tracers.values())).pipeline
        self.device, self.dtype = pipe.device, pipe.dtype
        self._data_dev = torch.as_tensor(self.data_vector, dtype=self.dtype, device=self.device)
        self._invcov_dev = torch.as_tensor(self.invcov, dtype=self.dtype, device=self.device)
        self._gather = {
            name: (torch.as_tensor(rt.rows, dtype=torch.long, device=self.device),
                   torch.as_tensor(rt.cols, dtype=torch.long, device=self.device))
            for name, rt in self.runtimes.items()
        }
        # the interpolation matrices, transposed, and the k grid they act on
        dev = lambda x: torch.as_tensor(x, dtype=self.dtype, device=self.device)
        self._interp = {
            name: dict(k=dev(rt.spec.pipeline.cfg.k), png=dev(rt.interp_png.T),
                       pg=dev(rt.interp_pg.T))
            for name, rt in self.runtimes.items() if rt.interp_png is not None
        }

    # ------------------------------------------------------------------
    def _load_tracer(self, name: str, spec: TracerSpec) -> _TracerRuntime:
        data = dict(spec.data)
        path = data.pop("path")
        ls = data.pop("ls")
        if isinstance(ls, int):
            ls = [ls]
        kmin = data.pop("kmin", None)
        kmax = data.pop("kmax", None)
        reader = find_reader(data.pop("reader", None), read_pkl, **data.pop("reader_kwargs", {}))
        table = reader(path)
        symbol, ls_tot = extract_multipole_info(list(table.columns))
        missing = set(ls) - set(ls_tot)
        if missing:
            raise ValueError(f"tracer {name}: multipoles {missing} not found in data")
        kall = table.k
        kmask = parse_kmask(kall, ls, kmin, kmax)
        data_vector = np.hstack([table[symbol + str(ell)][kmask[ell]] for ell in ls])
        lo = min(s.start for s in kmask.values())
        hi = max(s.stop for s in kmask.values())
        kout = kall[lo:hi]
        kout_mask = parse_kmask(kout, ls, kmin, kmax)

        binning_tables = None
        if spec.with_binning:
            binning_tables = spec.pipeline.binning_tables(kout, **spec.binning)

        cfg = spec.pipeline.cfg
        interp_png = interp_pg = None
        if not spec.with_binning and spec.with_interp:
            # PlkInterpolator inserts (0, 0) before interpolating k·P
            # (theory.py:75-106); the PG path interpolates without the
            # zero-insertion (likelihood.py:511-513)
            kgrid0 = np.concatenate([[0.0], cfg.k])
            interp_png = spline_matrix(kgrid0, kout)[:, 1:] / kout[:, None]
            interp_pg = spline_matrix(cfg.k, kout) / kout[:, None]

        # the product carries cfg.no multipoles (one fewer when chained): a
        # data multipole beyond that would otherwise index past the computed
        # ones (orchestrate's ls negotiation normally prevents this)
        n_prod_l = cfg.no - (1 if spec.chained else 0)
        if max(ls) // 2 >= n_prod_l:
            raise ValueError(
                f"tracer {name}: data requests multipole l={max(ls)} but the "
                f"pipeline computes only {n_prod_l} output multipoles "
                f"(nl={cfg.nl}, chained={spec.chained}) — raise the tracer's "
                "'ls' (or let Analysis.from_config negotiate it)"
            )
        # flatten gather indices into the product plk (likelihood.py:167-195)
        rows, cols = [], []
        use_mask = spec.with_binning or spec.with_interp
        for ell in ls:
            sel = (np.arange(kout_mask[ell].start, kout_mask[ell].stop) if use_mask
                   else np.arange(cfg.nk))
            rows.append(np.full(sel.size, ell // 2))
            cols.append(sel)
        return _TracerRuntime(
            spec=spec,
            ls=ls,
            ls_tot=ls_tot,
            kall=kall,
            kmin=kmin,
            kmax=kmax,
            kout=kout,
            data_vector=data_vector,
            rows=np.concatenate(rows),
            cols=np.concatenate(cols),
            binning_tables=binning_tables,
            interp_png=interp_png,
            interp_pg=interp_pg,
        )

    # ------------------------------------------------------------------
    def marginalizable_params(self) -> list[str]:
        out: list[str] = []
        for spec in self.tracers.values():
            for p in spec.basis.gaussian_params():
                if p not in out:
                    out.append(p)
        return out

    def _tracer_product(self, name: str, inputs: CosmoInputs):
        rt = self.runtimes[name]
        spec = rt.spec
        bird = spec.pipeline.compute_bird(inputs)
        _, _, product = spec.pipeline.product(
            bird, chained=spec.chained, binning=rt.binning_tables
        )
        return product

    def _flatten(self, name: str, plk, part: str = "png"):
        """Gather the data's entries of ``plk`` (W, L, nk); an interpolated
        tracer first maps k·P onto its k with the matrix of ``part`` ("png":
        the theory vector, "pg": the ∂P/∂b_G rows)."""
        if name in self._interp:
            interp = self._interp[name]
            plk = (plk * interp["k"]) @ interp[part]
        rows, cols = self._gather[name]
        return plk[..., rows, cols]

    def png_and_pg(self, inputs: Mapping[str, CosmoInputs], params: Mapping):
        """Theory vector (W, ndata) and, when marginalizing, the ∂P/∂b_G
        matrix (W, nmarg, ndata), one pass over the tracers."""
        png_parts = []
        pg_rows: dict[int, list] = {}
        nmarg = self.marginal.nmarg if self.marginal else 0
        for name, rt in self.runtimes.items():
            spec = rt.spec
            product = self._tracer_product(name, inputs[name])
            comp: BirdComponent = spec.basis.reduce_plk(spec.pipeline.cfg, product, params)
            png_parts.append(self._flatten(name, comp.sum()))
            if self.marginal:
                group = self._bg_groups[name]
                table = spec.basis.gaussian_table(
                    spec.pipeline.cfg, product, params, requires=set(group)
                )
                seg = self.segments[name]
                for p in group:
                    pg_rows.setdefault(self._bg_index[p], []).append(
                        (seg, self._flatten(name, table[p], "pg")))
        png = torch.cat(png_parts, dim=-1)
        pg = None
        if self.marginal:
            pg = png.new_zeros(png.shape[:-1] + (nmarg, self.ndata))
            for row, entries in pg_rows.items():
                for (start, stop), flat in entries:
                    pg[..., row, start:stop] = flat
        return png, pg

    def logp(self, inputs: Mapping[str, CosmoInputs], params: Mapping) -> dict:
        """Log-posterior + derived quantities (likelihood.py:570-594), each
        of shape (W,)."""
        with stage_precision("like"):
            return self._logp(inputs, params)

    def _logp(self, inputs: Mapping[str, CosmoInputs], params: Mapping) -> dict:
        png, pg = self.png_and_pg(inputs, params)
        data, invcov = self._data_dev, self._invcov_dev
        if self.marginal is None:
            res = data - png
            chi2 = torch.einsum("...i,ij,...j->...", res, invcov, res)
            return dict(logp=-0.5 * chi2, chi2=chi2, fullchi2=chi2)
        mu, sigma_inv = self.marginal.mu_sigma_inv(params, png)
        logp, fullchi2, bg_best = marginalized_logp(
            pg, png, invcov, data, mu, sigma_inv, jeffreys=self.jeffreys
        )
        return dict(
            logp=logp, chi2=-2.0 * logp, fullchi2=fullchi2, bg_bestfit=bg_best
        )
