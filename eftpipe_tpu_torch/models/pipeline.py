"""Per-tracer theory pipeline (counterpart of ``eftpipe_tpu/models/pipeline.py``).

The analogue of upstream ``EFTLeafKernel.calculate_power_spectrum``
(eftpipe/theory.py:557-609): cosmology inputs → bird → IR resummation → AP →
window (+icc) → window matrix → fiber → per-(chained, binned) products.  All
Phase-A tables are built once, on the host, and moved to the device in
:meth:`TracerPipeline.build`; the per-evaluation methods run on a whole
walker batch (leading axis W).  :meth:`TracerPipeline.freeze_template` is
the template-fit fast path: the P_lin-only loop products computed once.
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass
from typing import Any, NamedTuple

from .. import resolve_device
from .config import EFTConfig
from .nonlinear import LOWRANK_TOL, QUADFORMS, build_nonlinear_tables, nonlinear_pscf
from .bird import build_bird_tables, assemble_bird, BirdState
from .resum import build_resum_tables, resum_ps
from .ap import build_ap_tables, ap_transform
from .window import (build_window_tables, window_tables_to, apply_window,
                     build_window_matrix_tables, window_matrix_tables_to, apply_window_matrix)
from .icc import build_icc_tables
from .fiber import build_fiber_tables, fiber_tables_to, apply_fiber
from .transforms import build_binning_matrix, apply_binning, apply_chained
from .resum import ir_filters, _xpyp
from ..ops.precision import stage_precision


class CosmoInputs(NamedTuple):
    """Per-evaluation cosmology inputs of one tracer, batched over walkers.

    ``plin`` (W, nkin) is sampled on the pipeline's fixed ``cfg.kin`` grid;
    ``f`` (W,); ``qperp``/``qpar`` (W,) are the AP distortion parameters
    (DA/DA_fid and H_fid/H); 1.0 disables the distortion.
    """

    plin: Any
    f: Any
    qperp: Any = 1.0
    qpar: Any = 1.0


@dataclass
class TracerPipeline:
    cfg: EFTConfig
    nt: dict
    bt: dict
    rt: dict | None = None
    at: dict | None = None
    wt: dict | None = None
    wmt: dict | None = None
    ft: dict | None = None
    with_rsd: bool = True
    zeff: float | None = None
    device: Any = None
    dtype: Any = None
    quadform: str = "kernel"
    cf_premix: bool = True
    frozen: dict | None = None

    @classmethod
    def build(
        cls,
        cfg: EFTConfig,
        zeff: float | None = None,
        with_irresum: bool | dict = True,
        apeffect: dict | None = None,
        window: dict | None = None,
        window_matrix: dict | None = None,
        icc: dict | None = None,
        fiber: dict | None = None,
        with_rsd: bool = True,
        cache_dir=None,
        device=None,
        dtype=torch.float64,
        quadform: str = "kernel",
        lowrank_tol: float = LOWRANK_TOL,
        cf_premix: bool = True,
    ) -> "TracerPipeline":
        """Build all Phase-A tables and move them to ``device`` (default: the
        card; raises when there is none).  ``quadform`` selects the
        quadratic forms' route ("kernel", "plain" or "lowrank"), see
        :func:`..nonlinear.nonlinear_pscf`; "lowrank" builds the factors at
        the cut ``lowrank_tol`` and contracts the CF loop on the premixed
        factors unless ``cf_premix`` is False.
        ``window``/``window_matrix``/``icc``/``fiber`` are the keyword
        arguments of the matching host builders; the icc tables are coupled
        into the window.  ``window["builder"]``, a dotted path, names another
        host window builder with the signature and result of
        :func:`..window.build_window_tables` (upstream theory.py:62-72)."""
        if quadform not in QUADFORMS:
            raise ValueError(f"quadform must be one of {QUADFORMS}, got {quadform!r}")
        device = resolve_device(device)
        nt = build_nonlinear_tables(
            cfg, device, dtype, cache_dir=cache_dir,
            lowrank_tol=lowrank_tol if quadform == "lowrank" else None)
        bt = build_bird_tables(cfg, device, dtype)
        rt = None
        if with_irresum:
            kwargs = with_irresum if isinstance(with_irresum, dict) else {}
            rt = build_resum_tables(cfg, device, dtype, **kwargs)
        at = build_ap_tables(cfg, device, dtype, **apeffect) if apeffect else None
        icc_tables = build_icc_tables(cfg, cache_dir=cache_dir, **icc) if icc else None
        wt = wmt = ft = None
        if window:
            window = dict(window)
            builder = build_window_tables
            dotted = window.pop("builder", None)
            if dotted:
                import importlib

                module_name, fn_name = dotted.rsplit(".", 1)
                builder = getattr(importlib.import_module(module_name), fn_name)
            wt = window_tables_to(builder(
                cfg, cache_dir=cache_dir, icc_tables=icc_tables, **window), device, dtype)
        if window_matrix:
            wmt = window_matrix_tables_to(
                build_window_matrix_tables(cfg, **window_matrix), device, dtype)
        if fiber:
            ft = fiber_tables_to(build_fiber_tables(cfg, **fiber), device, dtype)
        return cls(cfg=cfg, nt=nt, bt=bt, rt=rt, at=at, wt=wt, wmt=wmt, ft=ft,
                   with_rsd=with_rsd, zeff=zeff, device=device, dtype=dtype,
                   quadform=quadform, cf_premix=cf_premix)

    def freeze_template(self, plin) -> "TracerPipeline":
        """Template-fit fast path (upstream ``LinearPowerFile`` mode,
        boltzmann.py:246-315): everything that depends only on P_lin — the
        one-loop quadratic forms (through the kernels on the card) and the IR
        filter powers — is computed ONCE here, for ``plin`` (nkin,) on
        cfg.kin, and kept on the device with a walker axis of one;
        :meth:`compute_bird` then runs only the f- and AP-dependent work."""
        p = torch.as_tensor(np.asarray(plin), dtype=self.dtype, device=self.device)[None]
        with torch.no_grad(), stage_precision("nonlinear"):
            frozen = {"nl_out": nonlinear_pscf(self.nt, self.cfg, p, quadform=self.quadform,
                                               cf_premix=self.cf_premix)}
            if self.rt is not None:
                frozen["xpyp"] = _xpyp(self.rt, *ir_filters(self.rt, p))
        self.frozen = frozen
        return self

    def compute_bird(self, inputs: CosmoInputs, with_snapshots: bool = False,
                     stop_after: str | None = None):
        """Full bird pipeline on a walker batch; with ``with_snapshots`` also
        returns the state after each enabled stage (upstream BirdSnapshot,
        pybird.py:616-632).  ``stop_after`` truncates the pipeline after the
        named stage — the stage-prefix hook of the timing decomposition."""
        cfg = self.cfg
        plin = inputs.plin
        f = inputs.f if self.with_rsd else torch.zeros_like(inputs.f)
        snaps: dict[str, BirdState] = {}
        nw = plin.shape[0]
        batch = lambda x: x.expand((nw,) + tuple(x.shape[1:]))
        with stage_precision("nonlinear"):
            if self.frozen is not None:
                out = {k: batch(v) for k, v in self.frozen["nl_out"].items()}
            else:
                out = nonlinear_pscf(self.nt, cfg, plin, quadform=self.quadform,
                                     cf_premix=self.cf_premix)
            bird = assemble_bird(self.bt, cfg, out, plin, f)
        snaps["nonlinear"] = bird
        if stop_after == "nonlinear":
            return bird
        if self.rt is not None:
            xpyp = batch(self.frozen["xpyp"]) if self.frozen is not None else None
            with stage_precision("IRresum"):
                bird = resum_ps(self.rt, cfg, bird, plin, xpyp=xpyp)
            snaps["IRresum"] = bird
        if stop_after == "IRresum":
            return bird
        if self.at is not None:
            with stage_precision("APeffect"):
                bird = ap_transform(self.at, cfg, bird, inputs.qperp, inputs.qpar)
            snaps["APeffect"] = bird
        if stop_after == "APeffect":
            return bird
        if self.wt is not None:
            with stage_precision("window"):
                bird = apply_window(self.wt, cfg, bird)
            snaps["window"] = bird
        if stop_after == "window":
            return bird
        if self.wmt is not None:
            bird = apply_window_matrix(self.wmt, cfg, bird)
            snaps["window_matrix"] = bird
        if stop_after == "window_matrix":
            return bird
        if self.ft is not None:
            with stage_precision("fiber"):
                bird = apply_fiber(self.ft, cfg, bird)
            snaps["fiber"] = bird
        if with_snapshots:
            return bird, snaps
        return bird

    def binning_tables(self, kout, **binning_opts) -> dict:
        """Host binning tables plus ``matrix_dev``, the bin-average matrix on
        the pipeline's device."""
        tables = build_binning_matrix(self.cfg, kout, **binning_opts)
        tables["matrix_dev"] = torch.as_tensor(
            tables["matrix"], dtype=self.dtype, device=self.device)
        return tables

    def product_info(self, chained: bool = False, binning: dict | None = None):
        """Static (ls, kgrid, nk) of a product combination."""
        cfg = self.cfg
        kret = binning["keff"] if binning is not None else cfg.k
        ls = [2 * i for i in range(cfg.no - 1 if chained else cfg.no)]
        return ls, kret, len(kret)

    def product(self, bird: BirdState, chained: bool = False,
                binning: dict | None = None) -> tuple[list[int], np.ndarray, BirdState]:
        """(ls, kgrid, birdlike) for one (chained, binned) combination
        (theory.py:590-604)."""
        ls, kret, _ = self.product_info(chained, binning)
        out = bird
        if binning is not None:
            with stage_precision("binning"):
                out = apply_binning(binning["matrix_dev"], out)
        if chained:
            out = apply_chained(self.cfg, out)
        return ls, kret, out
