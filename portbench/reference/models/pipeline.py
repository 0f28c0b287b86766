"""Per-tracer theory pipeline (counterpart of ``eftpipe_tpu/models/pipeline.py``).

The analogue of upstream ``EFTLeafKernel.calculate_power_spectrum``
(eftpipe/theory.py:557-609): cosmology inputs → bird → IR resummation → AP →
window → per-(chained, binned) products.  All Phase-A tables are built
once, on the host, and moved to the device in :meth:`TracerPipeline.build`;
the per-evaluation methods run on a whole walker batch (leading axis W).
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass
from typing import Any, NamedTuple

from .. import resolve_device
from .config import EFTConfig
from .nonlinear import build_nonlinear_tables, nonlinear_pscf
from .bird import build_bird_tables, assemble_bird, BirdState
from .resum import build_resum_tables, resum_ps
from .ap import build_ap_tables, ap_transform
from .window import build_window_tables, window_tables_to, apply_window
from .transforms import build_binning_matrix, apply_binning, apply_chained
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
    with_rsd: bool = True
    zeff: float | None = None
    device: Any = None
    dtype: Any = None
    quadform: str = "plain"

    @classmethod
    def build(
        cls,
        cfg: EFTConfig,
        zeff: float | None = None,
        with_irresum: bool | dict = True,
        apeffect: dict | None = None,
        window: dict | None = None,
        with_rsd: bool = True,
        cache_dir=None,
        device=None,
        dtype=torch.float64,
        quadform: str = "plain",
    ) -> "TracerPipeline":
        """Build all Phase-A tables on the host and move them to ``device``.
        ``window`` holds the keyword arguments of
        :func:`..window.build_window_tables`; the quadratic forms are the
        plain ones."""
        if quadform != "plain":
            raise ValueError("the reference runs the plain quadratic forms only")
        device = resolve_device(device)
        nt = build_nonlinear_tables(cfg, device, dtype, cache_dir=cache_dir)
        bt = build_bird_tables(cfg, device, dtype)
        rt = None
        if with_irresum:
            kwargs = with_irresum if isinstance(with_irresum, dict) else {}
            rt = build_resum_tables(cfg, device, dtype, **kwargs)
        at = build_ap_tables(cfg, device, dtype, **apeffect) if apeffect else None
        wt = None
        if window:
            wt = window_tables_to(build_window_tables(cfg, cache_dir=cache_dir, **window),
                                  device, dtype)
        return cls(cfg=cfg, nt=nt, bt=bt, rt=rt, at=at, wt=wt, with_rsd=with_rsd, zeff=zeff,
                   device=device, dtype=dtype, quadform=quadform)

    def compute_bird(self, inputs: CosmoInputs, stop_after: str | None = None):
        """The bird pipeline on a walker batch; ``stop_after`` truncates it
        after the named stage."""
        cfg = self.cfg
        plin = inputs.plin
        f = inputs.f if self.with_rsd else torch.zeros_like(inputs.f)
        with stage_precision("nonlinear"):
            out = nonlinear_pscf(self.nt, cfg, plin, quadform=self.quadform)
            bird = assemble_bird(self.bt, cfg, out, plin, f)
        if stop_after == "nonlinear":
            return bird
        if self.rt is not None:
            with stage_precision("IRresum"):
                bird = resum_ps(self.rt, cfg, bird, plin)
        if stop_after == "IRresum":
            return bird
        if self.at is not None:
            with stage_precision("APeffect"):
                bird = ap_transform(self.at, cfg, bird, inputs.qperp, inputs.qpar)
        if stop_after == "APeffect":
            return bird
        if self.wt is not None:
            with stage_precision("window"):
                bird = apply_window(self.wt, cfg, bird)
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
