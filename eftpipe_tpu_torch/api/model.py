"""Fluent single-tracer theory API — the ``EFTModel`` analogue (counterpart
of ``eftpipe_tpu/api/model.py``; upstream eftpipe/model.py:15-460).

Build a full theory pipeline without writing a config::

    model = (EFTModel(z=0.7, nd=5e-5, device="cpu")
             .set_cosmology(omega_b=0.02237, omega_cdm=0.12, h=0.6777,
                            ln10As=3.044, ns=0.9649)   # on-device EH98
             .set_IRresum()
             .set_APeffect(Om_AP=0.31)
             .set_window(window_configspace_file="mask.txt")
             .done(ellmax=4))
    interp = model(b1=2.0, c2=1.2, b3=0.5, cct=0.3)    # -> PlkInterpolator
    p0 = interp(0, kgrid)

Bias parameters use the westcoast convention with upstream's (c2, c4) ↔
(b2, b4) reparametrisation b2 = (c2 + c4)/√2, b4 = (c2 − c4)/√2
(model.py:100-132).  ``set_template(path)`` switches to the template-fit
mode (fixed P_lin; sample f/α's), with the frozen fast path.  The model
lives on ``device`` (the card unless ``device="cpu"``) in ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch
from typing import Any

from .. import resolve_device
from ..models.config import EFTConfig
from ..models.pipeline import TracerPipeline
from ..models.ap import lcdm_da, lcdm_hubble
from ..likelihood.parambasis import find_param_basis
from ..boltzmann.eh98 import EisensteinHuProvider
from ..boltzmann.providers import FixedTemplateProvider
from .products import PlkInterpolator, plk_grid


def c2c4_to_b2b4(c2, c4=0.0):
    """b2 = (c2 + c4)/√2, b4 = (c2 − c4)/√2 (upstream model.py:100-132)."""
    s = np.sqrt(2.0)
    return (c2 + c4) / s, (c2 - c4) / s


class EFTModel:
    """Chainable builder; every ``set_*`` returns self, ``done()`` freezes."""

    def __init__(self, z: float, nd: float = 3e-4, km: float = 0.7,
                 kr: float = 0.25, basis: str = "westcoast",
                 cache_dir=None, use_cb: bool = False, device=None,
                 dtype=torch.float64):
        self.z = float(z)
        self.nd, self.km, self.kr = nd, km, kr
        self.basis_name = basis
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        self.dtype = dtype
        self._cosmo: dict | None = None
        self._template: dict | None = None
        self._irresum: Any = True
        self._ap: dict | None = None
        self._window: dict | None = None
        self._icc: dict | None = None
        self._fiber: dict | None = None
        self._with_nnlo = False
        self._with_rsd = True
        self._done = False

    # -- fluent setters (upstream model.py:134-390) ------------------------
    def _check_open(self):
        if self._done:
            raise RuntimeError("model already finalised with done()")

    def set_cosmology(self, omega_b: float, omega_cdm: float, h: float,
                      ln10As: float, ns: float, om_fid: float | None = None):
        self._check_open()
        self._cosmo = dict(omega_b=omega_b, omega_cdm=omega_cdm, h=h,
                           ln10As=ln10As, ns=ns)
        self._om_fid = om_fid or (omega_b + omega_cdm) / h**2
        return self

    def set_template(self, path, f: float, alperp: float = 1.0,
                     alpara: float = 1.0, with_hubble_unit: bool = True,
                     h: float = 1.0):
        """Template-fit mode (upstream LinearPowerFile, boltzmann.py:246-315)."""
        self._check_open()
        self._template = dict(path=path, f=f, alperp=alperp, alpara=alpara,
                              with_hubble_unit=with_hubble_unit, h=h)
        return self

    def set_IRresum(self, enable: bool = True, optiresum: bool = False, **kw):
        self._check_open()
        self._irresum = (dict(optiresum=optiresum, **kw) if enable and
                         (optiresum or kw) else enable)
        return self

    def set_APeffect(self, Om_AP: float | None = None, z_AP: float | None = None,
                     **kw):
        self._check_open()
        self._ap = dict(om_ap=Om_AP if Om_AP is not None else 0.31,
                        z_ap=z_AP if z_AP is not None else self.z, **kw)
        return self

    def set_window(self, window_configspace_file, **kw):
        self._check_open()
        self._window = dict(window_configspace_file=window_configspace_file, **kw)
        return self

    def set_icc(self, **kw):
        self._check_open()
        self._icc = dict(kw)
        return self

    def set_fiber(self, **kw):
        self._check_open()
        self._fiber = dict(kw)
        return self

    def set_NNLO(self, enable: bool = True):
        self._check_open()
        self._with_nnlo = enable
        return self

    def set_real_space(self):
        """Disable RSD (f = 0)."""
        self._check_open()
        self._with_rsd = False
        return self

    # -- finalisation --------------------------------------------------------
    def done(self, ellmax: int = 2) -> "EFTModel":
        """Build Phase-A tables; the model becomes callable (model.py:392-427)."""
        self._check_open()
        nl = ellmax // 2 + 1
        basis_cls = find_param_basis(self.basis_name)
        self.cfg = EFTConfig(
            nl=max(nl, 2), no=nl, nd_a=self.nd, km_a=self.km, kr_a=self.kr,
            with_nnlo=self._with_nnlo,
            counterform=getattr(basis_cls, "counterform", "westcoast"),
            optiresum=bool(isinstance(self._irresum, dict)
                           and self._irresum.get("optiresum")),
        )
        irresum = self._irresum
        if isinstance(irresum, dict):
            irresum = {k: v for k, v in irresum.items() if k != "optiresum"} or True
        self.pipeline = TracerPipeline.build(
            self.cfg, zeff=self.z, with_irresum=irresum, apeffect=self._ap,
            window=self._window, icc=self._icc, fiber=self._fiber,
            with_rsd=self._with_rsd, cache_dir=self.cache_dir,
            device=self.device, dtype=self.dtype,
        )
        self.basis = basis_cls(prefix="")
        if self._template is not None:
            t = self._template
            self.provider = FixedTemplateProvider.from_file(
                self.cfg, t["path"], with_hubble_unit=t["with_hubble_unit"],
                h=t["h"],
            )
            self.pipeline.freeze_template(self.provider.plin)
            self._base_params = dict(f=t["f"], alperp=t["alperp"],
                                     alpara=t["alpara"])
        elif self._cosmo is not None:
            self.provider = EisensteinHuProvider(
                cfg=self.cfg, zeff=self.z,
                da_fid=lcdm_da(self._om_fid, self.z),
                h_fid=lcdm_hubble(self._om_fid, self.z),
            )
            self._base_params = dict(self._cosmo)
        else:
            raise ValueError("call set_cosmology() or set_template() first")
        self._done = True
        return self

    # -- evaluation -----------------------------------------------------------
    def _eft_params(self, kwargs: dict) -> dict:
        kwargs = dict(kwargs)
        if "c2" in kwargs or "c4" in kwargs:
            if "b2" in kwargs or "b4" in kwargs:
                raise ValueError("pass either (c2, c4) or (b2, b4), not both")
            b2, b4 = c2c4_to_b2b4(kwargs.pop("c2", 0.0), kwargs.pop("c4", 0.0))
            kwargs["b2"], kwargs["b4"] = b2, b4
        return kwargs

    def Plk_grid(self, **bias) -> tuple[list[int], np.ndarray, torch.Tensor]:
        """(ls, kgrid, plk) at the internal k grid; ``plk`` (nl, nk)."""
        if not self._done:
            raise RuntimeError("call done() first")
        params = {**self._base_params, **self._eft_params(bias)}
        params = {k: torch.full((1,), float(v), dtype=self.dtype, device=self.device)
                  for k, v in params.items()}
        ls, kret, plk = plk_grid(self.pipeline, self.basis, self.provider.inputs(params),
                                 params)
        return ls, kret, plk[0]

    def __call__(self, **bias) -> PlkInterpolator:
        """Evaluate and return a PlkInterpolator (model.py:429-460)."""
        ls, kret, plk = self.Plk_grid(**bias)
        return PlkInterpolator(ls, kret, plk)

    def Plk_mm(self, **cosmo_overrides) -> PlkInterpolator:
        """Matter-limit multipoles: b1 = 1, all other bias/stochastic terms
        zero (model.py:417)."""
        return self(b1=1.0)
