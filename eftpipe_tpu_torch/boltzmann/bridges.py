"""Host-side Boltzmann bridges, the CLASS/CAMB extractors (counterpart of
``eftpipe_tpu/boltzmann/bridges.py``).

CLASS and CAMB are C/Fortran codes that run on the host; ``OracleProvider``
runs one per walker and hands the pipeline a ``(W,)``-stacked
:class:`~eftpipe_tpu_torch.models.pipeline.CosmoInputs` on the device and in
the dtype of the parameters it was given (``tabulate`` stacks a list of
parameter dicts the same way).  Both oracles are import-gated: constructing
one raises ``ImportError`` with install guidance when its package is absent.
:func:`train_emulator_from_oracle` trains the transfer emulator on an
oracle's spectra.
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass
from typing import Any, Mapping

from ..models.config import EFTConfig
from ..models.pipeline import CosmoInputs
from .providers import resample_loglog
from .neutrino import neutrino_boltzmann_args

C_KMS = 299792.458


class ClassyOracle:
    """CLASS-backed linear power + background (reference
    CobayaClassyExtractor, boltzmann.py:191-243; classynu neutrino handling,
    classy.py:156-177)."""

    def __init__(self, zmax: float = 3.0, kmax_h: float = 5.0,
                 extra_args: Mapping | None = None, use_cb: bool = False,
                 hierarchy: str = "normal"):
        try:
            import classy  # noqa: F401
        except ImportError as e:  # pragma: no cover - env without classy
            raise ImportError(
                "ClassyOracle requires the 'classy' package (CLASS python "
                "wrapper); install CLASS or use the EH98/emulator provider"
            ) from e
        self.zmax = zmax
        self.kmax_h = kmax_h
        self.extra_args = dict(extra_args or {})
        self.use_cb = use_cb
        self.hierarchy = hierarchy

    def compute(self, params: Mapping, z: float) -> dict:
        """One CLASS run → P_lin(kh)[(Mpc/h)³] on a log grid, f, H/H0, H0·DA,
        rdrag, h, σ8(z)."""
        from classy import Class

        cosmo = Class()
        args = {
            "output": "mPk",
            "P_k_max_h/Mpc": self.kmax_h,
            "z_max_pk": max(self.zmax, z),
            "omega_b": params["omega_b"],
            "omega_cdm": params["omega_cdm"],
            "h": params["h"],
            "A_s": 1e-10 * np.exp(params["ln10As"]),
            "n_s": params["ns"],
        }
        if (mnu := params.get("mnu")) is not None:
            args.update({k: v for k, v in neutrino_boltzmann_args(
                mnu, self.hierarchy).items() if v is not None})
        args.update(self.extra_args)
        cosmo.set(args)
        cosmo.compute()
        h = cosmo.h()
        kh = np.logspace(-5, np.log10(self.kmax_h * 0.999), 400)
        pk_of = cosmo.pk_cb_lin if self.use_cb else cosmo.pk_lin
        pkh = np.array([pk_of(k * h, z) for k in kh]) * h**3
        # scale-independent growth rate (boltzmann.py:231-243)
        f = cosmo.scale_independent_growth_factor_f(z)
        hz = cosmo.Hubble(z) * C_KMS / (100.0 * h)          # H/H0
        da = cosmo.angular_distance(z) * 100.0 * h / C_KMS  # H0·DA
        out = dict(kh=kh, pkh=pkh, f=f, e=hz, da=da, h=h,
                   rdrag=cosmo.rs_drag(), sigma8_z=cosmo.sigma(8.0 / h, z))
        cosmo.struct_cleanup()
        return out


class CambOracle:
    """CAMB-backed oracle (reference CobayaCambExtractor, boltzmann.py:159-188)."""

    def __init__(self, kmax_h: float = 5.0, use_cb: bool = False):
        try:
            import camb  # noqa: F401
        except ImportError as e:  # pragma: no cover - env without camb
            raise ImportError(
                "CambOracle requires the 'camb' package; install camb or use "
                "the EH98/emulator provider"
            ) from e
        self.kmax_h = kmax_h
        self.use_cb = use_cb

    def compute(self, params: Mapping, z: float) -> dict:
        import camb

        pars = camb.set_params(
            ombh2=params["omega_b"], omch2=params["omega_cdm"],
            H0=100.0 * params["h"], As=1e-10 * np.exp(params["ln10As"]),
            ns=params["ns"], mnu=params.get("mnu", 0.06),
            redshifts=[z], kmax=self.kmax_h,
        )
        results = camb.get_results(pars)
        var = "delta_nonu" if self.use_cb else "delta_tot"
        kh, _, pk = results.get_matter_power_spectrum(
            minkh=1e-5, maxkh=self.kmax_h, npoints=400,
            var1=var, var2=var,
        )
        h = params["h"]
        fs8 = results.get_fsigma8()[0]
        s8 = results.get_sigma8()[0]
        hz = results.hubble_parameter(z) / (100.0 * h)
        da = results.angular_diameter_distance(z) * 100.0 * h / C_KMS
        return dict(kh=kh, pkh=pk[0], f=fs8 / s8, e=hz, da=da, h=h,
                    rdrag=results.get_derived_params()["rdrag"], sigma8_z=s8)


def _rows(params: Mapping) -> tuple[list[dict], Any]:
    """Per-walker host dicts of a parameter batch (numbers or (W,) tensors),
    and a tensor of the batch (or None) whose device and dtype the outputs
    take."""
    like = next((v for v in params.values() if isinstance(v, torch.Tensor)), None)
    host = {k: np.atleast_1d(v.detach().cpu().double().numpy() if isinstance(v, torch.Tensor)
                             else np.asarray(v, np.float64)) for k, v in params.items()}
    nw = max(v.size for v in host.values())
    return [{k: float(v[i] if v.size > 1 else v[0]) for k, v in host.items()}
            for i in range(nw)], like


@dataclass
class OracleProvider:
    """Cosmology provider backed by a host oracle: one oracle run per walker,
    stacked."""

    cfg: EFTConfig
    zeff: float
    oracle: Any
    da_fid: float | None = None
    h_fid: float | None = None

    def _one(self, params: Mapping) -> tuple:
        res = self.oracle.compute(params, self.zeff)
        plin = resample_loglog(res["kh"], res["pkh"], self.cfg.kin)
        qperp = res["da"] / self.da_fid if self.da_fid else 1.0
        qpar = self.h_fid / res["e"] if self.h_fid else 1.0
        return plin, res["f"], qperp, qpar

    def _stack(self, rows: list[dict], like) -> CosmoInputs:
        cols = list(zip(*(self._one(p) for p in rows)))
        kw = dict(dtype=torch.float64 if like is None else like.dtype,
                  device=None if like is None else like.device)
        plin, f, qperp, qpar = (torch.as_tensor(np.asarray(c, np.float64), **kw) for c in cols)
        return CosmoInputs(plin=plin, f=f, qperp=qperp, qpar=qpar)

    def inputs(self, params: Mapping) -> CosmoInputs:
        """``params``: name → number or (W,) tensor; (W, nkin) P_lin and (W,)
        f, q⊥, q∥ in the parameters' dtype, on their device."""
        return self._stack(*_rows(params))

    def tabulate(self, params_list) -> CosmoInputs:
        """Stack the host evaluations of a list of single parameter dicts
        (float64, on the host)."""
        return self._stack([dict(p) for p in params_list], None)


def train_emulator_from_oracle(oracle, z: float, kgrid_mpc, bounds,
                               h_of_row=None, **train_kwargs):
    """Fit the transfer emulator (``emulator.train_transfer_emulator``, its
    keyword arguments in ``train_kwargs``) on oracle samples: the target of
    a row is the oracle's P(k) at ``z`` resampled log-log onto
    ``kgrid_mpc / h`` [h/Mpc], divided by the primordial shape
    (k/0.05)^(n_s−1)·k and square-rooted (floor 1e-300): an effective |T|
    whose normalisation the emulator's output scaling absorbs."""
    from .emulator import train_transfer_emulator

    names = tuple(bounds)
    kgrid_mpc = np.asarray(kgrid_mpc)

    def target(row):
        params = dict(zip(names, row))
        res = oracle.compute(params, z)
        h = params.get("h", res["h"])
        p = resample_loglog(res["kh"], res["pkh"], kgrid_mpc / h)
        prim = (kgrid_mpc / 0.05) ** (params.get("ns", 0.96) - 1.0) * kgrid_mpc
        return np.sqrt(np.maximum(p / prim, 1e-300))

    return train_transfer_emulator(kgrid_mpc, bounds=bounds, oracle=target, **train_kwargs)
