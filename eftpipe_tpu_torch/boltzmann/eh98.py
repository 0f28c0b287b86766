"""Eisenstein–Hu (1998) linear power spectrum + LCDM background on tensors
(counterpart of ``eftpipe_tpu/boltzmann/eh98.py``).

A fully on-device cosmology → P_lin map (astro-ph/9709112, including the
baryon-acoustic-oscillation features): every quantity (transfer function,
growth factor/rate, comoving distances, sound horizon) is closed-form or a
fixed-node quadrature.  Everything is batched: the sampled parameters are
(W,) tensors, k grids get a trailing axis, the quadratures sum over a
trailing node axis; the Gauss–Legendre nodes are made on the device and in
the dtype of the input.

Parameters sampled: omega_b (=Ωb h²), omega_cdm (=Ωc h²), h, ln10As, ns.
"""

from __future__ import annotations

import math
import numpy as np
import torch
from dataclasses import dataclass, field

from ..models.config import EFTConfig
from ..models.pipeline import CosmoInputs

_TCMB = 2.7255
_KPIVOT = 0.05  # 1/Mpc
_GL_N = 64
_GL_CACHE: dict = {}


def _t0_tilde(q, alpha, beta):
    c = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q**1.08)
    lnterm = torch.log(math.e + 1.8 * beta * q)
    return lnterm / (lnterm + c * q * q)


def eh98_transfer(k_mpc, omega_b, omega_m, h):
    """Full EH98 transfer function T(k) with BAO wiggles; k_mpc (..., nk) in
    1/Mpc, the parameters broadcastable against it (e.g. (W, 1)).

    Returns (T, s) with s the sound horizon at the drag epoch [Mpc].
    """
    theta = _TCMB / 2.7
    ob_om = omega_b / omega_m
    oc_om = 1.0 - ob_om

    z_eq = 2.50e4 * omega_m * theta**-4
    k_eq = 7.46e-2 * omega_m * theta**-2
    b1 = 0.313 * omega_m**-0.419 * (1.0 + 0.607 * omega_m**0.674)
    b2 = 0.238 * omega_m**0.223
    z_d = 1291.0 * omega_m**0.251 / (1.0 + 0.659 * omega_m**0.828) * (
        1.0 + b1 * omega_b**b2
    )
    r_of_z = lambda z: 31.5 * omega_b * theta**-4 * (z / 1e3) ** -1
    r_d = r_of_z(z_d)
    r_eq = r_of_z(z_eq)
    s = (
        2.0 / (3.0 * k_eq) * torch.sqrt(6.0 / r_eq)
        * torch.log((torch.sqrt(1.0 + r_d) + torch.sqrt(r_d + r_eq)) / (1.0 + torch.sqrt(r_eq)))
    )
    k_silk = 1.6 * omega_b**0.52 * omega_m**0.73 * (1.0 + (10.4 * omega_m) ** -0.95)

    q = k_mpc / (13.41 * k_eq)

    a1 = (46.9 * omega_m) ** 0.670 * (1.0 + (32.1 * omega_m) ** -0.532)
    a2 = (12.0 * omega_m) ** 0.424 * (1.0 + (45.0 * omega_m) ** -0.582)
    alpha_c = a1 ** (-ob_om) * a2 ** (-(ob_om**3))
    bb1 = 0.944 / (1.0 + (458.0 * omega_m) ** -0.708)
    bb2 = (0.395 * omega_m) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * (oc_om**bb2 - 1.0))
    ks = k_mpc * s
    fk = 1.0 / (1.0 + (ks / 5.4) ** 4)
    t_c = fk * _t0_tilde(q, 1.0, beta_c) + (1.0 - fk) * _t0_tilde(q, alpha_c, beta_c)

    y = (1.0 + z_eq) / (1.0 + z_d)
    sy = torch.sqrt(1.0 + y)
    g_y = y * (-6.0 * sy + (2.0 + 3.0 * y) * torch.log((sy + 1.0) / (sy - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + r_d) ** -0.75 * g_y
    beta_b = 0.5 + ob_om + (3.0 - 2.0 * ob_om) * torch.sqrt((17.2 * omega_m) ** 2 + 1.0)
    beta_node = 8.41 * omega_m**0.435
    s_tilde = s / (1.0 + (beta_node / ks) ** 3) ** (1.0 / 3.0)
    kst = k_mpc * s_tilde
    j0 = torch.sin(kst) / kst
    t_b = (
        _t0_tilde(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
        + alpha_b / (1.0 + (beta_b / ks) ** 3) * torch.exp(-((k_mpc / k_silk) ** 1.4))
    ) * j0

    return ob_om * t_b + oc_om * t_c, s


def _gauss_nodes(like):
    """64 Gauss–Legendre nodes and weights on ``like``'s device and dtype."""
    key = (like.device, like.dtype)
    if key not in _GL_CACHE:
        x, w = np.polynomial.legendre.leggauss(_GL_N)
        _GL_CACHE[key] = (torch.as_tensor(x, dtype=like.dtype, device=like.device),
                          torch.as_tensor(w, dtype=like.dtype, device=like.device))
    return _GL_CACHE[key]


def _e_of_a(om, a):
    return torch.sqrt(om / a**3 + (1.0 - om))


def lcdm_growth(om, z: float):
    """(D(z), f(z)) for om (W,), D normalised to a deep in matter domination
    (fixed-node Gauss–Legendre version of pybird.py:18-31)."""
    glx, glw = _gauss_nodes(om)
    a = 1.0 / (1.0 + z)
    # ∫_0^a da' / (a' E(a'))^3 with substitution a' = a(x+1)/2
    ap = a * (glx + 1.0) / 2.0
    w = glw * a / 2.0
    integ = torch.sum(w / (ap * _e_of_a(om[..., None], ap)) ** 3, dim=-1)
    # cH(a) = a·E(a), so D = 5/2 om E(a) ∫ (a'E')⁻³ da'
    d = 2.5 * om * torch.sqrt(om / a**3 + (1.0 - om)) * integ
    return d, (om * (5.0 * a - 3.0 * d)) / (2.0 * (a**3 * (1.0 - om) + om) * d)


def lcdm_background(om, z: float):
    """Dimensionless (H(z)/H0, H0·DA(z)) for om (W,) via fixed-node quadrature."""
    glx, glw = _gauss_nodes(om)
    e = torch.sqrt(om * (1.0 + z) ** 3 + (1.0 - om))
    zp = z * (glx + 1.0) / 2.0
    w = glw * z / 2.0
    chi = torch.sum(w / torch.sqrt(om[..., None] * (1.0 + zp) ** 3 + (1.0 - om[..., None])), dim=-1)
    return e, chi / (1.0 + z)


def lcdm_growth_f(om, z: float):
    return lcdm_growth(om, z)[1]


def eh98_pk(kin_h, omega_b, omega_cdm, h, ln10as, ns, z: float):
    """P_lin(k, z) in (Mpc/h)³ on the k grid ``kin_h`` (nk,) in h/Mpc for
    (W,) parameters → (W, nk), plus (f, H/H0, H0·DA, rdrag[Mpc]), each (W,)."""
    omega_m = omega_b + omega_cdm
    om = omega_m / h**2
    col = lambda x: x[..., None]
    k_mpc = kin_h * col(h)
    t, s = eh98_transfer(k_mpc, col(omega_b), col(omega_m), col(h))
    d, f = lcdm_growth(om, z)
    as_ = 1e-10 * torch.exp(ln10as)
    c_h0 = 2997.92458 / h  # c/H0 in Mpc
    prim = col(as_) * (k_mpc / _KPIVOT) ** (col(ns) - 1.0)
    pk_mpc = (8.0 * math.pi**2 / 25.0) * prim * k_mpc * (t * col(d)) ** 2 * col(c_h0**4 / om**2)
    pk_h = pk_mpc * col(h**3)  # (Mpc/h)³ with k in h/Mpc: P_h(k_h) = h³ P(k)
    e, da = lcdm_background(om, z)
    return pk_h, f, e, da, s[..., 0]


def sigma_r(kh, pk, r: float = 8.0):
    """σ(R) from P(k) on a log-spaced grid [h/Mpc, (Mpc/h)³] via the
    top-hat-window integral σ² = ∫ dk k² P W²(kR) / 2π²; pk (W, nk) → (W,)."""
    x = kh * r
    w = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x**3
    integ = kh**3 * pk * w * w / (2.0 * math.pi**2)
    return torch.sqrt(torch.trapezoid(integ, torch.log(kh), dim=-1))


@dataclass
class EisensteinHuProvider:
    """On-device cosmology provider for a tracer at effective redshift z."""

    cfg: EFTConfig
    zeff: float
    da_fid: float | None = None  # dimensionless H0·DA of the fiducial cosmology
    h_fid: float | None = None   # dimensionless H/H0 of the fiducial cosmology
    use_ap: bool = True
    rdrag_fid: float | None = None  # Mpc: enables the rdrag·h-rescaled α's
    h0_fid: float | None = None     # H0/100 of the fiducial cosmology
    _kin: dict = field(default_factory=dict, repr=False)  # (device, dtype) → cfg.kin

    def _kin_like(self, h):
        key = (h.device, h.dtype)
        if key not in self._kin:
            self._kin[key] = torch.as_tensor(self.cfg.kin, dtype=h.dtype, device=h.device)
        return self._kin[key]

    def _background(self, params):
        h = params["h"]
        return eh98_pk(
            self._kin_like(h), params["omega_b"], params["omega_cdm"], h,
            params["ln10As"], params["ns"], self.zeff,
        )

    def _q(self, f, e, da):
        if self.use_ap and self.da_fid is not None:
            return da / self.da_fid, self.h_fid / e
        return torch.ones_like(f), torch.ones_like(f)

    def inputs(self, params) -> CosmoInputs:
        """``params``: name → (W,) tensor, all on one device in one dtype."""
        pk, f, e, da, _ = self._background(params)
        qperp, qpar = self._q(f, e, da)
        return CosmoInputs(plin=pk, f=f, qperp=qperp, qpar=qpar)

    def derived(self, params) -> dict:
        """Chain columns (upstream theory.py:611-648): fz, fsigma8_z and
        α⊥/α∥ — rescaled by (rdrag_fid·h0_fid)/(rdrag·h) when the fiducial
        sound horizon is configured (pybird.py:1564-1579), else = q's;
        each (W,)."""
        pk, f, e, da, rdrag = self._background(params)
        s8z = sigma_r(self._kin_like(params["h"]), pk)
        qperp, qpar = self._q(f, e, da)
        if self.rdrag_fid is not None and self.h0_fid is not None:
            ratio = (self.rdrag_fid * self.h0_fid) / (rdrag * params["h"])
            alperp, alpara = qperp * ratio, qpar * ratio
        else:
            alperp, alpara = qperp, qpar
        return dict(fz=f, fsigma8_z=f * s8z, alperp=alperp, alpara=alpara)
