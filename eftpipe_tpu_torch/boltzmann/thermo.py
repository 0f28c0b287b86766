"""Background cosmology + recombination thermodynamics of the Einstein–
Boltzmann solver (counterpart of ``eftpipe_tpu/boltzmann/thermo.py``).

The physics is the JAX module's: photons, massless neutrinos (N_ur), one
optional massive-neutrino species of degenerate mass (exact Fermi–Dirac
integrals on a Gauss–Laguerre grid), baryons, CDM and Λ; Saha equilibrium
for He III/He II/He I and early H, then a Peebles three-level atom for
hydrogen (Crank–Nicolson, RECFAST case-B fudge) and the matter temperature
by exact exponential steps; the derived epochs κ(τ), drag depth, r_s(τ),
r_drag and the visibility peak.

Differences from the JAX module:

* a batch of cosmologies: every field of :class:`CosmoParams` is a ``(W,)``
  tensor (:func:`as_batch`), and every table is ``(W, n_grid)`` on the
  shared ln-a grid ``lna`` ``(n_grid,)``;
* always float64, whatever the caller's dtype;
* the recurrence of ``_thermo_on_grid`` (a ``lax.scan`` there) is
  :func:`recomb_scan`: the CUDA kernel ``recomb_scan`` of
  ``csrc/boltzmann.cu`` on a CUDA tensor, the plain step loop
  :func:`recomb_scan_plain` on a CPU tensor.  Its carry-free inputs (the
  Saha fractions, of a 30-step fixed point each) are computed for the whole
  grid before it.  On the card it differentiates in forward mode only
  (``torch.autograd.forward_ad``: the tangent kernel ``recomb_scan_jvp``);
  the tables carry forward-mode tangents end to end, which is how
  ``einstein_boltzmann.EBSolver`` takes the solver's gradient there.  Its
  second order is :func:`recomb_scan_jvp2` (the hyper-dual kernel
  ``recomb_scan_jvp2`` on the card, the plain loop on ``jet.HyperDual``
  operands on the CPU), which ``EBSolver.table_hessians`` reaches through
  :class:`ThermoStages`: :func:`thermo_tables` cut at the recurrence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import forward_ad

from .. import resolve_device
from . import _kernels
from .dual import direct_tangents
from .jet import Jet, as_jet, hyper

# ---------------------------------------------------------------------------
# physical constants (SI)
# ---------------------------------------------------------------------------
C_SI = 2.99792458e8              # m/s
MPC_M = 3.0856775814913673e22    # m
KB = 1.380649e-23                # J/K
HP = 6.62607015e-34              # J s
ME = 9.1093837015e-31            # kg
MH = 1.6735575e-27               # kg (neutral hydrogen)
SIGMA_T = 6.6524587321e-29       # m²
EV = 1.602176634e-19             # J
A_RAD = 7.565723e-16             # radiation constant, J m⁻³ K⁻⁴
H100_SI = 1.0e5 / MPC_M          # 100 km/s/Mpc in 1/s
RHO_CRIT_H2 = 1.878341616e-26    # critical density / h², kg/m³

TCMB_K = 2.7255
OMEGA_G_H2 = A_RAD * TCMB_K**4 / C_SI**2 / RHO_CRIT_H2  # ≈ 2.4728e-5
# CLASS convention: T_ncdm/T_γ chosen so that ω_ncdm ≈ Σm/93.14 eV
T_NCDM_FAC = 0.71611
# one massless-neutrino family in units of photons: (7/8)(4/11)^(4/3)
UR_FAC = 0.875 * (4.0 / 11.0) ** (4.0 / 3.0)

B1_EV = 13.598434      # H ionization from 1s
B2_EV = B1_EV / 4.0    # from 2s
E21_EV = B1_EV * 0.75  # Lyman-alpha
CHI_HE1_EV = 24.587389
CHI_HE2_EV = 54.417765
LAM_2S1S = 8.2245809            # 2s->1s two-photon rate, 1/s
LAM_ALPHA = HP * C_SI / (E21_EV * EV)   # Lyman-alpha wavelength, m
RECFAST_F = 1.14                # case-B fudge factor

_NQ_BG = 24  # Gauss–Laguerre nodes for the ncdm background integrals
_qbg, _wbg = np.polynomial.laguerre.laggauss(_NQ_BG)
# weights for ∫ q^2 .. q^3 f(q) dq with f = 1/(e^q+1): fold e^{+q} back in
_WQ2 = _wbg * _qbg**2 * np.exp(_qbg) / (np.exp(_qbg) + 1.0)
_QBG = _qbg
_RHO_MASSLESS = float(np.sum(_wbg * _qbg**3 * np.exp(_qbg) / (np.exp(_qbg) + 1.0)))
# = 7π⁴/120 ≈ 5.6822

F64 = torch.float64


class CosmoParams(NamedTuple):
    """Input cosmologies (flat ΛCDM + massive ν), one per walker.

    Fields are numbers or tensors; :func:`as_batch` broadcasts them to
    ``(W,)`` float64 tensors on one device.  ``m_ncdm`` is the PER-SPECIES
    mass and ``deg_ncdm`` the number of degenerate species sharing it (a
    static float, as in the JAX module)."""

    omega_b: torch.Tensor
    omega_cdm: torch.Tensor
    h: torch.Tensor
    ln10As: torch.Tensor
    ns: torch.Tensor
    m_ncdm: torch.Tensor | float = 0.06   # eV per species (0 disables)
    n_ur: torch.Tensor | float = 2.0328   # massless families
    yhe: torch.Tensor | float = 0.2454
    deg_ncdm: float = 1.0                 # static degeneracy factor


def as_batch(par: CosmoParams, device=None) -> CosmoParams:
    """``par`` with every numeric field a ``(W,)`` float64 tensor on one
    device: that of its tensors, else ``device`` (the card by default)."""
    names = CosmoParams._fields[:-1]
    vals = [getattr(par, n) for n in names]
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    vals = [torch.as_tensor(v, dtype=F64, device=dev) for v in vals]
    shape = torch.broadcast_shapes(*(v.shape for v in vals), (1,))
    if len(shape) != 1:
        raise ValueError(f"CosmoParams fields must be scalars or (W,) tensors, got {shape}")
    return CosmoParams(*(v.expand(shape) for v in vals), deg_ncdm=float(par.deg_ncdm))


def _const(x, like):
    """Host values (a number or an array, copied) as float64 on ``like``'s device."""
    return torch.as_tensor(np.array(x, dtype=np.float64), dtype=F64, device=like.device)


def gradient(f, dx):
    """``jnp.gradient(f, dx)`` along the last axis (second-order centred
    inside, first-order one-sided at the two ends)."""
    inner = (f[..., 2:] - f[..., :-2]) * 0.5 / dx
    return torch.cat([(f[..., 1:2] - f[..., 0:1]) / dx, inner,
                      (f[..., -1:] - f[..., -2:-1]) / dx], dim=-1)


def cumsum_rows(x):
    """``torch.cumsum(x, -1)`` of a (W, n) batch, each row summed in the
    same order whatever W: on the card a lone row (W = 1) takes another scan
    (cub's device-wide one) than the rows of a batch, so it is scanned as
    the first of two copies of itself."""
    if x.shape[0] == 1 and x.is_cuda:
        return torch.cumsum(x.expand(2, -1), dim=-1)[:1]
    return torch.cumsum(x, dim=-1)


def interp(x, xp, fp):
    """``jnp.interp`` on a grid ``xp`` (n,) shared by the batch: ``fp``
    (..., n), ``x`` (..., m) → (..., m); constant beyond both ends."""
    n = xp.shape[0]
    batch = torch.broadcast_shapes(x.shape[:-1], fp.shape[:-1])
    x = x.expand(*batch, x.shape[-1])
    fp = fp.expand(*batch, n)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    f0 = torch.gather(fp, -1, i - 1)
    f1 = torch.gather(fp, -1, i)
    x0 = xp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (f1 - f0)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def ncdm_rho_p(y):
    """(ρ, p) of one massive-ν species relative to its massless limit, as a
    function of y = a m c²/(k_B T_ncdm,0) (any shape).  Exact Fermi–Dirac
    integrals."""
    lead = (-1,) + (1,) * y.dim()
    q = _const(_QBG, y).view(lead)
    w2 = _const(_WQ2, y).view(lead)
    eps = torch.sqrt(q**2 + y[None] ** 2)
    rho = torch.sum(w2 * eps, dim=0) / _RHO_MASSLESS
    p = torch.sum(w2 * q**2 / (3.0 * eps), dim=0) / _RHO_MASSLESS
    return rho, p


class Background(NamedTuple):
    """Homogeneous quantities on the ln-a grid (all Mpc units, ℋ = aH):
    ``lna`` (n,), every table (W, n), ``tau0`` (W,)."""

    lna: torch.Tensor
    tau: torch.Tensor        # conformal time, Mpc
    conf_h: torch.Tensor     # ℋ(a), 1/Mpc
    conf_h_prime: torch.Tensor  # dℋ/dτ, 1/Mpc²
    # density parameters ρ̂_i(a) ≡ (8πG/3)ρ_i a², 1/Mpc²
    rho_g: torch.Tensor
    rho_ur: torch.Tensor
    rho_b: torch.Tensor
    rho_c: torch.Tensor
    rho_lambda: torch.Tensor
    rho_ncdm: torch.Tensor
    p_ncdm: torch.Tensor
    y_ncdm: torch.Tensor     # a m / T_ncdm0 on the grid
    tau0: torch.Tensor       # conformal age, Mpc


def _h0_mpc(h):
    return h / 2997.92458


def background_tables(par: CosmoParams, lna_min: float = -21.0,
                      n_grid: int = 4096) -> Background:
    """Expansion histories on a fixed ln-a grid (default a = 7.6e-10 … 1)."""
    par = as_batch(par)
    lna = _const(np.linspace(lna_min, 0.0, n_grid), par.h)
    a = torch.exp(lna)
    col = lambda v: v[:, None]
    h0 = col(_h0_mpc(par.h))
    h2 = col(par.h**2)

    om_g = OMEGA_G_H2 / h2
    om_ur = col(par.n_ur) * UR_FAC * OMEGA_G_H2 / h2
    om_b = col(par.omega_b) / h2
    om_c = col(par.omega_cdm) / h2

    t_ncdm0_ev = T_NCDM_FAC * TCMB_K * KB / EV
    y0 = col(par.m_ncdm) / t_ncdm0_ev
    om_ncdm_massless = par.deg_ncdm * 0.875 * T_NCDM_FAC**4 * OMEGA_G_H2 / h2
    rho_fac, p_fac = ncdm_rho_p(y0 * a)
    rho1, _ = ncdm_rho_p(y0)
    om_ncdm_today = om_ncdm_massless * rho1

    om_lambda = 1.0 - om_g - om_ur - om_b - om_c - om_ncdm_today

    e2_a2 = (
        (om_g + om_ur) / a**2
        + (om_b + om_c) / a
        + om_lambda * a**2
        + om_ncdm_massless * rho_fac / a**2
    )
    conf_h = h0 * torch.sqrt(e2_a2)

    # conformal time: cumulative trapezoid + the exact radiation-dominated
    # piece below the grid
    integrand = 1.0 / conf_h
    dlna = lna[1] - lna[0]
    cumt = torch.cat([
        torch.zeros_like(conf_h[:, :1]),
        cumsum_rows(0.5 * (integrand[:, 1:] + integrand[:, :-1]) * dlna),
    ], dim=-1)
    om_r_tot = om_g + om_ur + om_ncdm_massless * rho_fac[:, :1]
    tau_start = a[0] / (h0 * torch.sqrt(om_r_tot))
    tau = tau_start + cumt

    dlnh = gradient(torch.log(conf_h), dlna)
    conf_h_prime = conf_h**2 * dlnh

    rho = lambda om, power: h0**2 * om / a**power
    return Background(
        lna=lna, tau=tau, conf_h=conf_h, conf_h_prime=conf_h_prime,
        rho_g=rho(om_g, 4) * a**2, rho_ur=rho(om_ur, 4) * a**2,
        rho_b=rho(om_b, 3) * a**2, rho_c=rho(om_c, 3) * a**2,
        rho_lambda=h0**2 * om_lambda * a**2,
        rho_ncdm=h0**2 * om_ncdm_massless * rho_fac / a**2,
        p_ncdm=h0**2 * om_ncdm_massless * p_fac / a**2,
        y_ncdm=y0 * a,
        tau0=tau[:, -1],
    )


# ---------------------------------------------------------------------------
# recombination
# ---------------------------------------------------------------------------
def _alpha_b(tm):
    """Case-B recombination coefficient (RECFAST Hummer fit, m³/s) including
    the F = 1.14 fudge."""
    t = tm / 1.0e4
    return RECFAST_F * 4.309e-19 * t**-0.6166 / (1.0 + 0.6703 * t**0.5300)


def _saha_s(t_k, chi_ev):
    """(2π m_e k T / h²)^{3/2} e^{-χ/kT}, m⁻³ (clipped exponent)."""
    pref = (2.0 * math.pi * ME * KB * t_k / HP**2) ** 1.5
    return pref * torch.exp(torch.clamp(-chi_ev * EV / (KB * t_k), -300.0, 0.0))


def _saha_xe(t_k, n_h, f_he):
    """Equilibrium (x_H, x_HeII, x_HeIII) by fixed-point iteration over n_e
    (30 steps, as the JAX module's ``fori_loop``)."""
    s_h = _saha_s(t_k, B1_EV)
    s_he1 = 4.0 * _saha_s(t_k, CHI_HE1_EV)
    s_he2 = _saha_s(t_k, CHI_HE2_EV)

    def body(ne):
        ne = torch.maximum(ne, 1e-20 * n_h)
        x_h = s_h / (s_h + ne)
        r21 = s_he1 / ne
        r32 = s_he2 / ne
        den = 1.0 + r21 + r21 * r32
        x_he2 = r21 / den
        x_he3 = r21 * r32 / den
        return n_h * (x_h + f_he * (x_he2 + 2.0 * x_he3))

    ne = n_h * (1.0 + 2.0 * f_he)
    for _ in range(30):
        ne = body(ne)
    ne = torch.maximum(ne, 1e-20 * n_h)
    x_h = s_h / (s_h + ne)
    r21, r32 = s_he1 / ne, s_he2 / ne
    den = 1.0 + r21 + r21 * r32
    return x_h, r21 / den, r21 * r32 / den


class Thermo(NamedTuple):
    """Thermodynamic histories on the background's ln-a grid: ``lna`` (n,),
    tables (W, n), epochs (W,)."""

    lna: torch.Tensor
    xe: torch.Tensor          # n_e/n_H (without reionization)
    tm: torch.Tensor          # matter temperature, K
    dkappa: torch.Tensor      # dκ/dτ = a n_e σ_T, 1/Mpc
    cs2: torch.Tensor         # baryon sound speed squared (c=1)
    r_bg: torch.Tensor        # R ≡ 3ρ_b/(4ρ_γ)
    rs: torch.Tensor          # sound horizon ∫ c_s dτ, Mpc
    tau_drag: torch.Tensor    # conformal time of the drag epoch, Mpc
    rs_drag: torch.Tensor     # r_s(τ_drag), Mpc
    z_drag: torch.Tensor
    tau_rec: torch.Tensor     # visibility-peak conformal time (approx), Mpc


N_FINE = 32768  # the recombination recurrence's fine grid (the JAX default)


def thermo_tables(par: CosmoParams | None = None, bg: Background | None = None,
                  n_fine: int = N_FINE, stages: bool = False) -> Thermo:
    """Thermodynamic histories, downsampled onto ``bg``'s grid.

    The recombination recurrence runs on an internal fine grid (``n_fine``,
    as in the JAX module) and the results are linearly interpolated onto the
    caller's grid.  ``n_fine=0`` integrates directly on ``bg``'s grid.
    ``stages=True``: no tables, but the :class:`ThermoStages` of these
    options (``par`` and ``bg`` unused), for a caller that crosses the
    recurrence itself."""
    st = ThermoStages(n_fine)
    if stages:
        return st
    par = as_batch(par)
    bg_f, ins = st.before_scan(par, bg)
    rec = recomb_scan(*ins, scan_step(bg if bg_f is None else bg_f))
    return st.after_scan(par, bg, bg_f, ins, rec)


def scan_step(bg: Background) -> float:
    """The ln-a step of the recurrence on ``bg``'s grid."""
    return float(bg.lna[1] - bg.lna[0])


class ThermoStages(NamedTuple):
    """:func:`thermo_tables` cut at the recurrence: ``before_scan``, the
    recurrence on its inputs, ``after_scan`` give its tables.  Both stages
    are plain torch on the fields of ``par`` and the tables of ``bg``."""

    n_fine: int

    def fine_background(self, par: CosmoParams, bg: Background):
        """The background on the recurrence's fine grid; None when the
        recurrence runs on ``bg``'s grid."""
        if self.n_fine and self.n_fine > bg.lna.shape[0]:
            return background_tables(par, n_grid=self.n_fine)
        return None

    def before_scan(self, par: CosmoParams, bg: Background):
        """(:meth:`fine_background`; the recurrence's inputs on its grid)."""
        bg_f = self.fine_background(par, bg)
        return bg_f, recomb_inputs(par, bg if bg_f is None else bg_f)

    def after_scan(self, par: CosmoParams, bg: Background, bg_f, ins, rec) -> Thermo:
        """The tables from the recurrence's outputs ``rec`` (x_H, x_e, T_M)."""
        if bg_f is None:
            return _thermo_after_scan(par, bg, ins, rec)
        th_f = _thermo_after_scan(par, bg_f, ins, rec)
        g = lambda t: interp(bg.lna, th_f.lna, t)
        return Thermo(
            lna=bg.lna, xe=g(th_f.xe), tm=g(th_f.tm), dkappa=g(th_f.dkappa),
            cs2=g(th_f.cs2), r_bg=0.75 * bg.rho_b / bg.rho_g, rs=g(th_f.rs),
            tau_drag=th_f.tau_drag, rs_drag=th_f.rs_drag, z_drag=th_f.z_drag,
            tau_rec=th_f.tau_rec,
        )


# --- the recurrence: Peebles hydrogen (Crank–Nicolson) + T_M ----------------
def _peebles_rate(x, tm, tg_i, nh_i, h_i):
    alpha = _alpha_b(tm)
    beta2 = alpha * (2.0 * math.pi * ME * KB * tm / HP**2) ** 1.5 * torch.exp(
        torch.clamp(-B2_EV * EV / (KB * tm), -300.0, 0.0)
    )
    boltz = torch.exp(torch.clamp(-E21_EV * EV / (KB * tg_i), -300.0, 0.0))
    n1s = torch.clamp(1.0 - x, min=1e-12) * nh_i
    k_ly = LAM_ALPHA**3 / (8.0 * math.pi * h_i)
    c_peeb = (1.0 + k_ly * LAM_2S1S * n1s) / (
        1.0 + k_ly * (LAM_2S1S + beta2) * n1s
    )
    g = c_peeb / h_i
    return g * (beta2 * boltz * (1.0 - x) - alpha * nh_i * x**2), (g, alpha, beta2, boltz)


def _t_exp_step(t_prev, xe_mid, tg_m, h_m, f_he, dlna):
    """Exact exponential step of T' = -λT + s with frozen coefficients."""
    gamma_c = (
        8.0 * SIGMA_T * A_RAD * tg_m**4 * xe_mid
        / (3.0 * ME * C_SI * (1.0 + f_he + xe_mid))
    )
    lam = 2.0 + gamma_c / h_m
    t_eq = (gamma_c / h_m) * tg_m / lam
    return t_eq + (t_prev - t_eq) * torch.exp(-torch.clamp(lam * dlna, 0.0, 300.0))


def _recomb_step(carry, inp, f_he, dlna):
    """One step of the JAX module's ``step`` (``thermo.py:317-367``), with
    the Saha fractions of the new point precomputed."""
    x_prev, t_prev, xe_prev, was_saha = carry
    tg_o, tg_i, nh_o, nh_i, h_o, h_i, x_saha, he_term = inp
    tg_m, h_m = 0.5 * (tg_o + tg_i), 0.5 * (h_o + h_i)

    t_star = _t_exp_step(t_prev, xe_prev, tg_m, h_m, f_he, dlna)

    f_old, _ = _peebles_rate(x_prev, t_prev, tg_o, nh_o, h_o)
    theta = torch.where(was_saha, 1.0, 0.5).to(F64)  # implicit weight
    f_old = (1.0 - theta) / theta * f_old

    def solve_implicit(x_for_c):
        _, (g, alpha, beta2, boltz) = _peebles_rate(x_for_c, t_star, tg_i, nh_i, h_i)
        hd = theta * dlna
        a2 = hd * g * alpha * nh_i
        a1 = 1.0 + hd * g * beta2 * boltz
        a0 = -(x_prev + hd * f_old + hd * g * beta2 * boltz)
        disc = torch.sqrt(torch.clamp(a1**2 - 4.0 * a2 * a0, min=0.0))
        return torch.where(a2 > 1e-30, (-a1 + disc) / (2.0 * a2), -a0 / a1)

    x_star = solve_implicit(x_prev)
    x_peebles = solve_implicit(torch.clamp(x_star, 0.0, 1.0))
    use_saha = x_saha > 0.999
    x_h = torch.clamp(torch.where(use_saha, x_saha, x_peebles), 0.0, 1.0)
    xe = x_h + he_term
    t_new = _t_exp_step(t_prev, 0.5 * (xe_prev + xe), tg_m, h_m, f_he, dlna)
    return (x_h, t_new, xe, use_saha)


def recomb_scan_plain(tg, nh, hs, x_saha, he_term, f_he, dlna: float):
    """The recurrence as a step loop over the grid, batched over
    cosmologies: ``tg`` (T_γ, K), ``nh`` (n_H, m⁻³), ``hs`` (H, 1/s),
    ``x_saha`` (Saha x_H) and ``he_term`` (f_He (x_HeII + 2 x_HeIII)), each
    (W, n); ``f_he`` (W,).  Returns (x_H, x_e, T_M), each (W, n)."""
    cols = [t.unbind(-1) for t in (tg, nh, hs, x_saha, he_term)]
    tg_c, nh_c, h_c, xs_c, he_c = cols
    carry = (torch.ones_like(f_he), tg_c[0], 1.0 + 2.0 * f_he,
             torch.ones_like(f_he, dtype=torch.bool))
    xh, xe, tm = [], [], []
    for i in range(tg.shape[-1]):
        o = max(i - 1, 0)
        carry = _recomb_step(carry, (tg_c[o], tg_c[i], nh_c[o], nh_c[i], h_c[o], h_c[i],
                                     xs_c[i], he_c[i]), f_he, dlna)
        xh.append(carry[0])
        tm.append(carry[1])
        xe.append(carry[2])
    return torch.stack(xh, -1), torch.stack(xe, -1), torch.stack(tm, -1)


def _check_recomb(tg, nh, hs, x_saha, he_term, f_he):
    nw, n = tg.shape
    for name, t in (("nh", nh), ("hs", hs), ("x_saha", x_saha), ("he_term", he_term)):
        _kernels.check(name, t, (nw, n), tg)
    _kernels.check("f_he", f_he, (nw,), tg)
    return nw, n


def recomb_scan_cuda(tg, nh, hs, x_saha, he_term, f_he, dlna: float):
    """Launch ``recomb_scan`` (a parallel pre-pass of the input-only terms,
    then one thread per cosmology walks the grid)."""
    nw, n = _check_recomb(tg, nh, hs, x_saha, he_term, f_he)
    out = torch.empty((3, nw, n), dtype=F64, device=tg.device)
    work = _kernels.recomb_work(0, nw, n, tg.device)
    _kernels.launch("recomb_scan", tg.device, tg, nh, hs, x_saha, he_term, f_he, out, work,
                    ints=(nw, n), doubles=(float(dlna),))
    return out[0], out[1], out[2]


def recomb_scan_jvp_cuda(inputs, tangents, dlna: float):
    """Launch ``recomb_scan_jvp``: the recurrence and its tangent, one
    direction a cosmology.  ``inputs`` and ``tangents``: the six arguments
    of :func:`recomb_scan_cuda` and a tangent of each, of its shape.
    Returns ((x_H, x_e, T_M), their tangents)."""
    nw, n = _check_recomb(*inputs)
    for name, t, like in zip(("tg", "nh", "hs", "x_saha", "he_term", "f_he"), tangents, inputs):
        _kernels.check(f"tangent of {name}", t, like.shape, like)
    out = torch.empty((3, nw, n), dtype=F64, device=inputs[0].device)
    dout = torch.empty_like(out)  # (a base of its own: a tangent has its primal's layout)
    work = _kernels.recomb_work(1, nw, n, out.device)
    _kernels.launch("recomb_scan_jvp", inputs[0].device, *inputs, *tangents, out, dout, work,
                    ints=(nw, n), doubles=(float(dlna),))
    return (out[0], out[1], out[2]), (dout[0], dout[1], dout[2])


class _RecombScan(torch.autograd.Function):
    """``recomb_scan`` on the card for inputs that require grad: the forward
    kernel, and no reverse mode (the solver's gradient on the card is
    forward-mode, through the tangent kernel that :func:`recomb_scan`
    launches for dual inputs; ``einstein_boltzmann.EBSolver``)."""

    @staticmethod
    def forward(ctx, tg, nh, hs, x_saha, he_term, f_he, dlna):
        return recomb_scan_cuda(tg, nh, hs, x_saha, he_term, f_he, dlna)

    @staticmethod
    def backward(ctx, *grads):
        raise _kernels.no_backward("recomb_scan")


def recomb_scan(tg, nh, hs, x_saha, he_term, f_he, dlna: float):
    """The Peebles/T_M recurrence: the CUDA kernel on a CUDA tensor (forward
    AD through its tangent kernel, no reverse mode), the plain step loop on
    a CPU tensor.  Under forward AD on the card the tangent kernel alone
    runs: it gives the primal too (``dual.direct_tangents``)."""
    if not tg.is_cuda:
        return recomb_scan_plain(tg, nh, hs, x_saha, he_term, f_he, dlna)
    args = [t.contiguous() for t in (tg, nh, hs, x_saha, he_term, f_he)]
    dual = direct_tangents(*args)
    if dual is not None:
        outs, douts = recomb_scan_jvp_cuda(*dual, float(dlna))
        return tuple(forward_ad.make_dual(o, d) for o, d in zip(outs, douts))
    return _RecombScan.apply(*args, float(dlna))


def recomb_scan_jvp2_cuda(jet: Jet, dlna: float) -> Jet:
    """Launch ``recomb_scan_jvp2``: the recurrence and its second order, one
    pair of directions a row.  ``jet``: the six arguments of
    :func:`recomb_scan_cuda` with their parts in the directions p and q and
    their mixed parts.  Returns the jet of (x_H, x_e, T_M)."""
    inputs = [t.contiguous() for t in jet.v]
    nw, n = _check_recomb(*inputs)
    names = ("tg", "nh", "hs", "x_saha", "he_term", "f_he")
    parts = [torch.stack(p, -1).contiguous() for p in zip(jet.a, jet.b, jet.ab)]
    for name, t, like in zip(names, parts, inputs):
        _kernels.check(f"parts of {name}", t, (*like.shape, 3), like)
    out = torch.empty((3, nw, n), dtype=F64, device=inputs[0].device)
    dout = torch.empty((3, nw, n, 3), dtype=F64, device=inputs[0].device)
    work = _kernels.recomb_work(3, nw, n, out.device)
    _kernels.launch("recomb_scan_jvp2", inputs[0].device, *inputs, *parts, out, dout, work,
                    ints=(nw, n), doubles=(float(dlna),))
    return Jet(tuple(out.unbind(0)), *(tuple(dout[..., i].unbind(0)) for i in range(3)))


def recomb_scan_jvp2_plain(jet: Jet, dlna: float) -> Jet:
    """The second order of :func:`recomb_scan_plain`: the step loop on
    hyper-dual operands (``jet.HyperDual``)."""
    return as_jet(recomb_scan_plain(*hyper(jet), dlna))


def recomb_scan_jvp2(jet: Jet, dlna: float) -> Jet:
    """The recurrence's jet (:func:`recomb_scan_jvp2_cuda` on the card, the
    plain version on the CPU)."""
    if jet.v[0].is_cuda:
        return recomb_scan_jvp2_cuda(jet, dlna)
    return recomb_scan_jvp2_plain(jet, dlna)


def recomb_inputs(par: CosmoParams, bg: Background):
    """The recurrence's carry-free inputs on ``bg``'s grid: (T_γ, n_H, H in
    1/s, Saha x_H, f_He (x_HeII + 2 x_HeIII), f_He (W,))."""
    a = torch.exp(bg.lna)
    tg = (TCMB_K / a).expand_as(bg.conf_h).contiguous()
    f_he = par.yhe / (4.0 * (1.0 - par.yhe))
    n_h0 = (1.0 - par.yhe) * par.omega_b * RHO_CRIT_H2 / MH  # m⁻³ today
    n_h = n_h0[:, None] / a**3
    h_si = bg.conf_h / a * (C_SI / MPC_M)
    x_saha, x_he2, x_he3 = _saha_xe(tg, n_h, f_he[:, None])
    he_term = f_he[:, None] * (x_he2 + 2.0 * x_he3)
    return tg, n_h, h_si, x_saha, he_term, f_he


def _thermo_after_scan(par: CosmoParams, bg: Background, ins, rec) -> Thermo:
    """The tables on the recurrence's grid ``bg`` from its inputs ``ins``
    and outputs ``rec``."""
    lna = bg.lna
    a = torch.exp(lna)
    dlna = lna[1] - lna[0]

    tg, n_h, h_si, x_saha, he_term, f_he = ins
    xh, xe, tm = rec

    dkappa = a * xe * n_h * SIGMA_T * MPC_M  # 1/Mpc

    # baryon sound speed c_s² = kT/(μ m_H c²)(1 - ⅓ dlnT/dlna)
    fh = f_he[:, None]
    mu = (1.0 + 4.0 * fh) / (1.0 + fh + xe)
    dlntm = gradient(torch.log(tm), dlna)
    cs2 = KB * tm / (mu * MH * C_SI**2) * (1.0 - dlntm / 3.0)

    r_bg = 0.75 * bg.rho_b / bg.rho_g

    # sound horizon r_s(τ) = ∫ dτ/sqrt(3(1+R)), exact RD start τ(a0)/√3
    integ = 1.0 / (bg.conf_h * torch.sqrt(3.0 * (1.0 + r_bg)))
    rs = torch.cat([
        torch.zeros_like(integ[:, :1]),
        cumsum_rows(0.5 * (integ[:, 1:] + integ[:, :-1]) * dlna),
    ], dim=-1)
    rs = rs + bg.tau[:, :1] / math.sqrt(3.0)

    # drag depth from the LATE end (suffix sum; see the JAX module)
    suffix = lambda mid: torch.cat(
        [cumsum_rows(mid.flip(-1)).flip(-1), torch.zeros_like(mid[:, :1])], dim=-1)
    ointeg = dkappa / (r_bg * bg.conf_h)
    drag = suffix(0.5 * (ointeg[:, 1:] + ointeg[:, :-1]) * dlna)
    # z_drag: the drag depth crosses 1; three-point quadratic root in log
    n = lna.shape[0]
    one = torch.full_like(drag[:, :1], -1.0)
    idx = torch.searchsorted((-drag).contiguous(), one).clamp(2, n - 1)
    at = lambda t, i: torch.gather(t, -1, i)[:, 0]
    y0 = torch.log(torch.clamp(at(drag, idx - 2), min=1e-300))
    y1 = torch.log(torch.clamp(at(drag, idx - 1), min=1e-300))
    y2 = torch.log(torch.clamp(at(drag, idx), min=1e-300))
    a_q = 0.5 * (y2 - 2.0 * y1 + y0)
    b_q = 0.5 * (y2 - y0)
    disc = torch.sqrt(torch.clamp(b_q**2 - 4.0 * a_q * y1, min=0.0))
    s_root = 2.0 * y1 / (-b_q + disc)
    s_root = torch.clamp(torch.where(torch.isfinite(s_root), s_root, -y1 / b_q), 0.0, 1.0)
    lna_drag = lna[idx[:, 0] - 1] + s_root * (lna[1] - lna[0])
    tau_drag = interp(lna_drag[:, None], lna, bg.tau)[:, 0]
    rs_drag = interp(lna_drag[:, None], lna, rs)[:, 0]
    z_drag = torch.exp(-lna_drag) - 1.0

    # optical depth to today and the visibility peak
    kinteg = dkappa / bg.conf_h
    kappa = suffix(0.5 * (kinteg[:, 1:] + kinteg[:, :-1]) * dlna)
    vis = dkappa * torch.exp(-torch.clamp(kappa, 0.0, 200.0))
    tau_rec = at(bg.tau, torch.argmax(vis, dim=-1, keepdim=True))

    return Thermo(
        lna=lna, xe=xe, tm=tm, dkappa=dkappa, cs2=cs2, r_bg=r_bg, rs=rs,
        tau_drag=tau_drag, rs_drag=rs_drag, z_drag=z_drag, tau_rec=tau_rec,
    )
