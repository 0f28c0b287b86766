"""Linear Einstein–Boltzmann solver, synchronous gauge (counterpart of
``eftpipe_tpu/boltzmann/einstein_boltzmann.py``).

The physics is the JAX module's: photons (Θ_l, G_l), baryons, CDM, massless
neutrinos (F_l), one massive species on a Gauss–Laguerre momentum grid
(Ψ_l(q)); first-order tight coupling with its closed-form slip; explicit RK4
in ln a on a per-mode step schedule built on the host from fiducial (or
envelope) tables; the primordial normalisation by ζ at the initial time,
P(k) = P_ζ(k) |δ_m(k, τ) / ζ_ini|².

Differences from the JAX module:

* a batch of cosmologies: :class:`CosmoParams` fields are ``(W,)``, the
  tables ``(W, ...)``, and every output carries the leading ``W``;
* the state vector is the LAST axis of a ``(W, nk, NSTATE)`` tensor, the
  per-mode functions (``_rhs``, ``_rk4_advance``, ...) broadcast over the
  leading axes;
* ``solve_k``/``solve_perturbations`` (a ``lax.scan`` per mode, ``vmap``-ed
  over modes) are :func:`eb_solve`: on a CUDA tensor the kernel ``eb_solve``
  of ``csrc/boltzmann.cu``, one warp per (cosmology, mode) walking its
  mode's unpadded schedule in one launch per solve; on a CPU tensor
  :func:`eb_solve_plain`, a step loop batched over (cosmology, mode) on the
  lockstep-padded schedule (padded steps are exact no-ops: dlna = 0, TCA
  off).  The plain versions are differentiable by autograd, twice;
* the gradient on the card is forward-mode.  Neither kernel has a reverse
  mode; each has a tangent kernel for ``torch.autograd.forward_ad``
  (``eb_solve_jvp``, ``recomb_scan_jvp``).  When the solver's parameters
  are on the card and require grad, :class:`EBSolver` runs the part of the
  solve that depends on the tables as one ``torch.autograd.Function``
  (``_SolverTables``): the primal with the forward kernels, then one pass
  under forward AD on W·P rows (row (w, p) seeded with the p-th of the P
  differentiated fields among ω_b, ω_cdm, h, m_ncdm, N_ur and Y_He), whose
  tangents are the Jacobian that its backward contracts.  That pass
  launches only the tangent kernels, which give the primal too.  Its second
  derivative (a backward with ``create_graph=True``: ``Analysis.laplace_cov``)
  is forward-mode too: :meth:`EBSolver.table_hessians`, one pass on
  W·P(P+1)/2 rows, one pair of fields a row, each quantity a jet (value, two
  first-order parts, the mixed part; ``boltzmann/jet.py``), the plain stages
  by nested ``torch.func.jvp`` and each recurrence by its hyper-dual kernel
  (``recomb_scan_jvp2``, ``eb_solve_jvp2``), made only when a double backward
  reaches it.  A third derivative raises;
* always float64; :class:`SolverProvider` casts its outputs to the dtype
  of the parameters it is given.

The schedule (``build_schedule``, ``bucket_indices``, ``out_indices``,
``solver_k_grid``) is host NumPy, copied verbatim: built from the same
tables it gives the JAX module's grids bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import forward_ad

from .. import resolve_device
from . import _kernels
from .dual import DenseTangents, direct_tangents, tangent_or_zeros
from .jet import HyperDual, Jet, as_jet, hessian_of, jet_call, pair_rows
from .thermo import (
    CosmoParams, Background, Thermo, as_batch, background_tables, thermo_tables,
    gradient, interp, recomb_scan_jvp2, scan_step, _const, _h0_mpc, F64,
)

# hierarchy truncations (CLASS P(k)-grade defaults)
LMAX_G = 12     # photon temperature
LMAX_P = 10     # photon polarization
LMAX_UR = 16    # massless neutrinos
LMAX_NC = 10    # massive neutrinos
NQ_NC = 5       # momentum nodes for massive neutrinos

_qnc, _wnc = np.polynomial.laguerre.laggauss(NQ_NC)
_F0 = 1.0 / (np.exp(_qnc) + 1.0)
# weights for ∫ q² f0(q) (…) dq, Laguerre-folded
W_NC = _wnc * _qnc**2 * np.exp(_qnc) * _F0
Q_NC = _qnc
DLNF = -_qnc * (1.0 - _F0)  # dln f0 / dln q

# state layout offsets
_I_ETA = 0
_I_DC = 1
_I_DB = 2
_I_TB = 3
_I_DG = 4                      # δ_γ
_I_TG = 5                      # θ_γ
_I_F = 6                       # F_γ2 … F_γLMAX_G   (LMAX_G-1 entries)
_I_G = _I_F + (LMAX_G - 1)     # G_γ0 … G_γLMAX_P   (LMAX_P+1 entries)
_I_UR = _I_G + (LMAX_P + 1)    # δ_ν, θ_ν, F_ν2 … F_νLMAX_UR
_I_NC = _I_UR + (LMAX_UR + 1)  # Ψ_l(q): (NQ_NC, LMAX_NC+1) flattened
NSTATE = _I_NC + NQ_NC * (LMAX_NC + 1)

TCA_K = 0.04
TCA_H = 0.015
N_ROWS = 14  # rows of the stacked tables (make_tables)


class PerturbOut(NamedTuple):
    delta_m: torch.Tensor    # (W, nz, nk) comoving-gauge total-matter density
    delta_cb: torch.Tensor   # (W, nz, nk) CDM+baryon only
    zeta_ini: torch.Tensor   # (W, nk) super-horizon curvature at the start


# ---------------------------------------------------------------------------
# step schedules (host NumPy, a copy of the JAX module's)
# ---------------------------------------------------------------------------
class HostBackground(NamedTuple):
    """One cosmology's background tables as NumPy arrays (the fields
    :func:`build_schedule` reads)."""

    lna: np.ndarray
    tau: np.ndarray
    conf_h: np.ndarray
    rho_g: np.ndarray
    rho_b: np.ndarray


class HostThermo(NamedTuple):
    dkappa: np.ndarray
    tau_rec: float


def host_tables(bg: Background, th: Thermo) -> tuple[list, list]:
    """Per-cosmology NumPy copies of batched tables, for :func:`build_schedule`."""
    np_ = lambda t: t.detach().cpu().numpy()
    lna = np_(bg.lna)
    tau, conf_h, rho_g, rho_b = np_(bg.tau), np_(bg.conf_h), np_(bg.rho_g), np_(bg.rho_b)
    dk, trec = np_(th.dkappa), np_(th.tau_rec)
    bgs = [HostBackground(lna, tau[i], conf_h[i], rho_g[i], rho_b[i]) for i in range(tau.shape[0])]
    ths = [HostThermo(dk[i], float(trec[i])) for i in range(tau.shape[0])]
    return bgs, ths


def build_schedule(k_mpc: np.ndarray, bg, th, lna_out: np.ndarray,
                   phase_acc: float = 0.22, phase_post: float = 2.0,
                   tca_k: float = TCA_K, tca_h: float = TCA_H,
                   dlna_max: float = 0.04, x_ini: float = 0.03,
                   a_ini_max: float = 1e-5, pad: bool = True):
    """Per-k ln-a step grids (nk, nsteps+1), padded with repeats at the end.

    ``bg``/``th``: one cosmology's tables (``HostBackground``/``HostThermo``
    or the JAX module's NamedTuples) or equal-length lists of them; a list
    builds the conservative envelope over its members (see the JAX
    module)."""
    def as_list(x):
        return list(x) if isinstance(x, (list, tuple)) and not hasattr(
            x, "_fields") else [x]

    bgs = as_list(bg)
    ths = as_list(th)
    lna_out = np.sort(np.asarray(lna_out))

    lna0 = min(float(np.asarray(b.lna)[0]) for b in bgs)
    dense = np.linspace(lna0, 0.0, 16384)
    hh_c, tt_c, stiff_c, tca_c, taug_c = [], [], [], [], []
    tau_rec = max(float(t.tau_rec) for t in ths)
    for b, t in zip(bgs, ths):
        lna = np.asarray(b.lna)
        tau_c = 1.0 / np.maximum(np.asarray(t.dkappa), 1e-30)
        hh_i = np.interp(dense, lna, np.asarray(b.conf_h))
        tc_i = np.interp(dense, lna, tau_c)
        r_gb = (4.0 / 3.0) * np.interp(dense, lna, np.asarray(b.rho_g)) \
            / np.interp(dense, lna, np.asarray(b.rho_b))
        hh_c.append(hh_i)
        tt_c.append(np.interp(dense, lna, np.asarray(b.tau)))
        stiff_c.append(0.8 * tc_i * hh_i / (1.0 + r_gb))
        tca_c.append(tc_i)
        taug_c.append((np.asarray(b.tau), lna))
    hh = np.min(hh_c, axis=0)
    tt = np.max(tt_c, axis=0)
    stiff_env = np.min(stiff_c, axis=0)
    tc_max = np.max(tca_c, axis=0)
    hh_max = np.max(hh_c, axis=0)

    grids, masks = [], []
    for k in np.asarray(k_mpc):
        lna_ini = min(np.log(a_ini_max),
                      min(float(np.interp(x_ini / k, tau_i, lna_i))
                          for tau_i, lna_i in taug_c))
        in_tca = (tc_max * k < tca_k) & (tc_max * hh_max < tca_h)
        phase = np.where(tt < 3.0 * tau_rec, phase_acc, phase_post)
        d = np.minimum(dlna_max, phase * hh / k)
        d = np.where(in_tca, d, np.minimum(d, np.maximum(stiff_env, 1e-6)))
        mask = dense >= lna_ini
        x = dense[mask]
        integ = 1.0 / d[mask]
        s = np.concatenate([
            [0.0], np.cumsum(0.5 * (integ[1:] + integ[:-1]) * np.diff(x)),
        ])
        nsteps = int(np.ceil(s[-1]))
        grid = np.interp(np.arange(nsteps + 1) * s[-1] / nsteps, s, x)
        grid[0], grid[-1] = lna_ini, 0.0
        for lo in lna_out:
            if lo < grid[-1] - 1e-12:
                i = int(np.searchsorted(grid, lo))
                if abs(grid[min(i, grid.size - 1)] - lo) > 1e-12 and \
                   abs(grid[i - 1] - lo) > 1e-12:
                    grid = np.insert(grid, i, lo)
        grids.append(grid)
        masks.append(np.interp(grid, dense, in_tca.astype(float)) > 0.999)

    if pad:
        return _pad_grids(grids), _pad_masks(masks)
    return grids, masks


def _pad_grids(grids: list) -> np.ndarray:
    n = max(g.size for g in grids)
    out = np.empty((len(grids), n))
    for i, g in enumerate(grids):
        out[i, : g.size] = g
        out[i, g.size:] = g[-1]  # padded no-op steps (dlna = 0)
    return out


def _pad_masks(masks: list) -> np.ndarray:
    n = max(m.size for m in masks)
    out = np.zeros((len(masks), n), dtype=bool)
    for i, m in enumerate(masks):
        out[i, : m.size] = m
    return out


def bucket_indices(lengths, waste: float = 1.3) -> list:
    """Group k-modes by schedule length (see the JAX module)."""
    order = np.argsort(lengths)
    buckets, cur = [], [order[0]]
    for i in order[1:]:
        if lengths[i] > waste * lengths[cur[0]]:
            buckets.append(np.asarray(cur))
            cur = [i]
        else:
            cur.append(i)
    buckets.append(np.asarray(cur))
    return buckets


def out_indices(grids: np.ndarray, lna_out: np.ndarray) -> np.ndarray:
    """(nz, nk) index of each output time in each k's grid."""
    idx = np.empty((len(lna_out), grids.shape[0]), dtype=np.int32)
    for j, lo in enumerate(np.sort(np.asarray(lna_out))):
        for i in range(grids.shape[0]):
            hits = np.nonzero(np.abs(grids[i] - lo) < 1e-12)[0]
            idx[j, i] = hits[0] if hits.size else grids.shape[1] - 1
    return idx


# ---------------------------------------------------------------------------
# tables and the per-mode right-hand side (broadcast over leading axes)
# ---------------------------------------------------------------------------
class EBTables(NamedTuple):
    """Background/thermo tables re-packed for the solve.  ``stacked`` (W, 14,
    n) rows: ℋ, ℋ', ρ̂_γ, ρ̂_b, ρ̂_c, ρ̂_ur, ρ̂_nc-norm, y_ncdm, κ', c_s²,
    dc_s²/dτ, 4ρ_γ/3ρ_b, dτ_c/dτ, τ — all on the uniform ln-a grid ``lna``
    (n,) of spacing ``dlna``."""

    lna: torch.Tensor
    dlna: torch.Tensor
    tau: torch.Tensor
    stacked: torch.Tensor


def _ncdm_rho_ratio(y):
    eps = torch.sqrt(_const(Q_NC, y)[:, None, None] ** 2 + y[None] ** 2)
    return torch.sum(_const(W_NC, y)[:, None, None] * eps, dim=0)


def make_tables(par: CosmoParams, bg: Background, th: Thermo) -> EBTables:
    dlna = bg.lna[1] - bg.lna[0]
    dtau = 1.0 / bg.conf_h  # dτ/dlna
    cs2_prime = gradient(th.cs2, dlna) / dtau
    tau_c = 1.0 / torch.clamp(th.dkappa, min=1e-30)
    tauc_dot = gradient(tau_c, dlna) / dtau
    rho_nc_norm = bg.rho_ncdm / torch.clamp(_ncdm_rho_ratio(bg.y_ncdm), min=1e-300)
    stacked = torch.stack([
        bg.conf_h, bg.conf_h_prime, bg.rho_g, bg.rho_b, bg.rho_c, bg.rho_ur,
        rho_nc_norm, bg.y_ncdm, th.dkappa, th.cs2, cs2_prime,
        (4.0 / 3.0) * bg.rho_g / bg.rho_b, tauc_dot, bg.tau,
    ], dim=1)
    return EBTables(lna=bg.lna, dlna=dlna, tau=bg.tau, stacked=stacked)


def _rows_at(tab: EBTables, lna, rows=slice(None)):
    """Linear interpolation of the stacked rows at ``lna`` (any shape, shared
    by the cosmologies): (W, nrows, *lna.shape).  Index arithmetic on the
    uniform grid, floor → clip to [0, n-2], weight clipped to [0, 1]."""
    n = tab.lna.shape[0]
    x = (lna - tab.lna[0]) / tab.dlna
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    w = torch.clamp(x - i0, 0.0, 1.0)
    st = tab.stacked[:, rows]
    flat = i0.reshape(-1)
    lo = st[..., flat].reshape(*st.shape[:-1], *lna.shape)
    hi = st[..., flat + 1].reshape(*st.shape[:-1], *lna.shape)
    return lo * (1.0 - w) + hi * w


def _eps(y_nc):
    return torch.sqrt(_const(Q_NC, y_nc) ** 2 + y_nc[..., None] ** 2)


def _bgv_tau(tab: EBTables, lna):
    """(bgv, τ) at ``lna``: bgv the 13 background/thermo values of the JAX
    module's ``_bgv_at`` (each (W, *lna.shape); ``eps`` with a last axis of
    NQ_NC), τ the last row."""
    (conf_h, conf_hp, rho_g, rho_b, rho_c, rho_ur, rho_nc_norm, y_nc,
     kappa_dot, cs2, cs2_prime, r_gb, tauc_dot, tau) = _rows_at(tab, lna).unbind(1)
    return (conf_h, conf_hp, rho_g, rho_b, rho_c, rho_ur, rho_nc_norm, _eps(y_nc),
            kappa_dot, cs2, cs2_prime, r_gb, tauc_dot), tau


def _bgv_at(tab: EBTables, lna):
    return _bgv_tau(tab, lna)[0]


def _tau_at(tab: EBTables, lna):
    return _rows_at(tab, lna, slice(13, 14))[:, 0]


def _row_at(tab: EBTables, row: int, lna):
    return _rows_at(tab, lna, slice(row, row + 1))[:, 0]


def _einstein(y, k, rho, par_free):
    """(h', η') from the 00 and 0i Einstein constraints."""
    rho_g, rho_b, rho_c, rho_ur, conf_h = rho
    nc_drho, nc_thetap = par_free
    s = lambda i: y[..., i]
    drho = (
        rho_g * s(_I_DG) + rho_b * s(_I_DB) + rho_c * s(_I_DC)
        + rho_ur * s(_I_UR) + nc_drho
    )
    h_prime = (2.0 / conf_h) * (k**2 * s(_I_ETA) + 1.5 * drho)
    rpt = (
        (4.0 / 3.0) * (rho_g * s(_I_TG) + rho_ur * s(_I_UR + 1))
        + rho_b * s(_I_TB) + nc_thetap
    )
    eta_prime = 1.5 * rpt / k**2
    return h_prime, eta_prime


def _psi(y):
    return y[..., _I_NC:].reshape(*y.shape[:-1], NQ_NC, LMAX_NC + 1)


def _ncdm_moments(y, rho_nc_norm, eps):
    """(δρ, (ρ+p)θ/k) of the massive species from the Ψ_l(q) block."""
    psi = _psi(y)
    drho = rho_nc_norm * torch.sum(_const(W_NC, y) * eps * psi[..., 0], dim=-1)
    thetap = rho_nc_norm * torch.sum(_const(W_NC * Q_NC, y) * psi[..., 1], dim=-1)
    return drho, thetap


def _hier(k, lo, hi, ls):
    """(k/(2l+1)) (l X_{l-1} − (l+1) X_{l+1}) over a block of moments."""
    return (k[..., None] / (2.0 * ls + 1.0)) * (ls * lo - (ls + 1.0) * hi)


def _rhs(y, k, tau, bgv, tca):
    """dy/dτ (the state on the last axis).  ``bgv`` bundles the interpolated
    background/thermo values, ``tca`` selects the tight-coupling branch."""
    (conf_h, conf_hp, rho_g, rho_b, rho_c, rho_ur, rho_nc_norm, eps,
     kappa_dot, cs2, cs2_prime, r_gb, tauc_dot) = bgv
    shape = y.shape[:-1]
    k = k.expand(shape)
    tca = torch.as_tensor(tca, device=y.device).expand(shape)
    s = lambda i: y[..., i]
    zero = torch.zeros_like(y[..., :1])

    nc_drho, nc_thetap_k = _ncdm_moments(y, rho_nc_norm, eps)
    h_prime, eta_prime = _einstein(
        y, k, (rho_g, rho_b, rho_c, rho_ur, conf_h), (nc_drho, k * nc_thetap_k))
    alpha_k2 = 0.5 * h_prime + 3.0 * eta_prime

    dg, tg = s(_I_DG), s(_I_TG)
    db, tb = s(_I_DB), s(_I_TB)
    sig = 0.5 * s(_I_F)
    g0, g2 = s(_I_G), s(_I_G + 2)
    tau_c = 1.0 / torch.clamp(kappa_dot, min=1e-30)

    # ---- exact (post-TCA) photon/baryon momentum equations
    tb_dot_full = -conf_h * tb + cs2 * k**2 * db + r_gb * kappa_dot * (tg - tb)
    tg_dot_full = k**2 * (0.25 * dg - sig) + kappa_dot * (tb - tg)

    # ---- first-order TCA (σ_γ and slip from the tight hierarchy)
    sig_tca = (16.0 / 45.0) * tau_c * (tg + alpha_k2)
    r = r_gb
    opr = 1.0 + r
    d_big = -conf_h * tb + cs2 * k**2 * db - 0.25 * k**2 * dg
    s0 = tau_c * d_big / opr
    theta_dot0 = (
        -conf_h * tb + cs2 * k**2 * db + r * k**2 * (0.25 * dg - sig_tca)
    ) / opr
    db_dot = -tb - 0.5 * h_prime
    dg_dot = -(4.0 / 3.0) * tg - (2.0 / 3.0) * h_prime
    d_big_dot = (
        -conf_hp * tb - conf_h * theta_dot0
        + cs2_prime * k**2 * db + cs2 * k**2 * db_dot - 0.25 * k**2 * dg_dot
    )
    s0_dot = s0 * (tauc_dot * kappa_dot + conf_h * r / opr) + tau_c * d_big_dot / opr
    s1 = tau_c * (d_big + k**2 * sig_tca - s0_dot) / opr
    s_dot = d_big + k**2 * sig_tca - opr * s1 / tau_c
    tb_dot_tca = (
        -conf_h * tb + cs2 * k**2 * db + r * (k**2 * (0.25 * dg - sig_tca) + s_dot)
    ) / opr
    tg_dot_tca = tb_dot_tca - s_dot

    # ---- photon temperature hierarchy (l >= 2), exact branch only
    fl = y[..., _I_F:_I_F + LMAX_G - 1]
    f1 = 4.0 * tg / (3.0 * k)
    ls = torch.arange(2, LMAX_G + 1, dtype=y.dtype, device=y.device)
    dfl = _hier(k, torch.cat([f1[..., None], fl[..., :-1]], -1),
                torch.cat([fl[..., 1:], zero], -1), ls) - kappa_dot[..., None] * fl
    dfl0 = dfl[..., 0] + (
        (4.0 / 15.0) * h_prime + (8.0 / 5.0) * eta_prime
        + kappa_dot * (0.1 * fl[..., 0] + 0.1 * (g0 + g2)))
    dfl_last = k * fl[..., -2] - ((LMAX_G + 1.0) / tau + kappa_dot) * fl[..., -1]
    dfl = torch.cat([dfl0[..., None], dfl[..., 1:-1], dfl_last[..., None]], -1)

    # ---- polarization
    gl = y[..., _I_G:_I_G + LMAX_P + 1]
    lsp = torch.arange(0, LMAX_P + 1, dtype=y.dtype, device=y.device)
    src = 0.5 * (fl[..., 0] + g0 + g2)
    dgl = _hier(k, torch.cat([zero, gl[..., :-1]], -1), torch.cat([gl[..., 1:], zero], -1),
                lsp) - kappa_dot[..., None] * gl
    dgl_last = k * gl[..., -2] - ((LMAX_P + 1.0) / tau + kappa_dot) * gl[..., -1]
    dgl = torch.cat([(dgl[..., 0] + kappa_dot * src)[..., None], dgl[..., 1:2],
                     (dgl[..., 2] + kappa_dot * src / 5.0)[..., None], dgl[..., 3:-1],
                     dgl_last[..., None]], -1)
    zeros_g = torch.zeros_like(dfl)
    dfl = torch.where(tca[..., None], zeros_g, dfl)
    dgl = torch.where(tca[..., None], torch.zeros_like(dgl), dgl)

    # ---- massless neutrinos
    dn, tn = s(_I_UR), s(_I_UR + 1)
    fn = y[..., _I_UR + 2:_I_UR + LMAX_UR + 1]
    fn1 = 4.0 * tn / (3.0 * k)
    lsn = torch.arange(2, LMAX_UR + 1, dtype=y.dtype, device=y.device)
    dfn = _hier(k, torch.cat([fn1[..., None], fn[..., :-1]], -1),
                torch.cat([fn[..., 1:], zero], -1), lsn)
    dfn0 = dfn[..., 0] + ((4.0 / 15.0) * h_prime + (8.0 / 5.0) * eta_prime)
    dfn_last = k * fn[..., -2] - ((LMAX_UR + 1.0) / tau) * fn[..., -1]
    dfn = torch.cat([dfn0[..., None], dfn[..., 1:-1], dfn_last[..., None]], -1)

    # ---- massive neutrinos (Ψ_l(q) hierarchy, MB95 56-58)
    psi = _psi(y)
    q = _const(Q_NC, y)
    dlnf = _const(DLNF, y)
    x = q * k[..., None] / eps
    zq = torch.zeros_like(psi[..., :1])
    lsnc = torch.arange(0, LMAX_NC + 1, dtype=y.dtype, device=y.device)
    dpsi = (x[..., None] / (2.0 * lsnc + 1.0)) * (
        lsnc * torch.cat([zq, psi[..., :-1]], -1) - (lsnc + 1.0) * torch.cat([psi[..., 1:], zq], -1))
    p0 = dpsi[..., 0] + (h_prime / 6.0)[..., None] * dlnf
    p2 = dpsi[..., 2] + (-(h_prime / 15.0 + 2.0 * eta_prime / 5.0))[..., None] * dlnf
    p_last = (x * psi[..., -2]
              - ((LMAX_NC + 1.0) * eps / torch.clamp(q * k[..., None] * tau[..., None], min=1e-30))
              * x * psi[..., -1])
    dpsi = torch.cat([p0[..., None], dpsi[..., 1:2], p2[..., None], dpsi[..., 3:-1],
                      p_last[..., None]], -1)

    head = torch.stack([
        eta_prime, -0.5 * h_prime, db_dot,
        torch.where(tca, tb_dot_tca, tb_dot_full), dg_dot,
        torch.where(tca, tg_dot_tca, tg_dot_full),
    ], -1)
    ur_head = torch.stack([-(4.0 / 3.0) * tn - (2.0 / 3.0) * h_prime,
                           k**2 * (0.25 * dn - 0.5 * fn[..., 0])], -1)
    return torch.cat([head, dfl, dgl, ur_head, dfn, dpsi.flatten(-2)], -1)


def _tca_project(y, k, bgv):
    """Overwrite the fast photon moments with their tight-coupling values."""
    (conf_h, conf_hp, rho_g, rho_b, rho_c, rho_ur, rho_nc_norm, eps,
     kappa_dot, *_rest) = bgv
    k = k.expand(y.shape[:-1])
    nc_drho, nc_thetap_k = _ncdm_moments(y, rho_nc_norm, eps)
    h_prime, eta_prime = _einstein(
        y, k, (rho_g, rho_b, rho_c, rho_ur, conf_h), (nc_drho, k * nc_thetap_k))
    tau_c = 1.0 / torch.clamp(kappa_dot, min=1e-30)
    sig = (16.0 / 45.0) * tau_c * (y[..., _I_TG] + 0.5 * h_prime + 3.0 * eta_prime)
    f2 = 2.0 * sig
    z = lambda n: torch.zeros_like(y[..., :n])
    return torch.cat([
        y[..., :_I_F], f2[..., None], z(LMAX_G - 2),
        (1.25 * f2)[..., None], z(1), (0.25 * f2)[..., None], z(LMAX_P - 2),
        y[..., _I_UR:],
    ], -1)


def _nc_rho(eps):
    return torch.sum(_const(W_NC, eps) * eps, dim=-1)


def _ic_state(k, lna0, tab: EBTables, rv):
    """MB95 (96) adiabatic initial conditions, C = 1/2: (W, *k.shape, NSTATE)."""
    c = 0.5
    x = k * _tau_at(tab, lna0)
    dg = -(2.0 / 3.0) * c * x**2
    tg = -(c / 18.0) * k * x**3
    eta = 2.0 * c - c * (5.0 + 4.0 * rv) / (6.0 * (15.0 + 4.0 * rv)) * x**2
    tn = -c * k * x**3 * (23.0 + 4.0 * rv) / (18.0 * (15.0 + 4.0 * rv))
    sn = (4.0 * c / (3.0 * (15.0 + 4.0 * rv))) * x**2
    eps = _eps(_row_at(tab, 7, lna0))
    dlnf = _const(DLNF, eps)
    q = _const(Q_NC, eps)
    psi0 = -0.25 * dg[..., None] * dlnf
    psi1 = -(eps / (3.0 * q * k[..., None])) * tn[..., None] * dlnf
    psi2 = -0.5 * sn[..., None] * dlnf
    psi = torch.stack([psi0, psi1, psi2], -1)
    psi = torch.cat([psi, torch.zeros_like(psi[..., :1]).expand(*psi.shape[:-1], LMAX_NC - 2)], -1)
    zero = torch.zeros_like(dg)
    head = torch.stack([eta, 0.75 * dg, 0.75 * dg, tg, dg, tg], -1)
    return torch.cat([
        head, zero[..., None].expand(*zero.shape, _I_UR - _I_F),
        torch.stack([dg, tn, 2.0 * sn], -1),
        zero[..., None].expand(*zero.shape, _I_NC - _I_UR - 3),
        psi.flatten(-2),
    ], -1)


def _zeta(y, k, bgv):
    """Uniform-density curvature ζ = -η + δρ/3(ρ+p) (super-horizon)."""
    (conf_h, _hp, rho_g, rho_b, rho_c, rho_ur, rho_nc_norm, eps, *_rest) = bgv
    nc_drho, _ = _ncdm_moments(y, rho_nc_norm, eps)
    s = lambda i: y[..., i]
    drho = (rho_g * s(_I_DG) + rho_b * s(_I_DB) + rho_c * s(_I_DC)
            + rho_ur * s(_I_UR) + nc_drho)
    rpp = (4.0 / 3.0) * (rho_g + rho_ur + rho_nc_norm * _nc_rho(eps)) + rho_b + rho_c
    return -s(_I_ETA) + drho / (3.0 * rpp)


def _ic_and_zeta(tab: EBTables, k, lna0):
    """Initial states + their super-horizon curvature at the schedules'
    starts ``lna0`` (shape of ``k``)."""
    y_nc0 = _row_at(tab, 7, lna0)
    rv_num = _row_at(tab, 5, lna0) + _row_at(tab, 6, lna0) * _nc_rho(_eps(y_nc0))
    rv = rv_num / (rv_num + _row_at(tab, 2, lna0))
    y0 = _ic_state(k, lna0, tab, rv)
    return y0, _zeta(y0, k, _bgv_at(tab, lna0))


def _rk4_advance(y, k, tab: EBTables, lna_a, lna_b, tca, tca_b):
    """One RK4 step in ln a (dy/dlna = dy/dτ / ℋ) + TCA projection."""
    bgv_a, tau_a = _bgv_tau(tab, lna_a)
    bgv_m, tau_m = _bgv_tau(tab, 0.5 * (lna_a + lna_b))
    bgv_b, tau_b = _bgv_tau(tab, lna_b)

    d1 = (lna_b - lna_a)[..., None]
    f1 = _rhs(y, k, tau_a, bgv_a, tca) / bgv_a[0][..., None]
    y2 = y + 0.5 * d1 * f1
    f2 = _rhs(y2, k, tau_m, bgv_m, tca) / bgv_m[0][..., None]
    y3 = y + 0.5 * d1 * f2
    f3 = _rhs(y3, k, tau_m, bgv_m, tca) / bgv_m[0][..., None]
    y4 = y + d1 * f3
    f4 = _rhs(y4, k, tau_b, bgv_b, tca) / bgv_b[0][..., None]
    y_new = y + (d1 / 6.0) * (f1 + 2.0 * f2 + 2.0 * f3 + f4)
    tca_b = torch.as_tensor(tca_b, device=y.device).expand(y.shape[:-1])
    return torch.where(tca_b[..., None], _tca_project(y_new, k, bgv_b), y_new), bgv_b


def _delta_m(y, k, bgv):
    """Comoving-gauge total-matter and cb density contrasts."""
    (conf_h, _hp, rho_g, rho_b, rho_c, rho_ur, rho_nc_norm, eps, *_rest) = bgv
    nc_drho, nc_thetap_k = _ncdm_moments(y, rho_nc_norm, eps)
    rho_nc = rho_nc_norm * _nc_rho(eps)
    rho_cb = rho_b + rho_c
    rho_m = rho_cb + rho_nc
    s = lambda i: y[..., i]
    d_cb = (rho_b * s(_I_DB) + rho_c * s(_I_DC)) / rho_cb
    d_m = (rho_b * s(_I_DB) + rho_c * s(_I_DC) + nc_drho) / rho_m
    th_cb = rho_b * s(_I_TB) / rho_cb
    th_m = (rho_b * s(_I_TB) + k * nc_thetap_k) / rho_m
    d_cb = d_cb + 3.0 * conf_h * th_cb / k**2
    d_m = d_m + 3.0 * conf_h * th_m / k**2
    return d_m, d_cb


# ---------------------------------------------------------------------------
# the solve: plain step loop (CPU) and the CUDA kernel
# ---------------------------------------------------------------------------
def eb_solve_plain(tab: EBTables, k, grids, masks, out_idx) -> PerturbOut:
    """The JAX module's ``solve_perturbations`` as a step loop batched over
    (cosmology, mode): ``k`` (nk,), ``grids``/``masks`` (nk, n) padded
    lockstep schedules, ``out_idx`` (nz, nk).  Differentiable by autograd."""
    like = tab.stacked
    k = _const(k, like)
    g = _const(grids, like)
    m = torch.as_tensor(np.asarray(masks), dtype=torch.bool, device=like.device)
    oidx = np.asarray(out_idx)
    y, zeta0 = _ic_and_zeta(tab, k, g[:, 0])
    nw, nz, nk = like.shape[0], oidx.shape[0], k.shape[0]
    dm = torch.zeros((nw, nz, nk), dtype=F64, device=like.device)
    dcb = torch.zeros_like(dm)
    hits = torch.as_tensor(oidx, device=like.device)
    snap_steps = set(int(i) - 1 for i in np.unique(oidx))
    for i in range(g.shape[1] - 1):
        y, bgv_b = _rk4_advance(y, k, tab, g[:, i], g[:, i + 1], m[:, i], m[:, i + 1])
        if i in snap_steps:
            d_m, d_cb = _delta_m(y, k, bgv_b)
            hit = hits == i + 1
            dm = torch.where(hit, d_m[:, None, :], dm)
            dcb = torch.where(hit, d_cb[:, None, :], dcb)
    return PerturbOut(delta_m=dm, delta_cb=dcb, zeta_ini=zeta0)


class KernelSchedule(NamedTuple):
    """All modes' unpadded schedules, flattened for ``eb_solve``: modes in
    order of decreasing length (``order``: positions in the k grid),
    ``offsets`` (nk+1,) into ``lna``/``tca``, ``out_idx`` (nk, nz) relative
    to each mode's start."""

    order: np.ndarray
    k: np.ndarray
    offsets: np.ndarray
    lna: np.ndarray
    tca: np.ndarray
    out_idx: np.ndarray

    @property
    def steps(self) -> np.ndarray:
        """RK4 steps of each mode (in ``order``)."""
        return np.diff(self.offsets) - 1

    def to(self, device) -> dict:
        """The kernel's arguments on ``device``: the schedule and the
        massive-neutrino quadrature (W_NC, Q_NC, DLNF, W_NC·Q_NC)."""
        quad = np.concatenate([W_NC, Q_NC, DLNF, W_NC * Q_NC])
        return {name: torch.as_tensor(np.ascontiguousarray(a), device=device) for name, a in (
            ("k", self.k), ("order", self.order.astype(np.int32)), ("offsets", self.offsets),
            ("lna", self.lna), ("tca", self.tca), ("out_idx", self.out_idx), ("quad", quad))}


def kernel_schedule(k_mpc, buckets) -> KernelSchedule:
    """The flattened schedule of ``buckets`` ((idx, grids, masks, out_idx)
    each, as :class:`EBSolver` holds them).  A mode's padding (repeats of its
    last point, TCA off) is dropped: those steps are exact no-ops; an output
    index past its real end becomes its last point, the state there."""
    rows = []
    for idx, grids, masks, oidx in buckets:
        for j, kid in enumerate(np.asarray(idx)):
            g = np.asarray(grids[j])
            n = int(np.argmax(g == g[-1])) + 1
            rows.append((n, int(kid), g[:n], np.asarray(masks[j])[:n],
                         np.minimum(np.asarray(oidx)[:, j], n - 1)))
    rows.sort(key=lambda r: (-r[0], r[1]))
    sizes = np.array([r[0] for r in rows])
    return KernelSchedule(
        order=np.array([r[1] for r in rows], dtype=np.int64),
        k=np.asarray(k_mpc, np.float64)[[r[1] for r in rows]],
        offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
        lna=np.concatenate([r[2] for r in rows]).astype(np.float64),
        tca=np.concatenate([r[3] for r in rows]).astype(np.uint8),
        out_idx=np.stack([r[4] for r in rows]).astype(np.int32),
    )


def _check_eb(tab: EBTables, dsched: dict):
    st = tab.stacked
    nw, nrows, ng = st.shape
    if nrows != N_ROWS:
        raise ValueError(f"eb_solve_cuda: stacked tables have {nrows} rows, expected {N_ROWS}")
    if dsched["lna"].device != st.device:
        raise ValueError(f"eb_solve_cuda: schedule on {dsched['lna'].device}, "
                         f"tables on {st.device}")
    return nw, ng


def _eb_outputs(out, nw: int, nz: int, nk: int) -> PerturbOut:
    return PerturbOut(delta_m=out[: nw * nz * nk].view(nw, nz, nk),
                      delta_cb=out[nw * nz * nk: 2 * nw * nz * nk].view(nw, nz, nk),
                      zeta_ini=out[2 * nw * nz * nk:].view(nw, nk))


def _eb_args(tab: EBTables, dsched: dict) -> list:
    d = dsched
    return [tab.lna[0:1].contiguous(), tab.dlna.reshape(1).contiguous(), d["k"], d["order"],
            d["offsets"], d["lna"], d["tca"], d["out_idx"], d["quad"]]


def eb_solve_cuda(tab: EBTables, dsched: dict, nk: int) -> PerturbOut:
    """Launch ``eb_solve``: one warp per (cosmology, mode), one launch for
    every mode of the schedule ``dsched`` (:meth:`KernelSchedule.to`);
    outputs in the k grid's order (nk modes)."""
    nw, ng = _check_eb(tab, dsched)
    dev = tab.stacked.device
    table = tab.stacked.transpose(1, 2).contiguous()  # (W, n, 14): one point's rows together
    nm, nz = dsched["out_idx"].shape
    out = torch.zeros((2 * nw * nz * nk + nw * nk,), dtype=F64, device=dev)
    _kernels.launch("eb_solve", dev, table, *_eb_args(tab, dsched), out,
                    ints=(nw, nm, nk, nz, ng))
    return _eb_outputs(out, nw, nz, nk)


def eb_solve_jvp_cuda(tab: EBTables, d_stacked, dsched: dict, nk: int):
    """Launch ``eb_solve_jvp``: the solve and its tangent, one direction a
    cosmology, ``d_stacked`` the tangent of ``tab.stacked`` (the schedule
    and the grid carry none).  Returns (the outputs, their tangents), each a
    :class:`PerturbOut`."""
    nw, ng = _check_eb(tab, dsched)
    _kernels.check("tangent of the tables", d_stacked, tab.stacked.shape, tab.stacked)
    dev = tab.stacked.device
    table = tab.stacked.transpose(1, 2).contiguous()
    dtable = d_stacked.transpose(1, 2).contiguous()
    nm, nz = dsched["out_idx"].shape
    out = torch.zeros((2 * nw * nz * nk + nw * nk,), dtype=F64, device=dev)
    dout = torch.zeros_like(out)  # (a base of its own: a tangent has its primal's layout)
    _kernels.launch("eb_solve_jvp", dev, table, dtable, *_eb_args(tab, dsched), out, dout,
                    ints=(nw, nm, nk, nz, ng))
    return _eb_outputs(out, nw, nz, nk), _eb_outputs(dout, nw, nz, nk)


def eb_solve_jvp2_cuda(tab: EBTables, parts, dsched: dict, nk: int) -> Jet:
    """Launch ``eb_solve_jvp2``: the solve and its second order, one pair of
    directions a row, ``parts`` the parts of ``tab.stacked`` in the
    directions p and q and its mixed part.  Returns the jet of (δ_m, δ_cb,
    ζ_ini)."""
    nw, ng = _check_eb(tab, dsched)
    parts = torch.stack(tuple(parts), -1)
    _kernels.check("parts of the tables", parts.contiguous(), (*tab.stacked.shape, 3),
                   tab.stacked)
    dev = tab.stacked.device
    table = tab.stacked.transpose(1, 2).contiguous()
    dtable = parts.transpose(1, 2).contiguous()  # (W, n, 14, 3): a point's rows together
    nm, nz = dsched["out_idx"].shape
    out = torch.zeros((2 * nw * nz * nk + nw * nk,), dtype=F64, device=dev)
    dout = torch.zeros((out.shape[0], 3), dtype=F64, device=dev)
    _kernels.launch("eb_solve_jvp2", dev, table, dtable, *_eb_args(tab, dsched), out, dout,
                    ints=(nw, nm, nk, nz, ng))
    return Jet(tuple(_eb_outputs(out, nw, nz, nk)),
               *(tuple(_eb_outputs(d, nw, nz, nk)) for d in dout.unbind(-1)))


def eb_solve_jvp2(tab: EBTables, parts, k_mpc, buckets, dsched: dict | None = None) -> Jet:
    """The solve's jet: :func:`eb_solve_jvp2_cuda` on the card, on the CPU
    the plain step loops of :func:`eb_solve` on hyper-dual tables
    (``jet.HyperDual``)."""
    st = tab.stacked
    if st.is_cuda:
        if dsched is None:
            dsched = kernel_schedule(k_mpc, buckets).to(st.device)
        return eb_solve_jvp2_cuda(tab, parts, dsched, len(k_mpc))
    return as_jet(eb_solve(tab._replace(stacked=HyperDual(st, *parts)), k_mpc, buckets))


class _EBSolve(torch.autograd.Function):
    """``eb_solve`` on the card for tables that require grad: the forward
    kernel, and no reverse mode (:class:`EBSolver` takes the gradient on
    the card by forward mode, through the tangent kernel that
    :func:`eb_solve` launches for dual tables)."""

    @staticmethod
    def forward(ctx, stacked, lna, dlna, dsched, nk):
        return tuple(eb_solve_cuda(EBTables(lna, dlna, None, stacked), dsched, nk))

    @staticmethod
    def backward(ctx, *grads):
        raise _kernels.no_backward("eb_solve")


def eb_solve(tab: EBTables, k_mpc, buckets, dsched: dict | None = None) -> PerturbOut:
    """All modes of ``buckets`` for every cosmology of ``tab``: the CUDA
    kernel on a CUDA tensor (``dsched``: the flattened schedule on the
    device, made now when None; forward AD through the tangent kernel, no
    reverse mode), the plain step loop per bucket on a CPU tensor.  Outputs
    (W, nz, nk) and (W, nk) in the order of ``k_mpc``.  Under forward AD on
    the card the tangent kernel alone runs: it gives the primal too
    (``dual.direct_tangents``)."""
    st = tab.stacked
    nk = len(k_mpc)
    if st.is_cuda:
        if dsched is None:
            dsched = kernel_schedule(k_mpc, buckets).to(st.device)
        dual = direct_tangents(st)
        if dual is not None:
            (prim,), (d_st,) = dual
            lna, dlna = (forward_ad.unpack_dual(t).primal for t in (tab.lna, tab.dlna))
            out, dout = eb_solve_jvp_cuda(EBTables(lna, dlna, None, prim), d_st, dsched, nk)
            return PerturbOut(*(forward_ad.make_dual(o, d) for o, d in zip(out, dout)))
        return PerturbOut(*_EBSolve.apply(st, tab.lna, tab.dlna, dsched, nk))
    nw = st.shape[0]
    nz = buckets[0][3].shape[0]
    dm = torch.zeros((nw, nz, nk), dtype=F64, device=st.device)
    dcb = torch.zeros_like(dm)
    zeta = torch.zeros((nw, nk), dtype=F64, device=st.device)
    k = np.asarray(k_mpc)
    for idx, grids, masks, oidx in buckets:
        o = eb_solve_plain(tab, k[idx], grids, masks, oidx)
        sel = torch.as_tensor(np.asarray(idx), device=st.device)
        dm = dm.index_copy(2, sel, o.delta_m)
        dcb = dcb.index_copy(2, sel, o.delta_cb)
        zeta = zeta.index_copy(1, sel, o.zeta_ini)
    return PerturbOut(delta_m=dm, delta_cb=dcb, zeta_ini=zeta)


def solve_perturbations(par: CosmoParams, tab: EBTables, k_mpc, lna_grids, tca_masks,
                        out_idx) -> PerturbOut:
    """One lockstep bucket (``lna_grids``/``tca_masks`` (nk, n), ``out_idx``
    (nz, nk)) for every cosmology of ``tab``."""
    return eb_solve(tab, k_mpc, [(np.arange(len(k_mpc)), lna_grids, tca_masks, out_idx)])


def zeta_track(tab: EBTables, k, lna_grid, tca_mask):
    """ζ(lna) along one mode's schedule, (W, nsteps+1) — the super-horizon
    conservation diagnostic.  Plain torch on any device."""
    like = tab.stacked
    g = _const(lna_grid, like)
    m = torch.as_tensor(np.asarray(tca_mask), dtype=torch.bool, device=like.device)
    k = _const(np.atleast_1d(k), like)
    y, z0 = _ic_and_zeta(tab, k, g[:1])
    zs = [z0[:, 0]]
    for i in range(g.shape[0] - 1):
        y, bgv_b = _rk4_advance(y, k, tab, g[i:i + 1], g[i + 1:i + 2], m[i:i + 1], m[i + 1:i + 2])
        zs.append(_zeta(y, k, bgv_b)[:, 0])
    return torch.stack(zs, -1)


# ---------------------------------------------------------------------------
# full P(k) pipeline
# ---------------------------------------------------------------------------
def solver_k_grid(kmax: float = 1.6) -> np.ndarray:
    """Internal solver k grid (1/Mpc): log-coarse outside the acoustic range,
    linear-fine through it (~8 points per BAO period)."""
    lo = np.geomspace(5e-6, 0.012, 44, endpoint=False)
    mid = np.arange(0.012, 0.62, 0.00265)
    hi = np.geomspace(0.62, kmax, 14)
    return np.concatenate([lo, mid, hi])


class LinearPower(NamedTuple):
    k_mpc: torch.Tensor       # solver grid, 1/Mpc (nk,)
    pk: torch.Tensor          # (W, nz, nk) total-matter P(k), Mpc³
    pk_cb: torch.Tensor       # (W, nz, nk) CDM+baryon P(k), Mpc³
    z: torch.Tensor           # (nz,)
    sigma8: torch.Tensor      # (W, nz)
    f: torch.Tensor           # (W, nz) dln σ8/dln a
    fsigma8: torch.Tensor     # (W, nz)
    h_of_z: torch.Tensor      # (W, nz) H(z)/H0
    da_of_z: torch.Tensor     # (W, nz) dimensionless H0·D_A(z)
    rs_drag: torch.Tensor     # (W,) Mpc


FIDUCIAL = dict(omega_b=0.02237, omega_cdm=0.12, h=0.6777, ln10As=3.044, ns=0.9649)

# The training box of the solver emulator (the port's copy of the constants
# of tools/train_solver_emulator.py): the wide (ω_b, ω_cdm, h) box, the
# per-species mass axis of its 4-input mode, the neutrino setup (Σm_ν over 3
# degenerate species, N_ur = 0.00641), the 13 output redshifts uniform in
# ln a from z = 1.05 to 0, kmax, and the fixed primordial parameters.
BOX_BOUNDS = {"omega_b": (0.017, 0.029), "omega_cdm": (0.03, 0.70), "h": (0.40, 1.00)}
BOX_MNU_BOUNDS = (0.0, 0.10)
BOX_NEUTRINO = dict(deg_ncdm=3.0, n_ur=0.00641, yhe=0.2454)
BOX_PRIMORDIAL = dict(ln10As=3.044, ns=0.9649)
BOX_Z_GRID = np.exp(-np.linspace(np.log(1.0 / 2.05), 0.0, 13))[::-1] - 1.0
BOX_KMAX = 1.6


def box_params(omega_b, omega_cdm, h, m_ncdm, device=None) -> "CosmoParams":
    """Cosmologies of the training box (numbers or (W,) arrays): the box's
    neutrino setup and primordial parameters, ``m_ncdm`` per species."""
    par = CosmoParams(omega_b=omega_b, omega_cdm=omega_cdm, h=h, m_ncdm=m_ncdm,
                      n_ur=BOX_NEUTRINO["n_ur"], yhe=BOX_NEUTRINO["yhe"],
                      deg_ncdm=BOX_NEUTRINO["deg_ncdm"], **BOX_PRIMORDIAL)
    return as_batch(par, device)


def box_corners(bounds: dict, m_ncdm: float | None = None) -> list:
    """The corners of a box of the training cosmologies, one
    :class:`CosmoParams` each (the box's neutrino setup and primordial
    parameters): ``bounds`` maps omega_b, omega_cdm, h and optionally
    m_ncdm (per species) to (lo, hi), in that order; a fixed ``m_ncdm`` is
    given when it is not an axis.  2^len(bounds) corners, in
    ``itertools.product`` order."""
    import itertools

    names = list(bounds)
    if ("m_ncdm" in names) == (m_ncdm is not None):
        raise ValueError("box_corners: give m_ncdm either as an axis of bounds or fixed")
    return [CosmoParams(**{"m_ncdm": m_ncdm, **dict(zip(names, c))}, **BOX_NEUTRINO,
                        **BOX_PRIMORDIAL)
            for c in itertools.product(*(bounds[n] for n in names))]


def box_solver(bounds: dict | None = None, m_ncdm: float | None = None,
               device=None) -> "EBSolver":
    """A solver of the emulator's training recipe: the 13 z of the box,
    ``kmax`` 1.6, no growth stencil, the schedule built over the envelope of
    the corners of ``bounds`` (:func:`box_corners`).  By default the 16
    corners of the 4-D box (``BOX_BOUNDS`` and ``BOX_MNU_BOUNDS``): the
    recipe of the 4-input artifact (``--sample-mnu``).  The shipped 3-input
    artifact's recipe is the 8 corners of ``BOX_BOUNDS`` at ``m_ncdm=0.02``
    (``eftpipe_tpu_torch/tools/train_solver_emulator.py``)."""
    if bounds is None:
        bounds = dict(BOX_BOUNDS, m_ncdm=BOX_MNU_BOUNDS)
    return EBSolver(z_out=BOX_Z_GRID.tolist(), kmax=BOX_KMAX, growth_stencil=False,
                    envelope=box_corners(bounds, m_ncdm), device=device)


def log_transfers(lp: "LinearPower", ln10As: float = BOX_PRIMORDIAL["ln10As"],
                  ns: float = BOX_PRIMORDIAL["ns"]):
    """(log T_m, log T_cb) of a solve, (W, nz, nk): the spectra with the
    primordial power divided out, as the emulator's training samples store
    them (host NumPy arithmetic on the k grid)."""
    k = lp.k_mpc.detach().cpu().numpy()
    pzeta = 2 * np.pi**2 / k**3 * (1e-10 * np.exp(ln10As)) * (k / 0.05) ** (ns - 1.0)
    pz = torch.as_tensor(pzeta, dtype=F64, device=lp.pk.device)
    return 0.5 * torch.log(lp.pk / pz), 0.5 * torch.log(lp.pk_cb / pz)


class EBSolver:
    """Schedule-owning front end: build once (host schedule from fiducial or
    envelope tables computed on ``device``), evaluate for any batch of
    cosmologies.

    ``device``: where the tables are computed and the solves run (the card
    unless ``"cpu"``)."""

    def __init__(self, z_out, kmax: float = 1.6, fiducial: CosmoParams | None = None,
                 dlna_f: float = 0.02, growth_stencil: bool = True,
                 envelope: "list[CosmoParams] | None" = None, device=None,
                 **sched_opts):
        self.device = resolve_device(device)
        fid = fiducial or CosmoParams(**FIDUCIAL)
        self.k_mpc = np.asarray(solver_k_grid(kmax), np.float64)
        self.z_out = np.sort(np.atleast_1d(np.asarray(z_out, float)))[::-1]
        lna_list = []
        self.dlna_f = dlna_f
        self.growth_stencil = growth_stencil
        for z in self.z_out:
            lna = np.log(1.0 / (1.0 + z))
            if growth_stencil:
                lna_list += [lna - dlna_f, lna, min(lna + dlna_f, 0.0)]
            else:
                lna_list.append(lna)
        self.lna_out = np.unique(np.asarray(lna_list))
        corners = list(envelope) if envelope else [fid]
        with torch.no_grad():
            par = stack_params(corners, self.device)
            bg = background_tables(par)
            th = thermo_tables(par, bg)
        bg_f, th_f = host_tables(bg, th)
        raw, raw_masks = build_schedule(self.k_mpc, bg_f, th_f, self.lna_out,
                                        pad=False, **sched_opts)
        self.buckets = []
        for idx in bucket_indices([g.size for g in raw]):
            grids = _pad_grids([raw[i] for i in idx])
            masks = _pad_masks([raw_masks[i] for i in idx])
            self.buckets.append((idx, grids, masks, out_indices(grids, self.lna_out)))
        self._sched, self._dsched = None, {}

    def schedule(self) -> KernelSchedule:
        """The flattened schedule the kernel walks (made once)."""
        if self._sched is None:
            self._sched = kernel_schedule(self.k_mpc, self.buckets)
        return self._sched

    def device_schedule(self, device) -> dict:
        """:meth:`schedule` on ``device``, moved there once."""
        key = str(torch.device(device))
        if key not in self._dsched:
            self._dsched[key] = self.schedule().to(device)
        return self._dsched[key]

    def tables(self, par: CosmoParams) -> tuple[Background, Thermo, EBTables]:
        par = as_batch(par, self.device)
        bg = background_tables(par)
        th = thermo_tables(par, bg)
        return bg, th, make_tables(par, bg, th)

    def table_part(self, par: CosmoParams) -> tuple:
        """The part of a solve that depends on the tables: δ_m and δ_cb (W,
        nz, nk), ζ_ini (W, nk), ℋ and τ at the output times (W, nz_out), τ0
        and r_drag (W,).  The rest of :meth:`__call__` is plain torch on
        these and on h, ln10As and n_s."""
        bg, th, tab = self.tables(par)
        dev = tab.stacked.device
        out = eb_solve(tab, self.k_mpc, self.buckets,
                       self.device_schedule(dev) if dev.type == "cuda" else None)
        lna_out = torch.log(1.0 / (1.0 + _const(self.z_out, tab.stacked)))
        return (out.delta_m, out.delta_cb, out.zeta_ini, interp(lna_out, bg.lna, bg.conf_h),
                interp(lna_out, bg.lna, bg.tau), bg.tau0, th.rs_drag)

    def table_tangents(self, par: CosmoParams, names) -> list:
        """The Jacobian of :meth:`table_part` in the fields ``names`` (P of
        ``TABLE_FIELDS``): one pass under forward AD on the W·P rows of
        :func:`tangent_rows` (on the card: one launch of each tangent
        kernel, which gives the primal too).  One (W, P, ...) tensor an
        output."""
        nw, p = par.h.shape[0], len(names)
        with forward_ad.dual_level(), DenseTangents():
            out = self.table_part(tangent_rows(par, names))
            return [tangent_or_zeros(o).reshape(nw, p, *o.shape[1:]) for o in out]

    def table_hessians(self, par: CosmoParams, names) -> list:
        """The second derivatives of :meth:`table_part` in the fields
        ``names`` (P of ``TABLE_FIELDS``): one pass on the W·P(P+1)/2 rows of
        ``jet.pair_rows``, each quantity a jet.  The plain stages (the
        backgrounds and the recurrence's inputs; the thermodynamic and the
        solver's tables with the interpolations at the output times) by
        ``jet.jet_call`` under ``DenseTangents``, each recurrence by its
        second-order kernel (on the card: one launch of ``recomb_scan_jvp2``
        and one of ``eb_solve_jvp2``, which give the primal and the first
        order too).  One (W, P, P, ...) tensor an output, symmetric."""
        par = as_batch(par, self.device)
        nw, p = par.h.shape[0], len(names)
        values = {n: getattr(par, n) for n in CosmoParams._fields[:-1]}
        rows, jet = pair_rows(values, names, par.h)
        base = CosmoParams(**rows, deg_ncdm=par.deg_ncdm)
        at = lambda f: base._replace(**dict(zip(names, f)))
        st = thermo_tables(stages=True)
        with torch.no_grad():  # the grids (constants): one row's
            one = base._replace(**{n: v[:1] for n, v in rows.items()})
            bg1 = background_tables(one)
            bgf1 = st.fine_background(one, bg1)
        fine = bgf1 is not None
        nb = len(Background._fields) - 1
        grid = lambda lna, t: Background(lna, *t)
        lna_out = torch.log(1.0 / (1.0 + _const(self.z_out, par.h)))

        def before(*f):
            bg = background_tables(at(f))
            bg_f, ins = st.before_scan(at(f), bg)
            return (*bg[1:], *(bg_f[1:] if fine else ()), *ins)

        def after(*x):
            f, bg_t, x = x[:p], x[p:p + nb], x[p + nb:]
            bg = grid(bg1.lna, bg_t)
            bg_f, x = (grid(bgf1.lna, x[:nb]), x[nb:]) if fine else (None, x)
            ins, rec = x[:6], x[6:]
            th = st.after_scan(at(f), bg, bg_f, ins, rec)
            tab = make_tables(at(f), bg, th)
            return (tab.stacked, interp(lna_out, bg.lna, bg.conf_h),
                    interp(lna_out, bg.lna, bg.tau), bg.tau0, th.rs_drag)

        with DenseTangents():
            ja = jet_call(before, jet)
        ins = Jet(*(t[-6:] for t in ja))
        rec = recomb_scan_jvp2(ins, scan_step(bgf1 if fine else bg1))
        with DenseTangents():
            jb = jet_call(after, Jet(*(f + a + r for f, a, r in zip(jet, ja, rec))))
        tab = EBTables(lna=bg1.lna, dlna=bg1.lna[1] - bg1.lna[0], tau=None, stacked=jb.v[0])
        dev = tab.stacked.device
        sol = eb_solve_jvp2(tab, (jb.a[0], jb.b[0], jb.ab[0]), self.k_mpc, self.buckets,
                            self.device_schedule(dev) if dev.type == "cuda" else None)
        return [hessian_of(m, nw, p) for m in sol.ab + jb.ab[1:]]

    def __call__(self, par: CosmoParams) -> LinearPower:
        par = as_batch(par, self.device)
        if _tangent_route(par):
            names = tuple(n for n in TABLE_FIELDS if getattr(par, n).requires_grad)
            fixed = par._replace(**{n: getattr(par, n).detach() for n in TABLE_FIELDS})
            parts = _SolverTables.apply(self, fixed, self.table_tangents(fixed, names), names,
                                        *(getattr(par, n) for n in names))
        else:
            parts = self.table_part(par)
        delta_m, delta_cb, zeta_ini, conf_h, tau_out, tau0, rs_drag = parts
        k = _const(self.k_mpc, delta_m)
        col = lambda v: v[:, None]
        as_ = 1e-10 * torch.exp(col(par.ln10As))
        pzeta = 2.0 * math.pi**2 / k**3 * as_ * (k / 0.05) ** (col(par.ns) - 1.0)  # (W, nk)
        t2 = (delta_m / zeta_ini[:, None, :]) ** 2
        t2cb = (delta_cb / zeta_ini[:, None, :]) ** 2
        pk_all = pzeta[:, None, :] * t2          # (W, n_lna, nk), Mpc³
        pkcb_all = pzeta[:, None, :] * t2cb

        s8_all = _sigma_r_mpc(k, pk_all, (8.0 / par.h)[:, None, None])  # (W, n_lna)
        rows, f = [], []
        lna_sorted = self.lna_out
        for z in self.z_out:
            lna = np.log(1.0 / (1.0 + z))
            i = int(np.argmin(np.abs(lna_sorted - lna)))
            im = int(np.argmin(np.abs(lna_sorted - (lna - self.dlna_f))))
            ip = int(np.argmin(np.abs(lna_sorted - min(lna + self.dlna_f, 0.0))))
            rows.append(i)
            if self.growth_stencil and ip != im:
                dlna_tot = lna_sorted[ip] - lna_sorted[im]
                f.append(torch.log(s8_all[:, ip] / s8_all[:, im]) / dlna_tot)
            else:
                f.append(torch.zeros_like(s8_all[:, 0]))
        pk = pk_all[:, rows]
        pkcb = pkcb_all[:, rows]
        s8 = s8_all[:, rows]
        f = torch.stack(f, -1)

        z_t = _const(self.z_out, k)
        a_out = 1.0 / (1.0 + z_t)
        h0 = col(_h0_mpc(par.h))
        h_of_z = conf_h / a_out / h0
        chi = col(tau0) - tau_out
        da = a_out * chi * h0
        return LinearPower(k_mpc=k, pk=pk, pk_cb=pkcb, z=z_t, sigma8=s8, f=f,
                           fsigma8=f * s8, h_of_z=h_of_z, da_of_z=da, rs_drag=rs_drag)


# the fields of CosmoParams the tables depend on (ln10As and n_s enter after
# the solve, in plain torch)
TABLE_FIELDS = ("omega_b", "omega_cdm", "h", "m_ncdm", "n_ur", "yhe")
THIRD_ORDER = ("EBSolver: no third derivative through the solver's CUDA kernels: its first "
               "derivative is forward-mode (one tangent a parameter), its second hyper-dual "
               "(ROADMAP A8.2: one pair of parameters a row), and a backward of the second "
               "with create_graph=True would need third-order parts. The CPU's plain solver "
               "differentiates to any order")


def tangent_rows(par: CosmoParams, names) -> CosmoParams:
    """``par``'s W cosmologies as W·P rows, row w·P + p cosmology w with the
    tangent 1 on its field ``names[p]`` (inside the caller's
    ``forward_ad.dual_level()``)."""
    nw, p = par.h.shape[0], len(names)
    eye = torch.eye(p, dtype=F64, device=par.h.device).repeat(nw, 1)  # row w·P + i: e_i
    vals = {n: getattr(par, n).detach().repeat_interleave(p) for n in CosmoParams._fields[:-1]}
    for i, n in enumerate(names):
        vals[n] = forward_ad.make_dual(vals[n], eye[:, i].contiguous())
    return CosmoParams(**vals, deg_ncdm=par.deg_ncdm)


def _tangent_route(par: CosmoParams) -> bool:
    """Whether :class:`EBSolver` takes its gradient through
    :class:`_SolverTables`: the tables on the card, and a table field that
    requires grad under grad mode."""
    return (par.h.is_cuda and torch.is_grad_enabled()
            and any(getattr(par, n).requires_grad for n in TABLE_FIELDS))


class _SolverTables(torch.autograd.Function):
    """:meth:`EBSolver.table_part` with a backward by forward mode: its
    forward runs the primal as a call without a gradient does (the same
    numbers, bit for bit) and keeps ``jac``, the tangents of
    :meth:`EBSolver.table_tangents` in the differentiated fields (made
    outside: torch runs a Function's forward with forward AD off); its
    backward contracts the incoming gradients with them.  Under grad mode
    (``create_graph=True``) the contraction is differentiable: in the
    incoming gradients as torch ops, in the fields through
    :class:`_SolverJacobian`."""

    @staticmethod
    def forward(ctx, solver, par, jac, names, *fields):
        ctx.solver, ctx.par, ctx.names = solver, par, names
        ctx.save_for_backward(*jac, *fields)
        return solver.table_part(par._replace(**dict(zip(names, fields))))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        jacs, fields = saved[:-len(ctx.names)], saved[-len(ctx.names):]
        if torch.is_grad_enabled():
            jacs = _SolverJacobian.apply(ctx.solver, ctx.par, ctx.names, jacs, *fields)
        g = sum((jac * grad.unsqueeze(1)).reshape(*jac.shape[:2], -1).sum(-1)
                for jac, grad in zip(jacs, grads))  # (W, P)
        return (None, None, None, None, *g.unbind(1))


class _SolverJacobian(torch.autograd.Function):
    """The Jacobian ``jac`` of :class:`_SolverTables` as a function of the
    differentiated fields, for a double backward: its forward gives ``jac``,
    its backward contracts the incoming gradients with the second
    derivatives of :meth:`EBSolver.table_hessians`, computed then (so a
    value, or a value and gradient, never runs the second-order pass).  A
    third derivative raises (``THIRD_ORDER``)."""

    @staticmethod
    def forward(ctx, solver, par, names, jac, *fields):
        ctx.solver, ctx.par, ctx.names = solver, par, names
        return tuple(j.clone() for j in jac)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise NotImplementedError(THIRD_ORDER)
        hess = ctx.solver.table_hessians(ctx.par, ctx.names)
        g = sum((h * grad.unsqueeze(2)).reshape(*h.shape[:3], -1).sum(-1).sum(1)
                for h, grad in zip(hess, grads))  # (W, P)
        return (None, None, None, None, *g.unbind(1))


def stack_params(pars, device=None) -> CosmoParams:
    """One batched :class:`CosmoParams` from a list of single cosmologies
    (equal ``deg_ncdm``)."""
    degs = {float(p.deg_ncdm) for p in pars}
    if len(degs) != 1:
        raise ValueError(f"stack_params: mixed deg_ncdm {sorted(degs)}")
    dev = resolve_device(device)
    cols = [torch.stack([torch.as_tensor(getattr(p, n), dtype=F64, device=dev).reshape(())
                         for p in pars]) for n in CosmoParams._fields[:-1]]
    return CosmoParams(*cols, deg_ncdm=degs.pop())


def _sigma_r_mpc(k_mpc, pk_mpc, r_mpc):
    """σ(R) over the last axis (k), R broadcast against ``pk_mpc``."""
    x = k_mpc * r_mpc
    w = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x**3
    integ = k_mpc**3 * pk_mpc * w * w / (2.0 * math.pi**2)
    return torch.sqrt(torch.trapezoid(integ, torch.log(k_mpc), dim=-1))


def interp_loglog(k_new, k, pk):
    """cubic-in-log interpolation of a positive spectrum (host NumPy)."""
    from scipy.interpolate import CubicSpline

    sp = CubicSpline(np.log(np.asarray(k)), np.log(np.asarray(pk)))
    return np.exp(sp(np.log(np.asarray(k_new))))


class SolverProvider:
    """Cosmology provider backed by the Einstein–Boltzmann solver (the
    interface of the port's other providers: ``inputs(params) ->
    CosmoInputs`` and ``derived(params)`` on ``(W,)`` parameter tensors).

    The solve runs in float64 on the solver's device; the outputs are cast
    to the dtype and device of the parameters.  A full solve takes a large
    part of a second on the card, so this provider is for gates, emulator
    training and spot checks, as in the JAX package."""

    def __init__(self, cfg, zeff: float, da_fid=None, h_fid=None,
                 use_cb: bool = False, rdrag_fid=None, h0_fid=None,
                 kmax: float = 1.6, mnu: float = 0.06,
                 hierarchy: str = "degenerate", n_ur: float | None = None,
                 yhe: float = 0.2454, solver: "EBSolver | None" = None, device=None):
        self.cfg = cfg
        self.zeff = float(zeff)
        self.da_fid, self.h_fid = da_fid, h_fid
        self.rdrag_fid, self.h0_fid = rdrag_fid, h0_fid
        self.use_cb = use_cb
        if hierarchy == "degenerate":
            self.deg, self.m_per = 3.0, mnu / 3.0
            self.n_ur = 0.00641 if n_ur is None else n_ur
        else:
            self.deg, self.m_per = 1.0, mnu
            self.n_ur = 2.0328 if n_ur is None else n_ur
        self.yhe = yhe
        self.solver = solver or EBSolver(z_out=[self.zeff], kmax=kmax, device=device)
        self._iz = int(np.argmin(np.abs(np.asarray(self.solver.z_out) - self.zeff)))

    def _params(self, params) -> CosmoParams:
        dev = self.solver.device
        shape = torch.as_tensor(params["h"]).shape or (1,)

        def get(name, default):
            v = params[name] if default is None else params.get(name, default)
            return torch.as_tensor(v).to(dtype=F64, device=dev).expand(shape)

        return CosmoParams(
            omega_b=get("omega_b", None), omega_cdm=get("omega_cdm", None), h=get("h", None),
            ln10As=get("ln10As", None), ns=get("ns", None),
            m_ncdm=get("m_ncdm", self.m_per), n_ur=get("n_ur", self.n_ur),
            yhe=get("yhe", self.yhe), deg_ncdm=self.deg)

    def linear_power(self, params) -> LinearPower:
        return self.solver(self._params(params))

    def _plin_on_kin(self, lp: LinearPower, h):
        """P_lin on cfg.kin [h/Mpc] in (Mpc/h)³: log-log linear interpolation."""
        kin_mpc = _const(self.cfg.kin, h) * h[:, None]
        pk = lp.pk_cb[:, self._iz] if self.use_cb else lp.pk[:, self._iz]
        lnp = interp(torch.log(kin_mpc), torch.log(lp.k_mpc), torch.log(pk))
        return torch.exp(lnp) * h[:, None] ** 3

    def _ap(self, lp: LinearPower):
        iz = self._iz
        if self.da_fid is not None:
            return lp.da_of_z[:, iz] / self.da_fid, self.h_fid / lp.h_of_z[:, iz]
        one = torch.ones_like(lp.rs_drag)
        return one, one

    @staticmethod
    def _cast(params, tensors):
        """``tensors`` in the dtype and on the device of ``params["h"]``."""
        like = params["h"]
        if not isinstance(like, torch.Tensor):
            return tensors
        return [t.to(dtype=like.dtype, device=like.device) for t in tensors]

    def inputs(self, params):
        from ..models.pipeline import CosmoInputs

        par = self._params(params)
        lp = self.solver(par)
        qperp, qpar = self._ap(lp)
        plin, f, qperp, qpar = self._cast(params, [
            self._plin_on_kin(lp, par.h), lp.f[:, self._iz], qperp, qpar])
        return CosmoInputs(plin=plin, f=f, qperp=qperp, qpar=qpar)

    def derived(self, params) -> dict:
        """fz, fσ8(z), α⊥, α∥, σ8(z), r_drag at zeff, each (W,)."""
        par = self._params(params)
        lp = self.solver(par)
        iz = self._iz
        qperp, qpar = self._ap(lp)
        if self.rdrag_fid is not None and self.h0_fid is not None:
            ratio = (self.rdrag_fid * self.h0_fid) / (lp.rs_drag * par.h)
            alperp, alpara = qperp * ratio, qpar * ratio
        else:
            alperp, alpara = qperp, qpar
        names = ("fz", "fsigma8_z", "alperp", "alpara", "sigma8_z", "rdrag")
        vals = (lp.f[:, iz], lp.fsigma8[:, iz], alperp, alpara, lp.sigma8[:, iz], lp.rs_drag)
        return dict(zip(names, self._cast(params, vals)))
