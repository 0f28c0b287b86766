"""IR resummation of the long-wavelength displacements (counterpart of
``eftpipe_tpu/models/resum.py``).

Functional, batched replacement for upstream ``Resum``
(pybird/pybird.py:1174-1464):

* IR filters X(s), Y(s) from a 32-point FFTLog of P_lin e^{-k²/Λ²}/k²
  (pybird.py:1316-1353) — the damping factor lives on the fixed input grid,
  so it is a Phase-A constant vector.
* The correlation-function multipoles (linear, counterterm, NNLO, 12 loop
  channels) are multiplied by the 2·NIR powers X^p, X^p·Y, FFTLog'd back to
  k (192 points) and contracted with the spherical-Bessel moment matrices —
  the padding-mode FFTLog being linear in the s-grid values, all of it is ONE
  real constant matrix ``air_fold`` (pybird.py:1361-65).
* The quadruple loop filling IR11/IRct/IRloop (pybird.py:1422-1441) is a
  reshape; ``makeQ`` is a Chebyshev einsum (tables/qcoef.py).
* optiresum's BAO-peak extraction (pybird.py:1382-1400) is a constant linear
  map (selection minus linear-interpolated smooth part).

Only the k ≥ 0.02 rows receive corrections (``nklow`` offset).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import to_device
from ..ops.fftlog import HostFFTLog, make_plan, fftlog_coef
from ..ops import cplx
from ..tables.loop_matrices import mpc, legendre_weights
from ..tables.qcoef import load_qcoef, make_q
from .config import EFTConfig
from .bird import BirdState


def resum_orders(cfg: EFTConfig) -> tuple[int, int]:
    """(NIR, Na): 16/3 when the hexadecapole is computed, else 8/2
    (pybird.py:1246-1257)."""
    return (16, 3) if cfg.nl == 3 else (8, 2)


def _extract_bao_matrix(s: np.ndarray, slow: float, shigh: float) -> tuple[np.ndarray, int, int]:
    """Linear map cf(s) -> BAO-only cf(s_bao) (pybird.py:1382-1400)."""
    idlow = int(np.where(s > slow)[0][0])
    idhigh = int(np.where(s > shigh)[0][0])
    sbao = s[idlow:idhigh]
    snobao = np.concatenate([s[:idlow], s[idhigh:]])
    sel_bao = np.zeros((sbao.size, s.size))
    sel_bao[np.arange(sbao.size), idlow + np.arange(sbao.size)] = 1.0
    sel_nobao = np.zeros((snobao.size, s.size))
    sel_nobao[np.arange(idlow), np.arange(idlow)] = 1.0
    sel_nobao[idlow:, idhigh:] = np.eye(s.size - idhigh)
    # linear interp of s² cf_nobao onto sbao, then / sbao²
    lin = np.zeros((sbao.size, snobao.size))
    for j in range(snobao.size):
        e = np.zeros(snobao.size)
        e[j] = 1.0
        lin[:, j] = np.interp(sbao, snobao, e)
    smooth = (lin * (1.0 / sbao**2)[:, None]) @ (sel_nobao * (snobao**2)[:, None])
    return sel_bao - smooth, idlow, idhigh


def resum_tables_numpy(cfg: EFTConfig, lambda_ir: float = 0.2) -> dict:
    nir, na = resum_orders(cfg)
    nn = 2 * nir * na
    kr = cfg.kr
    s = cfg.s

    if cfg.optiresum:
        extract, idlow, idhigh = _extract_bao_matrix(s, 70.0, 190.0)
        sr = s[idlow:idhigh]
    else:
        extract = None
        sr = s

    # back-transform FFTLog (pybird.py:1288) and its fused Bessel contraction
    fft = HostFFTLog(n=cfg.nfft_resum, xmin=0.1, xmax=10000.0, bias=-0.6)
    plan = make_plan(fft, sr, extrap="padding", window=None)
    ells = 2 * np.arange(na)
    m = 8.0 * np.pi**3 * mpc(ells[:, None], -0.5 * fft.pow[None, :])  # (na, n+1)
    kpow = kr[None, :] ** (-fft.pow[:, None] - 3.0)  # (n+1, nkr)
    air = np.einsum("an,nk->nak", m, kpow)

    # spline-resample -> DFT -> Bessel moments -> k powers as ONE real matrix
    embed = np.zeros((sr.size, fft.n))
    embed[:, plan.ileft:plan.iright] = plan.smid.T
    g = plan.gre + 1j * plan.gim  # (n, n+1)
    air_fold = np.real(embed @ g @ air.reshape(fft.n + 1, na * kr.size))

    # X/Y filter FFTLog (pybird.py:1293-1296)
    xfft = HostFFTLog(n=cfg.nfft_irfilter, xmin=1.5e-5, xmax=10.0, bias=-2.6)
    kin = cfg.kin
    if cfg.ir_cutoff in ("all", "resum"):
        icut = int(np.searchsorted(kin, cfg.k_ir))
        xplan = make_plan(xfft, kin[icut:], extrap=("padding", "extrap"), window=None)
    else:
        icut = 0
        xplan = make_plan(xfft, kin, extrap="extrap", window=None)
    damp = np.exp(-kin**2 / lambda_ir**2) / kin**2
    xm = mpc(2 * np.arange(2)[:, None], -0.5 * xfft.pow[None, :])  # (2, n+1)
    xspow = sr[None, :] ** (-xfft.pow[:, None] - 3.0)  # (n+1, nsr)
    ax = np.einsum("ln,ns->nls", xm, xspow)
    soffset = 1.0
    xoff = xm[0] * soffset ** (-xfft.pow - 3.0)

    k2pi = np.stack([kr ** (2 * (p + 1)) for p in range(nir)])
    k2p = np.concatenate([k2pi, k2pi])  # (2 nir, nkr)

    qcoef, qfmax = load_qcoef(nir)
    ltab = legendre_weights(cfg.nl)

    return dict(
        nir=nir,
        na=na,
        nn=nn,
        plan=plan,
        air=cplx.split(air),
        air_fold=air_fold,
        nkr=kr.size,
        xplan=xplan,
        x_icut=icut,
        damp=damp,
        ax=cplx.split(ax),
        xoff=cplx.split(xoff),
        k2p=k2p,
        extract=extract,
        qcoef=qcoef,
        qfmax=qfmax,
        l11=ltab["l11"],
        lct=ltab["lct"],
        lct_nnlo=ltab["lct_nnlo"],
    )


def build_resum_tables(cfg: EFTConfig, device, dtype, lambda_ir: float = 0.2) -> dict:
    return to_device(resum_tables_numpy(cfg, lambda_ir), device, dtype)


def ir_filters(rt: dict, plin_kin):
    """X(s), Y(s) on the resummation grid (pybird.py:1316-1353)."""
    f_in = plin_kin * rt["damp"]
    if rt["x_icut"]:
        f_in = f_in[..., rt["x_icut"]:]
    coef = fftlog_coef(rt["xplan"], f_in)
    x02 = cplx.ceinsum_real("...n,nls->...ls", coef, rt["ax"])  # (W, 2, nsr)
    x0_offset = cplx.ceinsum_real("...n,n->...", coef, rt["xoff"])
    x0 = x0_offset[..., None] - x02[..., 0, :]
    x = 2.0 / 3.0 * (x0 - x02[..., 1, :])
    y = 2.0 * x02[..., 1, :]
    return x, y


def _xpyp(rt: dict, x, y):
    """Stack [X, X², ..., X^nir, Y, XY, ..., X^{nir-1}Y] (pybird.py:1402-1407)."""
    nir = rt["nir"]
    # the powers by repeated products: the backward of torch.cumprod reads
    # its input back to the host (one synchronisation per call)
    pows = [x]
    for _ in range(nir - 1):
        pows.append(pows[-1] * x)
    xp = torch.stack(pows, dim=-2)  # (W, nir, nsr)
    ones = torch.ones_like(x)[..., None, :]
    xpy = y[..., None, :] * torch.cat([ones, xp[..., :-1, :]], dim=-2)
    return torch.cat([xp, xpy], dim=-2)  # (W, 2 nir, nsr)


def _expand(x, extra: int):
    """Insert `extra` axes before the trailing two of x."""
    for _ in range(extra):
        x = x[..., None, :, :]
    return x


def _ir_correction(rt: dict, cfg: EFTConfig, xpyp, cf):
    """IR-correction stack of a CF quantity.

    cf : (W, L..., ns) — any number of structure axes before s.
    Returns (W, L..., nn, nk) zero-padded below k = 0.02.
    """
    if rt["extract"] is not None:
        cf = cf @ rt["extract"].T
    # (W, L..., 2nir, nsr): broadcast the filter powers against cf
    integ = cf[..., None, :] * _expand(xpyp, cf.dim() - xpyp.dim() + 1)
    # fused back-transform: one real matmul replaces the FFTLog + complex
    # Bessel contraction (air_fold, built in Phase A)
    irn = integ @ rt["air_fold"]
    irn = irn.reshape(irn.shape[:-1] + (rt["na"], rt["nkr"]))
    irn = irn * rt["k2p"][:, None, :]
    irn = irn.reshape(irn.shape[:-3] + (rt["nn"], irn.shape[-1]))  # u = j*na + v
    return torch.nn.functional.pad(irn, (cfg.nklow, 0))


def resum_ps(rt: dict, cfg: EFTConfig, bird: BirdState, plin_kin, xpyp=None) -> BirdState:
    """Add the IR corrections to P11l/Pctl/(PctNNLOl)/Ploopl (pybird.py:1413-1464).
    ``xpyp`` may be passed precomputed (the IR filter powers depend only on
    P_lin)."""
    if xpyp is None:
        x, y = ir_filters(rt, plin_kin)
        xpyp = _xpyp(rt, x, y)

    # one stacked IR-correction pass for all CF quantities: c11 / cct
    # (/ cct_nnlo) as single channels next to the 12 loop channels
    cfs = [bird.c11[..., None, :], bird.cct[..., None, :]]
    if cfg.with_nnlo:
        cfs.append(bird.cct_nnlo[..., None, :])
    cfs.append(bird.cloopl)
    irall = _ir_correction(rt, cfg, xpyp, torch.cat(cfs, dim=-2))
    nextra = 3 if cfg.with_nnlo else 2
    ir11 = irall[..., 0, :, :]
    irct = irall[..., 1, :, :]
    irloop = irall[..., nextra:, :, :]

    q = make_q(rt["qcoef"], rt["qfmax"], bird.f)  # (W, 2, nl, nl, nn)
    q0, q1 = q[..., 0, :, :, :], q[..., 1, :, :, :]
    l11, lct = rt["l11"], rt["lct"]

    p11l = bird.p11l + torch.einsum("...lpn,...pnk,pi->...lik", q0, ir11, l11)
    pctl = bird.pctl + torch.einsum("...lpn,...pnk,pi->...lik", q1, irct, lct)
    ploopl = bird.ploopl + torch.einsum("...lpn,...pink->...lik", q1, irloop)
    if cfg.with_nnlo:
        irct_nnlo = irall[..., 2, :, :]
        pct_nnlo_l = bird.pct_nnlo_l + torch.einsum(
            "...lpn,...pnk,pi->...lik", q1, irct_nnlo, rt["lct_nnlo"]
        )
    else:
        pct_nnlo_l = bird.pct_nnlo_l

    return bird._replace(p11l=p11l, pctl=pctl, ploopl=ploopl, pct_nnlo_l=pct_nnlo_l)
