"""Alcock–Paczyński projection (counterpart of ``eftpipe_tpu/models/ap.py``).

Functional replacement for upstream ``APeffect`` (pybird/pybird.py:1467-1628).
The multipoles are rebuilt into P(k, µ) on a distorted grid (k', µ'), then
re-projected onto Legendre multipoles by a quadrature over a fixed µ grid.
The distorted grid depends on the sampled (q⊥, q∥), so the cubic
interpolation runs per evaluation via the constant second-derivative spline
operator (ops/interp.py); the Legendre re-projection against the fixed µ
grid is folded into one constant weight matrix.

Everything here carries the walker axis: ``qperp``/``qpar`` are (W,), the
distorted grid is (W, nk, nmu), and the per-walker spline operator is built
by scattering each query's two segment weights instead of per-evaluation
one-hot comparisons.

Quadrature: float32 uses Gauss–Legendre nodes (``n_gl`` of
``build_ap_tables``, default 16), float64 the upstream 200-point trapezoid —
the same rule as the JAX package (there an environment variable, here an
argument).  ``quadrature="gauss_legendre"`` puts every dtype on the
Gauss–Legendre nodes, so that float32 and float64 differ by rounding only.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import to_device
from ..ops.interp import SplineTable, segment_index
from ..ops.legendre import legendre_even
from .config import EFTConfig
from .bird import BirdState


def lcdm_hubble(om: float, z: float) -> float:
    """Dimensionless H(z)/H0 for flat LCDM (pybird.py:34-36)."""
    return float(np.sqrt(om * (1 + z) ** 3 + (1 - om)))


def lcdm_da(om: float, z: float) -> float:
    """Dimensionless angular-diameter distance H0·DA (pybird.py:39-42)."""
    from scipy.integrate import quad

    r = quad(lambda x: 1.0 / lcdm_hubble(om, x), 0, z)[0]
    return float(r / (1 + z))


def ap_tables_numpy(
    cfg: EFTConfig,
    z_ap: float | None = None,
    om_ap: float | None = None,
    da_fid: float | None = None,
    h_fid: float | None = None,
    rdrag_ap: float | None = None,
    hubble_ap: float | None = None,
    nbinsmu: int = 200,
    accboost: int = 1,
    nlmax: int | None = None,
    ap_st: bool = False,
    n_gl: int = 16,
    quadrature: str = "by_dtype",
) -> dict:
    """Fiducial background + fixed-µ-grid constants.

    Either (da_fid, h_fid) directly or (om_ap, z_ap) to compute them from flat
    LCDM (pybird.py:1522-1530).  ``rdrag_ap``/``hubble_ap`` feed the derived
    α⊥/α∥ (pybird.py:1564-1579).  ``n_gl`` Gauss–Legendre nodes for the
    float32 quadrature (0: trapezoid for every dtype); ``quadrature``
    ``"by_dtype"`` (that rule) or ``"gauss_legendre"`` (those nodes for every
    dtype).
    """
    if quadrature not in ("by_dtype", "gauss_legendre"):
        raise ValueError(f"unknown AP quadrature {quadrature!r}")
    if quadrature == "gauss_legendre" and n_gl <= 0:
        raise ValueError("quadrature='gauss_legendre' needs n_gl > 0")
    if da_fid is None or h_fid is None:
        if om_ap is None or z_ap is None:
            raise ValueError("need (da_fid, h_fid) or (om_ap, z_ap)")
        da_fid = lcdm_da(om_ap, z_ap)
        h_fid = lcdm_hubble(om_ap, z_ap)
    nmu = nbinsmu * accboost
    nlmax = nlmax or cfg.nl

    def nodes_weights(mu, wmu):
        # (2l+1)/2 L_2i(µ) at the nodes, times 2·quadrature weights
        legw = np.stack(
            [(4.0 * i + 1.0) / 2.0 * legendre_even(i, mu) for i in range(nlmax)]
        )  # (nlmax, nmu)
        return mu, 2.0 * legw * wmu[None, :]

    # upstream quadrature: nbinsmu-point trapezoid on [0, 1]
    # (pybird.py:1581-1596) — the float64 parity path
    mu = np.linspace(0.0, 1.0, nmu)
    wmu = np.full(nmu, mu[1] - mu[0])
    wmu[0] *= 0.5
    wmu[-1] *= 0.5
    mu, proj = nodes_weights(mu, wmu)
    # Gauss–Legendre quadrature — the float32 path.  The µ integrand is C²
    # (even polynomials of µ' times a cubic spline along k'(k,µ)), so a
    # handful of GL nodes sit far below the trapezoid's own O(h²) error,
    # and the per-walker (nk, nmu, n) spline operator shrinks by nmu/n_gl.
    if n_gl > 0:
        x_gl, w_gl = np.polynomial.legendre.leggauss(n_gl)
        mu_gl, proj_gl = nodes_weights(0.5 * (x_gl + 1.0), 0.5 * w_gl)
    else:
        mu_gl = proj_gl = None
    if quadrature == "gauss_legendre":
        mu, proj = mu_gl, proj_gl
    return dict(
        da_fid=float(da_fid),
        h_fid=float(h_fid),
        rdrag_ap=rdrag_ap,
        h_ap=hubble_ap,
        mu=mu,
        proj=proj,
        mu_gl=mu_gl,
        proj_gl=proj_gl,
        nlmax=nlmax,
        ap_st=ap_st,
        spline=SplineTable.build(cfg.k),
        k=cfg.k,
    )


def build_ap_tables(cfg: EFTConfig, device, dtype, **kwargs) -> dict:
    return to_device(ap_tables_numpy(cfg, **kwargs), device, dtype)


def ap_params(at: dict, da, h):
    """(q⊥, q∥) from the sampled background (pybird.py:1554-1562)."""
    return da / at["da_fid"], at["h_fid"] / h


def alperp_alpara(at: dict, da, h, rdrag, hubble):
    """Derived (α⊥, α∥) including the rdrag·h rescaling (pybird.py:1564-1579)."""
    qperp, qpar = ap_params(at, da, h)
    if at["rdrag_ap"] is None or at["h_ap"] is None:
        return qperp, qpar
    ratio = (at["rdrag_ap"] * at["h_ap"]) / (rdrag * hubble)
    return qperp * ratio, qpar * ratio


def ap_quadrature(at: dict, dtype):
    """(µ nodes, projection weights) for the evaluation dtype:
    Gauss–Legendre for float32, the upstream trapezoid for float64."""
    if dtype == torch.float32 and at.get("mu_gl") is not None:
        return at["mu_gl"], at["proj_gl"]
    return at["mu"], at["proj"]


def _project(at: dict, proj, plk, kp, leg_mup):
    """Interpolate multipoles to (k', µ), rebuild P(k,µ), re-project
    (pybird.py:1581-1596), contracted into one per-walker operator.

    Cubic-spline interpolation is linear in the data, so the chain
    spline(k'(k,µ)) → ×L_l(µ') → Σ_µ (quadrature×Legendre weights) collapses
    to ``out[w,a,p,k] = Σ_{l,j} T[w,a,l,k,j]·plk[w,l,p,j]`` with T built by
    contracting the spline's segment weights against the µ weights FIRST, so
    the (channels × nk·nmu) interpolants never materialise.

    plk: (W, nl, P, n); kp: (W, nk, nmu); leg_mup: (W, nl, nmu);
    proj: (nlmax, nmu).  Returns (W, nlmax, P, nk).
    """
    table = at["spline"]
    x, h, m2 = table.x, table.h, table.m2
    n = x.shape[0]

    # containing segment, clipped to [0, n-2]; each query touches knots idx
    # and idx+1 with the weights of the Hermite form of ops/interp.spline_eval
    idx = segment_index(kp, x)                    # (W, nk, nmu)
    hi = h[idx]
    t = (kp - x[idx]) / hi
    u = 1.0 - t
    h26 = hi * hi / 6.0

    def seg_weights(c0, c1):
        # W[w,k,m,i] = c0·[idx=i] + c1·[idx+1=i], shape (W, nk, nmu, n)
        out = kp.new_zeros(kp.shape + (n,))
        out.scatter_(-1, idx[..., None], c0[..., None])
        out.scatter_(-1, idx[..., None] + 1, c1[..., None])
        return out

    wy = seg_weights(u, t)
    wm = seg_weights(h26 * (u * u * u - u), h26 * (t * t * t - t))

    a_w = proj[:, None, :] * leg_mup[..., None, :, :]      # (W, a, l, nmu)
    ty = torch.einsum("walm,wkmi->walki", a_w, wy)
    tm = torch.einsum("walm,wkmi->walki", a_w, wm)
    t_op = ty + torch.einsum("walki,ij->walkj", tm, m2)
    return torch.einsum("walkj,wlpj->wapk", t_op, plk)


def ap_transform(at: dict, cfg: EFTConfig, bird: BirdState, qperp, qpar) -> BirdState:
    """Apply the AP distortion to all multipole tensors (pybird.py:1598-1621);
    ``qperp``/``qpar`` are (W,) tensors (or floats, broadcast to the batch)."""
    ref = bird.p11l
    nw = ref.shape[0]
    mu, proj = ap_quadrature(at, ref.dtype)
    k = at["k"]
    qperp = torch.as_tensor(qperp, dtype=ref.dtype, device=ref.device).expand(nw)[:, None]
    qpar = torch.as_tensor(qpar, dtype=ref.dtype, device=ref.device).expand(nw)[:, None]
    finv2 = (qperp / qpar) ** 2                         # (W, 1)
    warp = torch.sqrt(1.0 + mu * mu * (finv2 - 1.0))    # (W, nmu)
    kp = k[None, :, None] / qperp[:, :, None] * warp[:, None, :]   # (W, nk, nmu)
    mup = mu / (qpar / qperp) / warp                    # (W, nmu)
    leg_mup = torch.stack([legendre_even(i, mup) for i in range(at["nlmax"])], dim=-2)
    coef = 1.0 / (qperp * qperp * qpar)                 # (W, 1)

    # one fused projection for all structure channels: the spline operator is
    # shared instead of repeated per array
    fields = ["p11l", "pctl", "ploopl"]
    if cfg.with_nnlo:
        fields.append("pct_nnlo_l")
    if at["ap_st"]:
        fields.append("pstl")
    sizes = [getattr(bird, f).shape[-2] for f in fields]
    stacked = torch.cat([getattr(bird, f) for f in fields], dim=-2)
    projected = coef[:, :, None, None] * _project(at, proj, stacked, kp, leg_mup)
    parts = torch.split(projected, sizes, dim=-2)
    return bird._replace(**dict(zip(fields, parts)))
