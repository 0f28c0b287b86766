"""Emulator cosmology, the part the benchmark configurations use:
``PkEmulator`` read from the shipped artifact and ``SolverEmulatorProvider``.

``PkEmulator`` is a polynomial ridge on normalised (ω_b, ω_cdm, h[, m_ncdm])
that predicts log T(k, z) of total matter and cb on the solver's grids and
log r_drag, optionally blended with an inner-region ridge.
``SolverEmulatorProvider`` turns it into the pipeline's ``CosmoInputs``:
P_lin at z_eff on ``cfg.kin``, the growth rate f = dln σ8/dln a from the
emulated spectra, and the AP distortions from an exact flat-ΛCDM(+ν as
matter) background.  Parameters are (W,) tensors.
"""

from __future__ import annotations

import math
import numpy as np
import torch
from dataclasses import dataclass, field
from itertools import combinations_with_replacement
from pathlib import Path

from ..models.config import EFTConfig
from ..models.pipeline import CosmoInputs
from ..models.window import MetaInfoError
from ..ops.interp import MatmulInterp

# the shipped artifact, read as input data (the same file the program reads)
_ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "eftpipe_tpu_torch" / "boltzmann"
                 / "artifacts")
DEFAULT_PK_ARTIFACT = _ARTIFACT_DIR / "pk_emulator_mnu06.npz"


_GL_N = 64
_GL_CACHE: dict = {}


def _gauss_nodes(like):
    """64 Gauss–Legendre nodes and weights on ``like``'s device and dtype."""
    key = (like.device, like.dtype)
    if key not in _GL_CACHE:
        x, w = np.polynomial.legendre.leggauss(_GL_N)
        _GL_CACHE[key] = (torch.as_tensor(x, dtype=like.dtype, device=like.device),
                          torch.as_tensor(w, dtype=like.dtype, device=like.device))
    return _GL_CACHE[key]


def _const(cache: dict, key, make, like):
    """``make()`` (host NumPy) as a tensor on ``like``'s device and dtype,
    made once per (key, device, dtype)."""
    full = (key, like.device, like.dtype)
    if full not in cache:
        cache[full] = torch.as_tensor(np.ascontiguousarray(make()), dtype=like.dtype,
                                      device=like.device)
    return cache[full]


def poly_exponents(nin: int, degree: int) -> np.ndarray:
    """(nterms, nin) exponents of the monomials up to ``degree`` in the fixed
    term order of the JAX package's ``_poly_design``: the constant, then each
    degree's ``combinations_with_replacement`` in lexicographic order."""
    rows = [np.zeros(nin, np.int64)]
    for d in range(1, degree + 1):
        for combo in combinations_with_replacement(range(nin), d):
            rows.append(np.bincount(combo, minlength=nin))
    return np.stack(rows)


def _poly_design(xn, degree: int, cache: dict):
    """Monomial design matrix (..., nterms) of the (..., nin) normalised
    inputs: the powers x_j^0..x_j^degree, then one gather per input (a
    handful of launches instead of one per term)."""
    nin = xn.shape[-1]
    expo = _const(cache, ("expo", nin, degree), lambda: poly_exponents(nin, degree).T,
                  torch.empty((), dtype=torch.int64, device=xn.device))  # (nin, nterms)
    # the powers by repeated products: the backward of torch.cumprod reads
    # its input back to the host (one synchronisation per call)
    pows = [torch.ones_like(xn)]
    for _ in range(degree):
        pows.append(pows[-1] * xn)
    pw = torch.stack(pows, dim=-1)  # (..., nin, degree + 1)
    out = pw[..., 0, :].index_select(-1, expo[0])
    for j in range(1, nin):
        out = out * pw[..., j, :].index_select(-1, expo[j])
    return out


def _host(a) -> np.ndarray:
    """A host NumPy copy of a tensor or array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _smoothstep(t):
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@dataclass(eq=False)
class PkEmulator:
    """Polynomial-ridge emulator of the Einstein–Boltzmann solver's
    log-transfer outputs (host NumPy arrays; trained by
    :func:`train_pk_emulator`).  ``y = y_mean + design(x) @ coeffs``; with the inner
    ridge, ``(1 - w)·global + w·inner`` with w a C¹ smoothstep bump that is
    1 over [blend_lo, blend_hi] and 0 outside the margin-expanded box."""

    coeffs: np.ndarray          # (nterms, d)
    y_mean: np.ndarray          # (d,)
    x_mean: np.ndarray
    x_std: np.ndarray
    degree: int
    kgrid: np.ndarray           # solver k grid, 1/Mpc
    z_grid: np.ndarray          # output redshifts (uniform in ln a)
    input_names: tuple = ("omega_b", "omega_cdm", "h")
    bounds_lo: np.ndarray | None = None
    bounds_hi: np.ndarray | None = None
    coeffs_in: np.ndarray | None = None
    y_mean_in: np.ndarray | None = None
    x_mean_in: np.ndarray | None = None
    x_std_in: np.ndarray | None = None
    degree_in: int | None = None
    blend_lo: np.ndarray | None = None
    blend_hi: np.ndarray | None = None
    blend_margin: np.ndarray | None = None
    m_ncdm: float | None = None     # eV per massive species
    deg_ncdm: float | None = None   # massive species count
    n_ur: float | None = None       # massless families
    yhe: float | None = None
    meta: dict | None = None
    _cache: dict = field(default_factory=dict, repr=False)

    def _ridge(self, x, cols, coeffs: str, y_mean: str, x_mean: str, x_std: str, degree: int):
        ckey = None if cols is None else cols.tobytes()

        def sl(name):
            a = np.asarray(getattr(self, name))
            if cols is None:
                return a
            return a[..., cols] if a.ndim == 1 else a[:, cols]

        xn = (x - _const(self._cache, x_mean, lambda: getattr(self, x_mean), x)) / _const(
            self._cache, x_std, lambda: getattr(self, x_std), x)
        return _const(self._cache, (y_mean, ckey), lambda: sl(y_mean), x) + _poly_design(
            xn, degree, self._cache) @ _const(self._cache, (coeffs, ckey), lambda: sl(coeffs), x)

    def raw(self, x, cols=None):
        """Emulated outputs (W, d) of the inputs x (W, nin); ``cols`` (a host
        index array) restricts the prediction to those output columns by
        slicing the coefficients BEFORE the product (exact per column: the
        ridge is linear in them)."""
        pred = self._ridge(x, cols, "coeffs", "y_mean", "x_mean", "x_std", self.degree)
        if self.coeffs_in is None:
            return pred
        pred_in = self._ridge(x, cols, "coeffs_in", "y_mean_in", "x_mean_in", "x_std_in",
                              self.degree_in)
        lo = _const(self._cache, "blend_lo", lambda: self.blend_lo, x)
        hi = _const(self._cache, "blend_hi", lambda: self.blend_hi, x)
        m = _const(self._cache, "blend_margin", lambda: self.blend_margin, x)
        bump = _smoothstep((x - (lo - m)) / m) * _smoothstep(((hi + m) - x) / m)
        # the product over the inputs by slices: the backward of torch.prod
        # reads its input back to the host
        w = bump[..., :1]
        for j in range(1, bump.shape[-1]):
            w = w * bump[..., j:j + 1]
        return (1.0 - w) * pred + w * pred_in

    def unpack(self, y):
        """y (..., d) -> (log T_m (..., nz, nk), log T_cb (..., nz, nk), log rdrag (...))."""
        nz, nk = len(self.z_grid), len(self.kgrid)
        lead = y.shape[:-1]
        log_tm = y[..., : nz * nk].reshape(*lead, nz, nk)
        log_tcb = y[..., nz * nk: 2 * nz * nk].reshape(*lead, nz, nk)
        return log_tm, log_tcb, y[..., -1]

    def box(self) -> tuple[np.ndarray, np.ndarray]:
        """Validity box (lo, hi); artifacts without bounds fall back to the
        Sobol inference x_mean ± √3·x_std."""
        if self.bounds_lo is not None and self.bounds_hi is not None:
            return np.asarray(self.bounds_lo), np.asarray(self.bounds_hi)
        lo = np.asarray(self.x_mean) - np.sqrt(3.0) * np.asarray(self.x_std)
        hi = np.asarray(self.x_mean) + np.sqrt(3.0) * np.asarray(self.x_std)
        return lo, hi

    def mnu_total(self) -> float | None:
        """Σm_ν [eV] the artifact was trained at (None if unrecorded)."""
        if self.m_ncdm is None:
            return None
        return float(self.m_ncdm) * float(self.deg_ncdm or 1.0)

    @classmethod
    def load(cls, path) -> "PkEmulator":
        with np.load(path) as z:
            def opt(name):
                return float(z[name]) if name in z.files else None

            meta = {k[5:]: z[k].item() for k in z.files if k.startswith("meta_")}
            inner = {}
            if "coeffs_in" in z.files:
                inner = {name: np.asarray(z[name]) for name in (
                    "coeffs_in", "y_mean_in", "x_mean_in", "x_std_in",
                    "blend_lo", "blend_hi", "blend_margin")}
                inner["degree_in"] = int(z["degree_in"])
            return cls(
                coeffs=np.asarray(z["coeffs"]), y_mean=np.asarray(z["y_mean"]),
                x_mean=np.asarray(z["x_mean"]), x_std=np.asarray(z["x_std"]),
                degree=int(z["degree"]), kgrid=z["kgrid"], z_grid=z["z_grid"],
                input_names=(tuple(str(s) for s in z["input_names"])
                             if "input_names" in z.files
                             else ("omega_b", "omega_cdm", "h")),
                bounds_lo=z["bounds_lo"] if "bounds_lo" in z.files else None,
                bounds_hi=z["bounds_hi"] if "bounds_hi" in z.files else None,
                m_ncdm=opt("m_ncdm"), deg_ncdm=opt("deg_ncdm"),
                n_ur=opt("n_ur"), yhe=opt("yhe"), meta=meta or None,
                **inner,
            )


@dataclass(eq=False)
class SolverEmulatorProvider:
    """Cosmology provider of emulated solver spectra (sampled: omega_b,
    omega_cdm, h, ln10As, ns, plus m_ncdm or the total mnu for a 4-input
    artifact).  Inputs outside the training box are clamped for the
    evaluation and rejected by :meth:`validity_logp` (−inf) when
    ``out_of_box="reject"``."""

    cfg: EFTConfig
    zeff: float
    emulator: PkEmulator
    da_fid: float | None = None    # dimensionless H0*DA of the fiducial
    h_fid: float | None = None     # dimensionless H/H0 of the fiducial
    use_cb: bool = False
    use_ap: bool = True
    rdrag_fid: float | None = None
    h0_fid: float | None = None
    out_of_box: str = "reject"     # "reject" (logp=-inf) | "clamp"
    mnu_fixed: float | None = None  # per-species mass for a 4-input artifact
    _cache: dict = field(default_factory=dict, repr=False)
    _plan: tuple | None = field(default=None, repr=False)

    @classmethod
    def load(cls, cfg: EFTConfig, zeff: float, path=None, mnu=None,
             n_ur=None, yhe=None, **kwargs):
        """Load an artifact, checking the requested physics against its
        training metadata (a mismatch raises ``MetaInfoError`` at build)."""
        path = path or DEFAULT_PK_ARTIFACT
        emu = PkEmulator.load(path)
        sampled_mnu = "m_ncdm" in emu.input_names
        requested = {"mnu": mnu, "n_ur": n_ur, "yhe": yhe}
        stored = {"mnu": emu.mnu_total(), "n_ur": emu.n_ur, "yhe": emu.yhe}
        for name, want in requested.items():
            if want is None:
                continue
            if name == "mnu" and sampled_mnu:
                # 4-input artifact: m_ncdm is an emulator dimension, any Σm_ν
                # inside its trained range is valid
                deg = float(emu.deg_ncdm or 1.0)
                m_per = float(want) / deg
                lo, hi = emu.box()
                i = emu.input_names.index("m_ncdm")
                if not (lo[i] <= m_per <= hi[i]):
                    raise MetaInfoError(
                        f"config requests mnu={want} (m_ncdm={m_per:.4g}/"
                        f"species) but artifact {path} covers m_ncdm in "
                        f"[{lo[i]:.4g}, {hi[i]:.4g}] — retrain with a wider "
                        f"mass range (tools/train_solver_emulator.py "
                        f"--sample-mnu)"
                    )
                kwargs.setdefault("mnu_fixed", m_per)
                continue
            have = stored[name]
            if have is None:
                raise MetaInfoError(
                    f"config requests {name}={want} but artifact {path} "
                    f"records no {name} metadata — retrain with "
                    f"tools/train_solver_emulator.py to stamp it"
                )
            if abs(float(want) - float(have)) > 1e-8 + 1e-6 * abs(float(have)):
                raise MetaInfoError(
                    f"config requests {name}={want} but artifact {path} was "
                    f"trained at {name}={have}; train a matching artifact "
                    f"(tools/train_solver_emulator.py) or drop the request"
                )
        return cls(cfg=cfg, zeff=zeff, emulator=emu, **kwargs)

    def _t(self, key, make, like):
        return _const(self._cache, key, make, like)

    # -- validity ------------------------------------------------------------
    def _input_value(self, name, params):
        """One emulator input (W,) from the parameter dict; ``m_ncdm`` may
        come from a sampled ``m_ncdm``, a sampled total ``mnu`` (÷ deg_ncdm)
        or the value fixed at load (``load(mnu=...)``)."""
        like = params["h"]
        if name in params:
            return torch.as_tensor(params[name], dtype=like.dtype, device=like.device)
        if name == "m_ncdm":
            deg = float(self.emulator.deg_ncdm or 1.0)
            if "mnu" in params:
                return torch.as_tensor(params["mnu"], dtype=like.dtype, device=like.device) / deg
            if self.mnu_fixed is not None:
                return torch.full_like(like, self.mnu_fixed)
        raise KeyError(
            f"emulator input {name!r} is neither sampled nor fixed — sample "
            f"it, or fix it via SolverEmulatorProvider.load(mnu=...)"
        )

    def _x(self, params):
        return torch.stack([self._input_value(n, params)
                            for n in self.emulator.input_names], dim=-1)

    def _box(self, like):
        lo, hi = self.emulator.box()
        return self._t("lo", lambda: lo, like), self._t("hi", lambda: hi, like)

    def in_box(self, params):
        """(W,) True where every emulator input lies inside the training box."""
        x = self._x(params)
        lo, hi = self._box(x)
        return ((x >= lo) & (x <= hi)).all(dim=-1)

    def validity_logp(self, params):
        """(W,): 0 inside the training box, −inf outside (when rejecting)."""
        like = params["h"]
        if self.out_of_box != "reject":
            return torch.zeros_like(like)
        return torch.zeros_like(like).masked_fill(~self.in_box(params), -math.inf)

    # -- core evaluation ----------------------------------------------------
    def _pzeta(self, params, k):
        as_ = 1e-10 * torch.exp(params["ln10As"])
        return 2.0 * math.pi**2 / k**3 * as_[..., None] * (k / 0.05) ** (
            params["ns"][..., None] - 1.0)

    def _eval(self, params):
        """(k (nk,), P_m (W, nz, nk), P_cb (W, nz, nk), rdrag (W,)) in Mpc units."""
        emu = self.emulator
        x = self._x(params)
        lo, hi = self._box(x)
        x = torch.clamp(x, lo, hi)
        log_tm, log_tcb, log_rd = emu.unpack(emu.raw(x))
        rdrag = torch.exp(log_rd)
        k = self._t("kgrid", lambda: emu.kgrid, x)
        pzeta = self._pzeta(params, k)[..., None, :]
        return k, pzeta * torch.exp(2.0 * log_tm), pzeta * torch.exp(2.0 * log_tcb), rdrag

    def _sigma8(self, params, k, pk):
        """σ8 of each (W, nz', nk) spectrum → (W, nz')."""
        r8 = 8.0 / params["h"]
        x = k * r8[..., None]
        w = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x**3
        integ = k**3 * pk * (w * w)[..., None, :] / (2.0 * math.pi**2)
        return torch.sqrt(torch.trapezoid(integ, torch.log(k), dim=-1))

    def _sigma8_f(self, params, k, pk):
        """σ8 and f = dln σ8/dln a on the z grid (W, nz) (uniform-in-ln-a
        grid → central differences, one-sided at the ends), and the ln a grid."""
        s8 = self._sigma8(params, k, pk)
        lna = np.log(1.0 / (1.0 + np.asarray(self.emulator.z_grid, np.float64)))
        dl = self._t("dl", lambda: lna[1] - lna[0], s8)
        return s8, torch.gradient(torch.log(s8), dim=-1)[0] / dl, lna

    def _zinterp(self, lna_grid, table):
        """Linear interpolation of (W, nz) ``table`` at ln a(zeff), clamped."""
        q = torch.full((), math.log(1.0 / (1.0 + self.zeff)), dtype=table.dtype,
                       device=table.device)
        return MatmulInterp.build(lna_grid).interp(q, table)

    def _background(self, params):
        """Exact flat-ΛCDM(+ν as matter) background at zeff: (H/H0, H0·DA),
        each (W,).  Radiation (photons + the artifact's N_ur) is included;
        the neutrino setup comes from the artifact's metadata."""
        emu = self.emulator
        h = params["h"]
        if "m_ncdm" in emu.input_names:
            mnu = self._input_value("m_ncdm", params) * float(emu.deg_ncdm or 1.0)
        else:
            mnu = emu.mnu_total() if emu.mnu_total() is not None else 0.06
        n_ur = emu.n_ur if emu.n_ur is not None else 0.00641
        h2 = h**2
        om_g = 2.47282e-5 / h2 * (1.0 + 0.2271 * n_ur)
        om_m = (params["omega_b"] + params["omega_cdm"] + mnu / 93.14) / h2
        om_l = 1.0 - om_m - om_g
        col = lambda t: t[..., None]

        def e_of_z(z, om_m, om_g, om_l):
            return torch.sqrt(om_m * (1 + z) ** 3 + om_g * (1 + z) ** 4 + om_l)

        glx, glw = _gauss_nodes(h)
        z = self.zeff
        zp = z * (glx + 1.0) / 2.0
        chi = torch.sum(glw * z / 2.0 / e_of_z(zp, col(om_m), col(om_g), col(om_l)), dim=-1)
        return e_of_z(torch.full_like(h, z), om_m, om_g, om_l), chi / (1.0 + z)

    def _ap(self, params, like):
        if self.use_ap and self.da_fid is not None:
            e, da = self._background(params)
            return da / self.da_fid, self.h_fid / e
        one = torch.ones_like(like)
        return one, one

    # -- provider interface ---------------------------------------------------
    def _zplan(self):
        """Host plan of the hot path: the emulator output columns ``inputs``
        consumes (log T at the two z rows around zeff plus the rows of the
        growth-rate stencils), the z blend and the growth stencil ``fvec``
        (central differences inside, one-sided at the ends, clamped like the
        interpolation of :meth:`_zinterp`), and the linear-interpolation
        table on log k."""
        if self._plan is not None:
            return self._plan
        emu = self.emulator
        nz, nk = len(emu.z_grid), len(emu.kgrid)
        lna_g = np.log(1.0 / (1.0 + np.asarray(emu.z_grid, np.float64)))
        dl = lna_g[1] - lna_g[0]
        w = (np.log(1.0 / (1.0 + self.zeff)) - lna_g[0]) / dl
        # the log P z-blend (possibly extrapolating, as the full path)
        i0 = int(np.clip(np.floor(w), 0, nz - 2))
        ww = float(w - i0)

        def grad_stencil(i):
            if i == 0:
                return {0: -1.0 / dl, 1: 1.0 / dl}
            if i == nz - 1:
                return {nz - 2: -1.0 / dl, nz - 1: 1.0 / dl}
            return {i - 1: -0.5 / dl, i + 1: 0.5 / dl}

        # f at zeff: the interpolation CLAMPS outside the grid
        fcoef: dict = {}
        if w <= 0.0:
            pieces = [(grad_stencil(0), 1.0)]
        elif w >= nz - 1:
            pieces = [(grad_stencil(nz - 1), 1.0)]
        else:
            pieces = [(grad_stencil(i0), 1.0 - ww), (grad_stencil(i0 + 1), ww)]
        for st, c in pieces:
            for j, g in st.items():
                fcoef[j] = fcoef.get(j, 0.0) + c * g
        rows = sorted(set(fcoef) | {i0, i0 + 1})
        fvec = np.array([fcoef.get(j, 0.0) for j in rows])
        off = nz * nk if self.use_cb else 0
        cols = (off + np.asarray(rows)[:, None] * nk + np.arange(nk)[None, :]).ravel()
        lut = MatmulInterp.build(np.log(np.asarray(emu.kgrid, np.float64)))
        self._plan = (rows, fvec, rows.index(i0), rows.index(i0 + 1), ww, cols, lut)
        return self._plan

    def _plin(self, params, lut, lpk_z):
        """P_lin on cfg.kin [(Mpc/h)³] from log P(k) [Mpc³] (W, nk) at zeff."""
        h = params["h"]
        kin = self._t("kin", lambda: self.cfg.kin, h)
        kin_mpc = kin * h[..., None]
        return torch.exp(lut.interp_rows(torch.log(kin_mpc), lpk_z)) * (h**3)[..., None]

    def inputs(self, params, sliced: bool = True) -> CosmoInputs:
        """``CosmoInputs`` of a (W,) parameter batch.  ``sliced=False`` takes
        the full-grid path (all z rows of both species), the A/B reference
        of the sliced one."""
        if not sliced:
            return self._inputs_full(params)
        emu = self.emulator
        rows, fvec, ri0, ri1, ww, cols, lut = self._zplan()
        x = self._x(params)
        lo, hi = self._box(x)
        x = torch.clamp(x, lo, hi)
        log_t = emu.raw(x, cols=cols).reshape(*x.shape[:-1], len(rows), len(emu.kgrid))
        k = self._t("kgrid", lambda: emu.kgrid, x)
        pk = self._pzeta(params, k)[..., None, :] * torch.exp(2.0 * log_t)  # (W, nsel, nk)
        # z interpolation of log P, linear in ln a
        lpk = torch.log(pk)
        lpk_z = lpk[..., ri0, :] * (1 - ww) + lpk[..., ri1, :] * ww
        plin = self._plin(params, lut, lpk_z)
        # f(zeff): the growth stencil contracted over the selected rows
        f = torch.log(self._sigma8(params, k, pk)) @ self._t("fvec", lambda: fvec, x)
        qperp, qpar = self._ap(params, f)
        return CosmoInputs(plin=plin, f=f, qperp=qperp, qpar=qpar)

    def _inputs_full(self, params) -> CosmoInputs:
        k, pk_m, pk_cb, _ = self._eval(params)
        pk = pk_cb if self.use_cb else pk_m
        lna_g = np.log(1.0 / (1.0 + np.asarray(self.emulator.z_grid, np.float64)))
        lpk = torch.log(pk)
        w = (math.log(1.0 / (1.0 + self.zeff)) - lna_g[0]) / (lna_g[1] - lna_g[0])
        i0 = int(np.clip(np.floor(w), 0, lna_g.size - 2))
        ww = w - i0
        lpk_z = lpk[..., i0, :] * (1 - ww) + lpk[..., i0 + 1, :] * ww
        plin = self._plin(params, self._zplan()[-1], lpk_z)
        _, fgrid, lna = self._sigma8_f(params, k, pk)
        f = self._zinterp(lna, fgrid)
        qperp, qpar = self._ap(params, f)
        return CosmoInputs(plin=plin, f=f, qperp=qperp, qpar=qpar)

    def derived(self, params) -> dict:
        """fz, fσ8(z), α⊥, α∥, σ8(z), r_drag at zeff, each (W,)."""
        k, pk_m, pk_cb, rdrag = self._eval(params)
        pk = pk_cb if self.use_cb else pk_m
        s8, fgrid, lna = self._sigma8_f(params, k, pk)
        f = self._zinterp(lna, fgrid)
        s8z = self._zinterp(lna, s8)
        qperp, qpar = self._ap(params, f)
        if self.rdrag_fid is not None and self.h0_fid is not None:
            ratio = (self.rdrag_fid * self.h0_fid) / (rdrag * params["h"])
            alperp, alpara = qperp * ratio, qpar * ratio
        else:
            alperp, alpara = qperp, qpar
        return dict(fz=f, fsigma8_z=f * s8z, alperp=alperp, alpara=alpara,
                    sigma8_z=s8z, rdrag=rdrag)
