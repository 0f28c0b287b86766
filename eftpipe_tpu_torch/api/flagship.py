"""Flagship analysis: self-contained two-tracer eBOSS-style joint fit
(counterpart of ``eftpipe_tpu/api/flagship.py``).

Two tracers (LRG-like z=0.70 with P0/P2/P4, ELG-like z=0.845 with P0/P2),
each with IR resummation, AP projection, survey-window convolution
(synthetic but realistic mask multipoles), k-binning, and a joint
Gaussian-covariance likelihood with analytic marginalization over the 12
linearly-entering EFT parameters.  Cosmology runs on the device through the
solver emulator (the shipped artifact; Eisenstein–Hu with
``cosmology="eh98"``), so the sampled vector is

    theta = (omega_cdm, h, ln10As, LRG_b1, LRG_b2, LRG_b4,
             ELG_b1, ELG_b2, ELG_b4)

and ``FlagshipModel.logp(thetas)`` maps a walker batch (W, 9) to (W,).

The mock data vector is generated from the model itself at the fiducial
parameter point; the covariance is the analytic Gaussian covariance at that
point.  All Phase-A artifacts are cached under ``workdir``.

The defaults are the JAX package's: window on (``window_nmax=2048``) and
``cosmology=None``, which resolves to ``"solver_emulator"`` when the artifact
ships (it does) and to ``"eh98"`` otherwise.
"""

from __future__ import annotations

import json
import numpy as np
import torch
from dataclasses import dataclass
from pathlib import Path

from .. import resolve_device
from ..models.config import EFTConfig
from ..models.pipeline import TracerPipeline
from ..models.ap import lcdm_da, lcdm_hubble
from ..models.nonlinear import LOWRANK_TOL, cf_loop_complex, complex_cf_matrices
from ..likelihood.likelihood import EFTLikelihood, TracerSpec
from ..likelihood.parambasis import WestCoastBasis
from ..likelihood.covariance import GaussianCovariance, Multipole
from ..ops.quadform import kernel_matrices
from ..boltzmann.eh98 import EisensteinHuProvider
from ..boltzmann.emulator import DEFAULT_PK_ARTIFACT, SolverEmulatorProvider

FIDUCIAL = dict(omega_b=0.02237, omega_cdm=0.1200, h=0.6777, ln10As=3.044, ns=0.9649)
TRACERS = {
    "LRG": dict(zeff=0.70, ls=[0, 2, 4], kmin=0.01, kmax=0.20, nd=5e-5,
                b1=2.2, b2=0.8, b4=0.8, smask=350.0),
    "ELG": dict(zeff=0.845, ls=[0, 2], kmin=0.03, kmax=0.20, nd=1.85e-4,
                b1=1.3, b2=0.5, b4=0.5, smask=250.0),
}
COSMO_NAMES = ["omega_cdm", "h", "ln10As"]
BIAS_NAMES = ["b1", "b2", "b4"]


def synthetic_mask_file(path: Path, smask: float) -> Path:
    """Plausible survey-mask multipoles Q_q(s): monopole ~1 at small s with a
    smooth roll-off, small anisotropic Q2/Q4 contributions."""
    s = np.geomspace(3.0, 4000.0, 2000)
    roll = 1.0 / (1.0 + (s / smask) ** 3)
    q0 = roll
    q2 = 0.08 * (s / smask) / (1.0 + (s / smask) ** 4)
    q4 = 0.03 * (s / smask) ** 2 / (1.0 + (s / smask) ** 5)
    np.savetxt(path, np.column_stack([s, q0, q2, q4]), header="s Q0 Q2 Q4")
    return path


@dataclass(eq=False)
class FlagshipModel:
    like: EFTLikelihood
    providers: dict
    param_names: list[str]
    theta0: np.ndarray
    dtype: torch.dtype
    device: torch.device

    def params_dict(self, thetas) -> dict:
        """Named (W,) parameter tensors of a (W, ndim) batch."""
        nw = thetas.shape[0]
        base = {k: torch.full((nw,), v, dtype=self.dtype, device=self.device)
                for k, v in FIDUCIAL.items()}
        for i, name in enumerate(self.param_names):
            base[name] = thetas[:, i]
        return base

    def _as_batch(self, thetas):
        thetas = torch.as_tensor(thetas, dtype=self.dtype, device=self.device)
        if thetas.dim() != 2 or thetas.shape[1] != len(self.param_names):
            raise ValueError(
                f"thetas must have shape (W, {len(self.param_names)}), got {tuple(thetas.shape)}")
        return thetas

    def cosmo_inputs(self, thetas) -> tuple[dict, dict]:
        params = self.params_dict(thetas)
        return {t: p.inputs(params) for t, p in self.providers.items()}, params

    def _logp_batch(self, thetas):
        inputs, params = self.cosmo_inputs(thetas)
        return self.like.logp(inputs, params)["logp"]

    def logp(self, thetas, chunk: int | None = None):
        """Log-posterior of a walker batch: thetas (W, 9) → (W,).  ``chunk``
        splits W into pieces evaluated one after the other, bounding the
        per-walker intermediates (the counterpart of the JAX package's
        ``chunked_vmap``)."""
        thetas = self._as_batch(thetas)
        nw = thetas.shape[0]
        if not chunk or chunk >= nw:
            return self._logp_batch(thetas)
        return torch.cat([self._logp_batch(thetas[i:i + chunk])
                          for i in range(0, nw, chunk)])

    def fold_ab_check(self, thetas, tracer: str = "LRG", ell_index: int = 0):
        """A/B check of the Hermitian fold at this model's widths: the ℓ =
        ``ell_index`` CF loop terms of ``tracer`` through the complex
        quadratic form (``cf_contract`` on the unfolded matrices) against the
        folded real form (``quad_form_real``).  Returns (reference, folded),
        both (W, 38, ns).  The complex matrices, and on the card their
        kernel layouts, are made on first use."""
        thetas = self._as_batch(thetas)
        pipe = self.like.tracers[tracer].pipeline
        key = (tracer, ell_index)
        cache = self.__dict__.setdefault("_complex_cf", {})
        if key not in cache:
            m = complex_cf_matrices(pipe.cfg, ell_index)
            parts = tuple(
                torch.as_tensor(np.ascontiguousarray(part), dtype=self.dtype, device=self.device)
                for part in (m.real, m.imag))
            lays = tuple(kernel_matrices(p) for p in parts) if parts[0].is_cuda else None
            cache[key] = parts, lays
        inputs, _ = self.cosmo_inputs(thetas)
        parts, lays = cache[key]
        return cf_loop_complex(pipe.nt, pipe.cfg, inputs[tracer].plin, parts, ell_index, lays)


def _fiducial_multipoles(pipe: TracerPipeline, provider, params, basis, binning):
    """Theory multipoles at the fiducial point (a batch of one)."""
    tparams = {k: torch.full((1,), float(v), dtype=pipe.dtype, device=pipe.device)
               for k, v in params.items()}
    with torch.no_grad():
        bird = pipe.compute_bird(provider.inputs(tparams))
        _, _, product = pipe.product(bird, chained=False, binning=binning)
        plk = basis.reduce_plk(pipe.cfg, product, tparams).sum()[0]
    ls, kret, _ = pipe.product_info(chained=False, binning=binning)
    return ls, np.asarray(kret), plk.double().cpu().numpy()


def _make_provider(cfg, zeff, om_fid, cosmology: str):
    da_fid, h_fid = lcdm_da(om_fid, zeff), lcdm_hubble(om_fid, zeff)
    if cosmology == "solver_emulator":
        return SolverEmulatorProvider.load(cfg=cfg, zeff=zeff, da_fid=da_fid, h_fid=h_fid)
    return EisensteinHuProvider(cfg=cfg, zeff=zeff, da_fid=da_fid, h_fid=h_fid)


def _resolve_cosmology(cosmology: str | None) -> str:
    if cosmology is not None:
        return cosmology
    # the solver emulator when its artifact ships, Eisenstein–Hu otherwise
    return "solver_emulator" if DEFAULT_PK_ARTIFACT.exists() else "eh98"


def build_flagship(
    workdir, dtype=torch.float64, with_window: bool = True, window_nmax: int = 2048,
    cosmology: str | None = None, device=None, quadform: str = "kernel",
    ap_gl: int = 16, ap_quadrature: str = "by_dtype", lowrank_tol: float = LOWRANK_TOL,
    cf_premix: bool = True,
) -> FlagshipModel:
    """Build the flagship model on ``device`` (default: the card; raises when
    there is none — pass ``device="cpu"`` for the plain PyTorch path).

    with_window, window_nmax : the survey window and its FFTLog size.
    cosmology : "solver_emulator", "eh98", or None (the emulator when its
        artifact ships).
    quadform : "kernel" (the fused CUDA quadratic forms on the card),
        "plain" (their two-einsum plain version, an independent reference)
        or "lowrank" (the truncated-eigenbasis factors at the cut
        ``lowrank_tol``, the CF loop premixed unless ``cf_premix`` is False;
        the JAX package's float32 route, an approximation).
    ap_gl : Gauss–Legendre nodes of the float32 AP quadrature.
    ap_quadrature : "by_dtype" (float32: ``ap_gl`` Gauss–Legendre nodes,
        float64: the 200-point trapezoid) or "gauss_legendre" (``ap_gl``
        nodes in every dtype, so that two dtypes differ by rounding alone).

    The mock data and covariance are those of the default float64 dense
    model whatever ``dtype``, ``quadform`` and ``ap_quadrature`` are, so
    every route is compared on the same data.
    """
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    cache = workdir / "cache"
    cosmology = _resolve_cosmology(cosmology)

    # mock data/cov are generated from the model itself: a workdir built for
    # a different cosmology provider, window or theory version must regenerate
    meta_file = workdir / "flagship_meta.json"
    meta = {"cosmology": cosmology, "version": 2, "with_window": with_window,
            "window_nmax": window_nmax if with_window else None}
    stale = True
    if meta_file.exists():
        try:
            stale = json.loads(meta_file.read_text()) != meta
        except json.JSONDecodeError:
            stale = True
    if stale:
        for name in TRACERS:
            (workdir / f"data_{name}.txt").unlink(missing_ok=True)
        (workdir / "cov.txt").unlink(missing_ok=True)
        meta_file.write_text(json.dumps(meta))

    om_fid = (FIDUCIAL["omega_b"] + FIDUCIAL["omega_cdm"]) / FIDUCIAL["h"] ** 2

    def make_pipeline(name, pipe_dtype, route=quadform, quadrature=ap_quadrature):
        tc = TRACERS[name]
        nl = max(tc["ls"]) // 2 + 1
        cfg = EFTConfig(nl=nl, no=nl, nd_a=tc["nd"])
        window = None
        if with_window:
            mask_file = workdir / f"mask_{name}.txt"
            if not mask_file.exists():
                synthetic_mask_file(mask_file, tc["smask"])
            window = dict(window_configspace_file=mask_file, nmax=window_nmax)
        return TracerPipeline.build(
            cfg,
            zeff=tc["zeff"],
            with_irresum=True,
            apeffect=dict(om_ap=om_fid, z_ap=tc["zeff"], rdrag_ap=147.66,
                          hubble_ap=FIDUCIAL["h"], n_gl=ap_gl, quadrature=quadrature),
            window=window,
            cache_dir=cache,
            device=device,
            dtype=pipe_dtype,
            quadform=route,
            lowrank_tol=lowrank_tol,
            cf_premix=cf_premix,
        )

    providers: dict = {}
    fid_params = dict(FIDUCIAL)
    kout = {}
    pipes = {}
    for name, tc in TRACERS.items():
        pipes[name] = make_pipeline(name, dtype)
        providers[name] = _make_provider(pipes[name].cfg, tc["zeff"], om_fid, cosmology)
        kout[name] = np.arange(0.01, 0.2049, 0.005)
        fid_params.update({f"{name}_{b}": tc[b] for b in BIAS_NAMES})

    # ---- mock data + analytic covariance at the fiducial point, always
    # generated by the default float64 dense model whatever this model's
    # dtype, route and quadrature ------------------------------------------
    data_ready = all((workdir / f"data_{n}.txt").exists() for n in TRACERS) and (
        workdir / "cov.txt"
    ).exists()
    if not data_ready:
        cov_blocks = []
        for name, tc in TRACERS.items():
            pipe = pipes[name]
            if dtype != torch.float64 or quadform == "lowrank" or ap_quadrature != "by_dtype":
                pipe = make_pipeline(name, torch.float64,
                                     route="kernel" if quadform == "lowrank" else quadform,
                                     quadrature="by_dtype")
            binning = pipe.binning_tables(kout[name])
            ls, keff, plk = _fiducial_multipoles(
                pipe, providers[name], fid_params, WestCoastBasis(prefix=f"{name}_"), binning
            )
            cols = [kout[name]] + [plk[l // 2] for l in tc["ls"]]
            np.savetxt(
                workdir / f"data_{name}.txt",
                np.column_stack(cols),
                header="k " + " ".join(f"P{l}" for l in tc["ls"]),
            )
            kedges = np.concatenate([binning["binmin"], binning["binmax"][-1:]])
            gcov = GaussianCovariance(kedges, volume=4.0)
            shot = 1.0 / tc["nd"]
            mp = Multipole(
                p0=plk[0] + shot,
                p2=plk[1],
                p4=plk[2] if len(tc["ls"]) > 2 else None,
            )
            cov_blocks.append(gcov(tc["ls"], tc["ls"], "aa->aaaa", mp))
        from scipy.linalg import block_diag

        np.savetxt(workdir / "cov.txt", block_diag(*cov_blocks))

    specs = {
        name: TracerSpec(
            pipeline=pipes[name],
            basis=WestCoastBasis(prefix=f"{name}_"),
            data=dict(path=workdir / f"data_{name}.txt", ls=tc["ls"],
                      kmin=tc["kmin"], kmax=tc["kmax"]),
            with_binning=True,
        )
        for name, tc in TRACERS.items()
    }
    marg = {
        f"{name}_": {
            "b3": {"loc": 0.0, "scale": 2.0},
            "cct": {"loc": 0.0, "scale": 4.0},
            "cr1": {"loc": 0.0, "scale": 8.0},
            "cr2": {"loc": 0.0, "scale": 4.0},
            "ce0": {"loc": 0.0, "scale": 4.0},
            "cequad": {"loc": 0.0, "scale": 2.0},
        }
        for name in TRACERS
    }
    like = EFTLikelihood(tracers=specs, cov=workdir / "cov.txt", marg=marg)

    param_names = COSMO_NAMES + [f"{n}_{b}" for n in TRACERS for b in BIAS_NAMES]
    theta0 = np.array([fid_params[p] for p in param_names])
    return FlagshipModel(
        like=like, providers=providers, param_names=param_names, theta0=theta0,
        dtype=dtype, device=device,
    )
