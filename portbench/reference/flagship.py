"""The two-tracer eBOSS flagship analysis, built from the reference's own
pieces: LRG (z=0.70, P0/P2/P4) and ELG (z=0.845, P0/P2), each with IR
resummation, AP, the survey window and k-binning, a joint Gaussian
covariance and analytic marginalisation over the 12 linear EFT parameters;
the cosmology from the solver emulator.

The numbers (fiducial point, tracers, priors of the marginalised
parameters) come from the configuration file; ``write_inputs`` writes the
masks, the mock data at the fiducial point and the covariance that both the
program and the reference then read.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from scipy.linalg import block_diag

from .boltzmann.emulator import SolverEmulatorProvider
from .likelihood.covariance import GaussianCovariance, Multipole
from .likelihood.likelihood import EFTLikelihood, TracerSpec
from .likelihood.parambasis import WestCoastBasis
from .models.ap import lcdm_da, lcdm_hubble
from .models.config import EFTConfig
from .models.pipeline import TracerPipeline

BIAS_NAMES = ["b1", "b2", "b4"]


def synthetic_mask_file(path: Path, smask: float) -> Path:
    """Survey-mask multipoles Q_q(s): a monopole ~1 at small s with a smooth
    roll-off at ``smask``, small anisotropic Q2/Q4."""
    s = np.geomspace(3.0, 4000.0, 2000)
    roll = 1.0 / (1.0 + (s / smask) ** 3)
    q2 = 0.08 * (s / smask) / (1.0 + (s / smask) ** 4)
    q4 = 0.03 * (s / smask) ** 2 / (1.0 + (s / smask) ** 5)
    np.savetxt(path, np.column_stack([s, roll, q2, q4]), header="s Q0 Q2 Q4")
    return path


def om_fid(fiducial: dict) -> float:
    return (fiducial["omega_b"] + fiducial["omega_cdm"]) / fiducial["h"] ** 2


@dataclass(eq=False)
class FlagshipReference:
    like: EFTLikelihood
    providers: dict
    param_names: list
    fiducial: dict
    dtype: torch.dtype
    device: torch.device

    def params_dict(self, thetas) -> dict:
        nw = thetas.shape[0]
        base = {k: torch.full((nw,), float(v), dtype=self.dtype, device=self.device)
                for k, v in self.fiducial.items()}
        for i, name in enumerate(self.param_names):
            base[name] = thetas[:, i]
        return base

    def logp(self, thetas):
        thetas = torch.as_tensor(thetas, dtype=self.dtype, device=self.device)
        params = self.params_dict(thetas)
        inputs = {t: p.inputs(params) for t, p in self.providers.items()}
        return self.like.logp(inputs, params)["logp"]


def _pipeline(name, tc, spec, workdir, cache_dir, device, dtype, quadrature="by_dtype",
              nfft_loop=None, nkin=None):
    nl = max(tc["ls"]) // 2 + 1
    narrow = {k: v for k, v in (("nfft_loop", nfft_loop), ("nkin", nkin)) if v is not None}
    cfg = EFTConfig(nl=nl, no=nl, nd_a=tc["nd"], **narrow)
    fid = spec["fiducial"]
    window = dict(window_configspace_file=workdir / f"mask_{name}.txt",
                  nmax=spec["window_nmax"])
    return TracerPipeline.build(
        cfg, zeff=tc["zeff"], with_irresum=True,
        apeffect=dict(om_ap=om_fid(fid), z_ap=tc["zeff"], rdrag_ap=147.66,
                      hubble_ap=fid["h"], n_gl=16, quadrature=quadrature),
        window=window, cache_dir=cache_dir, device=device, dtype=dtype, quadform="plain")


def _provider(cfg, tc, fid):
    return SolverEmulatorProvider.load(
        cfg=cfg, zeff=tc["zeff"], da_fid=lcdm_da(om_fid(fid), tc["zeff"]),
        h_fid=lcdm_hubble(om_fid(fid), tc["zeff"]))


def build(spec: dict, workdir, cache_dir, device, dtype=torch.float64, quadrature="by_dtype",
          **narrow):
    """The reference model of ``spec`` (the configuration's ``flagship``
    block) over the files in ``workdir``.  ``quadrature`` is the AP µ
    quadrature: "by_dtype" (float32 16 Gauss–Legendre nodes, float64 the
    200-point trapezoid) or "gauss_legendre" (16 nodes in every dtype)."""
    workdir = Path(workdir)
    fid, tracers = spec["fiducial"], spec["tracers"]
    specs, providers = {}, {}
    for name, tc in tracers.items():
        pipe = _pipeline(name, tc, spec, workdir, cache_dir, device, dtype, quadrature,
                         **narrow)
        providers[name] = _provider(pipe.cfg, tc, fid)
        specs[name] = TracerSpec(
            pipeline=pipe, basis=WestCoastBasis(prefix=f"{name}_"),
            data=dict(path=workdir / f"data_{name}.txt", ls=tc["ls"], kmin=tc["kmin"],
                      kmax=tc["kmax"]),
            with_binning=True)
    marg = {f"{name}_": spec["marg"] for name in tracers}
    like = EFTLikelihood(tracers=specs, cov=workdir / "cov.txt", marg=marg)
    fixed = {k: v for k, v in fid.items() if k not in spec["cosmo_names"]}
    return FlagshipReference(
        like=like, providers=providers,
        param_names=spec["cosmo_names"] + [f"{n}_{b}" for n in tracers for b in BIAS_NAMES],
        fiducial=fixed, dtype=dtype, device=torch.device(device))


def theta0(spec: dict) -> np.ndarray:
    fid, tracers = spec["fiducial"], spec["tracers"]
    return np.array([fid[p] for p in spec["cosmo_names"]]
                    + [tracers[n][b] for n in tracers for b in BIAS_NAMES])


def write_inputs(spec: dict, workdir, cache_dir, device, **narrow) -> None:
    """Masks, mock data at the fiducial point (float64) and the Gaussian
    covariance (volume 4 (Gpc/h)^3, shot noise 1/nd) into ``workdir``, with
    the meta file that tells the program's builder the data are current."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    fid, tracers = spec["fiducial"], spec["tracers"]
    for name, tc in tracers.items():
        synthetic_mask_file(workdir / f"mask_{name}.txt", tc["smask"])
    kout = np.arange(0.01, 0.2049, 0.005)
    blocks = []
    for name, tc in tracers.items():
        pipe = _pipeline(name, tc, spec, workdir, cache_dir, device, torch.float64, **narrow)
        prov = _provider(pipe.cfg, tc, fid)
        params = dict(fid, **{f"{name}_{b}": tc[b] for b in BIAS_NAMES})
        tp = {k: torch.full((1,), float(v), dtype=torch.float64, device=pipe.device)
              for k, v in params.items()}
        binning = pipe.binning_tables(kout)
        with torch.no_grad():
            bird = pipe.compute_bird(prov.inputs(tp))
            _, _, product = pipe.product(bird, chained=False, binning=binning)
            plk = WestCoastBasis(prefix=f"{name}_").reduce_plk(pipe.cfg, product, tp).sum()[0]
        plk = plk.cpu().numpy()
        np.savetxt(workdir / f"data_{name}.txt",
                   np.column_stack([kout] + [plk[l // 2] for l in tc["ls"]]),
                   header="k " + " ".join(f"P{l}" for l in tc["ls"]))
        kedges = np.concatenate([binning["binmin"], binning["binmax"][-1:]])
        mp = Multipole(p0=plk[0] + 1.0 / tc["nd"], p2=plk[1],
                       p4=plk[2] if len(tc["ls"]) > 2 else None)
        blocks.append(GaussianCovariance(kedges, volume=4.0)(tc["ls"], tc["ls"], "aa->aaaa", mp))
    np.savetxt(workdir / "cov.txt", block_diag(*blocks))
    (workdir / "flagship_meta.json").write_text(json.dumps(spec["meta"]))
