"""The three-tracer eBOSS analysis (LRG, ELG chained, and their cross X),
built from the reference's own pieces and the configuration's numbers.

It reads the configuration's ``analysis`` block, the same block the
program's config-driven builder is given (its paths relative to the work
directory), and interprets the part of the schema that block uses: tracers
with ``z``, ``nd``, ``ls``, ``cross``, a survey window, IR resummation and AP
at the fiducial background, the solver-emulator cosmology, a ``default``
block under every tracer; sampled parameters with uniform
priors, fixed numbers and lambda strings; one likelihood block with its
data, covariance, chained tracers, marginalised parameters and the Jeffreys
prior.  ``write_inputs`` writes the masks, the mock data at the reference
point and the covariance.
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from scipy.linalg import block_diag

from .boltzmann.emulator import SolverEmulatorProvider
from .flagship import synthetic_mask_file
from .likelihood.covariance import GaussianCovariance, Multipole
from .likelihood.likelihood import EFTLikelihood, TracerSpec
from .likelihood.parambasis import WestCoastBasis
from .models.ap import lcdm_da, lcdm_hubble
from .models.config import EFTConfig
from .models.pipeline import TracerPipeline
from .utils.safe_expr import safe_eval_expr

KOUT = np.round(np.arange(0.01, 0.2049, 0.005), 6)


def _tracers(spec: dict) -> dict:
    """Each tracer's block with the ``default`` block under it."""
    tracers = dict(spec["theory"]["tracers"])
    default = tracers.pop("default")
    return {name: {**default, **tc} for name, tc in tracers.items()}


def _tracer_ls(spec: dict) -> dict:
    """Internal multipoles of each tracer: its own ``ls``, raised to the
    data's ℓmax + 2 for a chained tracer."""
    like = spec["likelihood"]
    out = {}
    for name, tc in _tracers(spec).items():
        ls = list(tc["ls"])
        if name in like["data"]:
            need = max(like["data"][name]["ls"]) + (2 if like["chained"].get(name) else 0)
            if need > max(ls):
                ls = list(range(0, need + 1, 2))
        out[name] = ls
    return out


def _pipelines(spec: dict, workdir: Path, cache_dir, device, dtype, narrow: dict,
               quadrature: str = "by_dtype"):
    tracers = _tracers(spec)
    pipes, providers, bases = {}, {}, {}
    for name, ls in _tracer_ls(spec).items():
        tc = tracers[name]
        nl = max(ls) // 2 + 1
        if tc.get("cross"):
            a, b = (tracers[p] for p in tc["cross"])
            nd = dict(km_a=0.7, kr_a=0.25, nd_a=a["nd"], km_b=0.7, kr_b=0.25, nd_b=b["nd"])
            basis = WestCoastBasis(prefix=f"{name}_", cross_prefix=[f"{p}_" for p in tc["cross"]])
        else:
            nd = dict(km_a=0.7, kr_a=0.25, nd_a=tc["nd"])
            basis = WestCoastBasis(prefix=f"{name}_")
        cfg = EFTConfig(nl=max(nl, 2), no=nl, **nd, **narrow)
        ap, om = tc["with_APeffect"], tc["boltzmann"]["om_fid"]
        pipes[name] = TracerPipeline.build(
            cfg, zeff=tc["z"], with_irresum=True,
            apeffect=dict(om_ap=ap["Om_AP"], rdrag_ap=ap["rdrag_AP"], hubble_ap=ap["h_AP"],
                          z_ap=tc["z"], quadrature=quadrature),
            window=dict(window_configspace_file=workdir / tc["with_window"]["window_configspace_file"],
                        nmax=tc["with_window"]["Nmax"]),
            cache_dir=cache_dir, device=device, dtype=dtype, quadform="plain")
        providers[name] = SolverEmulatorProvider.load(
            cfg=cfg, zeff=tc["z"], da_fid=lcdm_da(om, tc["z"]), h_fid=lcdm_hubble(om, tc["z"]))
        bases[name] = basis
    return pipes, providers, bases


class Params:
    """Sampled (uniform priors), fixed and computed parameters."""

    def __init__(self, params: dict):
        self.sampled, self.fixed, self.computed = [], {}, {}
        self.lo, self.hi, self.ref = [], [], []
        for name, p in params.items():
            if isinstance(p, dict):
                self.sampled.append(name)
                self.lo.append(p["prior"]["min"])
                self.hi.append(p["prior"]["max"])
                self.ref.append(p["ref"])
            elif isinstance(p, str):
                fn = safe_eval_expr(p)
                self.computed[name] = (inspect.getfullargspec(fn).args, fn)
            else:
                self.fixed[name] = float(p)

    def to_dict(self, thetas) -> dict:
        nw = thetas.shape[0]
        out = {k: torch.full((nw,), v, dtype=thetas.dtype, device=thetas.device)
               for k, v in self.fixed.items()}
        for i, name in enumerate(self.sampled):
            out[name] = thetas[:, i]
        for name, (args, fn) in self.computed.items():
            out[name] = fn(*(out[a] for a in args))
        return out

    def log_prior(self, thetas):
        lo = torch.as_tensor(self.lo, dtype=thetas.dtype, device=thetas.device)
        hi = torch.as_tensor(self.hi, dtype=thetas.dtype, device=thetas.device)
        inside = ((thetas >= lo) & (thetas <= hi)).all(dim=-1)
        flat = -torch.log(hi - lo).sum()
        return torch.where(inside, flat, torch.full_like(thetas[:, 0], -math.inf))


@dataclass(eq=False)
class AnalysisReference:
    like: EFTLikelihood
    providers: dict
    params: Params
    dtype: torch.dtype
    device: torch.device

    def logp(self, thetas):
        thetas = torch.as_tensor(thetas, dtype=self.dtype, device=self.device)
        params = self.params.to_dict(thetas)
        lp = self.params.log_prior(thetas)
        for prov in self.providers.values():
            lp = lp + prov.validity_logp(params).to(self.dtype)
        inputs = {t: p.inputs(params) for t, p in self.providers.items()}
        res = self.like.logp(inputs, params)["logp"]
        return torch.where(torch.isfinite(lp), lp + res, torch.full_like(lp, -math.inf))


def build(spec: dict, workdir, cache_dir, device, dtype=torch.float64, quadrature="by_dtype",
          **narrow):
    """The reference of ``spec`` (the configuration's ``analysis`` block)
    over the files in ``workdir``; ``quadrature`` as in ``flagship.build``."""
    workdir = Path(workdir)
    pipes, providers, bases = _pipelines(spec, workdir, cache_dir, device, dtype, narrow,
                                         quadrature)
    like = spec["likelihood"]
    specs = {
        name: TracerSpec(
            pipeline=pipes[name], basis=bases[name],
            data=dict(like["data"][name], path=workdir / like["data"][name]["path"]),
            chained=bool(like["chained"].get(name)), with_binning=True)
        for name in like["tracers"]}
    lk = EFTLikelihood(tracers=specs, cov=workdir / like["cov"], marg=like["marg"],
                       jeffreys=like["jeffreys"])
    return AnalysisReference(like=lk, providers=providers, params=Params(spec["params"]),
                             dtype=dtype, device=torch.device(device))


def theta0(spec: dict) -> np.ndarray:
    return np.asarray(Params(spec["params"]).ref)


def write_inputs(spec: dict, masks: dict, workdir, cache_dir, device, **narrow) -> None:
    """Masks, the binned mock multipoles of each tracer at the reference
    point (float64) and their block-diagonal Gaussian covariance (volume 4
    (Gpc/h)^3, shot noise 1/nd, none for the cross) into ``workdir``."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tracers = _tracers(spec)
    for name, smask in masks.items():
        synthetic_mask_file(workdir / tracers[name]["with_window"]["window_configspace_file"],
                            smask)
    pipes, providers, bases = _pipelines(spec, workdir, cache_dir, device, torch.float64, narrow)
    space = Params(spec["params"])
    fid = space.to_dict(torch.as_tensor(theta0(spec), dtype=torch.float64,
                                        device=device)[None])
    like = spec["likelihood"]
    blocks = []
    for name in like["tracers"]:
        pipe = pipes[name]
        chained = bool(like["chained"].get(name))
        binning = pipe.binning_tables(KOUT)
        with torch.no_grad():
            bird = pipe.compute_bird(providers[name].inputs(fid))
            ls, _, product = pipe.product(bird, chained=chained, binning=binning)
            plk = bases[name].reduce_plk(pipe.cfg, product, fid).sum()[0].cpu().numpy()
        np.savetxt(workdir / like["data"][name]["path"],
                   np.column_stack([KOUT] + [plk[i] for i in range(len(ls))]),
                   header="k " + " ".join(f"P{l}" for l in ls))
        kedges = np.concatenate([KOUT - 0.0025, [KOUT[-1] + 0.0025]])
        nd = tracers[name].get("nd")
        shot = 1.0 / nd if nd else 0.0
        mp = Multipole(p0=plk[0] + shot + 1e3, p2=plk[1], p4=plk[2] if len(ls) > 2 else None)
        blocks.append(GaussianCovariance(kedges, volume=4.0)(ls, ls, "aa->aaaa", mp))
    np.savetxt(workdir / like["cov"], block_diag(*blocks))
