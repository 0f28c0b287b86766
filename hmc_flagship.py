#!/usr/bin/env python3
"""HMC on the default flagship posterior, on one NVIDIA GPU.

    python3 hmc_flagship.py                    # float32, then float64
    python3 hmc_flagship.py --dtype float32 --warmup 300 --steps 100 --chains 64
    python3 hmc_flagship.py --dtype float32 --priors gauss   # no hard walls on b2, b4

Builds the default flagship (``api/flagship.py::build_flagship``: two
tracers, survey window at nmax 2048, solver-emulator cosmology, its mock
data and covariance) and the same posterior as a config-driven
``Analysis`` over the flagship's own data files, with broad uniform priors
on the nine sampled parameters (``--priors gauss``: Gaussian priors
N(0, 2) on b2 and b4 in place of their uniform ones, whose walls the data
reach).  It checks that the two ``logp`` differ by the ``Analysis``'
log-prior alone (so that the config stays the flagship's posterior), then
runs ``Analysis.run_mcmc(sampler="hmc", init="laplace")``: the Laplace
covariance at the reference point seeds the dense warmup metric and
scatters the chains; the warmup (dual-averaged step size, windowed metric)
runs ``--warmup`` transitions, then ``--steps`` sampling transitions.  One
JSON line per dtype: acceptance during sampling, R−1 and the integrated
autocorrelation time (in transitions) per parameter, the adapted step size
and metric, the share of evaluated points outside the prior support,
seconds, gradients per second, and the card's ``nvidia-smi`` name and power
limit.  Exits non-zero when no card is present, the two ``logp`` disagree
or a chain is not finite.  Imports nothing but the port, torch and NumPy.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("hmc_flagship: no CUDA device (torch.cuda.is_available() is False)\n")
    sys.exit(2)

from eftpipe_tpu_torch.api.flagship import (BIAS_NAMES, COSMO_NAMES, FIDUCIAL, TRACERS,
                                            build_flagship)
from eftpipe_tpu_torch.api.orchestrate import Analysis
from eftpipe_tpu_torch.parallel.diagnostics import integrated_autocorr_time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, "chip_smoke_workdir", "hmc_flagship")
# the flagship's marginalised parameters and their Gaussian priors
MARG = {"b3": 2.0, "cct": 4.0, "cr1": 8.0, "cr2": 4.0, "ce0": 4.0, "cequad": 2.0}
PRIORS = {"omega_cdm": (0.09, 0.15), "h": (0.55, 0.80), "ln10As": (2.5, 3.5),
          "b1": (0.5, 4.0), "b2": (-4.0, 4.0), "b4": (-4.0, 4.0)}
GAUSS_PRIORS = {"b2": (0.0, 2.0), "b4": (0.0, 2.0)}   # --priors gauss: (loc, scale)
# |an.logp − flagship logp − an.log_prior| allowed on the check points
LOGP_MATCH = {torch.float32: 1e-3, torch.float64: 1e-9}


def flagship_config(workdir: str, theta0: np.ndarray, names: list,
                    priors: str = "uniform") -> dict:
    """The default flagship's posterior as an ``Analysis`` config over the
    files ``build_flagship(workdir)`` wrote, with uniform priors (or, under
    ``priors="gauss"``, Gaussian ones on b2 and b4)."""
    om_fid = (FIDUCIAL["omega_b"] + FIDUCIAL["omega_cdm"]) / FIDUCIAL["h"] ** 2
    tracers = {}
    for name, tc in TRACERS.items():
        tracers[name] = {
            "z": tc["zeff"], "nd": tc["nd"], "ls": tc["ls"], "with_IRresum": True,
            "with_APeffect": {"Om_AP": om_fid, "z_AP": tc["zeff"], "rdrag_AP": 147.66,
                              "h_AP": FIDUCIAL["h"]},
            "with_window": {"window_configspace_file": os.path.join(workdir, f"mask_{name}.txt"),
                            "Nmax": 2048},
            "boltzmann": {"name": "solver_emulator", "om_fid": om_fid}}
    params = {"omega_b": FIDUCIAL["omega_b"], "ns": FIDUCIAL["ns"]}
    for name, ref in zip(names, theta0):
        key = name.split("_")[-1] if name not in PRIORS else name
        if priors == "gauss" and key in GAUSS_PRIORS:
            loc, scale = GAUSS_PRIORS[key]
            prior = {"dist": "norm", "loc": loc, "scale": scale}
        else:
            lo, hi = PRIORS[key]
            prior = {"min": lo, "max": hi}
        params[name] = {"prior": prior, "ref": float(ref)}
    return {
        "theory": {"cache_dir": os.path.join(workdir, "cache"), "tracers": tracers},
        "likelihood": {
            "tracers": list(TRACERS), "cov": os.path.join(workdir, "cov.txt"), "binned": True,
            "data": {n: {"path": os.path.join(workdir, f"data_{n}.txt"), "ls": tc["ls"],
                         "kmin": tc["kmin"], "kmax": tc["kmax"]} for n, tc in TRACERS.items()},
            "marg": {f"{n}_": {k: {"loc": 0.0, "scale": v} for k, v in MARG.items()}
                     for n in TRACERS}},
        "params": params,
    }


def run(dtype, warmup: int, steps: int, chains: int, seed: int, priors: str) -> dict:
    model = build_flagship(WORKDIR, dtype=dtype)
    names = list(model.param_names)
    assert names == COSMO_NAMES + [f"{n}_{b}" for n in TRACERS for b in BIAS_NAMES]
    an = Analysis.from_config(flagship_config(WORKDIR, model.theta0, names, priors), dtype=dtype)
    assert an.space.sampled == names
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(model.theta0[None, :] * (1 + 1e-3 * rng.standard_normal((16, 9))),
                          dtype=dtype, device="cuda")
    with torch.no_grad():
        diff = (an.logp(pts) - model.logp(pts)).double().cpu().numpy()
        mismatch = float(np.abs(diff - an.space.log_prior(pts).double().cpu().numpy()).max())
    if not mismatch < LOGP_MATCH[dtype]:
        raise SystemExit(f"hmc_flagship: the config's logp is not the flagship's plus its "
                         f"log-prior ({mismatch} >= {LOGP_MATCH[dtype]})")
    t0 = time.perf_counter()
    cov = an.laplace_cov()
    laplace_s = time.perf_counter() - t0
    calls = {"n": 0}
    outside = torch.zeros((), dtype=torch.int64, device="cuda")  # read once, at the end
    logp = an.logp

    def counted(x, chunk=None):
        calls["n"] += 1
        v = logp(x, chunk)
        outside.add_((~torch.isfinite(v.detach())).sum())
        return v

    an.logp = counted
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = an.run_mcmc(nwalkers=chains, out=os.path.join(tmp, "hmc"), max_steps=steps,
                          block=steps, rhat_tol=-1.0, key=seed, sampler="hmc", init="laplace",
                          warmup_steps=warmup, with_derived=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with np.load(os.path.join(tmp, "hmc.checkpoint.npz")) as ck:  # the adapted (eps, metric)
            eps, inv_mass = float(np.mean(ck["hmc_eps"])), np.asarray(ck["hmc_inv_mass"])
    del an.logp
    finite = bool(np.isfinite(res.logps).all() and np.isfinite(res.chain).all())
    metric_sigma = np.sqrt(np.diag(inv_mass) if inv_mass.ndim == 2 else inv_mass)
    return dict(
        phase="hmc_flagship", dtype=str(dtype).replace("torch.", ""), priors=priors,
        chains=chains, warmup_steps=warmup, steps=steps, n_leapfrog=16, seed=seed,
        logp_minus_flagship=dict(min=float(diff.min()), max=float(diff.max())),
        logp_minus_flagship_minus_prior_max=mismatch,
        laplace_sigma=np.sqrt(np.diag(cov)).tolist(), laplace_seconds=laplace_s,
        accept_rate=float(res.accept_rate), rminus1=np.asarray(res.rminus1).tolist(),
        max_rminus1=float(np.max(res.rminus1)), converged_at_0_01=bool(np.max(res.rminus1) < 0.01),
        tau_transitions=integrated_autocorr_time(res.chain).tolist(),
        step_size=eps, metric_sigma=metric_sigma.tolist(),
        outside_support_share=float(outside) / (chains * calls["n"]),
        chain_shape=list(res.chain.shape), all_finite=finite,
        posterior_mean=res.chain[steps // 2:].reshape(-1, 9).mean(axis=0).tolist(),
        posterior_std=res.chain[steps // 2:].reshape(-1, 9).std(axis=0).tolist(),
        seconds=seconds, logp_calls=calls["n"], grads_per_s=chains * calls["n"] / seconds)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("float32", "float64", "both"), default="both")
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--priors", choices=("uniform", "gauss"), default="uniform")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dtypes = ("float32", "float64") if args.dtype == "both" else (args.dtype,)
    ok = True
    for name in dtypes:
        line = run(getattr(torch, name), args.warmup, args.steps, args.chains, args.seed,
                   args.priors)
        line["nvidia_smi"] = smi
        print(json.dumps(line), flush=True)
        ok = ok and line["all_finite"]
    print(smi)
    if not ok:
        raise SystemExit("hmc_flagship: a chain is not finite")


if __name__ == "__main__":
    main()
