"""MCMC driver: blocked sampling with checkpoint/resume and convergence
stopping (counterpart of ``eftpipe_tpu/parallel/mcmc.py``).

Each block of steps runs on the device (parallel/sampler.py or
parallel/hmc.py); the host sees the thinned chain once per block, computes
split-R̂ over walkers (diagnostics.py), checkpoints atomically, and stops
when R−1 drops below the requested threshold.

The checkpoint ``<out>.checkpoint.npz`` holds the JAX driver's arrays under
the JAX driver's names (``walkers``, ``chain``, ``logps``, ``nsteps_done``,
``hmc_eps``, ``hmc_inv_mass``), with ``generator_state`` (the state of the
driver's ``torch.Generator``) in place of the JAX ``key``.  A checkpoint the
JAX driver wrote resumes too (``convert.py::driver_state_from_numpy``).

Chain output is getdist-compatible: ``<prefix>.1.txt`` with columns
``weight  -logpost  <params...>  <derived...>``, a ``<prefix>.paramnames``
sidecar and ``<prefix>.params.json`` — the JAX driver's files.

With ``mesh=`` (:func:`.mesh.walker_mesh`) the walkers live on the mesh's
device, every rank runs the same chain (the samplers split only the
evaluations), only rank 0 writes the checkpoint and the chain files, and
every rank resumes from the same checkpoint, so a resumed run on N ranks
equals the one-process resume.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .diagnostics import gelman_rubin, integrated_autocorr_time
from .sampler import EnsembleSampler, init_walkers

logger = logging.getLogger("eftpipe_tpu_torch.mcmc")

_DERIVED_CHUNK = 1024


def _atomic_savez(path: Path, **arrays) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    index = lambda d: (torch.cuda.current_device() if d.index is None else d.index) \
        if d.type == "cuda" else d.index
    return a.type == b.type and index(a) == index(b)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclass
class MCMCResult:
    chain: np.ndarray        # (nsteps, nwalkers, ndim) thinned
    logps: np.ndarray        # (nsteps, nwalkers)
    rminus1: np.ndarray      # per-parameter R̂ − 1 at the end
    accept_rate: float
    converged: bool
    tau: np.ndarray | None = None

    def flat(self, burn_frac: float = 0.3) -> np.ndarray:
        start = int(burn_frac * self.chain.shape[0])
        return self.chain[start:].reshape(-1, self.chain.shape[-1])


@dataclass(eq=False)
class HMCSamplerAdapter:
    """EnsembleSampler-shaped facade over :class:`.hmc.HMC`: ``init(gen,
    center)`` and ``run(gen, walkers, nsteps, thin) -> (chain, logps,
    accept)``, so the blocked checkpoint/R̂ machinery is sampler-agnostic.
    Warmup runs once, before the first block; the tuned ``(eps, inv_mass)``
    ride the driver checkpoint so a resumed run skips re-adaptation."""

    logp: Callable
    nwalkers: int
    ndim: int
    n_leapfrog: int = 16
    target_accept: float = 0.8
    warmup_steps: int = 300
    eps0: float = 0.01
    inv_mass0: np.ndarray | None = None
    mesh: object | None = None

    def __post_init__(self):
        from .hmc import HMC

        self.hmc = HMC(logp=self.logp, ndim=self.ndim, n_leapfrog=self.n_leapfrog,
                       target_accept=self.target_accept, mesh=self.mesh)
        self.eps = None
        self.inv_mass = None

    def init(self, gen: torch.Generator, center, scale: float = 1e-3):
        return init_walkers(gen, center, self.nwalkers, scale)

    def run(self, gen: torch.Generator, x0, nsteps: int, thin: int = 1):
        from .hmc import HMCState

        if self.eps is None:
            inv0 = None if self.inv_mass0 is None else torch.as_tensor(
                self.inv_mass0, dtype=x0.dtype, device=x0.device)
            state, self.eps, self.inv_mass, _ = self.hmc.warmup(
                gen, x0, self.warmup_steps, self.eps0, inv_mass0=inv0)
            x0 = state.q
        lp, grad = self.hmc._lpg(x0)
        return self.hmc.run(gen, HMCState(q=x0, logp=lp, grad=grad), self.eps,
                            self.inv_mass, nsteps, thin)

    # -- checkpointable adaptation state ------------------------------------
    def state_arrays(self) -> dict:
        if self.eps is None:
            return {}
        return {"hmc_eps": _host(self.eps), "hmc_inv_mass": _host(self.inv_mass)}

    def restore_state(self, state) -> None:
        if "hmc_eps" in state:
            self.eps = torch.as_tensor(state["hmc_eps"])
            self.inv_mass = torch.as_tensor(state["hmc_inv_mass"])


@dataclass
class MCMCDriver:
    """Blocked MCMC with convergence stopping and resume.

    Parameters
    ----------
    logp : batched log-posterior ``thetas (W, ndim) -> (W,)`` (for HMC,
        differentiable)
    ndim : parameter dimension
    nwalkers : ensemble size (even)
    rhat_tol : stop when max-over-params (R̂ − 1) < rhat_tol
    block : steps per block (the host sees the chain between blocks)
    out : optional output prefix; enables checkpointing + chain files
    param_names : column names for the chain files
    derived_fn : optional ``theta_batch (n, ndim) -> (n, nderived)``
        evaluated on the final chain and written beside it
    device : where the walkers live; the card unless ``"cpu"`` is asked for
        (with a mesh: the mesh's device)
    mesh : a :class:`.mesh.WalkerMesh` over which the samplers split their
        evaluations (``nwalkers`` a multiple of twice its size)
    """

    logp: Callable
    ndim: int
    nwalkers: int = 256
    a: float = 2.0
    chunk_size: int | None = None
    rhat_tol: float = 0.01
    block: int = 100
    thin: int = 1
    burn_frac: float = 0.5
    out: str | os.PathLike | None = None
    param_names: list[str] | None = None
    derived_names: list[str] | None = None
    derived_fn: Callable | None = None
    min_blocks_before_check: int = 2
    mesh: object | None = None       # .mesh.WalkerMesh: split the walker axis
    sampler_kind: str = "stretch"    # "stretch" | "hmc"
    # HMC-only knobs (sampler_kind="hmc"); inv_mass0 seeds the warmup metric
    # with a known posterior scale (the diagonal of a Laplace covariance)
    n_leapfrog: int = 16
    target_accept: float = 0.8
    warmup_steps: int = 300
    inv_mass0: np.ndarray | None = None
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.mesh is None:
            self.device = resolve_device(self.device)
        elif self.device is not None and not _same_device(self.device, self.mesh.device):
            raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
        else:
            self.device = self.mesh.device
        self._writes = self.mesh is None or self.mesh.rank == 0
        if self.sampler_kind == "stretch":
            self.sampler = EnsembleSampler(
                logp=self.logp, nwalkers=self.nwalkers, ndim=self.ndim,
                a=self.a, chunk_size=self.chunk_size, mesh=self.mesh)
        elif self.sampler_kind == "hmc":
            self.sampler = HMCSamplerAdapter(
                logp=self.logp, nwalkers=self.nwalkers, ndim=self.ndim,
                n_leapfrog=self.n_leapfrog, target_accept=self.target_accept,
                warmup_steps=self.warmup_steps, inv_mass0=self.inv_mass0, mesh=self.mesh)
        else:
            raise ValueError(f"unknown sampler_kind {self.sampler_kind!r} (stretch | hmc)")
        self._ckpt = Path(str(self.out) + ".checkpoint.npz") if self.out else None

    # -- persistence ------------------------------------------------------
    def _save_state(self, gen, walkers, chain_blocks, logp_blocks, nsteps_done):
        if self._ckpt is None or not self._writes:
            return
        self._ckpt.parent.mkdir(parents=True, exist_ok=True)
        extra = self.sampler.state_arrays() if hasattr(self.sampler, "state_arrays") else {}
        _atomic_savez(
            self._ckpt,
            generator_state=gen.get_state().numpy(),
            walkers=_host(walkers),
            chain=(np.concatenate(chain_blocks) if chain_blocks
                   else np.zeros((0, self.nwalkers, self.ndim))),
            logps=(np.concatenate(logp_blocks) if logp_blocks
                   else np.zeros((0, self.nwalkers))),
            nsteps_done=nsteps_done,
            **extra,
        )

    def _load_state(self):
        if self._ckpt is None or not self._ckpt.exists():
            return None
        from ..convert import driver_state_from_numpy

        with np.load(self._ckpt) as z:
            state = driver_state_from_numpy(z)
        if hasattr(self.sampler, "restore_state"):
            self.sampler.restore_state(state)
        return state

    def write_chains(self, result: MCMCResult, derived: np.ndarray | None = None):
        """getdist/Cobaya-style ``<out>.1.txt`` + ``<out>.paramnames``."""
        if self.out is None:
            raise ValueError("no output prefix configured")
        prefix = Path(self.out)
        prefix.parent.mkdir(parents=True, exist_ok=True)
        names = self.param_names or [f"p{i}" for i in range(self.ndim)]
        dnames = list(self.derived_names or [])
        with open(f"{prefix}.paramnames", "w") as f:
            for n in names + [d + "*" for d in dnames]:
                f.write(f"{n}\t{n}\n")
        flat = result.chain.reshape(-1, self.ndim)
        lp = result.logps.reshape(-1)
        cols = [np.ones_like(lp), -lp, *flat.T]
        if derived is not None:
            cols.extend(np.asarray(derived).reshape(-1, len(dnames)).T)
        np.savetxt(f"{prefix}.1.txt", np.column_stack(cols))
        meta = dict(ndim=self.ndim, nwalkers=self.nwalkers, thin=self.thin,
                    param_names=names, derived_names=dnames)
        with open(f"{prefix}.params.json", "w") as f:
            json.dump(meta, f, indent=1)

    def _derived(self, chain: np.ndarray) -> np.ndarray:
        flat = chain.reshape(-1, self.ndim)
        with torch.no_grad():
            parts = [_host(self.derived_fn(torch.as_tensor(flat[i:i + _DERIVED_CHUNK],
                                                           device=self.device)))
                     for i in range(0, flat.shape[0], _DERIVED_CHUNK)]
        return np.concatenate(parts)

    # -- main loop ----------------------------------------------------------
    def run(
        self,
        seed: int | torch.Generator = 0,
        x0=None,
        max_steps: int = 10_000,
        resume: bool = True,
        progress_fn: Callable | None = None,
    ) -> MCMCResult:
        """Sample until R̂ − 1 < ``rhat_tol`` or ``max_steps``.  ``seed`` is
        an int or a ``torch.Generator`` on the driver's device; ``x0`` a
        centre (ndim,) around which the walkers start, or the walkers
        (nwalkers, ndim) themselves; their dtype is the chain's."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))

        chain_blocks: list[np.ndarray] = []
        logp_blocks: list[np.ndarray] = []
        nsteps_done = 0
        walkers = None

        if resume and (state := self._load_state()) is not None:
            if "generator_state" in state:
                gen.set_state(torch.as_tensor(state["generator_state"]))
            else:
                gen.manual_seed(state["seed"])
                logger.info("resuming a checkpoint without a generator state (%s): "
                            "generator seeded with %d from its key",
                            self._ckpt, state["seed"])
            walkers = torch.as_tensor(state["walkers"], device=self.device)
            chain_blocks = state["chain"]
            logp_blocks = state["logps"]
            nsteps_done = state["nsteps_done"]

        if walkers is None:
            if x0 is None:
                raise ValueError("x0 required for a fresh run")
            x0 = torch.as_tensor(x0, device=self.device)
            walkers = self.sampler.init(gen, x0) if x0.dim() == 1 else x0

        converged = False
        rminus1 = np.full(self.ndim, np.inf)
        accepts = []
        blocks_run = len(chain_blocks)
        while nsteps_done < max_steps:
            block_t0 = time.perf_counter()
            nsteps = min(self.block, max_steps - nsteps_done)
            chain_t, chain_logp_t, acc_t = self.sampler.run(gen, walkers, nsteps, thin=self.thin)
            walkers = chain_t[-1]
            # the one read of the block's results back to the host
            chain, chain_logp, acc = _host(chain_t), _host(chain_logp_t), float(acc_t)
            chain_blocks.append(chain)
            logp_blocks.append(chain_logp)
            accepts.append(acc)
            nsteps_done += nsteps
            blocks_run += 1

            full = np.concatenate(chain_blocks)
            if blocks_run >= self.min_blocks_before_check:
                rminus1 = gelman_rubin(full, burn_frac=self.burn_frac) - 1.0
            self._save_state(gen, walkers, chain_blocks, logp_blocks, nsteps_done)
            seconds = time.perf_counter() - block_t0
            logger.info(
                "block %d: steps=%d/%d max(R^-1)=%.4g accept=%.3f (%.1fs, %.1f evals/s)",
                blocks_run, nsteps_done, max_steps, float(np.max(rminus1)), acc,
                seconds, nsteps * self.nwalkers / max(seconds, 1e-9))
            if progress_fn is not None:
                progress_fn(nsteps_done, float(np.max(rminus1)), acc)
            if np.max(rminus1) < self.rhat_tol:
                converged = True
                break

        chain = np.concatenate(chain_blocks)
        logps = np.concatenate(logp_blocks)
        if not np.all(np.isfinite(rminus1)) and chain.shape[0] >= 4:
            # resumed with no new blocks: diagnose the stored chain
            rminus1 = gelman_rubin(chain, burn_frac=self.burn_frac) - 1.0
            converged = bool(np.max(rminus1) < self.rhat_tol)
        tau = None
        if chain.shape[0] >= 50:
            tau = integrated_autocorr_time(chain, burn_frac=self.burn_frac)
        result = MCMCResult(
            chain=chain, logps=logps, rminus1=rminus1,
            accept_rate=float(np.mean(accepts)) if accepts else float("nan"),
            converged=converged, tau=tau)
        if self.out is not None and self._writes:
            derived = self._derived(chain) if self.derived_fn is not None else None
            self.write_chains(result, derived)
        if self.mesh is not None:
            self.mesh.barrier()  # every rank returns after rank 0's files are written
        return result
