"""Affine-invariant ensemble MCMC, the Goodman & Weare stretch move
(counterpart of ``eftpipe_tpu/parallel/sampler.py``).

The walker axis is explicit: ``logp`` maps a (W, ndim) batch to (W,) — the
port's ``FlagshipModel.logp(thetas, chunk=)``; ``chunk_size`` is handed to it
as ``chunk=`` (the counterpart of ``mesh.py::chunked_vmap``).  Randomness
comes from an explicit ``torch.Generator`` on the walkers' device, and the
draws are kept apart from the update (:func:`stretch_draws` /
:func:`_half_update`) so that the update can be fed any draws.  A block of
steps stays on the device: nothing in :meth:`EnsembleSampler.run` reads a
value back to the host.

With ``mesh=`` (:func:`.mesh.walker_mesh`) the state stays whole and equal
on every rank, and so do the draws (every rank's generator has the same
seed); each rank evaluates ``logp`` on its block of the proposed half and
an ``all_gather`` rebuilds the half's values before the common accept step:
one collective of W/2 numbers a half-step, and the chain equals the
one-process chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def stretch_draws(gen: torch.Generator, n: int, n_other: int, like: torch.Tensor):
    """The random numbers of one half-ensemble update: the stretch uniform
    ``u`` (n,), the partner index ``j`` (n,) into the other half, and the
    acceptance uniform ``u_acc`` (n,), on ``like``'s device and dtype."""
    u = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    j = torch.randint(0, n_other, (n,), generator=gen, device=like.device)
    u_acc = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    return u, j, u_acc


def _half_update(logp_batched, active, active_logp, other, a: float, dim: int, u, j, u_acc):
    """Stretch-move update of one half of the ensemble with the given draws
    (``eftpipe_tpu/parallel/sampler.py:22-38``)."""
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partner = other[j]
    proposal = partner + z[:, None] * (active - partner)
    prop_logp = logp_batched(proposal)
    log_accept = (dim - 1.0) * torch.log(z) + prop_logp - active_logp
    # a NaN log-posterior compares False: the proposal is rejected
    accept = torch.log(u_acc) < log_accept
    new = torch.where(accept[:, None], proposal, active)
    new_logp = torch.where(accept, prop_logp, active_logp)
    return new, new_logp, accept


def stretch_step(gen: torch.Generator, logp_batched, walkers, logps, a: float = 2.0):
    """One full ensemble update; walkers (nw, d) with nw even."""
    nw, dim = walkers.shape
    half = nw // 2
    first, second = walkers[:half], walkers[half:]
    lp0, lp1 = logps[:half], logps[half:]
    first, lp0, acc0 = _half_update(logp_batched, first, lp0, second, a, dim,
                                    *stretch_draws(gen, half, nw - half, walkers))
    second, lp1, acc1 = _half_update(logp_batched, second, lp1, first, a, dim,
                                     *stretch_draws(gen, nw - half, half, walkers))
    return (torch.cat([first, second]), torch.cat([lp0, lp1]), torch.cat([acc0, acc1]))


def init_walkers(gen: torch.Generator, center, nwalkers: int, scale: float = 1e-3):
    """A ball of ``nwalkers`` around ``center`` (ndim,): relative width
    ``scale`` (absolute below |center| = 1)."""
    noise = torch.randn((nwalkers, center.shape[-1]), generator=gen, dtype=center.dtype,
                        device=center.device)
    return center[None, :] + scale * noise * torch.clamp(center.abs(), min=1.0)[None, :]


@dataclass(eq=False)
class EnsembleSampler:
    """Ensemble sampler over a batched log-posterior ``logp(thetas (W, d)) →
    (W,)``; ``mesh`` (a :class:`.mesh.WalkerMesh`) splits each evaluation
    over its ranks."""

    logp: Callable
    nwalkers: int
    ndim: int
    a: float = 2.0
    chunk_size: int | None = None
    mesh: object | None = None
    mesh_axis: str = "walkers"

    def __post_init__(self):
        if self.nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if self.mesh is not None and self.nwalkers % (2 * self.mesh.size):
            raise ValueError(
                f"nwalkers={self.nwalkers} must be a multiple of twice the mesh size "
                f"({self.mesh.size}) so each half-ensemble shards evenly")

    def _logp_local(self, thetas):
        if self.chunk_size is None:
            return self.logp(thetas)
        return self.logp(thetas, chunk=self.chunk_size)

    def _logp_batched(self, thetas):
        if self.mesh is None:
            return self._logp_local(thetas)
        return self.mesh.evaluate(self._logp_local, thetas)

    def init(self, gen: torch.Generator, center, scale: float = 1e-3):
        return init_walkers(gen, center, self.nwalkers, scale)

    @torch.no_grad()
    def run(self, gen: torch.Generator, x0, nsteps: int, thin: int = 1):
        """Run ``nsteps`` ensemble updates from walkers ``x0`` (nwalkers,
        ndim); returns (chain, logps, accept_rate) as tensors on ``x0``'s
        device, chain (ceil(nsteps / thin), nwalkers, ndim)."""
        walkers = x0
        lps = self._logp_batched(walkers)
        chain, chain_logp, acc = [], [], []
        for _ in range(nsteps):
            walkers, lps, accept = stretch_step(gen, self._logp_batched, walkers, lps, self.a)
            chain.append(walkers)
            chain_logp.append(lps)
            acc.append(accept.to(walkers.dtype).mean())
        return (torch.stack(chain[::thin]), torch.stack(chain_logp[::thin]),
                torch.stack(acc).mean())
