"""Hamiltonian Monte Carlo with warmup adaptation (counterpart of
``eftpipe_tpu/parallel/hmc.py``).

Many chains run as one batch: ``logp`` maps a (nchains, ndim) batch to
(nchains,) — the port's ``FlagshipModel.logp`` — and one batched forward plus
one backward (:meth:`HMC._lpg`) takes the place of the JAX package's
``jax.vmap(jax.value_and_grad(logp))``; the chains are independent, so the
gradient of the summed log-posterior is each chain's own.  Leapfrog
integration, dual-averaging step-size adaptation to a target acceptance rate
and diagonal or dense metric estimation during warmup are the JAX module's.

Randomness: the momenta, the step-size jitter and the acceptance uniforms are
drawn on the chains' device from an explicit ``torch.Generator``; the
randomised trajectory length L ~ U{⌈L/2⌉..L} (shared by the chains, as in
JAX) is drawn on the host, from a NumPy generator seeded with the state of
that ``torch.Generator`` at the start of each phase or block (a CUDA
generator's state lives on the host), so that the Python leapfrog loop never
waits for the device.  The draws are kept apart from the update
(:meth:`HMC.draws` / :func:`_transition`) so that the update can be fed any
draws.

With ``mesh=`` (:func:`.mesh.walker_mesh`) every rank holds all chains and
draws the same numbers; each evaluates ``logp`` and its gradient on its
block of the chains, and one ``all_gather`` of the values and one of the
(chains, ndim) gradients rebuild the batch, so that every rank takes the
same leapfrog, accept and warmup steps (the warmup's cross-chain statistics
need no collective of their own) and the chains equal the one-process
chains.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch


class HMCState(NamedTuple):
    q: torch.Tensor          # (nchains, ndim) positions
    logp: torch.Tensor       # (nchains,)
    grad: torch.Tensor       # (nchains, ndim)


class DAState(NamedTuple):
    """Dual-averaging state (Hoffman & Gelman 2014, Algorithm 5)."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor


class HMCDraws(NamedTuple):
    """The random numbers of one transition."""

    z: torch.Tensor          # (nchains, ndim) standard normal → momenta
    u: torch.Tensor          # (nchains, 1) step-size jitter in [1 − j, 1 + j]
    n_steps: int             # leapfrog steps (host)
    u_acc: torch.Tensor      # (nchains,) acceptance uniforms


def _mass_ops(inv_mass):
    """Kinetic-energy operators for a diagonal ``(ndim,)`` or dense
    ``(ndim, ndim)`` inverse mass matrix (= the metric ≈ posterior
    covariance).  Momenta are p ~ N(0, Σ⁻¹): with Σ = LLᵀ, p = L⁻ᵀz gives
    cov(p) = Σ⁻¹ without forming the inverse.

    Returns ``(sample_p, velocity, kinetic)`` acting on (nchains, ndim)."""
    if inv_mass.dim() == 1:
        sigma = torch.sqrt(1.0 / inv_mass)

        def sample_p(z):
            return z * sigma

        def velocity(p):
            return inv_mass * p

        def kinetic(p):
            return 0.5 * torch.sum(inv_mass * p * p, dim=-1)

    else:
        # Σ = L Lᵀ; the _ex form does not read its status back to the host
        chol = torch.linalg.cholesky_ex(inv_mass).L

        def sample_p(z):
            # solve Lᵀ p = z per chain: p = L⁻ᵀ z
            return torch.linalg.solve_triangular(chol.T, z.T, upper=True).T

        def velocity(p):
            return p @ inv_mass  # Σ symmetric

        def kinetic(p):
            return 0.5 * torch.sum(p * (p @ inv_mass), dim=-1)

    return sample_p, velocity, kinetic


def _leapfrog(lpg, q, p, grad, eps, velocity, n_steps: int):
    """``n_steps`` leapfrog updates; eps may be per-chain (nchains, 1).
    Returns (q, p, grad, logp) at the end point (the log-posterior comes
    with the last gradient)."""
    logp = None
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad
        q = q + eps * velocity(p)
        logp, grad = lpg(q)
        p = p + 0.5 * eps * grad
    return q, p, grad, logp


def _transition(lpg, state: HMCState, eps, mass_ops, draws: HMCDraws):
    """One HMC transition with the given draws; returns (new state,
    acceptance probability (nchains,))."""
    sample_p, velocity, kinetic = mass_ops
    p0 = sample_p(draws.z)
    eps_c = eps * draws.u
    q, p, grad_new, logp_new = _leapfrog(lpg, state.q, p0, state.grad, eps_c, velocity,
                                         draws.n_steps)
    log_alpha = (logp_new - kinetic(p)) - (state.logp - kinetic(p0))
    # a divergent trajectory (NaN energy) is rejected, not propagated
    log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
    accept_prob = torch.clamp(torch.exp(log_alpha), max=1.0)
    accept = torch.log(draws.u_acc) < log_alpha
    new = HMCState(
        q=torch.where(accept[:, None], q, state.q),
        logp=torch.where(accept, logp_new, state.logp),
        grad=torch.where(accept[:, None], grad_new, state.grad),
    )
    return new, accept_prob


def _host_rng(gen: torch.Generator) -> np.random.Generator:
    """A NumPy generator seeded with the current state of ``gen`` (read on
    the host, no device access)."""
    return np.random.default_rng(gen.get_state().numpy())


@dataclass(eq=False)
class HMC:
    """Fixed-path-length HMC over a batch of chains.

    Parameters
    ----------
    logp : batched log-posterior (nchains, ndim) → (nchains,), differentiable
    n_leapfrog : leapfrog steps per proposal (the upper end of the randomised
        trajectory length)
    target_accept : dual-averaging target during warmup
    mesh : a :class:`.mesh.WalkerMesh` splitting each evaluation over its
        ranks (the number of chains a multiple of its size)
    """

    logp: Callable
    ndim: int
    n_leapfrog: int = 16
    target_accept: float = 0.8
    jitter: float = 0.1  # uniform step-size jitter to decorrelate paths
    mesh: object | None = None
    mesh_axis: str = "walkers"

    def _lpg(self, q):
        """(logp (nchains,), ∇logp (nchains, ndim)) of a batch: one forward
        and one backward (on the mesh: of this rank's block, gathered).  The
        value is pinned to the chain dtype (a posterior that works in
        another dtype would otherwise promote the acceptance and
        dual-averaging arithmetic)."""
        if self.mesh is not None:
            return self.mesh.evaluate(self._lpg_local, q)
        return self._lpg_local(q)

    def _lpg_local(self, q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            v = self.logp(x)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach().to(q.dtype), g

    # -- draws --------------------------------------------------------------
    def lengths(self, gen: torch.Generator, n: int) -> np.ndarray:
        """``n`` randomised trajectory lengths L ~ U{⌈L/2⌉..L} (Neal 2011
        §5.4: spreads the rotation angles of the proposals), drawn on the
        host from the state of ``gen``."""
        n_lo = max(1, (self.n_leapfrog + 1) // 2)
        return _host_rng(gen).integers(n_lo, self.n_leapfrog + 1, size=n)

    def draws(self, gen: torch.Generator, q, n_steps: int) -> HMCDraws:
        nchains = q.shape[0]
        kw = dict(generator=gen, dtype=q.dtype, device=q.device)
        z = torch.randn(q.shape, **kw)
        u = (1.0 - self.jitter) + (2.0 * self.jitter) * torch.rand((nchains, 1), **kw)
        u_acc = torch.rand((nchains,), **kw)
        return HMCDraws(z=z, u=u, n_steps=int(n_steps), u_acc=u_acc)

    def _transition(self, gen, state: HMCState, eps, mass_ops, n_steps: int):
        return _transition(self._lpg, state, eps, mass_ops, self.draws(gen, state.q, n_steps))

    # -- dual averaging -------------------------------------------------------
    def _da_init(self, eps0):
        return DAState(log_eps=torch.log(eps0), log_eps_avg=torch.log(eps0),
                       h_avg=torch.zeros_like(eps0), t=torch.zeros_like(eps0))

    def _da_update(self, da: DAState, accept_prob, mu):
        gamma, t0, kappa = 0.05, 10.0, 0.75
        t = da.t + 1.0
        h = torch.mean(self.target_accept - accept_prob)
        h_avg = (1.0 - 1.0 / (t + t0)) * da.h_avg + h / (t + t0)
        log_eps = mu - torch.sqrt(t) / gamma * h_avg
        w = t ** (-kappa)
        log_eps_avg = w * log_eps + (1.0 - w) * da.log_eps_avg
        return DAState(log_eps=log_eps, log_eps_avg=log_eps_avg, h_avg=h_avg, t=t)

    # -- drivers --------------------------------------------------------------
    def _da_phase(self, gen, state, eps0, inv_mass, n_steps: int):
        """One dual-averaging phase at fixed mass; returns (state, averaged
        eps, positions (n_steps, nchains, ndim), acceptances)."""
        mu = torch.log(10.0 * eps0)
        da = self._da_init(eps0)
        ops = _mass_ops(inv_mass)
        qs, accs = [], []
        for n in self.lengths(gen, n_steps):
            state, acc = self._transition(gen, state, torch.exp(da.log_eps), ops, n)
            da = self._da_update(da, acc, mu)
            qs.append(state.q)
            accs.append(acc)
        return state, torch.exp(da.log_eps_avg), torch.stack(qs), torch.stack(accs)

    def warmup(self, gen: torch.Generator, q0, n_warmup: int = 300, eps0: float = 0.01,
               inv_mass0=None):
        """Windowed warmup (Stan-style), as the JAX package's: dual averaging
        at the seed mass, mass re-estimation from the window's draws,
        repeated, then a final dual-averaging phase at the settled mass.
        A ``(ndim,)`` ``inv_mass0`` is refined by a diagonal variance
        estimate; a dense ``(ndim, ndim)`` one by the windows' sample
        covariance shrunk toward the running metric (0.75 / 0.25).  Window
        layout 40 % / 40 % / 20 %.  Returns (state, eps, inv_mass, mean
        acceptance of the last phase)."""
        q0 = torch.as_tensor(q0)
        logp0, grad0 = self._lpg(q0)
        state = HMCState(q=q0, logp=logp0, grad=grad0)
        eps0 = torch.as_tensor(eps0, dtype=q0.dtype, device=q0.device)
        if inv_mass0 is None:
            inv_mass = torch.ones((self.ndim,), dtype=q0.dtype, device=q0.device)
        else:
            inv_mass = torch.as_tensor(inv_mass0, dtype=q0.dtype, device=q0.device)

        def refine(inv_mass, qs, n: int):
            # draws from the window's second half (the first half still
            # carries the step-size transient)
            flat = qs[n // 2:].reshape(-1, self.ndim)
            if inv_mass.dim() == 1:
                est = torch.var(flat, dim=0, correction=0) + 1e-12
            else:
                d = flat - flat.mean(dim=0)
                cov = (d.T @ d) / (flat.shape[0] - 1)
                est = 0.75 * cov + 0.25 * inv_mass  # PD: shrink to running
            return torch.where(torch.isfinite(est).all(), est, inv_mass)

        n1 = max(1, int(0.4 * n_warmup))
        n2 = max(1, int(0.4 * n_warmup))
        n3 = max(1, n_warmup - n1 - n2)
        state, eps1, qs, _ = self._da_phase(gen, state, eps0, inv_mass, n1)
        inv_mass = refine(inv_mass, qs, n1)
        state, eps2, qs, _ = self._da_phase(gen, state, eps1, inv_mass, n2)
        inv_mass = refine(inv_mass, qs, n2)
        state, eps, _, accs = self._da_phase(gen, state, eps2, inv_mass, n3)
        return state, eps, inv_mass, torch.mean(accs)

    def run(self, gen: torch.Generator, state: HMCState, eps, inv_mass, n_samples: int,
            thin: int = 1):
        """``n_samples`` transitions at fixed (eps, inv_mass); returns
        (chain (ceil(n_samples / thin), nchains, ndim), logps, mean
        acceptance probability) as tensors on the chains' device."""
        # eps/inv_mass may arrive as float64 host arrays (checkpoint restore,
        # Laplace seeding) while the posterior runs float32: cast to the chain
        # dtype or the kinetic terms promote the whole transition
        like = state.q
        eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
        inv_mass = torch.as_tensor(inv_mass, dtype=like.dtype, device=like.device)
        ops = _mass_ops(inv_mass)
        chain, logps, accs = [], [], []
        for n in self.lengths(gen, n_samples):
            state, acc = self._transition(gen, state, eps, ops, n)
            chain.append(state.q)
            logps.append(state.logp)
            accs.append(acc)
        return (torch.stack(chain[::thin]), torch.stack(logps[::thin]),
                torch.stack(accs).mean())

    def sample(self, gen: int | torch.Generator, q0, n_warmup: int = 300,
               n_samples: int = 1000, eps0: float = 0.01, thin: int = 1):
        """Convenience: warmup + sampling; returns (chain, logps, info) as
        NumPy arrays.  ``gen`` may be a seed (a generator on ``q0``'s device
        is made from it)."""
        q0 = torch.as_tensor(q0)
        if isinstance(gen, int):
            gen = torch.Generator(device=q0.device).manual_seed(gen)
        state, eps, inv_mass, acc_w = self.warmup(gen, q0, n_warmup, eps0)
        chain, logps, acc = self.run(gen, state, eps, inv_mass, n_samples, thin)
        info = dict(eps=float(torch.mean(eps)), accept_warmup=float(acc_w),
                    accept=float(acc), inv_mass=inv_mass.cpu().numpy())
        return chain.cpu().numpy(), logps.cpu().numpy(), info
