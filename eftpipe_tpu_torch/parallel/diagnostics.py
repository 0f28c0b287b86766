"""Convergence diagnostics for ensemble chains (a NumPy copy of
``eftpipe_tpu/parallel/diagnostics.py``; the port keeps its own).

The walkers of the ensemble play the role of independent chains: split-R̂
(Gelman–Rubin) over walkers plus the Goodman–Weare integrated
autocorrelation time.  All inputs are host NumPy arrays (chains are small
compared to the sampling computation).
"""

from __future__ import annotations

import numpy as np


def gelman_rubin(chain: np.ndarray, burn_frac: float = 0.5) -> np.ndarray:
    """Split-R̂ per parameter; ``chain`` has shape (nsteps, nwalkers, ndim).

    Each walker's post-burn-in trajectory is split in half, giving
    2·nwalkers sequences; returns the classic potential-scale-reduction
    estimate R̂ (→ 1 at convergence).  Use ``R̂ − 1`` against the Cobaya-style
    threshold.
    """
    chain = np.asarray(chain)
    nsteps = chain.shape[0]
    start = int(burn_frac * nsteps)
    x = chain[start:]
    n = x.shape[0] // 2
    if n < 2:
        return np.full(chain.shape[-1], np.inf)
    # split each walker trajectory in two → (2*nwalkers, n, ndim)
    seqs = np.concatenate([x[:n], x[n : 2 * n]], axis=1).swapaxes(0, 1)
    m, n, d = seqs.shape
    mean = seqs.mean(axis=1)                       # (m, d)
    var = seqs.var(axis=1, ddof=1)                 # (m, d)
    w = var.mean(axis=0)                           # within
    b = n * mean.var(axis=0, ddof=1)               # between
    v_hat = (n - 1) / n * w + b / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(v_hat / w)
    return np.where(np.isfinite(rhat), rhat, np.inf)


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_func_1d(x: np.ndarray) -> np.ndarray:
    """Normalised autocorrelation of a 1-D sequence via FFT."""
    x = np.asarray(x, dtype=np.float64)
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] == 0:
        return np.zeros_like(acf)
    return acf / acf[0]


def integrated_autocorr_time(
    chain: np.ndarray, c: float = 5.0, burn_frac: float = 0.0
) -> np.ndarray:
    """Goodman–Weare integrated autocorrelation time per parameter.

    chain: (nsteps, nwalkers, ndim); the walker-averaged autocorrelation
    function is integrated with the standard self-consistent window
    (tau estimates are reliable once nsteps ≳ 50·tau).
    """
    chain = np.asarray(chain)
    start = int(burn_frac * chain.shape[0])
    x = chain[start:]
    nsteps, nwalkers, ndim = x.shape
    taus = np.empty(ndim)
    for d in range(ndim):
        f = np.zeros(nsteps)
        for w in range(nwalkers):
            f += autocorr_func_1d(x[:, w, d])
        f /= nwalkers
        taus_cum = 2.0 * np.cumsum(f) - 1.0
        window = np.arange(len(taus_cum)) >= c * taus_cum
        idx = np.argmax(window) if window.any() else len(taus_cum) - 1
        taus[d] = taus_cum[idx]
    return taus


def effective_sample_size(chain: np.ndarray, **kwargs) -> np.ndarray:
    """ESS per parameter = total samples / tau."""
    chain = np.asarray(chain)
    tau = integrated_autocorr_time(chain, **kwargs)
    return chain.shape[0] * chain.shape[1] / np.maximum(tau, 1.0)
