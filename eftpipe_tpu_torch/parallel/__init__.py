"""Sampling: the stretch-move ensemble sampler, HMC, the blocked MCMC driver
and convergence diagnostics (counterpart of ``eftpipe_tpu/parallel/``; the
walker mesh is not ported)."""

from .sampler import EnsembleSampler, stretch_step
