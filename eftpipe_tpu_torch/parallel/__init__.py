"""Sampling: the stretch-move ensemble sampler, HMC, the blocked MCMC driver,
convergence diagnostics and the walker mesh over several processes
(counterpart of ``eftpipe_tpu/parallel/``)."""

from .sampler import EnsembleSampler, stretch_step
