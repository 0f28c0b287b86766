"""Post-analysis tooling of the port (counterpart of
``eftpipe_tpu/analysis/``): chain products, multipole containers and
bestfit models for chains written by :mod:`eftpipe_tpu_torch.parallel.mcmc`,
NumPy in place of pandas; and the host tools ``kaiser.py`` (linear Kaiser
fits), ``convert.py`` (BAO/RSD conversions) and ``zeff.py`` (effective
redshift of a random catalogue), copies of the JAX package's."""

from .chains import ChainProducts
from .multipole import Multipole
from .bestfit import BestfitModel

__all__ = ["ChainProducts", "Multipole", "BestfitModel"]
