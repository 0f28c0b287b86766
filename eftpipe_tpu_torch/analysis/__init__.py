"""Post-analysis tooling of the port (counterpart of
``eftpipe_tpu/analysis/``): chain products, multipole containers and
bestfit models for chains written by :mod:`eftpipe_tpu_torch.parallel.mcmc`.
NumPy in place of pandas.  Not ported yet: ``kaiser.py``, ``convert.py``,
``zeff.py`` (ROADMAP A7)."""

from .chains import ChainProducts
from .multipole import Multipole
from .bestfit import BestfitModel

__all__ = ["ChainProducts", "Multipole", "BestfitModel"]
