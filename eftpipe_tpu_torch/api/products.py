"""Theory products: the analogue of upstream's provider outputs (counterpart
of ``eftpipe_tpu/api/products.py``).

Upstream exposes per-tracer products through Cobaya (eftpipe/theory.py:
244-267, 773-799):

* ``nonlinear_Plk_grid``      — (ls, kgrid, plk) on the internal/binned grid
* ``nonlinear_Plk_interpolator`` — cubic interpolator in k·P (theory.py:75-106)
* ``nonlinear_Plk_gaussian_grid`` — ∂P/∂(gaussian param) tables
* ``snapshots``               — intermediate bird states per pipeline stage
* ``bird_component``          — (Plin, Ploop, Pct, Pst, Picc) split

Here the same products are plain functions of (pipeline, basis, inputs,
params) on a walker batch: ``plk`` is (W, nl, nk).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import spline_matrix


class PlkInterpolator:
    """Cubic interpolator of multipoles, built on k·P with a (0, 0) point
    prepended (upstream theory.py:75-106).

    Parameters
    ----------
    ls : the multipoles the grid rows correspond to
    kgrid : (nk,) grid the theory was evaluated on
    plk : (..., nl, nk) multipole tensor
    """

    def __init__(self, ls, kgrid, plk):
        self.ls = list(ls)
        self._row = {ell: i for i, ell in enumerate(self.ls)}
        self.kgrid = np.asarray(kgrid)
        self.plk = plk
        self._kp = np.concatenate([[0.0], self.kgrid])

    def __call__(self, ell, k):
        """P_ell(k); ell may be an int or a list of ints."""
        ells = [ell] if isinstance(ell, int) else list(ell)
        for l in ells:
            if l not in self._row:
                raise ValueError(f"ell={l} not available (have {self.ls})")
        k = np.atleast_1d(np.asarray(k, dtype=np.float64))
        like = self.plk
        mat = torch.as_tensor(spline_matrix(self._kp, k), dtype=like.dtype, device=like.device)
        kgrid = torch.as_tensor(self.kgrid, dtype=like.dtype, device=like.device)
        kq = torch.as_tensor(k, dtype=like.dtype, device=like.device)
        kp = torch.cat([like.new_zeros(like.shape[:-1] + (1,)), like * kgrid], dim=-1)
        out = (kp[..., [self._row[l] for l in ells], :] @ mat.T) / kq
        return out[..., 0, :] if isinstance(ell, int) else out


def plk_grid(pipeline, basis, inputs, params, chained=False, binning=None):
    """(ls, kgrid, plk): the ``nonlinear_Plk_grid`` product."""
    bird = pipeline.compute_bird(inputs)
    ls, kret, product = pipeline.product(bird, chained=chained, binning=binning)
    plk = basis.reduce_plk(pipeline.cfg, product, params).sum()
    return ls, kret, plk


def plk_interpolator(pipeline, basis, inputs, params, chained=False):
    ls, kret, plk = plk_grid(pipeline, basis, inputs, params, chained=chained)
    return PlkInterpolator(ls, kret, plk)


def plk_gaussian_grid(pipeline, basis, inputs, params, chained=False,
                      binning=None, requires=None):
    """name → (W, nl, nk) table of ∂P/∂(gaussian param)."""
    bird = pipeline.compute_bird(inputs)
    ls, kret, product = pipeline.product(bird, chained=chained, binning=binning)
    table = basis.gaussian_table(pipeline.cfg, product, params, requires=requires)
    return ls, kret, table


def bird_component(pipeline, basis, inputs, params, chained=False, binning=None):
    """The (Plin, Ploop, Pct, Pst, Picc) split (parambasis.py:30-39)."""
    bird = pipeline.compute_bird(inputs)
    ls, kret, product = pipeline.product(bird, chained=chained, binning=binning)
    return ls, kret, basis.reduce_plk(pipeline.cfg, product, params)


def snapshots(pipeline, inputs):
    """Intermediate bird states per stage (upstream BirdSnapshot,
    pybird.py:616-632)."""
    return pipeline.compute_bird(inputs, with_snapshots=True)[1]
