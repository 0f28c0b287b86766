"""Bird state: multipole-weighted spectra and bias-channel regrouping
(counterpart of ``eftpipe_tpu/models/bird.py``).

Functional replacement for upstream ``Bird`` + ``setPsCfl`` / ``reducePsCfl``
/ ``setPstl`` / ``subtractShotNoise`` (pybird/pybird.py:635-866).  The
f-power regrouping of the 28 + 10 loop structures into 12 bias-independent
channels is tensorised into constant (channel, structure) exponent masks, so
the whole assembly is a pair of einsums over the walker batch.
"""

from __future__ import annotations

import numpy as np
import torch
from typing import NamedTuple

from .. import to_device
from ..ops.interp import spline_matrix
from ..tables.loop_matrices import legendre_weights
from .config import EFTConfig


class BirdState(NamedTuple):
    """Per-evaluation pipeline state (tensors; leading axis = walkers).

    Power-spectrum side on cfg.k, correlation-function side on cfg.s.
    ``pct_nnlo_l`` / ``cct_nnlo`` are zeros when cfg.with_nnlo is off, so all
    downstream transforms can act unconditionally.
    """

    f: torch.Tensor          # (W,) growth rate
    p11l: torch.Tensor       # (W, nl, 3, nk)
    ploopl: torch.Tensor     # (W, nl, 12, nk)
    pctl: torch.Tensor       # (W, nl, 6, nk)
    pct_nnlo_l: torch.Tensor # (W, nl, 3, nk)
    pstl: torch.Tensor       # (W, nl, 3, nk)
    picc: torch.Tensor       # (W, nl, nk)
    c11: torch.Tensor        # (W, nl, ns)
    cct: torch.Tensor        # (W, nl, ns)
    cct_nnlo: torch.Tensor   # (W, nl, ns)
    cloopl: torch.Tensor     # (W, nl, 12, ns)


# (channel, structure, f-power) triples of the bias regrouping
# (pybird.py:762-803); channels ordered [1, b1, b2, b3, b4, b1², b1b2, b1b3,
# b1b4, b2², b2b4, b4²]
_R22 = [
    (0, 20, 2), (0, 23, 3), (0, 24, 3), (0, 25, 4), (0, 26, 4), (0, 27, 4),
    (1, 9, 1), (1, 14, 2), (1, 15, 2), (1, 21, 3), (1, 22, 3),
    (2, 10, 1), (2, 16, 2), (2, 17, 2),
    (4, 11, 1), (4, 18, 2), (4, 19, 2),
    (5, 0, 0), (5, 6, 1), (5, 12, 2), (5, 13, 2),
    (6, 1, 0), (6, 7, 1),
    (8, 2, 0), (8, 8, 1),
    (9, 3, 0), (10, 4, 0), (11, 5, 0),
]
_R13 = [
    (0, 7, 2), (0, 8, 3), (0, 9, 3),
    (1, 3, 1), (1, 5, 2), (1, 6, 2),
    (3, 4, 1),
    (5, 0, 0), (5, 2, 1),
    (7, 1, 0),
]


def _exponent_tables(triples, nchan, nstruct):
    mask = np.zeros((nchan, nstruct))
    expo = np.zeros((nchan, nstruct))
    for c, b, p in triples:
        mask[c, b] = 1.0
        expo[c, b] = p
    return mask, expo


def bird_tables_numpy(cfg: EFTConfig) -> dict:
    ltab = legendre_weights(cfg.nl)
    mask22, expo22 = _exponent_tables(_R22, cfg.nloop, cfg.n22)
    mask13, expo13 = _exponent_tables(_R13, cfg.nloop, cfg.n13)
    pstl = np.zeros((cfg.nl, 3, cfg.nk))
    pstl[0, 0] = 1.0
    pstl[0, 1] = cfg.k**2
    if cfg.nl >= 2:
        pstl[1, 2] = cfg.k**2
    return dict(
        s_kin_to_k=spline_matrix(cfg.kin, cfg.k),
        k=cfg.k,
        k2=cfg.k**2,
        k4=cfg.k**4,
        mask22=mask22,
        expo22=expo22,
        mask13=mask13,
        expo13=expo13,
        pstl=pstl,
        **ltab,
    )


def build_bird_tables(cfg: EFTConfig, device, dtype) -> dict:
    return to_device(bird_tables_numpy(cfg), device, dtype)


def _loop_weights(bt, f):
    """(W, 12, 28) and (W, 12, 10) f-power weights."""
    fb = f[..., None, None]
    w22 = fb ** bt["expo22"] * bt["mask22"]
    w13 = fb ** bt["expo13"] * bt["mask13"]
    return w22, w13


def assemble_bird(bt: dict, cfg: EFTConfig, nl_out: dict, plin_kin, f) -> BirdState:
    """setPsCfl + reducePsCfl + setPstl + subtractShotNoise, batched.

    nl_out : output of :func:`..nonlinear.nonlinear_pscf`: the CF loop as
        per-structure ``c22``/``c13``
    plin_kin : (W, nkin) linear P on cfg.kin;  f : (W,) growth rate
    """
    dtype = plin_kin.dtype
    p11 = plin_kin @ bt["s_kin_to_k"].T  # (W, nk)
    l11, lct, lct_nnlo = bt["l11"], bt["lct"], bt["lct_nnlo"]
    l22, l13 = bt["l22"], bt["l13"]

    p11l = torch.einsum("...x,ln->...lnx", p11, l11)
    pctl = torch.einsum("...x,ln->...lnx", bt["k2"] * p11, lct)
    if cfg.with_nnlo:
        pct_nnlo_l = torch.einsum("...x,ln->...lnx", bt["k4"] * p11, lct_nnlo)
    else:
        pct_nnlo_l = p11.new_zeros(p11.shape[:-1] + (cfg.nl, 3, cfg.nk))

    p13 = nl_out["p13_kernel"] * p11[..., None, :]
    p22l = torch.einsum("...bx,lb->...lbx", nl_out["p22"], l22)
    p13l = torch.einsum("...bx,lb->...lbx", p13, l13)

    w22, w13 = _loop_weights(bt, f)
    ploopl = torch.einsum("...cb,...lbx->...lcx", w22, p22l) + torch.einsum(
        "...cb,...lbx->...lcx", w13, p13l
    )
    c22l = nl_out["c22"] * l22[:, :, None]
    c13l = nl_out["c13"] * l13[:, :, None]
    cloopl = torch.einsum("...cb,...lbx->...lcx", w22, c22l) + torch.einsum(
        "...cb,...lbx->...lcx", w13, c13l
    )
    # constant stochastic contribution removed from the loops (pybird.py:861-866)
    ploopl = ploopl - ploopl[..., :1]

    pstl = bt["pstl"].expand(p11.shape[:-1] + (cfg.nl, 3, cfg.nk))
    picc = p11.new_zeros(p11.shape[:-1] + (cfg.nl, cfg.nk))

    return BirdState(
        f=f.to(dtype),
        p11l=p11l,
        ploopl=ploopl,
        pctl=pctl,
        pct_nnlo_l=pct_nnlo_l,
        pstl=pstl,
        picc=picc,
        c11=nl_out["c11"],
        cct=nl_out["cct"],
        cct_nnlo=nl_out["cct_nnlo"] if cfg.with_nnlo else torch.zeros_like(nl_out["cct"]),
        cloopl=cloopl,
    )
