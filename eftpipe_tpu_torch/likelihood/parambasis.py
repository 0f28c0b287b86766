"""EFT parameter bases: map named bias parameters to reduced multipoles
(counterpart of ``eftpipe_tpu/likelihood/parambasis.py``; this slice ports
the "west coast" basis without cross spectra).

Upstream eftpipe/parambasis.py: {b1,b2,b3,b4,cct,cr1,cr2,ce0,cemono,cequad
(,cr4,cr6)} with km/kr/nd normalisations (parambasis.py:42-136, 165-316).
All outputs are linear in the bird tensors and polynomial in the sampled
parameters.  Parameters are (W,) tensors or Python floats; bird tensors are
a ``BirdState`` or any object with p11l/ploopl/pctl/pct_nnlo_l/pstl/picc
shaped (W, L, n, nk) plus the growth rate ``f`` (W,).
"""

from __future__ import annotations

import torch
from typing import Iterable, Mapping, NamedTuple

from ..models.config import EFTConfig


class BirdComponent(NamedTuple):
    plin: torch.Tensor
    ploop: torch.Tensor
    pct: torch.Tensor
    pst: torch.Tensor
    picc: torch.Tensor

    def sum(self):
        return self.plin + self.ploop + self.pct + self.pst + self.picc


def _no(cfg: EFTConfig, x):
    """Slice the multipole axis to the output count."""
    return x[..., : cfg.no, :, :]


def _stack(items, like):
    """Stack parameter combinations (tensors shaped like ``like``, or Python
    floats) on a new leading axis."""
    return torch.stack([
        x.to(like.dtype) if isinstance(x, torch.Tensor) and x.shape == like.shape
        else like * 0.0 + x
        for x in items])


def reduce_plk(
    cfg: EFTConfig,
    bird,
    f,
    bs_a: Iterable,
    bs_b: Iterable | None = None,
    es: Iterable = (0.0, 0.0, 0.0),
    cnnlo_a: Iterable = (0.0, 0.0),
) -> BirdComponent:
    """Contract bias parameters against the bird tensors (parambasis.py:42-136).

    bs_a/bs_b: (b1, b2, b3, b4, cct, cr1, cr2) per tracer.
    """
    if cfg.counterform != "westcoast":
        raise NotImplementedError(
            "reduce_plk: the eastcoast counterterm form is not ported yet (ROADMAP A5)")
    km_a, kr_a, nd_a = cfg.km_a, cfg.kr_a, cfg.nd_a
    km_b, kr_b, nd_b = cfg.km_b, cfg.kr_b, cfg.nd_b
    b1a, b2a, b3a, b4a, ccta, cr1a, cr2a = bs_a
    b1b, b2b, b3b, b4b, cctb, cr1b, cr2b = bs_b if bs_b is not None else bs_a
    ce0, cemono, cequad = es

    b11 = _stack([b1a * b1b, (b1a + b1b) * f, f * f], f)
    bct = _stack([
        b1a * cctb / km_b**2 + b1b * ccta / km_a**2,
        b1b * cr1a / kr_a**2 + b1a * cr1b / kr_b**2,
        b1b * cr2a / kr_a**2 + b1a * cr2b / kr_b**2,
        (ccta / km_a**2 + cctb / km_b**2) * f,
        (cr1a / kr_a**2 + cr1b / kr_b**2) * f,
        (cr2a / kr_a**2 + cr2b / kr_b**2) * f,
    ], f)
    if cfg.with_nnlo:
        cr4, cr6 = cnnlo_a
        bct_nnlo = _stack(
            [0.25 * b1a**2 / kr_a**4 * cr4, 0.25 * b1a / kr_a**4 * cr6, 0.0], f)
    else:
        bct_nnlo = None
    bloop = _stack([
        1.0,
        0.5 * (b1a + b1b),
        0.5 * (b2a + b2b),
        0.5 * (b3a + b3b),
        0.5 * (b4a + b4b),
        b1a * b1b,
        0.5 * (b1a * b2b + b1b * b2a),
        0.5 * (b1a * b3b + b1b * b3a),
        0.5 * (b1a * b4b + b1b * b4a),
        b2a * b2b,
        0.5 * (b2a * b4b + b2b * b4a),
        b4a * b4b,
    ], f)
    x1 = 0.5 * (1.0 / nd_a + 1.0 / nd_b)
    x2 = 0.5 * (1.0 / nd_a / km_a**2 + 1.0 / nd_b / km_b**2)
    bst = _stack([ce0 * x1, cemono * x2, cequad * x2], f)

    def contract(w, x):
        return torch.einsum("b...,...lbx->...lx", w, _no(cfg, x))

    plin = contract(b11, bird.p11l)
    ploop = contract(bloop, bird.ploopl)
    pct = contract(bct, bird.pctl)
    if bct_nnlo is not None:
        pct = pct + contract(bct_nnlo, bird.pct_nnlo_l)
    pst = contract(bst, bird.pstl)
    picc = bird.picc[..., : cfg.no, :]
    return BirdComponent(plin=plin, ploop=ploop, pct=pct, pst=pst, picc=picc)


def _col(x):
    """A (W,) parameter against (W, L, nk) tensors."""
    return x[..., None, None] if isinstance(x, torch.Tensor) and x.dim() else x


class WestCoastBasis:
    """parambasis.py:165-316, auto spectra only."""

    name = "westcoast"
    counterform = "westcoast"

    def __init__(self, prefix: str = "", cross_prefix: list[str] | None = None):
        if cross_prefix:
            raise NotImplementedError(
                "WestCoastBasis: cross spectra are not ported yet (ROADMAP A5)")
        self.prefix = prefix
        self.cross_prefix: list[str] = []

    def is_cross(self) -> bool:
        return False

    def bs_names(self, which: int = 0) -> list[str]:
        names = ("b1", "b2", "b3", "b4", "cct", "cr1", "cr2")
        return [self.prefix + p for p in names]

    def es_names(self) -> list[str]:
        return [self.prefix + p for p in ("ce0", "cemono", "cequad")]

    def cnnlo_names(self) -> list[str]:
        return [self.prefix + p for p in ("cr4", "cr6")]

    def non_gaussian_params(self) -> list[str]:
        return [self.prefix + p for p in ("b1", "b2", "b4")]

    def gaussian_params(self) -> list[str]:
        names = ("b3", "cct", "cr1", "cr2")
        st = ("ce0", "cemono", "cequad")
        return [self.prefix + p for p in names + st] + self.cnnlo_names()

    def _values(self, params: Mapping, names: list[str]):
        return [params.get(n, 0.0) for n in names]

    def reduce_plk(self, cfg: EFTConfig, bird, params: Mapping) -> BirdComponent:
        bs_a = self._values(params, self.bs_names(0))
        es = self._values(params, self.es_names())
        cnnlo = self._values(params, self.cnnlo_names()) if cfg.with_nnlo else (0.0, 0.0)
        return reduce_plk(cfg, bird, bird.f, bs_a, None, es, cnnlo)

    def gaussian_table(self, cfg: EFTConfig, bird, params: Mapping, requires=None) -> dict:
        """∂P/∂(gaussian param) rows, each (W, L, nk) (parambasis.py:249-316)."""
        f = _col(bird.f)
        km_a, kr_a, nd_a = cfg.km_a, cfg.kr_a, cfg.nd_a
        km_b, nd_b = cfg.km_b, cfg.nd_b
        ploopl = _no(cfg, bird.ploopl)
        pctl = _no(cfg, bird.pctl)
        pct_nnlo_l = _no(cfg, bird.pct_nnlo_l)
        pstl = _no(cfg, bird.pstl)
        pg: dict = {}

        def want(p):
            return requires is None or p in requires

        b1 = _col(params[self.prefix + "b1"])
        if want(p := self.prefix + "b3"):
            pg[p] = ploopl[..., 3, :] + b1 * ploopl[..., 7, :]
        if want(p := self.prefix + "cct"):
            pg[p] = 2.0 * b1 / km_a**2 * pctl[..., 0, :] + 2.0 * f / km_a**2 * pctl[..., 3, :]
        if want(p := self.prefix + "cr1"):
            pg[p] = 2.0 * b1 / kr_a**2 * pctl[..., 1, :] + 2.0 * f / kr_a**2 * pctl[..., 4, :]
        if want(p := self.prefix + "cr2"):
            pg[p] = 2.0 * b1 / kr_a**2 * pctl[..., 2, :] + 2.0 * f / kr_a**2 * pctl[..., 5, :]
        if cfg.with_nnlo:
            if want(p := self.prefix + "cr4"):
                pg[p] = 0.25 * b1**2 / kr_a**4 * pct_nnlo_l[..., 0, :]
            if want(p := self.prefix + "cr6"):
                pg[p] = 0.25 * b1 / kr_a**4 * pct_nnlo_l[..., 1, :]
        x1 = 0.5 * (1.0 / nd_a + 1.0 / nd_b)
        x2 = 0.5 * (1.0 / nd_a / km_a**2 + 1.0 / nd_b / km_b**2)
        if want(p := self.prefix + "ce0"):
            pg[p] = pstl[..., 0, :] * x1
        if want(p := self.prefix + "cemono"):
            pg[p] = pstl[..., 1, :] * x2
        if want(p := self.prefix + "cequad"):
            pg[p] = pstl[..., 2, :] * x2
        return pg
