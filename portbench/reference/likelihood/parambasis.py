"""EFT parameter bases: map named bias parameters to reduced multipoles
(counterpart of ``eftpipe_tpu/likelihood/parambasis.py``).

Upstream eftpipe/parambasis.py: the "west coast" basis {b1,b2,b3,b4,cct,
cr1,cr2,ce0,cemono,cequad(,cr4,cr6)} with km/kr/nd normalisations, for auto
and cross spectra (parambasis.py:42-136, 165-316), and the "east coast"
basis {b1,b2,bG2,bGamma3,c0,c2,c4,Pshot,a0,a2(,ctilde)} with its basis
rotation (parambasis.py:319-454).  All outputs are linear in the bird
tensors and polynomial in the sampled parameters.  Parameters are (W,)
tensors or Python floats; bird tensors are a ``BirdState`` or any object
with p11l/ploopl/pctl/pct_nnlo_l/pstl/picc shaped (W, L, n, nk) plus the
growth rate ``f`` (W,).
"""

from __future__ import annotations

import importlib
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

    bs_a/bs_b: (b1, b2, b3, b4, cct, cr1, cr2) per tracer; in the eastcoast
    convention the last three are interpreted as (c̃0, c̃2, c̃4).
    """
    km_a, kr_a, nd_a = cfg.km_a, cfg.kr_a, cfg.nd_a
    km_b, kr_b, nd_b = cfg.km_b, cfg.kr_b, cfg.nd_b
    b1a, b2a, b3a, b4a, ccta, cr1a, cr2a = bs_a
    b1b, b2b, b3b, b4b, cctb, cr1b, cr2b = bs_b if bs_b is not None else bs_a
    ce0, cemono, cequad = es

    b11 = _stack([b1a * b1b, (b1a + b1b) * f, f * f], f)
    bct_nnlo = None
    if cfg.counterform == "westcoast":
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
    else:  # eastcoast (parambasis.py:102-107)
        bct = _stack([-ccta - cctb, -(cr1a + cr1b) * f, -(cr2a + cr2b) * f * f,
                      0.0, 0.0, 0.0], f)
        if cfg.with_nnlo:
            ctilde = cnnlo_a[0]
            bct_nnlo = ctilde * _stack([-(b1a**2) * f**4, -2 * b1a * f**5, -(f**6)], f)
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
    """parambasis.py:165-316; a cross spectrum takes its partners' bias
    parameters (``cross_prefix``) and its own stochastic ones (``prefix``)."""

    name = "westcoast"
    counterform = "westcoast"

    def __init__(self, prefix: str = "", cross_prefix: list[str] | None = None):
        self.prefix = prefix
        self.cross_prefix = list(cross_prefix or [])

    def is_cross(self) -> bool:
        return bool(self.cross_prefix)

    def bs_names(self, which: int = 0) -> list[str]:
        names = ("b1", "b2", "b3", "b4", "cct", "cr1", "cr2")
        prefix = self.cross_prefix[which] if self.is_cross() else self.prefix
        return [prefix + p for p in names]

    def es_names(self) -> list[str]:
        return [self.prefix + p for p in ("ce0", "cemono", "cequad")]

    def cnnlo_names(self) -> list[str]:
        return [self.prefix + p for p in ("cr4", "cr6")]

    def non_gaussian_params(self) -> list[str]:
        names = ("b1", "b2", "b4")
        if self.is_cross():
            return [x + p for x in self.cross_prefix for p in names]
        return [self.prefix + p for p in names]

    def gaussian_params(self) -> list[str]:
        names = ("b3", "cct", "cr1", "cr2")
        st = ("ce0", "cemono", "cequad")
        if self.is_cross():
            return [x + p for x in self.cross_prefix for p in names] + [
                self.prefix + p for p in st
            ]
        return [self.prefix + p for p in names + st] + self.cnnlo_names()

    def _values(self, params: Mapping, names: list[str]):
        return [params.get(n, 0.0) for n in names]

    def reduce_plk(self, cfg: EFTConfig, bird, params: Mapping) -> BirdComponent:
        bs_a = self._values(params, self.bs_names(0))
        bs_b = self._values(params, self.bs_names(1)) if self.is_cross() else None
        es = self._values(params, self.es_names())
        cnnlo = self._values(params, self.cnnlo_names()) if cfg.with_nnlo else (0.0, 0.0)
        return reduce_plk(cfg, bird, bird.f, bs_a, bs_b, es, cnnlo)

    def gaussian_table(self, cfg: EFTConfig, bird, params: Mapping, requires=None) -> dict:
        """∂P/∂(gaussian param) rows, each (W, L, nk) (parambasis.py:249-316)."""
        f = _col(bird.f)
        km_a, kr_a, nd_a = cfg.km_a, cfg.kr_a, cfg.nd_a
        km_b, kr_b, nd_b = cfg.km_b, cfg.kr_b, cfg.nd_b
        ploopl = _no(cfg, bird.ploopl)
        pctl = _no(cfg, bird.pctl)
        pct_nnlo_l = _no(cfg, bird.pct_nnlo_l)
        pstl = _no(cfg, bird.pstl)
        pg: dict = {}

        def want(p):
            return requires is None or p in requires

        if self.is_cross():
            pa, pb = self.cross_prefix
            b1a = _col(params[pa + "b1"])
            b1b = _col(params[pb + "b1"])
            for pref, b1o, km, kr in ((pa, b1b, km_a, kr_a), (pb, b1a, km_b, kr_b)):
                if want(p := pref + "b3"):
                    pg[p] = 0.5 * ploopl[..., 3, :] + 0.5 * b1o * ploopl[..., 7, :]
                if want(p := pref + "cct"):
                    pg[p] = b1o / km**2 * pctl[..., 0, :] + f / km**2 * pctl[..., 3, :]
                if want(p := pref + "cr1"):
                    pg[p] = b1o / kr**2 * pctl[..., 1, :] + f / kr**2 * pctl[..., 4, :]
                if want(p := pref + "cr2"):
                    pg[p] = b1o / kr**2 * pctl[..., 2, :] + f / kr**2 * pctl[..., 5, :]
        else:
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


class EastCoastBasis:
    """parambasis.py:319-454 (arXiv 2106.12580, 2208.05929); no cross support."""

    name = "eastcoast"
    counterform = "eastcoast"

    def __init__(self, prefix: str = "", cross_prefix: list[str] | None = None):
        if cross_prefix:
            raise NotImplementedError("EastCoastBasis does not support cross spectra")
        self.prefix = prefix
        self.cross_prefix: list[str] = []

    def is_cross(self) -> bool:
        return False

    def non_gaussian_params(self) -> list[str]:
        return [self.prefix + p for p in ("b1", "b2", "bG2")]

    def gaussian_params(self) -> list[str]:
        return [
            self.prefix + p
            for p in ("bGamma3", "c0", "c2", "c4", "Pshot", "a0", "a2", "ctilde")
        ]

    def reduce_plk(self, cfg: EFTConfig, bird, params: Mapping) -> BirdComponent:
        g = lambda n: params.get(self.prefix + n, 0.0)
        b1, b2, bg2, bgamma3 = g("b1"), g("b2"), g("bG2"), g("bGamma3")
        c0, c2, c4 = g("c0"), g("c2"), g("c4")
        f = bird.f
        bs_a = [
            b1,
            b1 + 3.5 * bg2,
            b1 + 15.0 * bg2 + 6.0 * bgamma3,
            0.5 * b2 - 3.5 * bg2,
            c0 - f / 3.0 * c2 + 3.0 / 35.0 * f**2 * c4,
            c2 - 6.0 / 7.0 * f * c4,
            c4,
        ]
        pshot, a0, a2 = g("Pshot"), g("a0"), g("a2")
        es = [pshot, a0 + a2 / 3.0, 2.0 / 3.0 * a2]
        cnnlo = (g("ctilde"), 0.0) if cfg.with_nnlo else (0.0, 0.0)
        return reduce_plk(cfg, bird, f, bs_a, None, es, cnnlo)

    def gaussian_table(self, cfg: EFTConfig, bird, params: Mapping, requires=None) -> dict:
        f = _col(bird.f)
        km_a, nd_a = cfg.km_a, cfg.nd_a
        km_b, nd_b = cfg.km_b, cfg.nd_b
        b1 = _col(params[self.prefix + "b1"])
        ploopl = _no(cfg, bird.ploopl)
        pctl = _no(cfg, bird.pctl)
        pct_nnlo_l = _no(cfg, bird.pct_nnlo_l)
        pstl = _no(cfg, bird.pstl)
        pg: dict = {}

        def want(p):
            return requires is None or p in requires

        if want(p := self.prefix + "bGamma3"):
            pg[p] = 6.0 * (ploopl[..., 3, :] + b1 * ploopl[..., 7, :])
        if want(p := self.prefix + "c0"):
            pg[p] = -2.0 * pctl[..., 0, :]
        if want(p := self.prefix + "c2"):
            pg[p] = 2.0 / 3.0 * f * pctl[..., 0, :] - 2.0 * f * pctl[..., 1, :]
        if want(p := self.prefix + "c4"):
            pg[p] = (
                -6.0 / 35.0 * f**2 * pctl[..., 0, :]
                + 12.0 / 7.0 * f**2 * pctl[..., 1, :]
                - 2.0 * f**2 * pctl[..., 2, :]
            )
        if cfg.with_nnlo and want(p := self.prefix + "ctilde"):
            pg[p] = (
                -(b1**2) * f**4 * pct_nnlo_l[..., 0, :]
                - 2.0 * b1 * f**5 * pct_nnlo_l[..., 1, :]
                - f**6 * pct_nnlo_l[..., 2, :]
            )
        x1 = 0.5 * (1.0 / nd_a + 1.0 / nd_b)
        x2 = 0.5 * (1.0 / nd_a / km_a**2 + 1.0 / nd_b / km_b**2)
        if want(p := self.prefix + "Pshot"):
            pg[p] = x1 * pstl[..., 0, :]
        if want(p := self.prefix + "a0"):
            pg[p] = x2 * pstl[..., 1, :]
        if want(p := self.prefix + "a2"):
            pg[p] = x2 / 3.0 * (pstl[..., 1, :] + 2.0 * pstl[..., 2, :])
        return pg


def find_param_basis(name: str):
    """Resolve a basis by name or dotted path (parambasis.py:457-465)."""
    if name == "westcoast":
        return WestCoastBasis
    if name == "eastcoast":
        return EastCoastBasis
    module_name, class_name = name.rsplit(".", 1)
    return getattr(importlib.import_module(module_name), class_name)
