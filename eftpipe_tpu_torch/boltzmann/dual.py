"""Forward-mode helpers of the solver's gradient.

The solver's gradient is forward-mode: its tables are built once more under
:mod:`torch.autograd.forward_ad` with a tangent on the differentiated
parameters (``einstein_boltzmann.EBSolver``), and the recurrences take their
tangent kernels on the card and their plain versions on the CPU.

Under forward AD, torch gives an operand that has no tangent (a number, a
constant table) an efficient zero tensor, and every operation on one
computes its result's shape through torch's Python meta kernels: 0.2–0.5 ms
an operation on the host, ~25× a plain operation of the solver's step loops.
:class:`DenseTangents` keeps the dual pass off that path and changes no
number: tensor-number arithmetic goes to the ``Scalar`` overloads (the same
kernels, whose tangent formulas need no tangent of the number), and a
floating tensor without a tangent that meets one with a tangent is given a
dense zero tangent.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad
from torch.overrides import TorchFunctionMode

_A = torch.ops.aten
# tensor (op) number, by the name of the method Python's arithmetic calls
_SCALAR_OPS = {"mul": _A.mul.Scalar, "add": _A.add.Scalar, "sub": _A.sub.Scalar,
               "div": _A.div.Scalar, "__rsub__": _A.rsub.Scalar}


def tangent(t: torch.Tensor):
    """The forward-AD tangent of ``t`` at the current level, or None."""
    return forward_ad.unpack_dual(t).tangent


def tangent_or_zeros(t: torch.Tensor) -> torch.Tensor:
    d = tangent(t)
    return torch.zeros_like(forward_ad.unpack_dual(t).primal) if d is None else d


def direct_tangents(*tensors):
    """The primals and tangents of a kernel's inputs when the kernel's
    wrapper should launch its tangent kernel itself: some input carries a
    forward-AD tangent and none needs a reverse-mode graph.  A missing or
    efficient-zero tangent comes back as dense zeros, every tangent
    contiguous.  None otherwise (the wrapper's ``torch.autograd.Function``
    then takes the inputs)."""
    tans = [tangent(t) for t in tensors]
    if all(d is None for d in tans):
        return None
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return None
    prims = [forward_ad.unpack_dual(t).primal for t in tensors]
    return prims, [torch.zeros_like(p) if d is None or d._is_zerotensor() else d.contiguous()
                   for p, d in zip(prims, tans)]


def _dense(a):
    if type(a) is torch.Tensor and a.is_floating_point() and tangent(a) is None:
        a = a.contiguous() if 0 in a.stride() else a
        return forward_ad.make_dual(a, torch.zeros_like(a))
    return a


class DenseTangents(TorchFunctionMode):
    """Within a ``forward_ad.dual_level()``: the same numbers, with no
    efficient zero tangents (module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if len(args) == 2 and type(args[1]) in (int, float) and type(args[0]) is torch.Tensor:
            name = func.__name__
            if name in _SCALAR_OPS and not kwargs:
                return _SCALAR_OPS[name](args[0], args[1])
            if name == "__rdiv__":  # number / tensor, as torch computes it
                return _A.mul.Scalar(torch.reciprocal(args[0]), args[1])
        elif len(args) > 1 or (args and type(args[0]) in (list, tuple)):
            floats = [b for a in args for b in (a if type(a) in (list, tuple) else (a,))
                      if type(b) is torch.Tensor and b.is_floating_point()]
            if len(floats) > 1:
                has = [tangent(a) is not None for a in floats]
                if any(has) and not all(has):
                    args = tuple(type(a)(_dense(b) for b in a) if type(a) in (list, tuple)
                                 else _dense(a) for a in args)
        return func(*args, **kwargs)
