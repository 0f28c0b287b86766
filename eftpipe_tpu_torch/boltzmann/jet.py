"""Second-order (jet) helpers of the solver's Hessian.

The solver's second derivative is forward-mode, one pair of directions a
row: each quantity of the solve is carried as a jet (u, u_p, u_q, u_pq),
its value, its first-order parts in the directions p and q, and its mixed
part.  Between the kernels the stages are plain torch and :func:`jet_call`
takes their jets by nested forward AD (``torch.func.jvp``, which nests where
``torch.autograd.forward_ad`` levels do not): for a stage f at
u + s·u_p + t·u_q + s·t·u_pq, ∂/∂s, ∂/∂t and ∂²/∂s∂t at 0 are f'·u_p, f'·u_q
and f''[u_p, u_q] + f'·u_pq.  At a kernel the four parts are handed to its
hyper-dual instance on the card (``recomb_scan_jvp2``, ``eb_solve_jvp2``),
to its plain version on :class:`HyperDual` operands on the CPU.

:func:`pair_rows` lays the rows out: W·P(P+1)/2 a batch of W cosmologies and
P differentiated fields, row w·Q + k the k-th pair (p ≤ q) of cosmology w,
Q = P(P+1)/2; :func:`pair_index` maps a symmetric (p, q) to its pair.

The kernels' plain second-order versions run the plain recurrences
(``thermo.recomb_scan_plain``, ``einstein_boltzmann.eb_solve_plain``) on
:class:`HyperDual` operands: the same code, each operation carrying the four
parts of a jet by the rules of the kernels' hyper-dual scalar.  Nested
``torch.func.jvp`` gives the same numbers at 60–100× the plain loop's time
on the host (each operation of a step loop through two transform levels);
the hyper-dual operands take 6–10×.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Jet(NamedTuple):
    """The four parts of a jet, each a tuple of tensors of the same
    shapes: the value, the parts in the directions p and q, the mixed part."""

    v: tuple
    a: tuple
    b: tuple
    ab: tuple


def jet_call(f, jet: Jet) -> Jet:
    """The jet of ``f(*jet.v)`` (a tensor or a tuple of tensors; a tuple
    comes back for either): two nested ``torch.func.jvp``, the inner in the
    direction ``b``, the outer in ``a`` with ``ab`` the inner tangent's own
    part."""
    def first(x, y):
        return torch.func.jvp(lambda *z: _tuple(f(*z)), x, y)

    (out, out_b), (out_a, out_ab) = torch.func.jvp(first, (tuple(jet.v), tuple(jet.b)),
                                                   (tuple(jet.a), tuple(jet.ab)))
    return Jet(out, out_a, out_b, out_ab)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def pairs(p: int) -> list:
    """The P(P+1)/2 pairs (p, q), p ≤ q, in row order."""
    return [(i, j) for i in range(p) for j in range(i, p)]


def pair_index(p: int) -> torch.Tensor:
    """(P, P) int64: the pair of (i, j) and of (j, i)."""
    idx = torch.empty((p, p), dtype=torch.int64)
    for k, (i, j) in enumerate(pairs(p)):
        idx[i, j] = idx[j, i] = k
    return idx


def pair_rows(values: dict, names, like: torch.Tensor) -> tuple[dict, Jet]:
    """The W·P(P+1)/2 rows of a second-order pass over ``values`` (name →
    (W,) tensor) in the fields ``names`` (P of them): each value repeated
    once a pair, and the jet of the ``names`` fields, part a the indicator
    of the pair's p, part b of its q, the mixed part 0 (the fields are the
    pass's own coordinates).  Returns (every field's rows, the jet of the
    ``names`` fields in their order)."""
    pr = pairs(len(names))
    rows = {n: v.detach().repeat_interleave(len(pr)) for n, v in values.items()}
    nw = like.shape[0]
    ind = lambda side: [torch.tensor([float(pq[side] == i) for pq in pr], dtype=like.dtype,
                                     device=like.device).repeat(nw) for i in range(len(names))]
    zero = [torch.zeros(nw * len(pr), dtype=like.dtype, device=like.device) for _ in names]
    return rows, Jet(tuple(rows[n] for n in names), tuple(ind(0)), tuple(ind(1)), tuple(zero))


def hessian_of(mixed: torch.Tensor, nw: int, p: int) -> torch.Tensor:
    """(W·Q, ...) mixed parts of :func:`pair_rows`' rows as (W, P, P, ...),
    symmetric by construction."""
    q = p * (p + 1) // 2
    m = mixed.reshape(nw, q, *mixed.shape[1:])
    idx = pair_index(p).reshape(-1).to(mixed.device)
    return m[:, idx].reshape(nw, p, p, *mixed.shape[1:])


# ---------------------------------------------------------------------------
# hyper-dual operands: the plain recurrences' second order
# ---------------------------------------------------------------------------
def _dim(d):
    """An axis of a hyper-dual's tensor: its parts are the leading axis."""
    if isinstance(d, (tuple, list)):
        return type(d)(_dim(x) for x in d)
    return d + 1 if d >= 0 else d


def _lift(x):
    """(4, ...): a hyper-dual's parts; a floating tensor is a constant
    (itself in the value, 0 in the parts)."""
    if isinstance(x, HyperDual):
        return x.t
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z])


def _pad(t, nd: int):
    """A hyper-dual's (4, ...) tensor with its value's shape padded to ``nd``
    axes on the left, so that it broadcasts against a tensor of ``nd`` axes
    as its value would."""
    k = nd - (t.dim() - 1)
    return t.reshape(4, *([1] * k), *t.shape[1:]) if k > 0 else t


def _both(x, y):
    """The (4, ...) tensors of two hyper-duals, padded to one rank."""
    nd = max(x.t.dim(), y.t.dim()) - 1
    return _pad(x.t, nd), _pad(y.t, nd)


def _with(t, v=None, ab=None):
    """``t`` (4, ...) with its value replaced by ``v`` and ``ab`` added to its
    mixed part, in place."""
    if v is not None:
        t[0] = v
    if ab is not None:
        t[3] += ab
    return HyperDual.of(t)


def _add(x, y):
    if not isinstance(x, HyperDual):
        x, y = y, x
    if isinstance(y, HyperDual):
        xt, yt = _both(x, y)
        return HyperDual.of(xt + yt)
    if isinstance(y, torch.Tensor):
        xt = _pad(x.t, y.dim())
        t = xt.expand(4, *torch.broadcast_shapes(xt.shape[1:], y.shape)).clone()
    else:
        t = x.t.clone()
    t[0] += y
    return HyperDual.of(t)


def _neg(x):
    return HyperDual.of(-x.t)


def _sub(x, y):
    return _add(x, _neg(y)) if isinstance(y, HyperDual) else _add(x, -y)


def _mul(x, y):
    if isinstance(x, HyperDual) and isinstance(y, HyperDual):
        # (x y)_p = x_p y + x y_p, (x y)_pq = x_pq y + x_p y_q + x_q y_p + x y_pq
        xt, yt = _both(x, y)
        x0, x1, x2, _ = xt.unbind(0)
        y0, y1, y2, _ = yt.unbind(0)
        t = xt * y0 + x0 * yt
        t[0] *= 0.5  # 2 x y, exactly: the value x y
        t[3] += x1 * y2 + x2 * y1
        return HyperDual.of(t)
    if isinstance(y, HyperDual):
        x, y = y, x
    return HyperDual.of((_pad(x.t, y.dim()) if isinstance(y, torch.Tensor) else x.t) * y)


def _univariate(x, f0, f1, f2):
    """f(x) from f, f' and f'' at the value: f'·x_p, f'·x_q, f'·x_pq + f''·x_p·x_q."""
    _, x1, x2, _ = x.t.unbind(0)
    t = x.t * f1
    return _with(t, f0, f2 * x1 * x2)


def _reciprocal(y):
    r = 1.0 / y.t[0]
    return _univariate(y, r, -r * r, 2.0 * r * r * r)


def _div(x, y):
    if not isinstance(y, HyperDual):
        return HyperDual.of((_pad(x.t, y.dim()) if isinstance(y, torch.Tensor) else x.t) / y)
    q = _mul(_reciprocal(y), x)
    q.t[0] = (x.t[0] if isinstance(x, HyperDual) else x) / y.t[0]
    return q


def _pow(x, p):
    if not isinstance(p, (int, float)):
        raise NotImplementedError("HyperDual: only a number as the exponent")
    v = x.t[0]
    return _univariate(x, v ** p, p * v ** (p - 1), p * (p - 1) * v ** (p - 2))


def _sqrt(x):
    s = torch.sqrt(x.t[0])
    f1 = 0.5 / s
    return _univariate(x, s, f1, -0.5 * f1 / x.t[0])


def _exp(x):
    e = torch.exp(x.t[0])
    return _univariate(x, e, e, e)


def _clamp(x, min=None, max=None):
    """torch's clamp and its derivative: the parts pass where min ≤ value ≤
    max (a NaN keeps its value, its parts are 0)."""
    v = x.t[0]
    keep = None
    if min is not None:
        keep = v >= min
    if max is not None:
        keep = (v <= max) if keep is None else keep & (v <= max)
    t = torch.where(keep, x.t, torch.zeros((), dtype=v.dtype, device=v.device))
    return _with(t, torch.clamp(v, min, max))


def _lifted(fn, dim_default):
    """cat / stack of a list of operands along ``dim``."""
    def op(tensors, dim=dim_default):
        return HyperDual.of(fn([_lift(x) for x in tensors], _dim(dim)))
    return op


def _where(cond, x, y):
    xt, yt = _lift(x), _lift(y)
    nd = max(cond.dim(), xt.dim() - 1, yt.dim() - 1)
    return HyperDual.of(torch.where(cond, _pad(xt, nd), _pad(yt, nd)))


def _sum(x, dim, keepdim=False):
    return HyperDual.of(x.t.sum(_dim(dim), keepdim=keepdim))


def _index_copy(x, dim, index, source):
    return HyperDual.of(_lift(x).index_copy(_dim(dim), index, _lift(source)))


def _getitem(x, idx):
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not idx or idx[0] is not Ellipsis:
        idx = (slice(None),) + idx
    return HyperDual.of(x.t[idx])


def _sizes(args):
    return tuple(args[0]) if len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)) \
        else args


_RULES = {"add": _add, "sub": _sub, "mul": _mul, "div": _div, "sqrt": _sqrt, "exp": _exp,
          "clamp": _clamp, "cat": _lifted(torch.cat, 0), "stack": _lifted(torch.stack, 0),
          "where": _where, "sum": _sum, "index_copy": _index_copy}
_CONST = {"zeros_like": torch.zeros_like, "ones_like": torch.ones_like}


class HyperDual:
    """A tensor's value ``v``, its parts ``a`` and ``b`` in the directions p
    and q and its mixed part ``ab``, held as one (4, ...) tensor ``t``, for
    the torch code of the plain recurrences: torch's functions and the
    arithmetic dispatch here (``__torch_function__``), a linear operation on
    the four parts at once (an axis moved past the parts' axis), a nonlinear
    one by the hyper-dual rules (``csrc/boltzmann.cu``'s ``HD``), a
    comparison on the value; a ``*_like`` of one is a constant tensor.  An
    operation outside those raises."""

    __slots__ = ("t",)

    def __init__(self, v, a, b, ab):
        self.t = torch.stack([v, a, b, ab])

    @classmethod
    def of(cls, t):
        x = cls.__new__(cls)
        x.t = t
        return x

    @property
    def parts(self) -> tuple:
        return tuple(self.t.unbind(0))

    shape = property(lambda self: self.t.shape[1:])
    dtype = property(lambda self: self.t.dtype)
    device = property(lambda self: self.t.device)
    is_cuda = property(lambda self: self.t.is_cuda)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _RULES:
            return _RULES[name](*args, **kwargs)
        if name in _CONST:
            return _CONST[name](args[0].t[0], *args[1:], **kwargs)
        raise NotImplementedError(f"HyperDual: no rule for {name}")

    __add__ = __radd__ = _add
    __sub__ = _sub
    __rsub__ = lambda self, x: _sub(x, self)
    __mul__ = __rmul__ = _mul
    __truediv__ = _div
    __rtruediv__ = lambda self, x: _div(x, self)
    __pow__ = _pow
    __neg__ = _neg
    __gt__ = lambda self, c: self.t[0] > c  # a branch is decided on the value
    __getitem__ = _getitem
    sum = _sum
    index_copy = _index_copy

    def reshape(self, *shape):
        return HyperDual.of(self.t.reshape(4, *_sizes(shape)))

    def unbind(self, dim=0):
        return tuple(HyperDual.of(t) for t in self.t.unbind(_dim(dim)))

    def flatten(self, start_dim=0, end_dim=-1):
        return HyperDual.of(self.t.flatten(_dim(start_dim), _dim(end_dim)))


def hyper(jet: Jet) -> list:
    """The jet's tensors as :class:`HyperDual` operands."""
    return [HyperDual(*p) for p in zip(*jet)]


def as_jet(outs) -> Jet:
    """Outputs of a plain function on :class:`HyperDual` operands as a jet
    (an output that no operand reached: its parts 0)."""
    parts = [o.parts if isinstance(o, HyperDual) else _lift(o).unbind(0) for o in outs]
    return Jet(*(tuple(p) for p in zip(*parts)))
