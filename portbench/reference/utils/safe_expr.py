"""AST-whitelisted evaluation of config expression strings (counterpart of
``eftpipe_tpu/utils/safe_expr.py``).

Upstream evals prior/param lambda strings straight from YAML
(eftpipe/marginal.py:13-19, "eval_callable").  Here the expression is
*parsed* and validated against a whitelist of AST nodes before compilation:

* arithmetic / comparisons / boolean ops / conditional expressions,
* calls and attribute chains rooted at ``np``/``jnp``/``torch`` (never
  reaching an underscore-prefixed attribute),
* names bound by the lambda itself, plus ``abs``/``min``/``max``.

Anything else (imports, dunder access, walrus, comprehensions, f-strings,
...) raises ``UnsafeExpressionError`` at config load time.

``np``, ``jnp`` and ``torch`` are all bound to :data:`NAMESPACE`, one small
namespace whose functions dispatch on their arguments: to ``torch`` when any
argument is a tensor (a (W,) parameter batch on the card stays there), to
NumPy on Python numbers.  So ``lambda c2, c4: (c2 + c4) / np.sqrt(2.)``
works on a (W,) tensor and on a float.
"""

from __future__ import annotations

import ast

import numpy as np
import torch


class UnsafeExpressionError(ValueError):
    """A config expression used syntax outside the whitelisted grammar."""


_ALLOWED_NODES = (
    ast.Expression, ast.Lambda, ast.arguments, ast.arg,
    ast.Name, ast.Load, ast.Constant, ast.keyword,
    ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.And, ast.Or, ast.Not,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq,
    ast.Call, ast.Attribute, ast.Tuple, ast.List, ast.Subscript, ast.Slice,
)

_MODULE_ROOTS = ("np", "jnp", "torch")
_SAFE_BUILTINS = {"abs": abs, "min": min, "max": max}

# NumPy name → torch name where they differ
_TORCH_NAME = {"arcsin": "asin", "arccos": "acos", "arctan": "atan", "arctan2": "atan2",
               "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
               "power": "pow", "absolute": "abs", "clip": "clamp"}
_FUNCTIONS = ("sqrt", "exp", "log", "log10", "log2", "log1p", "expm1", "sin", "cos", "tan",
              "sinh", "cosh", "tanh", "abs", "sign", "floor", "ceil", "square",
              "where", "minimum", "maximum", "isfinite", "isnan", "isinf", *_TORCH_NAME)
_SEQUENCE_FUNCTIONS = ("asarray", "array", "stack")
_CONSTANTS = {"pi": np.pi, "e": np.e, "inf": np.inf, "nan": np.nan}


def _dispatch(name: str):
    np_fn = getattr(np, name)
    torch_fn = getattr(torch, _TORCH_NAME.get(name, name))

    def fn(*args, **kwargs):
        tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
        if not tensors:
            return np_fn(*args, **kwargs)
        if name in ("minimum", "maximum", "where"):
            # numbers beside a tensor become tensors made by a fill kernel on
            # its device: a number copied to the card would synchronise
            like = tensors[0]
            args = tuple(a if isinstance(a, torch.Tensor) else torch.full_like(like, a)
                         for a in args)
        return torch_fn(*args, **kwargs)

    fn.__name__ = name
    return fn


def _dispatch_sequence(name: str):
    """``asarray``/``array``/``stack`` of a sequence: ``torch.stack`` when
    an element is a tensor (numbers become fills on its device)."""
    np_fn = getattr(np, name)

    def fn(seq, *args, **kwargs):
        tensors = [x for x in seq if isinstance(x, torch.Tensor)]
        if not tensors:
            return np_fn(seq, *args, **kwargs)
        like = tensors[0]
        return torch.stack([x if isinstance(x, torch.Tensor) else torch.full_like(like, x)
                            for x in seq], *args, **kwargs)

    fn.__name__ = name
    return fn


class _Linalg:
    """``np.linalg`` inside a config expression: ``norm`` only."""

    def __init__(self):
        self.norm = _dispatch_linalg_norm


def _dispatch_linalg_norm(x, *args, **kwargs):
    if isinstance(x, torch.Tensor):
        return torch.linalg.norm(x, *args, **kwargs)
    return np.linalg.norm(x, *args, **kwargs)


class _Namespace:
    """``np``/``jnp``/``torch`` inside a config expression."""

    def __init__(self):
        for name in _FUNCTIONS:
            setattr(self, name, _dispatch(name))
        for name in _SEQUENCE_FUNCTIONS:
            setattr(self, name, _dispatch_sequence(name))
        self.linalg = _Linalg()
        for name, value in _CONSTANTS.items():
            setattr(self, name, value)

    def __getattr__(self, name):
        raise AttributeError(
            f"{name!r} is not available in config expressions (functions: "
            f"{', '.join(sorted(_FUNCTIONS + _SEQUENCE_FUNCTIONS))}, linalg.norm; "
            f"constants: {', '.join(_CONSTANTS)})")


NAMESPACE = _Namespace()


def _check(node: ast.AST, bound: set[str]) -> None:
    if not isinstance(node, _ALLOWED_NODES):
        raise UnsafeExpressionError(
            f"disallowed syntax {type(node).__name__!r} in config expression"
        )
    if isinstance(node, ast.Attribute):
        # attribute chains must root at np/jnp/torch and never touch _names
        base = node
        while isinstance(base, ast.Attribute):
            if base.attr.startswith("_"):
                raise UnsafeExpressionError(
                    f"underscore attribute {base.attr!r} is not allowed"
                )
            base = base.value
        if not (isinstance(base, ast.Name) and base.id in _MODULE_ROOTS):
            raise UnsafeExpressionError(
                "attribute access is only allowed on np/jnp/torch"
            )
    if isinstance(node, ast.Lambda):
        a = node.args
        if a.vararg or a.kwarg or a.posonlyargs or a.kwonlyargs:
            raise UnsafeExpressionError(
                "only plain positional lambda arguments are allowed"
            )
        inner = bound | {arg.arg for arg in a.args}
        for child in ast.iter_child_nodes(node):
            _check(child, inner)
        return
    if isinstance(node, ast.Name):
        allowed = bound | set(_MODULE_ROOTS) | set(_SAFE_BUILTINS)
        if node.id not in allowed:
            raise UnsafeExpressionError(
                f"name {node.id!r} is not defined in the expression scope"
            )
    for child in ast.iter_child_nodes(node):
        _check(child, bound)


def safe_eval_expr(expr: str):
    """Validate + evaluate a config expression string (typically a lambda).

    Returns the resulting Python object (usually a function closing only
    over :data:`NAMESPACE`).  Raises :class:`UnsafeExpressionError` on any
    syntax or name outside the whitelist.
    """
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise UnsafeExpressionError(f"invalid config expression: {e}") from e
    _check(tree, set())
    code = compile(tree, "<config-expr>", "eval")
    # the AST whitelist is the security boundary: the compiled code can only
    # reference validated names, and the frame has no builtins beyond these
    env = {"__builtins__": {}, **{root: NAMESPACE for root in _MODULE_ROOTS},
           **_SAFE_BUILTINS}
    return eval(code, env)  # noqa: S307 — grammar validated above
