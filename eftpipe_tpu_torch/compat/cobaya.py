"""Convert an upstream-style Cobaya config into this package's config
(counterpart of ``eftpipe_tpu/compat/cobaya.py``).

Upstream is driven by Cobaya: an ``eftpipe.eftlss`` theory block with
per-tracer sub-dicts, one or more ``eftpipe.eftlike`` likelihood blocks and a
Cobaya ``params`` block.  ``convert_cobaya_config`` maps all of that onto the
:mod:`eftpipe_tpu_torch.api.orchestrate` schema, so an existing run config
migrates with one call::

    from eftpipe_tpu_torch.compat import convert_cobaya_config
    from eftpipe_tpu_torch.api.orchestrate import Analysis

    info = convert_cobaya_config(cobaya_info)      # a dict, or a YAML path
    an = Analysis.from_config(info, dtype=torch.float32)

What is translated
------------------
* tracer blocks: z/km/kr/nd/basis/prefix/cross, the ``with_X`` switches
  merged with their ``X:`` option dicts (APeffect, window incl.
  window_fourier_file, icc, fiber), with_NNLO/with_RSD
* likelihood blocks: data paths + ls/kmin/kmax masks, cov (path/rescale/
  Nreal → Hartlap), chained (scalar/list/dict), with_binning, marg, jeffreys
* params: Cobaya priors/refs; the standard cosmology renames
  omegabh2→omega_b, omegach2→omega_cdm, H0→h (values ÷100), logA→ln10As;
  ``value:`` floats become fixed params; lambda-valued entries become
  computed parameters (their arguments renamed the same way); latex-only
  (derived) entries are dropped

What is NOT translated
----------------------
* the Boltzmann provider: CLASS/CAMB are host codes; the converted config
  defaults to the on-device EH98 provider (pass ``boltzmann=...`` to
  override with fixed_template / tabulated / emulator / solver_emulator)
* sampler settings (use ``Analysis.run_mcmc``)

One difference from the JAX function: a lambda string is checked against
the AST whitelist of ``utils/safe_expr.py`` (the JAX function ``eval``\\ s
it); one that the whitelist refuses is dropped with a warning, as an
unparseable one is.  PyYAML is imported only to read a path.
"""

from __future__ import annotations

import ast
import copy
import inspect
import warnings
from pathlib import Path
from typing import Any, Mapping

from ..utils.safe_expr import UnsafeExpressionError, safe_eval_expr

COSMO_RENAMES = {
    "omegabh2": "omega_b",
    "ombh2": "omega_b",
    "omegach2": "omega_cdm",
    "omch2": "omega_cdm",
    "logA": "ln10As",
    "nns": "ns",
}

_PLUGINS = ("IRresum", "APeffect", "window", "icc", "fiber")


def _load(src) -> dict:
    """A mapping is deep-copied; a path is read with PyYAML (imported here
    only: a dict needs none)."""
    if isinstance(src, Mapping):
        return copy.deepcopy(dict(src))
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the Cobaya YAML {src} needs PyYAML, which is not installed; "
            "give the config as a dict") from e
    with open(src) as f:
        return yaml.safe_load(f)


def _convert_tracer(tcfg: Mapping[str, Any]) -> dict:
    out: dict[str, Any] = {}
    for key in ("z", "km", "kr", "nd", "basis", "prefix", "cross",
                "with_NNLO", "with_RSD"):
        if key in tcfg:
            out[key] = copy.deepcopy(tcfg[key])
    for plug in _PLUGINS:
        flag = tcfg.get(f"with_{plug}")
        opts = tcfg.get(plug)
        if flag is None and opts is None:
            continue
        if flag is False:
            out[f"with_{plug}"] = False
        elif opts is not None:
            out[f"with_{plug}"] = dict(opts)
        else:
            out[f"with_{plug}"] = bool(flag)
    return out


def _convert_params(params: Mapping[str, Any]) -> dict:
    out: dict[str, Any] = {}
    lambdas: dict[str, str] = {}
    for name, spec in (params or {}).items():
        new = COSMO_RENAMES.get(name, name)
        scale = 0.01 if name == "H0" else 1.0
        if name == "H0":
            new = "h"
        if not isinstance(spec, Mapping):
            if isinstance(spec, str):
                lambdas[new] = spec
                continue
            out[new] = float(spec) * scale
            continue
        if "prior" in spec:
            prior = dict(spec["prior"])
            if "min" in prior:
                prior = {"min": float(prior["min"]) * scale,
                         "max": float(prior["max"]) * scale}
            elif prior.get("dist") == "norm":
                prior = {"dist": "norm", "loc": float(prior["loc"]) * scale,
                         "scale": float(prior["scale"]) * scale}
            entry: dict[str, Any] = {"prior": prior}
            if "ref" in spec:
                ref = spec["ref"]
                ref = ref.get("loc") if isinstance(ref, Mapping) else ref
                entry["ref"] = float(ref) * scale
            out[new] = entry
        elif "value" in spec:
            v = spec["value"]
            if isinstance(v, str):
                lambdas[new] = v
                continue
            out[new] = float(v) * scale
        # else latex-only: a Cobaya derived parameter, not sampled here
    # keep lambda-valued ("derived input") params whose arguments survive the
    # conversion (the production configs' c2/c4 -> b2/b4 mapping), with
    # arguments that name a renamed cosmology param rewritten
    for name, expr in lambdas.items():
        try:
            expr = _rename_lambda_args(expr)
            args = inspect.getfullargspec(safe_eval_expr(expr)).args
        except (SyntaxError, TypeError, UnsafeExpressionError):
            warnings.warn(f"dropping unparseable lambda param {name!r}")
            continue
        if all(a in out or a in lambdas for a in args):
            out[name] = {"value": expr}
        else:
            warnings.warn(
                f"dropping lambda-valued param {name!r} (inputs {args} not all"
                " available after conversion)"
            )
    return out


def _rename_lambda_args(expr: str) -> str:
    """Rewrite a Cobaya lambda string's argument names through the standard
    cosmology renames so the lambda stays evaluable after conversion.

    ``lambda logA: 1e-10*np.exp(logA)`` → ``lambda ln10As: ...(ln10As)``
    (logA ≡ ln(10¹⁰ As) ≡ ln10As, so the rename keeps the value); an ``H0``
    argument becomes ``h`` with every use replaced by ``100 * h``.
    Non-lambda strings and lambdas without renamed args pass through
    unchanged."""
    tree = ast.parse(expr, mode="eval")
    if not isinstance(tree.body, ast.Lambda):
        return expr
    lam = tree.body
    subst: dict[str, ast.expr] = {}
    for arg in lam.args.args:
        old = arg.arg
        if old == "H0":
            arg.arg = "h"
            subst[old] = ast.BinOp(
                left=ast.Constant(100.0), op=ast.Mult(),
                right=ast.Name(id="h", ctx=ast.Load()),
            )
        elif old in COSMO_RENAMES:
            new = COSMO_RENAMES[old]
            arg.arg = new
            subst[old] = ast.Name(id=new, ctx=ast.Load())
    if not subst:
        return expr

    class _Sub(ast.NodeTransformer):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Load) and node.id in subst:
                return ast.copy_location(copy.deepcopy(subst[node.id]), node)
            return node

    lam.body = ast.fix_missing_locations(_Sub().visit(lam.body))
    return ast.unparse(tree)


def convert_cobaya_config(src, data_root=None, boltzmann: Mapping | None = None,
                          cache_dir=None) -> dict:
    """Upstream Cobaya config (a mapping, or a YAML path) → orchestrate-schema
    dict.

    data_root: base directory for the relative data/window/cov paths in the
    original config (upstream resolves them against the cobaya/ cwd).
    """
    info = _load(src)
    root = Path(data_root) if data_root is not None else None

    def fix_path(x):
        if root is not None and isinstance(x, (str, Path)):
            p = Path(x)
            return str(p if p.is_absolute() else root / p)
        return str(x) if isinstance(x, Path) else x

    # ---- theory ---------------------------------------------------------
    theory_block = None
    for key, val in (info.get("theory") or {}).items():
        if key.endswith("eftlss") and isinstance(val, Mapping):
            theory_block = val
            break
    if theory_block is None:
        raise ValueError("no eftpipe.eftlss theory block found")
    tracers = {
        name: _convert_tracer(tcfg or {})
        for name, tcfg in (theory_block.get("tracers") or {}).items()
    }
    for tcfg in tracers.values():
        for plug in ("with_window", "with_icc"):
            opts = tcfg.get(plug)
            if isinstance(opts, Mapping):
                for pk in ("window_fourier_file", "window_configspace_file",
                           "icc_configspace_SN_file", "icc_configspace_IC_file"):
                    if pk in opts:
                        opts[pk.replace("SN_file", "sn_file").replace(
                            "IC_file", "ic_file")] = fix_path(opts.pop(pk))
        if boltzmann is not None:
            tcfg["boltzmann"] = dict(boltzmann)

    out: dict[str, Any] = {
        "theory": {
            "cache_dir": cache_dir or theory_block.get("cache_dir_path"),
            "tracers": tracers,
        }
    }

    # ---- likelihood -----------------------------------------------------
    like_blocks = []
    for name, val in (info.get("likelihood") or {}).items():
        if isinstance(val, Mapping) and ("tracers" in val and "data" in val):
            like_blocks.append((name, val))

    def convert_block(lk: Mapping) -> dict:
        data = {}
        for t, d in (lk.get("data") or {}).items():
            d = dict(d)
            d["path"] = fix_path(d["path"])
            data[t] = d
        cov = lk.get("cov")
        if isinstance(cov, Mapping):
            cov = dict(cov)
            cov["path"] = (
                [fix_path(p) for p in cov["path"]]
                if isinstance(cov["path"], (list, tuple))
                else fix_path(cov["path"])
            )
        else:
            cov = fix_path(cov)
        order = list(lk.get("tracers") or data)
        chained = lk.get("chained", False)
        if isinstance(chained, (list, tuple)):
            chained = dict(zip(order, chained))
        binned = lk.get("with_binning", lk.get("binned", True))
        if isinstance(binned, (list, tuple)):
            binned = dict(zip(order, binned))
        return {
            "tracers": order,
            "data": data,
            "cov": cov,
            "chained": chained,
            "binned": binned,
            "marg": lk.get("marg"),
            "jeffreys": bool(lk.get("jeffreys", False)),
        }

    if len(like_blocks) == 1:
        out["likelihood"] = convert_block(like_blocks[0][1])
    elif like_blocks:
        # independent blocks (NGC + SGC in the production configs): their
        # log-likelihoods add — Analysis takes named blocks
        out["likelihood"] = {name: convert_block(lk) for name, lk in like_blocks}

    out["params"] = _convert_params(info.get("params"))
    return out
