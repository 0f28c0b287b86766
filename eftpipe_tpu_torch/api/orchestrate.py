"""Config-driven multi-tracer analysis builder — the ``EFTLSS`` analogue
(counterpart of ``eftpipe_tpu/api/orchestrate.py``).

Upstream wires its pipeline through Cobaya: a root Theory parses the
``tracers:`` block (merging a ``default`` sub-block and validating ``cross``
references, eftpipe/theory.py:126-156), spawns per-tracer helper theories,
and an ``EFTLike`` likelihood consumes their products (likelihood.py:
275-473).  Here the same declarative config — a plain dict, a JSON file or a
YAML file — builds a self-contained :class:`Analysis`: per-tracer Phase-A
pipelines + cosmology providers + parameter bases + the multi-tracer
likelihood + the sampled-parameter prior, fused into one batched
``logp(thetas)``: a walker batch (W, ndim) → (W,) on the device.

The config schema is the JAX package's (its module docstring).  Sampled
parameters are those with a ``prior``; the rest are fixed or computed
(Cobaya-style lambda strings, evaluated on (W,) tensors).  The prior enters
``logp`` (uniform → hard bounds, norm → Gaussian).

Differences from the JAX module, all of the kind "switches are arguments":
``from_config(src, dtype=, device=, quadform=, lowrank_tol=, cf_premix=)``
takes the dtype explicitly (default float64, as ``build_flagship``; the CLI
defaults to float32, as the JAX CLI), the device (the card unless
``device="cpu"``) and the quadratic forms' route ("kernel", "plain", or
"lowrank" with its cut and CF premix: the JAX package's
``EFTPIPE_TPU_LOWRANK*`` / ``EFTPIPE_TPU_CF_PREMIX``); ``run_mcmc`` seeds a
``torch.Generator``; the ``solver`` provider solves on the analysis' device
(float64, cast to the analysis' dtype); ``run_mcmc(mesh=)`` takes a
``parallel/mesh.py::WalkerMesh`` (one process per card) on the analysis'
device.
"""

from __future__ import annotations

import copy
import inspect
import json
import logging
import math
import time as _time
import numpy as np
import torch
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from .. import resolve_device
from ..models.config import EFTConfig
from ..models.pipeline import TracerPipeline, CosmoInputs
from ..likelihood.likelihood import EFTLikelihood, TracerSpec
from ..likelihood.parambasis import find_param_basis
from ..boltzmann.eh98 import EisensteinHuProvider
from ..boltzmann.providers import FixedTemplateProvider, TabulatedProvider
from ..models.ap import lcdm_da, lcdm_hubble
from ..models.nonlinear import LOWRANK_TOL
from ..utils.dicttools import recursively_update_dict
from . import products as _products

log = logging.getLogger("eftpipe_tpu_torch.orchestrate")


# ----------------------------------------------------------------------
# config parsing
# ----------------------------------------------------------------------
def load_config(src) -> dict:
    """dict passthrough, or a JSON / YAML file path.  For file configs,
    relative data paths resolve against the config's directory.  A ``.json``
    file is read with ``json`` (JSON is a subset of YAML); any other file
    needs PyYAML, imported only here."""
    if isinstance(src, Mapping):
        return copy.deepcopy(dict(src))
    path = Path(src)
    if path.suffix.lower() == ".json":
        info = json.loads(path.read_text())
    else:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"reading the YAML config {path} needs PyYAML, which is not "
                "installed; give the config as a dict or a .json file") from e
        with open(path) as f:
            info = yaml.safe_load(f)
    _resolve_paths(info, path.resolve().parent)
    return info


_PATH_KEYS = {
    "path", "window_configspace_file", "window_fourier_file",
    "icc_configspace_sn_file", "icc_configspace_ic_file", "cache_dir",
}


def _resolve_paths(node, base: Path) -> None:
    """Rewrite relative path-valued entries (recognised keys) to absolute
    paths under ``base`` when the target exists there."""
    if isinstance(node, Mapping):
        for key, val in node.items():
            direct = key in _PATH_KEYS or (
                key == "cov" and isinstance(val, (str, Path, list, tuple))
            )
            if direct:
                if isinstance(val, (list, tuple)):
                    node[key] = [_resolve_one(v, base) for v in val]
                else:
                    node[key] = _resolve_one(val, base)
            else:
                _resolve_paths(val, base)
    elif isinstance(node, list):
        for item in node:
            _resolve_paths(item, base)


def _resolve_one(val, base: Path):
    if not isinstance(val, (str, Path)):
        return val
    p = Path(val)
    if p.is_absolute():
        return str(p)
    cand = base / p
    if cand.exists() or not p.exists():
        return str(cand)
    return str(p)


def merge_tracer_configs(tracers: Mapping[str, Any]) -> dict[str, dict]:
    """Apply the ``default`` block to every tracer (theory.py:133-139) and
    validate ``cross`` references (theory.py:143-152)."""
    tracers = copy.deepcopy(dict(tracers))
    default = tracers.pop("default", {}) or {}
    out: dict[str, dict] = {}
    for name, cfg in tracers.items():
        merged = copy.deepcopy(default)
        recursively_update_dict(merged, cfg or {})
        out[name] = merged
    for name, cfg in out.items():
        cross = cfg.get("cross")
        if cross:
            if len(cross) != 2:
                raise ValueError(f"tracer {name}: cross must list exactly 2 tracers")
            for ref in cross:
                if ref not in out:
                    raise ValueError(
                        f"tracer {name}: cross reference {ref!r} not defined"
                    )
                if out[ref].get("cross"):
                    raise ValueError(f"tracer {name}: cannot cross a cross tracer")
    return out


def _plugin_opts(x, **renames) -> dict | None:
    """normalize bool-or-dict plugin switches; rename upstream-style keys."""
    if not x:
        return None
    opts = dict(x) if isinstance(x, Mapping) else {}
    for old, new in renames.items():
        if old in opts:
            opts[new] = opts.pop(old)
    return opts


def build_tracer(
    name: str,
    tcfg: Mapping[str, Any],
    cross_partners: tuple[Mapping, Mapping] | None = None,
    cache_dir=None,
    device=None,
    dtype=torch.float64,
    quadform: str = "kernel",
    lowrank_tol: float = LOWRANK_TOL,
    cf_premix: bool = True,
):
    """(EFTConfig, TracerPipeline, provider, basis) from one tracer block."""
    zeff = float(tcfg.get("z", tcfg.get("zeff", 0.5)))
    ls = list(tcfg.get("ls", [0, 2]))
    nl = max(ls) // 2 + 1
    basis_name = tcfg.get("basis", "westcoast")
    basis_cls = find_param_basis(basis_name)

    if cross_partners is not None:
        a, b = cross_partners
        km_a, kr_a, nd_a = a.get("km", 0.7), a.get("kr", 0.25), a.get("nd", 3e-4)
        km_b, kr_b, nd_b = b.get("km", 0.7), b.get("kr", 0.25), b.get("nd", 3e-4)
    else:
        km_a, kr_a, nd_a = tcfg.get("km", 0.7), tcfg.get("kr", 0.25), tcfg.get("nd", 3e-4)
        km_b = kr_b = nd_b = None

    cfg = EFTConfig(
        nl=max(nl, 2),
        no=nl,
        km_a=km_a, kr_a=kr_a, nd_a=nd_a,
        km_b=km_b, kr_b=kr_b, nd_b=nd_b,
        with_nnlo=bool(tcfg.get("with_NNLO", False)),
        counterform=getattr(basis_cls, "counterform", "westcoast"),
        optiresum=bool(
            isinstance(tcfg.get("with_IRresum"), Mapping)
            and tcfg["with_IRresum"].get("optiresum", False)
        ),
    )

    irresum = tcfg.get("with_IRresum", True)
    if isinstance(irresum, Mapping):
        irresum = {k: v for k, v in irresum.items() if k != "optiresum"} or True
    ap = _plugin_opts(
        tcfg.get("with_APeffect"),
        Om_AP="om_ap", z_AP="z_ap", rdrag_AP="rdrag_ap", h_AP="hubble_ap",
        APst="ap_st",
    )
    if ap is not None and "da_fid" not in ap:
        # the fiducial AP redshift defaults to the tracer's z (theory.py:363-364)
        ap.setdefault("z_ap", zeff)
    window = _plugin_opts(tcfg.get("with_window"), Nmax="nmax")
    icc = _plugin_opts(tcfg.get("with_icc"), Pshot="pshot")
    fiber = _plugin_opts(tcfg.get("with_fiber"), Dfc="dfc", fiberst="fiber_st")

    pipe = TracerPipeline.build(
        cfg,
        zeff=zeff,
        with_irresum=irresum,
        apeffect=ap,
        window=window,
        icc=icc,
        fiber=fiber,
        with_rsd=bool(tcfg.get("with_RSD", True)),
        cache_dir=cache_dir,
        device=device,
        dtype=dtype,
        quadform=quadform,
        lowrank_tol=lowrank_tol,
        cf_premix=cf_premix,
    )

    prefix = tcfg.get("prefix", name + "_")
    if cross_partners is not None:
        prefixes = [
            p.get("prefix", n + "_")
            for n, p in zip(tcfg["cross"], cross_partners)
        ]
        basis = basis_cls(prefix=prefix, cross_prefix=prefixes)
    else:
        basis = basis_cls(prefix=prefix)

    provider = build_provider(tcfg.get("boltzmann", {"name": "eh98"}), cfg, zeff, device=device)
    return cfg, pipe, provider, basis


def build_provider(bcfg: Mapping[str, Any], cfg: EFTConfig, zeff: float, device=None):
    """The cosmology provider of a tracer's ``boltzmann`` block; ``device``
    is where the ``solver`` provider solves (the card unless ``"cpu"``)."""
    bcfg = dict(bcfg or {})
    name = bcfg.pop("name", "eh98")
    if name == "eh98":
        om_fid = bcfg.pop("om_fid", 0.31)
        return EisensteinHuProvider(
            cfg=cfg, zeff=zeff,
            da_fid=lcdm_da(om_fid, zeff), h_fid=lcdm_hubble(om_fid, zeff),
            **bcfg,
        )
    if name == "fixed_template":
        return FixedTemplateProvider.from_file(cfg, **bcfg)
    if name == "tabulated":
        return TabulatedProvider(cfg=cfg, **bcfg)
    if name == "emulator":
        # a trained transfer-function MLP (``TransferEmulator.save`` file)
        from ..boltzmann.emulator import EmulatorProvider

        return EmulatorProvider.load(cfg=cfg, zeff=zeff, **bcfg)
    if name == "solver":
        # a full Einstein-Boltzmann solve per evaluation: the Boltzmann-grade
        # oracle (for gates and training; the emulators are for sampling)
        from ..boltzmann.einstein_boltzmann import SolverProvider

        om_fid = bcfg.pop("om_fid", None)
        if om_fid is not None:
            bcfg.setdefault("da_fid", lcdm_da(om_fid, zeff))
            bcfg.setdefault("h_fid", lcdm_hubble(om_fid, zeff))
        bcfg.setdefault("device", device)
        return SolverProvider(cfg=cfg, zeff=zeff, **bcfg)
    if name == "solver_emulator":
        # trained PCA + polynomial-ridge emulator of the Einstein-Boltzmann
        # solver — the production Boltzmann-grade provider
        from ..boltzmann.emulator import SolverEmulatorProvider

        om_fid = bcfg.pop("om_fid", 0.31)
        return SolverEmulatorProvider.load(
            cfg=cfg, zeff=zeff,
            da_fid=bcfg.pop("da_fid", lcdm_da(om_fid, zeff)),
            h_fid=bcfg.pop("h_fid", lcdm_hubble(om_fid, zeff)),
            **bcfg,
        )
    if "." in name:
        # dotted-path extension point, mirroring upstream's
        # find_boltzmann_extractor (boltzmann.py:351-363)
        import importlib

        module_name, cls_name = name.rsplit(".", 1)
        provider_cls = getattr(importlib.import_module(module_name), cls_name)
        return provider_cls(cfg=cfg, zeff=zeff, **bcfg)
    raise ValueError(f"unknown boltzmann provider {name!r}")


def _validate_emulator_boxes(providers, space, log) -> None:
    """Check sampled/fixed cosmology priors against each emulator provider's
    training box at build time: out-of-box proposals are rejected with
    logp = −inf, so the user must learn *now* if a prior reaches past the
    box — or sits entirely outside it."""
    checked = set()
    for tracer, prov in providers.items():
        emu = getattr(prov, "emulator", None)
        if emu is None or not hasattr(emu, "box"):
            continue
        lo, hi = emu.box()
        names = tuple(getattr(emu, "input_names", ()))
        key = (tuple(np.round(np.asarray(lo), 12)), names)
        if key in checked:
            continue
        checked.add(key)
        deg = float(getattr(emu, "deg_ncdm", None) or 1.0)
        if "m_ncdm" not in names:
            # 3-input artifact: the neutrino mass is baked in, NOT an
            # emulator dimension — a config that samples it would run a
            # chain whose mnu posterior is just the prior
            sampled = [p for p in ("mnu", "m_ncdm") if p in space.priors]
            if sampled:
                raise ValueError(
                    f"config samples {sampled} but the emulator artifact has"
                    f" no m_ncdm input (input_names={names}, tracer"
                    f" {tracer}): the sampled mass would never enter the"
                    f" spectra. Retrain with --sample-mnu (4-input artifact)"
                    f" or fix the mass."
                )
            stored = getattr(emu, "mnu_total", lambda: None)()
            for p in ("mnu", "m_ncdm"):
                if p in space.fixed and stored is not None:
                    want = float(space.fixed[p]) * (1.0 if p == "mnu" else deg)
                    if abs(want - stored) > 1e-8:
                        raise ValueError(
                            f"config fixes {p}={space.fixed[p]} (Σm_ν="
                            f"{want}) but the 3-input emulator artifact was"
                            f" trained at Σm_ν={stored} (tracer {tracer}):"
                            f" the fixed value would be silently ignored."
                            f" Retrain with --sample-mnu or match the"
                            f" artifact's mass."
                        )
        for i, name in enumerate(names):
            # 4-input artifacts sample the PER-SPECIES mass; a config may
            # instead fix/sample the total Σm_ν as "mnu" — check that axis
            # against the box rescaled by deg_ncdm
            pname, scale = name, 1.0
            if (name == "m_ncdm" and name not in space.fixed
                    and name not in space.priors
                    and ("mnu" in space.fixed or "mnu" in space.priors)):
                pname, scale = "mnu", 1.0 / deg
            if pname in space.fixed:
                v = space.fixed[pname] * scale
                if not (lo[i] <= v <= hi[i]):
                    raise ValueError(
                        f"fixed {pname}={space.fixed[pname]} ({name}={v}) "
                        f"lies outside the emulator training"
                        f" box [{lo[i]}, {hi[i]}] (tracer {tracer}): every"
                        f" evaluation would be rejected — retrain the"
                        f" artifact or fix the config"
                    )
            elif pname in space.priors:
                spec = space.priors[pname]
                if spec.get("dist", "uniform") == "norm":
                    plo = spec["loc"] - 5.0 * spec["scale"]
                    phi = spec["loc"] + 5.0 * spec["scale"]
                else:
                    plo, phi = spec["min"], spec["max"]
                plo, phi = plo * scale, phi * scale
                if phi < lo[i] or plo > hi[i]:
                    raise ValueError(
                        f"prior of {name} ([{plo}, {phi}]) lies entirely"
                        f" outside the emulator training box"
                        f" [{lo[i]}, {hi[i]}] (tracer {tracer})"
                    )
                if plo < lo[i] or phi > hi[i]:
                    log.warning(
                        "prior of %s ([%g, %g]) extends beyond the emulator "
                        "training box [%g, %g] (tracer %s): proposals outside "
                        "the box get logp = -inf (explicit rejection; the "
                        "posterior is effectively truncated there). Retrain "
                        "with a wider box if posterior mass lives near the "
                        "edge.", name, plo, phi, lo[i], hi[i], tracer,
                    )


# ----------------------------------------------------------------------
# sampled-parameter handling
# ----------------------------------------------------------------------
def _compile_lambda(expr: str):
    """Compile a Cobaya-style ``"lambda a, b: ..."`` value string into a
    function of the parameter dict.  The string is parsed against the AST
    whitelist of ``utils/safe_expr.py``, so a loaded third-party config
    cannot reach the interpreter; inside it ``np`` dispatches to torch on
    (W,) tensors."""
    from ..utils.safe_expr import safe_eval_expr

    fn = safe_eval_expr(expr)
    argnames = inspect.getfullargspec(fn).args
    return argnames, (lambda params: fn(*(params[a] for a in argnames)))


@dataclass(eq=False)
class ParamSpace:
    """Split a ``params:`` block into sampled / fixed / computed, with
    batched priors.  Computed parameters are Cobaya-style lambda strings
    ("derived inputs", e.g. the production configs' c2/c4 → b2/b4 mapping)
    evaluated on the walkers' (W,) tensors inside ``logp``."""

    sampled: list[str]
    fixed: dict[str, float]
    priors: dict[str, dict]
    refs: dict[str, float]
    computed: dict[str, Any] = field(default_factory=dict)
    # (device, dtype) → the prior's constants as tensors, made once: a number
    # put on the card inside logp is a copy that synchronises the stream
    _consts: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_config(cls, params: Mapping[str, Any]) -> "ParamSpace":
        sampled, fixed, priors, refs, computed = [], {}, {}, {}, {}
        for name, spec in (params or {}).items():
            if isinstance(spec, Mapping) and "prior" in spec:
                sampled.append(name)
                priors[name] = dict(spec["prior"])
                if "ref" in spec:
                    refs[name] = float(spec["ref"])
                elif "loc" in priors[name]:
                    refs[name] = float(priors[name]["loc"])
                else:
                    refs[name] = 0.5 * (
                        float(priors[name]["min"]) + float(priors[name]["max"])
                    )
            elif isinstance(spec, Mapping) and "value" in spec:
                if isinstance(spec["value"], str):
                    computed[name] = _compile_lambda(spec["value"])
                else:
                    fixed[name] = float(spec["value"])
            elif isinstance(spec, str):
                computed[name] = _compile_lambda(spec)
            else:
                fixed[name] = float(spec)
        return cls(sampled=sampled, fixed=fixed, priors=priors, refs=refs,
                   computed=computed)

    @property
    def ndim(self) -> int:
        return len(self.sampled)

    def theta0(self) -> np.ndarray:
        return np.array([self.refs[p] for p in self.sampled])

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) support of the sampled parameters (±inf for norm)."""
        lo, hi = [], []
        for p in self.sampled:
            spec = self.priors[p]
            if spec.get("dist", "uniform") == "norm":
                lo.append(-np.inf)
                hi.append(np.inf)
            else:
                lo.append(float(spec["min"]))
                hi.append(float(spec["max"]))
        return np.asarray(lo), np.asarray(hi)

    def to_dict(self, theta) -> dict:
        """Named parameters of ``theta``: (W, ndim) → (W,) columns (or one
        point (ndim,) → its entries); fixed values stay numbers, computed
        ones are evaluated on what they depend on."""
        out = dict(self.fixed)
        for i, p in enumerate(self.sampled):
            out[p] = theta[..., i]
        # resolve computed params; a few passes allow computed-on-computed
        pending = dict(self.computed)
        for _ in range(3):
            if not pending:
                break
            still = {}
            for name, (argnames, fn) in pending.items():
                if all(a in out for a in argnames):
                    out[name] = fn(out)
                else:
                    still[name] = (argnames, fn)
            if len(still) == len(pending):
                missing = {n: a for n, (a, _) in still.items()}
                raise ValueError(
                    f"computed params with unresolvable inputs: {missing}"
                )
            pending = still
        return out

    def _prior_tensors(self, like):
        key = (like.device, like.dtype)
        if key not in self._consts:
            norm = [self.priors[p].get("dist", "uniform") == "norm" for p in self.sampled]
            lo, hi = self.bounds()
            loc = [float(self.priors[p]["loc"]) if n else 0.0 for p, n in zip(self.sampled, norm)]
            scale = [float(self.priors[p]["scale"]) if n else 1.0
                     for p, n in zip(self.sampled, norm)]
            width = np.where(norm, 1.0, hi - lo)
            lognorm = np.log(np.asarray(scale) * np.sqrt(2.0 * np.pi))
            dev = lambda x, dt=like.dtype: torch.as_tensor(np.asarray(x), dtype=dt,
                                                           device=like.device)
            self._consts[key] = dict(
                norm=dev(norm, torch.bool), lo=dev(np.where(norm, -np.inf, lo)),
                hi=dev(np.where(norm, np.inf, hi)), loc=dev(loc), scale=dev(scale),
                lognorm=dev(lognorm), logwidth=dev(np.log(width)))
        return self._consts[key]

    def log_prior(self, theta):
        """(W,) log prior of a (W, ndim) batch (or a scalar of one point)."""
        c = self._prior_tensors(theta)
        x = theta
        gauss = -0.5 * ((x - c["loc"]) / c["scale"]) ** 2 - c["lognorm"]
        inside = (x >= c["lo"]) & (x <= c["hi"])
        flat = torch.where(inside, -c["logwidth"], torch.full_like(x, -math.inf))
        return torch.where(c["norm"], gauss, flat).sum(dim=-1)


# ----------------------------------------------------------------------
# the Analysis object
# ----------------------------------------------------------------------
@dataclass(eq=False)
class Analysis:
    """A fully built multi-tracer analysis on one device: ``logp(thetas)``
    maps a walker batch (W, ndim) to (W,); products mirror upstream's
    provider API."""

    configs: dict[str, EFTConfig]
    pipelines: dict[str, TracerPipeline]
    providers: dict[str, Any]
    bases: dict[str, Any]
    like: EFTLikelihood | None
    space: ParamSpace
    dtype: Any = torch.float64
    likes: dict[str, EFTLikelihood] = field(default_factory=dict)
    source_info: dict | None = None   # normalized config (paths resolved)
    device: Any = None
    quadform: str = "kernel"
    lowrank_tol: float = LOWRANK_TOL
    cf_premix: bool = True

    def __post_init__(self):
        if not self.likes and self.like is not None:
            self.likes = {"like": self.like}
        self.device = resolve_device(self.device)
        self._fills: dict = {}

    # -- variant rebuilds --------------------------------------------------
    def rebuilt(self, remove_window: bool = False, zeff: float | None = None,
                dtype=None) -> "Analysis":
        """A new Analysis from this one's (already path-resolved) config with
        upstream's ``BestfitModel`` switches applied (analysis.py:778-784):
        ``remove_window`` drops the survey-window convolution from every
        tracer, ``zeff`` re-evaluates every tracer at an overridden
        effective redshift.  Phase-A operators re-use the same
        ``cache_dir``."""
        if self.source_info is None:
            raise ValueError(
                "this Analysis was not built via from_config; rebuild "
                "requires the stored source config")
        info = copy.deepcopy(self.source_info)
        for tcfg in info.get("theory", {}).get("tracers", {}).values():
            if remove_window:
                tcfg["with_window"] = False
                tcfg.pop("with_icc", None)   # icc rides the window transform
            if zeff is not None:
                tcfg.pop("zeff", None)
                tcfg["z"] = float(zeff)
        return Analysis.from_config(info, dtype=dtype or self.dtype, device=self.device,
                                    quadform=self.quadform, lowrank_tol=self.lowrank_tol,
                                    cf_premix=self.cf_premix)

    # -- construction ---------------------------------------------------
    @classmethod
    def from_config(cls, src, dtype=torch.float64, device=None,
                    quadform: str = "kernel", lowrank_tol: float = LOWRANK_TOL,
                    cf_premix: bool = True) -> "Analysis":
        """Build on ``device`` (default: the card; raises when there is none —
        pass ``device="cpu"`` for the plain PyTorch path) in ``dtype``;
        ``quadform`` is the quadratic forms' route ("kernel", "plain" or
        "lowrank"; with "lowrank" the factors' cut ``lowrank_tol`` and the
        premixed CF loop ``cf_premix``, see ``TracerPipeline.build``)."""
        device = resolve_device(device)
        info = load_config(src)
        theory = info.get("theory", {})
        cache_dir = theory.get("cache_dir")
        tracer_cfgs = merge_tracer_configs(theory.get("tracers", {}))

        # likelihood: one block, or a dict of independent named blocks whose
        # log-likelihoods add (upstream's NGC + SGC production configs)
        lk = info.get("likelihood")
        if lk and "data" in lk:
            blocks = {"like": lk}
        else:
            blocks = dict(lk or {})

        def per_tracer(x, name, default, order=None):
            # scalar / list / dict forms all accepted, mirroring upstream's
            # or_list_to_dict (likelihood.py:309-335); list entries map to
            # tracers by position in the block's order
            if isinstance(x, Mapping):
                return x.get(name, default)
            if isinstance(x, (list, tuple)):
                if order is None or len(x) != len(order):
                    raise ValueError(
                        f"per-tracer list {x!r} does not match tracer order {order!r}"
                    )
                return x[list(order).index(name)]
            return x

        # requirement negotiation (upstream theory.py:500-555): every tracer
        # computes internal multipoles up to the data's l_max (+2 when the
        # block consumes chained multipoles)
        for block in blocks.values():
            order = block.get("tracers", list(block.get("data", {})))
            chained = block.get("chained", False)
            for name in order:
                data_ls = block["data"][name]["ls"]
                if isinstance(data_ls, int):
                    data_ls = [data_ls]
                need = max(data_ls) + (
                    2 if per_tracer(chained, name, False, order) else 0
                )
                have = max(tracer_cfgs[name].get("ls", [0, 2]))
                if need > have:
                    tracer_cfgs[name]["ls"] = list(range(0, need + 1, 2))

        configs, pipelines, providers, bases = {}, {}, {}, {}
        for name, tcfg in tracer_cfgs.items():
            partners = None
            if tcfg.get("cross"):
                a, b = tcfg["cross"]
                partners = (tracer_cfgs[a], tracer_cfgs[b])
            t0 = _time.perf_counter()
            cfg, pipe, provider, basis = build_tracer(
                name, tcfg, cross_partners=partners, cache_dir=cache_dir,
                device=device, dtype=dtype, quadform=quadform,
                lowrank_tol=lowrank_tol, cf_premix=cf_premix,
            )
            configs[name], pipelines[name] = cfg, pipe
            providers[name], bases[name] = provider, basis
            plugins = [
                p for p, t in (
                    ("IRresum", pipe.rt), ("AP", pipe.at), ("window", pipe.wt),
                    ("window_matrix", pipe.wmt), ("fiber", pipe.ft),
                ) if t is not None
            ]
            if pipe.wt is not None and pipe.wt.get("icc"):
                plugins.append("icc")
            log.info(
                "tracer %s: z=%.4g ls=%s nl=%d basis=%s provider=%s "
                "plugins=[%s]%s (Phase-A build %.1fs)",
                name, tcfg.get("z", tcfg.get("zeff", 0.5)),
                tcfg.get("ls", [0, 2]), cfg.nl, type(basis).__name__,
                type(provider).__name__, ",".join(plugins),
                f" cross={tcfg['cross']}" if tcfg.get("cross") else "",
                _time.perf_counter() - t0,
            )

        likes: dict[str, EFTLikelihood] = {}
        for block_name, block in blocks.items():
            order = block.get("tracers", list(block["data"]))
            chained = block.get("chained", False)
            binned = block.get("binned", True)
            binning = block.get("binning", {})
            specs = {}
            for name in order:
                specs[name] = TracerSpec(
                    pipeline=pipelines[name],
                    basis=bases[name],
                    data=dict(block["data"][name]),
                    chained=bool(per_tracer(chained, name, False, order)),
                    with_binning=bool(per_tracer(binned, name, True, order)),
                    with_interp=not bool(per_tracer(binned, name, True, order)),
                    binning=dict(per_tracer(binning, name, {}, order) or {}),
                )
            likes[block_name] = EFTLikelihood(
                tracers=specs,
                cov=block["cov"],
                marg=block.get("marg"),
                jeffreys=bool(block.get("jeffreys", False)),
            )
            lk = likes[block_name]
            log.info(
                "likelihood %s: tracers=%s ndata=%d marg=%d jeffreys=%s",
                block_name, order, lk.ndata,
                lk.marginal.nmarg if lk.marginal else 0, lk.jeffreys,
            )
        like = next(iter(likes.values())) if len(likes) == 1 else None

        space = ParamSpace.from_config(info.get("params", {}))
        log.info(
            "params: %d sampled %s, %d fixed, %d computed",
            space.ndim, space.sampled, len(space.fixed), len(space.computed),
        )
        _validate_emulator_boxes(providers, space, log)
        # template-fit fast path: with a fixed P_lin and no sampled amplitude
        # the loop products are Phase-A constants (pipeline.freeze_template)
        amp_free = "A" not in space.sampled and space.fixed.get("A", 1.0) == 1.0
        if amp_free:
            for name, prov in providers.items():
                if isinstance(prov, FixedTemplateProvider):
                    pipelines[name].freeze_template(prov.plin)
        return cls(
            configs=configs, pipelines=pipelines, providers=providers,
            bases=bases, like=like, likes=likes, space=space, dtype=dtype,
            source_info=copy.deepcopy(info), device=device, quadform=quadform,
            lowrank_tol=lowrank_tol, cf_premix=cf_premix,
        )

    # -- evaluation -------------------------------------------------------
    def _as_batch(self, thetas):
        thetas = torch.as_tensor(thetas, dtype=self.dtype, device=self.device)
        if thetas.dim() != 2 or thetas.shape[1] != self.space.ndim:
            raise ValueError(
                f"thetas must have shape (W, {self.space.ndim}), got {tuple(thetas.shape)}")
        return thetas

    def _fill(self, value: float, nw: int):
        """A (nw,) tensor of ``value``, made once per (value, nw)."""
        key = (value, nw)
        if key not in self._fills:
            self._fills[key] = torch.full((nw,), value, dtype=self.dtype, device=self.device)
        return self._fills[key]

    def params_dict(self, thetas) -> dict:
        """Named (W,) parameter tensors of a (W, ndim) batch: sampled columns,
        fixed values and computed parameters."""
        nw = thetas.shape[0]
        return {k: v if isinstance(v, torch.Tensor) else self._fill(float(v), nw)
                for k, v in self.space.to_dict(thetas).items()}

    def _inputs(self, params, tracers=None) -> dict[str, CosmoInputs]:
        names = tracers if tracers is not None else list(self.pipelines)
        out = {}
        for t in names:
            ci = self.providers[t].inputs(params)
            out[t] = CosmoInputs(*(x.to(self.dtype) for x in ci))
        return out

    def _loglike(self, params) -> dict:
        if not self.likes:
            raise ValueError("no likelihood block in the config")
        tracers = sorted({t for lk in self.likes.values() for t in lk.runtimes})
        inputs = self._inputs(params, tracers)
        blocks = {name: lk.logp(inputs, params) for name, lk in self.likes.items()}
        out = dict(
            logp=sum(b["logp"] for b in blocks.values()),
            chi2=sum(b["chi2"] for b in blocks.values()),
            fullchi2=sum(b["fullchi2"] for b in blocks.values()),
        )
        if len(blocks) == 1:
            only = next(iter(blocks.values()))
            if "bg_bestfit" in only:
                out["bg_bestfit"] = only["bg_bestfit"]
        out["blocks"] = blocks
        return out

    def loglike(self, thetas) -> dict:
        """Sum over all likelihood blocks, each entry (W,); the per-block
        breakdown under ``blocks``."""
        thetas = self._as_batch(thetas)
        return self._loglike(self.params_dict(thetas))

    def validity_logp(self, params):
        """Provider validity terms: −inf where a proposal leaves an
        emulator's training box, so out-of-box regions are rejected
        instead of plateauing."""
        total = 0.0
        for prov in self.providers.values():
            if hasattr(prov, "validity_logp"):
                total = total + prov.validity_logp(params).to(self.dtype)
        return total

    def _logp_batch(self, thetas):
        params = self.params_dict(thetas)
        lp = self.space.log_prior(thetas) + self.validity_logp(params)
        res = self._loglike(params)
        return torch.where(torch.isfinite(lp), lp + res["logp"],
                           torch.full_like(lp, -math.inf))

    def logp(self, thetas, chunk: int | None = None):
        """log prior + provider validity + log likelihood of a walker batch:
        (W, ndim) → (W,).  ``chunk`` splits W into pieces evaluated one
        after the other (the counterpart of the JAX package's
        ``chunked_vmap``)."""
        thetas = self._as_batch(thetas)
        nw = thetas.shape[0]
        if not chunk or chunk >= nw:
            return self._logp_batch(thetas)
        return torch.cat([self._logp_batch(thetas[i:i + chunk])
                          for i in range(0, nw, chunk)])

    # -- products (upstream theory.py:244-267) ----------------------------
    def _tracer_eval(self, tracer, params):
        """(inputs, params, squeeze): numbers become a batch of one (then
        squeezed from the products), (W,) tensors stay a batch of W."""
        merged = {**self.space.fixed, **dict(params)}
        nw = max((v.shape[0] for v in merged.values()
                  if isinstance(v, torch.Tensor) and v.dim()), default=None)
        squeeze = nw is None
        nw = nw or 1
        tp = {}
        for k, v in merged.items():
            if isinstance(v, torch.Tensor):
                v = v.to(dtype=self.dtype, device=self.device)
                tp[k] = v.expand(nw) if v.dim() == 0 else v
            else:
                tp[k] = torch.full((nw,), float(v), dtype=self.dtype, device=self.device)
        return self._inputs(tp, [tracer])[tracer], tp, squeeze

    @staticmethod
    def _squeeze(x, squeeze):
        return x[0] if squeeze else x

    def nonlinear_Plk_grid(self, tracer, params, chained=False, binned=False,
                           kout=None, **binning_opts):
        inputs, tp, sq = self._tracer_eval(tracer, params)
        binning = (
            self.pipelines[tracer].binning_tables(kout, **binning_opts)
            if binned else None
        )
        ls, kret, plk = _products.plk_grid(
            self.pipelines[tracer], self.bases[tracer], inputs, tp,
            chained=chained, binning=binning,
        )
        return ls, kret, self._squeeze(plk, sq)

    def nonlinear_Plk_interpolator(self, tracer, params, chained=False):
        ls, kret, plk = self.nonlinear_Plk_grid(tracer, params, chained=chained)
        return _products.PlkInterpolator(ls, kret, plk)

    def nonlinear_Plk_gaussian_grid(self, tracer, params, chained=False,
                                    binned=False, kout=None, **binning_opts):
        inputs, tp, sq = self._tracer_eval(tracer, params)
        binning = (
            self.pipelines[tracer].binning_tables(kout, **binning_opts)
            if binned else None
        )
        ls, kret, table = _products.plk_gaussian_grid(
            self.pipelines[tracer], self.bases[tracer], inputs, tp,
            chained=chained, binning=binning,
        )
        return ls, kret, {k: self._squeeze(v, sq) for k, v in table.items()}

    def bird_component(self, tracer, params, chained=False):
        inputs, tp, sq = self._tracer_eval(tracer, params)
        ls, kret, comp = _products.bird_component(
            self.pipelines[tracer], self.bases[tracer], inputs, tp,
            chained=chained,
        )
        return ls, kret, type(comp)(*(self._squeeze(x, sq) for x in comp))

    def snapshots(self, tracer, params):
        inputs, _, sq = self._tracer_eval(tracer, params)
        snaps = _products.snapshots(self.pipelines[tracer], inputs)
        return {k: type(v)(*(self._squeeze(x, sq) for x in v)) for k, v in snaps.items()}

    def eft_params_values_dict(self, tracer, params) -> dict:
        basis = self.bases[tracer]
        full = {**self.space.fixed, **dict(params)}
        names = basis.non_gaussian_params() + basis.gaussian_params()
        return {n: full.get(n, 0.0) for n in names}

    # -- derived parameters (upstream theory.py:611-648, likelihood.py:587-615)
    def _marg_columns(self) -> list[tuple[str, str, int]]:
        """(column, block, row) for every analytically-marginalized parameter:
        their conditional bestfit values as ``marg_<param>`` derived chain
        columns (upstream likelihood.py:590-593)."""
        cols: list[tuple[str, str, int]] = []
        seen: dict[str, int] = {}
        for bn, lk in self.likes.items():
            if lk.marginal is None:
                continue
            for p, row in sorted(lk._bg_index.items(), key=lambda kv: kv[1]):
                name = f"marg_{p}"
                if name in seen:   # same param marginalized in two blocks
                    name = f"marg_{bn}_{p}"
                seen[name] = 1
                cols.append((name, bn, row))
        return cols

    def derived_names(self) -> list[str]:
        names = []
        for t, prov in self.providers.items():
            if hasattr(prov, "derived"):
                names += [f"{t}_fz", f"{t}_fsigma8_z", f"{t}_alperp", f"{t}_alpara"]
            else:
                names += [f"{t}_fz", f"{t}_alperp", f"{t}_alpara"]
            if hasattr(prov, "in_box"):
                names.append(f"{t}_emu_in_box")
        if self.likes:
            names += ["chi2", "fullchi2"]
            if len(self.likes) > 1:
                for bn in self.likes:
                    names += [f"{bn}_chi2", f"{bn}_fullchi2"]
            names += [c for c, _, _ in self._marg_columns()]
        return names

    def derived(self, thetas):
        """Per-tracer growth/AP derived params + chi² columns: (W, ndim) →
        (W, nderived)."""
        thetas = self._as_batch(thetas)
        params = self.params_dict(thetas)
        vals = []
        for t, prov in self.providers.items():
            if hasattr(prov, "derived"):
                d = prov.derived(params)
                vals += [d["fz"], d["fsigma8_z"], d["alperp"], d["alpara"]]
            else:
                ci = prov.inputs(params)
                vals += [ci.f, ci.qperp, ci.qpar]
            if hasattr(prov, "in_box"):
                vals.append(prov.in_box(params))
        if self.likes:
            res = self._loglike(params)
            vals += [res["chi2"], res["fullchi2"]]
            if len(self.likes) > 1:
                for bn in self.likes:
                    vals += [res["blocks"][bn]["chi2"], res["blocks"][bn]["fullchi2"]]
            for _, bn, row in self._marg_columns():
                vals.append(res["blocks"][bn]["bg_bestfit"][..., row])
        return torch.stack([v.to(self.dtype).expand(thetas.shape[0]) for v in vals], dim=-1)

    # -- sampling ----------------------------------------------------------
    def sampler(self, nwalkers: int = 256, chunk_size: int | None = None, a: float = 2.0):
        from ..parallel.sampler import EnsembleSampler

        return EnsembleSampler(
            logp=self.logp, nwalkers=nwalkers, ndim=self.space.ndim,
            a=a, chunk_size=chunk_size,
        )

    def _hessian(self, theta):
        """∇²logp at one point (ndim,) as a float64 NumPy array, in the
        analysis' dtype on its device: one forward at W = ndim copies of the
        point, its gradient kept in the graph, and one more backward of the
        gradient's diagonal (copy i's gradient depends on copy i alone, so
        row i of the result is ∂(∂logp/∂θ_i)/∂θ)."""
        n = self.space.ndim
        x = self._as_batch(np.tile(np.asarray(theta, np.float64), (n, 1)))
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self.logp(x).sum(), x, create_graph=True)
            (h,) = torch.autograd.grad(torch.diagonal(g).sum(), x)
        return h.detach().double().cpu().numpy()

    def laplace_cov(self, theta=None, jitter: float = 1e-12):
        """Gaussian (Laplace) posterior approximation at ``theta`` (default:
        the reference point): Σ = (−∇²logp)⁻¹, eigenvalue-floored to be PD
        and each direction's σ capped at its prior half-width (the JAX
        module's reasons, ``orchestrate.py:893-929``).  The Hessian is a
        double backward through ``logp`` (:meth:`_hessian`)."""
        cached = theta is None
        if cached and getattr(self, "_laplace_cov_cache", None) is not None:
            return self._laplace_cov_cache
        theta = self.space.theta0() if theta is None else theta
        h = self._hessian(theta)
        h = 0.5 * (h + h.T)
        evals, evecs = np.linalg.eigh(h)
        # -logp curvature must be positive; floor tiny/negative directions
        # at the scale of the largest so Σ stays finite and PD
        curv = np.maximum(-evals, jitter * np.max(np.abs(evals)))
        cov = (evecs / curv) @ evecs.T
        # no posterior is wider than its prior support: cap each direction's
        # σ at the prior half-width (a diag(s) congruence keeps Σ PD)
        lo, hi = self.space.bounds()
        width = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
        cap = np.where(np.isfinite(width), width / 2.0, np.inf)
        sig = np.sqrt(np.diag(cov))
        s = np.minimum(1.0, cap / np.maximum(sig, 1e-300))
        cov = cov * np.outer(s, s)
        if cached:
            self._laplace_cov_cache = cov
        return cov

    def init_walkers(self, nwalkers: int, key=0, scale: float = 1.0, z=None):
        """Scatter walkers ~ N(theta0, scale²·Σ_laplace), clipped into the
        prior support.  ``key`` seeds a CPU ``torch.Generator`` (or is one)
        that draws the standard normals ``z`` (nwalkers, ndim), unless they
        are given."""
        theta0 = np.asarray(self.space.theta0(), np.float64)
        cov = self.laplace_cov()
        chol = np.linalg.cholesky(cov + 1e-30 * np.eye(len(theta0)))
        if z is None:
            gen = key if isinstance(key, torch.Generator) else \
                torch.Generator().manual_seed(int(key))
            z = torch.randn((nwalkers, theta0.size), generator=gen, dtype=torch.float64)
        z = np.asarray(z, np.float64)
        x = theta0[None, :] + scale * z @ chol.T
        lo, hi = self.space.bounds()
        span = np.where(np.isfinite(hi - lo), hi - lo, 1.0)
        x = np.clip(x, np.where(np.isfinite(lo), lo + 1e-6 * span, -np.inf),
                    np.where(np.isfinite(hi), hi - 1e-6 * span, np.inf))
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def run_mcmc(
        self,
        nwalkers: int = 256,
        out=None,
        rhat_tol: float = 0.01,
        max_steps: int = 10_000,
        key: int = 0,
        with_derived: bool = True,
        init: str = "ball",
        sampler: str = "stretch",
        mesh=None,
        resume: bool = True,
        **driver_kwargs,
    ):
        """Blocked ensemble MCMC with checkpoint/resume (parallel/mcmc.py).

        ``init="laplace"`` scatters the initial ensemble with the
        inverse-Hessian covariance at the reference point
        (:meth:`init_walkers`, seeded with ``key + 1``); ``"ball"`` is the
        tight-ball start.  ``sampler="hmc"`` runs HMC chains; with
        ``init="laplace"`` its warmup metric starts from the full Laplace
        covariance.  ``mesh`` (a ``parallel/mesh.py::WalkerMesh``, one
        process per card, its device the analysis') splits the walkers'
        evaluations over the cards; the chain equals the one-card chain and
        only rank 0 writes the files."""
        from ..parallel.mcmc import MCMCDriver

        if sampler == "hmc" and init == "laplace" and \
                "inv_mass0" not in driver_kwargs:
            driver_kwargs["inv_mass0"] = self.laplace_cov()
        driver = MCMCDriver(
            logp=self.logp, ndim=self.space.ndim, nwalkers=nwalkers,
            rhat_tol=rhat_tol, out=out, param_names=list(self.space.sampled),
            derived_names=self.derived_names() if with_derived else None,
            derived_fn=self.derived if with_derived else None,
            sampler_kind=sampler, mesh=mesh, device=self.device,
            **driver_kwargs,
        )
        if init == "laplace":
            x0 = self.init_walkers(nwalkers, key=key + 1)
        elif init == "ball":
            x0 = torch.as_tensor(self.space.theta0(), dtype=self.dtype, device=self.device)
        else:
            raise ValueError(f"unknown init {init!r} (ball | laplace)")
        return driver.run(seed=key, x0=x0, max_steps=max_steps, resume=resume)
