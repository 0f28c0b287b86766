"""State carried across from the JAX package, as plain NumPy.

The port never imports the JAX package; a caller that has it (the parity
tests) extracts its Phase-A state as nested dicts of NumPy arrays and hands
them over here, so that both sides compute from IDENTICAL constants:

* :func:`pipeline_from_numpy` — the ``nt/bt/rt/at/wt/wmt/ft`` table dicts
  of a ``TracerPipeline`` (dataclass members such as the FFTLog plans and the
  spline table given as dicts of their fields; the icc tables inside ``wt``);
* :func:`likelihood_from_numpy` — the likelihood's data vector, inverse
  covariance, gather indices, binning / interpolation matrices, chained and
  cross tracers and marginal prior;
* :func:`emulator_from_numpy` — a ``PkEmulator`` from its arrays;
* :func:`transfer_emulator_from_numpy` — a ``TransferEmulator`` (the MLP of
  the ``emulator`` provider) from its parameters;
* :func:`mlp_params_from_numpy` — MLP parameters as tensors (the JAX
  ``init_mlp`` output or trained weights), e.g. the initial parameters of
  ``emulator._train_mlp``;
* :func:`analysis_from_numpy` — a config-driven ``Analysis``: its pipelines'
  tables, frozen templates, providers, bases, likelihood blocks and
  parameter space;
* :func:`driver_state_from_numpy` — the state of a running chain from an
  MCMC driver checkpoint, the JAX driver's or the port's;
* :func:`eb_solver_from_numpy` — an ``EBSolver`` with a JAX solver's
  schedule (k grid, output times, step buckets), so that both integrate the
  same steps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device, to_device
from .likelihood.likelihood import EFTLikelihood, TracerSpec, _TracerRuntime
from .likelihood.marginal import MarginalSetup
from .likelihood.parambasis import find_param_basis
from .boltzmann.emulator import PkEmulator, TransferEmulator
from .boltzmann.eh98 import EisensteinHuProvider
from .boltzmann.einstein_boltzmann import EBSolver
from .boltzmann.providers import FixedTemplateProvider
from .models.config import EFTConfig
from .models.fiber import fiber_tables_to
from .models.nonlinear import nonlinear_tables_to
from .models.pipeline import TracerPipeline
from .models.window import window_tables_to, window_matrix_tables_to
from .ops.fftlog import FFTLogPlan
from .ops.interp import SplineTable


def _plan(d) -> FFTLogPlan:
    return d if isinstance(d, FFTLogPlan) else FFTLogPlan(**d)


def pipeline_from_numpy(cfg: EFTConfig, tables: dict, device=None,
                        dtype=torch.float64, zeff: float | None = None,
                        quadform: str = "kernel", cf_premix: bool = True) -> TracerPipeline:
    """A ``TracerPipeline`` from ``tables = {"nt", "bt", "rt", "at", "wt",
    "wmt", "ft"}`` (all but the first two optional; ``wt["icc"]`` holds the
    coupled integral-constraint tables, or None).  ``nt["plan_cf"]`` may be
    ``None`` or absent when it is the same plan as ``nt["plan_pk"]``;
    ``nt["lowrank"]`` (the JAX tables' low-rank factors) serves
    ``quadform="lowrank"``."""
    device = resolve_device(device)
    nt = dict(tables["nt"])
    if nt.get("lowrank") is None:
        nt.pop("lowrank", None)
    nt["plan_pk"] = _plan(nt["plan_pk"])
    nt["plan_cf"] = _plan(nt["plan_cf"]) if nt.get("plan_cf") is not None else nt["plan_pk"]
    bt = tables["bt"]
    rt = tables.get("rt")
    if rt is not None:
        rt = dict(rt, plan=_plan(rt["plan"]), xplan=_plan(rt["xplan"]))
    at = tables.get("at")
    if at is not None:
        sp = at["spline"]
        at = dict(at, spline=sp if isinstance(sp, SplineTable) else SplineTable(**sp))
    stages = {}
    for key, to in (("wt", window_tables_to), ("wmt", window_matrix_tables_to),
                    ("ft", fiber_tables_to)):
        if tables.get(key) is not None:
            stages[key] = to(tables[key], device, dtype)
    return TracerPipeline(
        cfg=cfg,
        nt=nonlinear_tables_to(nt, device, dtype),
        bt=to_device(bt, device, dtype),
        rt=to_device(rt, device, dtype) if rt is not None else None,
        at=to_device(at, device, dtype) if at is not None else None,
        **stages, zeff=zeff, device=device, dtype=dtype, quadform=quadform,
        cf_premix=cf_premix)


def emulator_from_numpy(state: dict) -> PkEmulator:
    """A ``PkEmulator`` from ``state``, a dict of its fields (NumPy arrays and
    scalars, e.g. the ``vars()`` of the JAX package's emulator); fields the
    port does not know are refused."""
    names = {f for f in PkEmulator.__dataclass_fields__ if not f.startswith("_")}
    unknown = set(state) - names
    if unknown:
        raise ValueError(f"unknown PkEmulator fields {sorted(unknown)}")
    return PkEmulator(**{k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
                         for k, v in state.items()})


def transfer_emulator_from_numpy(state: dict) -> TransferEmulator:
    """A ``TransferEmulator`` from ``state = {"params": [{"w", "b"}, ...],
    "kgrid", "x_mean", "x_std", "y_mean", "y_std", "input_names"
    (optional)}`` — the fields of the JAX package's emulator as NumPy."""
    arrays = {k: np.asarray(state[k], np.float64)
              for k in ("kgrid", "x_mean", "x_std", "y_mean", "y_std")}
    params = [{"w": np.asarray(layer["w"], np.float64), "b": np.asarray(layer["b"], np.float64)}
              for layer in state["params"]]
    extra = {"input_names": tuple(state["input_names"])} if "input_names" in state else {}
    return TransferEmulator(params=params, **arrays, **extra)


def mlp_params_from_numpy(params, dtype=torch.float64, device=None) -> list:
    """``[{"w": (din, dout), "b": (dout,)}, ...]`` (NumPy) as tensors of
    ``dtype`` on ``device`` (the card unless ``"cpu"``)."""
    device = resolve_device(device)
    return [{k: torch.as_tensor(np.array(layer[k]), dtype=dtype, device=device) for k in "wb"}
            for layer in params]


def _basis(ts: dict):
    """A parameter basis from ``{"basis": "westcoast" | "eastcoast" | dotted
    path (default westcoast), "prefix", "cross_prefix" (optional)}``."""
    cls = find_param_basis(ts.get("basis", "westcoast"))
    if ts.get("cross_prefix"):
        return cls(prefix=ts["prefix"], cross_prefix=list(ts["cross_prefix"]))
    return cls(prefix=ts["prefix"])


def likelihood_from_numpy(pipelines: dict, state: dict) -> EFTLikelihood:
    """An ``EFTLikelihood`` over ``pipelines`` (name → TracerPipeline) from

    state = {"tracers": {name: {"prefix", "ls", "rows", "cols",
                                "binning_matrix", "keff",
                                "basis", "cross_prefix", "chained",
                                "interp_png", "interp_pg"}},
             "data_vector", "invcov", "jeffreys",
             "marg_names", "marg_mu", "marg_sigma" | "marg"}

    without reading any file; tracer order is the order of
    ``state["tracers"]``.  ``binning_matrix`` is None for an unbinned tracer,
    whose ``interp_png``/``interp_pg`` then map k·P onto the data's k (or
    are absent: no interpolation).  The marginal prior is given either as
    floats (``marg_names``, ``marg_mu``, ``marg_sigma``) or as the prior
    config (``marg``: name → {loc, scale}, expression strings allowed).
    """
    like = object.__new__(EFTLikelihood)
    like.tracers, like.runtimes = {}, {}
    offsets = [0]
    for name, ts in state["tracers"].items():
        pipe = pipelines[name]
        spec = TracerSpec(pipeline=pipe, basis=_basis(ts), data={},
                          chained=bool(ts.get("chained", False)))
        binning = None
        kout = None
        if ts.get("binning_matrix") is not None:
            matrix = np.asarray(ts["binning_matrix"], np.float64)
            binning = dict(matrix=matrix, keff=np.asarray(ts["keff"]),
                           matrix_dev=torch.as_tensor(matrix, dtype=pipe.dtype,
                                                      device=pipe.device))
            kout = binning["keff"]
        else:
            spec.with_binning = False
            spec.with_interp = ts.get("interp_png") is not None
        rows = np.asarray(ts["rows"])
        like.tracers[name] = spec
        like.runtimes[name] = _TracerRuntime(
            spec=spec, ls=list(ts["ls"]), ls_tot=list(ts["ls"]), kall=kout,
            kmin=None, kmax=None, kout=kout,
            data_vector=np.zeros(rows.size), rows=rows, cols=np.asarray(ts["cols"]),
            binning_tables=binning,
            interp_png=None if ts.get("interp_png") is None else np.asarray(ts["interp_png"]),
            interp_pg=None if ts.get("interp_pg") is None else np.asarray(ts["interp_pg"]))
        offsets.append(offsets[-1] + rows.size)
    like.data_vector = np.asarray(state["data_vector"], np.float64)
    like.ndata = like.data_vector.size
    if like.ndata != offsets[-1]:
        raise ValueError(f"data vector has {like.ndata} entries, gathers give {offsets[-1]}")
    like.segments = {name: (offsets[i], offsets[i + 1]) for i, name in enumerate(like.runtimes)}
    like.invcov = np.asarray(state["invcov"], np.float64)
    like.covmat = like.full_covmat = None
    like.hartlap = None
    like.jeffreys = bool(state.get("jeffreys", False))
    like.marginal, like._bg_groups, like._bg_index = None, {}, {}
    if state.get("marg") or state.get("marg_names"):
        if state.get("marg"):
            ordering: list[str] = []
            for spec in like.tracers.values():
                ordering += [p for p in spec.basis.gaussian_params() if p not in ordering]
            like.marginal = MarginalSetup.from_config(
                state["marg"], ordering, jeffreys=like.jeffreys)
        else:
            like.marginal = MarginalSetup(
                names=list(state["marg_names"]), locs=[float(x) for x in state["marg_mu"]],
                scales=[float(x) for x in state["marg_sigma"]], jeffreys=like.jeffreys)
        names = like.marginal.names
        for name, spec in like.tracers.items():
            allowed = set(spec.basis.gaussian_params())
            like._bg_groups[name] = [p for p in names if p in allowed]
        for group in like._bg_groups.values():
            for p in group:
                like._bg_index.setdefault(p, len(like._bg_index))
    like._to_device()
    return like


def provider_from_numpy(cfg: EFTConfig, state: dict):
    """A cosmology provider from ``state = {"kind": ..., **fields}``:
    ``fixed_template`` (``plin`` on cfg.kin) or ``eh98`` (``zeff``,
    ``da_fid``, ``h_fid``, ...).  The solver emulator carries across through
    :func:`emulator_from_numpy`, the transfer emulator through
    :func:`transfer_emulator_from_numpy`."""
    state = dict(state)
    kind = state.pop("kind")
    if kind == "fixed_template":
        return FixedTemplateProvider(cfg=cfg, plin=np.asarray(state["plin"], np.float64))
    if kind == "eh98":
        return EisensteinHuProvider(cfg=cfg, **state)
    raise ValueError(f"unknown provider kind {kind!r}")


def frozen_from_numpy(pipe: TracerPipeline, frozen: dict) -> TracerPipeline:
    """Set a pipeline's frozen template from the JAX pipeline's ``frozen``
    (``{"nl_out": {...}, "xpyp": ...}``, one evaluation each, no walker
    axis): the same tensors with a walker axis of one, on its device."""
    dev = lambda a: torch.as_tensor(np.array(a), dtype=pipe.dtype, device=pipe.device)[None]
    out = {"nl_out": {k: dev(v) for k, v in frozen["nl_out"].items()}}
    if frozen.get("xpyp") is not None:
        out["xpyp"] = dev(frozen["xpyp"])
    pipe.frozen = out
    return pipe


def analysis_from_numpy(state: dict, device=None, dtype=torch.float64,
                        quadform: str = "kernel", cf_premix: bool = True):
    """A config-driven ``Analysis`` from plain data:

    state = {"configs": {name: EFTConfig fields},
             "tables": {name: tables of pipeline_from_numpy},
             "zeff": {name: float}, "with_rsd": {name: bool} (optional),
             "frozen": {name: the JAX pipeline's frozen template} (optional),
             "bases": {name: {"basis", "prefix", "cross_prefix"}},
             "providers": {name: provider state, see provider_from_numpy},
             "likes": {block: likelihood state, see likelihood_from_numpy},
             "params": the config's params block}

    The result computes what the analysis these came from computes, from the
    same constants, without building or reading anything."""
    from .api.orchestrate import Analysis, ParamSpace

    device = resolve_device(device)
    configs, pipelines, providers, bases = {}, {}, {}, {}
    for name, fields in state["configs"].items():
        cfg = EFTConfig(**fields)
        configs[name] = cfg
        pipe = pipeline_from_numpy(cfg, state["tables"][name], device=device, dtype=dtype,
                                   zeff=state["zeff"][name], quadform=quadform,
                                   cf_premix=cf_premix)
        pipe.with_rsd = bool(state.get("with_rsd", {}).get(name, True))
        if state.get("frozen", {}).get(name) is not None:
            frozen_from_numpy(pipe, state["frozen"][name])
        pipelines[name] = pipe
        providers[name] = provider_from_numpy(cfg, state["providers"][name])
        bases[name] = _basis(state["bases"][name])
    likes = {}
    for block, lstate in state["likes"].items():
        lstate = dict(lstate, tracers={
            t: dict(ts, **state["bases"][t]) for t, ts in lstate["tracers"].items()})
        likes[block] = likelihood_from_numpy(
            {t: pipelines[t] for t in lstate["tracers"]}, lstate)
    return Analysis(
        configs=configs, pipelines=pipelines, providers=providers, bases=bases,
        like=next(iter(likes.values())) if len(likes) == 1 else None, likes=likes,
        space=ParamSpace.from_config(state["params"]), dtype=dtype, device=device,
        quadform=quadform, cf_premix=cf_premix)


def driver_state_from_numpy(arrays) -> dict:
    """The state of a running chain from the arrays of an MCMC driver
    checkpoint (an ``np.load``-ed ``<out>.checkpoint.npz``), written by the
    JAX package's driver or by the port's: ``walkers``, ``chain`` and
    ``logps`` (each as a list of one block, empty when no step was taken),
    ``nsteps_done``, the HMC metric (``hmc_eps``, ``hmc_inv_mass``) when
    present, and either the port's ``generator_state`` or, for a JAX
    checkpoint, ``seed``: a JAX key cannot drive a ``torch.Generator``, so
    its bytes (little-endian, the first 8) seed the generator instead."""
    files = set(getattr(arrays, "files", arrays))
    chain, logps = np.asarray(arrays["chain"]), np.asarray(arrays["logps"])
    state = dict(walkers=np.asarray(arrays["walkers"]),
                 chain=[chain] if chain.size else [],
                 logps=[logps] if logps.size else [],
                 nsteps_done=int(arrays["nsteps_done"]))
    for name in ("hmc_eps", "hmc_inv_mass"):
        if name in files:
            state[name] = np.asarray(arrays[name])
    if "generator_state" in files:
        state["generator_state"] = np.asarray(arrays["generator_state"], np.uint8)
    elif "key" in files:
        key = np.ascontiguousarray(arrays["key"]).tobytes()
        state["seed"] = int.from_bytes(key[:8], "little")
    else:
        raise ValueError("checkpoint holds neither generator_state nor key")
    return state


def eb_solver_from_numpy(state: dict, device=None) -> EBSolver:
    """An ``EBSolver`` from a JAX ``EBSolver``'s state, without recomputing
    its schedule: ``k_mpc``, ``z_out``, ``lna_out``, ``dlna_f``,
    ``growth_stencil`` and ``buckets`` (a list of ``(idx, grids, masks,
    out_idx)``), all NumPy."""
    solver = EBSolver.__new__(EBSolver)
    solver.device = resolve_device(device)
    solver.k_mpc = np.asarray(state["k_mpc"], np.float64)
    solver.z_out = np.asarray(state["z_out"], np.float64)
    solver.lna_out = np.asarray(state["lna_out"], np.float64)
    solver.dlna_f = float(state["dlna_f"])
    solver.growth_stencil = bool(state["growth_stencil"])
    solver.buckets = [(np.asarray(i), np.asarray(g), np.asarray(m), np.asarray(o))
                      for i, g, m, o in state["buckets"]]
    solver._sched, solver._dsched = None, {}
    return solver
