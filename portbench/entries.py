"""The two entries a configuration can name (``"entry"`` in its file): the
program's object under test, the reference beside it, and the inputs both
read.

``flagship``: ``eftpipe_tpu_torch.api.flagship.build_flagship`` →
``FlagshipModel.logp``; ``analysis``: ``Analysis.from_config`` →
``Analysis.logp``.  The reference writes the masks, the mock data and the
covariance into the work directory before the program builds; the program
reads them there.  A later configuration of either kind adds a file under
``configs/`` and nothing here; a new kind of entry adds its functions to
``ENTRIES``.
"""

from __future__ import annotations

import copy
import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(eq=False)
class Program:
    """What the harness drives: ``logp(thetas, chunk=None)`` of the program,
    its start point, and the stage prefixes the traced run times."""

    logp: Callable
    theta0: np.ndarray
    cosmology: Callable        # thetas → the cosmology inputs of every tracer
    nonlinear: Callable        # thetas → the loop engine's output of every tracer


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(Path(p).read_bytes())
    return h.hexdigest()


def input_files(workdir: Path) -> list:
    return sorted(p for p in workdir.glob("*.txt")) + sorted(workdir.glob("*_meta.json"))


# ---------------------------------------------------------------------------
# flagship
# ---------------------------------------------------------------------------

def _flagship_inputs(config: dict, workdir: Path, cache_dir: Path, device, narrow: dict):
    from .reference import flagship as ref

    ref.write_inputs(config["flagship"], workdir, cache_dir, device, **narrow)


def _flagship_program(config: dict, workdir: Path, dtype, device) -> Program:
    from eftpipe_tpu_torch.api import flagship as fl

    spec = config["flagship"]
    # the file states what runs: the program's fixed numbers must be its own
    if (fl.FIDUCIAL != spec["fiducial"] or fl.TRACERS != spec["tracers"]
            or fl.COSMO_NAMES != spec["cosmo_names"]):
        raise SystemExit("portbench: the configuration file no longer states the program's "
                         "flagship numbers (FIDUCIAL, TRACERS, COSMO_NAMES)")
    model = fl.build_flagship(workdir, dtype=dtype, device=device, **config["build"])

    def nonlinear(thetas):
        inputs, _ = model.cosmo_inputs(thetas)
        return [spec.pipeline.compute_bird(inputs[name], stop_after="nonlinear")
                for name, spec in model.like.tracers.items()]

    return Program(logp=model.logp, theta0=np.asarray(model.theta0, dtype=np.float64),
                   cosmology=lambda thetas: model.cosmo_inputs(thetas)[0],
                   nonlinear=nonlinear)


def _flagship_reference(config: dict, workdir: Path, cache_dir: Path, device, dtype, quadrature,
                        narrow):
    from .reference import flagship as ref

    return ref.build(config["flagship"], workdir, cache_dir, device, dtype, quadrature, **narrow)


# ---------------------------------------------------------------------------
# config-driven analysis
# ---------------------------------------------------------------------------

def analysis_info(config: dict, workdir: Path) -> dict:
    """The ``analysis`` block with its paths made absolute under ``workdir``
    (the program's builder reads a dict's paths as they stand)."""
    info = copy.deepcopy(config["analysis"])
    info["theory"]["cache_dir"] = str(workdir / info["theory"]["cache_dir"])
    for name, tc in info["theory"]["tracers"].items():
        win = tc.get("with_window")
        if win:
            win["window_configspace_file"] = str(workdir / win["window_configspace_file"])
    like = info["likelihood"]
    like["cov"] = str(workdir / like["cov"])
    for d in like["data"].values():
        d["path"] = str(workdir / d["path"])
    return info


def _analysis_inputs(config: dict, workdir: Path, cache_dir: Path, device, narrow: dict):
    from .reference import analysis as ref

    ref.write_inputs(config["analysis"], config["masks"], workdir, cache_dir, device, **narrow)


def _analysis_program(config: dict, workdir: Path, dtype, device) -> Program:
    from eftpipe_tpu_torch.api.orchestrate import Analysis

    an = Analysis.from_config(analysis_info(config, workdir), dtype=dtype, device=device)

    def cosmology(thetas):
        return an._inputs(an.params_dict(thetas))

    def nonlinear(thetas):
        inputs = cosmology(thetas)
        return [pipe.compute_bird(inputs[name], stop_after="nonlinear")
                for name, pipe in an.pipelines.items()]

    return Program(logp=an.logp, theta0=np.asarray(an.space.theta0(), dtype=np.float64),
                   cosmology=cosmology, nonlinear=nonlinear)


def _analysis_reference(config: dict, workdir: Path, cache_dir: Path, device, dtype, quadrature,
                        narrow):
    from .reference import analysis as ref

    return ref.build(config["analysis"], workdir, cache_dir, device, dtype, quadrature, **narrow)


def _flagship_theta0(config: dict) -> np.ndarray:
    from .reference import flagship as ref

    return ref.theta0(config["flagship"])


def _analysis_theta0(config: dict) -> np.ndarray:
    from .reference import analysis as ref

    return ref.theta0(config["analysis"])


# each kind of entry: (write the inputs, build the program, build the
# reference, the reference point the start pool's burn-in begins at)
ENTRIES = {
    "flagship": (_flagship_inputs, _flagship_program, _flagship_reference, _flagship_theta0),
    "analysis": (_analysis_inputs, _analysis_program, _analysis_reference, _analysis_theta0),
}


def entry(config: dict):
    try:
        return ENTRIES[config["entry"]]
    except KeyError:
        raise SystemExit(f"portbench: unknown entry {config.get('entry')!r}; "
                         f"known: {sorted(ENTRIES)}") from None


def prepare_inputs(config: dict, config_text: str, workdir: Path, cache_dir: Path,
                   narrow: dict) -> str:
    """Write the inputs into ``workdir`` once per configuration and reference
    (a stamp keyed by both), on the host; returns the digest of the files,
    which the harness holds against them again once the program has built."""
    workdir.mkdir(parents=True, exist_ok=True)
    src = [p for p in (HERE / "reference").rglob("*.py")]
    key = hashlib.sha256(config_text.encode() + json.dumps(narrow, sort_keys=True).encode()
                         + _digest(src).encode()).hexdigest()
    stamp = workdir / "inputs.stamp"
    if not (stamp.exists() and stamp.read_text() == key and input_files(workdir)):
        entry(config)[0](config, workdir, cache_dir, "cpu", narrow)
        stamp.write_text(key)
    return _digest(input_files(workdir))


def check_inputs(workdir: Path, digest: str) -> None:
    if _digest(input_files(workdir)) != digest:
        raise SystemExit("portbench: the program rewrote the benchmark's input files "
                         f"under {workdir}; both sides must read the same inputs")
