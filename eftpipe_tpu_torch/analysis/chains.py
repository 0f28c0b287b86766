"""Chain loading / introspection — the ``CobayaProducts`` analogue
(counterpart of ``eftpipe_tpu/analysis/chains.py``; upstream
eftpipe/analysis.py:119-454), NumPy in place of pandas.

Reads the getdist-style output of :class:`eftpipe_tpu_torch.parallel.mcmc.
MCMCDriver` — and of the JAX package's driver, whose files are the same —
(``<prefix>.<i>.txt`` + ``<prefix>.paramnames`` + ``<prefix>.params.json``),
with multi-chain concatenation, burn-in removal, sampled/derived splits,
bestfit extraction and weighted summary statistics; and an upstream Cobaya
run (``from_cobaya``, ``progress``, ``fixed_params``).  Where the JAX module
returns a pandas ``Series`` this returns a ``dict`` (name → value); its
``DataFrame`` is :class:`Samples`, a 2-D array with named columns.  PyYAML
is imported only to read a Cobaya run's YAML files.
"""

from __future__ import annotations

import glob
import json
import numpy as np
from dataclasses import dataclass, field
from pathlib import Path


def _read_yaml(path: Path):
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading {path} needs PyYAML, which is not installed") from e
    return yaml.safe_load(path.read_text())


@dataclass
class Samples:
    """Named columns of a 2-D sample array."""

    columns: list[str]
    values: np.ndarray  # (nsamples, ncols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]

    def __len__(self) -> int:
        return self.values.shape[0]

    def row(self, i: int, names=None) -> dict:
        names = self.columns if names is None else names
        return {n: float(self[n][i]) for n in names}


@dataclass
class ChainProducts:
    root: str
    samples: Samples = field(repr=False)
    param_names: list[str]
    derived_names: list[str]
    meta: dict

    COLUMNS_PREFIX = ["weight", "minuslogpost"]

    # -- loading ----------------------------------------------------------
    @classmethod
    def from_prefix(cls, prefix, burn_in: float = 0.0) -> "ChainProducts":
        """Load ``<prefix>.<i>.txt`` chains (analysis.py:137-186 analogue).

        burn_in: fraction (0-1) of each chain file dropped from the front.
        """
        prefix = str(prefix)
        names, derived = cls._read_paramnames(prefix)
        files = sorted(glob.glob(f"{prefix}.[0-9]*.txt"))
        if not files:
            raise FileNotFoundError(f"no chain files found for prefix {prefix}")
        parts = []
        for fn in files:
            arr = np.atleast_2d(np.loadtxt(fn))
            if burn_in:
                arr = arr[int(burn_in * arr.shape[0]):]
            parts.append(arr)
        values = np.concatenate(parts, axis=0)
        cols = cls.COLUMNS_PREFIX + names + derived
        samples = Samples(columns=cols[: values.shape[1]], values=values)
        meta = {}
        meta_file = Path(f"{prefix}.params.json")
        if meta_file.exists():
            meta = json.loads(meta_file.read_text())
        return cls(root=prefix, samples=samples, param_names=names,
                   derived_names=derived, meta=meta)

    @classmethod
    def from_cobaya(cls, src, burn_in: float = 0.0) -> "ChainProducts":
        """Read an upstream-format **Cobaya run** (upstream
        ``analysis.py:119-271``).

        ``src`` is the run prefix (``path/to/run``) or one of its YAML files
        (``run.input.yaml`` / ``run.updated.yaml`` / a launch YAML with an
        ``output:`` entry).  Reads the ``<root>.<i>.txt`` chains with their
        column names from the ``#`` header line (Cobaya writes no
        ``.paramnames``), and ``<root>.updated.yaml`` (else ``.input.yaml``)
        for the sampled / fixed / derived split; ``.progress`` and
        ``.minimum`` are read on demand (:meth:`progress`, :meth:`bestfit`)."""
        src = str(src)
        if src.endswith((".input.yaml", ".updated.yaml")):
            prefix = src[: -len(".input.yaml")] if src.endswith(".input.yaml") \
                else src[: -len(".updated.yaml")]
        elif src.endswith((".yaml", ".yml")):
            out = _read_yaml(Path(src)).get("output")
            if out is None:
                raise ValueError(f"{src} has no 'output' entry")
            out = Path(out)
            prefix = str(out if out.is_absolute() else Path(src).resolve().parent / out)
        else:
            prefix = src
        prefix = str(Path(prefix))

        files = sorted(glob.glob(f"{prefix}.[0-9]*.txt"))
        if not files:
            raise FileNotFoundError(f"no Cobaya chain files for {prefix}")
        with open(files[0]) as f:
            header = f.readline()
        if not header.lstrip().startswith("#"):
            raise ValueError(f"{files[0]} has no '#' header line — not a Cobaya chain")
        cols = header.lstrip("# ").split()
        parts = []
        for fn in files:
            arr = np.atleast_2d(np.loadtxt(fn))
            if burn_in:
                arr = arr[int(burn_in * arr.shape[0]):]
            parts.append(arr)
        values = np.concatenate(parts, axis=0)
        samples = Samples(columns=cols[: values.shape[1]], values=values)

        updated = input_info = {}
        if Path(prefix + ".updated.yaml").exists():
            updated = _read_yaml(Path(prefix + ".updated.yaml")) or {}
        if Path(prefix + ".input.yaml").exists():
            input_info = _read_yaml(Path(prefix + ".input.yaml")) or {}
        params_info = (updated or input_info).get("params", {}) or {}
        sampled = [p for p, c in params_info.items() if isinstance(c, dict) and "prior" in c]
        fixed = {
            p: c["value"] for p, c in params_info.items()
            if isinstance(c, dict) and "value" in c
            and not c.get("derived", False)
            and not isinstance(c["value"], str)  # lambdas are derived inputs
        }
        # everything beyond (weight, minuslogpost, sampled) is a derived
        # column: Cobaya's minuslogprior/chi2 bookkeeping plus the
        # likelihood's marg_*/*_fullchi2 extras
        names = [c for c in cols if c in sampled]
        derived = [c for c in cols[2:] if c not in sampled]
        meta = dict(format="cobaya", nchains=len(files), input_info=input_info,
                    updated_info=updated,
                    sampled_param_specs={p: params_info[p] for p in sampled},
                    fixed_params=fixed)
        if not names:  # no YAML found: fall back to positional split
            names, derived = cols[2:], []
        return cls(root=prefix, samples=samples, param_names=names,
                   derived_names=derived, meta=meta)

    # -- Cobaya sidecar files ------------------------------------------------
    def progress(self) -> Samples:
        """``<root>.progress`` convergence history (N, acceptance rate, R−1;
        upstream ``analysis.py:245-261``)."""
        path = Path(f"{self.root}.progress")
        if not path.exists():
            raise FileNotFoundError(path)
        with open(path) as f:
            header = f.readline().lstrip("# ").split()
        arr = np.atleast_2d(np.loadtxt(path))
        return Samples(columns=header[: arr.shape[1]], values=arr)

    def fixed_params(self) -> dict[str, float]:
        return dict(self.meta.get("fixed_params", {}))

    # -- a minimizer's bestfit -------------------------------------------------
    def minimum(self) -> dict | None:
        """Bestfit from a Cobaya ``.minimum`` minimizer file beside the chain
        when present (upstream ``analysis.py:393-424``: three header rows,
        then ``idx value name [latex]`` lines)."""
        path = Path(f"{self.root}.minimum")
        if not path.exists():
            return None
        values: dict[str, float] = {}
        with open(path) as f:
            for i, line in enumerate(f):
                if i < 3 or not line.strip():
                    continue
                _idx, value, name, *_latex = line.split()
                values[name] = float(value)
        return values

    @staticmethod
    def _read_paramnames(prefix: str) -> tuple[list[str], list[str]]:
        names, derived = [], []
        with open(f"{prefix}.paramnames") as f:
            for line in f:
                if not line.strip():
                    continue
                n = line.split()[0]
                (derived if n.endswith("*") else names).append(n.rstrip("*"))
        return names, derived

    # -- introspection ------------------------------------------------------
    def sampled_params(self) -> list[str]:
        return list(self.param_names)

    def all_params(self) -> list[str]:
        return self.param_names + self.derived_names

    def __getitem__(self, name: str) -> np.ndarray:
        return self.samples[name]

    @property
    def weights(self) -> np.ndarray:
        return self.samples["weight"]

    # -- statistics ---------------------------------------------------------
    def mean(self, params=None) -> dict:
        params = params or self.all_params()
        w = self.weights
        return {p: float(np.average(self[p], weights=w)) for p in params}

    def std(self, params=None) -> dict:
        params = params or self.all_params()
        w = self.weights
        out = {}
        for p in params:
            m = np.average(self[p], weights=w)
            out[p] = float(np.sqrt(np.average((self[p] - m) ** 2, weights=w)))
        return out

    def cov(self, params=None) -> np.ndarray:
        """Weighted covariance of ``params`` (default: the sampled ones, in
        that order)."""
        params = params or self.sampled_params()
        x = np.column_stack([self[p] for p in params])
        return np.atleast_2d(np.cov(x, rowvar=False, aweights=self.weights))

    def bestfit(self, params=None) -> dict:
        """Bestfit: a Cobaya ``.minimum`` minimizer file when present
        (upstream analysis.py:393-414), else the sample with minimal
        -logpost (:415-424)."""
        mini = self.minimum()
        if mini is not None:
            return mini if params is None else {p: mini[p] for p in params if p in mini}
        i = int(np.argmin(self.samples["minuslogpost"]))
        return self.samples.row(i, params or self.all_params())

    def global_bestfit(self, chi2_cols: list[str] | None = None) -> dict:
        """Bestfit by minimal summed full-chi2 columns when present
        (analysis.py:425-454); falls back to minuslogpost."""
        cols = chi2_cols or [c for c in self.samples.columns if c.endswith("fullchi2")]
        if not cols:
            return self.bestfit()
        total = np.sum(np.column_stack([self.samples[c] for c in cols]), axis=1)
        return self.samples.row(int(np.argmin(total)))

    def to_getdist(self):
        """Optional getdist MCSamples view (gated import)."""
        from getdist import MCSamples  # pragma: no cover

        return MCSamples(
            samples=np.column_stack([self[p] for p in self.all_params()]),
            weights=self.weights,
            loglikes=self.samples["minuslogpost"],
            names=self.all_params(),
        )
