"""One run of one cell: build the program, warm it, measure for the window,
read the traced probes, judge what the window produced against the
reference, and print the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``) and that configuration's start
pool (``pools/<config>.npy``), its traffic mix (``traffic/<mix>.json``), its
comparison limits (``cells/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import entries, probes, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "eftpipe_tpu")


class Refused(SystemExit):
    """A run that prints no result: the message goes to standard error and
    the exit code is 2."""

    def __init__(self, msg: str):
        print(f"portbench: {msg}", file=sys.stderr)
        super().__init__(2)


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise Refused(f"{path} does not exist") from None


def load_reader(name: str, here: Path = HERE):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        raise Refused(f"no reader metrics/{name}.py for the metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, and those with no list whose end-to-end
    metric it reports (every cell reports an end-to-end metric with no
    list)."""
    def listed(m):
        return cell in m.get("workloads", [cell])

    e2e = {m["name"] for m in bench["end_to_end"] if listed(m)}
    return [m for m in bench[kind]
            if listed(m) and ("workloads" in m or kind == "end_to_end" or m["moves"] in e2e)]


class Cell:
    """One workload of ``BENCHMARK.json`` and the files it names under
    ``here`` (the benchmark's folder, whose parent is the checkout's root).
    ``narrow`` (tests only) narrows the reference's widths as the test
    narrows the program's."""

    def __init__(self, name: str, bench: dict | None = None, device="cuda",
                 narrow: dict | None = None, cache: Path = CACHE, here: Path = HERE):
        root = here.parent
        self.here = here
        self.bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise Refused(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name, self.spec = name, cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        if self.spec["config"] not in configs:
            raise Refused(f"workload {name!r} names the unknown config {self.spec['config']!r}")
        cfile = root / configs[self.spec["config"]]["file"]
        self.config = load_json(cfile)
        self.config_text = cfile.read_text()
        self.pool_file = here / "pools" / f"{self.spec['config']}.npy"
        if not self.pool_file.exists():
            raise Refused(f"no start pool pools/{self.spec['config']}.npy for the config "
                          f"{self.spec['config']!r} (calibrate.py pool makes it)")
        self.mix = load_json(here / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(here / "cells" / f"{name}.json")
        self.device = torch.device(device)
        self.narrow = dict(narrow or {})
        self.workdir = cache / "work" / self.spec["config"]
        self.refcache = cache / "reference"
        self.dtype = traffic.DTYPES[self.mix["dtype"]]
        entries.entry(self.config)

    # -- the program ------------------------------------------------------
    def build(self):
        digest = entries.prepare_inputs(self.config, self.config_text, self.workdir,
                                        self.refcache, self.narrow)
        self.program = entries.entry(self.config)[1](self.config, self.workdir, self.dtype,
                                                     self.device)
        entries.check_inputs(self.workdir, digest)

    def start(self, seed: int):
        """The seed's generator and driver, warmed on every shape the window
        uses."""
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.record = traffic.Record()
        pool = np.load(self.pool_file)
        if pool.ndim != 2 or pool.shape[1] != len(self.program.theta0):
            raise Refused(f"{self.pool_file} holds {pool.shape}, not (n, "
                          f"{len(self.program.theta0)}) positions")
        self.drv = traffic.driver(self.mix, self.program, pool, self.gen, self.device,
                                  self.record)
        self.drv.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, trace: bool) -> dict:
        win = traffic.run_window(self.drv, seconds, self.mix["block"], step_events=trace)
        self.win = win
        rec = dict(sampler=self.mix["sampler"], work=win.work, seconds=win.seconds,
                   steps=win.steps, step_ms=win.step_ms)
        return rec

    def probes(self, rec: dict, seed: int) -> None:
        """The traced run's readings, after the window: none of them is
        recorded as the window's output."""
        from eftpipe_tpu_torch.ops import quadform as qf

        self.record.on = False
        step = self.drv.one_step()
        n = self.mix["profile_steps"]
        rec["syncs_per_step"] = len(probes.sync_sites(step))
        rec["profile"] = probes.profile_steps(step, n, qf.LAUNCHES_BY_SHAPE)
        launched = {q["dtype"] for q in rec["profile"]["qf_real"]}
        if len(launched) > 1:
            raise Refused(f"the traced steps launched qf_real in {sorted(launched)}; its "
                          "device time cannot be split between them")
        if launched and not rec["profile"]["qf_real_device_s"] > 0:
            raise Refused(f"the program counted qf_real launches but the trace holds no "
                          f"device time under the host operation {probes.QF_REAL_OP!r}: "
                          "the roofline would go silent; read its time where it now runs")
        # the same steps' wall without the profiler, whose per-operation cost
        # on the host would read as device idle time where the host paces
        rec["profile"]["window_s"] = probes.host_ms_over(lambda _: [step() for _ in range(n)],
                                                         [None, None]) * 1e-3
        batch = self.drv.probe_batch()
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        inputs = [batch * (1.0 + 1e-6 * torch.randn(batch.shape, generator=gen,
                                                     dtype=batch.dtype, device=self.device))
                  for _ in range(self.mix["probe_calls"] + 1)]
        p = self.program
        with torch.no_grad():
            rec["stage_ms"] = {
                "cosmology": probes.host_ms_over(p.cosmology, inputs),
                "nonlinear": probes.host_ms_over(p.nonlinear, inputs),
                "logp": probes.host_ms_over(p.logp, inputs)}

        def value_and_grad(x):
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(p.logp(x).sum(), x)
            return g

        if self.mix["sampler"] == "hmc":
            rec["stage_ms"]["value_and_grad"] = probes.host_ms_over(value_and_grad, inputs)

    # -- the comparison ---------------------------------------------------
    def sample(self, seed: int) -> dict:
        """A sample, drawn from the seed, of every evaluation the window
        produced (positions and outputs as float64 host arrays), the share
        of walkers or chains the window moved, and the evaluations that came
        out NaN."""
        calls = self.record.calls
        cols = [torch.cat([c[i] for c in calls]) for i in range(len(calls[0]))]
        n = cols[0].shape[0]
        k = min(self.limits["sample"], n)
        idx = np.sort(np.random.default_rng(abs(seed)).choice(n, size=k, replace=False))
        pick = torch.as_tensor(idx, device=cols[0].device)
        moved = (self.win.end != self.win.start).any(dim=-1)
        out = dict(x=cols[0][pick], lp=cols[1][pick], n=n,
                   nan=int(torch.isnan(cols[1]).sum()),
                   moved_share=float(moved.to(torch.float64).mean()))
        if len(cols) > 2:
            out["grad"] = cols[2][pick]
        return {k: v.double().cpu() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()}

    def free(self) -> None:
        for name in ("drv", "record", "program", "gen"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64):
        """The reference in ``dtype``, on the µ quadrature of AP that the
        program uses in the cell's precision (a float32 cell's model has 16
        Gauss–Legendre nodes, a float64 one's the 200-point trapezoid), so
        that the two sides differ by their arithmetic alone."""
        quadrature = "gauss_legendre" if self.dtype == torch.float32 else "by_dtype"
        return entries.entry(self.config)[2](self.config, self.workdir, self.refcache,
                                            self.device, dtype, quadrature, self.narrow)

    def judge(self, sample: dict, ref, dtype=torch.float64) -> dict:
        """Each number that the cell's limits name, beside its limit."""
        got = reference_values(ref, sample["x"], "grad" in sample, dtype, self.device,
                               self.limits.get("chunk", 32))
        checks = numbers(sample, got)
        self.look = dict(worst_logp_ref=float(got["lp"][worst(sample["lp"], got["lp"])]))
        unknown = set(self.limits["limits"]) - set(checks)
        if unknown:
            raise Refused(f"cells/{self.name}.json limits {sorted(unknown)}; this cell's "
                          f"numbers are {sorted(checks)}")
        return {name: dict(value=checks[name], **lim)
                for name, lim in self.limits["limits"].items()}


def numbers(sample: dict, got: dict) -> dict:
    """Every number a cell can compare, of the sample against ``got``."""
    out = dict(logp_gap=logp_gap(sample["lp"], got["lp"]),
               logp_rel_gap=logp_rel_gap(sample["lp"], got["lp"]),
               moved_share=sample["moved_share"])
    if "grad" in sample:
        out["grad_err"] = grad_err(sample["grad"], got["grad"])
    return out


def reference_values(ref, x, with_grad: bool, dtype, device, chunk: int) -> dict:
    """The reference's logp (and its gradient) at the positions ``x``, in
    blocks of ``chunk`` rows."""
    lps, grads = [], []
    for i in range(0, x.shape[0], chunk):
        xi = x[i:i + chunk].to(device=device, dtype=dtype)
        if with_grad:
            xi = xi.detach().requires_grad_(True)
            lp = ref.logp(xi)
            (g,) = torch.autograd.grad(lp.sum(), xi)
            grads.append(g.double().cpu())
        else:
            with torch.no_grad():
                lp = ref.logp(xi)
        lps.append(lp.detach().double().cpu())
    out = dict(lp=torch.cat(lps))
    if with_grad:
        out["grad"] = torch.cat(grads)
    return out


def _nan_inf(d):
    return torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)


def _gaps(lp, want):
    """|Δlogp| a row; two −inf (a point outside the prior) agree, a NaN or
    one −inf on one side only is an infinite gap."""
    both = torch.isneginf(lp) & torch.isneginf(want)
    return _nan_inf(torch.where(both, torch.zeros_like(lp), (lp - want).abs()))


def logp_gap(lp, want) -> float:
    """The widest |Δlogp|."""
    return float(_gaps(lp, want).max())


def logp_rel_gap(lp, want) -> float:
    """The widest |Δlogp| / max(1, |logp_ref|): the gap against the size of
    the value, for traffic whose points reach log-posteriors so large
    (a divergent leapfrog step) that any float32 path's absolute error
    there outgrows every limit that the control could fail."""
    return float(_nan_inf(_gaps(lp, want) / want.abs().clamp(min=1.0)).max())


def worst(lp, want) -> int:
    """The sample's row with the widest |Δlogp|."""
    return int(_gaps(lp, want).argmax())


def grad_err(g, want) -> float:
    """The worst chain's ‖g − g_ref‖ / ‖g_ref‖.  A row whose gradient is not
    finite on both sides agrees, as two −inf log-posteriors do (the model has
    no gradient there); one not finite on one side only, or a NaN, is
    infinite."""
    neither = ~torch.isfinite(g).all(dim=-1) & ~torch.isfinite(want).all(dim=-1)
    e = (g - want).norm(dim=-1) / want.norm(dim=-1)
    return float(_nan_inf(torch.where(neither, torch.zeros_like(e), e)).max())


def passes(check: dict) -> bool:
    v = check["value"]
    if "max" in check and not v <= check["max"]:
        return False
    if "min" in check and not v >= check["min"]:
        return False
    return True


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(cell: Cell) -> dict:
    if cell.device.type != "cuda":   # the CPU tests' runs
        return dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=int(cell.spec["chips"]),
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def read_metrics(bench: dict, cell: str, kind: str, rec: dict, here: Path = HERE) -> dict:
    out = {}
    for m in cell_metrics(bench, cell, kind):
        value = load_reader(m["name"], here)(rec)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float) -> dict:
    """Everything of a run after its look for a device: build, warm,
    measure, probe, judge.  Returns the result line's object."""
    cell.build()
    cell.start(seed)
    setup_s = time.perf_counter() - t_start
    rec = cell.window(seconds, trace)
    rec["setup_s"] = setup_s
    device = device_info(cell)
    if trace:
        cell.probes(rec, seed)
        device.update(busy_s=rec["profile"]["busy_s"], window_s=rec["profile"]["window_s"])
    sample = cell.sample(seed)
    cell.free()
    checks = cell.judge(sample, cell.reference())
    correct = sample["nan"] == 0 and all(passes(c) for c in checks.values())
    kind = "per_layer" if trace else "end_to_end"
    result = dict(correct=bool(correct), attempted=int(rec["work"]), failed=int(sample["nan"]),
                  metrics=read_metrics(cell.bench, cell.name, kind, rec, cell.here),
                  device=device)
    if trace:
        result["breakdown"] = dict(device_ops=rec["profile"]["device_ops"],
                                   idle_gaps=rec["profile"]["idle_gaps"])
    checks["nan_outputs"] = dict(value=sample["nan"], max=0)
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not (ROOT / "eftpipe_tpu_torch" / "__init__.py").exists():
        raise Refused("the program (eftpipe_tpu_torch/) is not in this checkout")
    cell = Cell(args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"workload {cell.name} needs {chips} CUDA device(s); "
                      f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result = execute(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        raise Refused(f"the run loaded {found}; the benchmark and the program must not")
    print("look " + " ".join(f"{k} {v!r}" for k, v in cell.look.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        bound = " ".join(f"{k} {c[k]!r}" for k in ("min", "max") if k in c)
        print(f"check {name} {c['value']!r} {bound}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
