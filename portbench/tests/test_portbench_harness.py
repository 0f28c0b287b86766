"""The harness is driven by data, keeps to the contract's names, imports
nothing of JAX, and its comparison catches a broken timed path."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.support import narrow_program, run, small_cell  # noqa: F401

HERE = Path(harness.__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy_bench(tmp_path: Path) -> Path:
    here = tmp_path / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    return here


def test_new_cell_found_by_name(tmp_path):
    """A configuration, a mix, a cell's limits and a metric's reader added as
    files, with their entries in BENCHMARK.json, are found; nothing that is
    there is edited."""
    here = _copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "configs" / "eboss-lrg-elg-copy.json").write_text(
        (here / "configs" / "eboss-lrg-elg.json").read_text())
    (here / "pools" / "eboss-lrg-elg-copy.npy").write_bytes(
        (here / "pools" / "eboss-lrg-elg.npy").read_bytes())
    (here / "traffic" / "stretch-w8.json").write_text(json.dumps(dict(
        sampler="stretch", walkers=8, a=2.0, dtype="float32", block=1,
        profile_steps=1, probe_calls=1)))
    (here / "cells" / "copy.stretch-w8.json").write_text(json.dumps(dict(
        sample=4, limits=dict(logp_gap=dict(max=0.02), moved_share=dict(min=0.5)))))
    (here / "metrics" / "walkers_seen.py").write_text(
        "def read(rec):\n    return rec['work'] / max(rec['steps'], 1)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="eboss-lrg-elg-copy",
                                 file="portbench/configs/eboss-lrg-elg-copy.json"))
    bench["workloads"].append(dict(name="copy.stretch-w8", config="eboss-lrg-elg-copy",
                                   traffic="stretch-w8", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(name="walkers_seen", unit="count", better="higher",
                                   source="host_clock", layer="sampler", moves="evals_per_s",
                                   workloads=["copy.stretch-w8"]))
    bench["end_to_end"][0]["workloads"].append("copy.stretch-w8")
    cell = harness.Cell("copy.stretch-w8", bench=bench, device="cpu", here=here,
                        cache=tmp_path / "cache")
    assert cell.mix["walkers"] == 8 and cell.limits["sample"] == 4
    assert cell.config["entry"] == "flagship"
    rec = dict(sampler="stretch", work=80, seconds=2.0, steps=10, setup_s=3.0)
    e2e = harness.read_metrics(bench, cell.name, "end_to_end", rec, here)
    assert e2e == {"evals_per_s": dict(value=40.0, unit="evals/s"),
                   "setup_s": dict(value=3.0, unit="s")}
    layer = harness.read_metrics(bench, cell.name, "per_layer", rec, here)
    assert layer == {"walkers_seen": dict(value=8.0, unit="count")}
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("what", ["workload", "config", "pool", "traffic", "cell", "metric"])
def test_unknown_name_fails(what, tmp_path):
    here = _copy_bench(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    name = "lrg-elg.stretch-w4096"
    if what == "workload":
        name = "no-such.cell"
    elif what == "config":
        bench["workloads"][0]["config"] = "no-such-config"
    elif what == "traffic":
        bench["workloads"][0]["traffic"] = "no-such-mix"
    elif what == "pool":
        (here / "pools" / "eboss-lrg-elg.npy").unlink()
    elif what == "cell":
        (here / "cells" / f"{name}.json").unlink()
    with pytest.raises(SystemExit) as e:
        if what == "metric":
            harness.load_reader("no_such_metric", here)
        harness.Cell(name, bench=bench, device="cpu", here=here, cache=tmp_path)
    assert e.value.code == 2


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        for x in BENCH[group]:
            assert NAME.match(x["name"]), x["name"]
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
                assert x["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in x:
                    assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (HERE / "pools" / f"{w['config']}.npy").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "cells" / f"{w['name']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        if m in BENCH["end_to_end"]:
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for p in HERE.rglob("*"):
        if ".cache" not in p.parts and "__pycache__" not in p.parts:
            rel = str(p.relative_to(ROOT))
            assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "files") and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_jax_imports():
    """Top-level names compared whole: ``eftpipe_tpu_torch`` is the program,
    ``eftpipe_tpu`` (the JAX package) is not."""
    for path in HERE.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "eftpipe_tpu"}
        assert not found, (path, found)
    for path in (HERE / "reference").rglob("*.py"):
        assert "eftpipe_tpu_torch" not in _imports(path), path


# --- a broken timed path makes `correct` false -------------------------------

def _half_mean(logp, limit):
    def broken(thetas, chunk=None):
        out = logp(thetas, chunk=chunk)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half].mean().expand(out.shape[0] - half)])
    return broken


def _altered(logp, limit):
    # every answer moved by twice the cell's limit on its gap (in the size of
    # the answer where the limit is relative: never less than absolute)
    def broken(thetas, chunk=None):
        lp = logp(thetas, chunk=chunk)
        return lp + 2.0 * limit * lp.abs().clamp(min=1.0)
    return broken


def _frozen_stretch(monkeypatch):
    from eftpipe_tpu_torch.parallel import sampler

    monkeypatch.setattr(sampler, "stretch_step", lambda gen, logp, walkers, logps, a=2.0: (
        walkers, logps, torch.zeros(walkers.shape[0], dtype=torch.bool)))


def _frozen_hmc(monkeypatch):
    from eftpipe_tpu_torch.parallel import hmc

    monkeypatch.setattr(hmc, "_transition", lambda lpg, state, eps, ops, draws: (
        state, torch.zeros_like(state.logp)))


FAULTS = {
    "sound": None,
    "state_unchanged": "frozen",
    "half_batch_mean": _half_mean,
    "answer_altered": _altered,
}


@pytest.mark.parametrize("name", ["lrg-elg.stretch-w4096", "lrg-elg.hmc-c2048"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_makes_run_incorrect(name, fault, narrow_program, tmp_path_factory,  # noqa: F811
                                   monkeypatch):
    cell = small_cell(name, tmp_path_factory.mktemp("pb"))
    broken = FAULTS[fault]
    if broken == "frozen":
        (_frozen_hmc if "hmc" in name else _frozen_stretch)(monkeypatch)
    elif broken is not None:
        build = cell.build

        def build_broken():
            build()
            lim = cell.limits["limits"]
            cell.program.logp = broken(cell.program.logp,
                                       (lim.get("logp_gap") or lim["logp_rel_gap"])["max"])

        cell.build = build_broken
    result = run(cell)
    assert result["correct"] is (fault == "sound"), result["checks"]
