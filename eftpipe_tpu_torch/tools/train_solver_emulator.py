"""Train the production P(k) emulator on the Einstein–Boltzmann solver, on
the card (counterpart of the JAX package's ``tools/train_solver_emulator.py``).

    python -m eftpipe_tpu_torch.tools.train_solver_emulator \\
        --workdir WORK --out pk_emulator.npz [--n 512] [--inner-frac 0.4] \\
        [--degree 6] [--degree-in 7] [--ncomp 96] [--batch 64] \\
        [--train-only] [--sample-mnu] [--device cuda]

Solver spectra over a Sobol design in (ω_b, ω_cdm, h) (``--sample-mnu``:
and the per-species neutrino mass), with the production neutrino setup
(Σm_ν = 0.06 eV over 3 degenerate species, N_ur = 0.00641), then the PCA +
polynomial-ridge fit (``boltzmann/emulator.py::train_pk_emulator``) with its
training box, neutrino setup and solver settings stamped into the artifact.

The design is nested: a scrambled Sobol sequence (seed 7) over the wide box
and one (seed 11) over an inner box around the DR16 posterior, in the ratio
``--inner-frac``, so that the fit is sharpest where chains live and valid
over the whole box.  The solver's step schedule is the envelope over the
corners of this invocation's own box (8 corners at m_ncdm = 0.02 eV, 16 with
``--sample-mnu``), so every cosmology in the box integrates stably.  The
solves are batched, ``--batch`` cosmologies a call, each written to its own
sample file; a batched solve gives each cosmology the spectra of its own
solve.

``--workdir`` keeps the run: ``x.npy`` (the design, never overwritten) with
``sampling_meta.json`` beside it (a later invocation with other sampling
flags refuses, except under ``--train-only``, where the stored metadata
wins; a workdir without metadata refuses any difference), ``kgrid.npy``,
``zgrid.npy`` and ``sample_{i:04d}.npz`` (``log_tm``, ``log_tcb``,
``log_rdrag``).  Existing samples are skipped, so a cut run resumes.

``--out`` is required: the JAX tool's default path overwrites its shipped
artifact, and this tool never writes into the package's ``artifacts/``.
The shipped ``pk_emulator_mnu06.npz`` is reproduced by ``--n 512
--inner-frac 0.35 --degree 8 --degree-in 7 --ncomp 96``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..boltzmann import einstein_boltzmann as eb
from ..boltzmann.emulator import train_pk_emulator

BOUNDS = eb.BOX_BOUNDS            # the wide box: the production priors
INNER_BOUNDS = {                  # dense region around the DR16 posterior
    "omega_b": (0.0195, 0.0255),
    "omega_cdm": (0.075, 0.175),
    "h": (0.55, 0.80),
}
NEUTRINO = dict(m_ncdm=0.02, **eb.BOX_NEUTRINO)
MNU_BOUNDS = eb.BOX_MNU_BOUNDS    # --sample-mnu: m_ncdm per species, Σm_ν ∈ [0, 0.3] eV
MNU_INNER = (0.01, 0.04)          # dense around the production Σm_ν = 0.06 eV
SOLVER_KMAX = eb.BOX_KMAX
Z_GRID = eb.BOX_Z_GRID            # 13 z uniform in ln a, z = 0 … 1.05


def sobol(n: int, dim: int, seed: int = 7) -> np.ndarray:
    from scipy.stats import qmc

    return qmc.Sobol(d=dim, scramble=True, seed=seed).random(n)


def sample_design(n: int, inner_frac: float, sample_mnu: bool = False) -> dict:
    """The nested Sobol design: ``names``, the wide box ``lo``/``hi``, the
    inner box ``lo_i``/``hi_i`` and the inputs ``x`` (n, len(names)); in
    the 4-D mode the rows are interleaved by a ``default_rng(3)``
    permutation (a cut run then still fits on a balanced prefix)."""
    bounds, inner = dict(BOUNDS), dict(INNER_BOUNDS)
    if sample_mnu:
        bounds["m_ncdm"], inner["m_ncdm"] = MNU_BOUNDS, MNU_INNER
    names = list(bounds)
    n_in = int(round(inner_frac * n))
    lo = np.array([bounds[k][0] for k in names])
    hi = np.array([bounds[k][1] for k in names])
    lo_i = np.array([inner[k][0] for k in names])
    hi_i = np.array([inner[k][1] for k in names])
    x = np.concatenate([lo + (hi - lo) * sobol(n - n_in, len(names), seed=7),
                        lo_i + (hi_i - lo_i) * sobol(n_in, len(names), seed=11)])
    if sample_mnu:
        x = x[np.random.default_rng(3).permutation(len(x))]
    return dict(names=names, lo=lo, hi=hi, lo_i=lo_i, hi_i=hi_i, x=x)


def _sampling_meta(d: dict) -> dict:
    return dict(input_names=list(d["names"]),
                bounds_lo=[float(v) for v in d["lo"]], bounds_hi=[float(v) for v in d["hi"]],
                inner_lo=[float(v) for v in d["lo_i"]], inner_hi=[float(v) for v in d["hi_i"]])


def prepare_workdir(wd, design: dict, train_only: bool = False) -> dict:
    """Bind ``design`` to the workdir: the stored ``x.npy`` is the only
    source of the inputs (the samples are aligned to it by index).  A
    mismatch with ``sampling_meta.json`` raises ``SystemExit`` unless
    ``train_only``, where the stored metadata replaces the design's; a
    workdir without metadata refuses any difference.  Returns the design in
    force."""
    wd = Path(wd)
    wd.mkdir(parents=True, exist_ok=True)
    design = dict(design)
    meta_path = wd / "sampling_meta.json"
    if (wd / "x.npy").exists():
        x_stored = np.load(wd / "x.npy")
        if meta_path.exists():
            stored = json.loads(meta_path.read_text())
            cur = _sampling_meta(design)
            if any(stored[k] != cur[k] for k in cur):
                if not train_only:
                    raise SystemExit(
                        f"{meta_path} disagrees with this invocation's sampling flags — "
                        f"refusing to mix sample sets (delete the workdir to start fresh)")
                print(f"restoring sampling metadata from {meta_path} "
                      f"(sampling flags ignored with --train-only)")
                design.update(names=list(stored["input_names"]),
                              lo=np.asarray(stored["bounds_lo"]),
                              hi=np.asarray(stored["bounds_hi"]),
                              lo_i=np.asarray(stored["inner_lo"]),
                              hi_i=np.asarray(stored["inner_hi"]))
        elif x_stored.shape != design["x"].shape or not np.allclose(x_stored, design["x"]):
            raise SystemExit(
                f"{wd}/x.npy was made with other n/inner-frac/bounds than this invocation "
                f"and carries no sampling_meta.json — refusing to guess (delete the workdir "
                f"or rerun once without --train-only to stamp it)")
        design["x"] = x_stored
    else:
        np.save(wd / "x.npy", design["x"])
    if not meta_path.exists():
        meta_path.write_text(json.dumps(_sampling_meta(design)))
    return design


def design_solver(design: dict, device=None) -> "eb.EBSolver":
    """The solver of the design's box: the envelope over its corners (at
    the production m_ncdm when the mass is not an input)."""
    bounds = {k: (float(a), float(b)) for k, a, b in zip(design["names"], design["lo"],
                                                          design["hi"])}
    return eb.box_solver(bounds, None if "m_ncdm" in bounds else NEUTRINO["m_ncdm"],
                         device=device)


def sample_path(wd, i: int) -> Path:
    return Path(wd) / f"sample_{i:04d}.npz"


def solve_samples(solver, design: dict, wd, batch: int = 64, log=print) -> int:
    """Solve the design's cosmologies that have no sample file yet,
    ``batch`` a call, and write each one's ``sample_{i:04d}.npz``.  Returns
    the number of solver calls."""
    wd = Path(wd)
    wd.mkdir(parents=True, exist_ok=True)
    np.save(wd / "kgrid.npy", solver.k_mpc)
    np.save(wd / "zgrid.npy", np.sort(Z_GRID)[::-1])
    x, names = design["x"], list(design["names"])
    todo = [i for i in range(len(x)) if not sample_path(wd, i).exists()]
    calls = 0
    for start in range(0, len(todo), batch):
        sel = todo[start:start + batch]
        col = {k: torch.as_tensor(x[sel, j], dtype=torch.float64, device=solver.device)
               for j, k in enumerate(names)}
        par = eb.box_params(col["omega_b"], col["omega_cdm"], col["h"],
                            col.get("m_ncdm", NEUTRINO["m_ncdm"]), device=solver.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            lp = solver(par)
            log_tm, log_tcb = eb.log_transfers(lp)
            log_rd = torch.log(lp.rs_drag)
        log_tm, log_tcb, log_rd = (t.cpu().numpy() for t in (log_tm, log_tcb, log_rd))
        calls += 1
        for s, i in enumerate(sel):
            np.savez(sample_path(wd, i), log_tm=log_tm[s], log_tcb=log_tcb[s],
                     log_rdrag=log_rd[s])
        log(f"[{start + len(sel)}/{len(todo)}] {len(sel)} cosmologies in "
            f"{time.perf_counter() - t0:.1f}s")
    return calls


def fit(wd, design: dict, ncomp: int = 96, degree: int = 6, degree_in: int = 7,
        device=None) -> tuple:
    """Fit the emulator on the workdir's samples (those present, in index
    order) with the artifact's provenance; returns (PkEmulator, report)."""
    wd = Path(wd)
    kgrid, zgrid = np.load(wd / "kgrid.npy"), np.load(wd / "zgrid.npy")
    ys, xs = [], []
    for i, xi in enumerate(design["x"]):
        if not sample_path(wd, i).exists():
            continue
        with np.load(sample_path(wd, i)) as z:
            ys.append(np.concatenate([z["log_tm"].ravel(), z["log_tcb"].ravel(),
                                      [float(z["log_rdrag"])]]))
        xs.append(xi)
    sample_mnu = "m_ncdm" in design["names"]
    return train_pk_emulator(
        np.asarray(xs), np.asarray(ys), kgrid, zgrid, ncomp=ncomp, degree=degree,
        inner_bounds=(design["lo_i"], design["hi_i"]), degree_in=degree_in, device=device,
        meta=dict(
            bounds_lo=design["lo"], bounds_hi=design["hi"], input_names=list(design["names"]),
            # an artifact with the mass as an input records no fixed mass
            **({} if sample_mnu else {"m_ncdm": NEUTRINO["m_ncdm"]}),
            deg_ncdm=NEUTRINO["deg_ncdm"], n_ur=NEUTRINO["n_ur"], yhe=NEUTRINO["yhe"],
            kmax=SOLVER_KMAX, n_train=len(ys)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--inner-frac", type=float, default=0.4,
                    help="fraction of samples drawn from the inner box")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--out", required=True, help="path of the artifact (.npz)")
    ap.add_argument("--ncomp", type=int, default=96)
    ap.add_argument("--degree", type=int, default=6)
    ap.add_argument("--degree-in", type=int, default=7,
                    help="degree of the blended inner-box ridge")
    ap.add_argument("--batch", type=int, default=64, help="cosmologies a solver call")
    ap.add_argument("--train-only", action="store_true",
                    help="skip generation, fit on existing samples")
    ap.add_argument("--sample-mnu", action="store_true",
                    help="add the per-species neutrino mass as a 4th emulator input")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    design = prepare_workdir(args.workdir, sample_design(args.n, args.inner_frac,
                                                         args.sample_mnu), args.train_only)
    if not args.train_only:
        solve_samples(design_solver(design, args.device), design, args.workdir, args.batch)
    emu, report = fit(args.workdir, design, args.ncomp, args.degree, args.degree_in,
                      args.device)
    print("validation:", report)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    emu.save(out)
    print("saved", out)


if __name__ == "__main__":
    main()
