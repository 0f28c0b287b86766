#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device
    python3 chip_smoke.py --quick    # build + kernel checks at small depth only
    python3 chip_smoke.py --out DIR  # also write chip_smoke.json and ptxas.log to DIR
    python3 chip_smoke.py --against DIR  # also time DIR/quadform.cu's float64 kernels
                                         # and DIR/boltzmann.cu's six solver kernels

Phases, each printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``), versions.
2. ``build``   — compiles ``eftpipe_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   sm_90a into ``build/eftpipe_tpu_torch/`` (seconds, registers and spills
   per source, and its tensor-core instructions: DMMA and HGMMA in the SASS).
3. ``kernel_checks`` — every CUDA kernel against its plain PyTorch version in
   float64 on the same inputs: float32 (``quadform_tc.cu``, 3xTF32 on the
   tensor cores) at the flagship's shapes and at a small ragged shape,
   float64 (``quadform.cu``, the float64 tensor cores) at small ragged
   shapes (W·S no multiple of the column tiles; separates an indexing fault
   from rounding), at the float64 analysis' shapes and, for ``cf_half``, at
   the fold check's shape.  The matrices' kernel layout is made once per shape, as
   the model does it for its tables and for the fold check's complex
   matrices, and the timed calls reuse it (``prepared``, ``ms``); ``fly_ms``
   times the same calls with the layout made in each.  Times by
   ``torch.cuda.Event`` over distinct inputs.
4. ``main_path`` — builds the default flagship model (two tracers, full
   default widths, survey window, solver-emulator cosmology, float32, dense
   quadratic forms through the kernels) on the card, evaluates ``logp`` at 64
   seeded points, compares with the port's float64 plain path (|dlogp| <
   0.02), runs the complex A/B check of the Hermitian fold in float32 and,
   on the float64 model, in float64 (the float64 kernels; relative
   difference < 1e-9), then times
   batches of 1024 walkers and the stage prefixes.  The kernels' launch
   counters are set to 0 just before and read just after.  One more batch is
   traced with ``torch.profiler`` (``profile`` line: device time by kernel,
   the device's idle share, and the host-device synchronisations one
   ``logp`` call makes, by torch's sync debug mode).
5. ``main_path_lite`` — the same for the flagship without window and with the
   Eisenstein–Hu cosmology: the 64-point check, one timed batch of 256 and
   its profile.
6. ``stages`` — one LRG tracer pipeline with window (the LRG NGC window
   multipoles of ``tests/goldens/window_input_lrg_ngc.npz``), integral
   constraint and fiber collisions, and one with a window matrix, each in
   float32 at W=64 against the float64 plain path (same µ quadrature); the
   bias-contracted multipoles are held to the 1e-4 budget.
7. ``sampling`` — the sampling path on the default flagship (float32,
   kernels): ``gradient`` (autograd of ``logp`` on the 64 seeded points
   against the float64 plain path, ``grad_max_rel_err`` < 1e-2; ``logp`` and
   ``logp`` + backward timed at W=256 and 1024; the backward's peak memory;
   the ``qf_real`` backward against its forward kernel, by CUDA events and
   under ``torch.profiler``), ``stretch`` (``MCMCDriver`` with 1024 walkers,
   10 steps written to a checkpoint, then resumed to 15) and ``hmc``
   (``MCMCDriver(sampler_kind="hmc")``, 64 chains, 10 warmup and 10
   sampling steps).  Each sampler path counts its ``logp`` calls and its
   kernel launches, which must be 4 per call.
8. ``lowrank`` — the JAX package's float32 route on the default flagship:
   ``build_flagship(quadform="lowrank")`` (truncated-eigenbasis factors at
   the 1e-5 cut, the CF loop premixed), float32.  Two errors on the 64
   seeded points, kept apart: (a) the port's arithmetic, float32 against
   float64 on the same factors (|dlogp| < 0.02 and multipoles < 1e-4, or
   the script fails); (b) the truncation, float64 low-rank against float64
   dense (reported, not gated: the reference's own approximation).  Every
   model of the two comparisons is built with the Gauss-Legendre µ
   quadrature in both dtypes (``ap_quadrature="gauss_legendre"``), so that
   (a) is rounding alone, in ``logp`` and in the multipoles; the multipoles
   come from each model's own tracer pipelines on float64 cosmology
   inputs.  Also ``evals_per_s`` at W=1024
   beside the dense kernel route's (in turns), the ranks of the factors and
   the seconds to build them, peak memory, host syncs per ``logp``, and the
   ``qf_real`` launches of the route (none: it is two matmuls).  Then the
   options table: tol in {1e-8, 1e-5, 1e-4} × premix on/off, each with
   error (b), its ranks and its ``nonlinear`` stage time at W=1024.
9. ``analysis`` — the config-driven analysis (``Analysis.from_config``, its
   config built as a dict): LRG (z=0.70, l=0,2,4), ELG (z=0.845, l=0,2,
   chained) and their cross X, each with IR resummation, AP and a survey
   window (``window_nmax=2048``), solver-emulator cosmology, west-coast
   basis, b2/b4 computed from c2/c4 by a lambda string, Jeffreys
   marginalisation, binned mock data from ``nonlinear_Plk_grid`` at the
   fiducial point and its Gaussian covariance.  Float32 through the kernels
   against the float64 plain path on the 64 seeded points (|dlogp| < 0.02),
   ``logp`` timed at W=1024, its host syncs (0) and its ``qf_real`` launches
   (two per tracer pipeline: 6 per ``logp``), ``laplace_cov`` at theta0
   (finite, positive-definite), ``run_mcmc`` (stretch, 256 walkers,
   ``init="laplace"``, 10 steps to a checkpoint, resumed to 15),
   ``ChainProducts`` + ``BestfitModel`` (finite chi2); then a template-fit
   config (``fixed_template``, LRG) whose ``qf_real`` launches happen at
   build (``freeze_template``) and never in ``logp``; the same three-tracer
   analysis in float64 through the float64 kernels (the CLI's
   ``--dtype float64``), held against the float64 plain path on the 64
   seeded points (|dlogp| <= 1e-6: both float64, only the order of the sums
   differs) and its ``logp`` timed at W=1024; and a float32 LRG
   analysis on the ``emulator`` provider (a transfer-function MLP file
   written here with NumPy in the JAX package's ``TransferEmulator.save``
   layout, seeded weights) against its float64 plain path (|dlogp| < 0.02).
10. ``solver`` — the Einstein-Boltzmann solver (``boltzmann/thermo.py``,
   ``boltzmann/einstein_boltzmann.py``, kernels ``recomb_scan`` and
   ``eb_solve`` of ``csrc/boltzmann.cu``): (c) the full-width solve of the
   JAX solver's golden sample (``tests/goldens/solver_sample_4d_heldout.npz``:
   13 z × 288 k, the schedule over the corners of the box the golden was
   made with, the golden's cosmology in one slot of a W=4 batch of seeded
   cosmologies of that box), |Δ log T| ≤ 1e-6 and |Δ log r_drag| ≤ 1e-7; (a)
   ``recomb_scan`` against its plain version (W=4, a 4096-point grid,
   relative error ≤ 1e-10); (b) ``eb_solve`` against its plain version
   (W=2, the two shortest buckets of the 4-D training recipe and one mode of
   the longest cut to 1,500 steps, TCA and post-TCA steps, ≤ 1e-9 of the
   largest |value| of δ_m, δ_cb and ζ_ini); (e) seconds per solve at W=1, 4,
   16 and 64 on the 4-D training recipe (``--sample-mnu``: the schedule over
   the 16 corners of the wide box and the mass axis), each kernel's time
   alone, its bound (float64 operations counted from the source at the
   card's 34 TFLOP/s float64 rate; beside it, in this line only, two models
   of the longest mode's critical path: one float64 operation a cycle on one
   thread, and the latency chain of the warp design's step), the kernel's
   microseconds a step of the longest mode (``us_per_step_longest``); (d) a
   float32 LRG ``Analysis`` on the ``solver`` provider at W=4:
   finite ``logp`` and the launches of ``eb_solve``, ``recomb_scan`` and
   ``qf_real`` in one ``logp`` call; (f) the recurrence by phase
   (``recomb_phases``): ``recomb_scan`` on (e)'s W=4 batch and
   ``recomb_scan_jvp`` on its W·P = 8 rows in (ω_cdm, h), each timed once
   on the fine grid cut at the batch's first Peebles step (the Saha block
   alone) and once whole: µs a step in the Saha block and after it, the
   block's steps.
10b. ``solver_grad`` — the solver's gradient on the card (forward mode: the
   tangent kernels ``recomb_scan_jvp`` and ``eb_solve_jvp``, the same source
   as the forward kernels on a dual number, driven by
   ``einstein_boltzmann._SolverTables``): (a) ``recomb_scan_jvp`` against
   forward AD of ``recomb_scan_plain`` (on the host) on (a)'s inputs (W=4,
   4096 points) with a seeded tangent in the six table fields, ≤ 1e-9 of the largest
   |tangent|, its primal ≤ 1e-12 from the forward kernel's; (b)
   ``eb_solve_jvp`` against forward AD of ``eb_solve_plain`` on (b)'s
   cosmologies, the shortest bucket and the longest mode cut to 600 steps
   (TCA and after), ≤ 1e-9 of each output's largest |tangent|; (c) the float64
   LRG analysis on the ``solver`` provider (ω_cdm, h, ln10As, b1, c2
   sampled) at W=2: ∇logp through the kernels against central differences
   of its own ``logp`` (two steps, every perturbed point in one batch; each
   component ≤ 1e-5 at the better step), the solver's outputs with and
   without the gradient equal bit for bit and ``logp`` within 1e-12, and
   the launches of one value and gradient (one of each of the four
   kernels: the primal pass takes the forward kernels, the tangent pass only
   the tangent kernels, which give the primal too);
   (d) ``run_mcmc(sampler="hmc", init="ball")`` on the float32 analysis (2
   chains, ``n_leapfrog=1``, ``warmup_steps=1``, 1 step): finite chain
   and gradients, the acceptance rate; (e) seconds per value and gradient
   at W=1 and 4 against seconds per ``logp``, and the tangent kernels alone
   on the W·P rows of a W=4 value and gradient beside the forward kernels
   on the same rows, with their bounds, ``us_per_step_longest`` and the
   warp step model of the provider's longest mode.
10c. ``solver_hessian`` — the solver's second derivative on the card (the
   hyper-dual kernels ``recomb_scan_jvp2`` and ``eb_solve_jvp2``, the same
   source on a value, two first-order parts and a mixed part, driven by
   ``EBSolver.table_hessians`` from the double backward of
   ``_SolverTables``): (a) ``recomb_scan_jvp2`` against
   ``recomb_scan_plain`` on hyper-dual operands (on the host), two box
   cosmologies' pair rows in (ω_cdm, h) on a 1024-point grid, and
   ``eb_solve_jvp2`` against ``eb_solve_plain`` on hyper-dual tables, the
   longest mode of the 4-D recipe cut to 500 steps (TCA and after), seeded
   parts: every part ≤ 1e-9 of its output's largest |part|, the value and
   the first-order part ≤ 1e-12 from the forward and the tangent kernels';
   (b) ``Analysis._hessian(θ₀)`` of the float64 LRG analysis on the
   ``solver`` provider, each row against central differences of its ∇logp
   (two steps, one batch; ≤ 1e-4 of the row's largest |entry| at the better
   step), symmetric to 1e-8; (c) the solver's outputs, ``logp`` and the
   gradient of a seeded loss of the solver's outputs with the gradient's
   graph and without it, bit for bit, ∇logp within 1e-12 (torch's matmul
   takes another route in the EFT path's backward when the gradient
   requires grad), the Hessian again bit for bit, a value and
   gradient's launches (one of each of the first four kernels, none of the
   second-order ones), one Hessian's (one of each of the six); (d)
   ``laplace_cov()`` of the float64 and float32 analyses finite and
   positive-definite, and ``run_mcmc(sampler="hmc", init="laplace")`` on the
   float32 one (2 chains, 1 step) finite; (e) seconds a Hessian, the jet
   pass alone, the two kernels on the Hessian's own inputs (W·Q = 15 rows)
   beside the forward kernels on the same rows, their bounds.
11. ``training`` — the shipped P(k) artifact retrained at full width by
   ``eftpipe_tpu_torch/tools/train_solver_emulator.py``'s library functions
   (``--n 512 --inner-frac 0.35 --degree 8 --degree-in 7 --ncomp 96``: 512
   solves of 288 k × 13 z on the envelope of the 3-D box's 8 corners, 64 a
   call, in a temporary workdir; the PCA + ridge fit and its inner blend),
   against the package's copy of ``pk_emulator_mnu06.npz``: (a) the
   normalisations, boxes and blend equal bit for bit; (b) both artifacts'
   predictions (``PkEmulator.raw``, float64 on the card) at the 51 held-out
   points and 256 seeded points of the box and the blend region, |Δ log T|
   ≤ 1e-6 and |Δ log r_drag| ≤ 1e-7; (c) the fit's validation report beside
   the errors the artifact's commit states; (d) the ``SolverEmulatorProvider``
   on the retrained file against the shipped one (float64 ``plin`` and
   ``f`` at 64 seeded points, relative ≤ 1e-6); (e) 8 ``eb_solve`` and 8
   ``recomb_scan`` launches; (f) seconds by stage and cosmologies/s.
12. ``transfer_training`` — ``train_transfer_emulator`` at the JAX defaults
   (2,048 EH98 samples, width 128, depth 3, 3,000 steps, batch 256, lr
   3e-3) in float32 on the card: max |T_emu/T_EH − 1| < 0.02 at the JAX
   suite's held-out point on its k grid, the worst of 256 seeded points,
   steps/s, and a save → ``TransferEmulator.load`` → ``EmulatorProvider``
   round trip.
13. ``mesh`` (after ``main_path_lite``, on its model) — a one-rank NCCL
   group formed on the card: ``MCMCDriver(mesh=walker_mesh())`` (stretch,
   256 walkers, 4 steps) and ``HMC(mesh=...)`` (16 chains, 5 warmup + 5
   steps), each equal bit for bit to the same run without the mesh on the
   same seed; the collectives a step and their share of the step time (the
   time of one ``all_gather`` of a half-ensemble's values, alone).
With ``--against DIR`` the ``against`` line follows ``kernel_checks``: another
``quadform.cu`` with the same C interface (for example the parent commit's,
copied into a git-ignored directory) is built there and its float64 kernels
are checked and timed beside this tree's at the timed float64 shapes, in
turns (theirs, ours, ours, theirs) on the same inputs.  Where DIR holds a
``boltzmann.cu`` of the same C interface, it is built into the build
directory, and its kernels are timed beside this tree's in the same
turns: ``eb_solve`` and ``recomb_scan`` at each W of the ``solver`` phase's
(e), ``eb_solve_jvp``, ``eb_solve`` and ``recomb_scan_jvp``,
``recomb_scan`` at the W·P rows of ``solver_grad``'s (e), ``eb_solve_jvp2``
and ``recomb_scan_jvp2`` on the W·Q rows of ``solver_hessian``'s (e), each
with its speedup and its largest difference from ours, absolute and
relative to each output's largest |value| (the recurrence's also whether
its Saha block is the same bits); ``against`` entries of those lines, the
recurrence's phase split in (f) too; their registers and spills in the
``against_build`` line.  A ``boltzmann.cu`` that includes headers needs
them beside it (copy the commit's ``csrc/``).

14. ``kernels`` line (launches by path, ``training`` and ``mesh`` among
   them; every kernel instance, float32 and float64 ``qf_real`` and
   ``cf_half``, ``eb_solve`` and ``recomb_scan``, ``eb_solve_jvp`` and
   ``recomb_scan_jvp``, ``eb_solve_jvp2`` and ``recomb_scan_jvp2``, must
   appear), the card's
   ``nvidia-smi`` line, and the final ``{"ok": true, "device": {...}}`` line.

Any failed check raises: the exit code is then non-zero and no final line is
printed.  Imports nothing but the port (``eftpipe_tpu_torch``), torch, numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import forward_ad

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available() is False)\n")
    sys.exit(2)

from eftpipe_tpu_torch.analysis import BestfitModel, ChainProducts
from eftpipe_tpu_torch.api.flagship import build_flagship, synthetic_mask_file, FIDUCIAL, TRACERS
from eftpipe_tpu_torch.api.orchestrate import Analysis
from eftpipe_tpu_torch.boltzmann.eh98 import eh98_pk
from eftpipe_tpu_torch.likelihood.covariance import GaussianCovariance, Multipole
from eftpipe_tpu_torch.boltzmann.eh98 import eh98_transfer
from eftpipe_tpu_torch.boltzmann.emulator import (DEFAULT_BOUNDS, DEFAULT_PK_ARTIFACT,
                                                   EmulatorProvider, PkEmulator,
                                                   SolverEmulatorProvider, TransferEmulator,
                                                   train_transfer_emulator)
from eftpipe_tpu_torch.boltzmann import _kernels as bk, einstein_boltzmann as eb, jet, thermo
from eftpipe_tpu_torch.boltzmann.dual import DenseTangents, tangent_or_zeros
from eftpipe_tpu_torch.likelihood.parambasis import WestCoastBasis
from eftpipe_tpu_torch.models.ap import lcdm_da, lcdm_hubble
from eftpipe_tpu_torch.models.config import EFTConfig
from eftpipe_tpu_torch.models.nonlinear import LOWRANK_TOL, lowrank_tables_numpy
from eftpipe_tpu_torch.models.pipeline import CosmoInputs, TracerPipeline
from eftpipe_tpu_torch.ops import _build, quadform as qf
from eftpipe_tpu_torch.parallel.hmc import HMC
from eftpipe_tpu_torch.parallel.mcmc import MCMCDriver
from eftpipe_tpu_torch.parallel.mesh import walker_mesh
from eftpipe_tpu_torch.tools import train_solver_emulator as train_tool

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, "chip_smoke_workdir")
GOLDENS = os.path.join(ROOT, "tests", "goldens")

# published peaks of one H100 SXM (data sheet, dense): device-memory rate, the
# FMA rates outside the tensor cores (a reference only: the float64 kernel
# runs there), the float64 tensor-core rate (the card's peak for float64) and
# the TF32 tensor-core rate, of which the float32 kernels' 3xTF32 split (three
# TF32 products per float32-grade product) gets a third
HBM_BYTES_PER_S = 3.35e12
FMA_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
FP64_TC_FLOPS = 67e12
TF32_FLOPS = 495e12
PEAK_NAME = {torch.float32: "3xTF32: three TF32 tensor-core passes at 495 TFLOP/s",
             torch.float64: "67 TFLOP/s float64 on the tensor cores"}
LOGP_ABS_BUDGET = 0.02
# float64 kernels against the float64 plain path: the same arithmetic in
# another order of summation
LOGP64_ABS_BUDGET = 1e-6
FOLD64_REL_BUDGET = 1e-9
MULTIPOLE_REL_BUDGET = 1e-4  # tests/test_accuracy_budget.py
CHUNK_TRIALS = (256, 512)  # walker chunks tried, beside the whole batch
LITE_BATCH = 256
GRAD_REL_BUDGET = 1e-2
QF_PER_LOGP = 4  # qf_real launches of one logp call: two per tracer
# the analysis phase's qf_real launches of one logp call: two per tracer
# pipeline (P22 and the CF loop, models/nonlinear.py::nonlinear_pscf), three
# pipelines (LRG, ELG, X); a frozen template launches none per logp
QF_PER_ANALYSIS_LOGP = 6
ANALYSIS_KOUT = np.round(np.arange(0.01, 0.2049, 0.005), 6)
LOWRANK_OPTIONS = (1e-8, 1e-5, 1e-4)  # the options table's cuts (1e-5: the default)
# counterterms of the multipole comparisons, at the scales of their priors
COUNTERTERMS = dict(b3=0.5, cct=1.0, cr1=2.0, cr2=1.0, ce0=1.0, cequad=0.5)

REPLACES = {
    "qf_real": "eftpipe_tpu/ops/pallas_kernels.py:313",
    "cf_half": "eftpipe_tpu/ops/pallas_kernels.py:58",
}
SOURCE = {torch.float32: "eftpipe_tpu_torch/csrc/quadform_tc.cu",
          torch.float64: "eftpipe_tpu_torch/csrc/quadform.cu"}


def emit(phase: str, **payload) -> dict:
    line = dict(phase=phase, **payload)
    print(json.dumps(line), flush=True)
    return line


def ptxas_summary(log: str) -> list:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output."""
    rows, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = dict(kernel=line.split("'")[1], registers=None, spill_stores=None,
                       spill_loads=None)
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            parts = line.replace(",", "").split()
            cur["spill_stores"] = int(parts[parts.index("spill") - 2])
            cur["spill_loads"] = int(parts[parts.index("loads") - 3])
        elif cur is not None and "Used " in line and " registers" in line:
            cur["registers"] = int(line.split("Used ")[1].split(" registers")[0])
    return rows


def sass_counts(lib_path: str) -> dict:
    """Tensor-core instructions in a built library's SASS (``cuobjdump -sass``
    beside ``nvcc``): DMMA (float64 ``mma.sync``) and HGMMA (``wgmma``)."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return dict(note="not measured: no cuobjdump beside nvcc")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120).stdout
    return {op: sum(1 for line in sass.splitlines() if op in line) for op in ("DMMA", "HGMMA")}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, inputs, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn(x)`` over the distinct ``inputs`` (one call
    each), after ``warmup`` calls on the first, by CUDA events."""
    for _ in range(warmup):
        fn(inputs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in inputs:
        fn(x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(inputs)


def bound(kernel: str, dtype, nw: int, n: int, s: int, bl: int):
    """Least time for the work: each input read once, each output written
    once, against the operations at the card's peak for their type
    (float32: three TF32 tensor-core products per product, float64: the
    float64 tensor cores).  Only the symmetric part of M enters the forms,
    so the operations counted are those of its lower triangle: N(N+1)/2
    multiply-adds per vector and output, plus the reduction against z.
    Also returns the bound of the same operations at the FMA rate outside
    the tensor cores (float32: 67, float64: 34 TFLOP/s)."""
    sz = torch.empty((), dtype=dtype).element_size()
    nz = 1 if kernel == "qf_real" else 2
    nbytes = sz * (bl * n * n + nz * nw * n * s + nz * nw * bl * s)
    flops = nz * (1.0 * nw * bl * n * (n + 1) * s + 2.0 * nz * nw * bl * n * s)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fma = flops / FMA_FLOPS[dtype] * 1e3
    t_ops = (3.0 * flops / TF32_FLOPS if dtype == torch.float32 else flops / FP64_TC_FLOPS) * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), flops, nbytes,
            t_fma)


def check_kernel(kernel: str, dtype, nw: int, n: int, s: int, bl: int,
                 gen: torch.Generator, n_timed: int) -> dict:
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)


    nz = 1 if kernel == "qf_real" else 2
    m = rand(bl, n, n).to(dtype)
    # the kernel layout of m, made once as the model makes it for its tables
    lay = qf.kernel_matrices(m)
    # distinct inputs for every timed call; the first is also the checked one
    zs = [tuple(rand(nw, n, s).to(dtype) for _ in range(nz)) for _ in range(n_timed)]
    if kernel == "qf_real":
        run = lambda z: qf.qf_real_cuda(z[0], m, lay)
        run_fly = lambda z: qf.qf_real_cuda(z[0], m)
        plain = lambda z: qf.qf_real_plain(z[0], m)
        ref = qf.qf_real_plain(zs[0][0].double(), m.double())
        got = run(zs[0])
        fly = qf.qf_real_cuda(zs[0][0], m)  # layout made on the fly
        library = lambda z: torch.einsum("wns,bnm,wms->wbs", z[0], m, z[0])
        pairs = [(got, ref)]
        same = bool(torch.equal(fly, got))
    else:
        run = lambda z: qf.cf_half_cuda(m, z[0], z[1], lay)
        run_fly = lambda z: qf.cf_half_cuda(m, z[0], z[1])
        plain = lambda z: qf.cf_half_plain(m, z[0], z[1])
        ref = qf.cf_half_plain(m.double(), zs[0][0].double(), zs[0][1].double())
        got = run(zs[0])
        fly = qf.cf_half_cuda(m, zs[0][0], zs[0][1])  # layout made on the fly
        mc = m.to(torch.complex64 if dtype == torch.float32 else torch.complex128)
        library = lambda z: torch.einsum(
            "wns,bnm,wms->wbs", torch.complex(z[0], z[1]), mc, torch.complex(z[0], z[1]))
        pairs = list(zip(got, ref))
        same = all(bool(torch.equal(a, b)) for a, b in zip(fly, got))
    # `same`: the two launches agree bitwise (sums in a fixed order)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        rtol, atol_rel = 2e-4, 2e-3   # sums of N² terms taken in another order
    else:
        rtol, atol_rel = 1e-10, 1e-10
    max_abs_err, ok = 0.0, same
    for g, r in pairs:
        if g.shape != r.shape or not torch.isfinite(g).all():
            ok = False
            continue
        err = (g.double() - r).abs()
        tol = rtol * r.abs() + atol_rel * r.abs().max()
        max_abs_err = max(max_abs_err, float(err.max()))
        ok = ok and bool((err <= tol).all())
    scale = float(max(r.abs().max() for _, r in pairs))
    lib_check = library(zs[0])
    lib_ok = bool(((lib_check.real if lib_check.is_complex() else lib_check).double()
                   - pairs[0][1]).abs().max() <= 1e-2 * scale)
    kernel_ms = event_ms(run, zs)
    fly_ms = event_ms(run_fly, zs)
    plain_ms = event_ms(plain, zs, warmup=1)
    library_ms = event_ms(library, zs, warmup=1) if lib_ok else None
    bound_ms, bound_by, flops, nbytes, bound_fma_ms = bound(kernel, dtype, nw, n, s, bl)
    row = dict(
        name=f"{kernel}[{qf._SUFFIX[dtype]},W={nw},BL={bl},N={n},S={s}]",
        kernel=kernel, dtype=qf._SUFFIX[dtype], W=nw, BL=bl, N=n, S=s,
        route="cuda", source=SOURCE[dtype], replaces=REPLACES[kernel],
        max_abs_err=max_abs_err, ref_scale=scale,
        tolerance=f"|d| <= {rtol}*|ref| + {atol_rel}*max|ref| vs plain float64",
        ok=ok, repeat_bitwise=same, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, peak=PEAK_NAME[dtype],
        bound_fma_ms=bound_fma_ms, prepared=True, fly_ms=fly_ms,
        layout=list(lay.shape), flops=flops, bytes_min=nbytes,
        tflops=flops / (kernel_ms * 1e-3) / 1e12,
    )
    if not ok:
        raise SystemExit(f"chip_smoke: kernel check failed: {json.dumps(row)}")
    return row


def against_rows(src_dir: str, shapes, gen: torch.Generator) -> list:
    """Build ``src_dir/quadform.cu`` (float64 C interface of this tree's
    ``csrc/quadform.cu``) and time its kernels beside this tree's on the same
    inputs, in turns; both are checked against the float64 plain version."""
    import ctypes

    lib_path = os.path.join(src_dir, "libquadform_against.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(src_dir, "quadform.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.eft_qf_real_f64.argtypes = [ptr] * 3 + [i] * 5 + [ptr]
    lib.eft_cf_half_f64.argtypes = [ptr] * 5 + [i] * 5 + [ptr]
    lib.eft_quadform_pad.restype = i
    pad = lib.eft_quadform_pad()
    rows = []
    for kernel, nw, n, s, bl in shapes:
        dev = torch.device("cuda")
        m = torch.randn(bl, n, n, generator=gen, device=dev, dtype=torch.float64)
        ours_lay, their_lay = qf.kernel_matrices(m), qf.tril_fold(m, pad)
        nz = 1 if kernel == "qf_real" else 2
        zs = [[torch.randn(nw, n, s, generator=gen, device=dev, dtype=torch.float64)
               for _ in range(nz)] for _ in range(3)]
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def theirs(z):
            outs = [torch.empty((nw, bl, s), dtype=torch.float64, device=dev) for _ in range(nz)]
            if kernel == "qf_real":
                code = lib.eft_qf_real_f64(z[0].data_ptr(), their_lay.data_ptr(), outs[0].data_ptr(),
                                           nw, n, their_lay.shape[-1], s, bl, stream())
            else:
                code = lib.eft_cf_half_f64(their_lay.data_ptr(), z[0].data_ptr(), z[1].data_ptr(),
                                           outs[0].data_ptr(), outs[1].data_ptr(),
                                           nw, n, their_lay.shape[-1], s, bl, stream())
            if code != 0:
                raise SystemExit(f"chip_smoke: --against kernel failed to launch ({code})")
            return outs

        if kernel == "qf_real":
            ours = lambda z: [qf.qf_real_cuda(z[0], m, ours_lay)]
            ref = [qf.qf_real_plain(zs[0][0], m)]
        else:
            ours = lambda z: list(qf.cf_half_cuda(m, z[0], z[1], ours_lay))
            ref = list(qf.cf_half_plain(m, zs[0][0], zs[0][1]))
        errs = {name: max(float((g - r).abs().max()) for g, r in zip(fn(zs[0]), ref))
                for name, fn in (("theirs", theirs), ("ours", ours))}
        turns = [event_ms(fn, zs) for fn in (theirs, ours, ours, theirs)]
        rows.append(dict(kernel=kernel, dtype="f64", W=nw, N=n, S=s, BL=bl, against=src_dir,
                         their_pad=pad, their_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
                         their_max_abs_err=errs["theirs"], max_abs_err=errs["ours"]))
    return rows


def accuracy_batch(theta0: np.ndarray) -> np.ndarray:
    """The 64 seeded points of the JAX package's benchmark accuracy gate:
    seeds 0-3, 16 points each, theta0·(1 + 1e-3·N(0,1))."""
    parts = []
    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        parts.append(theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((16, theta0.size))))
    return np.concatenate(parts, axis=0)


def host_ms_over(fn, inputs) -> float:
    """Mean host milliseconds of ``fn(x)`` over the distinct ``inputs[1:]``,
    after a call on ``inputs[0]``; the timed calls end in a synchronisation."""
    fn(inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs[1:]:
        fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (len(inputs) - 1) * 1e3


def host_ms(fn, n: int = 3) -> float:
    return host_ms_over(lambda _: fn(), [None] * (n + 1))


def kernel_rows(fn) -> list:
    """(kernel name, device µs, calls) of one call of ``fn`` under
    ``torch.profiler`` (CUPTI), largest first; empty where the machine
    traces no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # a host-side op: its device time is its kernels', counted below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((ev.key, float(us), int(ev.count)))
    return sorted(rows, key=lambda r: -r[1])


def profile_batch(fn, wall_seconds: float, top: int = 8) -> dict:
    """Device time of one call of ``fn`` by kernel name and the device's
    idle share against ``wall_seconds``, the host time of the same call
    measured WITHOUT the profiler."""
    rows = kernel_rows(fn)
    if not rows:  # no device tracing on this machine: a measurement, not a check
        return dict(device_busy_ms=None, device_idle_share=None, note="not measured")
    busy_ms = sum(r[1] for r in rows) / 1e3
    return dict(device_busy_ms=busy_ms, wall_ms=wall_seconds * 1e3,
                device_idle_share=1.0 - busy_ms / (wall_seconds * 1e3),
                kernels_seen=len(rows),
                top=[dict(name=k[:80], ms=us / 1e3, calls=n) for k, us, n in rows[:top]])


def sync_sites(fn) -> list:
    """The places where one call of ``fn`` synchronised the host with the
    card (torch's sync debug mode: one warning per synchronising operation,
    at the Python line that issued it)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            if "synchronizing" in str(w.message)]


def flagship_path(phase: str, model_name: str, build_kw: dict, nb: int, n_timed: int,
                  chunk_trials: tuple, full: bool, lines: list) -> dict:
    """Drive one flagship configuration: build float32 (kernels) and float64
    (plain) models, the 64-point |dlogp| check against the float64 path,
    ``n_timed`` timed batches of ``nb`` walkers and a profiled batch; with
    ``full`` also the fold A/B check, stage prefixes and peak memory.  Launch
    counters are zeroed just before the counted window and read just after;
    returns the launches by shape."""
    f32, f64 = torch.float32, torch.float64
    workdir = os.path.join(WORKDIR, phase)
    t0 = time.perf_counter()
    model = build_flagship(workdir, dtype=f32, **build_kw)
    phase_a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_model = build_flagship(workdir, dtype=f64, quadform="plain", **build_kw)
    phase_a_ref_s = time.perf_counter() - t0
    thetas = accuracy_batch(model.theta0)
    rng = np.random.default_rng(10)
    batches = [torch.as_tensor(
        model.theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((nb, model.theta0.size))),
        dtype=f32, device="cuda") for _ in range(n_timed + 1)]
    extra = {}
    with torch.no_grad():
        # untimed, uncounted: the float64 plain reference and the chunk choice
        lp_ref = ref_model.logp(thetas).cpu().numpy()
        model.logp(thetas)  # warm-up (cuBLAS handles, kernel attributes)
        chunk = nb
        if chunk_trials:
            chunk_ms = {c: host_ms(lambda c=c: model.logp(batches[-1], chunk=c), n=2)
                        for c in chunk_trials + (nb,)}
            chunk = min(chunk_ms, key=chunk_ms.get)
            extra["chunk_trial_ms"] = chunk_ms
        else:
            model.logp(batches[-1])
        nchunks = -(-nb // chunk)

        qf.reset_launch_counts()
        lp = model.logp(thetas)
        if full:
            ab_ref, ab_fold = model.fold_ab_check(thetas, tracer="LRG", ell_index=0)
            # the same on the float64 model: its fold check runs through the
            # float64 kernels (cf_half twice, qf_real once)
            ab64_ref, ab64_fold = ref_model.fold_ab_check(thetas, tracer="LRG", ell_index=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [model.logp(b, chunk=chunk) for b in batches[:n_timed]]
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t0) / n_timed
        launches = dict(qf.LAUNCHES)
        by_shape = dict(qf.LAUNCHES_BY_SHAPE)

        if full:
            # float32 emulator inputs against float64 ones on the same points
            inputs32, _ = model.cosmo_inputs(torch.as_tensor(thetas, dtype=f32, device="cuda"))
            inputs64, _ = ref_model.cosmo_inputs(torch.as_tensor(thetas, dtype=f64, device="cuda"))
            extra["plin_f32_max_rel"] = max(
                float((inputs32[t].plin.double() / inputs64[t].plin - 1).abs().max())
                for t in inputs64)

            # stage prefixes at the timed batch (uncounted), cumulative ms
            def prefix(stop):
                def run():
                    inputs, _ = model.cosmo_inputs(batches[0])
                    for name, spec in model.like.tracers.items():
                        spec.pipeline.compute_bird(inputs[name], stop_after=stop)
                return run
            stage_ms = {"cosmology": host_ms(lambda: model.cosmo_inputs(batches[0]))}
            for stop in ("nonlinear", "IRresum", "APeffect", "window"):
                stage_ms[stop] = host_ms(prefix(stop))
            stage_ms["logp"] = host_ms(lambda: model.logp(batches[0]))
            torch.cuda.reset_peak_memory_stats()
            model.logp(batches[0], chunk=chunk)
            extra.update(stage_prefix_ms=stage_ms,
                         peak_memory_bytes=torch.cuda.max_memory_allocated())
        trace = profile_batch(lambda: model.logp(batches[0], chunk=chunk), batch_s)
        syncs = sync_sites(lambda: model.logp(batches[0], chunk=chunk))
        trace.update(host_syncs_per_logp=len(syncs), sync_sites=sorted(set(syncs)))

    lp_np = lp.double().cpu().numpy()
    dlogp = float(np.abs(lp_np - lp_ref).max())
    expected_qf = 4 + 4 * n_timed * nchunks + (2 if full else 0)
    expected_cf = 4 if full else 0
    finite = bool(np.isfinite(lp_np).all() and np.isfinite(lp_ref).all()
                  and all(torch.isfinite(t).all() for t in timed))
    if full:
        extra["fold_ab_rel_err"] = float((ab_ref - ab_fold).abs().max() / ab_fold.abs().max())
        extra["fold_ab_rel_err_float64"] = float(
            (ab64_ref - ab64_fold).abs().max() / ab64_fold.abs().max())
    lines.append(emit(
        phase, model=model_name, dtype="float32", reference="float64 plain path on the card",
        phase_a_seconds=phase_a_s, phase_a_reference_seconds=phase_a_ref_s,
        n_points=int(lp_np.size), all_finite=finite, max_abs_dlogp=dlogp,
        budget=LOGP_ABS_BUDGET, logp_range=[float(lp_ref.min()), float(lp_ref.max())],
        launches=launches, expected_qf_real=expected_qf, expected_cf_half=expected_cf,
        batch=nb, chunk=chunk, batch_seconds=batch_s, evals_per_s=nb / batch_s, **extra))
    lines.append(emit("profile", path=phase, batch=nb, chunk=chunk, **trace))
    if lp_np.shape != (64,) or any(t.shape != (nb,) for t in timed):
        raise SystemExit(f"chip_smoke: {phase}: logp has the wrong shape")
    if not finite:
        raise SystemExit(f"chip_smoke: {phase}: non-finite logp")
    if dlogp >= LOGP_ABS_BUDGET:
        raise SystemExit(f"chip_smoke: {phase}: |dlogp| {dlogp} outside the {LOGP_ABS_BUDGET} budget")
    if full and extra["fold_ab_rel_err"] > 2e-3:
        raise SystemExit(f"chip_smoke: folded and complex CF loops disagree "
                         f"({extra['fold_ab_rel_err']})")
    if full and not extra["fold_ab_rel_err_float64"] < FOLD64_REL_BUDGET:
        raise SystemExit(f"chip_smoke: folded and complex CF loops disagree in float64 "
                         f"({extra['fold_ab_rel_err_float64']})")
    if launches["qf_real"] != expected_qf or launches["cf_half"] != expected_cf:
        raise SystemExit(f"chip_smoke: {phase}: launch counts {launches}, expected "
                         f"qf_real={expected_qf}, cf_half={expected_cf}")
    return by_shape, model, ref_model


def value_and_grad(model, thetas):
    """(logp, ∇logp) of a walker batch: one forward, one backward."""
    x = thetas.detach().requires_grad_(True)
    lp = model.logp(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def device_ms(fn) -> tuple:
    """Device milliseconds of one call of ``fn`` under ``torch.profiler``,
    in total and the top kernels by name (None where not measured)."""
    rows = kernel_rows(fn)
    if not rows:
        return None, []
    return (sum(r[1] for r in rows) / 1e3,
            [dict(name=k[:80], ms=us / 1e3, calls=n) for k, us, n in rows[:4]])


def qf_backward_rows(gen: torch.Generator, shapes) -> list:
    """The ``qf_real`` backward (plain torch, ``qf_real_backward_plain``)
    at the path's shapes: its time by CUDA events over distinct inputs, the
    forward kernel's in the same call, their device times under the
    profiler, the one-call einsum of the same function, and the bound of its
    operations (the full N² of (M + Mᵀ) w, plus the contraction with g) at
    the 67 TFLOP/s float32 FMA rate against its bytes."""
    dev, f32 = torch.device("cuda"), torch.float32
    rows = []
    for nw, n, s, bl in shapes:
        m = torch.randn(bl, n, n, generator=gen, device=dev, dtype=f32)
        lay = qf.kernel_matrices(m)
        ins = [(torch.randn(nw, n, s, generator=gen, device=dev, dtype=f32),
                torch.randn(nw, bl, s, generator=gen, device=dev, dtype=f32)) for _ in range(3)]
        bwd = lambda x: qf.qf_real_backward_plain(x[1], x[0], m)
        fwd = lambda x: qf.qf_real_cuda(x[0], m, lay)
        msym = m + m.transpose(-1, -2)
        library = lambda x: torch.einsum("wbs,bnm,wms->wns", x[1], msym, x[0])
        ref = qf.qf_real_backward_plain(ins[0][1].double(), ins[0][0].double(), m.double())
        err = float((bwd(ins[0]).double() - ref).abs().max())
        bwd_ms, fwd_ms = event_ms(bwd, ins, warmup=1), event_ms(fwd, ins)
        library_ms = event_ms(library, ins, warmup=1)
        bwd_dev, bwd_top = device_ms(lambda: bwd(ins[1]))
        fwd_dev, _ = device_ms(lambda: fwd(ins[1]))
        flops = 2.0 * nw * bl * n * n * s + 2.0 * nw * bl * n * s
        nbytes = 4 * (bl * n * n + 2 * nw * n * s + nw * bl * s)
        t_ops, t_bytes = flops / FMA_FLOPS[f32] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            name=f"qf_real_backward[f32,W={nw},BL={bl},N={n},S={s}]", route="plain torch",
            W=nw, BL=bl, N=n, S=s, ms=bwd_ms, forward_kernel_ms=fwd_ms, library_ms=library_ms,
            device_ms=bwd_dev, forward_device_ms=fwd_dev, top=bwd_top,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
            max_abs_err_vs_float64=err, ref_scale=float(ref.abs().max())))
    return rows


class Counted:
    """A callable (a model's bound ``logp``) that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def sampling_phase(model, ref_model, lines: list) -> dict:
    """The sampling path on the default flagship: gradient accuracy and
    cost, a stretch-move run with checkpoint and resume, an HMC run.
    Returns the launches by shape of each sampler path."""
    f32, f64, dev = torch.float32, torch.float64, torch.device("cuda")
    thetas = accuracy_batch(model.theta0)
    _, g32 = value_and_grad(model, torch.as_tensor(thetas, dtype=f32, device=dev))
    _, g64 = value_and_grad(ref_model, torch.as_tensor(thetas, dtype=f64, device=dev))
    rel = ((g32.double() - g64).norm(dim=-1) / g64.norm(dim=-1)).cpu().numpy()
    rng = np.random.default_rng(11)
    timing = {}
    for nb in (256, 1024):
        batches = [torch.as_tensor(
            model.theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((nb, model.theta0.size))),
            dtype=f32, device=dev) for _ in range(4)]
        with torch.no_grad():
            logp_ms = host_ms_over(model.logp, batches)
        vg_ms = host_ms_over(lambda x: value_and_grad(model, x), batches)
        timing[str(nb)] = dict(logp_ms=logp_ms, value_and_grad_ms=vg_ms,
                               backward_share=1.0 - logp_ms / vg_ms)
    torch.cuda.reset_peak_memory_stats()
    value_and_grad(model, batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    syncs = sync_sites(lambda: value_and_grad(model, batches[0]))
    gen = torch.Generator(device=dev).manual_seed(4321)
    backward = qf_backward_rows(gen, [(64, 255, 80, 114), (256, 255, 80, 114),
                                      (1024, 255, 80, 114), (1024, 255, 80, 76),
                                      (1024, 255, 50, 28)])
    worst = float(rel.max())
    lines.append(emit("sampling", part="gradient", n_points=int(rel.size),
                      reference="float64 plain path on the card", grad_max_rel_err=worst,
                      budget=GRAD_REL_BUDGET, grad_finite=bool(torch.isfinite(g32).all()),
                      timing_by_batch=timing, peak_memory_bytes=peak,
                      host_syncs_per_value_and_grad=len(syncs),
                      sync_sites=sorted(set(syncs)), qf_real_backward=backward))
    if not bool(torch.isfinite(g32).all()) or not worst < GRAD_REL_BUDGET:
        raise SystemExit(f"chip_smoke: sampling: float32 gradient off by {worst}")

    by_path = {}
    x0 = torch.as_tensor(model.theta0, dtype=f32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- stretch: 10 steps to a checkpoint, then resumed to 15 ---------
        counted = Counted(model.logp)
        kw = dict(logp=counted, ndim=9, nwalkers=1024, block=5, rhat_tol=-1.0,
                  out=os.path.join(tmp, "stretch"), device=dev)
        qf.reset_launch_counts()
        t0 = time.perf_counter()
        first = MCMCDriver(**kw).run(seed=0, x0=x0, max_steps=10)
        resumed_driver = MCMCDriver(**kw)
        res = resumed_driver.run(seed=0, max_steps=15)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(qf.LAUNCHES)
        by_path["stretch"] = dict(qf.LAUNCHES_BY_SHAPE)
        calls = counted.calls
        expected_calls = 3 * (1 + 2 * 5)  # three blocks of five steps
        # uncounted: one more block of the sampler alone, timed and then
        # under the sync debug mode
        walkers = torch.as_tensor(res.chain[-1], device=dev)
        block = lambda: resumed_driver.sampler.run(
            torch.Generator(device=dev).manual_seed(1), walkers, 5)
        block_s = host_ms(block, n=1) / 1e3
        syncs = sync_sites(block)
        extended = (res.chain.shape == (15, 1024, 9)
                    and bool(np.array_equal(res.chain[:10], first.chain)))
        finite = bool(np.isfinite(res.logps).all())
        lines.append(emit(
            "sampling", part="stretch", nwalkers=1024, block=5, steps=15,
            resumed_from=10, chain_shape=list(res.chain.shape), extended=extended,
            all_finite=finite, seconds=seconds, steps_per_s=15 / seconds,
            evals_per_s=1024 * 15 / seconds, accept_rate=res.accept_rate,
            sampler_block_seconds=block_s, sampler_evals_per_s=1024 * 5 / block_s,
            logp_calls=calls, expected_logp_calls=expected_calls,
            launches=launches, expected_qf_real=QF_PER_LOGP * calls,
            host_syncs_per_step=len(syncs) / 5, sync_sites=sorted(set(syncs))))
        if not extended or not finite:
            raise SystemExit("chip_smoke: stretch: the resumed chain did not extend the first")
        if calls != expected_calls or launches["qf_real"] != QF_PER_LOGP * calls:
            raise SystemExit(f"chip_smoke: stretch: {calls} logp calls and launches "
                             f"{launches}, expected {expected_calls} and 4 per call")

        # ---- hmc: 10 warmup transitions, then two blocks of five ----------
        counted = Counted(model.logp)
        driver = MCMCDriver(logp=counted, ndim=9, sampler_kind="hmc", nwalkers=64,
                            n_leapfrog=4, warmup_steps=10, block=5, rhat_tol=-1.0,
                            inv_mass0=(1e-2 * model.theta0) ** 2,
                            out=os.path.join(tmp, "hmc"), device=dev)
        qf.reset_launch_counts()
        t0 = time.perf_counter()
        res = driver.run(seed=0, x0=x0, max_steps=10)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(qf.LAUNCHES)
        by_path["hmc"] = dict(qf.LAUNCHES_BY_SHAPE)
        calls = counted.calls
        # uncounted: two more transitions under the sync debug mode
        walkers = torch.as_tensor(res.chain[-1], device=dev)
        syncs = sync_sites(lambda: driver.sampler.run(
            torch.Generator(device=dev).manual_seed(1), walkers, 2))
    eps = driver.sampler.eps.cpu().numpy()
    inv_mass = driver.sampler.inv_mass.cpu().numpy()
    ok = (bool(np.isfinite(res.logps).all()) and res.accept_rate > 0.0
          and bool(np.isfinite(eps).all()) and bool(np.isfinite(inv_mass).all()))
    lines.append(emit(
        "sampling", part="hmc", nchains=64, n_leapfrog=4, warmup_steps=10, steps=10,
        chain_shape=list(res.chain.shape), all_finite=bool(np.isfinite(res.logps).all()),
        accept_rate=res.accept_rate, eps=float(eps), inv_mass=inv_mass.tolist(),
        seconds=seconds, grads_per_s=64 * calls / seconds,
        logp_calls=calls, launches=launches, expected_qf_real=QF_PER_LOGP * calls,
        host_syncs_per_step=len(syncs) / 2, sync_sites=sorted(set(syncs))))
    if not ok:
        raise SystemExit("chip_smoke: hmc: non-finite chain or metric, or nothing accepted")
    if launches["qf_real"] != QF_PER_LOGP * calls:
        raise SystemExit(f"chip_smoke: hmc: launches {launches} for {calls} logp calls")
    return by_path


def multipole_rel_err(got: dict, ref: dict) -> float:
    """Worst |got − ref| / max(|ref|, 1e-3·max|ref|) over tracers, the metric
    of tests/test_accuracy_budget.py."""
    worst = 0.0
    for name, r in ref.items():
        r = r.double()
        scale = torch.clamp(r.abs(), min=1e-3 * float(r.abs().max()))
        worst = max(worst, float(((got[name].double() - r).abs() / scale).max()))
    return worst


def model_pipelines(model) -> dict:
    """A flagship model's tracer pipelines, each with the binning matrix of
    its data k grid."""
    return {n: (spec.pipeline, model.like.runtimes[n].binning_tables)
            for n, spec in model.like.tracers.items()}


def pipeline_multipoles(pipes: dict, inputs: dict, params: dict) -> dict:
    """(W, nl, nk) binned multipoles of each tracer: the bird after the last
    stage contracted with the walkers' biases and ``COUNTERTERMS``."""
    out = {}
    for name, (pipe, binning) in pipes.items():
        _, _, prod = pipe.product(pipe.compute_bird(inputs[name]), binning=binning)
        out[name] = WestCoastBasis(prefix=f"{name}_").reduce_plk(pipe.cfg, prod, params).sum()
    return out


def lowrank_ranks(factors: dict) -> dict:
    """Kept eigenpairs R of each factor set (and the padded rows of Q)."""
    return {key: dict(R=qf.lowrank_rank(factors["s" + key]), rows=int(factors["q" + key].shape[0]))
            for key in ("22", "cf", "cfg")}


def lowrank_phase(model, ref_model, lines: list) -> dict:
    """The JAX package's float32 route on the default flagship (see the
    module docstring, phase 8).  Returns the route's launches by shape (none
    expected)."""
    f32, f64, dev = torch.float32, torch.float64, torch.device("cuda")
    workdir = os.path.join(WORKDIR, "main_path")   # the main path's data and caches
    cfgs = {name: spec.pipeline.cfg for name, spec in model.like.tracers.items()}
    factor_s, ranks = {}, {}
    for tol in LOWRANK_OPTIONS:                    # the factors alone, cold, per cut
        factor_s[tol], ranks[tol] = 0.0, {}
        for name, cfg in cfgs.items():
            t0 = time.perf_counter()
            factors = lowrank_tables_numpy(cfg, tol)
            factor_s[tol] += time.perf_counter() - t0
            ranks[tol][name] = lowrank_ranks(factors)
    # every model of the error comparisons takes the same µ quadrature (16
    # Gauss-Legendre nodes, the float32 default; float64 would take the
    # 200-point trapezoid), so that two dtypes differ by rounding alone
    gl = "gauss_legendre"
    t0 = time.perf_counter()
    lr32 = build_flagship(workdir, dtype=f32, quadform="lowrank", ap_quadrature=gl)
    build_s = time.perf_counter() - t0
    lr64 = build_flagship(workdir, dtype=f64, quadform="lowrank", ap_quadrature=gl)
    dense64 = build_flagship(workdir, dtype=f64, quadform="plain", ap_quadrature=gl)
    thetas = accuracy_batch(model.theta0)
    t64 = torch.as_tensor(thetas, dtype=f64, device=dev)
    rng = np.random.default_rng(13)
    nb, n_timed = 1024, 3
    batches = [torch.as_tensor(
        model.theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((nb, model.theta0.size))),
        dtype=f32, device=dev) for _ in range(n_timed + 1)]

    # multipoles: float64 cosmology inputs (cast for float32), the walkers'
    # biases and fixed counterterms, through the models' own pipelines
    inputs64, params64 = ref_model.cosmo_inputs(t64)
    params64 = dict(params64, **{f"{n}_{k}": torch.full((t64.shape[0],), v, dtype=f64, device=dev)
                                 for n in TRACERS for k, v in COUNTERTERMS.items()})
    inputs32 = {n: CosmoInputs(*(x.to(f32) for x in ci)) for n, ci in inputs64.items()}
    params32 = {k: v.to(f32) for k, v in params64.items()}
    with torch.no_grad():
        lp_dense64 = dense64.logp(t64).cpu().numpy()
        lp_lr64 = lr64.logp(t64).cpu().numpy()
        lr32.logp(batches[-1])                                  # warm-up
        qf.reset_launch_counts()
        lp_lr32 = lr32.logp(thetas)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [lr32.logp(b) for b in batches[:n_timed]]
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t0) / n_timed
        launches = dict(qf.LAUNCHES)
        by_shape = dict(qf.LAUNCHES_BY_SHAPE)
        # the two routes in turns, uncounted: dense, low-rank, low-rank, dense
        turns = [("dense", model), ("lowrank", lr32), ("lowrank", lr32), ("dense", model)]
        turn_ms = [(route, host_ms_over(m.logp, batches)) for route, m in turns]
        syncs = sync_sites(lambda: lr32.logp(batches[0]))
        torch.cuda.reset_peak_memory_stats()
        lr32.logp(batches[0])
        peak = torch.cuda.max_memory_allocated()
        mp = {key: pipeline_multipoles(model_pipelines(m), inputs32 if key == "lr32" else inputs64,
                                       params32 if key == "lr32" else params64)
              for key, m in (("lr32", lr32), ("lr64", lr64), ("dense64", dense64))}
        trace = profile_batch(lambda: lr32.logp(batches[0]), batch_s)

        # the options table: error (b) of each cut and CF form, its ranks, its
        # nonlinear stage at W=1024 (float32, cosmology excluded)
        inputs_w, _ = model.cosmo_inputs(batches[0])

        def nonlinear_ms(m):
            return host_ms(lambda: [s.pipeline.compute_bird(inputs_w[n], stop_after="nonlinear")
                                    for n, s in m.like.tracers.items()])
        dense_nl_ms = nonlinear_ms(model)
        options = []
        for tol in LOWRANK_OPTIONS:
            m64, m32 = (lr64, lr32) if tol == LOWRANK_TOL else (
                build_flagship(workdir, dtype=dt, quadform="lowrank", lowrank_tol=tol,
                               ap_quadrature=gl) for dt in (f64, f32))
            pipelines = [s.pipeline for m in (m64, m32) for s in m.like.tracers.values()]
            for premix in (True, False):
                for p in pipelines:
                    p.cf_premix = premix
                lp = m64.logp(t64).cpu().numpy()
                options.append(dict(
                    tol=tol, cf_premix=premix,
                    R={n: dict(p22=r["22"]["R"], cf=r["cfg" if premix else "cf"]["R"])
                       for n, r in ranks[tol].items()},
                    max_abs_dlogp_vs_dense64=float(np.abs(lp - lp_dense64).max()),
                    multipole_rel_err_vs_dense64=multipole_rel_err(
                        pipeline_multipoles(model_pipelines(m64), inputs64, params64),
                        mp["dense64"]),
                    nonlinear_ms_w1024=nonlinear_ms(m32)))
            for p in pipelines:
                p.cf_premix = True

    lp_np = lp_lr32.double().cpu().numpy()
    err_a = dict(max_abs_dlogp=float(np.abs(lp_np - lp_lr64).max()),
                 multipole_max_rel_err=multipole_rel_err(mp["lr32"], mp["lr64"]))
    err_b = dict(max_abs_dlogp=float(np.abs(lp_lr64 - lp_dense64).max()),
                 multipole_max_rel_err=multipole_rel_err(mp["lr64"], mp["dense64"]))
    finite = bool(np.isfinite(lp_np).all() and all(torch.isfinite(x).all() for x in timed))
    ms = {route: [t for r, t in turn_ms if r == route] for route in ("dense", "lowrank")}
    line = emit(
        "lowrank", model="default flagship, quadform=lowrank, tol=1e-5, cf_premix on",
        dtype="float32", n_points=int(lp_np.size), all_finite=finite,
        error_a_arithmetic=dict(err_a, reference="float64 low-rank, same factors",
                                budget=dict(dlogp=LOGP_ABS_BUDGET,
                                            multipoles=MULTIPOLE_REL_BUDGET)),
        error_b_truncation=dict(err_b, reference="float64 dense (plain) path", gated=False),
        ap_quadrature="16 Gauss-Legendre nodes in both dtypes",
        logp_range=[float(lp_dense64.min()), float(lp_dense64.max())],
        ranks=ranks[LOWRANK_TOL], factor_build_seconds=factor_s[LOWRANK_TOL],
        phase_a_seconds=build_s, batch=nb, batch_seconds=batch_s, evals_per_s=nb / batch_s,
        turns_ms=turn_ms, lowrank_evals_per_s=[nb / t * 1e3 for t in ms["lowrank"]],
        dense_kernel_evals_per_s=[nb / t * 1e3 for t in ms["dense"]],
        nonlinear_ms_w1024=dict(dense_kernel=dense_nl_ms),
        peak_memory_bytes=peak, host_syncs_per_logp=len(syncs), sync_sites=sorted(set(syncs)),
        launches=launches, expected_qf_real=0,
        device_busy_ms=trace.get("device_busy_ms"),
        device_idle_share=trace.get("device_idle_share"), top=trace.get("top"),
        options=options, options_factor_build_seconds=factor_s,
        options_ranks=ranks)
    lines.append(line)
    checks = {
        "finite logp": finite,
        f"(a) |dlogp| {err_a['max_abs_dlogp']} < {LOGP_ABS_BUDGET}":
            err_a["max_abs_dlogp"] < LOGP_ABS_BUDGET,
        f"(a) multipoles {err_a['multipole_max_rel_err']} < {MULTIPOLE_REL_BUDGET}":
            err_a["multipole_max_rel_err"] < MULTIPOLE_REL_BUDGET,
        f"launches {launches} (the route launches no kernel)":
            launches["qf_real"] == 0 and launches["cf_half"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: lowrank: failed {failed}")
    return by_shape


def stage_files(workdir: str) -> dict:
    """Inputs of the stage pipelines: the LRG NGC window multipoles of the
    committed golden, and seeded synthetic integral-constraint tables and a
    window matrix in the upstream ("Florian") layout."""
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(2024)
    mask = os.path.join(workdir, "win_lrg_ngc.txt")
    np.savetxt(mask, np.load(os.path.join(GOLDENS, "window_input_lrg_ngc.npz"))["table"])

    s = np.geomspace(1.0, 4000.0, 600)
    roll = 1.0 / (1.0 + (s / 350.0) ** 3)
    sn = os.path.join(workdir, "icc_sn.txt")
    np.savetxt(sn, np.column_stack([s, roll**2, 0.05 * roll**2, 0.01 * roll**2]))
    sgrid = np.geomspace(2.0, 1500.0, 60)
    g = 1.0 / (1.0 + (sgrid / 300.0) ** 2)
    rows = []
    for il1, l1 in enumerate((0.0, 2.0, 4.0)):
        for il2, l2 in enumerate((0.0, 2.0, 4.0)):
            amp = (1.0 + 0.05 * rng.standard_normal()) / (1.0 + il1 + il2)
            for i, s1 in enumerate(sgrid):
                for j, s2 in enumerate(sgrid):
                    rows.append([l1, l2, s1, s2, amp * g[i] * g[j]])
    ic = os.path.join(workdir, "icc_ic.npy")
    np.save(ic, np.asarray(rows))

    kout = (np.linspace(0, 0.4, 41)[1:] + np.linspace(0, 0.4, 41)[:-1]) / 2
    kin = (np.linspace(0, 0.4, 401)[1:] + np.linspace(0, 0.4, 401)[:-1]) / 2
    mrows = []
    for lo in range(5):
        for ko in kout:
            mrows.append(np.hstack([
                (1.0 if lo == 2 * li else 0.05 / (1 + abs(lo - 2 * li)))
                * np.exp(-((kin - ko) ** 2) / (2 * 0.01**2)) for li in range(3)]))
    wm = os.path.join(workdir, "florian.txt")
    np.savetxt(wm, np.asarray(mrows) * (1 + 0.01 * rng.standard_normal((200, 1200))))
    return dict(mask=mask, sn=sn, ic=ic, wm=wm)


def stages_check(nw: int, lines: list) -> None:
    """LRG pipelines with window + icc + fiber and with a window matrix:
    float32 through the kernels against the float64 plain path (both on the
    Gauss–Legendre µ quadrature, so that the comparison isolates rounding):
    the multipoles P_l(k) of the bird after the last stage contracted with
    fixed bias parameters, held to the 1e-4 budget relative to
    max(|P_l(k)|, 1e-3·max|P|), the metric of tests/test_accuracy_budget.py."""
    f32, f64 = torch.float32, torch.float64
    workdir = os.path.join(WORKDIR, "stages")
    files = stage_files(workdir)
    zeff = 0.70
    om_fid = (FIDUCIAL["omega_b"] + FIDUCIAL["omega_cdm"]) / FIDUCIAL["h"] ** 2
    cfg = EFTConfig(nl=3, no=3, nd_a=5e-5)
    common = dict(zeff=zeff, with_irresum=True, cache_dir=os.path.join(workdir, "cache"),
                  apeffect=dict(om_ap=om_fid, z_ap=zeff, rdrag_ap=147.66,
                                hubble_ap=FIDUCIAL["h"], quadrature="gauss_legendre"))
    configs = {
        "window+icc+fiber": dict(
            window=dict(window_configspace_file=files["mask"], nmax=2048),
            icc=dict(pshot=1.0 / 5e-5, icc_configspace_sn_file=files["sn"],
                     icc_configspace_ic_file=files["ic"], nmax=1024, nxmax=512, nymax=512),
            fiber=dict(fs=0.6, dfc=0.43 / 0.6777, ktrust=0.25)),
        "window_matrix": dict(
            window_matrix=dict(path=files["wm"], ells=[0, 2, 4], kmin=0.01, kmax=0.2,
                               window_st=True)),
    }
    provider = SolverEmulatorProvider.load(cfg=cfg, zeff=zeff, da_fid=lcdm_da(om_fid, zeff),
                                           h_fid=lcdm_hubble(om_fid, zeff))
    rng = np.random.default_rng(7)
    params = {k: torch.as_tensor(v * (1.0 + 1e-2 * rng.standard_normal(nw)), dtype=f64,
                                 device="cuda") for k, v in FIDUCIAL.items()}
    with torch.no_grad():
        x64 = provider.inputs(params)
    x32 = CosmoInputs(*(t.to(f32) for t in x64))
    basis = WestCoastBasis(prefix="")
    bias = dict(b1=2.2, b2=0.8, b3=0.5, b4=0.8, cct=1.0, cr1=2.0, cr2=1.0, ce0=1.0,
                cequad=0.5)
    bias64 = {k: torch.full((nw,), v, dtype=f64, device="cuda") for k, v in bias.items()}
    bias32 = {k: v.to(f32) for k, v in bias64.items()}
    for label, stage_kw in configs.items():
        t0 = time.perf_counter()
        p32 = TracerPipeline.build(cfg, dtype=f32, **common, **stage_kw)
        p64 = TracerPipeline.build(cfg, dtype=f64, quadform="plain", **common, **stage_kw)
        build_s = time.perf_counter() - t0
        qf.reset_launch_counts()
        with torch.no_grad():
            b32 = p32.compute_bird(x32)
            torch.cuda.synchronize()
            launches = dict(qf.LAUNCHES)
            b64 = p64.compute_bird(x64)
            ms = host_ms(lambda: p32.compute_bird(x32))
        # the P_l(k) a likelihood sees: the bird contracted with LRG biases
        # and counterterms at the scales of their priors (W, nl, nk)
        plk32 = basis.reduce_plk(cfg, b32, bias32).sum().double()
        plk64 = basis.reduce_plk(cfg, b64, bias64).sum()
        if not bool(torch.isfinite(plk32).all()):
            raise SystemExit(f"chip_smoke: stages {label}: non-finite multipoles")
        worst = multipole_rel_err({"LRG": plk32}, {"LRG": plk64})
        # per field of the bird, each against its own largest entry (reported)
        field_rel = {f: float((getattr(b32, f).double() - getattr(b64, f)).abs().max()
                              / getattr(b64, f).abs().max())
                     for f in ("p11l", "ploopl", "pctl", "pstl", "picc")
                     if float(getattr(b64, f).abs().max()) > 0.0}
        lines.append(emit("stages", pipeline=f"LRG nl=3 {label}", W=nw, dtype="float32",
                          reference="float64 plain path on the card, same mu quadrature",
                          multipoles_shape=list(plk32.shape), max_rel_err=worst,
                          budget=MULTIPOLE_REL_BUDGET, field_max_err_over_max=field_rel,
                          compute_bird_ms=ms, build_seconds=build_s, launches=launches))
        if worst >= MULTIPOLE_REL_BUDGET:
            raise SystemExit(f"chip_smoke: stages {label}: multipoles off by {worst}")
        if launches["qf_real"] != 2:
            raise SystemExit(f"chip_smoke: stages {label}: launch counts {launches}")


def analysis_config(workdir: str, with_like: bool = True) -> dict:
    """The production-shaped three-tracer analysis as a config dict: LRG and
    ELG with their cross X, each with IR resummation, AP and a survey window
    from ``synthetic_mask_file``; solver-emulator cosmology; b2/b4 computed
    from c2/c4; Jeffreys marginalisation; ELG chained."""
    om_fid = (FIDUCIAL["omega_b"] + FIDUCIAL["omega_cdm"]) / FIDUCIAL["h"] ** 2
    default = {
        "with_IRresum": True,
        "with_APeffect": {"Om_AP": om_fid, "rdrag_AP": 147.66, "h_AP": FIDUCIAL["h"]},
        "boltzmann": {"name": "solver_emulator", "om_fid": om_fid},
    }
    tracers = {"default": default,
               "LRG": {"z": 0.70, "nd": 5e-5, "ls": [0, 2, 4]},
               "ELG": {"z": 0.845, "nd": 1.85e-4, "ls": [0, 2, 4]},
               "X": {"z": 0.77, "ls": [0, 2], "cross": ["LRG", "ELG"]}}
    for name, smask in (("LRG", 350.0), ("ELG", 250.0), ("X", 300.0)):
        mask = os.path.join(workdir, f"mask_{name}.txt")
        if not os.path.exists(mask):
            synthetic_mask_file(mask, smask)
        tracers[name]["with_window"] = {"window_configspace_file": mask, "Nmax": 2048}
    params = {
        "omega_b": FIDUCIAL["omega_b"], "ns": FIDUCIAL["ns"],
        "omega_cdm": {"prior": {"min": 0.09, "max": 0.15}, "ref": FIDUCIAL["omega_cdm"]},
        "h": {"prior": {"min": 0.55, "max": 0.80}, "ref": FIDUCIAL["h"]},
        "ln10As": {"prior": {"min": 2.5, "max": 3.5}, "ref": FIDUCIAL["ln10As"]},
    }
    for name, b1, c2 in (("LRG", 2.2, 0.8 * 2 ** 0.5), ("ELG", 1.3, 0.5 * 2 ** 0.5)):
        params.update({
            f"{name}_b1": {"prior": {"min": 0.5, "max": 4.0}, "ref": b1},
            f"{name}_c2": {"prior": {"min": -4.0, "max": 4.0}, "ref": c2},
            f"{name}_c4": 0.0,
            f"{name}_b2": f"lambda {name}_c2, {name}_c4: ({name}_c2 + {name}_c4) / np.sqrt(2.)",
            f"{name}_b4": f"lambda {name}_c2, {name}_c4: ({name}_c2 - {name}_c4) / np.sqrt(2.)",
        })
    info = {"theory": {"cache_dir": os.path.join(workdir, "cache"), "tracers": tracers},
            "params": params}
    if with_like:
        prior = {"b3": {"scale": 2.0}, "cct": {"scale": 4.0}, "cr1": {"scale": 8.0},
                 "cr2": {"scale": 4.0}, "ce0": {"scale": 4.0}, "cequad": {"scale": 2.0}}
        info["likelihood"] = {
            "tracers": ["LRG", "ELG", "X"],
            "data": {n: {"path": os.path.join(workdir, f"data_{n}.txt"), "ls": ls,
                         "kmin": kmin, "kmax": kmax}
                     for n, ls, kmin, kmax in (("LRG", [0, 2, 4], 0.01, 0.20),
                                               ("ELG", [0, 2], 0.03, 0.20),
                                               ("X", [0, 2], 0.03, 0.15))},
            "cov": os.path.join(workdir, "cov.txt"),
            "chained": {"ELG": True}, "binned": True, "jeffreys": True,
            "marg": {"LRG_": prior, "ELG_": prior,
                     "X_": {"ce0": {"scale": 2.0}, "cequad": {"scale": 2.0}}},
        }
    return info


def analysis_mock_data(workdir: str, info: dict) -> None:
    """Binned mock multipoles of each tracer at the fiducial point (float64
    plain path on the card) and their block-diagonal Gaussian covariance
    (volume 4 (Gpc/h)^3, shot noise 1/nd), written into ``workdir``."""
    th = Analysis.from_config(info, dtype=torch.float64, device="cuda", quadform="plain")
    fid = th.space.to_dict(th.space.theta0())  # fixed, sampled and computed
    kout = ANALYSIS_KOUT
    shot = {"LRG": 1 / 5e-5, "ELG": 1 / 1.85e-4, "X": 0.0}
    blocks = []
    with torch.no_grad():
        for name, chained in (("LRG", False), ("ELG", True), ("X", False)):
            ls, _, plk = th.nonlinear_Plk_grid(name, fid, chained=chained, binned=True, kout=kout)
            plk = plk.double().cpu().numpy()
            np.savetxt(os.path.join(workdir, f"data_{name}.txt"),
                       np.column_stack([kout] + [plk[i] for i in range(len(ls))]),
                       header="k " + " ".join(f"P{l}" for l in ls))
            kedges = np.concatenate([kout - 0.0025, [kout[-1] + 0.0025]])
            mp = Multipole(p0=plk[0] + shot[name] + 1e3, p2=plk[1],
                           p4=plk[2] if len(ls) > 2 else None)
            blocks.append(GaussianCovariance(kedges, volume=4.0)(ls, ls, "aa->aaaa", mp))
    from scipy.linalg import block_diag

    np.savetxt(os.path.join(workdir, "cov.txt"), block_diag(*blocks))


def template_check(workdir: str) -> dict:
    """The template-fit mode on one LRG tracer (``fixed_template``, full
    widths, float32 kernels): ``freeze_template`` launches ``qf_real`` at
    build (twice, at W=1), ``logp`` launches it no time."""
    k = np.logspace(-5, 0, 400)
    cosmo = [torch.full((1,), FIDUCIAL[n], dtype=torch.float64)
             for n in ("omega_b", "omega_cdm", "h", "ln10As", "ns")]
    plin = os.path.join(workdir, "plin.txt")
    np.savetxt(plin, np.column_stack([k, eh98_pk(torch.as_tensor(k), *cosmo, 0.7)[0][0].numpy()]))
    info = {"theory": {"cache_dir": os.path.join(workdir, "cache"), "tracers": {"LRG": {
        "z": 0.7, "nd": 5e-5, "ls": [0, 2, 4], "with_IRresum": True,
        "boltzmann": {"name": "fixed_template", "path": plin}}}},
        "params": {"f": {"prior": {"min": 0.4, "max": 1.2}, "ref": 0.8},
                   "LRG_b1": {"prior": {"min": 1.0, "max": 4.0}, "ref": 2.2},
                   "LRG_b2": 0.8, "LRG_b4": 0.8}}
    with torch.no_grad():
        th = Analysis.from_config(info, dtype=torch.float64, device="cuda", quadform="plain")
        ls, _, plk = th.nonlinear_Plk_grid("LRG", {"f": 0.8, "LRG_b1": 2.2}, binned=True,
                                           kout=ANALYSIS_KOUT)
    plk = plk.double().cpu().numpy()
    np.savetxt(os.path.join(workdir, "data_tpl.txt"),
               np.column_stack([ANALYSIS_KOUT] + list(plk)), header="k P0 P2 P4")
    np.savetxt(os.path.join(workdir, "cov_tpl.txt"),
               np.diag((0.02 * np.abs(plk).ravel() + 10.0) ** 2))
    info["likelihood"] = {"tracers": ["LRG"], "cov": os.path.join(workdir, "cov_tpl.txt"),
                          "data": {"LRG": {"path": os.path.join(workdir, "data_tpl.txt"),
                                           "ls": [0, 2, 4], "kmin": 0.01, "kmax": 0.2}}}
    qf.reset_launch_counts()
    an = Analysis.from_config(info, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    at_build = dict(qf.LAUNCHES)
    thetas = torch.as_tensor(accuracy_batch(an.space.theta0()).repeat(16, axis=0)[:1024],
                             dtype=torch.float32, device="cuda")
    qf.reset_launch_counts()
    with torch.no_grad():
        lp = an.logp(thetas)
        torch.cuda.synchronize()
        per_logp = dict(qf.LAUNCHES)
        ms = host_ms(lambda: an.logp(thetas))
    return dict(qf_real_launches_at_build=at_build["qf_real"],
                qf_real_launches_per_logp=per_logp["qf_real"], logp_ms_w1024=ms,
                all_finite=bool(torch.isfinite(lp).all()))


def write_transfer_emulator(path: str, seed: int = 0, width: int = 16, depth: int = 2) -> str:
    """An ``emulator`` provider's file, written with NumPy in the JAX
    package's ``TransferEmulator.save`` layout from seeded weights (no
    training): log T(k) is the EH98 transfer at the box's centre plus a
    small tanh MLP whose last layer is smooth in log k."""
    rng = np.random.default_rng(seed)
    k = np.logspace(-5.5, 0.5, 160)                            # 1/Mpc
    lo, hi = np.array([0.020, 0.09, 0.60, 0.90]), np.array([0.024, 0.15, 0.76, 1.02])
    x_mean, x_std = 0.5 * (lo + hi), (hi - lo) / np.sqrt(12.0)
    xm = torch.as_tensor(x_mean)
    t_mid = eh98_transfer(torch.as_tensor(k), xm[0], xm[0] + xm[1], xm[2])[0]
    u = (np.log(k) - np.log(k[0])) / (np.log(k[-1]) - np.log(k[0]))
    smooth = np.stack([np.cos(np.pi * j * u) for j in range(4)])
    sizes = [4] + [width] * depth
    params = [{"w": rng.standard_normal((a, b)) / np.sqrt(a), "b": 0.1 * rng.standard_normal(b)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    params.append({"w": rng.standard_normal((width, 4)) / np.sqrt(width) @ smooth,
                   "b": np.zeros(k.size)})
    TransferEmulator(params=params, kgrid=k, x_mean=x_mean, x_std=x_std,
                     y_mean=np.log(t_mid.numpy()), y_std=np.full(k.size, 0.05)).save(path)
    return path


def emulator_check(workdir: str) -> dict:
    """A float32 LRG analysis (IR, AP, window at nmax 2048, kernels) on the
    ``emulator`` provider against its float64 plain path on the 64 seeded
    points, on binned mock data of the float64 path at the fiducial point."""
    om_fid = (FIDUCIAL["omega_b"] + FIDUCIAL["omega_cdm"]) / FIDUCIAL["h"] ** 2
    emu = write_transfer_emulator(os.path.join(workdir, "transfer_emulator.npz"))
    info = {"theory": {"cache_dir": os.path.join(workdir, "cache"), "tracers": {"LRG": {
        "z": 0.70, "nd": 5e-5, "ls": [0, 2, 4], "with_IRresum": True,
        "with_APeffect": {"Om_AP": om_fid, "rdrag_AP": 147.66, "h_AP": FIDUCIAL["h"]},
        "with_window": {"window_configspace_file": os.path.join(workdir, "mask_LRG.txt"),
                        "Nmax": 2048},
        "boltzmann": {"name": "emulator", "path": emu, "om_fid": om_fid}}}},
        "params": {"omega_b": FIDUCIAL["omega_b"], "ns": FIDUCIAL["ns"],
                   "omega_cdm": {"prior": {"min": 0.09, "max": 0.15}, "ref": FIDUCIAL["omega_cdm"]},
                   "h": {"prior": {"min": 0.60, "max": 0.76}, "ref": FIDUCIAL["h"]},
                   "ln10As": {"prior": {"min": 2.5, "max": 3.5}, "ref": FIDUCIAL["ln10As"]},
                   "LRG_b1": {"prior": {"min": 0.5, "max": 4.0}, "ref": 2.2},
                   "LRG_b2": 0.8, "LRG_b4": 0.8}}
    with torch.no_grad():
        th = Analysis.from_config(info, dtype=torch.float64, device="cuda", quadform="plain")
        ls, _, plk = th.nonlinear_Plk_grid("LRG", th.space.to_dict(th.space.theta0()),
                                           binned=True, kout=ANALYSIS_KOUT)
    plk = plk.double().cpu().numpy()
    np.savetxt(os.path.join(workdir, "data_emu.txt"),
               np.column_stack([ANALYSIS_KOUT] + list(plk)), header="k P0 P2 P4")
    kedges = np.concatenate([ANALYSIS_KOUT - 0.0025, [ANALYSIS_KOUT[-1] + 0.0025]])
    cov = GaussianCovariance(kedges, volume=4.0)(
        ls, ls, "aa->aaaa", Multipole(p0=plk[0] + 2e4, p2=plk[1], p4=plk[2]))
    np.savetxt(os.path.join(workdir, "cov_emu.txt"), cov)
    info["likelihood"] = {"tracers": ["LRG"], "cov": os.path.join(workdir, "cov_emu.txt"),
                          "data": {"LRG": {"path": os.path.join(workdir, "data_emu.txt"),
                                           "ls": [0, 2, 4], "kmin": 0.01, "kmax": 0.2}},
                          "marg": {"LRG_": {k: {"scale": 2.0} for k in ("b3", "cct", "ce0")}}}
    an = Analysis.from_config(info, dtype=torch.float32, device="cuda")
    ref = Analysis.from_config(info, dtype=torch.float64, device="cuda", quadform="plain")
    thetas = accuracy_batch(an.space.theta0())
    with torch.no_grad():
        lp_ref = ref.logp(thetas).cpu().numpy()
        an.logp(thetas)                                          # warm-up
        qf.reset_launch_counts()
        lp = an.logp(thetas).double().cpu().numpy()
        torch.cuda.synchronize()
        launches = dict(qf.LAUNCHES)
        by_shape = dict(qf.LAUNCHES_BY_SHAPE)
    return dict(provider=type(an.providers["LRG"]).__name__, n_points=int(lp.size),
                all_finite=bool(np.isfinite(lp).all() and np.isfinite(lp_ref).all()),
                max_abs_dlogp=float(np.abs(lp - lp_ref).max()),
                logp_range=[float(lp_ref.min()), float(lp_ref.max())],
                qf_real_launches=launches["qf_real"]), by_shape


def analysis_phase(lines: list) -> dict:
    """The config-driven analysis path; returns the launches by shape of its
    paths: the float32 analysis (the 64-point check and the timed batches),
    the float64 one (its timed batches) and the emulator-provider one."""
    f32, f64 = torch.float32, torch.float64
    workdir = os.path.join(WORKDIR, "analysis")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    analysis_mock_data(workdir, analysis_config(workdir, with_like=False))
    mock_s = time.perf_counter() - t0
    info = analysis_config(workdir)
    t0 = time.perf_counter()
    an = Analysis.from_config(info, dtype=f32, device="cuda")
    phase_a_s = time.perf_counter() - t0
    ref = Analysis.from_config(info, dtype=f64, device="cuda", quadform="plain")
    theta0 = an.space.theta0()
    thetas = accuracy_batch(theta0)
    rng = np.random.default_rng(12)
    nb, n_timed = 1024, 3
    batches = [torch.as_tensor(theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((nb, theta0.size))),
                               dtype=f32, device="cuda") for _ in range(n_timed + 1)]
    with torch.no_grad():
        lp_ref = ref.logp(thetas).cpu().numpy()
        an.logp(batches[-1])                                    # warm-up
        qf.reset_launch_counts()
        lp = an.logp(thetas)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [an.logp(b) for b in batches[:n_timed]]
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t0) / n_timed
        launches = dict(qf.LAUNCHES)
        by_shape = dict(qf.LAUNCHES_BY_SHAPE)
        trace = profile_batch(lambda: an.logp(batches[0]), batch_s)
        syncs = sync_sites(lambda: an.logp(batches[0]))
        torch.cuda.reset_peak_memory_stats()
        an.logp(batches[0])
        peak = torch.cuda.max_memory_allocated()
    lp_np = lp.double().cpu().numpy()
    dlogp = float(np.abs(lp_np - lp_ref).max())
    finite = bool(np.isfinite(lp_np).all() and np.isfinite(lp_ref).all()
                  and all(torch.isfinite(x).all() for x in timed))
    expected_qf = QF_PER_ANALYSIS_LOGP * (1 + n_timed)

    # the Laplace covariance at theta0: float32 kernels, and the float64
    # plain path's for comparison
    qf.reset_launch_counts()
    t0 = time.perf_counter()
    cov = an.laplace_cov()
    laplace_s = time.perf_counter() - t0
    laplace_launches = qf.LAUNCHES["qf_real"]
    cov_ref = ref.laplace_cov()
    evals = np.linalg.eigvalsh(cov)
    laplace_ok = bool(np.isfinite(cov).all() and evals.min() > 0)
    sig, sig_ref = np.sqrt(np.diag(cov)), np.sqrt(np.diag(cov_ref))

    # run_mcmc: stretch, 256 walkers from the Laplace scatter, 10 steps to a
    # checkpoint, then resumed to 15; then the chain's products
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "analysis")
        an.logp, an.derived = Counted(an.logp), Counted(an.derived)
        qf.reset_launch_counts()
        t0 = time.perf_counter()
        first = an.run_mcmc(nwalkers=256, out=out, max_steps=10, block=5, rhat_tol=-1.0,
                            init="laplace", key=0)
        res = an.run_mcmc(nwalkers=256, out=out, max_steps=15, block=5, rhat_tol=-1.0,
                          init="laplace", key=0)
        torch.cuda.synchronize()
        mcmc_s = time.perf_counter() - t0
        mcmc_launches = qf.LAUNCHES["qf_real"]
        logp_calls, derived_calls = an.logp.calls, an.derived.calls
        del an.logp, an.derived
        extended = (res.chain.shape == (15, 256, theta0.size)
                    and bool(np.array_equal(res.chain[:10], first.chain)))
        chains = ChainProducts.from_prefix(out, burn_in=0.3)
        best = BestfitModel.from_chains(an, chains)
        chi2 = best.chi2()
    tpl = template_check(workdir)

    # the same analysis in float64 through the float64 kernels (the CLI's
    # --dtype float64): logp at W=1024, after a warm-up
    an64 = Analysis.from_config(info, dtype=f64, device="cuda")
    batches64 = [b.to(f64) for b in batches]
    with torch.no_grad():
        an64.logp(batches64[-1])
        qf.reset_launch_counts()
        lp64 = an64.logp(torch.as_tensor(thetas, dtype=f64, device="cuda")).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed64 = [an64.logp(b) for b in batches64[:2]]
        torch.cuda.synchronize()
        batch64_s = (time.perf_counter() - t0) / 2
        launches64 = dict(qf.LAUNCHES)
        by_shape64 = dict(qf.LAUNCHES_BY_SHAPE)
    float64 = dict(batch=nb, logp_ms=batch64_s * 1e3, evals_per_s=nb / batch64_s,
                   all_finite=bool(np.isfinite(lp64).all()
                                   and all(torch.isfinite(x).all() for x in timed64)),
                   max_abs_dlogp=float(np.abs(lp64 - lp_ref).max()),
                   budget=LOGP64_ABS_BUDGET, reference="float64 plain path, the 64 points",
                   qf_real_launches=launches64["qf_real"],
                   expected_qf_real=3 * QF_PER_ANALYSIS_LOGP)
    del an64
    emulator, by_shape_emu = emulator_check(workdir)
    line = emit(
        "analysis", config="LRG(l=0,2,4) + ELG(l=0,2 chained) + X=LRGxELG, IR, AP, window "
        "nmax=2048, solver_emulator, westcoast, Jeffreys, binned; nfft_loop=256, nkin=200",
        dtype="float32", reference="float64 plain path on the card",
        ndim=an.space.ndim, sampled=an.space.sampled, ndata=an.like.ndata,
        nmarg=an.like.marginal.nmarg, mock_data_seconds=mock_s, phase_a_seconds=phase_a_s,
        n_points=int(lp_np.size), all_finite=finite, max_abs_dlogp=dlogp,
        budget=LOGP_ABS_BUDGET, logp_range=[float(lp_ref.min()), float(lp_ref.max())],
        batch=nb, logp_ms=batch_s * 1e3, evals_per_s=nb / batch_s, peak_memory_bytes=peak,
        host_syncs_per_logp=len(syncs), sync_sites=sorted(set(syncs)),
        qf_real_launches=launches["qf_real"], expected_qf_real=expected_qf,
        qf_real_per_logp=launches["qf_real"] / (1 + n_timed),
        expected_qf_real_per_logp=QF_PER_ANALYSIS_LOGP,
        laplace=dict(finite=bool(np.isfinite(cov).all()), positive_definite=laplace_ok,
                     min_eigenvalue=float(evals.min()), seconds=laplace_s,
                     qf_real_launches=laplace_launches,
                     sigma_rel_to_float64=float(np.max(np.abs(sig / sig_ref - 1)))),
        run_mcmc=dict(sampler="stretch", nwalkers=256, block=5, steps=15, resumed_from=10,
                      init="laplace", chain_shape=list(res.chain.shape), extended=extended,
                      all_finite=bool(np.isfinite(res.logps).all()),
                      accept_rate=res.accept_rate, seconds=mcmc_s,
                      evals_per_s=256 * 15 / mcmc_s, logp_calls=logp_calls,
                      derived_calls=derived_calls, qf_real_launches=mcmc_launches,
                      expected_qf_real=QF_PER_ANALYSIS_LOGP * (logp_calls + derived_calls)),
        bestfit=dict(chi2=chi2, samples=len(chains.samples)),
        template=tpl, float64=float64, emulator_provider=emulator,
        device_busy_ms=trace.get("device_busy_ms"),
        device_idle_share=trace.get("device_idle_share"), top=trace.get("top"))
    lines.append(line)
    checks = {
        "finite logp": finite,
        f"|dlogp| {dlogp} < {LOGP_ABS_BUDGET}": dlogp < LOGP_ABS_BUDGET,
        f"host syncs per logp {len(syncs)} == 0": not syncs,
        f"qf_real launches {launches['qf_real']} == {expected_qf}": launches["qf_real"] == expected_qf,
        "laplace_cov finite and positive-definite": laplace_ok,
        "stretch chain resumed and extended": extended and bool(np.isfinite(res.logps).all()),
        f"mcmc launches {mcmc_launches}": mcmc_launches == line["run_mcmc"]["expected_qf_real"],
        f"bestfit chi2 {chi2.get('chi2')} finite": bool(np.isfinite(chi2.get("chi2", np.nan))),
        f"template launches {tpl}": (tpl["qf_real_launches_at_build"] == 2
                                     and tpl["qf_real_launches_per_logp"] == 0
                                     and tpl["all_finite"]),
        f"float64 logp {float64}": (float64["all_finite"]
                                    and float64["max_abs_dlogp"] <= LOGP64_ABS_BUDGET
                                    and float64["qf_real_launches"] == 3 * QF_PER_ANALYSIS_LOGP),
        f"emulator provider {emulator}": (emulator["all_finite"]
                                          and emulator["max_abs_dlogp"] < LOGP_ABS_BUDGET
                                          and emulator["qf_real_launches"] == 2),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: analysis: failed {failed}")
    return {"analysis": by_shape, "analysis_float64": by_shape64,
            "analysis_emulator": by_shape_emu}


# ---------------------------------------------------------------------------
# the Einstein-Boltzmann solver (phase 10)
# ---------------------------------------------------------------------------
# float64 operations of one step, counted in the kernels' source
# (csrc/boltzmann.cu; adds, multiplies, divides and comparisons once each,
# pow/exp/sqrt once each): recomb_scan ~225 a fine-grid step (two T_M steps,
# three Peebles rates, two implicit solves); eb_solve ~5,700 an RK4 step
# (four right-hand sides of ~840: the metric ~50, photons and polarization
# ~225, massless neutrinos ~115, massive neutrinos ~440; the RK4 sums ~2,200
# over 100 state entries; two table interpolations ~130).  A step of the
# Saha block needs ~30 of recomb_scan's (csrc/recomb.cuh: x_H, x_e and T_M's
# exponential step, pow and exp once each): a bound counts each row's block
# at that where its inputs are given.
RECOMB_OPS_PER_STEP = 225
RECOMB_OPS_SAHA_STEP = 30
EB_OPS_PER_STEP = 5700
# the rate at which the solver line models one thread's critical path (a
# model, not a measurement; the kernels line carries no such figure): one
# float64 operation a cycle (a warp's FMA, two operations, takes two cycles on a
# sub-partition's 16 float64 lanes), at the H100 SXM boost clock
SM_CLOCK_HZ = 1.98e9
# eb_solve's per-step latency model (a model, not a measurement; the solver
# lines only): one warp walks a mode, and a step's dependent chain is four
# right-hand sides and the top of the step.  A right-hand side is one round
# of shuffles (the 21 broadcast entries and the l+-1 neighbours, issued
# together), then the dependent float64 operations counted from
# csrc/boltzmann.cu after it: the metric's 9 (the psi_0 sum, rho_nc, drho,
# h'); after tight coupling the sources' 6 (h'/15 by dv, a quotient whose
# divisor's reciprocal is known: 3), the slot's 2, the quotient by conf_h
# (dv: 3) and the stage's FMA; in tight coupling the fluid's 37 (five dv
# quotients among them) instead of the sources'.  The top of the step
# interpolates its two points into shared memory (2 operations and eps's
# square root), derives their quotients and each lane's k / (2l + 1) (dv
# with its reciprocal's Newton steps: 8 each), with three shared-memory
# round trips between.  Latencies in cycles of one SM sub-partition (not
# measured on this card): a shuffle round 30, a dependent float64 operation
# 8, a square root 40, a shared-memory round trip 30.  It leaves out the
# issue of the warp's instructions and every stall but these.
WARP_LATENCY = dict(shuffle=30, dop=8, quotient=40, shared=30)
WARP_RHS_CHAIN = {"tca": dict(shuffle=1, dop=9 + 37 + 2 + 3 + 1),
                  "post_tca": dict(shuffle=1, dop=9 + 6 + 2 + 3 + 1)}
WARP_STEP_TOP = dict(dop=2 + 8 + 8, quotient=1, shared=3)
SOLVER_REL_BUDGET = {"recomb_scan": 1e-10, "eb_solve": 1e-9}
# the box whose corners built the schedule of tests/goldens/
# solver_sample_4d_heldout.npz: tools/train_solver_emulator.py as it stood
# when the golden was committed (fa209b6; the box was widened later to
# today's BOX_BOUNDS), with the per-species mass axis (0, 0.1) eV
GOLDEN_BOX = {"omega_b": (0.017, 0.029), "omega_cdm": (0.05, 0.30), "h": (0.50, 0.90)}
GOLDEN_W, GOLDEN_SLOT = 4, 2  # the golden solved in slot 2 of a batch of the main path's W
GOLDEN_LOG_T_BUDGET = 1e-6
GOLDEN_LOG_RDRAG_BUDGET = 1e-7
SOLVER_SOURCE = "eftpipe_tpu_torch/csrc/boltzmann.cu"
SOLVE_BATCHES = (1, 4, 16, 64)  # cosmologies per timed solve; 4: the provider's batch in (d)
SOLVER_REPLACES = {
    "recomb_scan": "eftpipe_tpu/boltzmann/thermo.py:317 (lax.scan of _thermo_on_grid; no Pallas)",
    "eb_solve": "eftpipe_tpu/boltzmann/einstein_boltzmann.py:563 (lax.scan of solve_k; no Pallas)",
}


def box_draws(n: int, seed: int, bounds: dict = eb.BOX_BOUNDS) -> np.ndarray:
    """(n, 4) seeded cosmologies (ω_b, ω_cdm, h, m_ncdm) inside a box
    (``bounds``: its (ω_b, ω_cdm, h) ranges; the training box unless
    given), away from its edges."""
    rng = np.random.default_rng(seed)
    lo = np.array([bounds[k][0] for k in ("omega_b", "omega_cdm", "h")] + [eb.BOX_MNU_BOUNDS[0]])
    hi = np.array([bounds[k][1] for k in ("omega_b", "omega_cdm", "h")] + [eb.BOX_MNU_BOUNDS[1]])
    return lo + (hi - lo) * (0.1 + 0.8 * rng.random((n, 4)))


def box_batch(x: np.ndarray):
    return eb.box_params(*(torch.as_tensor(x[:, i], dtype=torch.float64, device="cuda")
                           for i in range(4)), device="cuda")


def timed(fn, warmup: int = 0):
    """(result, ms) of one call of ``fn`` by CUDA events, after ``warmup``
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def ops_factor(dual: bool, hyper: bool) -> float:
    return HYPER_OPS_FACTOR if hyper else (DUAL_OPS_FACTOR if dual else 1.0)


def eb_bound(mode_steps: int, longest: int, nbytes: int, dual: bool = False,
             hyper: bool = False) -> dict:
    """``dual``: the tangent kernel's (``DUAL_OPS_FACTOR`` times the
    operations; ``nbytes`` given for it); ``hyper``: the second-order
    kernel's (``HYPER_OPS_FACTOR``)."""
    ops = mode_steps * EB_OPS_PER_STEP * ops_factor(dual, hyper)
    t_ops = ops / FMA_FLOPS[torch.float64] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes_min=nbytes, critical_path_steps=longest,
                critical_path_model_ms=longest * ops / mode_steps / SM_CLOCK_HZ * 1e3)


def warp_step_model(sched, dual: bool = False) -> dict:
    """The per-step latency model of ``eb_solve``'s warp design
    (``WARP_RHS_CHAIN``) on the longest mode of ``sched``: cycles of a
    step's chain in tight coupling and after it, the mode's steps of each,
    and its chain in ms and in µs a step at the boost clock.  ``dual``: the
    tangent kernel, whose tangent half runs beside its value half on the
    same chain, but for one more dependent product in each dv quotient (2
    after tight coupling, 7 in it)."""
    def cycles(chain):
        return sum(WARP_LATENCY[k] * n for k, n in chain.items())

    per = {}
    for phase, chain in WARP_RHS_CHAIN.items():
        extra = (7 if phase == "tca" else 2) if dual else 0
        per[phase] = 4 * cycles(dict(chain, dop=chain["dop"] + extra)) + cycles(WARP_STEP_TOP)
    i = int(np.argmax(sched.steps))
    tca = int(sched.tca[sched.offsets[i]:sched.offsets[i + 1] - 1].sum())
    post = int(sched.steps[i]) - tca
    ms = (tca * per["tca"] + post * per["post_tca"]) / SM_CLOCK_HZ * 1e3
    return dict(cycles_per_step=per, latency_cycles=WARP_LATENCY, longest_tca_steps=tca,
                longest_post_tca_steps=post, model_ms=ms,
                model_us_per_step=ms * 1e3 / max(tca + post, 1))


def recomb_bound(nw: int, n: int, dual: bool = False, hyper: bool = False,
                 saha=None) -> dict:
    """``saha``: each row's Saha block (``saha_block``), whose steps count
    ``RECOMB_OPS_SAHA_STEP``; without it every step counts the full step's."""
    saha_steps = sum(saha) if saha is not None else 0
    ops = ((nw * n - saha_steps) * RECOMB_OPS_PER_STEP + saha_steps * RECOMB_OPS_SAHA_STEP
           ) * ops_factor(dual, hyper)
    t_ops = ops / FMA_FLOPS[torch.float64] * 1e3
    # five (W, n) inputs and f_He in, three (W, n) out; each with its tangent
    # (its three parts)
    nbytes = (4 if hyper else (2 if dual else 1)) * 8 * (8 * nw * n + nw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes_min=nbytes, critical_path_steps=n,
                critical_path_model_ms=ops / nw / SM_CLOCK_HZ * 1e3)


def eb_bytes(tab, dsched: dict, nz: int, nk: int, dual: bool = False,
             hyper: bool = False) -> int:
    """The tables (and their tangent, or their three parts), the schedule,
    the outputs (and theirs)."""
    nw = tab.stacked.shape[0]
    sched = sum(t.numel() * t.element_size() for t in dsched.values())
    return ((4 if hyper else (2 if dual else 1))
            * (tab.stacked.numel() * 8 + 8 * (2 * nw * nz * nk + nw * nk)) + sched)


class AgainstSolver:
    """Another ``boltzmann.cu`` with this tree's C interface (for example the
    parent commit's, copied into a git-ignored directory with the headers it
    includes), built into the build directory; its kernels launched on the
    inputs of this tree's wrappers, uncounted.  Its recurrence takes a
    workspace where it exports ``eft_recomb_work_bytes`` (this tree's
    interface), none where it does not (before the pre-pass)."""

    def __init__(self, src_dir: str):
        import ctypes

        self.src = os.path.join(src_dir, "boltzmann.cu")
        lib_path = _build.build_dir() / "libboltzmann_against.so"
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                              self.src], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"chip_smoke: --against: nvcc failed on {self.src}:\n"
                             f"{res.stdout}{res.stderr}")
        self.ptxas = ptxas_summary(res.stdout + res.stderr)
        self.lib = ctypes.CDLL(str(lib_path))
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        self.lib.eft_eb_solve.argtypes = [ptr] * 11 + [i] * 5 + [ptr]
        self.lib.eft_eb_solve_jvp.argtypes = [ptr] * 13 + [i] * 5 + [ptr]
        self.lib.eft_eb_solve_jvp2.argtypes = [ptr] * 13 + [i] * 5 + [ptr]
        # the recurrence takes a workspace where the library sizes one
        self.work = hasattr(self.lib, "eft_recomb_work_bytes")
        w = int(self.work)
        self.lib.eft_recomb_scan.argtypes = [ptr] * (7 + w) + [i] * 2 + [d, ptr]
        self.lib.eft_recomb_scan_jvp.argtypes = [ptr] * (14 + w) + [i] * 2 + [d, ptr]
        self.lib.eft_recomb_scan_jvp2.argtypes = [ptr] * (14 + w) + [i] * 2 + [d, ptr]
        if self.work:
            self.lib.eft_recomb_work_bytes.argtypes = [i] * 3
            self.lib.eft_recomb_work_bytes.restype = ctypes.c_size_t

    def _work(self, parts: int, nw: int, n: int) -> list:
        if not self.work:
            return []
        nbytes = int(self.lib.eft_recomb_work_bytes(parts, nw, n))
        return [torch.empty(nbytes, dtype=torch.uint8, device="cuda")]

    def _launch(self, fn, *tensors, ints, doubles=()):
        code = fn(*(t.data_ptr() for t in tensors), *ints, *doubles,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise SystemExit(f"chip_smoke: --against kernel failed to launch ({code})")

    def eb_solve(self, tab, dsched: dict, nk: int):
        nw, ng = eb._check_eb(tab, dsched)
        nm, nz = dsched["out_idx"].shape
        out = torch.zeros((2 * nw * nz * nk + nw * nk,), dtype=torch.float64, device="cuda")
        self._launch(self.lib.eft_eb_solve, tab.stacked.transpose(1, 2).contiguous(),
                     *eb._eb_args(tab, dsched), out, ints=(nw, nm, nk, nz, ng))
        return eb._eb_outputs(out, nw, nz, nk)

    def eb_solve_jvp(self, tab, d_stacked, dsched: dict, nk: int):
        nw, ng = eb._check_eb(tab, dsched)
        nm, nz = dsched["out_idx"].shape
        out = torch.zeros((2 * nw * nz * nk + nw * nk,), dtype=torch.float64, device="cuda")
        dout = torch.zeros_like(out)
        self._launch(self.lib.eft_eb_solve_jvp, tab.stacked.transpose(1, 2).contiguous(),
                     d_stacked.transpose(1, 2).contiguous(), *eb._eb_args(tab, dsched), out,
                     dout, ints=(nw, nm, nk, nz, ng))
        return eb._eb_outputs(out, nw, nz, nk), eb._eb_outputs(dout, nw, nz, nk)

    def eb_solve_jvp2(self, tab, parts, dsched: dict, nk: int):
        nw, ng = eb._check_eb(tab, dsched)
        nm, nz = dsched["out_idx"].shape
        out = torch.zeros((2 * nw * nz * nk + nw * nk,), dtype=torch.float64, device="cuda")
        dout = torch.zeros((out.shape[0], 3), dtype=torch.float64, device="cuda")
        self._launch(self.lib.eft_eb_solve_jvp2, tab.stacked.transpose(1, 2).contiguous(),
                     torch.stack(tuple(parts), -1).transpose(1, 2).contiguous(),
                     *eb._eb_args(tab, dsched), out, dout, ints=(nw, nm, nk, nz, ng))
        return jet.Jet(tuple(eb._eb_outputs(out, nw, nz, nk)),
                       *(tuple(eb._eb_outputs(p, nw, nz, nk)) for p in dout.unbind(-1)))

    def recomb_scan(self, ins, dlna: float):
        nw, n = ins[0].shape
        out = torch.empty((3, nw, n), dtype=torch.float64, device="cuda")
        self._launch(self.lib.eft_recomb_scan, *ins, out, *self._work(0, nw, n), ints=(nw, n),
                     doubles=(dlna,))
        return tuple(out.unbind(0))

    def recomb_scan_jvp(self, ins, tans, dlna: float):
        nw, n = ins[0].shape
        out = torch.empty((3, nw, n), dtype=torch.float64, device="cuda")
        dout = torch.empty_like(out)
        self._launch(self.lib.eft_recomb_scan_jvp, *ins, *tans, out, dout, *self._work(1, nw, n),
                     ints=(nw, n), doubles=(dlna,))
        return tuple(out.unbind(0)), tuple(dout.unbind(0))

    def recomb_scan_jvp2(self, ins, dlna: float):
        vals = [t.contiguous() for t in ins.v]
        parts = [torch.stack(p, -1).contiguous() for p in zip(ins.a, ins.b, ins.ab)]
        nw, n = vals[0].shape
        out = torch.empty((3, nw, n), dtype=torch.float64, device="cuda")
        dout = torch.empty((3, nw, n, 3), dtype=torch.float64, device="cuda")
        self._launch(self.lib.eft_recomb_scan_jvp2, *vals, *parts, out, dout,
                     *self._work(3, nw, n), ints=(nw, n), doubles=(dlna,))
        return jet.Jet(tuple(out.unbind(0)), *(tuple(dout[..., i].unbind(0)) for i in range(3)))


def in_turns(theirs, ours, block: int | None = None) -> dict:
    """``theirs`` and ``ours`` (callables returning a ``PerturbOut``, a
    tuple of tensors, or such pairs or jets) timed in turns (theirs, ours,
    ours, theirs) after a call of each, and the largest difference of their
    outputs, absolute and relative to each output's largest |value|;
    ``block``: whether the outputs' first ``block`` steps (the recurrence's
    Saha block) are the same bits.  Launches of this tree's kernels are not
    counted."""
    saved = dict(bk.LAUNCHES)
    theirs(), ours()  # a first call of each loads its module
    turns = [timed(fn)[1] for fn in (theirs, ours, ours, theirs)]
    got, want = ours(), theirs()
    bk.LAUNCHES.update(saved)
    def flat(o):  # a PerturbOut or a tuple of tensors, or (outputs, tangents), or a jet
        return [t for part in (o if isinstance(o[0], tuple) else (o,)) for t in part]

    pairs = list(zip(flat(got), flat(want)))
    row = dict(their_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
               speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]),
               max_abs_diff=max(float((g - w).abs().max()) for g, w in pairs),
               max_rel_diff=max(rel_err(g, w) for g, w in pairs if float(w.abs().max()) > 0))
    if block is not None:
        row["saha_block_steps"] = block
        row["saha_block_bitwise"] = all(bool(torch.equal(g[..., :block], w[..., :block]))
                                        for g, w in pairs)
    return row


def saha_block(x_saha) -> list:
    """Each row's Saha block: its steps before the first whose x_Saha is not
    above 0.999 (the recurrence's test)."""
    leave = ~(x_saha > 0.999)
    return [int(r.nonzero()[0]) if bool(r.any()) else int(x_saha.shape[-1]) for r in leave]


def cut_steps(ins, n: int) -> list:
    """The recurrence's six inputs (or their tangents) cut to their first
    ``n`` steps."""
    return [t[..., :n].contiguous() for t in ins[:5]] + [ins[5]]


def recomb_phases(par, against=None) -> dict:
    """(f): µs a step of ``recomb_scan`` (the W cosmologies of ``par``) and
    ``recomb_scan_jvp`` (their W·P rows in ``HESS_FIELDS``, as the solver's
    gradient seeds them) on the fine grid in the Saha block and after it:
    one launch on the grid cut at the batch's first Peebles step (the Saha
    block alone), one on the whole grid, after one warm-up each; and the
    same for ``against``'s kernels.  Launches are not counted."""
    saved = dict(bk.LAUNCHES)
    f_bg = thermo.background_tables(par, n_grid=thermo.N_FINE)
    ins = [t.contiguous() for t in thermo.recomb_inputs(par, f_bg)]
    dlna = thermo.scan_step(f_bg)
    with forward_ad.dual_level(), DenseTangents():
        dpar = eb.tangent_rows(par, HESS_FIELDS)
        d_ins = thermo.recomb_inputs(dpar, thermo.background_tables(dpar, n_grid=thermo.N_FINE))
        prim = [primal(t).contiguous() for t in d_ins]
        tans = [tangent_or_zeros(t).contiguous() for t in d_ins]
    n = thermo.N_FINE
    ends = saha_block(ins[3])
    nb = min(ends)
    runs = {"recomb_scan": ((ins,), lambda a: thermo.recomb_scan_cuda(*a, dlna),
                            against and (lambda a: against.recomb_scan(a, dlna))),
            "recomb_scan_jvp": ((prim, tans), lambda a, t: thermo.recomb_scan_jvp_cuda(a, t, dlna),
                                against and (lambda a, t: against.recomb_scan_jvp(a, t, dlna)))}
    out = dict(W=int(par.h.shape[0]), rows_jvp=len(prim[0]), fields_jvp=list(HESS_FIELDS), n=n,
               saha_steps=nb, saha_steps_by_row=ends, peebles_steps=n - nb)
    for name, (args, ours, theirs) in runs.items():
        cut = [cut_steps(a, nb) for a in args]
        out[name] = {}
        for who, fn in (("ours", ours), ("theirs", theirs)):
            if not fn:
                continue
            _, block_ms = timed(lambda: fn(*cut), warmup=1)
            _, full_ms = timed(lambda: fn(*args), warmup=1)
            out[name][who] = dict(block_ms=block_ms, full_ms=full_ms,
                                  us_per_step_saha=block_ms * 1e3 / nb,
                                  us_per_step_peebles=(full_ms - block_ms) * 1e3 / (n - nb))
    bk.LAUNCHES.update(saved)
    return out


def solver_check_recomb(nw: int = 4, n_fine: int = 4096) -> dict:
    """(a): recomb_scan against its plain version on the card."""
    par = box_batch(box_draws(nw, seed=11))
    bg = thermo.background_tables(par, n_grid=n_fine)
    ins = thermo.recomb_inputs(par, bg)
    dlna = float(bg.lna[1] - bg.lna[0])
    got, ms = timed(lambda: thermo.recomb_scan_cuda(*ins, dlna), warmup=1)
    ref, plain_ms = timed(lambda: thermo.recomb_scan_plain(*ins, dlna))
    err = max(float(((g - r).abs() / r.abs()).max()) for g, r in zip(got, ref))
    row = dict(W=nw, n=n_fine, max_rel_err=err, budget=SOLVER_REL_BUDGET["recomb_scan"],
               ms=ms, plain_ms=plain_ms, max_abs_err=max(float((g - r).abs().max())
                                                         for g, r in zip(got, ref)))
    row.update(recomb_bound(nw, n_fine, saha=saha_block(ins[3])))
    return row


def check_buckets(solver, cut: int, nbuckets: int = 2) -> list:
    """The comparison schedule of (b): the ``nbuckets`` shortest buckets,
    and one mode of the longest cut to its first ``cut`` steps (its outputs
    then sit at the cut)."""
    idx, grids, masks, _ = solver.buckets[-1]
    gcut, mcut = grids[:1, :cut + 1], masks[:1, :cut + 1]
    return list(solver.buckets[:nbuckets]) + [
        (idx[:1], gcut, mcut, eb.out_indices(gcut, solver.lna_out))]


def solver_check_eb(solver, nw: int = 2, cut: int = 1500) -> dict:
    """(b): eb_solve against its plain version on the card: all modes of the
    two shortest buckets, plus one mode of the longest bucket cut to its
    first ``cut`` steps (its outputs then sit at the cut)."""
    par = box_batch(box_draws(nw, seed=12))
    _, _, tab = solver.tables(par)
    buckets = check_buckets(solver, cut)
    mcut = buckets[-1][2]
    sel = np.concatenate([b[0] for b in buckets])
    k = solver.k_mpc
    dsched = eb.kernel_schedule(k, buckets).to("cuda")
    got, ms = timed(lambda: eb.eb_solve_cuda(tab, dsched, len(k)), warmup=1)

    def plain():
        return [eb.eb_solve_plain(tab, k[b[0]], b[1], b[2], b[3]) for b in buckets]

    ref, plain_ms = timed(plain)
    ref_dm = torch.cat([r.delta_m for r in ref], -1)
    ref_dcb = torch.cat([r.delta_cb for r in ref], -1)
    ref_z = torch.cat([r.zeta_ini for r in ref], -1)
    s = torch.as_tensor(sel, device="cuda")
    errs = dict(delta_m=rel_err(got.delta_m[..., s], ref_dm),
                delta_cb=rel_err(got.delta_cb[..., s], ref_dcb),
                zeta_ini=rel_err(got.zeta_ini[..., s], ref_z))
    steps = int(eb.kernel_schedule(k, buckets).steps.sum())
    return dict(W=nw, modes=int(sel.size), mode_steps=steps * nw,
                cut_mode_tca_steps=int(mcut[0, :-1].sum()),
                cut_mode_post_tca_steps=int((~mcut[0, :-1]).sum()),
                max_rel_err=errs, budget=SOLVER_REL_BUDGET["eb_solve"], ms=ms, plain_ms=plain_ms,
                max_abs_err=max(float((got.delta_m[..., s] - ref_dm).abs().max()),
                                float((got.delta_cb[..., s] - ref_dcb).abs().max()),
                                float((got.zeta_ini[..., s] - ref_z).abs().max())))


def golden_solver() -> "eb.EBSolver":
    """The golden's recipe: the 4-D recipe's, with the schedule built over
    the corners of ``GOLDEN_BOX`` (the box the golden was made with)."""
    return eb.box_solver(dict(GOLDEN_BOX, m_ncdm=eb.BOX_MNU_BOUNDS), device="cuda")


def solver_golden(solver, out_dir=None) -> dict:
    """(c): the full-width solve against the JAX solver's golden sample, at
    the main path's batch: the golden's cosmology in slot ``GOLDEN_SLOT`` of
    a W=4 batch whose other slots are seeded cosmologies of the golden's box
    (the golden slot's transfers also written to ``out_dir/solver_golden.npz``
    when given)."""
    g = np.load(os.path.join(GOLDENS, "solver_sample_4d_heldout.npz"))
    if not (np.allclose(g["kgrid"], solver.k_mpc, rtol=0, atol=0)
            and np.allclose(g["zgrid"], solver.z_out, rtol=1e-15, atol=0)):
        raise SystemExit("chip_smoke: solver: k or z grid differs from the golden's")
    x = box_draws(GOLDEN_W, seed=14, bounds=GOLDEN_BOX)
    x[GOLDEN_SLOT] = g["x"]
    with torch.no_grad():
        lp = solver(box_batch(x))
    log_tm, log_tcb = eb.log_transfers(lp)
    tm, tcb = log_tm[GOLDEN_SLOT].cpu().numpy(), log_tcb[GOLDEN_SLOT].cpu().numpy()
    log_rd = float(torch.log(lp.rs_drag[GOLDEN_SLOT]))
    d_tm = float(np.abs(tm - g["log_tm"]).max())
    d_tcb = float(np.abs(tcb - g["log_tcb"]).max())
    d_rd = abs(log_rd - float(g["log_rdrag"]))
    if out_dir:
        np.savez(os.path.join(out_dir, "solver_golden.npz"), log_tm=tm, log_tcb=tcb,
                 log_rdrag=log_rd)
    return dict(x=g["x"].tolist(), W=GOLDEN_W, slot=GOLDEN_SLOT, max_abs_dlog_tm=d_tm,
                max_abs_dlog_tcb=d_tcb, abs_dlog_rdrag=d_rd, budget_log_t=GOLDEN_LOG_T_BUDGET,
                budget_log_rdrag=GOLDEN_LOG_RDRAG_BUDGET,
                finite=bool(torch.isfinite(log_tm).all() and torch.isfinite(log_tcb).all()
                            and torch.isfinite(lp.rs_drag).all()),
                ok=d_tm <= GOLDEN_LOG_T_BUDGET and d_tcb <= GOLDEN_LOG_T_BUDGET
                and d_rd <= GOLDEN_LOG_RDRAG_BUDGET)


def solver_analysis_config(workdir: str) -> dict:
    """One LRG tracer of ``analysis_config`` on the ``solver`` provider."""
    info = analysis_config(workdir)
    tr = info["theory"]["tracers"]
    solver = {"name": "solver", "om_fid": tr["default"]["boltzmann"]["om_fid"]}
    info["theory"]["tracers"] = {"default": dict(tr["default"], boltzmann=solver),
                                 "LRG": tr["LRG"]}
    info["params"] = {k: v for k, v in info["params"].items() if not k.startswith("ELG_")}
    like = info["likelihood"]
    like["tracers"] = ["LRG"]
    like["data"] = {"LRG": like["data"]["LRG"]}
    like["cov"] = os.path.join(workdir, "cov.txt")
    like.pop("chained", None)
    like["marg"] = {"LRG_": like["marg"]["LRG_"]}
    return info


def solver_analysis(nw: int) -> tuple[dict, dict]:
    """(d): a float32 LRG analysis on the solver provider, its launches."""
    workdir = os.path.join(WORKDIR, "solver")
    os.makedirs(workdir, exist_ok=True)
    info = solver_analysis_config(workdir)
    if not os.path.exists(os.path.join(workdir, "cov.txt")):
        th = Analysis.from_config({k: v for k, v in info.items() if k != "likelihood"},
                                  dtype=torch.float64, device="cuda", quadform="plain")
        fid = th.space.to_dict(th.space.theta0())
        with torch.no_grad():
            ls, _, plk = th.nonlinear_Plk_grid("LRG", fid, binned=True, kout=ANALYSIS_KOUT)
        plk = plk.double().cpu().numpy()
        np.savetxt(os.path.join(workdir, "data_LRG.txt"),
                   np.column_stack([ANALYSIS_KOUT] + [plk[i] for i in range(len(ls))]),
                   header="k " + " ".join(f"P{l}" for l in ls))
        kedges = np.concatenate([ANALYSIS_KOUT - 0.0025, [ANALYSIS_KOUT[-1] + 0.0025]])
        mp = Multipole(p0=plk[0] + 1 / 5e-5 + 1e3, p2=plk[1], p4=plk[2])
        np.savetxt(os.path.join(workdir, "cov.txt"),
                   GaussianCovariance(kedges, volume=4.0)(ls, ls, "aa->aaaa", mp))
    an = Analysis.from_config(info, dtype=torch.float32, device="cuda")
    theta0 = np.asarray(an.space.theta0(), np.float64)
    rng = np.random.default_rng(13)
    thetas = theta0[None] * (1.0 + 1e-2 * rng.standard_normal((nw, theta0.size)))
    th = torch.as_tensor(thetas, dtype=torch.float32, device="cuda")
    an.logp(th)  # warm-up: builds, tables on the card
    torch.cuda.synchronize()
    qf.reset_launch_counts()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        lp = an.logp(th)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(eb_solve=bk.LAUNCHES["eb_solve"], recomb_scan=bk.LAUNCHES["recomb_scan"],
                  qf_real=qf.LAUNCHES["qf_real"], cf_half=qf.LAUNCHES["cf_half"])
    by_shape = dict(qf.LAUNCHES_BY_SHAPE)
    lp_np = lp.double().cpu().numpy()
    return dict(W=nw, dtype="float32", logp=lp_np.tolist(), finite=bool(np.isfinite(lp_np).all()),
                logp_seconds=seconds, launches=counts), by_shape


def solver_phase(lines: list, out_dir=None, against=None) -> dict:
    """Phase 10: the Einstein-Boltzmann solver.  Returns the launches of its
    paths, the ``qf_real`` shapes of its analysis and its kernels' rows.
    ``against``: an :class:`AgainstSolver` timed beside ``eb_solve`` and
    ``recomb_scan`` in (e) and (f)."""
    t_phase = time.perf_counter()
    out, by_path = {}, {}
    # (c) first: the golden's recipe (the envelope over the corners of the
    # box it was made with) at full width and the main path's W; its
    # launches are a path
    with torch.no_grad():
        gsolver = golden_solver()
        bk.reset_launch_counts()
        out["golden"] = solver_golden(gsolver, out_dir)
        by_path["solver_golden"] = dict(bk.LAUNCHES)
        del gsolver
        # the 4-D training recipe's solver (the wide box and the mass axis,
        # 16 corners; the --sample-mnu recipe): (b) and (e)
        t0 = time.perf_counter()
        solver = eb.box_solver(device="cuda")
    sched = solver.schedule()
    out["build_seconds"] = time.perf_counter() - t0
    out["schedule"] = dict(recipe="4-D (--sample-mnu): the 16 corners of the wide box and "
                                  "the mass axis",
                           box={k: list(v) for k, v in eb.BOX_BOUNDS.items()},
                           modes=int(sched.k.size), buckets=len(solver.buckets),
                           longest_mode_steps=int(sched.steps.max()),
                           mode_steps=int(sched.steps.sum()),
                           padded_mode_steps=int(sum(b[1].shape[0] * (b[1].shape[1] - 1)
                                                     for b in solver.buckets)),
                           warp_step_model=warp_step_model(sched))

    # (a), (b): each kernel against its plain version (launches uncounted)
    out["recomb_check"] = solver_check_recomb()
    out["eb_check"] = solver_check_eb(solver)

    # (e): seconds per solve at W = 1, 16, 64, and each kernel alone
    times = {}
    bk.reset_launch_counts()
    for nw in SOLVE_BATCHES:
        par = box_batch(box_draws(nw, seed=100 + nw))
        with torch.no_grad():
            _, solve_ms = timed(lambda: solver(par))
            bg, th, tab = solver.tables(par)
            f_bg = thermo.background_tables(par, n_grid=thermo.N_FINE)
            ins = thermo.recomb_inputs(par, f_bg)
            dlna = float(f_bg.lna[1] - f_bg.lna[0])
            _, recomb_ms = timed(lambda: thermo.recomb_scan_cuda(*ins, dlna))
            dsched = solver.device_schedule("cuda")
            _, eb_ms = timed(lambda: eb.eb_solve_cuda(tab, dsched, solver.k_mpc.size))
        nz, nk = solver.lna_out.size, solver.k_mpc.size
        times[nw] = dict(seconds_per_solve=solve_ms / 1e3, cosmologies_per_s=nw / (solve_ms / 1e3),
                         eb_solve_ms=eb_ms, recomb_scan_ms=recomb_ms,
                         us_per_step_longest=eb_ms * 1e3 / int(sched.steps.max()),
                         eb_solve=eb_bound(int(sched.steps.sum()) * nw, int(sched.steps.max()),
                                           eb_bytes(tab, dsched, nz, nk)),
                         recomb_scan=recomb_bound(nw, thermo.N_FINE, saha=saha_block(ins[3])))
        if against is not None:
            times[nw]["against"] = dict(
                eb_solve=in_turns(lambda: against.eb_solve(tab, dsched, nk),
                                  lambda: eb.eb_solve_cuda(tab, dsched, nk)),
                recomb_scan=in_turns(lambda: against.recomb_scan(ins, dlna),
                                     lambda: thermo.recomb_scan_cuda(*ins, dlna),
                                     block=min(saha_block(ins[3]))))
    by_path["solver_times"] = dict(bk.LAUNCHES)
    out["times"] = times
    # (f): the recurrence by phase, on (e)'s W=4 batch
    out["recomb_phases"] = recomb_phases(box_batch(box_draws(4, seed=104)), against)

    # (d): the solver provider end to end (its launches are the main path's)
    res, qf_shapes = solver_analysis(4)
    out["analysis"] = res
    by_path["solver_analysis"] = {"eb_solve": res["launches"]["eb_solve"],
                                  "recomb_scan": res["launches"]["recomb_scan"]}
    smi = nvidia_smi_line()
    out["nvidia_smi"] = smi
    out["seconds"] = time.perf_counter() - t_phase
    lines.append(emit("solver", **out))
    failed = []
    rc, ec = out["recomb_check"], out["eb_check"]
    if not rc["max_rel_err"] <= rc["budget"]:
        failed.append(f"recomb_scan vs plain {rc['max_rel_err']}")
    if not all(v <= ec["budget"] for v in ec["max_rel_err"].values()):
        failed.append(f"eb_solve vs plain {ec['max_rel_err']}")
    if not (out["golden"]["ok"] and out["golden"]["finite"]):
        failed.append(f"golden {out['golden']}")
    if not (res["finite"] and res["launches"]["eb_solve"] > 0
            and res["launches"]["recomb_scan"] > 0 and res["launches"]["qf_real"] > 0):
        failed.append(f"analysis {res}")
    if failed:
        raise SystemExit(f"chip_smoke: solver: failed {failed}")
    return dict(by_path=by_path, qf_shapes=qf_shapes, out=out, solver=solver)


def solver_rows(out: dict, grad: dict, hess: dict, by_path: dict) -> list:
    """The kernels line's rows of the solver's kernels: ``eb_solve`` and
    ``recomb_scan`` with their time and bound at the main path's shape (the
    provider's W=4 solve) and their plain versions' time at the reduced
    comparison shape of the solver phase's (a)/(b); their tangent kernels
    with their time and bound at the shape of a W=4 value and gradient of
    the ``solver_grad`` phase's analysis (W·P = 8 rows) and the plain
    versions' time under forward AD at the comparison shape of its (a)/(b);
    their second-order kernels with their time and bound at the rows of one
    Hessian of that analysis (W·Q: W = ndim copies of θ₀, Q = P(P+1)/2) and
    the plain versions' time on hyper-dual operands at the comparison shape
    of ``solver_hessian``'s (a)."""
    t4, g4, h5 = out["times"][4], grad["times"][4], hess["hessian"]["times"]
    rows = []
    for name, check, bnd, ms in (
            ("eb_solve", out["eb_check"], t4["eb_solve"], t4["eb_solve_ms"]),
            ("recomb_scan", out["recomb_check"], t4["recomb_scan"], t4["recomb_scan_ms"]),
            ("eb_solve_jvp", grad["eb_check"], g4["eb_solve_jvp"], g4["eb_solve_jvp_ms"]),
            ("recomb_scan_jvp", grad["recomb_check"], g4["recomb_scan_jvp"],
             g4["recomb_scan_jvp_ms"]),
            ("eb_solve_jvp2", hess["eb_check"], h5["eb_solve_jvp2"], h5["eb_solve_jvp2_ms"]),
            ("recomb_scan_jvp2", hess["recomb_check"], h5["recomb_scan_jvp2"],
             h5["recomb_scan_jvp2_ms"])):
        per_path = {p: c.get(name, 0) for p, c in by_path.items()} | {"mesh": 0}
        shape = ("W=4" if name in SOLVER_REPLACES else
                 f"W*P={g4['rows']}" if name in SOLVER_JVP_REPLACES else f"W*Q={h5['rows']}")
        rows.append(dict(
            name=f"{name}[f64,{shape}]", route="cuda", source=SOLVER_SOURCE,
            replaces=(SOLVER_REPLACES | SOLVER_JVP_REPLACES | SOLVER_JVP2_REPLACES)[name],
            launches=sum(per_path.values()),
            launches_by_path=per_path, max_abs_err=check["max_abs_err"], ms=ms,
            plain_ms=check["plain_ms"], ms_at_plain_shape=check["ms"],
            plain_shape={k: check[k] for k in ("W", "rows", "n", "modes", "mode_steps")
                         if k in check},
            bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# the solver's gradient on the card (phase 10b, solver_grad)
# ---------------------------------------------------------------------------
# the tangent kernels' operations: the forward kernels' counts times the
# mean cost of one operation of their source on a dual number (a sum, or a
# product by a number: 2 operations; a product of two duals: 3; a quotient:
# 4), ~2.3
DUAL_OPS_FACTOR = 2.3
TANGENT_BUDGET = 1e-9        # (a), (b): of the largest |tangent| of each output
JVP_PRIMAL_BUDGET = 1e-12    # (a): the tangent kernel's primal against the forward kernel's
FD_REL_BUDGET = 1e-5         # (c): each component of ∇logp against central differences
# (c): central-difference steps, relative to |θ_i|: small, for P_lin is
# interpolated linearly in log k (a kink where an output k crosses a
# solver node); the rounding of logp (~1e-13) costs ~1e-7 of a component
FD_STEPS = (1e-5, 3e-5)
LOGP_GRAD_REL_BUDGET = 1e-12  # (c): logp with the gradient against logp without
GRAD_BATCHES = (1, 4)        # (e): walkers of the timed values and gradients
# the seeded tangent direction of (a) and (b), per table field
TANGENT_SCALES = dict(omega_b=1e-3, omega_cdm=1e-2, h=1e-2, m_ncdm=1e-2, n_ur=1e-2, yhe=1e-2)
SOLVER_JVP_REPLACES = {
    "recomb_scan_jvp": "eftpipe_tpu/boltzmann/thermo.py:317 (its derivative: jax.jvp through "
                       "_thermo_on_grid's lax.scan; no Pallas)",
    "eb_solve_jvp": "eftpipe_tpu/boltzmann/einstein_boltzmann.py:563 (its derivative: jax.jvp "
                    "through solve_k's lax.scan; no Pallas)",
}


def seeded_tangents(par, seed: int):
    """``par`` with a seeded tangent on each table field (inside the
    caller's ``forward_ad.dual_level()``)."""
    rng = np.random.default_rng(seed)
    return par._replace(**{n: forward_ad.make_dual(
        getattr(par, n).contiguous(),
        TANGENT_SCALES[n] * torch.as_tensor(rng.standard_normal(par.h.shape[0]),
                                            dtype=torch.float64, device=par.h.device))
        for n in eb.TABLE_FIELDS})


def primal(t):
    return forward_ad.unpack_dual(t).primal


def grad_check_recomb(nw: int = 4, n_fine: int = 4096) -> dict:
    """(a): ``recomb_scan_jvp`` against forward AD of ``recomb_scan_plain``:
    the solver phase's (a) inputs, their tangents those of a seeded
    direction in the six table fields; the plain loop on the host (its
    operations, tiny and one after another, take ~3× longer under forward
    AD on the card)."""
    par = box_batch(box_draws(nw, seed=11))
    with forward_ad.dual_level(), DenseTangents():
        dpar = seeded_tangents(par, 21)
        bg = thermo.background_tables(dpar, n_grid=n_fine)
        ins = thermo.recomb_inputs(dpar, bg)
        dlna = float(primal(bg.lna)[1] - primal(bg.lna)[0])
        prim = [primal(t).contiguous() for t in ins]
        tans = [tangent_or_zeros(t).contiguous() for t in ins]
        (got, dgot), ms = timed(lambda: thermo.recomb_scan_jvp_cuda(prim, tans, dlna), warmup=1)
        fwd = thermo.recomb_scan_cuda(*prim, dlna)
        ins = [t.cpu() for t in ins]
        t0 = time.perf_counter()
        ref = [forward_ad.unpack_dual(o) for o in thermo.recomb_scan_plain(*ins, dlna)]
        plain_ms = (time.perf_counter() - t0) * 1e3
        ref = [r._replace(tangent=r.tangent.cuda()) for r in ref]
    names = ("x_H", "x_e", "T_M")
    row = dict(W=nw, n=n_fine, directions_per_row=1,
               tangent_err={k: rel_err(g, r.tangent) for k, g, r in zip(names, dgot, ref)},
               budget=TANGENT_BUDGET,
               primal_rel_err=max(float(((g - f).abs() / f.abs()).max()) for g, f in zip(got, fwd)),
               primal_budget=JVP_PRIMAL_BUDGET, ms=ms, plain_ms=plain_ms,
               plain="recomb_scan_plain under forward AD (DenseTangents), the inputs "
                     "copied to the host",
               max_abs_err=max(float((g - r.tangent).abs().max()) for g, r in zip(dgot, ref)),
               finite=all(bool(torch.isfinite(r.tangent).all()) for r in ref))
    row.update(recomb_bound(nw, n_fine, dual=True, saha=saha_block(prim[3])))
    return row


def grad_check_eb(solver, nw: int = 2, cut: int = 600, nbuckets: int = 1) -> dict:
    """(b): ``eb_solve_jvp`` against forward AD of ``eb_solve_plain``: the
    solver phase's (b) cosmologies, the tables' tangent that of a seeded
    direction in the six table fields; (b)'s schedule shortened, for the
    plain loop under forward AD takes ~90 ms a lockstep RK4 step on the
    card and ~35 ms on the host, where it runs: the shortest bucket (47
    modes, 624 steps) and the longest mode cut to 600 steps (410 in TCA,
    190 after)."""
    par = box_batch(box_draws(nw, seed=12))
    buckets = check_buckets(solver, cut, nbuckets)
    mcut = buckets[-1][2]
    sel = torch.as_tensor(np.concatenate([b[0] for b in buckets]), device="cuda")
    k = solver.k_mpc
    dsched = eb.kernel_schedule(k, buckets).to("cuda")
    with forward_ad.dual_level(), DenseTangents():
        _, _, tab = solver.tables(seeded_tangents(par, 22))
        ptab = eb.EBTables(lna=primal(tab.lna), dlna=primal(tab.dlna), tau=None,
                           stacked=primal(tab.stacked))
        d_stacked = tangent_or_zeros(tab.stacked)
        (got, dgot), ms = timed(lambda: eb.eb_solve_jvp_cuda(ptab, d_stacked, dsched, len(k)),
                                warmup=1)
        fwd = eb.eb_solve_cuda(ptab, dsched, len(k))
        tab = eb.EBTables(lna=tab.lna.cpu(), dlna=tab.dlna.cpu(), tau=None,
                          stacked=tab.stacked.cpu())
        t0 = time.perf_counter()
        ref = [eb.eb_solve_plain(tab, k[b[0]], b[1], b[2], b[3]) for b in buckets]
        plain_ms = (time.perf_counter() - t0) * 1e3
        refs = {n: forward_ad.unpack_dual(torch.cat([getattr(r, n) for r in ref], -1))
                for n in ("delta_m", "delta_cb", "zeta_ini")}
        refs = {n: r._replace(tangent=r.tangent.cuda()) for n, r in refs.items()}
    errs = {n: rel_err(getattr(dgot, n)[..., sel], r.tangent) for n, r in refs.items()}
    steps = int(eb.kernel_schedule(k, buckets).steps.sum())
    return dict(W=nw, modes=int(sel.numel()), mode_steps=steps * nw, directions_per_row=1,
                cut_mode_tca_steps=int(mcut[0, :-1].sum()),
                cut_mode_post_tca_steps=int((~mcut[0, :-1]).sum()),
                tangent_err=errs, budget=TANGENT_BUDGET,
                primal_rel_err={n: rel_err(getattr(got, n), getattr(fwd, n)) for n in refs},
                ms=ms, plain_ms=plain_ms,
                plain="eb_solve_plain under forward AD (DenseTangents), the tables "
                      "copied to the host",
                max_abs_err=max(float((getattr(dgot, n)[..., sel] - r.tangent).abs().max())
                                for n, r in refs.items()),
                finite=all(bool(torch.isfinite(r.tangent).all()) for r in refs.values()))


class SolverRecorder:
    """A provider's solver that keeps the ``LinearPower`` of each call."""

    def __init__(self, solver):
        self.solver, self.calls = solver, []

    def __call__(self, par):
        self.calls.append(self.solver(par))
        return self.calls[-1]

    def __getattr__(self, name):
        return getattr(self.solver, name)


def value_and_grad_fn(an, x):
    """A callable: ``an.logp`` at ``x`` (W, ndim) and its gradient."""
    def run():
        xg = x.clone().requires_grad_()
        lp = an.logp(xg)
        (g,) = torch.autograd.grad(lp.sum(), xg)
        return lp.detach(), g
    return run


def grad_fd_check(an, nw: int = 2) -> tuple[dict, dict, dict]:
    """(c): ∇logp of the float64 analysis through the kernels against
    central differences of its own float64 ``logp`` (all the perturbed
    points in one batch), at ``nw`` seeded points; the solver's outputs and
    ``logp`` with the gradient against without it.  Returns the line's
    entries, the solver kernels' launches of the value and gradient, and
    the ``qf_real`` launches by shape of the path."""
    theta0 = np.asarray(an.space.theta0(), np.float64)
    rng = np.random.default_rng(13)
    thetas = theta0[None] * (1.0 + 1e-2 * rng.standard_normal((nw, theta0.size)))
    x = torch.as_tensor(thetas, dtype=torch.float64, device="cuda")
    prov = an.providers["LRG"]
    rec = prov.solver = SolverRecorder(prov.solver)
    with torch.no_grad():
        an.logp(x)  # warm-up: the kernels' layouts on the card
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    qf.reset_launch_counts()
    (lp, g), vg_ms = timed(value_and_grad_fn(an, x))
    launches = dict(bk.LAUNCHES) | {"qf_real": qf.LAUNCHES["qf_real"]}
    by_shape = dict(qf.LAUNCHES_BY_SHAPE)
    with torch.no_grad():
        lp0 = an.logp(x)
    with_grad, without = rec.calls[-2], rec.calls[-1]
    prov.solver = rec.solver
    outputs_equal = {f: bool(torch.equal(getattr(with_grad, f).detach(), getattr(without, f)))
                     for f in eb.LinearPower._fields}
    logp_rel = float(((lp - lp0).abs() / lp0.abs()).max())
    # central differences: every point, parameter, step and sign in one batch
    ndim = theta0.size
    steps = np.array(FD_STEPS)[:, None, None] * np.abs(thetas)[None]          # (S, W, ndim)
    shifted = np.repeat(np.repeat(thetas[None, :, None, None, :], len(FD_STEPS), 0), ndim, 2)
    shifted = np.repeat(shifted, 2, 3)                                       # (S, W, ndim, 2, ndim)
    for j in range(ndim):
        shifted[:, :, j, 0, j] += steps[..., j]
        shifted[:, :, j, 1, j] -= steps[..., j]
    with torch.no_grad():
        lps = an.logp(torch.as_tensor(shifted.reshape(-1, ndim), dtype=torch.float64,
                                      device="cuda")).cpu().numpy().reshape(shifted.shape[:4])
    fd = (lps[..., 0] - lps[..., 1]) / (2.0 * steps)                           # (S, W, ndim)
    g_np = g.cpu().numpy()
    rel = np.abs(fd - g_np[None]) / np.abs(g_np[None])                        # (S, W, ndim)
    best = rel.min(axis=0)
    out = dict(W=nw, dtype="float64", params=list(an.space.sampled), theta=thetas.tolist(),
               logp=lp.cpu().numpy().tolist(), grad=g_np.tolist(),
               fd_steps_rel=list(FD_STEPS), fd_rel_err_by_step=rel.max(axis=(1, 2)).tolist(),
               fd_rel_err_by_param=dict(zip(an.space.sampled, best.max(axis=0).tolist())),
               fd_max_rel_err=float(best.max()), fd_budget=FD_REL_BUDGET,
               fd_batch=int(lps.size), solver_outputs_equal=outputs_equal,
               logp_rel_err_with_grad=logp_rel, logp_budget=LOGP_GRAD_REL_BUDGET,
               value_and_grad_ms=vg_ms, launches=launches,
               finite=bool(np.isfinite(g_np).all() and np.isfinite(lps).all()))
    return out, {k: launches[k] for k in bk.LAUNCHES}, by_shape


def grad_hmc(an) -> tuple[dict, dict, dict]:
    """(d): ``run_mcmc(sampler="hmc", init="ball")`` on the float32 analysis
    through the driver: 2 chains, ``n_leapfrog=1``, ``warmup_steps=1`` (the
    driver's three warmup windows, one transition each) and 1 step, five
    values and gradients of ~10 s; every gradient the sampler took is kept
    (a hook on its input)."""
    theta0 = np.asarray(an.space.theta0(), np.float64)
    grads, calls = [], [0]
    logp = an.logp

    def counted(x, chunk=None):
        calls[0] += 1
        if x.requires_grad:
            x.register_hook(lambda g: grads.append(g.detach().clone()))
        return logp(x, chunk)

    an.logp = counted
    bk.reset_launch_counts()
    qf.reset_launch_counts()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = an.run_mcmc(nwalkers=2, out=os.path.join(tmp, "hmc"), max_steps=1, block=1,
                              rhat_tol=-1.0, key=0, sampler="hmc", init="ball", n_leapfrog=1,
                              warmup_steps=1, with_derived=False,
                              inv_mass0=(1e-3 * theta0) ** 2)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        del an.logp
    launches = dict(bk.LAUNCHES)
    finite = bool(np.isfinite(res.chain).all() and np.isfinite(res.logps).all()
                  and grads and all(bool(torch.isfinite(g).all()) for g in grads))
    out = dict(nchains=2, n_leapfrog=1, warmup_steps=1, steps=1, dtype="float32",
               chain_shape=list(res.chain.shape), accept_rate=res.accept_rate,
               logp_calls=calls[0], gradients=len(grads), finite=finite, seconds=seconds,
               launches=launches | {"qf_real": qf.LAUNCHES["qf_real"]})
    return out, launches, dict(qf.LAUNCHES_BY_SHAPE)


def grad_times(an, solver, against=None) -> tuple[dict, dict, dict]:
    """(e): seconds per value and gradient of the float64 analysis at W = 1
    and 4 against seconds per ``logp``; at W=4 the tangent kernels alone on
    the rows of its tangent pass (W·P, P the differentiated table fields, as
    ``EBSolver.table_tangents`` seeds them), beside the forward kernels on
    the same rows, their bounds, µs a step of the longest mode and the warp
    step model; ``against``'s four kernels of those rows in turns with ours."""
    theta0 = np.asarray(an.space.theta0(), np.float64)
    prov = an.providers["LRG"]
    bk.reset_launch_counts()
    qf.reset_launch_counts()
    times = {}
    for nw in GRAD_BATCHES:
        rng = np.random.default_rng(200 + nw)
        x = torch.as_tensor(theta0[None] * (1.0 + 1e-2 * rng.standard_normal((nw, theta0.size))),
                            dtype=torch.float64, device="cuda")
        with torch.no_grad():
            _, logp_ms = timed(lambda: an.logp(x))
        _, vg_ms = timed(value_and_grad_fn(an, x))
        times[nw] = dict(logp_ms=logp_ms, value_and_grad_ms=vg_ms, ratio=vg_ms / logp_ms)
    par = thermo.as_batch(prov._params(an.params_dict(x)))
    names = tuple(n for n in eb.TABLE_FIELDS if n in an.space.sampled)
    with forward_ad.dual_level(), DenseTangents():
        dpar = eb.tangent_rows(par, names)
        f_bg = thermo.background_tables(dpar, n_grid=thermo.N_FINE)
        ins = thermo.recomb_inputs(dpar, f_bg)
        prim = [primal(t).contiguous() for t in ins]
        tans = [tangent_or_zeros(t).contiguous() for t in ins]
        _, _, tab = solver.tables(dpar)
        ptab = eb.EBTables(lna=primal(tab.lna), dlna=primal(tab.dlna), tau=None,
                           stacked=primal(tab.stacked))
        d_stacked = tangent_or_zeros(tab.stacked)
    dlna = float(f_bg.lna[1] - f_bg.lna[0])
    _, recomb_jvp_ms = timed(lambda: thermo.recomb_scan_jvp_cuda(prim, tans, dlna))
    _, recomb_ms = timed(lambda: thermo.recomb_scan_cuda(*prim, dlna))
    dsched = solver.device_schedule("cuda")
    nk, nz = solver.k_mpc.size, solver.lna_out.size
    _, eb_jvp_ms = timed(lambda: eb.eb_solve_jvp_cuda(ptab, d_stacked, dsched, nk))
    _, eb_ms = timed(lambda: eb.eb_solve_cuda(ptab, dsched, nk))
    sched = solver.schedule()
    rows = nw * len(names)
    longest = int(sched.steps.max())
    times[nw].update(
        rows=rows, fields=list(names), eb_solve_jvp_ms=eb_jvp_ms, eb_solve_ms_same_rows=eb_ms,
        recomb_scan_jvp_ms=recomb_jvp_ms, recomb_scan_ms_same_rows=recomb_ms,
        longest_mode_steps=longest, us_per_step_longest=dict(
            eb_solve_jvp=eb_jvp_ms * 1e3 / longest, eb_solve=eb_ms * 1e3 / longest),
        warp_step_model=dict(eb_solve_jvp=warp_step_model(sched, dual=True),
                             eb_solve=warp_step_model(sched)),
        eb_solve_jvp=eb_bound(int(sched.steps.sum()) * rows, int(sched.steps.max()),
                              eb_bytes(ptab, dsched, nz, nk, dual=True), dual=True),
        recomb_scan_jvp=recomb_bound(rows, thermo.N_FINE, dual=True, saha=saha_block(prim[3])))
    if against is not None:
        block = min(saha_block(prim[3]))
        times[nw]["against"] = dict(
            eb_solve_jvp=in_turns(lambda: against.eb_solve_jvp(ptab, d_stacked, dsched, nk),
                                  lambda: eb.eb_solve_jvp_cuda(ptab, d_stacked, dsched, nk)),
            eb_solve=in_turns(lambda: against.eb_solve(ptab, dsched, nk),
                              lambda: eb.eb_solve_cuda(ptab, dsched, nk)),
            recomb_scan_jvp=in_turns(lambda: against.recomb_scan_jvp(prim, tans, dlna),
                                     lambda: thermo.recomb_scan_jvp_cuda(prim, tans, dlna),
                                     block=block),
            recomb_scan=in_turns(lambda: against.recomb_scan(prim, dlna),
                                 lambda: thermo.recomb_scan_cuda(*prim, dlna), block=block))
    return times, dict(bk.LAUNCHES), dict(qf.LAUNCHES_BY_SHAPE)


def solver_grad_phase(solver, lines: list, against=None) -> dict:
    """Phase 10b: the solver's gradient on the card (``solver_grad`` line).
    ``solver``: the solver phase's 4-D recipe solver, for (b); ``against``:
    an :class:`AgainstSolver` timed in (e).  Returns the solver kernels'
    launches by path, the ``qf_real`` launches by shape of the paths, and
    the line."""
    t_phase = time.perf_counter()
    out, by_path, qf_paths = {}, {}, {}
    out["recomb_check"] = grad_check_recomb()
    out["eb_check"] = grad_check_eb(solver)
    info = solver_analysis_config(os.path.join(WORKDIR, "solver"))  # data: the solver phase's
    an64 = Analysis.from_config(info, dtype=torch.float64, device="cuda")
    an32 = Analysis.from_config(info, dtype=torch.float32, device="cuda")
    out["fd"], by_path["solver_grad"], qf_paths["solver_grad"] = grad_fd_check(an64)
    out["hmc"], by_path["solver_hmc"], qf_paths["solver_hmc"] = grad_hmc(an32)
    out["times"], by_path["solver_grad_times"], qf_paths["solver_grad_times"] = grad_times(
        an64, an64.providers["LRG"].solver, against)
    out["nvidia_smi"] = nvidia_smi_line()
    out["seconds"] = time.perf_counter() - t_phase
    lines.append(emit("solver_grad", **out))
    failed = []
    for key in ("recomb_check", "eb_check"):
        c = out[key]
        if not (c["finite"] and all(v <= c["budget"] for v in c["tangent_err"].values())):
            failed.append(f"{key} tangents {c['tangent_err']}")
    if not out["recomb_check"]["primal_rel_err"] <= JVP_PRIMAL_BUDGET:
        failed.append(f"recomb_scan_jvp primal {out['recomb_check']['primal_rel_err']}")
    fd = out["fd"]
    if not (fd["finite"] and fd["fd_max_rel_err"] <= FD_REL_BUDGET):
        failed.append(f"central differences {fd['fd_rel_err_by_param']}")
    if not (all(fd["solver_outputs_equal"].values())
            and fd["logp_rel_err_with_grad"] <= LOGP_GRAD_REL_BUDGET):
        failed.append(f"with/without the gradient {fd['solver_outputs_equal']} "
                      f"{fd['logp_rel_err_with_grad']}")
    la = fd["launches"]
    # the primal pass launches the forward kernels, the tangent pass only the
    # tangent kernels (they give the primal too): one each
    if not (la["eb_solve_jvp"] == 1 and la["recomb_scan_jvp"] == 1 and la["eb_solve"] == 1
            and la["recomb_scan"] == 1 and la["qf_real"] > 0):
        failed.append(f"launches of one value and gradient {la}")
    if not out["hmc"]["finite"]:
        failed.append(f"hmc {out['hmc']}")
    if failed:
        raise SystemExit(f"chip_smoke: solver_grad: failed {failed}")
    return dict(by_path=by_path, qf_paths=qf_paths, out=out, an64=an64, an32=an32)


# ---------------------------------------------------------------------------
# the solver's second derivative on the card (phase 10c, solver_hessian)
# ---------------------------------------------------------------------------
# the second-order kernels' operations: the forward kernels' counts times the
# mean cost of one operation of their source on a hyper-dual number (a sum,
# or a product by a number: 4 operations; a product of two: 9; a quotient:
# ~11), with the Dual's mix of them (DUAL_OPS_FACTOR 2.3: ~70 % at 2, the
# rest at 3-4): ~5.5
HYPER_OPS_FACTOR = 5.5
HESS_PART_BUDGET = 1e-9      # (a): of the largest |part| of each output
HESS_LOWER_BUDGET = 1e-12    # (a): value and first-order parts against the forward / Dual kernels
HESS_FD_BUDGET = 1e-4        # (b): each entry against central differences of ∇logp, of its row's max
HESS_SYM_BUDGET = 1e-8       # (b): |H - H^T| of max |H|
# (c): ∇logp with the gradient's graph against without it, of its largest
# |component|: the EFT path's backward differs in rounding, for torch's
# matmul takes another route when the gradient requires grad (the solver's
# own part is held bit for bit)
HESS_GRAPH_GRAD_BUDGET = 1e-12
HESS_FIELDS = ("omega_cdm", "h")  # (a): the pair rows' fields
SOLVER_JVP2_REPLACES = {
    "recomb_scan_jvp2": "eftpipe_tpu/boltzmann/thermo.py:317 (its second derivative: "
                        "jax.hessian through _thermo_on_grid's lax.scan, "
                        "eftpipe_tpu/api/orchestrate.py:905; no Pallas)",
    "eb_solve_jvp2": "eftpipe_tpu/boltzmann/einstein_boltzmann.py:563 (its second derivative: "
                     "jax.hessian through solve_k's lax.scan, "
                     "eftpipe_tpu/api/orchestrate.py:905; no Pallas)",
}


def pair_jet(par):
    """The pair rows of ``par`` in ``HESS_FIELDS``: (every field's rows, the
    jet of those fields)."""
    values = {n: getattr(par, n) for n in thermo.CosmoParams._fields[:-1]}
    return jet.pair_rows(values, HESS_FIELDS, par.h)


def part_errs(got, want) -> list:
    """Each part's largest |Δ| over its largest |value|, the largest |Δ|."""
    errs = [max(rel_err(g, w) for g, w in zip(got[i], want[i])) for i in range(4)]
    return errs, max(float((g - w).abs().max()) for i in range(4) for g, w in zip(got[i], want[i]))


def hess_check_recomb(nw: int = 2, n: int = 1024) -> dict:
    """(a): ``recomb_scan_jvp2`` against ``recomb_scan_plain`` on hyper-dual
    operands (on the host): ``nw`` seeded box cosmologies, their pair rows in
    ``HESS_FIELDS``, the inputs' jets those of the stage before the
    recurrence on an ``n``-point grid (``jet.jet_call``, on the card); the
    value and the first-order part against the forward and tangent kernels
    on the same rows."""
    par = box_batch(box_draws(nw, seed=31))
    rows, pj = pair_jet(par)
    base = thermo.CosmoParams(**rows, deg_ncdm=par.deg_ncdm)

    def stage(ocdm, h):
        p = base._replace(omega_cdm=ocdm, h=h)
        return thermo.recomb_inputs(p, thermo.background_tables(p, n_grid=n))

    with DenseTangents():
        ins = jet.jet_call(stage, pj)
    ins = jet.Jet(*(tuple(t.contiguous() for t in p) for p in ins))
    dlna = thermo.scan_step(thermo.background_tables(base, n_grid=n))
    got, ms = timed(lambda: thermo.recomb_scan_jvp2_cuda(ins, dlna), warmup=1)
    fwd = thermo.recomb_scan_cuda(*ins.v, dlna)
    _, dual = thermo.recomb_scan_jvp_cuda(list(ins.v), list(ins.a), dlna)
    host = jet.Jet(*(tuple(t.cpu() for t in p) for p in ins))
    t0 = time.perf_counter()
    want = thermo.recomb_scan_jvp2_plain(host, dlna)
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = jet.Jet(*(tuple(t.cuda() for t in p) for p in want))
    errs, abs_err = part_errs(got, want)
    row = dict(W=nw, rows=len(rows["h"]), n=n, fields=list(HESS_FIELDS),
               part_err=dict(zip(("value", "p", "q", "pq"), errs)), budget=HESS_PART_BUDGET,
               value_err=max(float(((g - f).abs() / f.abs()).max()) for g, f in zip(got.v, fwd)),
               first_order_err=max(rel_err(g, d) for g, d in zip(got.a, dual)),
               lower_budget=HESS_LOWER_BUDGET, ms=ms, plain_ms=plain_ms,
               plain="recomb_scan_plain on jet.HyperDual operands, the inputs copied to the host",
               max_abs_err=abs_err,
               finite=all(bool(torch.isfinite(t).all()) for p in want for t in p))
    row.update(recomb_bound(len(rows["h"]), n, hyper=True, saha=saha_block(ins.v[3])))
    return row


def hess_check_eb(solver, nw: int = 1, cut: int = 500) -> dict:
    """(a): ``eb_solve_jvp2`` against ``eb_solve_plain`` on hyper-dual
    tables (on the host): ``nw`` seeded box cosmologies' tables, seeded parts
    (relative 1e-2, 2e-2 and 1e-3 of each table entry), the longest mode of
    the 4-D recipe cut to its first ``cut`` steps (TCA and after: the plain
    loop on hyper-dual operands takes ~20 ms a step on the host); the value
    and the first-order part against the forward and tangent kernels."""
    par = box_batch(box_draws(nw, seed=32))
    with torch.no_grad():
        _, _, tab = solver.tables(par)
    buckets = check_buckets(solver, cut, nbuckets=0)
    mcut = buckets[-1][2]
    sel = torch.as_tensor(np.concatenate([b[0] for b in buckets]), device="cuda")
    k = solver.k_mpc
    dsched = eb.kernel_schedule(k, buckets).to("cuda")
    rng = np.random.default_rng(33)
    st = tab.stacked
    parts = tuple(sc * st * torch.as_tensor(rng.standard_normal(tuple(st.shape)), device="cuda")
                  for sc in (1e-2, 2e-2, 1e-3))
    got, ms = timed(lambda: eb.eb_solve_jvp2_cuda(tab, parts, dsched, len(k)), warmup=1)
    fwd = eb.eb_solve_cuda(tab, dsched, len(k))
    _, dual = eb.eb_solve_jvp_cuda(tab, parts[0].contiguous(), dsched, len(k))
    host = eb.EBTables(tab.lna.cpu(), tab.dlna.cpu(), None, st.cpu())
    t0 = time.perf_counter()
    want = eb.eb_solve_jvp2(host, tuple(p.cpu() for p in parts), k[sel.cpu().numpy()],
                            [(np.arange(b[0].size), *b[1:]) for b in buckets])
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = jet.Jet(*(tuple(t[..., sel] for t in p) for p in got))
    want = jet.Jet(*(tuple(t.cuda() for t in p) for p in want))
    errs, abs_err = part_errs(got, want)
    steps = int(eb.kernel_schedule(k, buckets).steps.sum())
    return dict(W=nw, modes=int(sel.numel()), mode_steps=steps * nw,
                cut_mode_tca_steps=int(mcut[0, :-1].sum()),
                cut_mode_post_tca_steps=int((~mcut[0, :-1]).sum()),
                part_err=dict(zip(("value", "p", "q", "pq"), errs)), budget=HESS_PART_BUDGET,
                value_err=max(rel_err(g, f[..., sel]) for g, f in zip(got.v, fwd)),
                first_order_err=max(rel_err(g, d[..., sel]) for g, d in zip(got.a, dual)),
                lower_budget=HESS_LOWER_BUDGET, ms=ms, plain_ms=plain_ms,
                plain="eb_solve_plain on jet.HyperDual tables, copied to the host",
                max_abs_err=abs_err,
                finite=all(bool(torch.isfinite(t).all()) for p in want for t in p))


class KernelRecorder:
    """Keeps the arguments of each call of a module's function (the
    second-order kernels' wrappers), for timing them again on the path's
    own inputs."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []
        self.fn = getattr(module, name)

    def __enter__(self):
        def rec(*args):
            self.calls.append(args)
            return self.fn(*args)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def hess_fd_check(an, against=None) -> tuple[dict, dict]:
    """(b), (c) and (e): ``Analysis._hessian`` at θ₀ of the float64 analysis
    through the kernels, its launches and seconds (the first call, then
    another), each row against central differences of ∇logp (every
    perturbed point in one value and gradient); the solver's outputs,
    ``logp`` and the gradient of a seeded loss of the solver's outputs with
    the gradient's graph (``create_graph=True``) against without it, bit for
    bit, ∇logp within ``HESS_GRAPH_GRAD_BUDGET``, and the launches of a
    value and gradient; the second-order kernels timed again on the inputs
    the Hessian gave them, and in turns with ``against``'s."""
    theta0 = np.asarray(an.space.theta0(), np.float64)
    ndim = theta0.size
    bk.reset_launch_counts()
    qf.reset_launch_counts()
    with KernelRecorder(thermo, "recomb_scan_jvp2_cuda") as rr, \
            KernelRecorder(eb, "eb_solve_jvp2_cuda") as er:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = an._hessian(theta0)
        torch.cuda.synchronize()
        hess_s = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    qf_shapes = dict(qf.LAUNCHES_BY_SHAPE)
    saved = dict(bk.LAUNCHES)
    t0 = time.perf_counter()
    h_again = an._hessian(theta0)
    torch.cuda.synchronize()
    hess_again_s = time.perf_counter() - t0
    bk.LAUNCHES.update(saved)
    # the jet pass alone (its host stages and the two kernels) at the same rows
    prov = an.providers["LRG"]
    par = thermo.as_batch(prov._params(an.params_dict(torch.as_tensor(
        np.tile(theta0, (ndim, 1)), dtype=torch.float64, device="cuda"))))
    names = tuple(n for n in eb.TABLE_FIELDS if n in an.space.sampled)
    saved = dict(bk.LAUNCHES)
    _, jet_ms = timed(lambda: prov.solver.table_hessians(par, names))
    (ins, dlna), = rr.calls
    (tab, parts, dsched, nk), = er.calls
    _, recomb_ms = timed(lambda: thermo.recomb_scan_jvp2_cuda(ins, dlna))
    _, eb_ms = timed(lambda: eb.eb_solve_jvp2_cuda(tab, parts, dsched, nk))
    _, recomb_fwd_ms = timed(lambda: thermo.recomb_scan_cuda(*(t.contiguous() for t in ins.v),
                                                             dlna))
    _, eb_fwd_ms = timed(lambda: eb.eb_solve_cuda(tab, dsched, nk))
    bk.LAUNCHES.update(saved)
    nrows = tab.stacked.shape[0]
    sched = prov.solver.schedule()
    longest = int(sched.steps.max())
    nz = dsched["out_idx"].shape[1]
    times = dict(
        hessian_seconds=hess_s, hessian_seconds_again=hess_again_s,
        hessian_repeats_bitwise=bool(np.array_equal(h, h_again)),
        table_hessians_ms=jet_ms, rows=nrows, fields=list(names),
        recomb_scan_jvp2_ms=recomb_ms, recomb_scan_ms_same_rows=recomb_fwd_ms,
        eb_solve_jvp2_ms=eb_ms, eb_solve_ms_same_rows=eb_fwd_ms,
        host_ms_of_table_hessians=jet_ms - recomb_ms - eb_ms,
        longest_mode_steps=longest, us_per_step_longest=dict(
            eb_solve_jvp2=eb_ms * 1e3 / longest, eb_solve=eb_fwd_ms * 1e3 / longest),
        eb_solve_jvp2=eb_bound(int(sched.steps.sum()) * nrows, longest,
                               eb_bytes(tab, dsched, nz, nk, hyper=True), hyper=True),
        recomb_scan_jvp2=recomb_bound(nrows, ins.v[0].shape[-1], hyper=True,
                                      saha=saha_block(ins.v[3])))
    if against is not None:
        times["against"] = dict(
            recomb_scan_jvp2=in_turns(lambda: against.recomb_scan_jvp2(ins, dlna),
                                      lambda: thermo.recomb_scan_jvp2_cuda(ins, dlna),
                                      block=min(saha_block(ins.v[3]))),
            eb_solve_jvp2=in_turns(lambda: against.eb_solve_jvp2(tab, parts, dsched, nk),
                                   lambda: eb.eb_solve_jvp2_cuda(tab, parts, dsched, nk)))
    # central differences of the gradient: every row, step and sign in one batch
    steps = np.array(FD_STEPS)[:, None] * np.abs(theta0)[None]                # (S, ndim)
    shifted = np.repeat(np.repeat(theta0[None, None, None], len(FD_STEPS), 0), ndim, 1)
    shifted = np.repeat(shifted, 2, 2)                                         # (S, ndim, 2, ndim)
    for j in range(ndim):
        shifted[:, j, 0, j] += steps[:, j]
        shifted[:, j, 1, j] -= steps[:, j]
    bk.reset_launch_counts()
    x = torch.as_tensor(shifted.reshape(-1, ndim), dtype=torch.float64, device="cuda")
    _, g = value_and_grad_fn(an, x)()
    fd_launches = dict(bk.LAUNCHES)
    g = g.cpu().numpy().reshape(len(FD_STEPS), ndim, 2, ndim)
    fd = (g[:, :, 0] - g[:, :, 1]) / (2.0 * steps[:, :, None])                 # (S, ndim, ndim)
    scale = np.abs(h).max(axis=1, keepdims=True)
    rel = np.abs(fd - h[None]) / scale[None]                                   # (S, ndim, ndim)
    best = rel.min(axis=0)
    sym = float(np.abs(h - h.T).max() / np.abs(h).max())
    # with and without the gradient's graph
    rng = np.random.default_rng(34)
    xs = torch.as_tensor(theta0[None] * (1.0 + 1e-2 * rng.standard_normal((2, ndim))),
                         dtype=torch.float64, device="cuda")
    rec = prov.solver = SolverRecorder(prov.solver)
    fields = ("pk", "pk_cb", "sigma8", "f", "h_of_z", "da_of_z", "rs_drag")
    weights = None
    runs = []
    try:
        for graph in (False, True):
            xg = xs.clone().requires_grad_()
            bk.reset_launch_counts()
            lp = an.logp(xg)
            (gr,) = torch.autograd.grad(lp.sum(), xg, create_graph=graph, retain_graph=True)
            counts = dict(bk.LAUNCHES)
            sol = rec.calls[-1]
            if weights is None:
                weights = [torch.as_tensor(rng.standard_normal(tuple(getattr(sol, f).shape)),
                                           device="cuda") / getattr(sol, f).detach().abs().mean()
                           for f in fields]
            loss = sum((w * getattr(sol, f)).sum() for w, f in zip(weights, fields))
            (gs,) = torch.autograd.grad(loss, xg, create_graph=graph)
            runs.append((lp.detach(), gr.detach(), counts, gs.detach()))
    finally:
        prov.solver = rec.solver
    outputs_equal = {f: bool(torch.equal(getattr(rec.calls[0], f).detach(),
                                         getattr(rec.calls[1], f).detach()))
                     for f in eb.LinearPower._fields}
    out = dict(dtype="float64", params=list(an.space.sampled), theta0=theta0.tolist(),
               hessian=h.tolist(), symmetry_err=sym, symmetry_budget=HESS_SYM_BUDGET,
               fd_steps_rel=list(FD_STEPS), fd_rel_err_by_step=rel.max(axis=(1, 2)).tolist(),
               fd_rel_err_by_row=dict(zip(an.space.sampled, best.max(axis=1).tolist())),
               fd_max_rel_err=float(best.max()), fd_budget=HESS_FD_BUDGET,
               fd_batch=int(x.shape[0]), fd_launches=fd_launches,
               solver_outputs_equal_with_graph=outputs_equal,
               logp_equal_with_graph=bool(torch.equal(runs[0][0], runs[1][0])),
               solver_grad_equal_with_graph=bool(torch.equal(runs[0][3], runs[1][3])),
               grad_rel_err_with_graph=rel_err(runs[1][1], runs[0][1]),
               grad_graph_budget=HESS_GRAPH_GRAD_BUDGET,
               launches_value_and_grad=runs[0][2], launches_value_and_grad_with_graph=runs[1][2],
               launches_hessian=launches, times=times,
               finite=bool(np.isfinite(h).all() and np.isfinite(g).all()))
    return out, qf_shapes


def hess_laplace(an64, an32) -> tuple[dict, dict, dict]:
    """(d): ``laplace_cov()`` of both analyses (finite, positive-definite),
    its seconds, and ``run_mcmc(sampler="hmc", init="laplace")`` on the
    float32 analysis (2 chains, ``n_leapfrog=1``, ``warmup_steps=1``, 1
    step; its metric and start from the Laplace covariance)."""
    out, launches = {}, {}
    for name, an in (("float64", an64), ("float32", an32)):
        bk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cov = an.laplace_cov()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = dict(bk.LAUNCHES)
        ev = np.linalg.eigvalsh(0.5 * (cov + cov.T))
        out[name] = dict(seconds=seconds, finite=bool(np.isfinite(cov).all()),
                         positive_definite=bool(ev.min() > 0), min_eig=float(ev.min()),
                         sigma=np.sqrt(np.diag(cov)).tolist(), launches=launches[name])
    bk.reset_launch_counts()
    qf.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = an32.run_mcmc(nwalkers=2, out=os.path.join(tmp, "hmc"), max_steps=1, block=1,
                            rhat_tol=-1.0, key=0, sampler="hmc", init="laplace", n_leapfrog=1,
                            warmup_steps=1, with_derived=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out["hmc_laplace"] = dict(nchains=2, n_leapfrog=1, warmup_steps=1, steps=1, dtype="float32",
                              chain_shape=list(res.chain.shape), accept_rate=res.accept_rate,
                              finite=bool(np.isfinite(res.chain).all()
                                          and np.isfinite(res.logps).all()),
                              seconds=seconds, launches=dict(bk.LAUNCHES))
    return out, launches["float64"], dict(bk.LAUNCHES)


def solver_hessian_phase(solver, an64, an32, lines: list, against=None) -> dict:
    """Phase 10c: the solver's second derivative on the card
    (``solver_hessian`` line).  ``solver``: the 4-D recipe solver, for (a);
    ``an64``, ``an32``: ``solver_grad``'s analyses.  Returns the solver
    kernels' launches by path, the ``qf_real`` launches by shape of the
    paths, and the line."""
    t_phase = time.perf_counter()
    out, by_path, qf_paths = {}, {}, {}
    out["recomb_check"] = hess_check_recomb()
    out["eb_check"] = hess_check_eb(solver)
    out["hessian"], qf_paths["solver_hessian_fd"] = hess_fd_check(an64, against)
    by_path["solver_hessian_fd"] = out["hessian"]["fd_launches"]
    out["laplace"], by_path["solver_hessian"], by_path["solver_hmc_laplace"] = hess_laplace(
        an64, an32)
    out["nvidia_smi"] = nvidia_smi_line()
    out["seconds"] = time.perf_counter() - t_phase
    lines.append(emit("solver_hessian", **out))
    failed = []
    for key in ("recomb_check", "eb_check"):
        c = out[key]
        if not (c["finite"] and all(v <= c["budget"] for v in c["part_err"].values())):
            failed.append(f"{key} parts {c['part_err']}")
        if not (c["value_err"] <= HESS_LOWER_BUDGET and c["first_order_err"] <= HESS_LOWER_BUDGET):
            failed.append(f"{key} value / first order {c['value_err']} {c['first_order_err']}")
    hs = out["hessian"]
    if not (hs["finite"] and hs["fd_max_rel_err"] <= HESS_FD_BUDGET
            and hs["symmetry_err"] <= HESS_SYM_BUDGET):
        failed.append(f"hessian {hs['fd_rel_err_by_row']} symmetry {hs['symmetry_err']}")
    if not (all(hs["solver_outputs_equal_with_graph"].values()) and hs["logp_equal_with_graph"]
            and hs["solver_grad_equal_with_graph"]
            and hs["grad_rel_err_with_graph"] <= HESS_GRAPH_GRAD_BUDGET
            and hs["times"]["hessian_repeats_bitwise"]):
        failed.append(f"with/without the graph {hs['solver_outputs_equal_with_graph']} "
                      f"{hs['solver_grad_equal_with_graph']} {hs['grad_rel_err_with_graph']}")
    one_each = dict(eb_solve=1, recomb_scan=1, eb_solve_jvp=1, recomb_scan_jvp=1)
    for key in ("launches_value_and_grad", "launches_value_and_grad_with_graph"):
        if hs[key] != one_each | dict(eb_solve_jvp2=0, recomb_scan_jvp2=0):
            failed.append(f"{key} {hs[key]}")
    if hs["launches_hessian"] != one_each | dict(eb_solve_jvp2=1, recomb_scan_jvp2=1):
        failed.append(f"launches of one Hessian {hs['launches_hessian']}")
    la = out["laplace"]
    for name in ("float64", "float32"):
        if not (la[name]["finite"] and la[name]["positive_definite"]):
            failed.append(f"laplace_cov {name} {la[name]}")
    if not la["hmc_laplace"]["finite"]:
        failed.append(f"hmc init=laplace {la['hmc_laplace']}")
    if failed:
        raise SystemExit(f"chip_smoke: solver_hessian: failed {failed}")
    return dict(by_path=by_path, qf_paths=qf_paths, out=out)


# ---------------------------------------------------------------------------
# emulator training (phases 11 and 12) and the walker mesh (phase 13)
# ---------------------------------------------------------------------------
# the recipe that reproduces the shipped artifact pk_emulator_mnu06.npz
TRAIN_RECIPE = dict(n=512, inner_frac=0.35, degree=8, degree_in=7, ncomp=96, batch=64)
TRAIN_LOG_T_BUDGET = 1e-6
TRAIN_LOG_RDRAG_BUDGET = 1e-7
TRAIN_PROVIDER_REL_BUDGET = 1e-6
# arrays made by host arithmetic on the same Sobol points: equal bit for bit
TRAIN_BITWISE = ("x_mean", "x_std", "bounds_lo", "bounds_hi", "x_mean_in", "x_std_in",
                 "blend_lo", "blend_hi", "blend_margin")
# the held-out errors the shipped artifact's commit (30719cf) states
SHIPPED_REPORT = dict(val_inner_max_abs_logT=2.9e-4, val_max_abs_log_rdrag=2.2e-4)
TRANSFER_K = np.logspace(-4, 0.3, 100)  # tests/test_boltzmann_extras.py's k grid [1/Mpc]
TRANSFER_HELDOUT = np.array([0.0223, 0.118, 0.69, 0.965])  # and its held-out point
TRANSFER_REL_BUDGET = 0.02
MESH_WALKERS, MESH_STEPS = 256, 4
MESH_CHAINS, MESH_HMC_STEPS = 16, 5


def seeded_box(n: int, seed: int, lo, hi) -> np.ndarray:
    return lo + (hi - lo) * np.random.default_rng(seed).random((n, len(lo)))


def training_phase(lines: list) -> dict:
    """Phase 11: the shipped P(k) artifact retrained at full width
    (``tools/train_solver_emulator.py``'s recipe: 512 solves of 288 k × 13 z
    on the 8-corner envelope of the 3-D box, 64 a call; the PCA + ridge fit
    and its inner blend) and compared with the shipped one.  Returns the
    solver kernels' launches of the path."""
    t_phase = time.perf_counter()
    r = TRAIN_RECIPE
    shipped = PkEmulator.load(DEFAULT_PK_ARTIFACT)
    out = dict(recipe=r)
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        design = train_tool.prepare_workdir(wd, train_tool.sample_design(r["n"], r["inner_frac"]))
        out["design_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            solver = train_tool.design_solver(design, device="cuda")
        sched = solver.schedule()
        out["schedule"] = dict(corners=2 ** len(design["names"]), modes=int(sched.k.size),
                               z=int(solver.z_out.size), longest_mode_steps=int(sched.steps.max()),
                               mode_steps=int(sched.steps.sum()),
                               seconds=time.perf_counter() - t0)
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        calls, solve_ms = timed(lambda: train_tool.solve_samples(
            solver, design, wd, batch=r["batch"], log=lambda m: None))
        solve_s = time.perf_counter() - t0
        launches = dict(bk.LAUNCHES)
        out.update(solver_calls=calls, solve_seconds=solve_s, solve_device_ms=solve_ms,
                   cosmologies_per_s=r["n"] / solve_s, launches=launches)
        t0 = time.perf_counter()
        emu, report = train_tool.fit(wd, design, r["ncomp"], r["degree"], r["degree_in"],
                                     device="cuda")
        out["fit_seconds"] = time.perf_counter() - t0
        out["report"] = report
        out["report_stated_for_the_shipped_artifact"] = SHIPPED_REPORT

        # (a) host arithmetic on identical Sobol points: bit for bit
        out["bitwise"] = {name: bool(np.array_equal(getattr(emu, name), getattr(shipped, name)))
                          for name in TRAIN_BITWISE}
        # (b) both artifacts' predictions, float64 on the card: the held-out
        # points, seeded points of the wide box and of the blend region
        t0 = time.perf_counter()
        vi = np.random.default_rng(0).permutation(r["n"])[:report["n_val"]]
        lo, hi = shipped.box()
        m = shipped.blend_margin
        groups = dict(validation=design["x"][vi], wide=seeded_box(128, 31, lo, hi),
                      blend=seeded_box(128, 32, shipped.blend_lo - m, shipped.blend_hi + m))
        nzk = len(shipped.z_grid) * len(shipped.kgrid)
        pred = {}
        for name, pts in groups.items():
            xt = torch.as_tensor(pts, dtype=torch.float64, device="cuda")
            with torch.no_grad():
                d = (emu.raw(xt) - shipped.raw(xt)).abs()
            pred[name] = dict(points=len(pts), max_abs_dlog_tm=float(d[:, :nzk].max()),
                              max_abs_dlog_tcb=float(d[:, nzk:2 * nzk].max()),
                              max_abs_dlog_rdrag=float(d[:, -1].max()))
        out["predictions"] = pred
        out["coeffs_max_rel_diff"] = {
            name: float(np.abs(getattr(emu, name) - getattr(shipped, name)).max()
                        / np.abs(getattr(shipped, name)).max())
            for name in ("coeffs", "coeffs_in")}
        # (d) the solver-emulator provider on the retrained file and the
        # shipped one, float64, at 64 seeded points of the inner box
        path = os.path.join(wd, "retrained.npz")
        emu.save(path)
        cfg = EFTConfig()
        pts = seeded_box(64, 33, np.array([0.0195, 0.075, 0.55, 2.9, 0.94]),
                         np.array([0.0255, 0.175, 0.80, 3.2, 0.99]))
        params = {n: torch.as_tensor(pts[:, i], dtype=torch.float64, device="cuda")
                  for i, n in enumerate(("omega_b", "omega_cdm", "h", "ln10As", "ns"))}
        with torch.no_grad():
            got = SolverEmulatorProvider.load(cfg, 0.7, path=path).inputs(params)
            ref = SolverEmulatorProvider.load(cfg, 0.7).inputs(params)
        out["provider"] = {f: rel_err(getattr(got, f), getattr(ref, f)) for f in ("plin", "f")}
        out["validation_seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = nvidia_smi_line()
    out["seconds"] = time.perf_counter() - t_phase
    lines.append(emit("training", **out))
    failed = [f"(a) {k}" for k, v in out["bitwise"].items() if not v]
    for name, p in pred.items():
        if not (p["max_abs_dlog_tm"] <= TRAIN_LOG_T_BUDGET
                and p["max_abs_dlog_tcb"] <= TRAIN_LOG_T_BUDGET
                and p["max_abs_dlog_rdrag"] <= TRAIN_LOG_RDRAG_BUDGET):
            failed.append(f"(b) {name} {p}")
    if not all(v <= TRAIN_PROVIDER_REL_BUDGET for v in out["provider"].values()):
        failed.append(f"(d) {out['provider']}")
    calls = r["n"] // r["batch"]  # and no tangent kernel: the solves take no gradient
    if launches != {"eb_solve": calls, "recomb_scan": calls, "eb_solve_jvp": 0,
                    "recomb_scan_jvp": 0, "eb_solve_jvp2": 0, "recomb_scan_jvp2": 0}:
        failed.append(f"(e) launches {launches}")
    if failed:
        raise SystemExit(f"chip_smoke: training: failed {failed}")
    return launches


def transfer_training_phase(lines: list) -> None:
    """Phase 12: ``train_transfer_emulator`` at the JAX defaults (2,048 EH98
    samples, width 128, depth 3, 3,000 Adam steps of 256, lr 3e-3), float32
    on the card, held to the JAX suite's 2 % gate at its held-out point on
    its k grid; then a save → load → provider round trip."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    emu, train_ms = timed(lambda: train_transfer_emulator(TRANSFER_K, dtype=torch.float32,
                                                          device=dev))
    train_s = time.perf_counter() - t0
    on_card = all(t.device.type == "cuda" for layer in emu.params for t in layer.values())
    k = torch.as_tensor(TRANSFER_K, dtype=torch.float64, device=dev)
    y_std = torch.as_tensor(emu.y_std, device=dev)

    def errors(x):
        with torch.no_grad():
            t_emu = emu(torch.as_tensor(x, dtype=torch.float32, device=dev)).double()
            col = lambda i: torch.as_tensor(x[:, i:i + 1], dtype=torch.float64, device=dev)
            t_ref, _ = eh98_transfer(k[None], col(0), col(0) + col(1), col(2))
        rel = (t_emu / t_ref - 1.0).abs().max(-1).values
        loss = (((torch.log(t_emu) - torch.log(t_ref)) / y_std) ** 2).mean()
        return float(rel.max()), float(loss)

    held, _ = errors(TRANSFER_HELDOUT[None])
    lo, hi = (np.array([v[i] for v in DEFAULT_BOUNDS.values()]) for i in (0, 1))
    worst, loss = errors(seeded_box(256, 34, lo, hi))
    cfg = EFTConfig()
    da_fid, h_fid = lcdm_da(0.31, 0.7), lcdm_hubble(0.31, 0.7)
    pts = seeded_box(16, 35, np.append(lo, 2.9), np.append(hi, 3.2))
    params = {n: torch.as_tensor(pts[:, i], dtype=torch.float32, device=dev)
              for i, n in enumerate(("omega_b", "omega_cdm", "h", "ns", "ln10As"))}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transfer.npz")
        emu.save(path)
        with torch.no_grad():
            got = EmulatorProvider.load(cfg, 0.7, path).inputs(params)
            ref = EmulatorProvider(cfg=cfg, zeff=0.7, emulator=emu, da_fid=da_fid,
                                   h_fid=h_fid).inputs(params)
    round_trip = {f: rel_err(getattr(got, f), getattr(ref, f)) for f in ("plin", "f")}
    steps = 3000
    lines.append(emit(
        "transfer_training", n_samples=2048, width=128, depth=3, steps=steps, batch=256,
        lr=3e-3, dtype="float32", params_on_card=on_card, seconds=train_s, device_ms=train_ms,
        steps_per_s=steps / train_s, heldout_point=TRANSFER_HELDOUT.tolist(),
        heldout_max_rel_err=held, budget=TRANSFER_REL_BUDGET, worst_of_256_in_box=worst,
        heldout_normalised_mse_256=loss, round_trip_max_rel=round_trip,
        nvidia_smi=nvidia_smi_line()))
    if not (on_card and held < TRANSFER_REL_BUDGET and max(round_trip.values()) == 0.0):
        raise SystemExit(f"chip_smoke: transfer_training: parameters on the card {on_card}, "
                         f"held-out error {held}, round trip {round_trip}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_phase(model, lines: list) -> dict:
    """Phase 13: a one-rank NCCL group on the card, formed here; the lite
    flagship under ``MCMCDriver(mesh=walker_mesh())`` (stretch, 256
    walkers, 4 steps) and ``HMC(mesh=...)`` (16 chains, 5 warmup + 5
    steps), each against the same run without the mesh on the same seed,
    bit for bit.  Returns the kernels' launches of the mesh runs by shape."""
    import torch.distributed as dist

    dev = torch.device("cuda")
    x0 = torch.as_tensor(model.theta0, dtype=torch.float32, device=dev)
    q0 = torch.as_tensor(accuracy_batch(model.theta0)[:MESH_CHAINS], dtype=torch.float32,
                         device=dev)
    inv_mass0 = torch.as_tensor((1e-2 * model.theta0) ** 2, dtype=torch.float32, device=dev)

    def stretch(mesh):
        drv = MCMCDriver(logp=model.logp, ndim=9, nwalkers=MESH_WALKERS, block=MESH_STEPS,
                         rhat_tol=-1.0, mesh=mesh, device=None if mesh else dev)
        return drv.run(seed=7, x0=x0, max_steps=MESH_STEPS)

    def hmc(mesh):
        sampler = HMC(logp=model.logp, ndim=9, n_leapfrog=4, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(8)
        state, eps, inv_mass, acc_w = sampler.warmup(gen, q0, MESH_HMC_STEPS, 1e-3, inv_mass0)
        chain, logps, acc = sampler.run(gen, state, eps, inv_mass, MESH_HMC_STEPS)
        return chain, logps, acc, eps, inv_mass, acc_w

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = walker_mesh()
        ref_stretch = stretch(None)  # comparisons, uncounted
        ref_hmc = hmc(None)
        torch.cuda.synchronize()
        qf.reset_launch_counts()
        mesh.collectives = 0
        t0 = time.perf_counter()
        got_stretch = stretch(mesh)
        torch.cuda.synchronize()
        stretch_s = time.perf_counter() - t0
        stretch_coll = mesh.collectives
        t0 = time.perf_counter()
        got_hmc = hmc(mesh)
        torch.cuda.synchronize()
        hmc_s = time.perf_counter() - t0
        hmc_coll = mesh.collectives - stretch_coll
        by_shape = dict(qf.LAUNCHES_BY_SHAPE)
        launches = dict(qf.LAUNCHES)
        # one all_gather of a half-ensemble's values, alone
        half = torch.zeros(MESH_WALKERS // 2, dtype=torch.float32, device=dev)
        _, gather_ms = timed(lambda: [mesh.gather(half) for _ in range(50)], warmup=1)
        gather_ms /= 50
    finally:
        dist.destroy_process_group()
    stretch_equal = (bool(np.array_equal(got_stretch.chain, ref_stretch.chain))
                     and bool(np.array_equal(got_stretch.logps, ref_stretch.logps)))
    hmc_equal = all(bool(torch.equal(a, b)) for a, b in zip(got_hmc, ref_hmc))
    stretch_per_step = (stretch_coll - 1) / MESH_STEPS  # the first: the initial evaluation
    lines.append(emit(
        "mesh", backend="nccl", ranks=1, model="flagship-lite, float32, kernels",
        stretch=dict(nwalkers=MESH_WALKERS, steps=MESH_STEPS, bitwise_equal=stretch_equal,
                     seconds=stretch_s, collectives=stretch_coll,
                     collectives_per_step=stretch_per_step,
                     collective_share_of_step=stretch_per_step * gather_ms
                     / (1e3 * stretch_s / MESH_STEPS)),
        hmc=dict(nchains=MESH_CHAINS, n_leapfrog=4, warmup=MESH_HMC_STEPS, steps=MESH_HMC_STEPS,
                 bitwise_equal=hmc_equal, seconds=hmc_s, collectives=hmc_coll,
                 collectives_per_transition=hmc_coll / (2 * MESH_HMC_STEPS),
                 collective_share=hmc_coll * gather_ms / (1e3 * hmc_s),
                 accept_warmup=float(got_hmc[5]), accept=float(got_hmc[2])),
        all_gather_ms=gather_ms, all_gather_numbers=MESH_WALKERS // 2, launches=launches,
        nvidia_smi=nvidia_smi_line()))
    if not (stretch_equal and hmc_equal and launches["qf_real"] > 0):
        raise SystemExit(f"chip_smoke: mesh: stretch equal {stretch_equal}, hmc equal "
                         f"{hmc_equal}, launches {launches}")
    return by_shape


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only, few timed calls")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--against", default=None,
                    help="directory holding another quadform.cu (its float64 kernels) and/or "
                         "boltzmann.cu (its six solver kernels), timed beside this tree's")
    ap.add_argument("--out", default=None,
                    help="directory that receives chip_smoke.json and ptxas.log")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    lines = []

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    lines.append(emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
                      torch=torch.__version__, cuda=torch.version.cuda,
                      python=sys.version.split()[0],
                      allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    per_source = {}
    for name, log in sorted(_build.BUILD_LOG.items()):
        kernels = ptxas_summary(log["ptxas"])
        per_source[name] = dict(
            cached=log["cached"], kernels=len(kernels),
            max_registers=max([k["registers"] or 0 for k in kernels] or [0]),
            kernels_with_spills=sum(1 for k in kernels
                                    if (k["spill_stores"] or 0) + (k["spill_loads"] or 0)),
            sass=sass_counts(log["path"]),
            registers={k["kernel"]: k["registers"] for k in kernels},
            spills={k["kernel"]: [k["spill_stores"], k["spill_loads"]] for k in kernels})
    lines.append(emit("build", seconds=build_s, sources=per_source))
    if args.out:
        with open(os.path.join(args.out, "ptxas.log"), "w") as f:
            f.write("\n".join(log["ptxas"] for log in _build.BUILD_LOG.values()))

    # ---- kernels against their plain versions ----------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    n_timed = 2 if args.quick else 5
    f32, f64 = torch.float32, torch.float64
    shapes = [
        ("qf_real", f32, 3, 33, 20, 11), ("qf_real", f64, 3, 33, 20, 11),
        ("cf_half", f32, 3, 33, 20, 11), ("cf_half", f64, 3, 33, 20, 11),
        # W·S = 130: no multiple of the float64 column tiles (64 of w, 32 of
        # [zr | zi]), at the flagship's N
        ("qf_real", f64, 5, 255, 26, 7), ("cf_half", f64, 5, 257, 26, 7),
        ("qf_real", f32, 64, 255, 80, 114), ("qf_real", f32, 64, 255, 80, 76),
        ("qf_real", f32, 64, 255, 50, 28), ("cf_half", f32, 64, 257, 80, 38),
        ("cf_half", f64, 64, 257, 80, 38),
    ]
    if not args.quick:
        # the walker counts the timed batches may hand the kernel (chunk trials)
        for nw in sorted(set(CHUNK_TRIALS + (LITE_BATCH, args.batch))):
            shapes += [("qf_real", f32, nw, 255, 80, 114), ("qf_real", f32, nw, 255, 80, 76),
                       ("qf_real", f32, nw, 255, 50, 28)]
    rows = [check_kernel(*shape, gen=gen, n_timed=n_timed) for shape in shapes]
    if not args.quick:
        # the float64 kernel at the float64 analysis' shapes (fewer timed calls:
        # its plain version takes ~0.1 s a call there)
        rows += [check_kernel("qf_real", f64, args.batch, 255, s_, bl, gen=gen, n_timed=2)
                 for s_, bl in ((80, 114), (80, 76), (50, 28))]
    lines.append(emit("kernel_checks", kernels=rows))
    against = None
    if args.against and os.path.exists(os.path.join(args.against, "quadform.cu")):
        timed64 = [(r["kernel"], r["W"], r["N"], r["S"], r["BL"]) for r in rows
                   if r["dtype"] == "f64" and r["W"] >= 64]
        lines.append(emit("against", rows=against_rows(args.against, timed64, gen)))
    if args.against and os.path.exists(os.path.join(args.against, "boltzmann.cu")):
        against = AgainstSolver(args.against)
        lines.append(emit("against_build", source=against.src, kernels=against.ptxas))
    by_path = {}
    if args.quick:
        print(smi)
        print(json.dumps({"ok": True, "quick": True,
                          "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}}))
        return

    # ---- the two flagship paths, then the survey-geometry stages ---------
    by_path["main_path"], model, ref_model = flagship_path(
        "main_path", "flagship LRG(nl=3)+ELG(nl=2), nfft_loop=256, window, solver_emulator",
        dict(), nb=args.batch, n_timed=3, chunk_trials=CHUNK_TRIALS, full=True, lines=lines)
    by_path.update(sampling_phase(model, ref_model, lines))
    by_path["lowrank"] = lowrank_phase(model, ref_model, lines)
    del model, ref_model
    by_path["main_path_lite"], lite, lite_ref = flagship_path(
        "main_path_lite", "flagship LRG(nl=3)+ELG(nl=2), nfft_loop=256, eh98, no window",
        dict(with_window=False, cosmology="eh98"), nb=LITE_BATCH, n_timed=1,
        chunk_trials=(), full=False, lines=lines)
    del lite_ref
    by_path["mesh"] = mesh_phase(lite, lines)
    del lite
    stages_check(64, lines)
    by_path.update(analysis_phase(lines))
    solver = solver_phase(lines, args.out, against)
    by_path["solver_analysis"] = solver["qf_shapes"]
    box = solver.pop("solver")
    grad = solver_grad_phase(box, lines, against)
    by_path.update(grad["qf_paths"])
    solver["by_path"].update(grad["by_path"])
    hess = solver_hessian_phase(box, grad.pop("an64"), grad.pop("an32"), lines, against)
    del box
    by_path.update(hess["qf_paths"])
    solver["by_path"].update(hess["by_path"])
    solver["by_path"]["training"] = training_phase(lines)
    transfer_training_phase(lines)
    # the quadratic-form kernels at the shapes the solver's analyses (their
    # values and gradients) and the mesh path gave them
    checked = {(r["kernel"], r["dtype"], r["W"], r["N"], r["S"], r["BL"]) for r in rows}
    launched = set(solver["qf_shapes"]) | set(by_path["mesh"])
    for shapes in list(grad["qf_paths"].values()) + list(hess["qf_paths"].values()):
        launched |= set(shapes)
    for key in sorted(launched - checked):
        kernel, suffix, nw, n, s_, bl = key
        rows.append(check_kernel(kernel, f32 if suffix == "f32" else f64, nw, n, s_, bl,
                                 gen=gen, n_timed=n_timed))

    # ---- the kernels line: one row per kernel and shape the paths launched,
    # with the launches of each path and their sum -------------------------
    out_rows = []
    for row in rows:
        key = (row["kernel"], row["dtype"], row["W"], row["N"], row["S"], row["BL"])
        per_path = {path: counts[key] for path, counts in by_path.items() if key in counts}
        if not per_path:
            continue  # a shape of the checks only (ragged)
        if row["kernel"] == "qf_real":
            per_path.setdefault("lowrank", 0)  # the low-rank route: two matmuls, no kernel
        per_path.setdefault("mesh", 0)
        per_path.setdefault("training", 0)
        out_rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "peak", "library_ms", "prepared")}
            | {"launches": sum(per_path.values()), "launches_by_path": per_path})
    for kernel in ("qf_real", "cf_half"):
        for suffix in ("f32", "f64"):
            if not any(r["name"].startswith(f"{kernel}[{suffix},") for r in out_rows):
                raise SystemExit(f"chip_smoke: kernel {kernel} ({suffix}) was not launched "
                                 f"on any path")
    solver["rows"] = solver_rows(solver["out"], grad["out"], hess["out"], solver["by_path"])
    for row in solver["rows"]:
        if row["launches"] <= 0:
            raise SystemExit(f"chip_smoke: kernel {row['name']} was not launched on any path")
    out_rows += solver["rows"]
    print(json.dumps({"kernels": out_rows}), flush=True)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(lines=lines, kernels=out_rows, nvidia_smi=smi,
                           total_seconds=time.perf_counter() - t_start), f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
