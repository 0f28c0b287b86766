#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device
    python3 chip_smoke.py --quick    # build + kernel checks at small depth only
    python3 chip_smoke.py --out DIR  # also write chip_smoke.json and ptxas.log to DIR

Phases, each printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``), versions.
2. ``build``   — compiles ``eftpipe_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   sm_90a into ``build/eftpipe_tpu_torch/`` (seconds, registers, spills).
3. ``kernel_checks`` — every CUDA kernel against its plain PyTorch version in
   float64 on the same inputs: float32 at the flagship's shapes and at a small
   ragged shape, float64 at the small shape (separates an indexing fault from
   float32 rounding).  Times by ``torch.cuda.Event`` over distinct inputs.
4. ``main_path`` — builds the flagship model (two tracers, full default
   widths, float32, dense quadratic forms through the kernels) on the card,
   evaluates ``logp`` at 64 seeded points, compares with the port's float64
   plain path (|dlogp| < 0.02), runs the complex A/B check of the Hermitian
   fold, then times batches of 1024 walkers and the stage prefixes.  The
   kernels' launch counters are set to 0 just before and read just after.
   One more batch is traced with ``torch.profiler`` (``profile`` line: device
   time by kernel, the device's idle share).
5. ``kernels`` line, the card's ``nvidia-smi`` line, and the final
   ``{"ok": true, "device": {...}}`` line.

Any failed check raises: the exit code is then non-zero and no final line is
printed.  Imports nothing but the port (``eftpipe_tpu_torch``), torch, numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available() is False)\n")
    sys.exit(2)

from eftpipe_tpu_torch.api.flagship import build_flagship
from eftpipe_tpu_torch.ops import _build, quadform as qf

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, "chip_smoke_workdir")

# published peaks of one H100 SXM (data sheet, dense): device-memory rate and
# the FMA rates outside the tensor cores, which is what the kernels use
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_NAME = {torch.float32: "67 TFLOP/s float32 (non-tensor)",
             torch.float64: "34 TFLOP/s float64 (non-tensor)"}
LOGP_ABS_BUDGET = 0.02
CHUNK_TRIALS = (256, 512)  # walker chunks tried, beside the whole batch

REPLACES = {
    "qf_real": "eftpipe_tpu/ops/pallas_kernels.py:313",
    "cf_half": "eftpipe_tpu/ops/pallas_kernels.py:58",
}
SOURCE = "eftpipe_tpu_torch/csrc/quadform.cu"


def emit(phase: str, **payload) -> dict:
    line = dict(phase=phase, **payload)
    print(json.dumps(line), flush=True)
    return line


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
    once, against the operations at the card's peak for the type.  Only the
    symmetric part of M enters the forms, so the operations counted are those
    of its lower triangle: N(N+1)/2 multiply-adds per vector and output, plus
    the reduction against z."""
    sz = torch.empty((), dtype=dtype).element_size()
    nz = 1 if kernel == "qf_real" else 2
    nbytes = sz * (bl * n * n + nz * nw * n * s + nz * nw * bl * s)
    flops = nz * (1.0 * nw * bl * n * (n + 1) * s + 2.0 * nz * nw * bl * n * s)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), flops, nbytes


def check_kernel(kernel: str, dtype, nw: int, n: int, s: int, bl: int,
                 gen: torch.Generator, n_timed: int) -> dict:
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)


    nz = 1 if kernel == "qf_real" else 2
    m = rand(bl, n, n).to(dtype)
    # distinct inputs for every timed call; the first is also the checked one
    zs = [tuple(rand(nw, n, s).to(dtype) for _ in range(nz)) for _ in range(n_timed)]
    if kernel == "qf_real":
        run = lambda z: qf.qf_real_cuda(z[0], m)
        plain = lambda z: qf.qf_real_plain(z[0], m)
        ref = qf.qf_real_plain(zs[0][0].double(), m.double())
        got = run(zs[0])
        library = lambda z: torch.einsum("wns,bnm,wms->wbs", z[0], m, z[0])
        pairs = [(got, ref)]
    else:
        run = lambda z: qf.cf_half_cuda(m, z[0], z[1])
        plain = lambda z: qf.cf_half_plain(m, z[0], z[1])
        ref = qf.cf_half_plain(m.double(), zs[0][0].double(), zs[0][1].double())
        got = run(zs[0])
        mc = m.to(torch.complex64 if dtype == torch.float32 else torch.complex128)
        library = lambda z: torch.einsum(
            "wns,bnm,wms->wbs", torch.complex(z[0], z[1]), mc, torch.complex(z[0], z[1]))
        pairs = list(zip(got, ref))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        rtol, atol_rel = 2e-4, 2e-3   # sums of N² terms taken in another order
    else:
        rtol, atol_rel = 1e-10, 1e-10
    max_abs_err, ok = 0.0, True
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
    plain_ms = event_ms(plain, zs, warmup=1)
    library_ms = event_ms(library, zs, warmup=1) if lib_ok else None
    bound_ms, bound_by, flops, nbytes = bound(kernel, dtype, nw, n, s, bl)
    row = dict(
        name=f"{kernel}[{qf._SUFFIX[dtype]},W={nw},BL={bl},N={n},S={s}]",
        kernel=kernel, dtype=qf._SUFFIX[dtype], W=nw, BL=bl, N=n, S=s,
        route="cuda", source=SOURCE, replaces=REPLACES[kernel],
        max_abs_err=max_abs_err, ref_scale=scale,
        tolerance=f"|d| <= {rtol}*|ref| + {atol_rel}*max|ref| vs plain float64",
        ok=ok, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, peak=PEAK_NAME[dtype],
        flops=flops, bytes_min=nbytes,
        tflops=flops / (kernel_ms * 1e-3) / 1e12,
    )
    if not ok:
        raise SystemExit(f"chip_smoke: kernel check failed: {json.dumps(row)}")
    return row


def accuracy_batch(theta0: np.ndarray) -> np.ndarray:
    """The 64 seeded points of the JAX package's benchmark accuracy gate:
    seeds 0-3, 16 points each, theta0·(1 + 1e-3·N(0,1))."""
    parts = []
    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        parts.append(theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((16, theta0.size))))
    return np.concatenate(parts, axis=0)


def host_ms(fn, n: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_batch(fn, wall_seconds: float, top: int = 8) -> dict:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``,
    CUPTI) and the device's idle share against ``wall_seconds``, the host time
    of the same call measured WITHOUT the profiler."""
    from torch.profiler import ProfilerActivity, profile

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
    if not rows:  # no device tracing on this machine: a measurement, not a check
        return dict(device_busy_ms=None, device_idle_share=None, note="not measured")
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    return dict(device_busy_ms=busy_ms, wall_ms=wall_seconds * 1e3,
                device_idle_share=1.0 - busy_ms / (wall_seconds * 1e3),
                kernels_seen=len(rows),
                top=[dict(name=k[:80], ms=us / 1e3, calls=n) for k, us, n in rows[:top]])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only, few timed calls")
    ap.add_argument("--batch", type=int, default=1024)
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
    ptxas = [l for log in _build.BUILD_LOG.values() for l in log["ptxas"].splitlines()
             if "registers" in l or "spill" in l]
    spills = [l for l in ptxas if "spill" in l and "0 bytes spill stores, 0 bytes spill loads" not in l]
    lines.append(emit("build", seconds=build_s, sources=sorted(_build.BUILD_LOG),
                      cached={k: v["cached"] for k, v in _build.BUILD_LOG.items()},
                      max_registers=max([int(l.split("Used ")[1].split(" registers")[0])
                                         for l in ptxas if "Used " in l] or [0]),
                      kernels_with_spills=len(spills)))
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
        ("qf_real", f32, 64, 255, 80, 114), ("qf_real", f32, 64, 255, 80, 76),
        ("qf_real", f32, 64, 255, 50, 28), ("cf_half", f32, 64, 257, 80, 38),
    ]
    if not args.quick:
        # the walker counts the timed batches may hand the kernel (chunk trials)
        for nw in CHUNK_TRIALS + (args.batch,):
            shapes += [("qf_real", f32, nw, 255, 80, 114), ("qf_real", f32, nw, 255, 80, 76),
                       ("qf_real", f32, nw, 255, 50, 28)]
    rows = [check_kernel(*shape, gen=gen, n_timed=n_timed) for shape in shapes]
    lines.append(emit("kernel_checks", kernels=rows))
    if args.quick:
        print(smi)
        print(json.dumps({"ok": True, "quick": True,
                          "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}}))
        return

    # ---- main path -------------------------------------------------------
    t0 = time.perf_counter()
    model = build_flagship(WORKDIR, dtype=f32, with_window=False, cosmology="eh98")
    phase_a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_model = build_flagship(WORKDIR, dtype=f64, with_window=False, cosmology="eh98",
                               quadform="plain")
    phase_a_ref_s = time.perf_counter() - t0
    thetas = accuracy_batch(model.theta0)
    rng = np.random.default_rng(10)
    nb = args.batch
    batches = [torch.as_tensor(
        model.theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((nb, model.theta0.size))),
        dtype=f32, device="cuda") for _ in range(4)]
    with torch.no_grad():
        # untimed, uncounted: the float64 plain reference and the chunk choice
        lp_ref = ref_model.logp(thetas).cpu().numpy()
        model.logp(thetas)  # warm-up (cuBLAS handles, kernel attributes)
        chunk_ms = {c: host_ms(lambda c=c: model.logp(batches[3], chunk=c), n=2)
                    for c in CHUNK_TRIALS + (nb,)}
        chunk = min(chunk_ms, key=chunk_ms.get)
        nchunks = -(-nb // chunk)

        qf.reset_launch_counts()
        lp = model.logp(thetas)
        ab_ref, ab_fold = model.fold_ab_check(thetas, tracer="LRG", ell_index=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [model.logp(b, chunk=chunk) for b in batches[:3]]
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t0) / 3
        launches = dict(qf.LAUNCHES)
        by_shape = dict(qf.LAUNCHES_BY_SHAPE)

        # stage prefixes at the timed batch (uncounted), cumulative ms
        def prefix(stop):
            def run():
                inputs, _ = model.cosmo_inputs(batches[0])
                for name, spec in model.like.tracers.items():
                    spec.pipeline.compute_bird(inputs[name], stop_after=stop)
            return run
        stage_ms = {"cosmology": host_ms(lambda: model.cosmo_inputs(batches[0]))}
        for stop in ("nonlinear", "IRresum", "APeffect"):
            stage_ms[stop] = host_ms(prefix(stop))
        stage_ms["logp"] = host_ms(lambda: model.logp(batches[0]))
        torch.cuda.reset_peak_memory_stats()
        model.logp(batches[0], chunk=chunk)
        peak_mem = torch.cuda.max_memory_allocated()
        trace = profile_batch(lambda: model.logp(batches[0], chunk=chunk), batch_s)

    lp_np = lp.double().cpu().numpy()
    dlogp = float(np.abs(lp_np - lp_ref).max())
    ab_err = float((ab_ref - ab_fold).abs().max() / ab_fold.abs().max())
    expected_qf = 4 + 1 + 3 * 4 * nchunks
    finite = bool(np.isfinite(lp_np).all() and np.isfinite(lp_ref).all()
                  and all(torch.isfinite(t).all() for t in timed))
    main_line = emit(
        "main_path", model="flagship LRG(nl=3)+ELG(nl=2), nfft_loop=256, eh98, no window",
        dtype="float32", reference="float64 plain path on the card",
        phase_a_seconds=phase_a_s, phase_a_reference_seconds=phase_a_ref_s,
        n_points=int(lp_np.size), all_finite=finite, max_abs_dlogp=dlogp,
        budget=LOGP_ABS_BUDGET, logp_range=[float(lp_ref.min()), float(lp_ref.max())],
        fold_ab_rel_err=ab_err, launches=launches, expected_qf_real=expected_qf,
        expected_cf_half=2, batch=nb, chunk=chunk, chunk_trial_ms=chunk_ms,
        batch_seconds=batch_s, evals_per_s=nb / batch_s,
        stage_prefix_ms=stage_ms, peak_memory_bytes=peak_mem)
    lines.append(main_line)
    lines.append(emit("profile", batch=nb, chunk=chunk, **trace))
    if lp_np.shape != (64,) or any(t.shape != (nb,) for t in timed):
        raise SystemExit("chip_smoke: logp has the wrong shape")
    if not finite:
        raise SystemExit("chip_smoke: non-finite logp")
    if dlogp >= LOGP_ABS_BUDGET:
        raise SystemExit(f"chip_smoke: |dlogp| {dlogp} outside the {LOGP_ABS_BUDGET} budget")
    if ab_err > 2e-3:
        raise SystemExit(f"chip_smoke: folded and complex CF loops disagree ({ab_err})")
    if launches["qf_real"] != expected_qf or launches["cf_half"] != 2:
        raise SystemExit(f"chip_smoke: launch counts {launches}, expected "
                         f"qf_real={expected_qf}, cf_half=2")

    # ---- the kernels line: one row per kernel and main-path shape ---------
    out_rows = []
    for row in rows:
        key = (row["kernel"], row["dtype"], row["W"], row["N"], row["S"], row["BL"])
        n = by_shape.get(key, 0)
        if n == 0:
            continue  # a shape of the checks only (ragged, float64)
        out_rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")} | {"launches": n})
    for kernel in ("qf_real", "cf_half"):
        if not any(r["name"].startswith(kernel) for r in out_rows):
            raise SystemExit(f"chip_smoke: kernel {kernel} was not launched by the main path")
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
