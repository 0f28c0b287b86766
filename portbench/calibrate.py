"""Readings that set the benchmark's fixed numbers; not run by the
benchmark's own runs.

    python3 portbench/calibrate.py readings --workload <cell> --seeds 1 2 3 --seconds 4
    python3 portbench/calibrate.py hmc --workload <cell> --chains 512 --warmup 150
    python3 portbench/calibrate.py pool --config <config> --walkers 2048 --burn 100 --thin 50 --snapshots 2

``readings``: for each seed, a short window of the cell's own traffic on
the program, then its sample judged against the float64 reference (the
lower readings of the cell's limits) and the control judged the same way
at the same positions (the upper readings).  The control is the reference
in the next precision below the cell's: TF32 products for a float32 cell
(the program keeps TF32 off), float32 for a float64 cell.  One line of JSON
a seed.

``hmc``: the program's own warm-up (dual averaging of the step size, a
diagonal metric) from the cell's start points: the step size and inverse
mass an HMC mix fixes.

``pool``: a configuration's start pool ``pools/<config>.npy``, drawn from
its posterior by the float64 reference alone (no code of the program): a
Gaussian about the reference point with the inverse of the log-posterior's
negative Hessian there (central differences of the reference's gradient),
then ``burn`` steps of a plain stretch move, then ``snapshots`` copies of
the ensemble ``thin`` steps apart.  Prints the ensemble's moments at each
snapshot, so that a drift between them shows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, traffic  # noqa: E402


@contextlib.contextmanager
def control_precision(dtype):
    """The control's precision: for float32, TF32 products on the card, on
    the CPU their emulation (operands of every matmul rounded to TF32's
    10-bit mantissa); for float64 nothing (the control is then float32)."""
    if dtype != torch.float32:
        yield
        return
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with TF32Emulation() if not torch.cuda.is_available() else contextlib.nullcontext():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def round_tf32(x):
    """float32 → the nearest value with TF32's 10-bit mantissa (the
    gradient passes straight through)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


class TF32Emulation(torch.overrides.TorchFunctionMode):
    _MATMUL = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm,
               torch.bmm, torch.einsum, torch.tensordot}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._MATMUL:
            args = tuple(round_tf32(a) if isinstance(a, torch.Tensor) else
                         [round_tf32(b) for b in a] if isinstance(a, (list, tuple)) else a
                         for a in args)
        return func(*args, **kwargs)


def readings(args) -> None:
    cell = harness.Cell(args.workload, device=args.device)
    cell.build()
    ref = cell.reference(torch.float64)
    ctl = cell.reference(torch.float32)
    if args.witness:   # the program's float64 path against the float64 reference's own model
        from portbench import entries

        kind = entries.entry(cell.config)
        prog64 = kind[1](cell.config, cell.workdir, torch.float64, cell.device)
        ref64 = kind[2](cell.config, cell.workdir, cell.refcache, cell.device, torch.float64,
                        "by_dtype", cell.narrow)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell.start(seed)
        cell.window(args.seconds, False)
        sample = cell.sample(seed)
        cell.judge(sample, ref)
        with control_precision(cell.dtype):
            got = harness.reference_values(ctl, sample["x"], "grad" in sample,
                                           torch.float32, cell.device,
                                           cell.limits.get("chunk", 32))
        want = harness.reference_values(ref, sample["x"], "grad" in sample, torch.float64,
                                        cell.device, cell.limits.get("chunk", 32))
        program = harness.numbers(sample, want)
        control = harness.numbers(dict(sample, **got), want)
        control.pop("moved_share")
        i = harness.worst(sample["lp"], want["lp"])
        witness = None
        if args.witness:
            chunk = cell.limits.get("chunk", 32)
            grad = "grad" in sample
            mine = harness.reference_values(prog64, sample["x"], grad, torch.float64,
                                            cell.device, chunk)
            theirs = harness.reference_values(ref64, sample["x"], grad, torch.float64,
                                              cell.device, chunk)
            witness = dict(float64_program_gap=harness.logp_gap(mine["lp"], theirs["lp"]))
            if grad:
                witness["float64_program_grad_err"] = harness.grad_err(mine["grad"],
                                                                       theirs["grad"])
        if "grad" in sample:
            program["nonfinite_grads"] = int((~torch.isfinite(sample["grad"]).all(-1)).sum())
            program["reference_nonfinite_grads"] = int(
                (~torch.isfinite(want["grad"]).all(-1)).sum())
        print(json.dumps(dict(workload=cell.name, seed=seed, n=sample["n"], nan=sample["nan"],
                              program=program,
                              witness=witness,
                              worst=dict(logp_ref=float(want["lp"][i]), theta=sample["x"][i].tolist()),
                              control=control, seconds=time.perf_counter() - t0)), flush=True)


def hmc(args) -> None:
    from eftpipe_tpu_torch.parallel.hmc import HMC

    cell = harness.Cell(args.workload, device=args.device)
    cell.build()
    p = cell.program
    gen = torch.Generator(device=cell.device).manual_seed(args.seed)
    q0 = traffic.start_points(gen, np.load(cell.pool_file), args.chains, cell.dtype,
                              cell.device)
    h = HMC(logp=p.logp, ndim=len(p.theta0), n_leapfrog=cell.mix["n_leapfrog"])
    t0 = time.perf_counter()
    state, eps, inv_mass, acc = h.warmup(gen, q0, n_warmup=args.warmup, eps0=args.eps0)
    print(json.dumps(dict(workload=cell.name, chains=args.chains, warmup=args.warmup,
                          step_size=float(eps), inv_mass=inv_mass.double().cpu().tolist(),
                          accept=float(acc), seconds=time.perf_counter() - t0)), flush=True)


def _reference_logp(ref, chunk: int):
    def logp(x):
        with torch.no_grad():
            return torch.cat([ref.logp(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)])
    return logp


def _hessian(ref, theta0) -> torch.Tensor:
    """The log-posterior's Hessian at ``theta0`` by central differences of
    the reference's gradient, one batch of 2·d points."""
    d = theta0.numel()
    h = 1e-4 * theta0.abs().clamp(min=0.1)
    steps = torch.diag(h)
    x = torch.cat([theta0 + steps, theta0 - steps]).requires_grad_(True)
    (g,) = torch.autograd.grad(ref.logp(x).sum(), x)
    hess = (g[:d] - g[d:]) / (2.0 * h[:, None])
    return 0.5 * (hess + hess.T)


def stretch_pass(x, lp, logp, gen, a: float = 2.0):
    """One Goodman–Weare stretch step of the ensemble ``x`` (in place), each
    half moved against the other."""
    n, d = x.shape
    half = n // 2
    accepted = 0
    for lo, hi, olo, ohi in ((0, half, half, n), (half, n, 0, half)):
        m = hi - lo
        kw = dict(generator=gen, dtype=x.dtype, device=x.device)
        z = ((a - 1.0) * torch.rand(m, **kw) + 1.0) ** 2 / a
        j = torch.randint(olo, ohi, (m,), generator=gen, device=x.device)
        prop = x[j] + z[:, None] * (x[lo:hi] - x[j])
        lp_new = logp(prop)
        log_r = (d - 1) * torch.log(z) + lp_new - lp[lo:hi]
        acc = torch.log(torch.rand(m, **kw)) < log_r
        x[lo:hi] = torch.where(acc[:, None], prop, x[lo:hi])
        lp[lo:hi] = torch.where(acc, lp_new, lp[lo:hi])
        accepted += int(acc.sum())
    return accepted / n


def pool(args) -> None:
    from portbench import entries

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = {c["name"]: c for c in bench["configs"]}[args.config]
    cfile = harness.ROOT / spec["file"]
    config = json.loads(cfile.read_text())
    cache = Path(args.cache) if args.cache else harness.CACHE
    narrow = dict(nfft_loop=64, nkin=80) if args.narrow else {}
    workdir = cache / "work" / args.config
    entries.prepare_inputs(config, cfile.read_text(), workdir, cache / "reference", narrow)
    kind = entries.entry(config)
    device = torch.device(args.device)
    ref = kind[2](config, workdir, cache / "reference", device, torch.float64, "by_dtype",
                  narrow)
    logp = _reference_logp(ref, args.chunk)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    theta0 = torch.as_tensor(kind[3](config), dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    hess = _hessian(ref, theta0)
    evals, vecs = torch.linalg.eigh(-hess)
    print(json.dumps(dict(config=args.config, hessian_eigenvalues=evals.cpu().tolist())),
          flush=True)
    cov = vecs @ torch.diag(1.0 / evals.clamp(min=evals.max() * 1e-12)) @ vecs.T
    chol = torch.linalg.cholesky(0.5 * (cov + cov.T))
    x = torch.empty((args.walkers, theta0.numel()), dtype=torch.float64, device=device)
    lp = torch.full((args.walkers,), -math.inf, dtype=torch.float64, device=device)
    for _ in range(50):   # draws outside a prior are drawn again
        bad = ~torch.isfinite(lp)
        if not bad.any():
            break
        z = torch.randn((int(bad.sum()), theta0.numel()), generator=gen, dtype=torch.float64,
                        device=device)
        x[bad] = theta0 + z @ chol.T
        lp[bad] = logp(x[bad])
    snaps = []
    for step in range(1, args.burn + args.thin * (args.snapshots - 1) + 1):
        acc = stretch_pass(x, lp, logp, gen, args.a)
        if step % 25 == 0:
            print(json.dumps(dict(step=step, accept=acc, seconds=time.perf_counter() - t0,
                                  logp_mean=float(lp.mean()))), flush=True)
        if step >= args.burn and (step - args.burn) % args.thin == 0:
            snaps.append(x.clone())
            print(json.dumps(dict(step=step, accept=acc, seconds=time.perf_counter() - t0,
                                  logp_mean=float(lp.mean()), logp_max=float(lp.max()),
                                  mean=x.mean(0).cpu().tolist(),
                                  std=x.std(0).cpu().tolist())), flush=True)
    out = torch.cat(snaps).cpu().numpy()
    path = Path(args.out) if args.out else harness.HERE / "pools" / f"{args.config}.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, out)
    print(json.dumps(dict(config=args.config, pool=str(path), shape=list(out.shape),
                          seconds=time.perf_counter() - t0)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--seconds", type=float, default=4.0)
    r.add_argument("--device", default="cuda")
    r.add_argument("--witness", action="store_true",
                   help="also the program's float64 path at the same positions")
    h = sub.add_parser("hmc")
    h.add_argument("--workload", required=True)
    h.add_argument("--chains", type=int, default=512)
    h.add_argument("--warmup", type=int, default=150)
    h.add_argument("--eps0", type=float, default=0.01)
    h.add_argument("--seed", type=int, default=1)
    h.add_argument("--device", default="cuda")
    q = sub.add_parser("pool")
    q.add_argument("--config", required=True)
    q.add_argument("--walkers", type=int, default=2048)
    q.add_argument("--burn", type=int, default=100)
    q.add_argument("--thin", type=int, default=50)
    q.add_argument("--snapshots", type=int, default=2)
    q.add_argument("--a", type=float, default=2.0)
    q.add_argument("--chunk", type=int, default=256)
    q.add_argument("--seed", type=int, default=20261019)
    q.add_argument("--device", default="cuda")
    q.add_argument("--narrow", action="store_true", help="the tests' narrow loop widths")
    q.add_argument("--cache", default=None)
    q.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    {"readings": readings, "hmc": hmc, "pool": pool}[args.what](args)


if __name__ == "__main__":
    main()
