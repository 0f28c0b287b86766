"""Command-line interface of the port (counterpart of
``eftpipe_tpu/cli.py``).

Usage: ``python -m eftpipe_tpu_torch <command> ...``

Commands
--------
run          build an Analysis from a config (JSON, or YAML with PyYAML) and
             run ensemble MCMC (checkpoint/resume, R−1 stopping,
             getdist-style chain output); last line of output is JSON
bestfit      evaluate/plot the bestfit theory of a finished run
             (upstream script/mkbestfit.py:1-179)
plot-window  survey-window QA plot (host NumPy; needs matplotlib)
zeff         effective redshift of a random catalogue (host: the native
             pair sums, or NumPy); prints one JSON line
bench        not ported yet: exits 2 with a message naming the benchmark's
             ROADMAP item

``run`` and ``bestfit`` build their analysis on the card unless ``--device
cpu`` is given, in float32 as the JAX CLI does (``--dtype float64`` is the
counterpart of its x64 switch, for parity runs), with the quadratic forms'
route of ``--quadform`` (``kernel``, the default; ``plain``; ``lowrank``, the
counterpart of ``EFTPIPE_TPU_LOWRANK``, with ``--lowrank-tol`` and
``--no-cf-premix``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_UNPORTED = {
    "bench": "the port has no benchmark yet (ROADMAP: the benchmark PR)",
}


def _analysis(args):
    import torch

    from .api.orchestrate import Analysis

    return Analysis.from_config(
        args.config, dtype=getattr(torch, args.dtype), device=args.device,
        quadform=args.quadform, lowrank_tol=args.lowrank_tol, cf_premix=args.cf_premix)


def cmd_run(args) -> int:
    an = _analysis(args)
    print(f"sampled params ({an.space.ndim}): {an.space.sampled}")
    res = an.run_mcmc(
        nwalkers=args.walkers, out=args.out, rhat_tol=args.rhat,
        max_steps=args.max_steps, block=args.block, key=args.key,
    )
    print(json.dumps({
        "steps": int(res.chain.shape[0]), "walkers": int(res.chain.shape[1]),
        "converged": bool(res.converged), "accept_rate": round(res.accept_rate, 3),
        "max_rminus1": float(np.max(res.rminus1)),
        "tau": None if res.tau is None else [round(float(t), 1) for t in res.tau],
    }))
    return 0


def cmd_bestfit(args) -> int:
    from .analysis import ChainProducts, BestfitModel

    an = _analysis(args)
    cp = ChainProducts.from_prefix(args.chains, burn_in=args.burn_in)
    bf = BestfitModel.from_chains(an, cp)
    print("bestfit point:", {p: round(float(v), 5) for p, v in bf.params.items()})
    print("chi2:", {k: round(v, 3) for k, v in bf.chi2().items()})
    tracers = args.tracer or list(an.pipelines)
    for tracer in tracers:
        mp = bf.multipoles(tracer)
        out = args.output or f"bestfit_{tracer}.txt"
        cols = [mp.k] + [mp(ell) for ell in mp.ells]
        np.savetxt(out, np.column_stack(cols),
                   header="k " + " ".join(f"P{l}" for l in mp.ells))
        print(f"{tracer}: multipoles written to {out}")
        if args.plot:
            import matplotlib

            matplotlib.use("Agg")
            ax = mp.plot()
            fig = ax.get_figure()
            png = args.plot if len(tracers) == 1 else f"{tracer}_{args.plot}"
            fig.savefig(png, dpi=150, bbox_inches="tight")
            print(f"{tracer}: plot written to {png}")
    return 0


def cmd_plot_window(args) -> int:
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit("eftpipe_tpu_torch plot-window: needs matplotlib, which is not "
                         "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from .models.config import EFTConfig
    from .models.window import build_window_tables

    cfg = EFTConfig(nl=args.nl, no=args.nl)
    wt = build_window_tables(cfg, window_configspace_file=args.mask, nmax=args.nmax)
    fig, axes = plt.subplots(1, cfg.nl, figsize=(5 * cfg.nl, 4), squeeze=False)
    mat = np.asarray(wt["wmat"])  # (na, nl, nk, p)
    for l in range(cfg.nl):
        ax = axes[0][l]
        im = ax.imshow(mat[:, l].reshape(-1, mat.shape[-1]), aspect="auto", cmap="RdBu_r")
        fig.colorbar(im, ax=ax)
        ax.set_title(f"W(a, k; p), l={2 * l}")
        ax.set_xlabel("p index")
        ax.set_ylabel("(a, k) index")
    fig.savefig(args.output, dpi=150, bbox_inches="tight")
    print(f"window QA plot written to {args.output}")
    return 0


def cmd_zeff(args) -> int:
    from .analysis.zeff import effective_redshift

    table = np.loadtxt(args.randoms)
    ra, dec, z = table[:, 0], table[:, 1], table[:, 2]
    w = table[:, 3] if table.shape[1] > 3 and not args.unit_weights else None
    if args.subsample and table.shape[0] > args.subsample:
        rng = np.random.default_rng(0)
        idx = rng.choice(table.shape[0], args.subsample, replace=False)
        ra, dec, z = ra[idx], dec[idx], z[idx]
        w = w[idx] if w is not None else None
    zeff = effective_redshift(ra, dec, z, weight=w, omegam=args.omegam,
                              smin=args.smin, smax=args.smax)
    print(json.dumps({"zeff": round(float(zeff), 6), "npoints": int(z.size)}))
    return 0


def cmd_unported(args) -> int:
    print(f"eftpipe_tpu_torch {args.command}: {_UNPORTED[args.command]}", file=sys.stderr)
    return 2


def _add_build(p) -> None:
    from .models.nonlinear import LOWRANK_TOL, QUADFORMS

    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="evaluation dtype (default float32, as the JAX CLI)")
    p.add_argument("--quadform", choices=QUADFORMS, default="kernel",
                   help="route of the loop's quadratic forms (default: kernel)")
    p.add_argument("--lowrank-tol", type=float, default=LOWRANK_TOL,
                   help="spectral cut of the lowrank route's factors")
    p.add_argument("--no-cf-premix", dest="cf_premix", action="store_false",
                   help="lowrank route: per-structure CF factors, not premixed ones")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="eftpipe_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="run ensemble MCMC from a config")
    p.add_argument("config")
    p.add_argument("--walkers", type=int, default=256)
    p.add_argument("--max-steps", type=int, default=10_000)
    p.add_argument("--block", type=int, default=100)
    p.add_argument("--rhat", type=float, default=0.01)
    p.add_argument("--out", default="chains/run")
    p.add_argument("--key", type=int, default=0)
    _add_build(p)
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("bestfit", help="bestfit theory from a finished run")
    p.add_argument("config")
    p.add_argument("--chains", required=True)
    p.add_argument("--tracer", action="append")
    p.add_argument("--burn-in", type=float, default=0.3)
    p.add_argument("-o", "--output")
    p.add_argument("--plot")
    _add_build(p)
    p.set_defaults(func=cmd_bestfit)

    p = sub.add_parser("plot-window", help="survey window QA plot")
    p.add_argument("mask", help="config-space mask multipole file Q_q(s)")
    p.add_argument("-o", "--output", default="window.png")
    p.add_argument("--nl", type=int, default=2)
    p.add_argument("--nmax", type=int, default=1024)
    p.set_defaults(func=cmd_plot_window)

    p = sub.add_parser("zeff", help="effective redshift from randoms")
    p.add_argument("randoms", help="text table: RA DEC z [weight]")
    p.add_argument("--omegam", type=float, default=0.31)
    p.add_argument("--smin", type=float, default=25.0)
    p.add_argument("--smax", type=float, default=150.0)
    p.add_argument("--subsample", type=int, default=0)
    p.add_argument("--unit-weights", action="store_true")
    p.set_defaults(func=cmd_zeff)

    for name in _UNPORTED:
        p = sub.add_parser(name, help=f"not ported: {_UNPORTED[name]}")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(func=cmd_unported)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
