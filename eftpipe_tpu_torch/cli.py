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
plot-window, zeff, bench   not ported yet: each exits with a message naming
             its ROADMAP item

Both ported commands run on the card unless ``--device cpu`` is given, in
float64 (``Analysis.from_config``'s default).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_UNPORTED = {
    "plot-window": "the window QA plot is not ported yet (ROADMAP A7, with tools.py)",
    "zeff": "the effective-redshift pair count is not ported yet (ROADMAP A7: "
            "analysis/zeff.py with native/)",
    "bench": "the port has no benchmark yet (ROADMAP A9)",
}


def cmd_run(args) -> int:
    from .api.orchestrate import Analysis

    an = Analysis.from_config(args.config, device=args.device)
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
    from .api.orchestrate import Analysis
    from .analysis import ChainProducts, BestfitModel

    an = Analysis.from_config(args.config, device=args.device)
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


def cmd_unported(args) -> int:
    print(f"eftpipe_tpu_torch {args.command}: {_UNPORTED[args.command]}", file=sys.stderr)
    return 2


def _add_device(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")


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
    _add_device(p)
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("bestfit", help="bestfit theory from a finished run")
    p.add_argument("config")
    p.add_argument("--chains", required=True)
    p.add_argument("--tracer", action="append")
    p.add_argument("--burn-in", type=float, default=0.3)
    p.add_argument("-o", "--output")
    p.add_argument("--plot")
    _add_device(p)
    p.set_defaults(func=cmd_bestfit)

    for name in _UNPORTED:
        p = sub.add_parser(name, help=f"not ported: {_UNPORTED[name]}")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(func=cmd_unported)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
