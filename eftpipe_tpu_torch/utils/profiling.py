"""Profiling helpers (counterpart of ``eftpipe_tpu/utils/profiling.py``):
a ``torch.profiler`` trace, a host stage timer, and the stage-prefix
functions that time the likelihood stage by stage.

``likelihood_stage_prefixes`` builds, for each active stage of the
pipelines (``cosmo``, ``nonlinear``, ``IRresum``, ``APeffect``, ``window``,
``window_matrix``, ``fiber``, ``png_pg``, ``logp``), a function of a walker
batch that runs everything up to and including that stage
(``TracerPipeline.compute_bird(stop_after=...)``) and reduces each walker's
products to one number; ``run_stage_profile`` times the prefixes and
differences them.  On the card the times come from CUDA events.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir="profile", host: bool = False):
    """``torch.profiler`` over the block (the card's kernels too when there
    is one), written to ``log_dir/trace.json`` (Chrome/Perfetto format);
    yields the profiler (``key_averages()`` for sums by kernel).  ``host`` is
    kept for the JAX signature."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


@contextlib.contextmanager
def stage_timer(collect: dict, name: str):
    """Accumulate wall time per stage into ``collect`` (host clock; wrap
    work that ends in a synchronisation to time the card)."""
    t0 = time.perf_counter()
    yield
    collect[name] = collect.get(name, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# stage-prefix profiling
# ---------------------------------------------------------------------------
PIPE_STAGES = ("nonlinear", "IRresum", "APeffect", "window", "window_matrix",
               "fiber")
_BIRD_FIELDS = ("p11l", "ploopl", "pctl", "pstl", "c11", "cct", "cloopl")


def _wmean(x):
    """Per-walker mean over every axis but the first."""
    return x.reshape(x.shape[0], -1).mean(-1)


def likelihood_stage_prefixes(providers, likes, params_dict, dtype):
    """Ordered {stage: thetas (W, ndim) → (W,)} prefix functions over a full
    theory + likelihood graph.

    Each prefix evaluates the pipelines up to and including the named stage
    and reduces every product to one checksum per walker.  Timing prefix k
    and k−1 on the same batch and differencing gives the stage's cost.

    providers: {tracer: provider}; likes: {name: EFTLikelihood};
    params_dict: thetas → the full parameter dict of (W,) tensors.
    """
    from ..models.pipeline import CosmoInputs

    runtimes = {}
    for lk in likes.values():
        runtimes.update({t: rt.spec.pipeline for t, rt in lk.runtimes.items()})
    active = ["cosmo"]
    attrs = {"nonlinear": "nt", "IRresum": "rt", "APeffect": "at",
             "window": "wt", "window_matrix": "wmt", "fiber": "ft"}
    for stage in PIPE_STAGES:
        if any(getattr(p, attrs[stage], None) is not None for p in runtimes.values()):
            active.append(stage)
    active += ["png_pg", "logp"]

    def _cast(ci):
        return CosmoInputs(plin=ci.plin.to(dtype), f=ci.f.to(dtype),
                           qperp=torch.as_tensor(ci.qperp).to(dtype),
                           qpar=torch.as_tensor(ci.qpar).to(dtype))

    def make(stage):
        def fn(thetas):
            params = params_dict(thetas)
            inputs = {t: _cast(p.inputs(params)) for t, p in providers.items()}
            acc = 0.0
            for ci in inputs.values():
                acc = acc + _wmean(ci.plin) + ci.f + ci.qperp + ci.qpar
            if stage == "cosmo":
                return acc
            if stage in PIPE_STAGES:
                for t, pipe in runtimes.items():
                    bird = pipe.compute_bird(inputs[t], stop_after=stage)
                    for name in _BIRD_FIELDS:
                        value = getattr(bird, name, None)
                        if value is not None:
                            acc = acc + _wmean(value)
                return acc
            for lk in likes.values():
                sub = {t: inputs[t] for t in lk.runtimes}
                if stage == "png_pg":
                    png, pg = lk.png_and_pg(sub, params)
                    acc = acc + _wmean(png)
                    if pg is not None:
                        acc = acc + _wmean(pg)
                else:
                    acc = acc + lk.logp(sub, params)["logp"]
            return acc
        return fn

    return {stage: make(stage) for stage in active}


def time_batches(fn, batches) -> float:
    """Seconds of ``fn`` over ``batches`` (one call each) after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    fn(batches[0])
    if batches[0].is_cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches:
            fn(b)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    for b in batches:
        fn(b)
    return time.perf_counter() - t0


def run_stage_profile(prefix_fns, make_batches, run_timed=None, batch: int = 1,
                      iters: int = 1) -> dict:
    """Time each prefix on ``make_batches()`` (``iters`` batches of ``batch``
    walkers; ``run_timed(fn, batches)`` → seconds, default
    :func:`time_batches`) and return the per-stage µs/eval deltas plus the
    cumulative prefix times."""
    run_timed = run_timed or time_batches
    cum = {}
    with torch.no_grad():
        for stage, fn in prefix_fns.items():
            cum[stage] = run_timed(fn, make_batches()) / (batch * iters)
    out, prev = {}, 0.0
    for stage, t in cum.items():
        out[stage] = round((t - prev) * 1e6, 2)  # µs/eval
        prev = t
    return {
        "stage_us_per_eval": out,
        "prefix_us_per_eval": {s: round(t * 1e6, 2) for s, t in cum.items()},
    }
