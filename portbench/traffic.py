"""The one traffic generator: a mix file (``traffic/<mix>.json``) names the
sampler and its numbers, and this module drives the program's own sampler
with them.

Every sampler starts from the configuration's start pool
(``pools/<config>.npy``): positions drawn from its posterior by a seeded
burn-in of the float64 reference (``calibrate.py pool``), so that the chains
are stationary from their first step and the window's cost and accuracy do
not drift with how far they got.  The seed picks and orders the start
positions (every seed the same pool, in another order), and the chains go
on from there for the whole window.

``stretch``: ``EnsembleSampler.run`` (the Goodman–Weare stretch move) over
``walkers`` walkers, in blocks of ``block`` steps as the program's MCMC
driver runs them (each block starts by evaluating its walkers again); every
half-step is one ``logp`` of ``walkers``/2.

``hmc``: ``HMC.run`` over ``chains`` chains, with the fixed ``step_size``
and diagonal ``inv_mass`` of the mix (no adaptation inside a run),
``n_leapfrog`` the upper end of the randomised trajectory length, in blocks
of ``block`` transitions (each block evaluates its start again, as the
driver does).

Every draw comes from one ``torch.Generator`` seeded with ``--seed``.  Each
call into the program's ``logp`` (and, for HMC, each value and gradient) is
recorded as it was produced: its positions and outputs stay on the device
until the window has closed, and the comparison draws its sample from them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass(eq=False)
class Record:
    """What the timed path produced: per call, the positions and the
    program's outputs (device tensors, no copy)."""

    calls: list = field(default_factory=list)
    on: bool = True

    def add(self, *tensors):
        if self.on:
            self.calls.append(tuple(t.detach() for t in tensors))


@dataclass(eq=False)
class Window:
    work: int = 0                 # posterior evaluations (stretch) or gradients (hmc)
    seconds: float = 0.0
    steps: int = 0
    step_ms: list = field(default_factory=list)   # traced runs: CUDA-event step times
    start: torch.Tensor | None = None   # the chains' positions when the window opened
    end: torch.Tensor | None = None


def start_points(gen: torch.Generator, pool: np.ndarray, n: int, dtype, device):
    """``n`` positions of the start pool, picked and ordered by ``gen``."""
    if n > pool.shape[0]:
        raise SystemExit(f"portbench: the mix asks for {n} chains; the start pool holds "
                         f"{pool.shape[0]}")
    idx = torch.randperm(pool.shape[0], generator=gen, device=device)[:n]
    return torch.as_tensor(pool, dtype=torch.float64, device=device)[idx].to(dtype)


class _Events:
    """CUDA events at step boundaries, read once the window has closed."""

    def __init__(self, on: bool):
        self.on = on and torch.cuda.is_available()
        self.blocks: list = []

    def open(self):
        if self.on:
            self.blocks.append([])

    def mark(self):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.blocks[-1].append(ev)

    def step_ms(self) -> list:
        """Times between consecutive boundaries of each block (a block's
        last boundary closes its last step)."""
        return [a.elapsed_time(b) for marks in self.blocks for a, b in zip(marks, marks[1:])]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Stretch:
    def __init__(self, mix: dict, program, pool, gen: torch.Generator, device, record: Record):
        from eftpipe_tpu_torch.parallel.sampler import EnsembleSampler

        self.mix, self.gen, self.device, self.record = mix, gen, device, record
        self.dtype = DTYPES[mix["dtype"]]
        self.program = program
        nw = mix["walkers"]
        self.half = nw // 2

        def logp(thetas, chunk=None):
            out = program.logp(thetas, chunk=chunk)
            record.add(thetas, out)
            return out

        self.sampler = EnsembleSampler(logp=logp, nwalkers=nw, ndim=len(program.theta0),
                                       a=mix["a"], chunk_size=self.half)
        self.walkers = start_points(gen, pool, nw, self.dtype, device)

    def block(self, nsteps: int):
        chain, _, _ = self.sampler.run(self.gen, self.walkers, nsteps)
        self.walkers = chain[-1]
        return self.sampler.nwalkers * (2 * nsteps + 2) // 2   # the start, then two halves a step

    def warm(self):
        """One block of one step: every shape and call the window makes."""
        with_record, self.record.on = self.record.on, False
        self.block(1)
        self.record.on = with_record

    def one_step(self):
        """One ensemble update, as ``run`` makes it (for the traced probes)."""
        from eftpipe_tpu_torch.parallel.sampler import stretch_step

        lps = self.program.logp(self.walkers, chunk=self.half)
        return lambda: stretch_step(self.gen, self.sampler._logp_batched, self.walkers, lps,
                                    self.mix["a"])

    def probe_batch(self):
        return self.walkers[: self.half]


class Hmc:
    def __init__(self, mix: dict, program, pool, gen: torch.Generator, device, record: Record):
        from eftpipe_tpu_torch.parallel.hmc import HMC

        self.mix, self.gen, self.device, self.record = mix, gen, device, record
        self.dtype = DTYPES[mix["dtype"]]
        self.program = program
        ndim = len(program.theta0)

        class RecordingHMC(HMC):
            def _lpg(self, q):
                v, g = super()._lpg(q)
                record.add(q, v, g)
                return v, g

        self.hmc = RecordingHMC(logp=program.logp, ndim=ndim, n_leapfrog=mix["n_leapfrog"])
        self.q = start_points(gen, pool, mix["chains"], self.dtype, device)
        self.eps = torch.as_tensor(mix["step_size"], dtype=self.dtype, device=device)
        self.inv_mass = torch.as_tensor(mix["inv_mass"], dtype=self.dtype, device=device)

    def block(self, nsteps: int):
        from eftpipe_tpu_torch.parallel.hmc import HMCState

        lengths = self.hmc.lengths(self.gen, nsteps)   # what run draws: read, not advanced
        lp, grad = self.hmc._lpg(self.q)
        chain, _, _ = self.hmc.run(self.gen, HMCState(q=self.q, logp=lp, grad=grad), self.eps,
                                   self.inv_mass, nsteps)
        self.q = chain[-1]
        return self.mix["chains"] * (1 + int(np.sum(lengths)))

    def warm(self):
        with_record, self.record.on = self.record.on, False
        self.block(1)
        self.record.on = with_record

    def one_step(self):
        """One transition of the window's kind (for the traced probes)."""
        from eftpipe_tpu_torch.parallel.hmc import HMCState, _mass_ops

        lp, grad = self.hmc._lpg(self.q)
        state = HMCState(q=self.q, logp=lp, grad=grad)
        n = int(self.hmc.lengths(self.gen, 1)[0])
        ops = _mass_ops(self.inv_mass)
        return lambda: self.hmc._transition(self.gen, state, self.eps, ops, n)

    def probe_batch(self):
        return self.q


SAMPLERS = {"stretch": Stretch, "hmc": Hmc}


def driver(mix: dict, program, pool, gen, device, record: Record):
    try:
        cls = SAMPLERS[mix["sampler"]]
    except KeyError:
        raise SystemExit(f"portbench: unknown sampler {mix.get('sampler')!r}; "
                         f"known: {sorted(SAMPLERS)}") from None
    return cls(mix, program, pool, gen, device, record)


def run_window(drv, seconds: float, block: int, step_events: bool) -> Window:
    """Blocks of ``block`` steps until ``seconds`` have passed, one block
    in flight behind the one being enqueued so that the device never waits
    for the host's check of the clock; all the work and all the time of the
    window count."""
    win = Window(start=_position(drv))
    events = _Events(step_events)
    device = drv.device
    is_cuda = torch.device(device).type == "cuda"
    if step_events:
        _wrap_step_marks(drv, events)
    _sync(device)
    t0 = time.perf_counter()
    prev = None
    while True:
        events.open()
        win.work += drv.block(block)
        win.steps += block
        events.mark()
        done = torch.cuda.Event() if is_cuda else None
        if done is not None:
            done.record()
        if prev is not None:
            prev.synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
        prev = done
    _sync(device)
    win.seconds = time.perf_counter() - t0
    win.end = _position(drv)
    win.step_ms = events.step_ms() if step_events else []
    return win


def _position(drv):
    return drv.walkers if isinstance(drv, Stretch) else drv.q


def _wrap_step_marks(drv, events: _Events):
    """Mark each step's start: a stretch step is two calls of ``logp``
    after the block's first (its start's evaluation); an HMC transition
    starts at the first value and gradient of its trajectory."""
    count = {"n": 0}
    if isinstance(drv, Stretch):
        inner = drv.sampler.logp

        def logp(thetas, chunk=None):
            if count["n"] % 2 == 1:
                events.mark()
            count["n"] += 1
            return inner(thetas, chunk=chunk)

        drv.sampler.logp = logp
    orig_block = drv.block

    def block(nsteps):
        count["n"] = 0
        return orig_block(nsteps)

    drv.block = block
