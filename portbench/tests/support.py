"""Shared pieces of the benchmark's CPU tests: the program and the
reference narrowed alike (``nfft_loop=64``, ``nkin=80``), and a cell driven
on the CPU at a test size."""

from __future__ import annotations

import functools
import time

import pytest
import torch

from portbench import harness

NARROW = dict(nfft_loop=64, nkin=80)
# a test-sized mix: few walkers or chains from the configuration's start
# pool, and blocks long enough that most of them move in a short window
SMALL = dict(walkers=16, chains=8, block=4)


@pytest.fixture(scope="module")
def narrow_program():
    """The program's builders with the narrow loop widths."""
    import eftpipe_tpu_torch.api.flagship as pf
    import eftpipe_tpu_torch.api.orchestrate as po
    import eftpipe_tpu_torch.models.config as mc

    mp = pytest.MonkeyPatch()
    narrow = functools.partial(mc.EFTConfig, **NARROW)
    mp.setattr(pf, "EFTConfig", narrow)
    mp.setattr(po, "EFTConfig", narrow)
    yield
    mp.undo()


def small_cell(name: str, cache, **kw) -> harness.Cell:
    cell = harness.Cell(name, device="cpu", narrow=NARROW, cache=cache, **kw)
    cell.mix = dict(cell.mix, **SMALL)
    return cell


def run(cell: harness.Cell, seed: int = 2**31 + 7, seconds: float = 1.5) -> dict:
    """A run of ``cell`` past its look for a device (``harness.execute``)."""
    return harness.execute(cell, seed, seconds, False, time.perf_counter())


def float64_program(cell: harness.Cell):
    from portbench import entries

    entries.prepare_inputs(cell.config, cell.config_text, cell.workdir, cell.refcache,
                           cell.narrow)
    return entries.entry(cell.config)[1](cell.config, cell.workdir, torch.float64, "cpu")
