"""The frozen reference against the program's plain CPU path, float64, at
the narrow loop widths: the same log-posterior and gradient on both
configurations."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.support import float64_program, narrow_program, small_cell  # noqa: F401


@pytest.mark.parametrize("name", ["lrg-elg.stretch-w4096", "lrg-elg-x.stretch-w4096"])
def test_reference_matches_program(name, narrow_program, tmp_path_factory):  # noqa: F811
    cell = small_cell(name, tmp_path_factory.mktemp("pb"))
    program = float64_program(cell)
    cell.dtype = torch.float64      # the reference on the float64 program's quadrature
    ref = cell.reference()
    rng = np.random.default_rng(3)
    th0 = program.theta0
    x = torch.as_tensor(th0[None] * (1 + 1e-2 * rng.standard_normal((6, th0.size))))
    xp = x.clone().requires_grad_(True)
    lp = program.logp(xp)
    (g,) = torch.autograd.grad(lp.sum(), xp)
    want = harness.reference_values(ref, x, True, torch.float64, "cpu", 3)
    assert torch.isfinite(lp).all()
    torch.testing.assert_close(lp.detach(), want["lp"], rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(g, want["grad"], rtol=1e-8, atol=1e-8)
