"""The control comes out as not correct, and the roofline counts the
algorithm's work.

The control is the reference put in the program's place in the next
precision below the cell's: TF32 products for the float32 cells (emulated
here on the CPU by rounding every matmul's operands to TF32), float32 for the
float64 cell.  At the narrow test widths, on the positions a short sound run
of the cell's traffic produced, its gap to the float64 reference must break
the cell's limit while the program's does not.
"""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, harness, roofline
from portbench.tests.support import narrow_program, small_cell  # noqa: F401

CELLS = ["lrg-elg.stretch-w4096", "lrg-elg-x.stretch-w4096", "lrg-elg.hmc-c2048",
         "lrg-elg-x.stretch-w2048-f64"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_program_passes(name, narrow_program, tmp_path_factory):  # noqa: F811
    cell = small_cell(name, tmp_path_factory.mktemp("pb"))
    cell.build()
    cell.start(2**31 + 99)
    cell.window(1.0, False)
    sample = cell.sample(5)
    ref = cell.reference()
    program = cell.judge(sample, ref)
    assert all(harness.passes(c) for c in program.values()), program
    ctl = cell.reference(torch.float32)
    with calibrate.control_precision(cell.dtype):
        got = harness.reference_values(ctl, sample["x"], "grad" in sample, torch.float32, "cpu",
                                       16)
    control = dict(sample, lp=got["lp"], **({"grad": got["grad"]} if "grad" in got else {}))
    checks = {k: v for k, v in cell.judge(control, ref).items() if k != "moved_share"}
    assert not all(harness.passes(c) for c in checks.values()), checks


def test_roofline_count_by_hand():
    """W=1024, BL=114, S=80, N=255: the lower triangle once plus the
    reduction, and each input read once and the output written once."""
    flops = 1024 * 114 * 80 * 255 * 256 + 2 * 1024 * 114 * 255 * 80
    assert roofline.qf_real_flops(1024, 255, 80, 114) == flops == 614_404_915_200
    assert roofline.qf_real_bytes(1024, 255, 80, 114, "f32") == 4 * (
        114 * 255 * 255 + 1024 * 255 * 80 + 1024 * 114 * 80)
    assert roofline.qf_real_least_seconds(1024, 255, 80, 114, "f32") == pytest.approx(
        flops / 989e12)


def test_roofline_reads_the_unpadded_width():
    """The share takes N from the program's launch counter, which records the
    walkers' width, not the kernel layout's padded one (256 for float32 at
    N=255, a multiple of 64): padding changes no count."""
    from eftpipe_tpu_torch.ops import quadform as qf

    qf.reset_launch_counts()
    qf._count_launch("qf_real", torch.float32, 1024, 255, 80, 114)
    (key,) = qf.LAUNCHES_BY_SHAPE
    assert key == ("qf_real", "f32", 1024, 255, 80, 114)
    padded = qf.tril_fold(torch.zeros(114, 255, 255), 64)
    assert padded.shape[-1] == 256
    read = harness.load_reader("qf_real_roofline.f32")
    least = roofline.qf_real_least_seconds(1024, 255, 80, 114, "f32")
    rec = dict(profile=dict(qf_real=[dict(dtype="f32", w=1024, n=255, s=80, bl=114, count=1)],
                            qf_real_device_s=10 * least))
    assert read(rec) == pytest.approx(10.0)
    assert harness.load_reader("qf_real_roofline.f64")(rec) is None
    qf.reset_launch_counts()
