"""Matmul precision of the port (counterpart of ``eftpipe_tpu/ops/precision.py``).

The JAX package raises selected pipeline stages to a higher matmul precision
because its accelerator's default float32 product is a reduced-precision
multi-pass one.  The port has no such per-stage choice to make: every
float32 matmul runs in IEEE float32 (``torch.backends.cuda.matmul.allow_tf32
= False`` and ``torch.backends.cudnn.allow_tf32 = False``, set when the
package is imported), and the hand-written quadratic-form kernels use plain
float32 FMA with float32 accumulation.  Whether TF32 fits the |dlogp| < 0.02
budget on some stage is a measurement for a later change.

``stage_precision`` is kept so the pipeline reads like its JAX counterpart
and so that a later per-stage TF32 switch has one place to live.
"""

from __future__ import annotations

from contextlib import nullcontext


def stage_precision(name: str):
    """No-op context around the stage ``name`` ("nonlinear", "IRresum",
    "APeffect", "window", "fiber", "binning", "like", "emu"): all stages run
    IEEE float32 (or float64) products."""
    return nullcontext()
