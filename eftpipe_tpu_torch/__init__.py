"""eftpipe_tpu_torch — the PyTorch/CUDA port of ``eftpipe_tpu``.

Same sub-package layout as the JAX package (``ops/ tables/ models/
likelihood/ boltzmann/ api/ parallel/``) plus ``csrc/`` for the hand-written
CUDA kernels.  The port imports ``torch``, ``numpy`` and ``scipy`` only; it
never imports ``jax`` nor anything of ``eftpipe_tpu`` (its pure-NumPy
Phase-A modules are copied here).

Conventions of the port:

* every per-evaluation function takes a leading walker axis ``W`` written
  out (the JAX package is single-evaluation + ``vmap``);
* Phase-A table construction runs on the host in NumPy (complex128 /
  float64) and the tables are moved to the device once, at build, by
  :func:`to_device`;
* the JAX package's ambient ``EFTPIPE_TPU_*`` switches are keyword arguments
  of the ``build_*`` functions here;
* float32 matmuls run in IEEE float32: TF32 is switched off below, on
  import, for matmuls and cuDNN alike (see ``ops/precision.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__version__ = "0.1.0"

_LAZY = {
    "EnsembleSampler": "eftpipe_tpu_torch.parallel.sampler",
    "MCMCDriver": "eftpipe_tpu_torch.parallel.mcmc",
    "HMC": "eftpipe_tpu_torch.parallel.hmc",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# IEEE float32 products everywhere; the accuracy budget of the float32 path
# (|dlogp| < 0.02 against float64) is stated for this setting.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """Entry points default to the card and raise when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "eftpipe_tpu_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


def to_device(obj, device, dtype):
    """Move a Phase-A table tree to ``device``: floating NumPy arrays become
    tensors of ``dtype``; dicts, tuples, lists and dataclasses are walked;
    everything else (ints, flags, integer index arrays, None) is kept."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind == "f":
            return torch.as_tensor(obj, dtype=dtype, device=device)
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device=device, dtype=dtype if obj.is_floating_point() else None)
    if isinstance(obj, dict):
        return {k: to_device(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device, dtype) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj)})
    return obj
