"""A frozen plain float64 copy of the EFT-of-LSS pipeline, the benchmark's
reference.

It imports torch, numpy and scipy only: nothing of the program under test
(the port) and nothing of the JAX package.  Its modules keep the port's
layout (``ops/ tables/ models/ likelihood/ boltzmann/``) so that a reader can
hold each against its counterpart, but every quadratic form here is the
plain two-einsum version, and every table is worked out again from the
source numbers (cached under the benchmark's own ``.cache/``) but two: the
IR-resummation Q coefficients (``tables/data/qcoef_nir8.npz``,
``qcoef_nir16.npz``) are byte copies of the tables the program ships, since
the upstream expressions they were fitted from are not in the repository,
so a fault in those tables is shared by both sides and the comparison
cannot see it.  The cosmology is evaluated from the shipped emulator
artifact, which is input data.
``flagship.py`` and ``analysis.py`` assemble the two benchmark
configurations from these pieces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The reference runs where it is told; the CPU by default."""
    return torch.device("cpu" if device is None else device)


def to_device(obj, device, dtype):
    """Move a table tree to ``device``: floating NumPy arrays become tensors
    of ``dtype``; dicts, tuples, lists and dataclasses are walked; everything
    else (ints, flags, integer index arrays, None) is kept."""
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
