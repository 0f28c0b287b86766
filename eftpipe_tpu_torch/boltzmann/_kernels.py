"""Loader, checks and launch counters of the solver's CUDA kernels
(``csrc/boltzmann.cu``: ``recomb_scan`` and ``eb_solve``, their tangent
kernels ``recomb_scan_jvp`` and ``eb_solve_jvp``, and their second-order
kernels ``recomb_scan_jvp2`` and ``eb_solve_jvp2``).

The library is built by :mod:`eftpipe_tpu_torch.ops._build` at the first
launch, never at import.  Each C function takes its tensors' pointers, then
its ints, then its doubles, then the stream, enqueues its kernels (the
recurrence: a pre-pass and the chain, with a scratch tensor the wrapper
allocates) and returns the first CUDA error; a non-zero code raises here.
``LAUNCHES`` counts the launches of each kernel (one a wrapper call) since
the last :func:`reset_launch_counts`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import _build

LAUNCHES = {"eb_solve": 0, "recomb_scan": 0, "eb_solve_jvp": 0, "recomb_scan_jvp": 0,
            "eb_solve_jvp2": 0, "recomb_scan_jvp2": 0}
_FUNCS: dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str, nptr: int, nint: int, ndbl: int):
    if name not in _FUNCS:
        lib = _build.load("boltzmann")
        fn = getattr(lib, f"eft_{name}")
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_double] * ndbl + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.eft_boltzmann_error_string.argtypes = [ctypes.c_int]
        lib.eft_boltzmann_error_string.restype = ctypes.c_char_p
        _FUNCS[name] = (lib, fn)
    return _FUNCS[name]


def recomb_work(parts: int, nw: int, n: int, device) -> torch.Tensor:
    """The scratch of one launch of the recurrence (``recomb_scan``: ``parts``
    0, ``recomb_scan_jvp``: 1, ``recomb_scan_jvp2``: 3): the pre-pass's
    records, sized by the library (``eft_recomb_work_bytes``)."""
    if "recomb_work_bytes" not in _FUNCS:
        lib = _build.load("boltzmann")
        lib.eft_recomb_work_bytes.argtypes = [ctypes.c_int] * 3
        lib.eft_recomb_work_bytes.restype = ctypes.c_size_t
        _FUNCS["recomb_work_bytes"] = lib.eft_recomb_work_bytes
    return torch.empty(int(_FUNCS["recomb_work_bytes"](parts, nw, n)), dtype=torch.uint8,
                       device=device)


def check(name, t, shape, like) -> None:
    """``t`` must be a contiguous float64 tensor of ``shape`` on ``like``'s
    device."""
    if not isinstance(t, torch.Tensor) or t.device != like.device:
        raise ValueError(f"{name} must be a tensor on {like.device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def no_backward(kernel: str) -> NotImplementedError:
    """The error of a reverse-mode pass through a kernel: each has a tangent
    kernel (forward mode) and no backward of its own."""
    return NotImplementedError(
        f"{kernel}: no reverse mode through the CUDA kernel, only forward mode (its "
        f"tangent kernel); take the gradient through EBSolver, whose backward contracts "
        f"the solve's tangents in the differentiated parameters")


def launch(kernel: str, device, *tensors, ints=(), doubles=()) -> None:
    """Enqueue one launch of ``eft_<kernel>`` on the current stream of
    ``device``; raises on a CUDA error, counts the launch otherwise."""
    with torch.cuda.device(device):
        lib, fn = _fn(kernel, len(tensors), len(ints), len(doubles))
        code = fn(*(t.data_ptr() for t in tensors), *ints, *doubles,
                  torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.eft_boltzmann_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code}: {msg}")
    LAUNCHES[kernel] += 1
