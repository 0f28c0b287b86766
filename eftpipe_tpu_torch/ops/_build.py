"""Build and load the CUDA sources under ``csrc/``.

Each ``*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` — seconds per
file, against minutes for a source that includes PyTorch's headers.  The
build happens at first use, never at import, into ``build/eftpipe_tpu_torch/``
beside the package (override: ``EFTPIPE_TORCH_BUILD_DIR``), keyed by a hash of
the source and the flags, so an unchanged source is compiled once.  All stale
sources are compiled together, one ``nvcc`` process each.  A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # name -> {"seconds", "cached", "ptxas", "path"}


def build_dir() -> Path:
    env = os.environ.get("EFTPIPE_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "eftpipe_tpu_torch"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "eftpipe_tpu_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every stale source (all of ``csrc/*.cu`` by default), the
    ``nvcc`` processes started together; returns name -> library path."""
    names = list(names) if names is not None else sorted(p.stem for p in CSRC.glob("*.cu"))
    out, procs = {}, []
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            BUILD_LOG.setdefault(name, dict(seconds=0.0, cached=True, ptxas="", path=str(target)))
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        BUILD_LOG[name] = dict(seconds=time.perf_counter() - t0, cached=False,
                               ptxas=log, path=str(target))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]
