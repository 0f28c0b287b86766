"""Atomic cache writes.

The reference guards cache writes with MPI rank-0 decorators
(upstream eftpipe/window.py:361, icc.py:461); in the single-controller
port the remaining hazard is concurrent processes sharing a cache
directory, handled by write-to-temp + atomic rename.
"""

from __future__ import annotations

import os
import tempfile
import numpy as np
from pathlib import Path


def atomic_save_npz(path, **arrays) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
