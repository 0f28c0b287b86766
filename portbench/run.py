"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The program's kernel builds and every cache live at fixed paths
inside the checkout (``build/eftpipe_tpu_torch/``, ``portbench/.cache/``), so
only the first run of a cell in a checkout compiles.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
os.environ["EFTPIPE_TORCH_BUILD_DIR"] = str(ROOT / "build" / "eftpipe_tpu_torch")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
