"""The 90th percentile of the ensemble steps' times in the window, each
from CUDA events at its two boundaries (all steps of the window)."""

import numpy as np


def read(rec):
    if rec["sampler"] != "stretch" or not rec["step_ms"]:
        return None
    return float(np.percentile(rec["step_ms"], 90))
