"""Value-and-gradient evaluations completed in the window (chains ×
gradients, the leapfrog steps and each block's start) over the window's
seconds."""


def read(rec):
    if rec["sampler"] != "hmc":
        return None
    return rec["work"] / rec["seconds"]
