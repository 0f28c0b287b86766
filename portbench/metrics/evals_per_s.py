"""Posterior evaluations completed in the window (walkers × logp calls)
over the window's seconds: all the work and all the time of the window."""


def read(rec):
    if rec["sampler"] != "stretch":
        return None
    return rec["work"] / rec["seconds"]
