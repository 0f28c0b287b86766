"""Synchronising operations of one HMC transition (torch's sync debug
mode)."""


def read(rec):
    return rec["syncs_per_step"] if rec["sampler"] == "hmc" else None
