"""Synchronising operations of one ensemble step (torch's sync debug
mode)."""


def read(rec):
    return rec["syncs_per_step"] if rec["sampler"] == "stretch" else None
