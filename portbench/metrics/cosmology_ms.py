"""Milliseconds of the cosmology provider at the half-step batch: the
``cosmology`` prefix, host clock around synchronised calls."""


def read(rec):
    stages = rec.get("stage_ms")
    return stages["cosmology"] if stages else None
