"""Milliseconds of the loop engine at the half-step batch: the prefix
through ``compute_bird(stop_after="nonlinear")`` minus the cosmology
prefix."""


def read(rec):
    stages = rec.get("stage_ms")
    return stages["nonlinear"] - stages["cosmology"] if stages else None
