"""Milliseconds after the loop engine (IR resummation, AP, window, binning,
the marginalised likelihood) at the half-step batch: the whole ``logp``
minus the ``nonlinear`` prefix."""


def read(rec):
    stages = rec.get("stage_ms")
    return stages["logp"] - stages["nonlinear"] if stages else None
