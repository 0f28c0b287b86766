"""Milliseconds of the gradient at the chains' batch: a value and gradient
minus a ``logp`` (host clock around synchronised calls)."""


def read(rec):
    stages = rec.get("stage_ms") or {}
    if "value_and_grad" not in stages:
        return None
    return stages["value_and_grad"] - stages["logp"]
