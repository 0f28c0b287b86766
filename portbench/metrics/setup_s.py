"""Seconds from the start of the process to the first timed step: imports,
the kernels' build or cache load, the inputs, Phase A and the warm-up."""


def read(rec):
    return rec["setup_s"]
