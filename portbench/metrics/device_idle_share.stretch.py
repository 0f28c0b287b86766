"""Per cent of the traced ensemble steps' wall time in which no operation
ran on the device: the busy
seconds from torch.profiler, the wall of the same steps timed without it."""


def read(rec):
    p = rec.get("profile")
    if rec["sampler"] != "stretch" or not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
