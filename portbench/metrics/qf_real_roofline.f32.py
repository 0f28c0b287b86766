"""Per cent of the float32 ``qf_real`` launches' device time that the
algorithm's work needs at the card's peaks (``roofline.py``): the least
time of every launch in the traced steps over their device time."""

from portbench.roofline import qf_real_least_seconds

DTYPE = "f32"


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    launches = [q for q in p["qf_real"] if q["dtype"] == DTYPE]
    if not launches:
        return None
    device_s = p["qf_real_device_s"]   # > 0 and of one dtype: the harness refuses a run otherwise
    least = sum(q["count"] * qf_real_least_seconds(q["w"], q["n"], q["s"], q["bl"], DTYPE)
                for q in launches)
    return 100.0 * least / device_s
