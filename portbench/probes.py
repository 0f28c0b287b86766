"""What a traced run (``--trace 1``) reads once the window has closed: host
synchronisations over one step, the device trace of a few steps, and the
stage prefixes on the host clock.  ``host_ms_over``, ``sync_sites`` and the
profiler's busy and idle share are copies of ``chip_smoke.py``'s helpers,
kept here so that the yardstick does not move when that script does.
"""

from __future__ import annotations

import time
import warnings

import torch

# the host operation that PyTorch records for each call of the autograd
# Function behind the public op ``quad_form_real``: the device time of the
# kernels launched inside it is the op's, whatever their names
QF_REAL_OP = "_QuadFormReal"


def host_ms_over(fn, inputs) -> float:
    """Mean host milliseconds of ``fn(x)`` over the distinct ``inputs[1:]``,
    after a call on ``inputs[0]``; the timed calls end in a synchronisation."""
    fn(inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs[1:]:
        fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (len(inputs) - 1) * 1e3


def sync_sites(fn) -> list:
    """The places where one call of ``fn`` synchronised the host with the
    card (torch's sync debug mode: one warning per synchronising operation,
    at the Python line that issued it)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_steps(fn, n: int, launches_by_shape: dict) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler`` (CUPTI): the device's
    busy seconds (the union of its operations' intervals) inside the traced
    window, the window's length under the profiler (``traced_s``), the
    device operations that took most time,
    the longest idle gaps labelled by the innermost host operation running
    in them, and the quadratic-form launches (by shape, from the program's
    counter) with the device seconds of the kernels that the host operation
    ``QF_REAL_OP`` launched (the profiler's correlation of each kernel with
    the host operation that launched it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    before = dict(launches_by_shape)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.window"):
            for _ in range(n):
                with record_function("portbench.step"):
                    fn()
            torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in launches_by_shape.items()
                if v - before.get(k, 0) > 0}
    events = prof.events()
    window = next(e for e in events if e.name == "portbench.window")
    w0, w1 = window.time_range.start, window.time_range.end
    # device operations: kernels, copies and sets, not the annotations' ranges
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and not e.name.startswith("portbench.")
           and e.time_range.end > w0 and e.time_range.start < w1]
    merged = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev])
    busy_us = sum(b - a for a, b in merged)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:10]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.name.startswith("portbench.")]
    labelled = []
    for width, a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        label = min(cover, key=lambda e: e.time_range.end - e.time_range.start).name \
            if cover else "host: between operations"
        labelled.append((label, width * 1e-6))
    qf_us = sum(e.device_time_total for e in events
                if e.name == QF_REAL_OP and e.device_type == DeviceType.CPU
                and w0 <= e.time_range.start <= w1)
    return dict(
        busy_s=busy_us * 1e-6, traced_s=(w1 - w0) * 1e-6, steps=n,
        device_ops=[[k[:120], us * 1e-6] for k, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[k[:120], s] for k, s in labelled],
        qf_real=[dict(dtype=k[1], w=k[2], n=k[3], s=k[4], bl=k[5], count=v)
                 for k, v in launches.items() if k[0] == "qf_real"],
        qf_real_device_s=qf_us * 1e-6)
