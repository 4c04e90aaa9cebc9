"""``idle_share`` (device layer): the share of the traced window in which
no operation ran on the device, from the profiler's device records."""

from portbench import profiling

PASS = "profile"


def read(rec):
    if rec.trace is None:
        return None
    w = (rec.trace.window.end_ns - rec.trace.window.start_ns) / 1e9
    return 1.0 - profiling.busy_s(rec.trace) / w
