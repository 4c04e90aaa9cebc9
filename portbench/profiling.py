"""What a traced window leaves to read: the device's operations and the
host's request spans, both from one ``torch.profiler`` trace.

The trace is read from the profiler's raw records
(``prof.profiler.kineto_results.events()``, as ``chip_smoke.py`` reads
them): building ``prof.events()`` would first build the host's operator
tree.  A window that ran requests on the card and left no device record is
a failed trace; it is taken again, the last time held open 50 ms past the
synchronise for CUPTI's late records, and a third empty one raises.  The
device's operations are its records other than user annotations, which
mirror host spans.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

__all__ = ["Span", "Trace", "trace", "SPAN_PREFIX", "WINDOW_SPAN"]

SPAN_PREFIX = "portbench:"          # the host's span of one request
WINDOW_SPAN = "portbench.window"    # the host's span of the traced window
NAME_CHARS = 160                    # a kernel's name in the breakdown, cut


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: list[Span]      # kernels, copies and sets, in start order
    requests: list[Span]    # the host's request spans, in start order
    window: Span            # the traced window


def trace(fn: Callable[[], None], log: Callable[[str], None]) -> Trace:
    """Run ``fn`` (which must open ``record_function(WINDOW_SPAN)`` around
    its work and ``record_function(SPAN_PREFIX + name)`` around each
    request) under the profiler and return what it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt, hold in enumerate((0.0, 0.0, 0.05)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(hold)
        device, requests, window = [], [], None
        for k in prof.profiler.kineto_results.events():
            start = k.start_ns()
            span = Span(k.name(), start, start + k.duration_ns())
            if k.device_type() == DeviceType.CUDA:
                # the profiler mirrors every host span (the harness's and
                # any the program opens) onto the device's timeline as a
                # user annotation; those are no operation of the device
                if not k.is_user_annotation():
                    device.append(span)
                continue
            if span.name == WINDOW_SPAN:
                window = span
            elif span.name.startswith(SPAN_PREFIX):
                requests.append(Span(span.name[len(SPAN_PREFIX):],
                                     span.start_ns, span.end_ns))
        if device and window is not None:
            device.sort(key=lambda s: s.start_ns)
            requests.sort(key=lambda s: s.start_ns)
            return Trace(device, requests, window)
        log(f"torch.profiler: trace {attempt + 1} (held {hold * 1e3:.0f} ms)"
            f" recorded {len(device)} device records and "
            f"{'a' if window else 'no'} window span")
    raise RuntimeError("torch.profiler recorded no device time for a window "
                       "that ran requests on the card, three times")


def busy_intervals(tr: Trace) -> list[tuple[int, int]]:
    """The union of the device records inside the window, as disjoint
    (start, end) intervals in time order."""
    w0, w1 = tr.window.start_ns, tr.window.end_ns
    out: list[list[int]] = []
    for s in tr.device:
        a, b = max(s.start_ns, w0), min(s.end_ns, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e9


def device_ops(tr: Trace, top: int = 10) -> list[list]:
    """The device operations that took most time, summed by name."""
    by: dict[str, int] = {}
    for s in tr.device:
        by[s.name] = by.get(s.name, 0) + (s.end_ns - s.start_ns)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:NAME_CHARS], ns / 1e9] for name, ns in ranked]


def idle_gaps(tr: Trace, top: int = 10) -> list[list]:
    """The device's idle time inside the window, summed by what the host
    was serving when each gap began (``q<n>``: a request of template n;
    ``between requests``: the harness's own work between two)."""
    busy = busy_intervals(tr)
    edges = [tr.window.start_ns] + [x for iv in busy for x in iv] + \
        [tr.window.end_ns]
    by: dict[str, int] = {}
    req = tr.requests
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while j < len(req) and req[j].end_ns <= a:
            j += 1
        on = req[j] if j < len(req) and req[j].start_ns <= a else None
        label = on.name.split(".")[0] if on else "between requests"
        by[label] = by.get(label, 0) + (b - a)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]
