"""The program's own spans in a traced window, and each device record's
launch, read from the same ``torch.profiler`` trace as
:mod:`portbench.profiling` reads.

The program opens its spans (``repro_torch.tracing``: names under its
``PREFIX``) only while ``tracing.capture()`` is open.  A reader's
``install`` hook (:func:`install`) opens it around the traced window and
keeps the profiler the window runs under, found among the locals of the
frames that called the hook; once the window is over, :func:`program_view`
reads from that profiler's raw records the program's spans and, for each
device record (kernel, copy, set), the host's start of the CUDA runtime
call that launched it, matched through kineto's correlation id.
:func:`portbench.profiling.trace` and what it returns are untouched, so the
older readers read what they read without these.  A program without
``repro_torch.tracing``, or a window run without the profiler, leaves no
span, and what reads them reads nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
from typing import NamedTuple

from .profiling import Span, Trace, busy_intervals

__all__ = ["ProgramTrace", "ProgramView", "program_tracing", "install",
           "kind", "from_profiler", "program_view"]

# the host records of CUDA runtime and driver calls (cudaLaunchKernel,
# cudaMemcpyAsync, cuLaunchKernel, ...), which share their correlation id
# with the device record they issue
_LAUNCH_PREFIX = "cu"


class ProgramTrace(NamedTuple):
    spans: list[Span]                   # the program's, PREFIX cut, by start
    device: list[tuple[Span, int | None]]   # (record, its launch), by start


def program_tracing():
    """The program's ``repro_torch.tracing`` module, or None for a program
    that has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def _profiler():
    """The ``torch.profiler.profile`` open in a calling frame, or None."""
    from torch.profiler import profile
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, profile):
                return v
        f = f.f_back
    return None


@contextlib.contextmanager
def install(rec):
    """A reader's hook around the traced window: the program's spans on
    (``tracing.capture()``), and the profiler kept in ``rec.extras``."""
    prof = _profiler()
    if prof is not None:
        rec.extras["profiler"] = prof
        rec.extras.pop("program_view", None)
    tracing = program_tracing()
    with contextlib.nullcontext() if tracing is None else tracing.capture():
        yield


def kind(name: str) -> str:
    """A program span's kind: its name without the tags after the second
    dot (``serve.submit.q6.12`` -> ``serve.submit``)."""
    return ".".join(name.split(".", 2)[:2])


def from_profiler(prof, prefix: str) -> ProgramTrace:
    """The spans named under ``prefix`` and the device records with their
    launches, from a finished profiler's raw records.  The device records
    are those :func:`portbench.profiling.trace` keeps: user annotations,
    the device's mirrors of host spans, are left out."""
    from torch.autograd import DeviceType
    spans, device, launched = [], [], {}
    for k in prof.profiler.kineto_results.events():
        start = k.start_ns()
        name = k.name()
        if k.device_type() == DeviceType.CUDA:
            if not k.is_user_annotation():
                device.append((Span(name, start, start + k.duration_ns()),
                               k.correlation_id()))
        elif name.startswith(_LAUNCH_PREFIX):
            launched[k.correlation_id()] = start
        elif name.startswith(prefix):
            spans.append(Span(name[len(prefix):], start,
                              start + k.duration_ns()))
    spans.sort(key=lambda s: s.start_ns)
    device.sort(key=lambda sc: sc[0].start_ns)
    return ProgramTrace(spans, [(s, launched.get(c)) for s, c in device])


class ProgramView:
    """The program's spans inside a trace's window, nested by time (one
    thread serves a request, so its spans nest), and what lies under them.

    ``parent[i]`` is span i's enclosing span (-1 at the top),
    ``children[i]`` the spans it encloses directly, ``engine[i]`` the
    innermost ``engine.*`` span among span i and its ancestors (-1: none),
    and ``pieces`` the (start, end, i) intervals of the window in which span
    i is the innermost span open (gaps: none open)."""

    def __init__(self, tr: Trace, pt: ProgramTrace):
        w0, w1 = tr.window.start_ns, tr.window.end_ns
        self.trace = tr
        self.device = pt.device
        self.spans = [s for s in pt.spans
                      if s.start_ns >= w0 and s.end_ns <= w1]
        self.kinds = [kind(s.name) for s in self.spans]
        n = len(self.spans)
        self.parent = [-1] * n
        self.pieces: list[tuple[int, int, int]] = []
        stack: list[int] = []
        t = w0

        def close(until: int) -> None:
            nonlocal t
            while stack and self.spans[stack[-1]].end_ns <= until:
                j = stack.pop()
                if self.spans[j].end_ns > t:
                    self.pieces.append((t, self.spans[j].end_ns, j))
                    t = self.spans[j].end_ns

        # parents before their children
        order = sorted(range(n), key=lambda i: (self.spans[i].start_ns,
                                                -self.spans[i].end_ns))
        for i in order:
            s = self.spans[i]
            close(s.start_ns)
            if stack:
                self.parent[i] = stack[-1]
                if s.start_ns > t:
                    self.pieces.append((t, s.start_ns, stack[-1]))
            t = max(t, s.start_ns)
            stack.append(i)
        close(w1)
        self._piece_starts = [a for a, _, _ in self.pieces]
        self.children: list[list[int]] = [[] for _ in range(n)]
        for j, p in enumerate(self.parent):
            if p >= 0:
                self.children[p].append(j)
        self.engine = [-1] * n
        for i in order:
            self.engine[i] = i if self.kinds[i].startswith("engine.") \
                else (self.engine[self.parent[i]] if self.parent[i] >= 0
                      else -1)

    def innermost(self, t: int) -> int:
        """The innermost span open at ``t`` (-1: none)."""
        k = bisect.bisect_right(self._piece_starts, t) - 1
        if k >= 0 and t < self.pieces[k][1]:
            return self.pieces[k][2]
        return -1

    def top(self, i: int) -> int:
        """Span i's outermost ancestor (itself at the top; -1 for -1)."""
        while i >= 0 and self.parent[i] >= 0:
            i = self.parent[i]
        return i

    def device_records(self):
        """(record, its launch's host time, the innermost span open then)
        for each device record overlapping the window; a record without a
        matched launch gets (record, None, -1)."""
        w0, w1 = self.trace.window.start_ns, self.trace.window.end_ns
        for s, at in self.device:
            if s.end_ns <= w0 or s.start_ns >= w1:
                continue
            yield s, at, (self.innermost(at) if at is not None else -1)

    def idle_pieces(self):
        """(start, end, i): the window's idle gaps, cut where the innermost
        span open on the host changes (i = -1: no span open)."""
        w0, w1 = self.trace.window.start_ns, self.trace.window.end_ns
        busy = busy_intervals(self.trace)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        k = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            while a < b:
                while k < len(self.pieces) and self.pieces[k][1] <= a:
                    k += 1
                if k == len(self.pieces) or self.pieces[k][0] >= b:
                    yield a, b, -1
                    break
                p0, p1, i = self.pieces[k]
                if p0 > a:
                    yield a, p0, -1
                    a = p0
                yield a, min(b, p1), i
                a = min(b, p1)

    def self_ns(self, i: int) -> int:
        """Span i's duration less what its child spans cover."""
        s = self.spans[i]
        return (s.end_ns - s.start_ns) - sum(
            self.spans[j].end_ns - self.spans[j].start_ns
            for j in self.children[i])


def program_view(rec) -> ProgramView | None:
    """The :class:`ProgramView` of a reader's record, made once per record:
    from ``rec.extras["program_trace"]`` where that is set, else from the
    profiler :func:`install` kept.  None without a trace, a profiler or the
    program's tracing module."""
    if rec.trace is None:
        return None
    if "program_view" not in rec.extras:
        pt = rec.extras.get("program_trace")
        if pt is None:
            prof, tracing = rec.extras.get("profiler"), program_tracing()
            if prof is None or tracing is None:
                return None
            pt = from_profiler(prof, tracing.PREFIX)
        rec.extras["program_view"] = ProgramView(rec.trace, pt)
    return rec.extras["program_view"]
