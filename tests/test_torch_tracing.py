"""The serving path's spans and sync counter (``repro_torch.tracing``) and
the benchmark's readers of them (``portbench/metrics``).

On the CPU: tracing off costs a shared no-op and leaves no record while the
counter still counts; under ``capture()`` the 22 templates served once leave
one ``serve.submit`` span a request with every other span inside it and one
``engine.*`` span a plan node executed, and the same syncs a template on
every pass, and a reader's hook finds the profiler the window runs under;
the new readers give exact values on hand-built traces, and the five older
readers the same values whether or not a record carries the program's
spans.

Marked ``gpu`` (they skip without a card, decided inside a fixture): the
counter equals the synchronising operations PyTorch's sync debug mode
reports over a pass of the 22 templates, and a program span gets its
kernels' device time in a ``portbench.profiling.trace`` window.  On a card run them
with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tracing.py
"""
import collections
import contextlib
import sys
import time
import traceback
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.core.planner import walk
from repro_torch.data import tpch
from repro_torch.serve import TEMPLATES, QueryServer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import catalog, harness, profiling, program_spans  # noqa: E402
from portbench.profiling import Span, Trace  # noqa: E402
from portbench.program_spans import ProgramTrace  # noqa: E402

# syncs a request of each template at tpch.generate(0.01, seed=7) with
# sorted joins: its parameters, lookup tables, float branches, min/max fills
# and left-join defaults uploaded, three flag reads, the answer's row count
# and each of its non-empty columns (Q18's answer is empty at this scale);
# on the card the sync debug mode counts the same (the gpu test below)
SYNCS = {1: 15, 2: 13, 3: 11, 4: 6, 5: 8, 6: 10, 7: 12, 8: 8, 9: 13, 10: 8,
         11: 6, 12: 9, 13: 8, 14: 7, 15: 8, 16: 18, 17: 5, 18: 4, 19: 5,
         20: 7, 21: 6, 22: 7}


SYNC_WARNING = "called a synchronizing CUDA operation"


def _n_syncs() -> int:
    return sum(tracing.syncs.values())


def _program_spans(prof) -> list[Span]:
    out = program_spans.from_profiler(prof, tracing.PREFIX).spans
    return sorted(out, key=lambda s: (s.start_ns, -s.end_ns))


class _Unprintable:
    def __str__(self):
        raise AssertionError("a tag was formatted with tracing off")


def test_tracing_off_is_a_shared_no_op_and_syncs_still_count():
    before = tracing.syncs.get("test_site", 0)
    a = tracing.span("engine", _Unprintable())
    b = tracing.sync("test_site")
    assert a is b
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("engine.GroupBy"):
            with tracing.sync("test_site"):
                torch.ones(8).sum()
    assert _program_spans(prof) == []
    assert tracing.syncs["test_site"] == before + 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.capture():
            with tracing.capture():
                pass
            with tracing.span("engine", "GroupBy"):
                with tracing.sync("test_site"):
                    torch.ones(8).sum()
        with tracing.span("serve.submit"):
            pass
    assert [s.name for s in _program_spans(prof)] == \
        ["engine.GroupBy", "sync.test_site"]
    assert tracing.syncs["test_site"] == before + 3


def _serve_pass(server) -> dict[int, int]:
    got = {}
    for qid in TEMPLATES:
        n = _n_syncs()
        server.submit(qid)
        got[qid] = _n_syncs() - n
    return got


def test_each_request_has_one_root_span_and_one_span_a_plan_node():
    db = tpch.generate(0.01, seed=7)
    server = QueryServer(db, device="cpu")
    rec = _record(None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a reader's hook: the spans on, and the profiler kept
        with program_spans.install(rec):
            first = _serve_pass(server)
    assert rec.extras["profiler"] is prof and not tracing._open
    second = _serve_pass(server)
    assert first == second == SYNCS
    assert server.overflow_reruns == 0 and server.recompiles == 22
    spans = _program_spans(prof)
    roots = [s for s in spans if s.name.startswith("serve.submit.")]
    assert [r.name for r in roots] == [f"serve.submit.{TEMPLATES[q].name}.{i}"
                                       for i, q in enumerate(TEMPLATES, 1)]
    inside = {r: [] for r in roots}
    for s in spans:
        if s in inside:
            continue
        holder = [r for r in roots
                  if r.start_ns <= s.start_ns and s.end_ns <= r.end_ns]
        assert len(holder) == 1, s
        inside[holder[0]].append(s.name)
    for qid, r in zip(TEMPLATES, roots):
        names = collections.Counter(inside[r])
        want = collections.Counter(f"engine.{type(n).__name__}"
                                   for n in walk(TEMPLATES[qid].query.plan))
        assert {k: v for k, v in names.items()
                if k.startswith("engine.")} == want, qid
        assert sum(v for k, v in names.items() if k.startswith("sync.")) == \
            SYNCS[qid]
        for k in ("serve.bind", "serve.prepare", "serve.execute",
                  "serve.fetch"):
            assert names[k] == 1, (qid, k)


# -- the readers on hand-built traces ----------------------------------------

MS = 1_000_000      # ns


def _record(tr, requests=2, program=None):
    rec = harness.Record(torch.device("cpu"), None)
    rec.trace = tr
    rec.requests = [None] * requests
    if program is not None:
        rec.extras["program_trace"] = program
    return rec


def _trace(device):
    w = Span(profiling.WINDOW_SPAN, 0, 100 * MS)
    reqs = [Span("q1.0", 5 * MS, 50 * MS), Span("q6.0", 55 * MS, 95 * MS)]
    return Trace(device, reqs, w)


# two requests; times in ms
SPANS = [Span(n, a * MS, b * MS) for n, a, b in [
    ("serve.submit.q1.1", 10, 50),
    ("serve.bind", 11, 13), ("sync.param", 11, 12),
    ("serve.execute", 14, 40),
    ("engine.Finalize", 14, 40),
    ("engine.GroupBy", 15, 39),
    ("engine.Join", 16, 30),
    ("engine.Scan", 17, 18),
    ("sync.minmax_fill", 31, 33),
    ("sync.flags", 40, 44),
    ("serve.fetch", 45, 49), ("sync.fetch", 45, 47),
    ("serve.submit.q6.2", 60, 90),
    ("serve.execute", 61, 80),
    ("engine.AggScalar", 61, 80),
    ("sync.lookup", 62, 64),
    ("sync.flags", 80, 85),
]]
# (name, start, end, launched at)
DEVICE = [("join_kernel", 20, 26, 19), ("fill", 34, 38, 32),
          ("sum_kernel", 40, 42, 36), ("copy", 46, 47, 45.5),
          ("agg_kernel", 66, 79, 65), ("late", 81, 82, None),
          ("outside", 96, 97, 95)]


def _device():
    return [Span(n, a * MS, b * MS) for n, a, b, _ in DEVICE]


def _program():
    return ProgramTrace(SPANS, [
        (s, None if at is None else int(at * MS))
        for s, (*_, at) in zip(_device(), DEVICE)])


def test_server_self_time_is_the_root_less_its_waits():
    rec = _record(_trace(_device()), program=_program())
    # q1: 40 less param 1, execute 26, flags 4, fetch's sync 2 = 7 ms;
    # q6: 30 less execute 19, flags 5 = 6 ms
    assert catalog.reader("server_self_ms").read(rec) == 6.5
    view = program_spans.program_view(rec)
    i = [s.name for s in view.spans].index("engine.GroupBy")
    assert view.self_ns(i) == (24 - 14 - 2) * MS
    assert any("engine.GroupBy 4.000" in n for n in rec.notes), rec.notes


def test_device_time_goes_to_the_innermost_engine_span_at_launch():
    rec = _record(_trace(_device()), program=_program())
    total = sum(b - a for _, a, b, _ in DEVICE)           # 28 ms
    # GroupBy: fill (launched in its sync) and sum_kernel; AggScalar:
    # agg_kernel; Join: join_kernel (Scan ended before its launch)
    assert catalog.reader("device_share.group_by").read(rec) == \
        (4 + 2 + 13) / total
    assert catalog.reader("device_share.join").read(rec) == 6 / total
    # launched inside serve.submit: all but "late" (no launch) and "outside"
    assert any(f"{(28 - 2) / 28:.5f}" in n for n in rec.notes), rec.notes


def test_idle_time_splits_over_the_innermost_spans_exactly():
    tr = _trace(_device())
    rec = _record(tr, program=_program())
    view = program_spans.program_view(rec)
    pieces = list(view.idle_pieces())
    w = tr.window.end_ns - tr.window.start_ns
    busy = sum(b - a for a, b in profiling.busy_intervals(tr))
    assert busy == 28 * MS
    # the pieces tile the idle time: 1 - busy / window, exactly
    assert sum(b - a for a, b, _ in pieces) == w - busy
    assert all(a < b for a, b, _ in pieces)
    # idle under an engine span or a sync inside one, by idle gap:
    # [0, 20) Finalize 14-15, GroupBy 15-16, Join 16-17, Scan 17-18, Join
    # 18-20; [26, 34) Join 26-30, GroupBy 30-31, its sync 31-33, GroupBy
    # 33-34; [38, 40) GroupBy 38-39, Finalize 39-40; [47, 66) AggScalar
    # 61-62, its sync 62-64, AggScalar 64-66; [79, 81) AggScalar 79-80.
    # Idle under sync.flags, serve.fetch, serve.submit or no span is not
    engine_ms = (1 + 1 + 1 + 1 + 2) + (4 + 1 + 2 + 1) + (1 + 1) + \
        (1 + 2 + 2) + 1
    assert engine_ms == 22
    got = catalog.reader("idle_share.engine").read(rec)
    assert got == engine_ms * MS / w
    assert got <= (w - busy) / w


def test_syncs_per_query_is_the_counters_change_over_the_requests():
    r = catalog.reader("syncs_per_query")
    rec = _record(None, requests=4)
    with r.install(rec):
        assert tracing._open
        for site in ("flags", "flags", "fetch", "param", "flags", "fetch"):
            with tracing.sync(site):
                pass
    assert not tracing._open
    assert r.read(rec) == 1.5
    assert rec.notes == ["syncs a request by site: flags 0.750, "
                         "fetch 0.500, param 0.250"]


class _Counter:
    calls = [("sort",)] * 6


def test_the_older_readers_read_the_same_with_or_without_the_new_fields():
    names = ("rerun_share", "sorts_per_query", "device_share.sort",
             "segment_reduce_roofline", "idle_share")
    got = []
    for program in (None, _program()):
        rec = _record(_trace(_device()), requests=3, program=program)
        rec.counters_before = {"overflow_reruns": 1}
        rec.counters_after = {"overflow_reruns": 2}
        rec.count_requests = [None] * 4
        rec.extras["sorts_per_query"] = _Counter()
        got.append({n: catalog.reader(n).read(rec) for n in names})
    assert got[0] == got[1]
    assert got[0]["idle_share"] == 1 - 28 / 100
    assert got[0]["sorts_per_query"] == 1.5
    assert got[0]["rerun_share"] == 1 / 3


def test_a_trace_without_program_spans_reads_nothing():
    # no profiler kept (a window run without it), and a program that left
    # no span in the window (a program without repro_torch.tracing)
    for program in (None, ProgramTrace([], _program().device)):
        rec = _record(_trace(_device()), program=program)
        for name in ("server_self_ms", "idle_share.engine",
                     "device_share.group_by", "device_share.join"):
            assert catalog.reader(name).read(rec) is None, name
        assert catalog.reader("syncs_per_query").read(rec) is None


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync debug mode and the "
                    "kernels' device records exist only there")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("join", ["sorted", "hash"])
def test_the_sync_counter_equals_the_sync_debug_warnings(cuda, join):
    server = QueryServer(tpch.generate(0.01, seed=7), device=cuda,
                         join_method=join)
    _serve_pass(server)                 # preparations and kernel loads
    torch.cuda.synchronize()
    depth, seen = [0], []
    inner = tracing.sync

    @contextlib.contextmanager
    def watched(site):
        with inner(site):
            depth[0] += 1
            n = len(seen)
            try:
                yield
            finally:
                depth[0] -= 1
                if len(seen) != n + 1:
                    seen.append((f"sync.{site} saw {len(seen) - n}",
                                 traceback.format_stack(limit=4)[-3]))

    def show(message, *args, **kwargs):
        # the mode's one notice that it is a prototype is no operation
        if str(message).startswith(SYNC_WARNING):
            where = "" if depth[0] else traceback.format_stack(limit=6)[-4]
            seen.append((str(message), where))

    counted, warned = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        tracing.sync = watched
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for qid in TEMPLATES:
                n, m = _n_syncs(), len(seen)
                server.submit(qid)
                counted[qid] = _n_syncs() - n
                warned[qid] = sum(w.startswith(SYNC_WARNING)
                                  for w, _ in seen[m:])
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracing.sync = inner
    stray = [w for w in seen if w[1] or " saw " in w[0]]
    assert counted == warned, stray[:20]
    assert not stray, stray[:20]
    if join == "sorted":
        assert counted == SYNCS


@pytest.mark.gpu
def test_a_program_span_gets_its_kernels_device_time(cuda):
    x = torch.randn(1 << 24, device=cuda)
    torch.cuda.synchronize()

    rec = _record(None, requests=1)

    def fn():
        # as the harness's traced window runs a reader's hook
        with program_spans.install(rec), \
                record_function(profiling.WINDOW_SPAN):
            with tracing.span("engine", "GroupBy"):
                torch.cumsum(x, 0)
            time.sleep(0.02)
            with tracing.span("engine", "Join"):
                x.mul(3.0)
    rec.trace = profiling.trace(fn, print)
    view = program_spans.program_view(rec)
    assert [view.kinds[i] for i in range(len(view.spans))] == \
        ["engine.GroupBy", "engine.Join"]
    by = collections.defaultdict(list)
    for s, at, i in view.device_records():
        assert at is not None, s.name
        by[view.kinds[i] if i >= 0 else None].append(s)
    assert sorted(by, key=str) == ["engine.GroupBy", "engine.Join"]
    assert all("mul" in s.name.lower() for s in by["engine.Join"])
    assert not any("mul" in s.name.lower() for s in by["engine.GroupBy"])
    # one clock: the card ran the cumsum before the host left the sleep
    # that separates the spans, and the product after (kineto aligns the
    # card's clock to the host's within tens of us, far under 20 ms)
    group_by, join = view.spans
    assert max(s.end_ns for s in by["engine.GroupBy"]) < join.start_ns
    assert min(s.start_ns for s in by["engine.Join"]) > \
        group_by.end_ns + 10 * MS
    total = sum(s.end_ns - s.start_ns for v in by.values() for s in v)
    assert catalog.reader("device_share.join").read(rec) == \
        sum(s.end_ns - s.start_ns for s in by["engine.Join"]) / total
