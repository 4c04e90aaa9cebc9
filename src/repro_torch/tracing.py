"""Spans and host-sync counters of the serving path, on the profiler's clock.

A span is a ``torch.profiler.record_function`` range named ``PREFIX +
name``: under a ``torch.profiler`` run it lands in the kineto trace beside
the card's records, on the same clock, and the kernels it launches fall
inside it.  Tracing is off unless a :func:`capture` block is open, and then
:func:`span` returns one shared no-op object after a single flag read (no
string built, no lock, no profiler imported).  :func:`capture` is the only
switch: no environment variable and no parameter turns spans on.

One thread serves one request, so the spans of a request nest by time.
The spans, the layer each belongs to, and the benchmark metric
(``portbench/metrics/<name>.py``) that reads each:

  ``serve.submit.<template>.<n>``  one per request (``QueryServer.submit``);
      ``n`` is the server's sequence number of the request, the identifier
      the request's other spans share by nesting inside it.  Read by
      ``server_self_ms`` (its duration less its ``serve.execute``,
      ``serve.rerun`` and ``sync.*`` spans) and by ``device_share.group_by``
      (the share of device time launched inside one, in its notes).
  ``serve.bind``     the binding's validation and its upload.
  ``serve.prepare``  a template's preparation (a cache miss only).
  ``serve.execute``  the prepared executable's run; ``serve.rerun`` the
      conservative re-run after an overflow.  Both subtracted by
      ``server_self_ms``.
  ``serve.fetch``    the answer's copy to the host.
  ``engine.<Node>``  one per plan node the executor runs
      (``planner._Executor``; a memo hit opens none), named by the node's
      class (``engine.GroupBy``, ``engine.Join``, ...); a child's span nests
      inside its parent's.  Read by ``device_share.group_by``
      (``GroupBy``, ``AggScalar``) and ``device_share.join`` (``Join``,
      ``Semi``, ``Anti``, ``Left``): device time by the innermost engine
      span open when each record was launched; by ``idle_share.engine``
      (the device idle while the innermost span is an engine span or a sync
      inside one); and by ``server_self_ms``'s notes (host self time by
      node type).
  ``sync.<site>``    each place where the host waits on the card: a
      pageable host-to-device copy (``param``, ``lookup``, ``where_f64``,
      ``minmax_fill``, ``left_default``, ``scalar_result``) or a read of a
      device value (``flags``, ``fetch``, ``probe_nonzero``).  Subtracted by
      ``server_self_ms``; read by ``idle_share.engine``.

The counter ``syncs`` (site -> passes) counts every :func:`sync` whether
tracing is on or off, on any device (on the CPU the same sites count, so a
count does not depend on where the tables live).  Read by
``syncs_per_query``: its change across the traced window over the window's
requests.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["PREFIX", "span", "sync", "capture", "syncs"]

PREFIX = "repro_torch."

# site -> times the host waited on the card there
syncs: dict[str, int] = {}
_lock = threading.Lock()
_open = 0                       # capture() blocks open, in any thread


class _Off:
    """The span of tracing off: enters and leaves, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, *tags):
    """A context manager spanning ``name`` (``name.tag.tag...`` when tags
    are given, joined only while tracing is on)."""
    if not _open:
        return _OFF
    from torch.autograd.profiler import record_function
    if tags:
        name = ".".join([name, *map(str, tags)])
    return record_function(PREFIX + name)


def sync(site: str):
    """:func:`span` of ``sync.<site>``, around one wait of the host on the
    card; counted in ``syncs`` whether tracing is on or off."""
    with _lock:
        syncs[site] = syncs.get(site, 0) + 1
    return span("sync", site)


@contextlib.contextmanager
def capture():
    """Tracing on while the block is open (re-entrant)."""
    global _open
    with _lock:
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
