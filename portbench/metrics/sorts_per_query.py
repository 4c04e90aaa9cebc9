"""``sorts_per_query`` (planner layer): the aten calls that sort
(``repro_torch.core.sortcount.SortCounter``: sort, argsort, topk, unique)
per request, over one cycle of the traffic.  The counter is a dispatch mode
with host overhead, so it runs in the counting cycle, not in the profiled
window."""

import contextlib

PASS = "count"


@contextlib.contextmanager
def install(rec):
    from repro_torch.core.sortcount import SortCounter
    counter = SortCounter()
    rec.extras["sorts_per_query"] = counter
    with counter:
        yield


def read(rec):
    counter = rec.extras.get("sorts_per_query")
    if counter is None or not rec.count_requests:
        return None
    return len(counter.calls) / len(rec.count_requests)
