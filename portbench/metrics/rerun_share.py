"""``rerun_share`` (server layer): the share of the traced window's requests
that the server ran twice, because the first run's capacity claims proved
too tight for the binding (``QueryServer.overflow_reruns``)."""

PASS = "profile"


def read(rec):
    key = "overflow_reruns"
    if key not in rec.counters_after or not rec.requests:
        return None
    return (rec.counters_after[key] - rec.counters_before[key]) / \
        len(rec.requests)
