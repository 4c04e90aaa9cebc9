"""``syncs_per_query`` (engine layer): the times the host waited on the card
in the traced window (the change of ``repro_torch.tracing.syncs``, summed
over its sites) over the window's requests.  The notes give it by site.  A
program without the counter reads nothing."""

import contextlib

from portbench import program_spans

PASS = "profile"


@contextlib.contextmanager
def install(rec):
    tracing = program_spans.program_tracing()
    if tracing is None:
        yield
        return
    before = dict(tracing.syncs)
    with tracing.capture():
        yield
    rec.extras["syncs"] = {k: n - before.get(k, 0)
                           for k, n in tracing.syncs.items()
                           if n != before.get(k, 0)}


def read(rec):
    syncs = rec.extras.get("syncs")
    if syncs is None or not rec.requests:
        return None
    n = len(rec.requests)
    rec.notes.append("syncs a request by site: " + ", ".join(
        f"{k} {v / n:.3f}" for k, v in sorted(syncs.items(),
                                             key=lambda kv: -kv[1])))
    return sum(syncs.values()) / n
