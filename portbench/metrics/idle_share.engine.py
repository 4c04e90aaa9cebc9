"""``idle_share.engine`` (engine layer): the share of the traced window in
which the device ran nothing while the host's innermost program span was
an ``engine.*`` span, or a ``sync.*`` span inside one
(``repro_torch.tracing``).  Each idle gap is split over the innermost spans
the host was in during it, by overlap; the notes give the idle seconds by
innermost span kind.  A program without spans reads nothing."""

from portbench import program_spans

PASS = "profile"

OUTSIDE = "outside the program's spans (the harness)"


def install(rec):
    return program_spans.install(rec)


def read(rec):
    view = program_spans.program_view(rec)
    if view is None or not view.spans:
        return None
    w = rec.trace.window.end_ns - rec.trace.window.start_ns
    engine, by = 0, {}
    for a, b, i in view.idle_pieces():
        label = view.kinds[i] if i >= 0 else OUTSIDE
        by[label] = by.get(label, 0) + (b - a)
        if i >= 0 and view.engine[i] >= 0:     # an engine span or in one
            engine += b - a
    rec.notes.append("idle s by innermost span: " + ", ".join(
        f"{k} {ns / 1e9:.4f}" for k, ns in sorted(by.items(),
                                                  key=lambda kv: -kv[1])))
    return engine / w
