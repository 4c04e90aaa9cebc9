"""``device_share.join`` (engine layer): the device time of the records
launched while the innermost ``engine.*`` span open on the host was
``engine.Join``, ``engine.Semi``, ``engine.Anti`` or ``engine.Left``
(``repro_torch.tracing``; launches matched by correlation id, as for
``device_share.group_by``), over all device time of the traced window.  A
program without spans reads nothing."""

from portbench import program_spans

PASS = "profile"

NODES = ("engine.Join", "engine.Semi", "engine.Anti", "engine.Left")


def install(rec):
    return program_spans.install(rec)


def read(rec):
    view = program_spans.program_view(rec)
    if view is None or not view.spans:
        return None
    total, join = 0, 0
    for s, _, i in view.device_records():
        d = s.end_ns - s.start_ns
        total += d
        e = view.engine[i] if i >= 0 else -1
        join += d if e >= 0 and view.kinds[e] in NODES else 0
    return join / total if total else None
