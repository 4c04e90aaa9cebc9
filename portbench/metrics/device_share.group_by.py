"""``device_share.group_by`` (engine layer): the device time of the records
launched while the innermost ``engine.*`` span open on the host was
``engine.GroupBy`` or ``engine.AggScalar`` (``repro_torch.tracing``; a
record's launch is the host's runtime call matched to it by correlation
id), over all device time of the traced window.  The notes give the device
seconds by innermost engine span with its three costliest kernels, and the
share launched inside a ``serve.submit`` span.  A program without spans
reads nothing."""

from portbench import program_spans

PASS = "profile"

NODES = ("engine.GroupBy", "engine.AggScalar")
OUTSIDE = "no engine span"


def install(rec):
    return program_spans.install(rec)


def read(rec):
    view = program_spans.program_view(rec)
    if view is None or not view.spans:
        return None
    total, submit = 0, 0
    by: dict[str, dict[str, int]] = {}
    for s, _, i in view.device_records():
        d = s.end_ns - s.start_ns
        total += d
        e = view.engine[i] if i >= 0 else -1
        label = view.kinds[e] if e >= 0 else OUTSIDE
        names = by.setdefault(label, {})
        names[s.name] = names.get(s.name, 0) + d
        top = view.top(i)
        submit += d if top >= 0 and view.kinds[top] == "serve.submit" else 0
    unmatched = sum(1 for _, a in view.device if a is None)
    if not total:
        return None
    rows = []
    for label, names in sorted(by.items(),
                               key=lambda kv: -sum(kv[1].values())):
        top3 = sorted(names.items(), key=lambda kv: -kv[1])[:3]
        rows.append(f"{label} {sum(names.values()) / 1e9:.4f} s [" + "; ".join(
            f"{n[:60]} {ns / 1e9:.4f}" for n, ns in top3) + "]")
    rec.notes.append("device s by innermost engine span at launch: " +
                     ", ".join(rows))
    rec.notes.append(f"device time launched inside serve.submit: "
                     f"{submit / total:.5f} of {total / 1e9:.4f} s; "
                     f"{unmatched} of {len(view.device)} device records "
                     "without a matched launch")
    return sum(sum(by.get(k, {}).values()) for k in NODES) / total
