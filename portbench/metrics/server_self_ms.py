"""``server_self_ms`` (server layer): the mean over the traced window's
requests of the program's ``serve.submit`` span less the part of it that
its ``serve.execute``, ``serve.rerun`` and ``sync.*`` spans cover: the
binding, the cache lookup, the answer's conversion and the server's own
Python (``repro_torch.tracing``).  The notes give the engine's host self
time by plan node type (each ``engine.*`` span less its child spans).  A
program without spans reads nothing."""

from portbench import program_spans

PASS = "profile"

_WAITS = ("serve.execute", "serve.rerun")


def install(rec):
    return program_spans.install(rec)


def _covered(view, root: int) -> int:
    """ns of span ``root`` covered by its topmost waiting descendants."""
    out, todo = 0, list(view.children[root])
    while todo:
        j = todo.pop()
        k = view.kinds[j]
        if k in _WAITS or k.startswith("sync."):
            s = view.spans[j]
            out += s.end_ns - s.start_ns
        else:
            todo.extend(view.children[j])
    return out


def read(rec):
    view = program_spans.program_view(rec)
    if view is None:
        return None
    roots = [i for i, k in enumerate(view.kinds) if k == "serve.submit"]
    if not roots:
        return None
    own = sum(view.spans[i].end_ns - view.spans[i].start_ns -
              _covered(view, i) for i in roots)
    by: dict[str, int] = {}
    for i, k in enumerate(view.kinds):
        if k.startswith("engine."):
            by[k] = by.get(k, 0) + view.self_ns(i)
    rec.notes.append("engine host self ms a request by node type: " +
                     ", ".join(f"{k} {ns / 1e6 / len(roots):.3f}"
                               for k, ns in sorted(by.items(),
                                                   key=lambda kv: -kv[1])))
    return own / 1e6 / len(roots)
