"""``segment_reduce_roofline`` (kernels layer): the least time the card could
take for every call of ``repro_torch.kernels.segsum.ops.segment_reduce`` in
the traced window, over the time the calls took, in %.

The least time is the call's bytes at the card's memory rate (3.35 TB/s,
the H100 SXM's data sheet): the group ids and the values read once, the
result written once.  The time is taken by CUDA events around each call of
the public op, by this reader's own wrapper, so the same work is measured
whatever implements the op.  A window with no call on the card reads
nothing."""

import contextlib

PASS = "profile"


@contextlib.contextmanager
def install(rec):
    import torch
    from repro_torch.kernels.segsum import ops
    calls = []
    rec.extras["segment_reduce"] = calls
    inner = ops.segment_reduce

    def timed(gids, values, groups, op="sum"):
        if gids.device.type != "cuda":
            return inner(gids, values, groups, op)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(gids, values, groups, op)
        end.record()
        nbytes = gids.numel() * gids.element_size() + \
            out.numel() * out.element_size()
        if op != "count":
            nbytes += values.numel() * values.element_size()
        calls.append((start, end, nbytes))
        return out

    ops.segment_reduce = timed
    try:
        yield
    finally:
        ops.segment_reduce = inner


def read(rec):
    calls = rec.extras.get("segment_reduce")
    if not calls:
        return None
    import torch
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e, _ in calls)
    least_ms = sum(b for _, _, b in calls) / rec.peak_bytes_per_s * 1e3
    rec.notes.append(f"segment_reduce: {len(calls)} calls, "
                     f"{sum(b for _, _, b in calls) / 1e9:.3f} GB, "
                     f"{ms:.3f} ms measured, {least_ms:.3f} ms least")
    return 100.0 * least_ms / ms if ms > 0 else None
