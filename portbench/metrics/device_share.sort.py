"""``device_share.sort`` (engine layer): the share of the traced window's
device time spent in sort kernels: cub's radix sorts (the kernels of
``DeviceRadixSort`` and ``DeviceSegmentedRadixSort``, under names holding
``RadixSort``) and ATen's own sort kernels (bitonic and segmented sorts,
``sortKeyValueInplace``).  The names matched are noted on standard error."""

import re

PASS = "profile"

SORT = re.compile(r"radixsort|radix_sort|bitonicsort|segmentedsort|"
                  r"segmented_sort|sortkeyvalue|sort_postprocess|"
                  r"sortcommon|mergesort|blocksort", re.IGNORECASE)


def read(rec):
    if rec.trace is None:
        return None
    w0, w1 = rec.trace.window.start_ns, rec.trace.window.end_ns
    total, sort, names = 0, 0, set()
    for s in rec.trace.device:
        if s.end_ns <= w0 or s.start_ns >= w1:
            continue
        d = s.end_ns - s.start_ns
        total += d
        if SORT.search(s.name):
            sort += d
            names.add(s.name)
    rec.notes.append("device_share.sort matched: " + "; ".join(
        sorted(n[:120] for n in names)))
    return sort / total if total else None
