#!/usr/bin/env python3
"""Time the parts of the sample ladder's row selection on the host.

    python3 tools/time_sampling.py [--rows N] [--seed S]

``repro_torch.approx.sampling.stratified_selection`` numbers the strata,
hashes every row index, ranks the rows by ``np.lexsort`` within their
stratum and keeps each stratum's ``m_g`` smallest ranks.  This times each
part on the same columns, for Q1's strata (two keys of 3 and 2 values, the
shape of ``l_returnflag`` and ``l_linestatus``) and for one global stratum
(Q6), at rung 1/16: the reference package's numbering
(``np.unique(axis=0)``) beside the port's (1-D codes), which must give the
same ids, the hash, the lexsort with the ids as int64 (the reference's)
and in their narrowest dtype (the port's), and the whole selection.
Prints one JSON line of seconds per part.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def timed(fn):
    s = time.perf_counter()
    out = fn()
    return out, round(time.perf_counter() - s, 3)


def reference_ids(strata, n: int) -> np.ndarray:
    """The reference package's numbering of the strata."""
    if not strata:
        return np.zeros(n, dtype=np.int64)
    key = np.stack([np.asarray(c).astype(np.int64) for c in strata], axis=1)
    return np.unique(key, axis=0, return_inverse=True)[1].reshape(-1)


def main() -> int:
    from repro_torch.approx import sampling
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=6_000_000)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    n = args.rows
    cases = {"q1 strata (3 x 2 keys)": [rng.integers(0, 3, n, dtype=np.int32),
                                        rng.integers(0, 2, n, dtype=np.int32)],
             "q6 (one stratum)": []}
    out = {"rows": n}
    for name, strata in cases.items():
        secs = {}
        want, secs["reference numbering"] = timed(
            lambda: reference_ids(strata, n))
        sid, secs["port numbering"] = timed(
            lambda: sampling._stratum_ids(strata, n))
        if sid.tobytes() != want.tobytes():
            raise AssertionError(f"{name}: the numberings differ")
        h, secs["hash"] = timed(lambda: sampling._splitmix64(
            np.arange(n, dtype=np.uint64)))
        _, secs["lexsort, int64 ids"] = timed(lambda: np.lexsort((h, sid)))
        key = sid.astype(np.min_scalar_type(int(sid.max(initial=0))))
        _, secs["lexsort, narrowest ids"] = timed(
            lambda: np.lexsort((h, key)))
        _, secs["selection"] = timed(
            lambda: sampling.stratified_selection(strata, n, 16))
        out[name] = secs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
