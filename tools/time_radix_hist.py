#!/usr/bin/env python3
"""Time the port's partition histogram (and the counting rank, whose
three-pass design shares its kernel) on one CUDA card.

    python3 tools/time_radix_hist.py [--src DIR] [--reps N] [--plain]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script times another checkout of the port, e.g. a parent commit
unpacked with ``git archive``.  It goes through the public wrappers, whose
signatures every version keeps:

* ``kernels.radix_hist.ops.radix_hist`` at the cases of ``RADIX_CASES``
  (blocks of 2048 rows): SF 10's l_orderkey (60 M rows) into 8 partitions,
  hashed and not; SF 10's l_partkey into 8, hashed (the ``skew_stats``
  path); 60 M keys all in one bin (the hot partition ``skew_stats`` exists
  to find) and 60 M uniform random keys into 8; uniform keys into 64 (the
  width ``benchmarks/bench_kernels.py`` uses), 129, 4096 and 12288 (the
  width limit).  Each case runs twice and must give the same bytes, and is
  held exactly against its plain PyTorch version.  Beside the wrapper's
  time (CUDA events over ``reps`` calls), its device time alone
  (``time_hash_kernels.device_ms``: calls queued behind a sleeping kernel),
  ``torch.bincount`` over ids binned beforehand (the library call), the
  bound (each key read once, each count written once, at the card's memory
  rate) and, with ``--plain``, the plain version's time; where the version
  plans the histogram (``hist_plan``), the plan;
* ``kernels.radix_hist.ops.counting_rank`` at ``time_group_kernels.py``'s
  ``RANK_CASES`` (parts 5 and 9 single pass, 63 three passes).

SF 10 is generated in each run.  Timing and bound are ``chip_smoke.py``'s
``time_ms`` and ``bound``; ``chip_smoke.py`` calls :func:`time_hist` for
its phase-3 lines.  Prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from chip_smoke import bound, time_ms  # noqa: E402
from time_group_kernels import RANK_CASES, time_rank  # noqa: E402
from time_hash_kernels import device_ms  # noqa: E402

SEED = 11
SF = 10.0
N_KEYS = 60_000_000
BLK = 2048
# (keys, parts, hashed)
RADIX_CASES = (("l_orderkey", 8, True), ("l_orderkey", 8, False),
               ("l_partkey", 8, True), ("one_bin", 8, True),
               ("uniform", 8, True), ("uniform", 64, True),
               ("uniform", 129, True), ("uniform", 4096, True),
               ("uniform", 12288, True))


def case_keys(dev, name: str, db=None):
    """(n,) int32 keys of one ``RADIX_CASES`` case on the card."""
    import torch
    if name in ("l_orderkey", "l_partkey"):
        return torch.from_numpy(
            db.tables["lineitem"][name].astype("int32")).to(dev)
    if name == "one_bin":
        return torch.full((N_KEYS,), 12345, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    return torch.randint(-2**31, 2**31 - 1, (N_KEYS,), generator=g,
                         device=dev, dtype=torch.int32)


def time_hist(dev, keys, parts: int, hashed: bool, blk: int = BLK,
              reps: int = 20, plain: bool = False) -> dict:
    """``radix_hist`` of ``keys`` into ``parts`` bins per ``blk`` rows: the
    wrapper's ms and its device ms, the library call's, the bound; with
    ``plain`` exactness against the plain version and its ms."""
    import torch
    from repro_torch.kernels.radix_hist import ops, ref
    n = keys.shape[0]
    what = f"n={n} parts={parts} hashed={hashed}"

    def kernel():
        return ops.radix_hist(keys, parts, blk=blk, hashed=hashed)

    got = kernel()
    if not torch.equal(got, kernel()):
        raise AssertionError(f"radix_hist {what}: not byte-identical across "
                             f"runs")
    nb = got.shape[0]
    flat = (torch.arange(n, device=dev) // blk) * parts + \
        ref.bin_of(keys, parts, hashed)
    nbytes = n * 4 + nb * parts * 4
    rec = {"n": n, "parts": parts, "blk": blk, "hashed": hashed,
           "ms": time_ms(kernel, reps), "device_ms": device_ms(kernel, reps),
           "library_ms": time_ms(lambda: torch.bincount(
               flat, minlength=nb * parts), reps),
           "bytes": nbytes, "bound_ms": bound(nbytes)[0],
           "identical_across_runs": True}
    del flat
    if plain:
        if not torch.equal(got, ref.radix_hist_plain(keys, parts, blk,
                                                     hashed=hashed)):
            raise AssertionError(f"radix_hist {what}: differs from the "
                                 f"plain version")
        rec["plain_ms"] = time_ms(lambda: ref.radix_hist_plain(
            keys, parts, blk, hashed=hashed), 2)
        rec["max_abs_err"] = 0.0
    if hasattr(ops, "hist_plan"):
        rec["plan"] = ops.hist_plan(n, parts, blk,
                                    keys.data_ptr() % 16 == 0)._asdict()
    return rec


def time_radix_hist(dev, reps: int = 20, plain: bool = False) -> dict:
    """Every case of ``RADIX_CASES`` and ``RANK_CASES`` through the
    ``repro_torch`` on the path, on the CUDA device ``dev``."""
    import torch
    from repro_torch.data import tpch
    db = tpch.generate(SF, seed=SEED)
    hist = []
    for name, parts, hashed in RADIX_CASES:
        keys = case_keys(dev, name, db)
        hist.append({"keys": name, **time_hist(dev, keys, parts, hashed,
                                                reps=reps, plain=plain)})
        del keys
        torch.cuda.empty_cache()
    rank = [time_rank(dev, n, parts, reps=reps, plain=plain)
            for n, parts in RANK_CASES]
    torch.cuda.empty_cache()
    return {"radix_hist": hist, "counting_rank": rank}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plain", action="store_true",
                    help="also check and time the plain versions")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_radix_hist: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    out = time_radix_hist(torch.device("cuda:0"), args.reps, args.plain)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "reps": args.reps,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
