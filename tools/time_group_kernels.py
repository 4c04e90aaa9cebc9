#!/usr/bin/env python3
"""Time the port's grouped reductions and counting rank on one CUDA card.

    python3 tools/time_group_kernels.py [--src DIR] [--reps N] [--plain]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script times another checkout of the port, e.g. a parent commit
unpacked with ``git archive``.  It goes through the public wrappers, whose
signatures every version keeps: ``kernels.segsum.ops.segment_reduce`` (sum,
count and max) over n = 60 M rows (SF 10's lineitem) at the shapes of
``SEGSUM_CASES``, and ``kernels.radix_hist.ops.counting_rank`` at those of
``RANK_CASES`` (one rank's lineitem share at SF 1, 15 M at SF 10, all of SF
10; parts 5 and 9 are the shuffle's N + 1 at N = 4 and 8, parts 63 a width
above the single-pass limit).  Inputs come from a seeded generator on the
card: ids uniform over the groups and the dead slot, float64 values
N(0, 1e4), int64 values uniform in +-2^40, keys uniform over the parts.

Each case runs twice and must give the same bytes; with ``--plain`` it is
also held against its plain PyTorch version (float sums within rtol 1e-9,
the rest exact) and the plain version is timed.  Beside each kernel it
times the one PyTorch call that computes the same function (``index_add_``;
``bincount`` for the count; ``scatter_reduce_`` for the max; none for the
rank, where the stable sort it replaces is timed instead) and gives the
bound: each input byte read once and each output byte written once at the
card's memory rate.  Timing and bound are ``chip_smoke.py``'s ``time_ms``
and ``bound``; :func:`time_group_kernels` is what ``chip_smoke.py`` calls
for its phase-3 lines.  Prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import bound, time_ms  # noqa: E402

SEED = 11
N_ROWS = 60_000_000
# (op, groups, columns, dtype name): Q1's 8 groups x 5 sums, a scalar sum,
# a grouped float and int64 sum, the count at the direct path's largest
# domain and at a scalar aggregate's, a grouped max
SEGSUM_CASES = (("sum", 8, 5, "float64"), ("sum", 1, 1, "float64"),
                ("sum", 2049, 2, "float64"), ("sum", 2049, 2, "int64"),
                ("count", 8193, 1, "int64"), ("count", 1, 1, "int64"),
                ("max", 2049, 1, "float64"))
# (rows, parts)
RANK_CASES = tuple((n, p) for n in (1_500_000, 15_000_000, 60_000_000)
                   for p in (5, 9)) + ((15_000_000, 63),)


def _bits(t):
    import torch
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def time_segsum(dev, op: str, groups: int, ncols: int, dtype_name: str,
                n: int = N_ROWS, reps: int = 5, plain: bool = False) -> dict:
    """One ``segment_reduce`` case: kernel, library and (``plain``) plain
    ms, the bound, and the max abs error against the plain version."""
    import torch
    from repro_torch.kernels.segsum import ops, ref
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(SEED)
    gids = torch.randint(0, groups + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    if op == "count":
        vals = None
    elif dtype.is_floating_point:
        vals = torch.randn((n, ncols), generator=g, device=dev,
                           dtype=dtype) * 1e4
    else:
        vals = torch.randint(-2**40, 2**40, (n, ncols), generator=g,
                             device=dev, dtype=dtype)

    def kernel():
        return ops.segment_reduce(gids, vals, groups, op)

    out = kernel()
    if not torch.equal(_bits(out), _bits(kernel())):
        raise AssertionError(f"segment_reduce {op} G={groups} C={ncols} "
                             f"{dtype_name}: not byte-identical across runs")
    idx = gids.long()
    if op == "count":
        ones = torch.ones((n, 1), dtype=torch.int64, device=dev)

        def plain_fn():
            return ref.segment_reduce_ref(gids, ones, groups, "sum")[:, 0]

        def library():
            return torch.bincount(gids, minlength=groups + 1)

        nbytes = n * 4 + groups * 8
    elif op == "max":
        def plain_fn():
            return ref.segment_reduce_ref(gids, vals, groups, "max")

        def library():
            return torch.full((groups + 1,), float("-inf"), dtype=dtype,
                              device=dev).scatter_reduce_(0, idx, vals[:, 0],
                                                          "amax")

        nbytes = n * 4 + vals.numel() * vals.element_size() + \
            groups * ncols * vals.element_size()
    else:
        def plain_fn():
            return ref.segment_reduce_ref(gids, vals, groups, "sum")

        def library():
            return torch.zeros((groups + 1, ncols), dtype=dtype,
                               device=dev).index_add_(0, idx, vals)

        nbytes = n * 4 + vals.numel() * vals.element_size() + \
            groups * ncols * vals.element_size()
    rec = {"op": op, "n": n, "groups": groups, "cols": ncols,
           "dtype": dtype_name, "ms": time_ms(kernel, reps),
           "library_ms": time_ms(library, reps),
           "bytes": nbytes, "bound_ms": bound(nbytes)[0],
           "identical_across_runs": True}
    if plain:
        want = plain_fn()
        err = (out - want).abs().max().item()
        if dtype.is_floating_point and op == "sum":
            scale = want.abs().max().item()
            ok = torch.allclose(out, want, rtol=1e-9, atol=1e-9 * scale)
        else:
            ok = torch.equal(out, want)
        if not ok:
            raise AssertionError(f"segment_reduce {op} G={groups} C={ncols} "
                                 f"{dtype_name}: max abs err {err} against "
                                 f"the plain version")
        rec["max_abs_err"] = float(err)
        rec["plain_ms"] = time_ms(plain_fn, 2)
    return rec


def time_rank(dev, n: int, parts: int, reps: int = 5,
              plain: bool = False) -> dict:
    """One ``counting_rank`` case: kernel, stable sort and (``plain``)
    plain ms and the bound; exact against the plain version."""
    import torch
    from repro_torch.kernels.radix_hist import ops, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.randint(0, parts, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    slot, counts = ops.counting_rank(keys, parts)
    again = ops.counting_rank(keys, parts)
    if not (torch.equal(slot, again[0]) and torch.equal(counts, again[1])):
        raise AssertionError(f"counting_rank n={n} parts={parts}: not "
                             f"identical across runs")
    rec = {"n": n, "parts": parts,
           "ms": time_ms(lambda: ops.counting_rank(keys, parts), reps),
           "sort_ms": time_ms(lambda: torch.sort(keys, stable=True), reps),
           "library_ms": None, "bytes": n * 4 + n * 4 + parts * 4,
           "bound_ms": bound(n * 4 + n * 4 + parts * 4)[0],
           "identical_across_runs": True}
    if plain:
        want_slot, want_counts = ref.counting_rank_ref(keys, parts)
        if not (torch.equal(slot, want_slot) and
                torch.equal(counts, want_counts)):
            raise AssertionError(f"counting_rank n={n} parts={parts} "
                                 f"differs from the plain version")
        rec["plain_ms"] = time_ms(lambda: ref.counting_rank_ref(keys, parts),
                                  2)
    return rec


def time_group_kernels(dev, reps: int = 5, plain: bool = False) -> dict:
    """Every case of ``SEGSUM_CASES`` and ``RANK_CASES`` through the
    ``repro_torch`` on the path, on the CUDA device ``dev``."""
    import torch
    segsum = [time_segsum(dev, *case, reps=reps, plain=plain)
              for case in SEGSUM_CASES]
    torch.cuda.empty_cache()
    rank = [time_rank(dev, n, parts, reps=reps, plain=plain)
            for n, parts in RANK_CASES]
    torch.cuda.empty_cache()
    return {"segsum": segsum, "counting_rank": rank}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true",
                    help="also check and time the plain versions")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_group_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    out = time_group_kernels(torch.device("cuda:0"), args.reps, args.plain)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "reps": args.reps,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
