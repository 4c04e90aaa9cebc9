#!/usr/bin/env python3
"""Time the port's group-dictionary insert and 32-bit hash probe on one CUDA
card.

    python3 tools/time_hash_kernels.py [--src DIR] [--reps N] [--plain]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script times another checkout of the port, e.g. a parent commit
unpacked with ``git archive``.  It goes through the public wrappers, whose
signatures every version keeps:

* ``kernels.hash_group.ops.build_group_dict`` at the cases of
  ``INSERT_CASES``: 1.5 M rows into 512 slots with 40 distinct keys (90 %
  of rows valid), Q13's own keys at TPC-H SF 10 (each customer's count of
  orders whose comment is not like '%special%requests%', a third of them 0;
  512 slots, as Q13's ``groups_hint`` 256 sizes them), and 1.5 M rows into
  8192 slots with 3000 keys.  Beside the wrapper's time, its device time
  alone (:func:`device_ms`: the change's memset and kernel, the parent's
  every launch), the host time a call takes to return (no synchronize),
  and
  ``torch.unique(return_inverse=True)`` as the library call; where the
  version has two designs (``insert_design``), the other one too, also at
  the caps of ``INSERT_SWEEP`` in between;
* ``kernels.hash_probe.ops.hash_probe32`` over SF 10's l_orderkey (60 M)
  probing o_orderkey (15 M) as int32, at each cap that
  ``hash_join_probe_auto`` builds there (8, 16, 32, 64; B = 2^25 / cap).
  Every version is timed without the build's fill counts; a version that
  takes them (``counts=``) also with them, and in each of its designs
  (``probe32_plan``'s choice, and the loop and scalar designs each with
  and without reading the fill counts).
  Beside them the bound (each probe key read and row written once, each
  occupied lane's key and row read once) and the layout's own floor: once
  per distinct (warp of 32 probes, bucket), the key row rounded up to
  32-byte sectors and one 32-byte row sector, plus 8 bytes a probe; with
  fill counts, only the filled lanes' sectors and the count's sector.

First, Q13 at SF 10 through ``run_local`` under each join method, the
path that launches the insert: the median of 5 runs after a warm-up.

With ``--plain`` each case is also held against its plain PyTorch version
(the insert: dense ids, key set and unresolved flag; the probe: bit for bit)
and the plain version is timed.  SF 10 is generated in each run.  Timing and
bound are ``chip_smoke.py``'s ``time_ms`` and ``bound``; ``chip_smoke.py``
calls :func:`time_insert` and :func:`time_probe32` for its phase-3 and
phase-8 lines.  Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import bound, time_ms  # noqa: E402

SEED = 11
SF = 10.0
N_INSERT = 1_500_000
# (name, cap, distinct keys): Q13's keys have their own count
INSERT_CASES = (("uniform", 512, 40), ("q13_sf10", 512, None),
                ("uniform", 8192, 3000))
# the two designs side by side between those caps, at 8192's load of keys
INSERT_SWEEP = tuple(("uniform", cap, cap * 3000 // 8192)
                     for cap in (1024, 2048, 4096))
PROBE_CAPS = (8, 16, 32, 64)


def q13_keys(db):
    """Q13's group keys: per customer, its count of orders whose comment is
    not like '%special%requests%' (0 for a customer without such orders),
    the c_count column its final group-by inserts, int64."""
    import numpy as np
    special = np.array([re.search("special.*requests", s) is not None
                        for s in db.dicts["o_comment"]])
    orders = db.tables["orders"]
    keep = ~special[orders["o_comment"]]
    n_cust = len(db.tables["customer"]["c_custkey"])
    return np.bincount(orders["o_custkey"][keep],
                       minlength=n_cust + 1)[1:].astype(np.int64)


def time_q13(dev, db, reps: int = 5) -> dict:
    """Q13 through ``run_local`` under each join method: the median ms of
    ``reps`` runs after a warm-up (host clock; the call ends by reading its
    result to the host), and ``hash_insert``'s launches in one run."""
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.queries import QUERIES
    out = {}
    for jm in ("sorted", "hash"):
        K.reset_launches()
        B.run_local(QUERIES[13], db, join_method=jm, device=dev)
        launches = K.launches["hash_insert"]
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            B.run_local(QUERIES[13], db, join_method=jm, device=dev)
            runs.append((time.perf_counter() - t0) * 1e3)
        out[jm] = {"median_ms": statistics.median(runs), "runs_ms": runs,
                   "hash_insert_launches": launches}
    return out


def device_ms(fn, reps: int) -> float:
    """Device time (ms) of one call of ``fn``, from CUDA events around
    ``reps`` calls enqueued behind a sleeping kernel: the stream is busy
    until every launch is queued, so the host's time between launches does
    not count, and what remains is the device work of the calls' own
    launches (for a wrapper whose host time exceeds its device time, as the
    insert's does)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)             # ~5 ms at the card's clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def insert_inputs(dev, cap: int, distinct, q13=None):
    """(keys, valid) of one ``INSERT_CASES`` case on the card."""
    import torch
    if distinct is None:
        keys = torch.from_numpy(q13).to(dev)
        return keys, torch.ones_like(keys, dtype=torch.bool)
    g = torch.Generator(device=dev).manual_seed(SEED + cap)
    pool = torch.randint(-2**40, 2**40, (distinct,), generator=g, device=dev)
    keys = pool[torch.randint(0, distinct, (N_INSERT,), generator=g,
                              device=dev)]
    return keys, torch.rand(N_INSERT, generator=g, device=dev) < 0.9


def time_insert(dev, keys, valid, cap: int, reps: int = 5,
                plain: bool = False) -> dict:
    """``build_group_dict`` of (n,) int64 ``keys`` into ``cap`` slots: the
    wrapper's and the kernel's ms, the library call's, the bound, the
    distinct keys, and with ``plain`` the checks against the plain version
    and its ms.  Where the version chooses a design by ``cap``
    (``insert_design``), the other design is timed too."""
    import torch
    from repro_torch.kernels.hash_group import ops, ref
    n = keys.shape[0]
    nbytes = n * (8 + 1 + 4) + cap * 12
    ops.build_group_dict(keys, valid, cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * reps):
        ops.build_group_dict(keys, valid, cap)
    host_ms = (time.perf_counter() - t0) * 1e3 / (4 * reps)
    torch.cuda.synchronize()
    rec = {"n": n, "cap": cap, "host_ms": host_ms,
           "distinct": int(torch.unique(keys[valid]).numel()),
           "ms": time_ms(lambda: ops.build_group_dict(keys, valid, cap), reps),
           "device_ms": device_ms(lambda: ops.build_group_dict(keys, valid,
                                                               cap), reps),
           "library_ms": time_ms(lambda: torch.unique(
               keys[valid], return_inverse=True), reps),
           "bytes": nbytes, "bound_ms": bound(nbytes)[0]}
    if hasattr(ops, "insert_design"):
        rec["design"] = chosen = ops.insert_design(cap)
        rec[f"{chosen}_ms"] = rec["ms"]
        other = "global" if chosen == "shared" else "shared"
        if other == "global" or 12 * cap <= ops.SHARED_BYTES:
            saved = ops.insert_design          # the other design beside it
            ops.insert_design = lambda cap: other
            try:
                if plain:
                    check_insert(keys, valid, cap, ops, ref)
                rec[f"{other}_ms"] = time_ms(
                    lambda: ops.build_group_dict(keys, valid, cap), reps)
                rec[f"{other}_device_ms"] = device_ms(
                    lambda: ops.build_group_dict(keys, valid, cap), reps)
            finally:
                ops.insert_design = saved
    if plain:
        check_insert(keys, valid, cap, ops, ref)
        rounds = ops.default_rounds(cap)
        rec["plain_ms"] = time_ms(
            lambda: ref.hash_insert_ref(keys, valid, cap, rounds), 2)
        rec["max_abs_err"] = 0.0
    return rec


def check_insert(keys, valid, cap, ops, ref) -> None:
    """Dense ids, key sets and unresolved flags equal the plain version's."""
    import torch
    slot, dk, occ, unres = ops.build_group_dict(keys, valid, cap)
    pslot, pdk, pocc, punres = ref.hash_insert_ref(
        keys, valid, cap, ops.default_rounds(cap))

    def dense(s, d, o):
        rank = ops.dict_rank(d, o)
        return torch.where(s >= 0, rank[s.clamp(min=0).long()], -1)

    what = f"hash_insert cap {cap}"
    if bool(unres) != bool(punres):
        raise AssertionError(f"{what}: unresolved differs")
    if not torch.equal(dense(slot, dk, occ), dense(pslot, pdk, pocc)):
        raise AssertionError(f"{what}: dense ids differ")
    if not torch.equal(torch.sort(dk[occ]).values,
                       torch.sort(pdk[pocc]).values):
        raise AssertionError(f"{what}: key sets differ")


def layout_floor(probe, bkeys, fill=None) -> int:
    """Bytes the (B, C) layout makes the probe move at least: once per
    distinct (warp of 32 probes, bucket) the key row (with ``fill``: its
    filled lanes, and the fill count's sector) rounded up to 32-byte
    sectors and one 32-byte row sector, plus 8 bytes a probe."""
    import torch
    from repro_torch.kernels.hash_probe.ref import bucket_of32
    buckets, cap = bkeys.shape
    n = probe.shape[0]
    warp = torch.arange(n, device=probe.device) // 32
    b = torch.unique(warp * buckets + bucket_of32(probe, buckets)) % buckets
    lanes = torch.full_like(b, cap) if fill is None else fill[b].long()
    sectors = (lanes * 4 + 31) // 32 + 1 + (0 if fill is None else 1)
    return int(sectors.sum()) * 32 + n * 8


def time_probe32(dev, probe, build, cap: int, reps: int = 5,
                 plain: bool = False) -> dict:
    """``hash_probe32`` of int32 ``probe`` keys into the table that
    ``hash_join_probe`` builds from ``build`` at ``cap``: ms without fill
    counts, and where the version takes them with them and per design;
    the bound and the layout's floors; with ``plain`` bit-equality with the
    plain version and its ms."""
    import torch
    from repro_torch.kernels.hash_probe import ops, ref
    n, m = probe.shape[0], build.shape[0]
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    buckets = max(128, ops.next_pow2(2 * m) // cap)
    bkeys, bvals, overflowed = ops.build_bucket_table(build, rows, buckets,
                                                      cap)
    occupied = int((bvals >= 0).sum())
    fill = torch.clamp(torch.bincount(ref.bucket_of32(build, buckets),
                                      minlength=buckets),
                       max=cap).to(torch.int32)
    nbytes = n * (4 + 4) + occupied * 8
    floor = layout_floor(probe, bkeys)
    rec = {"n": n, "build": m, "buckets": buckets, "cap": cap,
           "occupied": occupied, "overflowed": bool(overflowed),
           "ms": time_ms(lambda: ops.hash_probe32(probe, bkeys, bvals), reps),
           "device_ms": device_ms(lambda: ops.hash_probe32(probe, bkeys,
                                                           bvals), reps),
           "library_ms": None, "bytes": nbytes, "bound_ms": bound(nbytes)[0],
           "floor_bytes": floor, "floor_ms": bound(floor)[0]}
    counts_ok = "counts" in inspect.signature(ops.hash_probe32).parameters
    want = None
    if plain:
        chunk = 10_000_000

        def plain_fn():
            return torch.cat([ref.hash_probe32_ref(probe[i:i + chunk], bkeys,
                                                   bvals)
                              for i in range(0, n, chunk)])
        want = plain_fn()
        if not torch.equal(ops.hash_probe32(probe, bkeys, bvals), want):
            raise AssertionError(f"hash_probe32 cap {cap} differs from plain")
        rec["plain_ms"] = time_ms(plain_fn, 2)
        rec["max_abs_err"] = 0.0
    if counts_ok:
        floor_f = layout_floor(probe, bkeys, fill)
        rec.update(floor_filled_bytes=floor_f,
                   floor_filled_ms=bound(floor_f)[0],
                   counts_ms=time_ms(lambda: ops.hash_probe32(
                       probe, bkeys, bvals, fill), reps))
        designs = {"plan": ops.probe32_plan(cap)}
        for design in ("loop", "scalar") if cap % 4 == 0 else ("scalar",):
            for counts in (True, False):
                designs[f"{design}, counts {counts}"] = \
                    ops.Probe32Plan(design, counts)
        saved = ops.probe32_plan
        rec["designs"] = {}
        try:
            for name, plan in designs.items():
                ops.probe32_plan = lambda cap, aligned=True, plan=plan: plan
                got = ops.hash_probe32(probe, bkeys, bvals, fill)
                if want is not None and not torch.equal(got, want):
                    raise AssertionError(f"hash_probe32 cap {cap} {name} "
                                         f"differs from plain")
                rec["designs"][name] = {
                    "plan": dataclasses.asdict(plan),
                    "ms": time_ms(lambda: ops.hash_probe32(
                        probe, bkeys, bvals, fill), reps)}
        finally:
            ops.probe32_plan = saved
    return rec


def time_hash_kernels(dev, reps: int = 5, plain: bool = False) -> dict:
    """Q13 at SF 10 end to end, then every case of ``INSERT_CASES``,
    ``INSERT_SWEEP`` and ``PROBE_CAPS``, through the ``repro_torch`` on the
    path, on the CUDA device ``dev``."""
    import torch
    from repro_torch.core import planner
    from repro_torch.data import tpch
    db = tpch.generate(SF, seed=SEED)
    q13 = time_q13(dev, db, reps)
    planner.invalidate_stats(db)        # frees the resident tables
    torch.cuda.empty_cache()
    inserts = []
    for name, cap, distinct in INSERT_CASES + INSERT_SWEEP:
        keys, valid = insert_inputs(dev, cap, distinct, q13_keys(db))
        inserts.append({"case": name, **time_insert(dev, keys, valid, cap,
                                                     reps, plain)})
    probe = torch.from_numpy(db.tables["lineitem"]["l_orderkey"]
                             .astype("int32")).to(dev)
    build = torch.from_numpy(db.tables["orders"]["o_orderkey"]
                             .astype("int32")).to(dev)
    probes = [time_probe32(dev, probe, build, cap, reps, plain)
              for cap in PROBE_CAPS]
    torch.cuda.empty_cache()
    return {"q13": q13, "hash_insert": inserts, "hash_probe32": probes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true",
                    help="also check and time the plain versions")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_hash_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    out = time_hash_kernels(torch.device("cuda:0"), args.reps, args.plain)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "reps": args.reps,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
