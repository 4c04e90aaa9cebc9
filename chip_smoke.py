#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100.  Phases:

  1. card and versions (``nvidia-smi`` name and power limit, torch, CUDA);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once) and report the build time and ptxas usage;
  3. every kernel on the card against its plain PyTorch version, at the main
     path's shapes for TPC-H SF 10: kernel, plain, library-call and bound
     times, and the float sum run twice and compared byte for byte;
  4. the main path: all 22 TPC-H queries at SF 1 through
     ``repro_torch.core.backend.run_local`` under both join methods, checked
     against the port's NumPy reference (row counts equal, rtol 1e-7), with
     the kernels' launch counters reset just before and read just after;
  5. all 22 queries at SF 10 (60 M lineitem rows resident on the card),
     under each join method one warm-up and the median of 3 timed runs per
     query, peak device memory; the hash join's results checked against the
     sorted join's, and Q1/Q6/Q13/Q15 against the reference.

It prints the card line and a ``{"kernels": [...]}`` line before the last
line, ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
exit code is nonzero.  Without CUDA, or without the repository around it, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
SF_MAIN = 1.0
SF_TIMED = 10.0
SEED = 11
REPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events over ``reps``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` at the card's memory rate.  All four
    kernels do a few integer or float operations per 8-byte word, far below
    the card's peak rates, so bytes bound every one."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_entry(name, source, replaces, ms, plain_ms, library_ms, err,
                 nbytes) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_segsum_sum(dev, gen, n: int, groups: int, ncols: int):
    """One grouped float64 sum (and the int64 count) at ``(groups, ncols)``:
    byte-identical across two runs, within 1e-9 of the plain version.
    Returns (gids, values, kernel ms, plain ms, library ms, max abs err)."""
    import torch
    from repro_torch.kernels.segsum import ops, ref
    # ids in [0, groups]: the dead slot `groups` holds ~1/(groups+1) of rows
    gids = torch.randint(0, groups + 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((n, ncols), generator=gen, device=dev,
                       dtype=torch.float64) * 1e4
    out = ops.segment_reduce(gids, vals, groups, "sum")
    again = ops.segment_reduce(gids, vals, groups, "sum")
    if not torch.equal(out.view(torch.int64), again.view(torch.int64)):
        raise AssertionError("segsum float sum is not byte-identical across runs")
    want = ref.segment_reduce_ref(gids, vals, groups, "sum")
    err = (out - want).abs().max().item()
    scale = want.abs().max().item()
    if not torch.allclose(out, want, rtol=1e-9, atol=1e-9 * scale):
        raise AssertionError(f"segsum sum: max abs err {err} (scale {scale})")
    cnt = ops.segment_reduce(gids, None, groups, "count")
    want_cnt = torch.bincount(gids, minlength=groups + 1)[:groups]
    if not torch.equal(cnt, want_cnt):
        raise AssertionError("segsum count differs from bincount")
    idx = gids.long()
    ms = time_ms(lambda: ops.segment_reduce(gids, vals, groups, "sum"))
    plain = time_ms(lambda: ref.segment_reduce_ref(gids, vals, groups, "sum"))
    lib = time_ms(lambda: torch.zeros((groups + 1, ncols), dtype=vals.dtype,
                                      device=dev).index_add_(0, idx, vals))
    cnt_ms = time_ms(lambda: ops.segment_reduce(gids, None, groups, "count"))
    log(f"segsum sum   n={n} G={groups} C={ncols} f64: kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, index_add_ {lib:.3f} ms, max abs err {err:.3e}"
        f" (scale {scale:.3e}), byte-identical across runs; "
        f"int64 count kernel {cnt_ms:.3f} ms, exact")
    return gids, vals, ms, plain, lib, err


def check_segsum(dev, n: int) -> list[dict]:
    import torch
    from repro_torch.kernels.segsum import ops, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    # Q1's shape (8 groups x 5 sums) and a scalar aggregate take the
    # per-thread-partial regime; 2^11 + 1 groups x 2 sums the per-warp one
    for groups, ncols in ((8, 5), (1, 1)):
        check_segsum_sum(dev, g, n, groups, ncols)
    groups, ncols = (1 << 11) + 1, 2
    gids, vals, ms, plain, lib, err = check_segsum_sum(dev, g, n, groups,
                                                       ncols)
    idx = gids.long()
    nbytes = n * 4 + n * ncols * 8 + groups * ncols * 8
    entries = [kernel_entry(
        "segsum_sum", "src/repro_torch/kernels/csrc/segsum.cu",
        "src/repro/kernels/segsum/kernel.py:43", ms, plain, lib, err, nbytes)]

    # min / max: order-free, must be exact
    mm = {}
    for dt in (torch.float64, torch.int64):
        v = vals[:, 0].contiguous() if dt == torch.float64 else \
            torch.randint(-2**62, 2**62, (n,), generator=g, device=dev)
        for op in ("min", "max"):
            got = ops.segment_reduce(gids, v, groups, op)
            want = ref.segment_reduce_ref(gids, v[:, None], groups, op)[:, 0]
            if not torch.equal(got, want):
                raise AssertionError(f"segsum {op} {dt} differs from plain")
        k_ms = time_ms(lambda: ops.segment_reduce(gids, v, groups, "max"))
        p_ms = time_ms(lambda: ref.segment_reduce_ref(gids, v[:, None],
                                                      groups, "max"))
        ident = float("-inf") if dt.is_floating_point else torch.iinfo(dt).min
        l_ms = time_ms(lambda: torch.full((groups + 1,), ident, dtype=dt,
                                          device=dev).scatter_reduce_(
            0, idx, v, "amax"))
        mm[dt] = (k_ms, p_ms, l_ms)
        log(f"segsum max   n={n} G={groups} {dt}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, scatter_reduce {l_ms:.3f} ms; min and "
            f"max exact")
    k_ms, p_ms, l_ms = mm[torch.float64]
    entries.append(kernel_entry(
        "segsum_minmax", "src/repro_torch/kernels/csrc/segsum.cu",
        "src/repro/kernels/segsum/kernel.py:87", k_ms, p_ms, l_ms, 0.0,
        n * 4 + n * 8 + groups * 8))
    return entries


def check_hash_insert(dev, n: int) -> dict:
    import torch
    from repro_torch.kernels.hash_group import ops, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    result = None
    for cap, distinct in ((512, 40), (8192, 3000)):
        # Q13's shape at cap 512: per-customer order counts, a few dozen
        # distinct keys; cap 8192: thousands of keys, negatives included
        pool = torch.randint(-2**40, 2**40, (distinct,), generator=g,
                             device=dev)
        keys = pool[torch.randint(0, distinct, (n,), generator=g, device=dev)]
        valid = torch.rand(n, generator=g, device=dev) < 0.9
        rounds = ops.default_rounds(cap)
        slot, dk, occ, unres = ops.build_group_dict(keys, valid, cap)
        pslot, pdk, pocc, punres = ref.hash_insert_ref(keys, valid, cap,
                                                       rounds)

        def dense(s, d, o):
            rank = ops.dict_rank(d, o)
            return torch.where(s >= 0, rank[s.clamp(min=0).long()], -1)

        if bool(unres) != bool(punres):
            raise AssertionError(f"hash_insert cap {cap}: unresolved differs")
        if not torch.equal(dense(slot, dk, occ), dense(pslot, pdk, pocc)):
            raise AssertionError(f"hash_insert cap {cap}: dense ids differ")
        if not torch.equal(torch.sort(dk[occ]).values,
                           torch.sort(pdk[pocc]).values):
            raise AssertionError(f"hash_insert cap {cap}: key sets differ")
        ms = time_ms(lambda: ops.build_group_dict(keys, valid, cap))
        plain = time_ms(lambda: ref.hash_insert_ref(keys, valid, cap, rounds),
                        reps=2)
        lib = time_ms(lambda: torch.unique(keys[valid], return_inverse=True))
        log(f"hash_insert  n={n} cap={cap} keys={distinct}: kernel {ms:.3f} "
            f"ms, plain {plain:.3f} ms, torch.unique {lib:.3f} ms; dense ids "
            f"exact")
        if cap == 512:
            result = kernel_entry(
                "hash_insert", "src/repro_torch/kernels/csrc/hash_group.cu",
                "src/repro/kernels/hash_group/kernel.py:100", ms, plain, lib,
                0.0, n * (8 + 1 + 4) + cap * 12)
    return result


def check_hash_probe(dev, n: int, m: int) -> dict:
    import torch
    from repro_torch.kernels.hash_probe import ops, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    build = torch.randperm(m, generator=g, device=dev) + 1       # orderkeys
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    buckets = max(128, ops.next_pow2(2 * m) // 4)
    bk_lo, bk_hi, bv, ov = ops.build_bucket_table64(build, rows, buckets,
                                                   cap=16)
    if bool(ov):
        raise AssertionError("hash_probe build overflowed")
    probe = torch.randint(1, m + m // 10, (n,), generator=g, device=dev)
    got = ops.hash_probe64(probe, bk_lo, bk_hi, bv)
    chunk = 10_000_000

    def plain():
        return torch.cat([ref.hash_probe64_ref(probe[i:i + chunk], bk_lo,
                                               bk_hi, bv)
                          for i in range(0, n, chunk)])

    want = plain()
    if not torch.equal(got, want):
        raise AssertionError("hash_probe64 differs from plain")
    hit = got >= 0
    if not torch.equal(build[got[hit].long()], probe[hit]) or \
            int(hit.sum()) != int((probe <= m).sum()):
        raise AssertionError("hash_probe64 matched wrong rows")
    ms = time_ms(lambda: ops.hash_probe64(probe, bk_lo, bk_hi, bv))
    plain_ms = time_ms(plain, reps=2)
    # what a probe must move: each key read, each row written, and each
    # occupied lane (lo, hi, row) read once; empty lanes carry nothing
    occupied = int((bv >= 0).sum())
    nbytes = n * (8 + 4) + occupied * 12
    log(f"hash_probe64 n={n} build={m} B={buckets} C=16 occupied={occupied}: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (no single library "
        f"call), bound {bound_ms(nbytes):.3f} ms; exact")
    return kernel_entry(
        "hash_probe64", "src/repro_torch/kernels/csrc/hash_probe.cu",
        "src/repro/kernels/hash_probe/kernel.py:87", ms, plain_ms, None, 0.0,
        nbytes)


# ---------------------------------------------------------------------------
# phases 4 and 5: the queries
# ---------------------------------------------------------------------------

def compare(got: dict, want: dict, label: str) -> None:
    """The reference package's rule: row counts equal, floats rtol 1e-7."""
    import numpy as np
    keys = set(got) & set(want)
    if not keys:
        raise AssertionError(f"{label}: no common output columns")
    n = len(next(iter(want.values())))
    for k in sorted(keys):
        if len(got[k]) != n:
            raise AssertionError(f"{label} {k}: {len(got[k])} rows, want {n}")
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(want[k], dtype=np.float64),
                                   rtol=1e-7, err_msg=f"{label} {k}")


def run_main_path(dev) -> dict[str, int]:
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.data import tpch
    from repro_torch.queries import QUERIES
    t0 = time.perf_counter()
    db = tpch.generate(SF_MAIN, seed=SEED)
    t1 = time.perf_counter()
    refs = {q: B.run_reference(QUERIES[q], db)[0] for q in sorted(QUERIES)}
    t2 = time.perf_counter()
    log(f"SF {SF_MAIN}: generated in {t1 - t0:.1f} s, NumPy reference of 22 "
        f"queries in {t2 - t1:.1f} s")
    K.reset_launches()
    for jm in ("sorted", "hash"):
        t3 = time.perf_counter()
        for q in sorted(QUERIES):
            got, _ = B.run_local(QUERIES[q], db, join_method=jm, device=dev)
            compare(got, refs[q], f"SF {SF_MAIN} q{q} join={jm}")
        log(f"SF {SF_MAIN}: 22 queries join={jm} equal the reference "
            f"({time.perf_counter() - t3:.1f} s with the first upload)")
    counts = dict(K.launches)
    log(f"launches on the main path (SF {SF_MAIN}, 22 queries x 2 joins): "
        f"{json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    del db
    torch.cuda.empty_cache()
    return counts


def run_timed(dev) -> None:
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.data import tpch
    from repro_torch.queries import QUERIES
    t0 = time.perf_counter()
    db = tpch.generate(SF_TIMED, seed=SEED)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    B.device_tables(db, dev)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    resident = torch.cuda.memory_allocated(dev)
    log(f"SF {SF_TIMED}: generated in {t1 - t0:.1f} s, "
        f"{len(db.tables['lineitem']['l_orderkey'])} lineitem rows, "
        f"{resident / 1e9:.2f} GB resident after upload ({t2 - t1:.1f} s)")
    medians = {jm: {} for jm in ("sorted", "hash")}
    results, launches = {}, {}
    for jm, times in medians.items():
        K.reset_launches()
        for q in sorted(QUERIES):
            got, _ = B.run_local(QUERIES[q], db, join_method=jm,
                                 device=dev)                       # warm-up
            if jm == "sorted":
                results[q] = got
            else:
                compare(got, results[q], f"SF {SF_TIMED} q{q} join=hash")
            runs = []
            for _ in range(REPS):
                s = time.perf_counter()
                B.run_local(QUERIES[q], db, join_method=jm, device=dev)
                runs.append((time.perf_counter() - s) * 1e3)
            times[q] = statistics.median(runs)
        launches[jm] = dict(K.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    lines = [f"SF {SF_TIMED} q{q}: median of {REPS}, join=sorted "
             f"{medians['sorted'][q]:.2f} ms, join=hash "
             f"{medians['hash'][q]:.2f} ms" for q in sorted(QUERIES)]
    for line in lines:
        log(line)
    for jm, times in medians.items():
        log(f"SF {SF_TIMED} join={jm}: total of medians "
            f"{sum(times.values()):.1f} ms; launches "
            f"{json.dumps(launches[jm])}")
    log(f"SF {SF_TIMED}: peak device memory {peak / 1e9:.2f} GB; join=hash "
        f"results equal join=sorted")
    for q in (1, 6, 13, 15):
        s = time.perf_counter()
        want, _ = B.run_reference(QUERIES[q], db)
        compare(results[q], want, f"SF {SF_TIMED} q{q}")
        log(f"SF {SF_TIMED} q{q} equals the reference "
            f"(reference {time.perf_counter() - s:.1f} s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K

    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    secs = K.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s")
    for name, text in K.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    n_li = 60_000_000          # SF 10 lineitem rows
    entries = check_segsum(dev, n_li)
    entries.append(check_hash_insert(dev, 1_500_000))
    entries.append(check_hash_probe(dev, n_li, 15_000_000))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    counts = run_main_path(dev)
    for e in entries:
        e["launches"] = counts[e["name"]]
    run_timed(dev)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
