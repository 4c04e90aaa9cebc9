#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100.  Phases:

  1. card and versions (``nvidia-smi`` name and power limit, torch, CUDA);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once) and report the build time and ptxas usage;
  3. every kernel on the card against its plain PyTorch version, at the main
     path's shapes for TPC-H SF 10: kernel, plain, library-call and bound
     times.  Through ``tools/time_group_kernels.py``: the grouped sums of
     60 M rows into (8, 5), (1, 1), (2049, 2) float64 and (2049, 2) int64,
     the count into 8193 groups and into 1, the float64 max into 2049, and
     the counting rank at 1.5 M, 15 M and 60 M rows for the shuffle's parts
     5 and 9 and at parts 63 (three passes), each run twice and compared
     byte for byte; the grouped min and max of float64 and int64, exact;
     through ``tools/time_hash_kernels.py``, the group-dictionary insert
     at 1.5 M rows into 512 slots (40 keys, and Q13's own SF 10 keys) and
     into 8192 slots (3000 keys), in both designs, against the plain
     version; the 64-bit hash probe's build, probe and both timed, beside
     the sorted index over the same keys; through
     ``tools/time_radix_hist.py``, the partition histogram over SF 10's
     l_orderkey into 8 partitions, hashed and not, exact and
     byte-identical across runs; then ``skew_stats`` of SF 10's l_partkey
     over 8 partitions, the path that launches the histogram (once);
  4. the main path: all 22 TPC-H queries at SF 1 through
     ``repro_torch.core.backend.run_local`` under both join methods, checked
     against the port's NumPy reference (row counts equal, rtol 1e-7), with
     the kernels' launch counters reset just before and read just after,
     and each query's sorts counted (``core/sortcount.SortCounter``),
     printed per join method and held to the planner-off budget of
     ``sortcount.MAX_SORTS``; then the 22 plans the SQL frontend compiles
     from ``src/repro_torch/queries/sql`` (``repro_torch.sql``) under both
     join methods, each equal to the hand-built plan's result (integer
     columns byte for byte, floats within rtol 1e-7; how many are
     byte-identical throughout is printed);
  5. all 22 queries at SF 10 (60 M lineitem rows resident on the card),
     under each join method one warm-up and the median of 3 timed runs per
     query, peak device memory, and each query's device busy time from one
     profiled run (sorted joins); the hash join's results checked against
     the sorted join's, and Q1/Q6/Q13/Q15 against the reference; then one
     run of each SQL-compiled plan (sorted joins), equal to the hand-built
     plan's;
  6. the distributed path: all 22 queries at SF 1 through
     ``run_distributed`` on a ThreadGroup of N ranks on the one card (N = 4
     and 8 with sorted joins, N = 4 with hash joins), each equal to phase
     4's reference with exchange counts equal to the plans' static counts,
     narrow wire equal to wide byte for byte on Q9/Q10/Q13/Q18, launch
     counters reset just before and read just after, every counting rank
     of the phase run by the single-pass kernel;
  7. all 22 queries at SF 10 through ``run_distributed`` with N = 4 (sorted
     joins): partition and upload time, one warm-up and the median of 3
     timed runs per query, each query's device busy time from one profiled
     run, peak device memory, each result equal to phase 5's.  The ranks'
     work is serialised on one card: these are times of the distributed
     code path, not of a cluster;
 7b. recovery (``repro_torch.distributed``) at SF 10 on Q5, Q9 and Q18,
     with launch counters reset just before and read just after: the
     default fault plan (a transient, a corrupt and an overflow) through
     ``QueryRunner`` on a ThreadGroup of 4, each fault fired, the corrupt
     one a real bit flip of a checksummed exchange on the card where the
     plan's first group-by exchanges (Q5, Q9), the final attempt
     byte-identical to a clean run with its wire format and capacity
     factor; a device loss 4 -> 3 (rank 3 at the first exchange), the
     recovered result byte-identical to a clean run on 3 ranks and equal to
     phase 5's, with each attempt's wall time, the resident GB before and
     after the shrink and the re-partition and upload time at N = 3; then
     lineage snapshots (``run_resumable`` on the card, a ``LineageStore``
     under ``build/``): snapshot count, bytes and write time, a resumed run
     byte-identical and reusing a snapshot, full re-execution and resume
     times, and a store written at width 8 resumed at 5 (re-sharded).  The
     snapshot bytes are reckoned from SF 1's snapshots before the first
     write; above ``LINEAGE_MAX_BYTES`` the lineage part runs at SF 1;
  7c. serving and approximate answers (``repro_torch.serve``,
     ``repro_torch.approx``) on the SF 10 tables, uploaded once, with launch
     counters reset just before and read just after: the reference's
     29-request stream (every sample of the 22 standing templates) through
     ``QueryServer`` — a cold pass (22 preparations, each timed), 3 warm
     passes (no preparation, every warm request a cache hit; per-request
     median, stream total, requests/s, the device busy share of one
     profiled pass), every served result byte-identical to ``run_local`` of
     the same bound template and the ``samples[0]`` results equal to phase
     5's, then ``degrade(3)`` and a pass with exactly 22 more preparations;
     ``BatchExecutor`` over the stream, its memo's peak reckoned from SF 1
     first and run at SF 10 where it fits under ``BATCH_MAX_BYTES`` with
     the resident tables, each result byte-identical to the request run
     alone; Q1 and Q6 on every rung of the sample ladder (host build time,
     rung GB, warm wall, max relative CI half-width, the share of cells
     whose interval covers phase 5's exact answer, beside the exact plan's
     wall), rung 1 byte-identical to the exact plan, widths that never grow
     with the sample, ``ProgressiveRunner`` and
     ``QueryServer.submit(tolerance=)`` answering at the same rung, Q18
     refused on every sampled rung and served exact; at SF 1 every rung of
     Q1, Q6 and a shuffled per-supplier revenue on a ThreadGroup of 4 equal
     to the same rung on one device (the counting rank launched), and the
     stream under hash joins equal to the sorted server's (the 64-bit probe
     launched); ``footprint_bytes()`` beside the resident and peak GB;
  8. with the SF 10 tables freed: the 32-bit hash probe against its plain
     version, bit for bit, over SF 10's l_orderkey (60 M) probing
     o_orderkey (15 M) as int32 at caps 8, 16, 32 and 64, every design with
     and without fill counts, timed beside each cap's layout floor, then
     ``hash_join_probe_auto``, the path that launches it (once), equal to
     the sorted-build oracle; flash
     attention against its plain version at the LM path's shape (B 2,
     Hq 32, Hkv 8, S 4096, D 128, causal): float32 (the CUDA-core design)
     within 1e-5, bf16 (the tensor-core design) within one output rounding
     element by element and 2e-2 max abs, with
     ``F.scaled_dot_product_attention`` timed beside it as the yardstick;
     then the tensor-core design at head sizes 64 and 256 (S 1024, both
     masks) under the same limits;
  9. the LM path at full width and depth: Mistral-Nemo-12B, 40 layers, bf16,
     weights from a seeded generator on the card.  ``Model.forward`` of
     B 2 x S 4096 through the flash kernel (40 launches a call, all of the
     tensor-core design; one warm-up
     and the median of 3, the device busy share of one profiled call);
     prefill's last-token logits against forward's at B 1 x S 1024;
     ``serve_lm.generate`` of 32 tokens for 4 prompts of 512 (prefill ms,
     decode ms a step, tokens/s); peak device memory; then the same weights
     in float32 at B 1 x S 1024: logits with the kernel against logits
     without it (relative L2 <= 1e-4, top-1 agreement >= 0.99) and
     prefill's last-token logits against forward's (relative L2 <= 1e-4,
     argmax equal), beside the bf16 comparisons and the bf16 plain path
     against the float32 one: in bf16, rounding alone moves the plain path
     about as far, so the bf16 kernel path, and bf16 prefill against
     forward, must lie no further than 1.1x that.

It prints the card line and a ``{"kernels": [...]}`` line before the last
line, ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
exit code is nonzero.  Without CUDA, or without the repository around it, it
exits nonzero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores, same
SF_MAIN = 1.0
SF_TIMED = 10.0
SEED = 11
REPS = 3
# phase 7b: the queries the reference's recovery benchmark gates, and the
# most snapshot bytes the lineage part writes at SF 10
RECOVERY_QUERIES = (5, 9, 18)
LINEAGE_MAX_BYTES = 16e9
# phase 7c: the queries answered off the sample ladder, the most device
# memory the batch's memo may reach beside the resident SF 10 tables (above
# it the batch runs at SF 1), and the tolerance of the served approximate
# answers
APPROX_QUERIES = (1, 6)
BATCH_MAX_BYTES = 60e9
APPROX_TOLERANCE = 0.01
# phases 8 and 9: the LM path's attention shape (B, Hq, Hkv, S, D), its
# config, the forward's (B, S), the sequence of the logit comparisons, and
# generate's (batch, prompt length, new tokens)
FLASH_SHAPE = (2, 32, 8, 4096, 128)
LM_ARCH = "mistral_nemo_12b"
LM_FORWARD = (2, 4096)
LM_COMPARE_SEQ = 1024
LM_GENERATE = (4, 512, 32)
# flash attention against its plain version: float32 runs the same
# arithmetic in another order (atol = rtol); bf16 rounds each side's float32
# result once (unit roundoff 2^-8 each, so 2^-7 of |want| between them, plus
# the float32 tolerance), and the float32 difference survives near zero
FLASH_F32_TOL = 1e-5
FLASH_BF16_RTOL = 8e-3
FLASH_BF16_ATOL = 2e-5
# phase 9 in float32: logits with the kernel against without it, and
# prefill's last-token logits against forward's (readings 3.1e-6 and 0; bf16
# rounding alone moves the logits 1.77e-2)
LM_F32_REL_L2 = 1e-4


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


def device_time_by_kernel(fn) -> dict[str, float]:
    """Device time (ms) of everything ``fn`` ran on the card, summed by
    kernel or copy name over the device events of a ``torch.profiler``
    trace (one stream, so they never overlap).  Every measured run launches
    work on the card, so a trace with no device time means the profiler
    failed: that raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    if sum(by_name.values()) <= 0:
        raise RuntimeError("torch.profiler recorded no device time for a run "
                           "that launched work on the card")
    return by_name


def device_busy_ms(fn) -> float:
    """Device time (ms) of everything ``fn`` ran on the card."""
    return sum(device_time_by_kernel(fn).values())


def busy_line(label: str, busy: float, median_ms: float) -> str:
    return (f"{label}: device busy {busy:.2f} ms of {median_ms:.2f} ms "
            f"median, idle share {1 - busy / median_ms:.3f}")


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it: the larger of
    ``nbytes`` at the card's memory rate ("bytes") and ``flops`` at its
    dense bf16 rate ("operations").  The six query-engine kernels and the
    32-bit probe do a few integer or float operations per 8-byte word, far
    below the peak rates, so bytes bound them (``flops`` 0); flash attention
    does ~2 S D multiply-adds per element it reads, so operations bound it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, \
        "operations" if by_ops > by_bytes else "bytes"


def kernel_entry(name, source, replaces, ms, plain_ms, library_ms, err,
                 nbytes, flops: float = 0.0) -> dict:
    least, by = bound(nbytes, flops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": least, "bound_by": by,
            "library_ms": library_ms}


def check_tensor_core_sass(K) -> None:
    """The built flash attention library holds warpgroup tensor-core
    products (``HGMMA`` in its SASS), or the tensor-core design is not
    what was compiled."""
    cuobjdump = Path(K.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(K.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    hgmma = [line.strip() for line in sass.splitlines() if "HGMMA" in line]
    if not hgmma:
        raise AssertionError("no HGMMA in the flash attention library")
    shapes = sorted({line.split()[1] for line in hgmma})
    log(f"cuobjdump -sass flash_attention: {len(hgmma)} HGMMA instructions "
        f"({', '.join(shapes)}), e.g. {hgmma[0]}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_group_kernels(dev) -> list[dict]:
    """The grouped reductions (``SEGSUM_CASES``: n 60 M summed into (8, 5),
    (1, 1), (2049, 2) float64 and (2049, 2) int64, counted into 8193 and 1,
    the float64 max into 2049) and the counting rank (``RANK_CASES``: 1.5 M,
    15 M, 60 M rows at parts 5 and 9, and 15 M at parts 63, above the
    single-pass width) through ``tools/time_group_kernels.py``: each
    byte-identical across two runs, float sums within 1e-9 of the plain
    version and the rest exact, timed beside the plain version, the library
    call and the bound.  Returns the entries of segsum_sum (2049 x 2
    float64), segsum_count (8193), segsum_minmax and counting_rank (15 M,
    parts 5: one rank's SF 10 share at N = 4)."""
    sys.path.insert(0, str(ROOT / "tools"))
    from time_group_kernels import time_group_kernels
    res = time_group_kernels(dev, plain=True)
    picked = {}
    libs = {"sum": "index_add_", "count": "bincount",
            "max": "scatter_reduce_"}
    for r in res["segsum"]:
        what = "count" if r["op"] == "count" else f"{r['op']} {r['dtype']}"
        lib = libs[r["op"]]
        log(f"segsum {what} n={r['n']} G={r['groups']} C={r['cols']}: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, {lib} "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms, max abs "
            f"err {r['max_abs_err']:.3e}; byte-identical across runs")
        key = (r["op"], r["groups"], r["cols"], r["dtype"])
        if key == ("sum", 2049, 2, "float64"):
            picked["segsum_sum"] = r
        elif key == ("count", 8193, 1, "int64"):
            picked["segsum_count"] = r
        elif r["op"] == "max":
            picked["segsum_minmax"] = r
    for r in res["counting_rank"]:
        from repro_torch.kernels.radix_hist import ops as rh
        log(f"counting_rank n={r['n']} parts={r['parts']} "
            f"({rh.rank_design(r['parts'] + 1)}): kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms; "
            f"torch.sort(stable) {r['sort_ms']:.3f} ms (the sort it "
            f"replaces, no single call computes the rank); exact")
        if (r["n"], r["parts"]) == (15_000_000, 5):
            picked["counting_rank"] = r
    sources = {"segsum_sum": ("segsum.cu", "segsum/kernel.py:43"),
               "segsum_count": ("segsum.cu", "segsum/kernel.py:43"),
               "segsum_minmax": ("segsum.cu", "segsum/kernel.py:87"),
               "counting_rank": ("radix_hist.cu", "radix_hist/kernel.py:124")}
    return [kernel_entry(
        name, f"src/repro_torch/kernels/csrc/{src}",
        f"src/repro/kernels/{tpu}", picked[name]["ms"],
        picked[name]["plain_ms"], picked[name]["library_ms"],
        picked[name].get("max_abs_err", 0.0), picked[name]["bytes"])
        for name, (src, tpu) in sources.items()]


def check_segsum_minmax(dev, n: int) -> None:
    """Grouped min and max of n rows into 2049 groups, float64 and int64,
    exact against the plain version (``check_group_kernels`` times the
    float64 max)."""
    import torch
    from repro_torch.kernels.segsum import ops, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    groups = (1 << 11) + 1
    # ids in [0, groups]: the dead slot `groups` holds ~1/(groups+1) of rows
    gids = torch.randint(0, groups + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    for dt in (torch.float64, torch.int64):
        v = torch.randn(n, generator=g, device=dev, dtype=dt) * 1e4 \
            if dt == torch.float64 else \
            torch.randint(-2**62, 2**62, (n,), generator=g, device=dev)
        for op in ("min", "max"):
            got = ops.segment_reduce(gids, v, groups, op)
            want = ref.segment_reduce_ref(gids, v[:, None], groups, op)[:, 0]
            if not torch.equal(got, want):
                raise AssertionError(f"segsum {op} {dt} differs from plain")
    log(f"segsum min and max n={n} G={groups} float64 and int64: exact")


def check_hash_insert(dev, db) -> dict:
    """The group-dictionary insert at ``tools/time_hash_kernels.py``'s
    ``INSERT_CASES``: 1.5 M rows into 512 slots with 40 keys, Q13's own keys
    at SF 10 (orders per customer, a third of them 0) into 512, and 1.5 M
    rows into 8192 slots with 3000 keys.  Each in the design ``cap`` picks
    and in the global one: dense ids, key sets and the unresolved flag equal
    the plain version's; timed through the wrapper, with its host and
    device time apart, beside the plain version, ``torch.unique`` and the
    bound.  Returns the
    entry of the 40-key case."""
    sys.path.insert(0, str(ROOT / "tools"))
    from time_hash_kernels import (INSERT_CASES, insert_inputs, q13_keys,
                                   time_insert)
    q13 = q13_keys(db)
    entry = None
    for name, cap, distinct in INSERT_CASES:
        keys, valid = insert_inputs(dev, cap, distinct, q13)
        r = time_insert(dev, keys, valid, cap, plain=True)
        log(f"hash_insert  {name} n={r['n']} cap={cap} keys={r['distinct']} "
            f"({r['design']} design): wrapper {r['ms']:.3f} ms (host "
            f"{r['host_ms']:.3f} ms a call, device {r['device_ms']:.3f} ms: "
            f"memset and kernel); shared design {r['shared_ms']:.3f} "
            f"ms, global design {r['global_ms']:.3f} ms; plain "
            f"{r['plain_ms']:.3f} ms, torch.unique {r['library_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms; dense ids, key sets and "
            f"unresolved equal the plain version's in both designs")
        if (name, cap) == ("uniform", 512):
            entry = kernel_entry(
                "hash_insert", "src/repro_torch/kernels/csrc/hash_group.cu",
                "src/repro/kernels/hash_group/kernel.py:100", r["ms"],
                r["plain_ms"], r["library_ms"], 0.0, r["bytes"])
    return entry


def check_radix_hist(dev, db) -> dict:
    """Per-block histograms of SF 10's l_orderkey (int32), 8 partitions,
    blocks of 2048 rows, hashed and not, through
    ``tools/time_radix_hist.py``: exact against the plain version and
    byte-identical across two runs, timed beside the plain version,
    ``bincount`` over ids binned beforehand and the bound, with the plan
    ``hist_plan`` made.  Returns the hashed case's entry."""
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    from time_radix_hist import time_hist
    keys = torch.from_numpy(
        db.tables["lineitem"]["l_orderkey"].astype("int32")).to(dev)
    entry = None
    for hashed in (True, False):
        r = time_hist(dev, keys, 8, hashed, plain=True)
        log(f"radix_hist   n={r['n']} parts=8 blk={r['blk']} "
            f"hashed={hashed} (plan {json.dumps(r['plan'])}): kernel "
            f"{r['ms']:.3f} ms (device {r['device_ms']:.3f} ms), plain "
            f"{r['plain_ms']:.3f} ms, bincount (binned beforehand) "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms; exact, "
            f"byte-identical across runs")
        if hashed:
            entry = kernel_entry(
                "radix_hist", "src/repro_torch/kernels/csrc/radix_hist.cu",
                "src/repro/kernels/radix_hist/kernel.py:59", r["ms"],
                r["plain_ms"], r["library_ms"], 0.0, r["bytes"])
    return entry


def run_skew_path(dev, db) -> dict[str, int]:
    """``skew_stats`` of SF 10's l_partkey over 8 partitions: the path that
    runs the partition histogram."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.radix_hist import ops, ref
    keys = torch.from_numpy(
        db.tables["lineitem"]["l_partkey"].astype("int32")).to(dev)
    K.reset_launches()
    st = ops.skew_stats(keys, 8)
    per = st["per_partition"].tolist()
    counts = dict(K.launches)
    want = ref.radix_hist_plain(keys, 8, 2048).sum(dim=0).tolist()
    if per != want or sum(per) != keys.shape[0]:
        raise AssertionError("skew_stats totals differ from the plain "
                             "version's or from the row count")
    log(f"skew_stats SF {SF_TIMED} l_partkey, 8 partitions: per partition "
        f"{[int(x) for x in per]}, max/mean {float(st['imbalance']):.6f}; "
        f"launches {json.dumps(counts)}")
    if counts["radix_hist"] != 1:
        raise AssertionError(f"skew_stats launched radix_hist "
                             f"{counts['radix_hist']} times, not once")
    return counts


def check_hash_probe(dev, n: int, m: int) -> dict:
    """60 M probes into 15 M unique keys at cap 16, the SF 10 hash join's
    shape: the probe bit for bit against its plain version and timed;
    then, through the join's own ``build_index`` and ``probe_index``
    (``tools/time_hash_join.py::time_index``), the hash index's build
    (plain PyTorch), probe and both together, and beside them the sorted
    index over the same keys, the path a planner would choose against."""
    import torch
    from repro_torch.kernels.hash_probe import ops, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    build = torch.randperm(m, generator=g, device=dev) + 1       # orderkeys
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    buckets = max(128, ops.next_pow2(2 * m) // 4)
    heads, tails, ov = ops.build_bucket_table64(build, rows, buckets,
                                                cap=16)
    if bool(ov):
        raise AssertionError("hash_probe build overflowed")
    probe = torch.randint(1, m + m // 10, (n,), generator=g, device=dev)
    got = ops.hash_probe64(probe, heads, tails)
    chunk = 10_000_000

    def plain():
        return torch.cat([ref.hash_probe64_ref(probe[i:i + chunk], heads,
                                               tails)
                          for i in range(0, n, chunk)])

    want = plain()
    if not torch.equal(got, want):
        raise AssertionError("hash_probe64 differs from plain")
    hit = got >= 0
    if not torch.equal(build[got[hit].long()], probe[hit]) or \
            int(hit.sum()) != int((probe <= m).sum()):
        raise AssertionError("hash_probe64 matched wrong rows")

    ms = time_ms(lambda: ops.hash_probe64(probe, heads, tails))
    plain_ms = time_ms(plain, reps=2)
    sys.path.insert(0, str(ROOT / "tools"))
    from time_hash_join import time_index
    joins = time_index(build, probe)
    # the function's bytes: each probe key read and each row written once,
    # each kept build key and its row (12 bytes) read once; the layout's own
    # floor reads the 32-byte heads of all buckets and 16 bytes a tail entry
    kept = int(heads[:, 6].long().sum())
    spilled = int((heads[:, 6].long() - 2).clamp(min=0).sum())
    nbytes = n * (8 + 4) + kept * 12
    layout_bytes = n * (8 + 4) + heads.numel() * 4 + spilled * 16
    log(f"hash_probe64 n={n} build={m} B={buckets} cap=16 kept={kept} tail "
        f"entries={spilled}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (no "
        f"single library call), bound {bound(nbytes)[0]:.3f} ms (the heads "
        f"+ tails layout's own floor {bound(layout_bytes)[0]:.3f} ms); exact")
    for method, t in joins.items():
        log(f"build_index + probe_index, {method}, same keys: build "
            f"{t['build_ms']:.3f} ms, probe {t['probe_ms']:.3f} ms, build and "
            f"probe {t['build_and_probe_ms']:.3f} ms")
    return kernel_entry(
        "hash_probe64", "src/repro_torch/kernels/csrc/hash_probe.cu",
        "src/repro/kernels/hash_probe/kernel.py:87", ms, plain_ms, None, 0.0,
        nbytes)


# ---------------------------------------------------------------------------
# phases 4 and 5: the queries
# ---------------------------------------------------------------------------

def same_bytes(got: dict, want: dict) -> bool:
    """Equal column names, dtypes and bytes."""
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
        for k in want)


def same_plan_result(got: dict, want: dict, label: str) -> float | None:
    """A SQL-compiled plan's result against the hand-built plan's, over
    the columns both have (a SQL plan names its sort helper columns after
    the key where a hand-built plan picked its own names): the same rows
    and dtypes, every integer column byte for byte, float columns within
    the reference's rtol 1e-7.  Returns None where every column is
    byte-identical, else the largest relative difference of a float column
    (on the card a float sum's rounding follows the group count, and the
    two plans may number their groups differently)."""
    import numpy as np
    keys = sorted(set(got) & set(want))
    if not keys:
        raise AssertionError(f"{label}: no common output columns")
    worst = None
    for k in keys:
        a, b = got[k], want[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label} {k}: {a.dtype} {a.shape} against "
                                 f"{b.dtype} {b.shape}")
        if a.tobytes() == b.tobytes():
            continue
        if not np.issubdtype(a.dtype, np.floating):
            raise AssertionError(f"{label} {k}: integer column differs")
        np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=f"{label} {k}")
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
        worst = rel if worst is None else max(worst, rel)
    return worst


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


def run_main_path(dev):
    """Phase 4.  Returns the launch counts, the SF 1 database, the
    reference's results on it and the SQL-compiled plans."""
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.core.sortcount import LEGS, MAX_SORTS, SortCounter
    from repro_torch.data import tpch
    from repro_torch.queries import QUERIES
    from repro_torch.sql import sql_queries
    t0 = time.perf_counter()
    db = tpch.generate(SF_MAIN, seed=SEED)
    t1 = time.perf_counter()
    refs = {q: B.run_reference(QUERIES[q], db)[0] for q in sorted(QUERIES)}
    t2 = time.perf_counter()
    log(f"SF {SF_MAIN}: generated in {t1 - t0:.1f} s, NumPy reference of 22 "
        f"queries in {t2 - t1:.1f} s")
    sql = sql_queries()
    hand = {}
    K.reset_launches()
    for jm in ("sorted", "hash"):
        t3 = time.perf_counter()
        sorts = {}
        for q in sorted(QUERIES):
            with SortCounter() as c:
                got, _ = B.run_local(QUERIES[q], db, join_method=jm,
                                     device=dev)
            sorts[q] = len(c.calls)
            compare(got, refs[q], f"SF {SF_MAIN} q{q} join={jm}")
            hand[jm, q] = got
        log(f"SF {SF_MAIN}: 22 queries join={jm} equal the reference "
            f"({time.perf_counter() - t3:.1f} s with the first upload)")
        log(f"SF {SF_MAIN} join={jm} sorts per query (planner on): "
            f"{json.dumps(sorts)}, total {sum(sorts.values())}")
        # SF 1 may prove other key widths than sf 0.005's budgets, so only
        # the planner-off budget bounds the planner-on count here
        off = LEGS.index((jm, False))
        over = {q: n for q, n in sorts.items() if n > MAX_SORTS[q][off]}
        if over:
            raise AssertionError(f"join={jm}: planner-on sorts above the "
                                 f"planner-off budget: {over}")
    for jm in ("sorted", "hash"):
        t3 = time.perf_counter()
        differ = {}
        for q in sorted(sql):
            got, _ = B.run_local(sql[q], db, join_method=jm, device=dev)
            rel = same_plan_result(got, hand[jm, q],
                                   f"SF {SF_MAIN} q{q} join={jm} SQL plan")
            if rel is not None:
                differ[q] = rel
        log(f"SF {SF_MAIN}: 22 SQL-compiled plans join={jm} equal the "
            f"hand-built plans' results, integer columns byte for byte; "
            f"{22 - len(differ)} of 22 byte-identical throughout, float "
            f"columns of the others within max relative difference "
            f"{json.dumps({q: f'{r:.2e}' for q, r in differ.items()})} "
            f"({time.perf_counter() - t3:.1f} s)")
    counts = dict(K.launches)
    log(f"launches on the main path (SF {SF_MAIN}, 22 queries x 2 joins, "
        f"hand-built and SQL plans): {json.dumps(counts)}")
    local = ("segsum_sum", "segsum_count", "segsum_minmax", "hash_insert",
             "hash_probe64")
    missing = [k for k in local if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return counts, db, refs, sql


def run_timed(dev, db, sql) -> dict:
    """Phase 5.  Returns the sorted-join results per query."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.queries import QUERIES
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    B.device_tables(db, dev)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    resident = torch.cuda.memory_allocated(dev)
    log(f"SF {SF_TIMED}: {len(db.tables['lineitem']['l_orderkey'])} lineitem "
        f"rows, {resident / 1e9:.2f} GB resident after upload "
        f"({t2 - t1:.1f} s)")
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
    for q in sorted(QUERIES):
        busy = device_busy_ms(lambda: B.run_local(QUERIES[q], db,
                                                  device=dev))
        log(busy_line(f"SF {SF_TIMED} q{q} join=sorted", busy,
                      medians["sorted"][q]))
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
    t3 = time.perf_counter()
    differ = {}
    for q in sorted(sql):
        got, _ = B.run_local(sql[q], db, device=dev)
        rel = same_plan_result(got, results[q],
                               f"SF {SF_TIMED} q{q} join=sorted SQL plan")
        if rel is not None:
            differ[q] = rel
    log(f"SF {SF_TIMED}: 22 SQL-compiled plans join=sorted equal the "
        f"hand-built plans' results, integer columns byte for byte; "
        f"{22 - len(differ)} of 22 byte-identical throughout, float columns "
        f"of the others within max relative difference "
        f"{json.dumps({q: f'{r:.2e}' for q, r in differ.items()})} "
        f"({time.perf_counter() - t3:.1f} s)")
    return results


# ---------------------------------------------------------------------------
# phases 6 and 7: the distributed path
# ---------------------------------------------------------------------------

def run_distributed_path(dev, db, refs) -> dict[str, int]:
    """Phase 6: all 22 queries at SF 1 through run_distributed on a
    ThreadGroup on the one card.  Returns the launch counts of the phase."""
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.queries import QUERIES
    K.reset_launches()
    narrow = {}
    for n, jm in ((4, "sorted"), (8, "sorted"), (4, "hash")):
        t0 = time.perf_counter()
        for q in sorted(QUERIES):
            got, stats, overflow = B.run_distributed(
                QUERIES[q], db, n, join_method=jm, device=dev)
            label = f"SF {SF_MAIN} N={n} q{q} join={jm}"
            if overflow:
                raise AssertionError(f"{label}: capacity overflow")
            compare(got, refs[q], label)
            if stats.counts() != QUERIES[q].static_counts():
                raise AssertionError(f"{label}: exchanges {stats.counts()} "
                                     f"!= static {QUERIES[q].static_counts()}")
            if (n, jm) == (4, "sorted"):
                narrow[q] = got
        log(f"SF {SF_MAIN} distributed N={n} join={jm}: 22 queries equal the "
            f"reference, exchange counts equal the static counts "
            f"({time.perf_counter() - t0:.1f} s with the first upload)")
    for q in (9, 10, 13, 18):
        wide, _, _ = B.run_distributed(QUERIES[q], db, 4, device=dev,
                                       wire_format="wide")
        if set(wide) != set(narrow[q]) or any(
                wide[k].tobytes() != narrow[q][k].tobytes() for k in wide):
            raise AssertionError(f"SF {SF_MAIN} N=4 q{q}: narrow wire differs "
                                 f"from wide")
    log(f"SF {SF_MAIN} distributed N=4: narrow wire equals wide byte for byte "
        f"on Q9, Q10, Q13, Q18")
    counts = dict(K.launches)
    log(f"launches on the distributed path (SF {SF_MAIN}, 22 queries x 3 "
        f"runs + 4 wide): {json.dumps(counts)}")
    path = ("segsum_sum", "segsum_minmax", "hash_insert", "hash_probe64",
            "counting_rank")
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed "
                             f"path: {missing}")
    # the shuffle's widths (N + 2) all take the single-pass rank
    if counts["counting_rank_onepass"] != counts["counting_rank"]:
        raise AssertionError(f"{counts['counting_rank_onepass']} of "
                             f"{counts['counting_rank']} counting_rank calls "
                             f"ran the single-pass kernel")
    return counts


def run_distributed_timed(dev, db, results) -> None:
    """Phase 7: all 22 queries at SF 10 through run_distributed, N = 4."""
    import torch
    from repro_torch.core import backend as B
    from repro_torch.core import planner
    from repro_torch.queries import QUERIES
    n = 4
    planner.invalidate_stats(db)        # frees phase 5's resident tables
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    B.device_shards(db, dev, n)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    resident = torch.cuda.memory_allocated(dev)
    log(f"SF {SF_TIMED} distributed N={n}: partitioned and uploaded in "
        f"{t1 - t0:.1f} s, {resident / 1e9:.2f} GB resident")
    medians = {}
    for q in sorted(QUERIES):
        got, _, overflow = B.run_distributed(QUERIES[q], db, n,
                                             device=dev)        # warm-up
        if overflow:
            raise AssertionError(f"SF {SF_TIMED} N={n} q{q}: overflow")
        compare(got, results[q], f"SF {SF_TIMED} N={n} q{q} vs run_local")
        runs = []
        for _ in range(REPS):
            s = time.perf_counter()
            B.run_distributed(QUERIES[q], db, n, device=dev)
            runs.append((time.perf_counter() - s) * 1e3)
        medians[q] = statistics.median(runs)
        log(f"SF {SF_TIMED} distributed N={n} q{q}: median of {REPS} "
            f"{medians[q]:.2f} ms")
        busy = device_busy_ms(lambda: B.run_distributed(QUERIES[q], db, n,
                                                        device=dev))
        log(busy_line(f"SF {SF_TIMED} distributed N={n} q{q}", busy,
                      medians[q]))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"SF {SF_TIMED} distributed N={n} join=sorted: total of medians "
        f"{sum(medians.values()):.1f} ms; peak device memory "
        f"{peak / 1e9:.2f} GB; every result equals run_local's (ranks "
        f"serialised on one card, not a cluster's times)")


# ---------------------------------------------------------------------------
# phase 7b: recovery
# ---------------------------------------------------------------------------

def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def reckon_snapshot_bytes(dev, db) -> float:
    """The lineage snapshots Q5, Q9 and Q18 write at SF 10, reckoned from
    the ones they write at SF 1 (a snapshot is a post-exchange table, whose
    rows grow with the scale factor)."""
    import shutil
    import tempfile
    from repro_torch.distributed.lineage import LineageStore, run_resumable
    from repro_torch.queries import QUERIES
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="lineage_sf1_", dir=ROOT / "build")
    try:
        for q in RECOVERY_QUERIES:
            run_resumable(QUERIES[q], db, LineageStore(f"{work}/q{q}"),
                          device=dev)
        nbytes = dir_bytes(work)
    finally:
        shutil.rmtree(work)
    reckoned = nbytes * SF_TIMED / SF_MAIN
    log(f"lineage snapshots of Q5, Q9, Q18 at SF {SF_MAIN}: {nbytes / 1e9:.3f}"
        f" GB, so {reckoned / 1e9:.2f} GB reckoned at SF {SF_TIMED} (limit "
        f"{LINEAGE_MAX_BYTES / 1e9:.0f} GB)")
    return reckoned


def run_recovery(dev, db, results, snapshot_bytes, card) -> dict[str, int]:
    """Phase 7b: the default fault plan and a device loss through
    ``QueryRunner`` on 4 ranks, then lineage snapshots and resumes, at
    SF 10.  Returns the launch counts of the phase."""
    import shutil
    import tempfile
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.data import tpch
    from repro_torch.distributed.chaos import (ChaosInjector, FaultPlan,
                                               FaultSpec, TransientFault)
    from repro_torch.distributed.fault import QueryRunner, RetryPolicy
    from repro_torch.distributed.lineage import LineageStore, run_resumable
    from repro_torch.queries import QUERIES
    n = 4

    def gb() -> float:
        return torch.cuda.memory_allocated(dev) / 1e9

    K.reset_launches()

    # the default plan, on phase 7's resident shards: from capacity factor
    # 1, the injected overflow escalates to phase 7's 2
    for q in RECOVERY_QUERIES:
        runner = QueryRunner(db, n, capacity_factor=1.0, escalation=2.0,
                             chaos=ChaosInjector(FaultPlan.default(SEED)),
                             policy=RetryPolicy(max_attempts=6,
                                                backoff_s=0.01),
                             device=dev)
        res = runner.run(QUERIES[q])
        label = f"SF {SF_TIMED} N={n} q{q} FaultPlan.default({SEED})"
        outcomes = res.report.outcomes()
        fired = [(f.kind, f.cut, f.index, f.simulated)
                 for f in res.report.injected]
        if outcomes != ["transient", "corrupt", "overflow", "ok"] or \
                [f[0] for f in fired] != ["transient", "corrupt", "overflow"]:
            raise AssertionError(f"{label}: outcomes {outcomes}, fired "
                                 f"{fired}")
        # the corrupt fault fires at the first group_by cut: in Q5 and Q9 a
        # group-by whose partial is gathered through a checksummed exchange;
        # Q18 first groups lineitem by l_orderkey, its partitioning key,
        # with no exchange, so there the fault is simulated, as in the
        # reference
        if fired[1][3] != (q == 18):
            raise AssertionError(f"{label}: corrupt fault simulated = "
                                 f"{fired[1][3]}")
        last = res.report.attempts[-1]
        clean, _, overflow = B.run_distributed(
            QUERIES[q], db, n, capacity_factor=last.capacity_factor,
            wire_format=last.wire_format, device=dev)
        if overflow or not same_bytes(res.result, clean):
            raise AssertionError(f"{label}: the final attempt differs from "
                                 f"a clean run")
        walls = ", ".join(f"{a.outcome} {a.wall_s * 1e3:.1f} ms"
                          for a in res.report.attempts)
        log(f"{label}: fired {fired}; attempts {walls}; final attempt at "
            f"capacity factor {last.capacity_factor}, {last.wire_format} "
            f"wire, byte-identical to a clean run with both")

    # a device loss 4 -> 3, each time from phase 7's resident 4-rank shards
    for q in RECOVERY_QUERIES:
        B.release_shards(db, dev, n - 1)
        B.device_shards(db, dev, n)
        torch.cuda.synchronize(dev)
        before = gb()
        runner = QueryRunner(db, n, device=dev, chaos=ChaosInjector(
            FaultPlan.device_loss(SEED, devices=(3,), cut="exchange")))
        res = runner.run(QUERIES[q])
        torch.cuda.synchronize(dev)
        after = gb()
        label = f"SF {SF_TIMED} q{q} device loss {n} -> {n - 1}"
        if res.report.outcomes() != ["device_lost", "ok"] or \
                (runner.devices, runner.topology_generation,
                 runner.lost_devices) != (n - 1, 1, (3,)):
            raise AssertionError(f"{label}: outcomes "
                                 f"{res.report.outcomes()}, devices "
                                 f"{runner.devices}, lost "
                                 f"{runner.lost_devices}")
        clean, _, overflow = B.run_distributed(QUERIES[q], db, n - 1,
                                               device=dev)
        if overflow or not same_bytes(res.result, clean):
            raise AssertionError(f"{label}: differs from a clean run on "
                                 f"{n - 1} ranks")
        compare(res.result, results[q], f"{label} vs run_local")
        walls = ", ".join(f"{a.outcome} {a.wall_s * 1e3:.1f} ms"
                          for a in res.report.attempts)
        log(f"{label}: attempts {walls} (the second re-partitions and "
            f"uploads at N={n - 1}); resident {before:.2f} GB before the "
            f"shrink, {after:.2f} GB after; byte-identical to a clean run on "
            f"{n - 1} ranks, equal to run_local's")
    B.release_shards(db, dev, n - 1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    B.device_shards(db, dev, n - 1)
    torch.cuda.synchronize(dev)
    log(f"SF {SF_TIMED}: re-partition and upload at N={n - 1}: "
        f"{time.perf_counter() - t0:.2f} s, {gb():.2f} GB resident")
    B.release_shards(db, dev, n - 1)

    # lineage snapshots: written by a run that fails at finalize, then
    # resumed, against full re-execution (the reference's bench_recovery)
    class TimedStore(LineageStore):
        """A store that adds up the time its snapshot writes take (the copy
        to the host, the npy write and its CRC)."""
        write_s = 0.0

        def save(self, tag, table, ctx, node=None):
            t = time.perf_counter()
            super().save(tag, table, ctx, node)
            self.write_s += time.perf_counter() - t

    sf = SF_TIMED if snapshot_bytes <= LINEAGE_MAX_BYTES else SF_MAIN
    ldb = db if sf == SF_TIMED else tpch.generate(SF_MAIN, seed=SEED)
    if sf != SF_TIMED:
        log(f"lineage at SF {sf}: SF {SF_TIMED} would write "
            f"{snapshot_bytes / 1e9:.1f} GB of snapshots")
    work = tempfile.mkdtemp(prefix="lineage_", dir=ROOT / "build")

    def populate(q, store, n_devices):
        inj = ChaosInjector(FaultPlan(q, (
            FaultSpec("transient", cut="finalize"),)))
        try:
            run_resumable(QUERIES[q], ldb, store, chaos=inj,
                          n_devices=n_devices, device=dev)
        except TransientFault:
            return
        raise AssertionError(f"q{q}: the finalize fault did not fire")

    def timed(fn) -> float:
        fn()                                        # warm-up
        runs = []
        for _ in range(REPS):
            t = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t)
        return statistics.median(runs)

    try:
        for q in RECOVERY_QUERIES:
            label = f"SF {sf} q{q} lineage"
            store = TimedStore(f"{work}/q{q}")
            t0 = time.perf_counter()
            populate(q, store, 1)
            fail_s = time.perf_counter() - t0
            saved, nbytes = store.saved, dir_bytes(store.dir)
            if saved < 1:
                raise AssertionError(f"{label}: no snapshot written")
            full, _ = B.run_local(QUERIES[q], ldb, device=dev)
            full_s = timed(lambda: B.run_local(QUERIES[q], ldb, device=dev))

            def resume(st, width):
                got, _, overflow, reused = run_resumable(
                    QUERIES[q], ldb, st, n_devices=width, device=dev)
                if overflow or reused < 1 or not same_bytes(got, full):
                    raise AssertionError(f"{label}: resume at width "
                                         f"{width} reused {reused}, "
                                         f"overflow {overflow}, or differs")
            resume_s = timed(lambda: resume(store, 1))
            if store.resharded:
                raise AssertionError(f"{label}: a same-width resume "
                                     f"re-sharded")
            wide = TimedStore(f"{work}/q{q}_w8")
            populate(q, wide, 8)
            reshard_s = timed(lambda: resume(wide, 5))
            if wide.resharded < 1:
                raise AssertionError(f"{label}: the width 8 -> 5 resume did "
                                     f"not re-shard")
            log(f"{label}: {saved} snapshots, {nbytes / 1e9:.3f} GB, written "
                f"in {store.write_s:.2f} s (the failed attempt took "
                f"{fail_s:.2f} s); full_s {full_s:.4f}, resume_s "
                f"{resume_s:.4f}, ratio {resume_s / full_s:.3f}; written at "
                f"width 8 and resumed at 5: {reshard_s:.4f} s, ratio "
                f"{reshard_s / full_s:.3f}, re-sharded {wide.resharded}; "
                f"each resume byte-identical to run_local; medians of "
                f"{REPS} after a warm-up ({card})")
            shutil.rmtree(f"{work}/q{q}")
            shutil.rmtree(f"{work}/q{q}_w8")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = dict(K.launches)
    log(f"launches on the recovery path (SF {SF_TIMED}, Q5/Q9/Q18): "
        f"{json.dumps(counts)}")
    missing = [k for k in ("segsum_sum", "counting_rank") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the recovery "
                             f"path: {missing}")
    return counts


# ---------------------------------------------------------------------------
# phase 7c: serving and approximate answers
# ---------------------------------------------------------------------------

def serve_stream():
    """The reference's ``bench_serve._stream()``: every sample of all 22
    templates, round-robin, so consecutive requests come from different
    templates (29 requests)."""
    from repro_torch import serve
    per = [[(t, s) for s in t.samples]
           for _, t in sorted(serve.TEMPLATES.items())]
    out, i = [], 0
    while any(per):
        if per[i % len(per)]:
            out.append(per[i % len(per)].pop(0))
        i += 1
    return out


def supplier_revenue():
    """An estimable per-supplier revenue whose group-by shuffles (Q1's and
    Q6's gather or all-reduce, so only this one ranks rows on the
    distributed path)."""
    from repro_torch.core.plan import col, scan
    from repro_torch.core.table import days
    return scan("lineitem").filter(col("l_shipdate") <= days("1998-09-02")) \
        .group_by(["l_suppkey"],
                  [("revenue", "sum",
                    col("l_extendedprice") * (1 - col("l_discount"))),
                   ("n", "count", None)], exchange="shuffle") \
        .finalize(sort_keys=[("l_suppkey", True)])


def launch_delta(before: dict) -> dict:
    from repro_torch import kernels as K
    return {k: K.launches[k] - before.get(k, 0) for k in K.launches}


def counted(tally: dict, fn):
    """Run ``fn`` and add the kernels it launched to ``tally``."""
    from repro_torch import kernels as K
    before = dict(K.launches)
    out = fn()
    for k, v in launch_delta(before).items():
        tally[k] = tally.get(k, 0) + v
    return out


def require_launches(counts: dict, names, label: str) -> None:
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on {label}: {missing}")


def serve_sf10(dev, db, results, card) -> tuple[dict, dict, float, dict]:
    """7c.1: the stream through ``QueryServer`` (sorted joins) at SF 10.
    Returns the bound requests' run_local results and times, the passes'
    peak device memory, and the kernels the server launched (the counts
    are 0 when it is called)."""
    import torch
    from repro_torch.core import backend as B
    from repro_torch.core import planner
    from repro_torch.serve import QueryServer
    reqs = serve_stream()
    # a logical width of 4 (the port serves from one card), so that
    # degrade(3) is a real shrink
    srv = QueryServer(db, devices=4, device=dev)
    prep_ms = {}
    prepare = srv._prepare

    def timed_prepare(query, rdb, infer, factor):
        s = time.perf_counter()
        fn = prepare(query, rdb, infer, factor)
        prep_ms[query.name] = (time.perf_counter() - s) * 1e3
        return fn

    srv._prepare = timed_prepare
    s = time.perf_counter()
    planner.column_stats(db)
    stats_s = time.perf_counter() - s
    torch.cuda.reset_peak_memory_stats(dev)
    s = time.perf_counter()
    srv.serve(reqs)
    cold_ms = (time.perf_counter() - s) * 1e3
    if (srv.recompiles, srv.cache_hits) != (22, len(reqs) - 22):
        raise AssertionError(f"cold pass: {srv.recompiles} preparations, "
                             f"{srv.cache_hits} hits")
    log(f"SF {SF_TIMED} serve: cold pass of {len(reqs)} requests "
        f"{cold_ms:.1f} ms, 22 preparations (column statistics first, "
        f"{stats_s:.2f} s); preparation ms per template "
        f"{json.dumps({k: round(v, 2) for k, v in prep_ms.items()})}, "
        f"total {sum(prep_ms.values()):.1f} ms ({card})")
    per_req, passes, served = [], [], None
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = []
        for t, b in reqs:
            s = time.perf_counter()
            out.append(srv.submit(t, b))
            per_req.append((time.perf_counter() - s) * 1e3)
        passes.append((time.perf_counter() - t0) * 1e3)
        served = out
    hits = len(reqs) - 22 + REPS * len(reqs)
    if (srv.recompiles, srv.cache_hits) != (22, hits):
        raise AssertionError(f"warm passes: {srv.recompiles} preparations, "
                             f"{srv.cache_hits} hits, want 22 and {hits}")
    pass_ms = statistics.median(passes)
    busy = device_busy_ms(lambda: srv.serve(reqs))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"SF {SF_TIMED} serve: {REPS} warm passes, per-request median "
        f"{statistics.median(per_req):.2f} ms, stream total median "
        f"{pass_ms:.1f} ms (passes {', '.join(f'{p:.1f}' for p in passes)}),"
        f" {len(reqs) / pass_ms * 1e3:.1f} requests/s; recompiles 22, "
        f"cache hits {hits} ({card})")
    log(busy_line(f"SF {SF_TIMED} serve: one profiled pass", busy, pass_ms))
    srv.degrade(3)
    s = time.perf_counter()
    again = srv.serve(reqs)
    ms = (time.perf_counter() - s) * 1e3
    serving = launch_delta({})          # the server's passes, and no other
    if srv.recompiles != 44:
        raise AssertionError(f"degrade(3): {srv.recompiles} preparations, "
                             f"want 44")
    seq, seq_ms = {}, {}
    for i, ((t, b), got, deg) in enumerate(zip(reqs, served, again)):
        s = time.perf_counter()
        want, _ = B.run_local(t.bind(**b), db, device=dev)
        seq_ms[i] = (time.perf_counter() - s) * 1e3
        seq[i] = want
        if not same_bytes(got, want):
            raise AssertionError(f"SF {SF_TIMED} serve {t.name} {b}: the "
                                 f"served result differs from run_local's")
        if not same_bytes(deg, want):
            raise AssertionError(f"degrade(3): {t.name} {b} differs")
    differ = {}
    for i, (t, b) in enumerate(reqs):
        if b == t.samples[0]:
            rel = same_plan_result(served[i], results[int(t.name[1:])],
                                   f"SF {SF_TIMED} serve {t.name}")
            if rel is not None:
                differ[t.name] = f"{rel:.2e}"
    log(f"SF {SF_TIMED} serve: every served result byte-identical to "
        f"run_local of the same bound template; the samples[0] results "
        f"equal phase 5's hand-built results (integers exactly; floats of "
        f"{json.dumps(differ)} within rtol 1e-7, the rest byte-identical)")
    log(f"SF {SF_TIMED} serve: degrade(3), generation "
        f"{srv.topology_generation}: one pass {ms:.1f} ms, exactly 22 more "
        f"preparations (recompiles 44), every result byte-identical to "
        f"run_local's")
    return seq, seq_ms, peak, serving


def run_batch(dev, db, label, seq=None) -> tuple[float, float, float]:
    """7c.2 at one scale: the stream through ``BatchExecutor``, each result
    byte-identical to the request run alone.  Returns (batch ms, sum of
    the requests' own ms, memo peak bytes above what was allocated)."""
    import torch
    from repro_torch.core import backend as B
    from repro_torch.serve import BatchExecutor
    reqs = serve_stream()
    seq_ms = 0.0
    if seq is None:
        seq = {}
        for t, b in reqs:                 # the upload and the statistics
            B.run_local(t.bind(**b), db, device=dev)
        for i, (t, b) in enumerate(reqs):
            s = time.perf_counter()
            seq[i], _ = B.run_local(t.bind(**b), db, device=dev)
            seq_ms += (time.perf_counter() - s) * 1e3
    bx = BatchExecutor(db, device=dev)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    s = time.perf_counter()
    got = bx.run_batch(reqs)
    ms = (time.perf_counter() - s) * 1e3
    extra = torch.cuda.max_memory_allocated(dev) - before
    if bx.shared_hits <= 0:
        raise AssertionError(f"{label} batch: no cross-query sharing")
    for i, out in enumerate(got):
        if not same_bytes(out, seq[i]):
            raise AssertionError(f"{label} batch {reqs[i][0].name}: differs "
                                 f"from the request run alone")
    log(f"{label} batch of {len(reqs)}: {ms:.1f} ms, {bx.shared_hits} "
        f"shared hits, every result byte-identical to the request run "
        f"alone; memo peak {extra / 1e9:.2f} GB above the "
        f"{before / 1e9:.2f} GB allocated before")
    return ms, seq_ms, extra


def approx_sf10(dev, db, results, card) -> dict:
    """7c.3: Q1 and Q6 off the sample ladder at SF 10, per rung, through
    the rewrite on run_local, ``ProgressiveRunner`` and
    ``QueryServer.submit(tolerance=)``; Q18 refused.  Returns the kernels
    that ``ProgressiveRunner`` and ``submit(tolerance=)`` launched."""
    import numpy as np
    import torch
    from repro_torch.approx import ProgressiveRunner, sampling
    from repro_torch.approx.rewrite import rewrite_for_rung
    from repro_torch.core import backend as B
    from repro_torch.serve import TEMPLATES, QueryServer
    li = db.tables["lineitem"]
    rows = len(li["l_orderkey"])
    row_bytes = sum(v.itemsize for v in li.values())
    ladder_share = sum(1 / d for d in sampling.LADDER)
    log(f"SF {SF_TIMED} approx: reckoned sample tables per query "
        f"{ladder_share:.4f} x {rows} lineitem rows x ({row_bytes} + 24) "
        f"bytes = {ladder_share * rows * (row_bytes + 24) / 1e9:.2f} GB on "
        f"the host and the card (each ladder freed before the next)")
    base = B.device_tables(db, dev)
    srv = QueryServer(db, device=dev)
    tally = {}
    for q in APPROX_QUERIES:
        t = TEMPLATES[q]
        exact = None
        runs = []
        for _ in range(REPS + 1):
            s = time.perf_counter()
            exact, _ = B.run_local(t.query, db, device=dev)
            runs.append((time.perf_counter() - s) * 1e3)
        exact_ms = statistics.median(runs[1:])
        truth = results[q]
        widths, walls = {}, {}
        for den in sampling.LADDER:
            label = f"SF {SF_TIMED} q{q} rung 1/{den}"
            s = time.perf_counter()
            rw = rewrite_for_rung(t.query, db, den)
            build_s = time.perf_counter() - s
            name = sampling.rung_name("lineitem", den)
            gb = sum(v.nbytes for v in rw.db.tables[name].values()) / 1e9
            s = time.perf_counter()
            tables = B.device_tables(rw.db, dev)
            torch.cuda.synchronize(dev)
            upload_s = time.perf_counter() - s
            if any(tables[k] is not base[k] for k in base):
                raise AssertionError(f"{label}: a base table was uploaded "
                                     f"again")
            runs = []
            for _ in range(REPS + 1):
                s = time.perf_counter()
                out, _ = B.run_local(rw.query, rw.db, device=dev)
                runs.append((time.perf_counter() - s) * 1e3)
            walls[den] = statistics.median(runs[1:])
            est = rw.finalize(out)
            widths[den] = est.rel_width
            if den == 1 and not same_bytes(out, exact):
                raise AssertionError(f"{label}: differs from the exact plan")
            # the interval [est - hw, est + hw] against phase 5's answer, up
            # to the repo's float tolerance (a fully sampled count is n/m
            # summed m times: exact up to rounding, at width 0).  A 95 %
            # interval misses 1 in 20, and a group's aggregates share its
            # sample, so misses come a group at a time: the share is
            # printed, and a broken estimate (a lost weight, a wrong
            # stratum) is caught by holding every cell within 4 widths
            covered = total = 0
            for name_t, _ in rw.targets:
                hw = est.half_width[name_t]
                for i in range(len(est.result[name_t])):
                    j = i if q == 6 else int(np.flatnonzero(
                        (truth["l_returnflag"] ==
                         est.result["l_returnflag"][i]) &
                        (truth["l_linestatus"] ==
                         est.result["l_linestatus"][i]))[0])
                    want = float(truth[name_t][j])
                    err = abs(float(est.result[name_t][i]) - want)
                    width = float(hw[i]) if den > 1 else 0.0
                    slack = 1e-7 * abs(want)
                    total += 1
                    covered += bool(err <= width + slack)
                    if err > 4 * width + slack:
                        raise AssertionError(
                            f"{label} {name_t}[{i}]: estimate off by {err} "
                            f"against a half-width of {width}")
            log(f"{label}: sample built on the host in {build_s:.2f} s, "
                f"{gb:.3f} GB, uploaded in {upload_s:.2f} s beside the "
                f"resident base tables; warm wall median of {REPS} "
                f"{walls[den]:.2f} ms (exact plan {exact_ms:.2f} ms); max "
                f"relative CI half-width {widths[den]:.3e}; the interval "
                f"covers phase 5's exact answer in {covered} of {total} "
                f"(group, aggregate) cells, every cell within 4 "
                f"half-widths ({card})")
        dens = list(sampling.LADDER)
        if any(widths[a] < widths[b] for a, b in zip(dens, dens[1:])) or \
                widths[1] != 0.0:
            raise AssertionError(f"q{q}: the CI width grew as the sample "
                                 f"grew: {widths}")
        # where a rung's time goes against the exact plan's: the device
        # time by kernel of the 1/2 rung and of the exact plan
        half = rewrite_for_rung(t.query, db, 2)
        for what, fn in (("rung 1/2", lambda: B.run_local(
                half.query, half.db, device=dev)),
                         ("exact", lambda: B.run_local(t.query, db,
                                                       device=dev))):
            by = device_time_by_kernel(fn)
            top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
            log(f"SF {SF_TIMED} q{q} {what}: device busy "
                f"{sum(by.values()):.2f} ms in {len(by)} kernels; top "
                f"{json.dumps({k[:70]: round(v, 2) for k, v in top})}")
        log(f"SF {SF_TIMED} q{q}: the 1/16 rung ({walls[16]:.2f} ms) is "
            f"{'faster' if walls[16] < exact_ms else 'not faster'} than the "
            f"exact plan ({exact_ms:.2f} ms); rung 1 byte-identical to it")
        ans = counted(tally, lambda: ProgressiveRunner(
            db, tolerance=0.0, device=dev).run(t.query))
        got_w = [a.ci_width for a in ans.report.attempts]
        if [a.rung for a in ans.report.attempts] != dens or \
                not np.allclose(got_w, [widths[d] for d in dens],
                                rtol=1e-7, atol=0.0) or \
                not same_bytes(ans.result, exact):
            raise AssertionError(f"q{q}: ProgressiveRunner's climb differs "
                                 f"from the rungs run alone")
        ans = counted(tally, lambda: ProgressiveRunner(
            db, tolerance=APPROX_TOLERANCE, device=dev).run(t.query))
        esc = srv.approx_escalations
        counted(tally, lambda: srv.submit(q, tolerance=APPROX_TOLERANCE))
        climbed = srv.approx_escalations - esc
        if sampling.LADDER[climbed] != ans.rung:
            raise AssertionError(f"q{q}: the server answered at rung "
                                 f"1/{sampling.LADDER[climbed]}, the runner "
                                 f"at 1/{ans.rung}")
        if not same_bytes(srv.submit(q, tolerance=0.0), srv.submit(q)):
            raise AssertionError(f"q{q}: the server's rung 1 differs from "
                                 f"its exact answer")
        log(f"SF {SF_TIMED} q{q}: ProgressiveRunner climbs 1/16 .. 1/1 with "
            f"the same widths and ends byte-identical to the exact plan; at "
            f"tolerance {APPROX_TOLERANCE} it and QueryServer.submit answer "
            f"at rung 1/{ans.rung} (width {ans.ci_width:.3e}); the server's "
            f"tolerance-0 answer byte-identical to its exact one")
        srv.cache.clear()
        sampling.invalidate(db)
        del rw, half, tables, ans
        gc.collect()
        torch.cuda.empty_cache()
    for den in sampling.LADDER[:-1]:
        if rewrite_for_rung(TEMPLATES[18].query, db, den) is not None:
            raise AssertionError(f"q18 rewrote onto rung 1/{den}")
    refused = srv.approx_refused
    if not same_bytes(srv.submit(18, tolerance=APPROX_TOLERANCE),
                      srv.submit(18)) or srv.approx_refused != refused + 1:
        raise AssertionError("q18: not served exact as a refused shape")
    log(f"SF {SF_TIMED} q18: every sampled rung refused (its grouped sum "
        f"feeds a HAVING filter), served exact, approx_refused counted")
    return tally


def progressive_on_group(dev, db) -> dict:
    """7c.4: each rung of Q1, Q6 and the shuffled supplier revenue on a
    ThreadGroup of 4 at SF 1, against the same rung on one device.
    Returns the kernels that the runs on the group launched."""
    from repro_torch.approx import ProgressiveRunner, sampling
    from repro_torch.approx.rewrite import rewrite_for_rung
    from repro_torch.core import backend as B
    from repro_torch.core import comm, planner
    from repro_torch.serve import TEMPLATES
    group = comm.ThreadGroup(4, dev)
    queries = {"q1": TEMPLATES[1].query, "q6": TEMPLATES[6].query,
               "supplier revenue": planner.compile_query(
                   supplier_revenue, name="supplier_revenue")}
    t0 = time.perf_counter()
    tally = {}
    for name, q in queries.items():
        for den in sampling.LADDER:
            label = f"SF {SF_MAIN} N=4 {name} rung 1/{den}"
            rw = rewrite_for_rung(q, db, den)
            one = rw.finalize(B.run_local(rw.query, rw.db, device=dev)[0])
            got, _, overflow = counted(tally, lambda: B.run_distributed(
                rw.query, rw.db, group))
            dist = rw.finalize(got)
            if overflow:
                raise AssertionError(f"{label}: capacity overflow")
            same_plan_result(dist.result, one.result, label)
            if set(dist.result) != set(one.result) or not math.isclose(
                    dist.rel_width, one.rel_width, rel_tol=1e-7):
                raise AssertionError(f"{label}: width {dist.rel_width} "
                                     f"against {one.rel_width}")
        a = counted(tally, lambda: ProgressiveRunner(
            db, group=group, tolerance=APPROX_TOLERANCE, device=dev).run(q))
        b = ProgressiveRunner(db, tolerance=APPROX_TOLERANCE,
                              device=dev).run(q)
        if a.rung != b.rung:
            raise AssertionError(f"{name}: rung 1/{a.rung} on 4 ranks, "
                                 f"1/{b.rung} on one device")
        same_plan_result(a.result, b.result, f"SF {SF_MAIN} N=4 {name}")
    sampling.invalidate(db)
    log(f"SF {SF_MAIN} ProgressiveRunner on a ThreadGroup of 4: every rung "
        f"of Q1, Q6 and the shuffled supplier revenue equals the same rung "
        f"on one device (integers exactly, floats and CI widths rtol 1e-7), "
        f"and each answers at the same rung at tolerance "
        f"{APPROX_TOLERANCE} ({time.perf_counter() - t0:.1f} s)")
    return tally


def hash_stream(dev, db) -> dict:
    """7c.5: one pass of the stream under hash joins at SF 1 against the
    sorted server's.  Returns the kernels the hash server launched."""
    from repro_torch.serve import QueryServer
    reqs = serve_stream()
    want = QueryServer(db, device=dev).serve(reqs)
    tally = {}
    srv = QueryServer(db, join_method="hash", device=dev)
    got = counted(tally, lambda: srv.serve(reqs))
    for (t, b), g, w in zip(reqs, got, want):
        same_plan_result(g, w, f"SF {SF_MAIN} serve {t.name} join=hash")
    log(f"SF {SF_MAIN} serve join=hash: {len(reqs)} requests equal the "
        f"sorted server's (integers exactly, floats rtol 1e-7)")
    return tally


def run_serving(dev, db10, db1, results, card) -> dict[str, int]:
    """Phase 7c: serving and approximate answers (``repro_torch.serve``,
    ``repro_torch.approx``) on the SF 10 tables, uploaded once; SF 1 for
    the batch's reckoning, the ThreadGroup and the hash joins.  Returns the
    launch counts of the phase."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.core import planner
    from repro_torch.serve import QueryServer
    planner.invalidate_stats(db10)      # frees phase 7b's shards and tables
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    s = time.perf_counter()
    B.device_tables(db10, dev)
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev)
    log(f"SF {SF_TIMED} serve: tables uploaded once in "
        f"{time.perf_counter() - s:.1f} s, {resident / 1e9:.2f} GB resident")
    K.reset_launches()
    seq, seq_ms, serve_peak, serving = serve_sf10(dev, db10, results, card)
    log(f"launches on the serving path (SF {SF_TIMED}, 1 cold + {REPS} warm "
        f"+ 1 profiled + 1 degraded pass, the server's calls alone): "
        f"{json.dumps(serving)}")
    require_launches(serving, ("segsum_sum", "segsum_count", "segsum_minmax",
                               "hash_insert"), "the serving path")
    # the memo's peak: measured at SF 1, scaled by 10
    ms1, seq1, extra1 = run_batch(dev, db1, f"SF {SF_MAIN}")
    reckoned = resident + extra1 * SF_TIMED / SF_MAIN
    if reckoned <= BATCH_MAX_BYTES:
        ms, _, extra = run_batch(dev, db10, f"SF {SF_TIMED}", seq)
        seq_total, sf = sum(seq_ms.values()), SF_TIMED
    else:
        ms, seq_total, extra, sf = ms1, seq1, extra1, SF_MAIN
    log(f"batch: reckoned from SF {SF_MAIN} at {reckoned / 1e9:.2f} GB with "
        f"the resident SF {SF_TIMED} tables (limit "
        f"{BATCH_MAX_BYTES / 1e9:.0f}), so it ran at SF {sf}: {ms:.1f} ms "
        f"against {seq_total:.1f} ms for the requests run alone, memo peak "
        f"{extra / 1e9:.2f} GB above the resident tables ({card})")
    approximate = approx_sf10(dev, db10, results, card)
    require_launches(approximate, ("segsum_sum", "segsum_count"),
                     "the approximate path")
    ranked = progressive_on_group(dev, db1)
    require_launches(ranked, ("counting_rank",), "the progressive "
                     "ThreadGroup path")
    hashed = hash_stream(dev, db1)
    require_launches(hashed, ("hash_probe64",), "the hash-join stream")
    counts = dict(K.launches)
    log(f"launches on phase 7c: {json.dumps(counts)}; ProgressiveRunner "
        f"and submit(tolerance=) at SF {SF_TIMED} alone "
        f"{json.dumps(approximate)}; the ThreadGroup runs alone "
        f"{json.dumps(ranked)}; the hash server alone {json.dumps(hashed)}")
    peak = torch.cuda.max_memory_allocated(dev)
    foot = QueryServer(db10, device=dev).footprint_bytes()
    log(f"SF {SF_TIMED} serve: QueryServer.footprint_bytes() "
        f"{foot / 1e9:.2f} GB (tables x (1 + capacity factor 2)) against "
        f"{resident / 1e9:.2f} GB resident and {serve_peak / 1e9:.2f} GB "
        f"peak over the serving passes ({peak / 1e9:.2f} GB over the whole "
        f"phase, the sample ladders included) ({card})")
    planner.invalidate_stats(db1)
    return counts


# ---------------------------------------------------------------------------
# phase 8: the last two kernels at the main path's shapes
# ---------------------------------------------------------------------------

def check_hash_probe32(dev, probe_np, build_np) -> tuple[dict, dict]:
    """SF 10's l_orderkey probing o_orderkey as int32 at every cap that
    ``hash_join_probe_auto`` builds there (``tools/time_hash_kernels.py``'s
    ``PROBE_CAPS``): each design, with and without the build's fill counts,
    bit for bit against the plain version and timed beside the bound and
    the layout's floors.  Then ``hash_join_probe_auto``, the path that
    launches it, with the counters reset just before and read just after:
    one launch, at the cap that held, equal to the sorted-build oracle.
    Returns the entry of that launch (cap 64, fill counts) and the path's
    launch counts."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.hash_probe import ops, ref
    sys.path.insert(0, str(ROOT / "tools"))
    from time_hash_kernels import PROBE_CAPS, time_probe32
    probe = torch.from_numpy(probe_np.astype("int32")).to(dev)
    build = torch.from_numpy(build_np.astype("int32")).to(dev)
    rows = torch.arange(build.shape[0], dtype=torch.int32, device=dev)
    timed = {}
    for cap in PROBE_CAPS:
        r = timed[cap] = time_probe32(dev, probe, build, cap, plain=True)
        designs = "; ".join(f"{k} {v['ms']:.3f}"
                            for k, v in r["designs"].items())
        log(f"hash_probe32 n={r['n']} build={r['build']} B={r['buckets']} "
            f"C={cap} occupied={r['occupied']} overflowed={r['overflowed']}"
            f": all lanes {r['ms']:.3f} ms (device "
            f"{r['device_ms']:.3f}), filled lanes {r['counts_ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms (no single library call), bound "
            f"{r['bound_ms']:.3f} ms, layout floor {r['floor_ms']:.3f} ms "
            f"(filled lanes {r['floor_filled_ms']:.3f}); designs: {designs} "
            f"ms; every design exact")

    torch.cuda.synchronize(dev)
    K.reset_launches()
    t0 = time.perf_counter()
    found, cap_held = ops.hash_join_probe_auto(probe, build, rows, device=dev)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    counts = dict(K.launches)
    want = ref.hash_probe_ref(probe, build, rows)
    if not torch.equal(found, want) or bool((found < 0).any()) or \
            not torch.equal(build[found.long()], probe):
        raise AssertionError("hash_join_probe_auto differs from the "
                             "sorted-build oracle")
    log(f"hash_join_probe_auto SF {SF_TIMED} l_orderkey -> o_orderkey: "
        f"held at cap {cap_held} ({secs * 1e3:.1f} ms with the builds), "
        f"every lineitem found its order, equal to the sorted-build oracle; "
        f"launches {json.dumps(counts)}")
    if counts["hash_probe32"] != 1:
        raise AssertionError(f"hash_join_probe_auto launched hash_probe32 "
                             f"{counts['hash_probe32']} times, not once")
    r = timed[cap_held]
    entry = kernel_entry(
        "hash_probe32", "src/repro_torch/kernels/csrc/hash_probe.cu",
        "src/repro/kernels/hash_probe/kernel.py:65", r["counts_ms"],
        r["plain_ms"], None, 0.0, r["bytes"])
    return entry, counts


def excess(got, want, rtol, atol) -> float:
    """Largest |got - want| - (atol + rtol |want|): at most 0 passes."""
    want = want.float()
    return ((got.float() - want).abs() - rtol * want.abs() - atol) \
        .max().item()


def single_rounded_p(q, k, v, group: int):
    """Causal attention with P rounded to bf16 once before the P.V product,
    float32 otherwise: what a tensor-core kernel without the P_hi + P_lo
    split would compute.  One (batch, query head) at a time."""
    import torch
    b, hq, s, d = q.shape
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for i in range(b):
        for h in range(hq):
            sc = (q[i, h].float() @ k[i, h // group].float().T) / d ** 0.5
            sc = sc.masked_fill(~causal, float("-inf"))
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            o = p.to(torch.bfloat16).float() @ v[i, h // group].float()
            out[i, h] = (o / p.sum(-1, keepdim=True)).to(q.dtype)
    return out


def check_flash(dev) -> dict:
    """The LM path's attention shape (``FLASH_SHAPE``), causal, against the
    plain version and timed beside ``F.scaled_dot_product_attention``.  In
    float32 (the CUDA-core design) within ``FLASH_F32_TOL`` (the same
    arithmetic in another order); in bf16 (the tensor-core design) within
    one output rounding of the plain version element by element
    (``FLASH_BF16_RTOL``, ``FLASH_BF16_ATOL``) and within 2e-2 max abs.
    Late rows average thousands of keys, so their outputs are ~0.04: a
    fixed absolute limit of 2e-2 alone would pass a wrong kernel there.
    Then the tensor-core design at its other head sizes, at a shorter
    sequence, both masks, under the same limits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's GEMMs
    b, hq, hkv, s, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))

    def plain(q, k, v):
        return ref.attention_ref(q.reshape(b * hq, s, d),
                                 k.reshape(b * hkv, s, d),
                                 v.reshape(b * hkv, s, d)).reshape(q.shape)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    q32, k32, v32 = q.float(), k.float(), v.float()
    got32, want32 = ops.flash_attention(q32, k32, v32, causal=True), \
        plain(q32, k32, v32)
    err32 = (got32 - want32).abs().max().item()
    over32 = excess(got32, want32, FLASH_F32_TOL, FLASH_F32_TOL)
    del q32, k32, v32, got32, want32
    got, want = ops.flash_attention(q, k, v, causal=True), plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    over16 = excess(got, want, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    rel = rel_l2(got, want)
    once = single_rounded_p(q, k, v, hq // hkv)
    over_once = excess(once, want, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    n_once = int(((once.float() - want.float()).abs() >
                  FLASH_BF16_RTOL * want.float().abs() + FLASH_BF16_ATOL)
                 .sum())
    del once
    lib = library()
    lib_err = (lib.float() - want.float()).abs().max().item()
    lib_over = excess(lib, want, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    del got, want, lib
    log(f"flash_attention {FLASH_SHAPE} causal: float32 "
        f"({ops.design(torch.float32, d)}) max abs err {err32:.3e} (largest "
        f"excess over atol = rtol = {FLASH_F32_TOL}: {over32:.3e}); bf16 "
        f"({ops.design(torch.bfloat16, d)}) max abs err {err:.3e}, relative "
        f"L2 {rel:.3e}, largest excess over one output rounding (rtol "
        f"{FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}): {over16:.3e}; "
        f"with P rounded to bf16 once (plain PyTorch) instead of P_hi + "
        f"P_lo: {over_once:.3e}, {n_once} of {q.numel()} elements over; "
        f"scaled_dot_product_attention's: {lib_over:.3e}")
    if not over32 <= 0:
        raise AssertionError(f"flash_attention float32: beyond {FLASH_F32_TOL}"
                             f" of the plain version by {over32}")
    if not (over16 <= 0 and err <= 2e-2):
        raise AssertionError(f"flash_attention bf16: max abs err {err}, "
                             f"beyond one output rounding by {over16}")
    if not over_once > 0:
        raise AssertionError("flash_attention bf16: P rounded to bf16 once "
                             "stays within the element-wise limit, so the "
                             "limit no longer tells it from P_hi + P_lo")
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: plain(q, k, v), reps=2)
    lib_ms = time_ms(library)
    flops = 4.0 * d * (s * (s + 1) / 2) * b * hq     # the causal half
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    log(f"flash_attention B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal bf16: "
        f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms "
        f"(max abs err {lib_err:.3e} against plain), bound "
        f"{bound(nbytes, flops)[0]:.3f} ms ({bound(nbytes, flops)[1]}); "
        f"the design's own 1.5x tensor work (P_hi + P_lo) "
        f"{bound(nbytes, 1.5 * flops)[0]:.3f} ms")
    del q, k, v
    for hd in ops.WGMMA_HEAD_DIMS:
        if hd == d:
            continue
        shape = (1, 8, 2, 1024, hd)
        q, k, v = (torch.randn(shape[:1] + (h,) + shape[3:], generator=g,
                               device=dev).to(torch.bfloat16)
                   for h in (shape[1], shape[2], shape[2]))
        for causal in (True, False):
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q.reshape(-1, 1024, hd),
                                     k.reshape(-1, 1024, hd),
                                     v.reshape(-1, 1024, hd),
                                     causal=causal).reshape(got.shape)
            over = excess(got, want, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
            err_hd = (got.float() - want.float()).abs().max().item()
            log(f"flash_attention {shape} causal={causal} bf16 "
                f"({ops.design(torch.bfloat16, hd)}): max abs err "
                f"{err_hd:.3e}, largest excess over one output rounding "
                f"{over:.3e}")
            if not (over <= 0 and err_hd <= 2e-2):
                raise AssertionError(f"flash_attention bf16 D={hd}: beyond "
                                     f"one output rounding by {over}")
    return kernel_entry(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:67", ms, plain_ms,
        lib_ms, err, nbytes, flops)


# ---------------------------------------------------------------------------
# phase 9: the LM path at full width
# ---------------------------------------------------------------------------

def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def run_lm_path(dev) -> dict[str, int]:
    """Phase 9.  Returns the launch counts of one forward."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import Model
    cfg = get_config(LM_ARCH)
    (batch, seq), cmp_seq = LM_FORWARD, LM_COMPARE_SEQ
    gen_batch, prompt, new_tokens = LM_GENERATE
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, dtype=torch.bfloat16, generator=g,
                  use_flash_kernel=True)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, {n_params / 1e9:.3f} B parameters "
        f"in bf16 ({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB), drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                           device=dev)
    with torch.inference_mode():
        K.reset_launches()
        logits = model(tokens)
        torch.cuda.synchronize(dev)
        counts = dict(K.launches)
        if logits.shape != (batch, seq, model.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"forward: logits {tuple(logits.shape)} "
                                 f"not finite or of the wrong shape")
        del logits
        if not counts["flash_attention"] == \
                counts["flash_attention_wgmma"] == cfg.n_layers:
            raise AssertionError(
                f"forward launched flash_attention "
                f"{counts['flash_attention']} times, "
                f"{counts['flash_attention_wgmma']} of them the tensor-core "
                f"design; want {cfg.n_layers} and {cfg.n_layers}")
        runs = []
        for _ in range(REPS):
            s = time.perf_counter()
            model(tokens)
            torch.cuda.synchronize(dev)
            runs.append((time.perf_counter() - s) * 1e3)
        med = statistics.median(runs)
        by_name = device_time_by_kernel(lambda: model(tokens))
        busy = sum(by_name.values())
        log(f"forward B={batch} S={seq} through the flash kernel: median of "
            f"{REPS} {med:.1f} ms ({batch * seq / med * 1e3:.0f} tokens/s; "
            f"runs {', '.join(f'{r:.1f}' for r in runs)}); launches "
            f"{json.dumps(counts)}")
        log(busy_line(f"forward B={batch} S={seq}", busy, med))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("forward device time by kernel: " + "; ".join(
            f"{name[:72]} {ms:.1f} ms" for name, ms in top))

        short = tokens[:1, :cmp_seq]
        fast16, plain16 = logits_with_and_without_kernel(model, short)
        last, _ = model.prefill(short, model.init_cache(1, cmp_seq + 8))
        rel_p = rel_l2(last[:, 0], plain16[:, -1])
        same_p = bool((last[:, 0].argmax(-1) == plain16[:, -1].argmax(-1))
                      .all())
        del last
        log(f"B=1 S={cmp_seq} bf16: prefill's last-token logits vs "
            f"forward's: relative L2 {rel_p:.3e}, argmax equal {same_p}")
    prompts = torch.randint(0, cfg.vocab, (gen_batch, prompt), generator=g,
                            device=dev)
    out = serve_lm.generate(model, prompts, new_tokens, 0.8, g)
    ids = out.tokens
    if ids.shape != (gen_batch, new_tokens) or \
            not bool(((ids >= 0) & (ids < cfg.vocab)).all()):
        raise AssertionError(f"generate: ids {tuple(ids.shape)} out of range")
    steps = new_tokens - 1
    log(f"generate B={gen_batch} prompt={prompt} new={new_tokens}: prefill "
        f"{out.prefill_s * 1e3:.1f} ms, decode {out.decode_s / steps * 1e3:.2f}"
        f" ms a step, {gen_batch * steps / out.decode_s:.1f} decoded tokens/s,"
        f" {gen_batch * new_tokens / (out.prefill_s + out.decode_s):.1f} "
        f"tokens/s overall; first ids {ids[0, :8].tolist()}")
    with torch.inference_mode():
        # one decode step of that batch, host clock against device time
        cache = model.init_cache(gen_batch, prompt + 8)
        logits, cache = model.prefill(prompts, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)

        def step():
            return model.decode(tok, cache, prompt)

        runs = []
        for _ in range(REPS):
            torch.cuda.synchronize(dev)
            s = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            runs.append((time.perf_counter() - s) * 1e3)
        log(busy_line(f"decode step B={gen_batch} at position {prompt}",
                      device_busy_ms(step), statistics.median(runs)))
        del cache, logits
    log(f"LM path (bf16): peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    # The same weights in float32 (49 GB): with and without the kernel,
    # where rounding no longer hides the kernel, and the float32 plain path
    # as the yardstick of bf16 rounding alone.
    del out, prompts, tokens
    torch.backends.cuda.matmul.allow_tf32 = False       # full float32 GEMMs
    model.float()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        fast32, plain32 = logits_with_and_without_kernel(model, short)
        last, _ = model.prefill(short, model.init_cache(1, cmp_seq + 8))
        rel_p32 = rel_l2(last[:, 0], plain32[:, -1])
        same_p32 = bool((last[:, 0].argmax(-1) == plain32[:, -1].argmax(-1))
                        .all())
        del last
    log(f"B=1 S={cmp_seq} float32: prefill's last-token logits vs forward's:"
        f" relative L2 {rel_p32:.3e}, argmax equal {same_p32}")
    if not (rel_p32 <= LM_F32_REL_L2 and same_p32):
        raise AssertionError(f"prefill's last-token logits differ from "
                             f"forward's (float32): rel L2 {rel_p32}")
    rows = [("bf16, kernel vs plain attention", fast16, plain16),
            ("float32, kernel vs plain attention", fast32, plain32),
            ("plain attention, bf16 vs float32", plain16, plain32),
            ("bf16 kernel vs float32 plain attention", fast16, plain32)]
    got = {}
    for label, a, b in rows:
        got[label] = (rel_l2(a, b), top1_agreement(a, b))
        log(f"B=1 S={cmp_seq} logits, {label}: relative L2 "
            f"{got[label][0]:.3e}, top-1 agreement {got[label][1]:.4f}")
    rel, top1 = got["float32, kernel vs plain attention"]
    if not (rel <= LM_F32_REL_L2 and top1 >= 0.99):
        raise AssertionError(f"forward with the kernel differs from forward "
                             f"without (float32): rel L2 {rel}, top-1 {top1}")
    # bf16 rounding alone moves the plain path's logits this far from
    # float32; a fault in the bf16 kernel would move the kernel path further
    bf16_rounding = got["plain attention, bf16 vs float32"][0]
    kernel16 = got["bf16 kernel vs float32 plain attention"][0]
    if not kernel16 <= 1.1 * bf16_rounding:
        raise AssertionError(f"the bf16 kernel path is {kernel16} from the "
                             f"float32 logits, the bf16 plain path "
                             f"{bf16_rounding}")
    if not (rel_p <= 1.1 * bf16_rounding and same_p):
        raise AssertionError(f"prefill's last-token logits differ from "
                             f"forward's (bf16): rel L2 {rel_p}, bf16 "
                             f"rounding {bf16_rounding}")
    return counts


def logits_with_and_without_kernel(model, tokens):
    """Float32 copies of the model's logits through the flash kernel and
    through the plain attention."""
    out = []
    for flash in (True, False):
        model.use_flash_kernel = flash
        out.append(model(tokens).float())
    model.use_flash_kernel = True
    return out


def top1_agreement(a, b) -> float:
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


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
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"  ptxas {name}: {line.strip()}")
    check_tensor_core_sass(K)

    from repro_torch.data import tpch
    t0 = time.perf_counter()
    db10 = tpch.generate(SF_TIMED, seed=SEED)
    log(f"SF {SF_TIMED}: generated in {time.perf_counter() - t0:.1f} s")

    n_li = 60_000_000          # SF 10 lineitem rows
    entries = check_group_kernels(dev)
    check_segsum_minmax(dev, n_li)
    entries.append(check_hash_insert(dev, db10))
    entries.append(check_hash_probe(dev, n_li, 15_000_000))
    entries.append(check_radix_hist(dev, db10))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    skew_counts = run_skew_path(dev, db10)

    counts, db1, refs, sql = run_main_path(dev)
    results = run_timed(dev, db10, sql)
    dist_counts = run_distributed_path(dev, db1, refs)
    snapshot_bytes = reckon_snapshot_bytes(dev, db1)
    from repro_torch.core import planner
    planner.invalidate_stats(db1)       # phase 7c uploads it again
    run_distributed_timed(dev, db10, results)
    run_recovery(dev, db10, results, snapshot_bytes, card)
    run_serving(dev, db10, db1, results, card)
    del db1

    # phases 8 and 9 run with the SF 10 tables freed
    probe_np = db10.tables["lineitem"]["l_orderkey"]
    build_np = db10.tables["orders"]["o_orderkey"]
    planner.invalidate_stats(db10)
    del db10, results
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    entry, probe_counts = check_hash_probe32(dev, probe_np, build_np)
    entries.append(entry)
    del probe_np, build_np
    entries.append(check_flash(dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    lm_counts = run_lm_path(dev)
    # each kernel's launches on the path that runs it: the local main path,
    # the distributed path (the counting rank), the skew statistics, the
    # 32-bit join probe, one forward of the LM path
    for e in entries:
        e["launches"] = {"counting_rank": dist_counts,
                         "radix_hist": skew_counts,
                         "hash_probe32": probe_counts,
                         "flash_attention": lm_counts}.get(
            e["name"], counts)[e["name"]]
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
