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
     printed per join method and equal to SF 1's planner-on budget
     (``sortcount.budgets``); then the 22 plans the SQL frontend compiles
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
 7b. recovery (``repro_torch.distributed``) on Q5, Q9 and Q18, with
     launch counters reset just before and read just after: at SF 10 the
     default fault plan (a transient, a corrupt and an overflow) through
     ``QueryRunner`` on a ThreadGroup of 4, each fault fired, the corrupt
     one a real bit flip of a checksummed exchange on the card where the
     plan's first group-by exchanges (Q5, Q9), the final attempt
     byte-identical to a clean run with its wire format and capacity
     factor; a device loss 4 -> 3 (rank 3 at the first exchange) of Q9 at
     SF 10 and of Q5 and Q18 at SF 1, the recovered result byte-identical
     to a clean run on 3 ranks and equal to phase 5's (SF 10) or the
     reference's (SF 1), with each attempt's wall time (the second's is
     the re-partition and upload at N = 3) and the resident GB before and
     after the shrink (lineage resumes are phase 10's ``bench_recovery``);
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
     alone; Q1 and Q6 at SF 10 and SF 1 through ``ProgressiveRunner`` and
     ``QueryServer.submit(tolerance=)``, both answering at the same rung
     (at SF 10 the 1/16 rung, whose sample phase 10 reuses), at SF 1 also
     ``ProgressiveRunner`` climbing the whole ladder with each rung's width
     equal to the rung run alone and ending byte-identical to the exact
     plan, and Q18 served exact as a refused shape (each rung's wall,
     width and coverage are phase 10's ``bench_approx``); at SF 1 every
     rung of Q1, Q6 and a shuffled per-supplier revenue on a ThreadGroup of
     4 equal to the same rung on one device (the counting rank launched),
     and the
     stream under hash joins equal to the sorted server's (the 64-bit probe
     launched); ``footprint_bytes()`` beside the resident and peak GB;
 10. (run after 7c, SF 10 still resident) the paper's benches,
     ``repro_torch.bench.run``'s 13, in this process, at ``BENCH_ARGS``'
     sizes: the recovery and ladder benches at SF 10 (the 1/16 rungs and
     their stratum ranks phase 7c's; each lineage resume byte-identical to
     the full run), then, with SF 10 off the card, the rest in ``run``'s
     order at SF 1 (the skew sweep at SF 0.1) and the reference's sizes,
     the gated ones with
     ``--check`` (any failed gate or error fails the run; the sort tax
     against SF 1's own budgets): their CSV and report lines and each
     bench's seconds, reports under ``results/torch``;
 11. (run after 10, SF 1 still in the host's memory) the SF 1000
     analytics dry-run (``repro_torch.launch.dryrun_analytics``): all 22
     queries at N = 256 and 512, each query's exchange counts and the
     exchange time the paper's model prices on ``tpu_v5e`` and
     ``h100_ib`` (the model's arithmetic, not a measurement), the host
     seconds, and device memory unchanged across it (it allocates
     nothing); then the examples (``examples/torch_*.py``) on the card,
     with launch counters reset just before and read just after: the
     quickstart, the plan and SQL quickstarts and the group-by paths at SF
     1 on phase 4's database, each result equal to phase 4's reference
     (the group-by paths sort 1 / 0 / 0), the distributed driver at SF 1
     on a ThreadGroup of 8 (all 22 equal to phase 4's reference in one
     attempt, with the plans' static exchange counts), and the LM serving
     driver (reduced config); the grouped sums, counts, min/max, the group
     dictionary and the counting rank must each launch;
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
 12. (after 9) the model families at published widths, bf16 weights from a
     seeded generator on the card, each model freed before the next
     (``FAMILY_RUNS``): Granite-MoE-3B-A800M in full (32 layers, 40
     experts padded to 48, top-8), DeepSeek-V2 at depth 4 of 60 (its dense
     first layer and 3 MoE layers; MLA, 160 experts top-6 and 2 shared),
     Zamba2-1.2B and RWKV6-3B in full.  Each: a forward with launch counters
     reset just before and read just after (the counting rank once per
     MoE layer, all three-pass; the flash kernel once per GQA attention,
     the shared block's included, all tensor-core; none for MLA), the
     median of 3 timed forwards, peak device memory, the busy share and
     device time by kernel of a profiled one; ``serve_lm.generate``
     (prefill ms, decode ms a step; the SSMs' prefill is their Python time
     loop).  The first router's and the first flash attention's inputs and
     outputs are captured in a forward of the real model: the router's
     destinations through the counting rank equal ``counting_rank_ref``'s
     exactly; the flash kernel's output (Granite: B 2, 24/8 heads, group 3,
     S 4096, D 64; Zamba2's shared block) lies within phase 8's bf16 limits
     of the plain version on the same q, k, v; Granite's first MoE layer in
     float32 against a plain per-expert version under the same routing
     (relative L2 <= 1e-4, slots equal).  Then, in float32 at full width
     and reduced depth: for Granite and Zamba2 the logits with the flash
     kernel against those without, as phase 9 (relative L2 <= 1e-4, top-1
     agreement >= 0.99); Granite's prefill against forward and the SSMs'
     prefill-then-decode against forward (relative L2 <= 1e-4, argmax
     equal).
  13. (after 12) training (``repro_torch.train``, ``Model.loss``,
     ``launch/train.py``): (a) float32 gradients on the card against the
     CPU, one CPU model's state dict loaded into the card's, for all ten
     configs reduced and Granite-MoE-3B at its published width and depth 2
     (the first MoE layer's routing equal first; the loss and the
     gradients' global norm within relative 1e-5, every gradient leaf
     within relative L2 1e-4); (b) remat "full" against "none" on the
     wide Granite (the loss and the whole gradient within relative L2
     1e-6, the worst leaf printed; the counting
     rank twice a MoE layer against once); (c) Granite-MoE-3B-A800M in
     full, bf16, remat "full", the trainer's model and AdamW settings, 6
     steps of B 4 x S 1024 on the training example's zipf batches (the
     median of steps 2-6, tokens/s, AdamW's share by CUDA events, peak
     device memory, 64 counting-rank launches a step, the idle share and
     device time by kernel of one more, profiled step; every loss and norm
     finite, the parameters changed); (d) ``launch/train.py --smoke`` twice
     into one directory (the second restores step 6 and goes on from 7)
     and ``examples/torch_train_lm.py --steps 20``.
  14. (after 13) the sharded path (``distributed/shardings.py``,
     ``Model.constrain``, ``launch/train.py`` under a mesh) on a one-rank
     nccl group, mesh (data 1, model 1), destroyed at its end: (a) one
     train step of Granite at its published width, depth 2, float32,
     sharded with constrain on, seq_parallel off and on, against the
     unsharded step (loss and the parameters' tree within relative 1e-5, a
     leaf within 1e-4; a second unsharded step printed beside as the noise
     floor); (b) Granite-MoE-3B in full through ``launch/train.py`` on the
     mesh, bf16, remat full, 3 steps of B 4 x S 1024 (the median of steps
     2-3, peak memory, 64 counting-rank launches a step, the idle share of
     one more, profiled step); (c) its sharded forward with the flash
     kernel at B 2 x S 4096 against the unsharded one (max abs difference
     0; 32 flash and 32 counting-rank launches, on the local shards); (d)
     in a subprocess started first and run beside (a)-(c), the LM
     dry-run's cells qwen1_5_110b train_4k 16x16, deepseek_v2_236b
     decode_32k 2x16x16 and rwkv6_3b long_500k 16x16 on a fake group, then
     ``bench_roofline`` over them (host seconds a cell; the subprocess
     never initialises CUDA).
  15. (after 14) the distributed engine across processes, each started by
     ``python -m torch.distributed.run``, its results held to phase 4's
     reference (passed in a file): (a) one process per card (the world
     is ``torch.cuda.device_count()``) over NCCL, a ``TorchDistGroup``
     from ``comm.world_group``: every collective of the exchange on every
     wire dtype against the host's combination, then all 22 queries at SF
     1 under both join methods through ``QueryRunner`` on the group, each
     equal to the reference in one attempt with the plans' static exchange
     counts, the median of 3 warm runs per query, launch counters reset
     just before and read just after (every counting rank by the
     single-pass kernel); (b) four processes on cuda:0 over gloo (NCCL
     refuses two ranks on one card; gloo's send and receive go through the
     host, ``TorchDistGroup.staged``): the collectives on the world and on
     the 3 survivors of rank 3, then Q5, Q9 and Q18 with rank 3 lost at
     the first exchange: its process ends in ``DeviceLost``, the others
     shrink to a process group of 3 and answer equal to the reference.

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
# phase 7b: the queries the reference's recovery benchmark gates
RECOVERY_QUERIES = (5, 9, 18)
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
# phase 10: each bench's arguments: SF 1 at the main path's seed; the NumPy
# baseline at SF 0.1, where its 3 x 22 reference runs take seconds on the
# host, not minutes; the skew sweep at SF 0.1 (the reference's runs it at
# sf 0.005; at SF 1 its JCC-H generation and 8-rank host work took 26.7 s
# of a run that crossed 720 s); the IR-only wire bytes and the exchange sweeps at the
# reference's sizes; the kernels at SF 1's lineitem rows and the LM path's
# attention shape; the sort tax at SF 1 against SF 1's own budgets; the
# recovery and sample-ladder benches at SF 10,
# where a query's run is no longer bound by launches and host overhead (at
# SF 1 a whole query takes 3-8 ms on the card, a snapshot's restore as
# long, and a rung plan's ~500 operations more than its device time), with
# the reference's repetitions; the ladder's rungs share phase 7c's stratum
# ranks
_SF1 = ["--sf", str(SF_MAIN), "--seed", str(SEED)]
BENCH_ARGS = {
    "bench_tpch": _SF1,
    "bench_baseline": ["--sf", "0.1", "--seed", str(SEED)],
    "bench_kernels": ["--rows", "6000000",
                      "--flash", ",".join(map(str, FLASH_SHAPE))],
    "bench_skew": ["--sf", "0.1", "--seed", str(SEED)],
    "bench_q12_plans": _SF1,
    "bench_sort_tax": _SF1,
    "bench_recovery": ["--sf", str(SF_TIMED), "--seed", str(SEED)],
    "bench_serve": [*_SF1, "--baseline"],
    "bench_approx": ["--sf", str(SF_TIMED), "--seed", str(SEED)],
}
BENCH_SF10 = ("bench_recovery", "bench_approx")
# phase 11: the dry-run's device counts (one pod, two pods) and the LM
# serving driver's arguments (reduced config)
DRYRUN_DEVICES = (256, 512)
SERVE_ARGS = ["--batch", "4", "--prompt-len", "32", "--tokens", "16"]
# phase 12: the model families at published widths.  Per family: the depth
# cut (None: full depth), the forward's (B, S) (the SSMs' forward is a
# Python loop over time steps, so their long prompt is generate's prefill,
# and the forward, profiled too, is short), generate's (batch, prompt, new
# tokens; new - 1 decode steps follow the prefill's token), and the depth
# of the float32 comparison at full width.  DeepSeek-V2 keeps its
# first (dense) layer and 3 MoE layers of 60: 236 B parameters are ~472 GB
# in bf16 against the card's 80 GB, the cut ~25 GB.  The SSMs' forward (S
# 64 -> 32) and prompt (512 -> 256) are halved to keep the run under 720 s:
# their profiled forward alone took ~10 s of host time each at S 64
FAMILY_RUNS = {
    "granite_moe_3b_a800m": dict(layers=None, forward=(2, 4096),
                                 generate=(4, 512, 32), f32_layers=4),
    "deepseek_v2_236b": dict(layers=4, forward=(1, 2048),
                             generate=(2, 512, 16), f32_layers=None),
    "zamba2_1_2b": dict(layers=None, forward=(4, 32),
                        generate=(4, 256, 33), f32_layers=8),
    "rwkv6_3b": dict(layers=None, forward=(4, 32),
                     generate=(4, 256, 33), f32_layers=4),
}
# the float32 checks: prefill's last-token logits against forward's (the
# MoE; B 1 x S 1024) and prefill of half the tokens then step-by-step
# decode against forward (the SSMs; B 2 x S 64), relative L2; one MoE
# layer against its plain version under the same routing
FAMILY_F32_SEQ = {"moe": (1, 1024), "ssm": (2, 64)}
FAMILY_F32_REL_L2 = 1e-4
# phase 13: training.  (a) float32 gradients on the card against the CPU:
# every config reduced (B x S), and Granite at its published width cut to
# TRAIN_WIDE_LAYERS layers; the loss and the gradients' global norm at
# relative TRAIN_F32_RTOL, every gradient leaf at relative L2
# TRAIN_GRAD_REL_L2.  (b) remat "full" against "none" on the card, the
# same wide Granite: the loss and the whole gradient at relative L2
# TRAIN_REMAT_REL_L2.  The card's index_add_ adds in no fixed order, so two
# runs without remat differ too (logged beside; full against none read
# 8.99e-7 and 9.08e-7, a leaf alone 9.9e-7); a wrong recompute (other
# routing, a layer left out) moves the gradient by orders more.  (c)
# Granite-MoE-3B in
# full, bf16, remat "full": TRAIN_FULL's steps of (batch, seq) under the
# trainer's AdamW settings.  (d) the trainer's smoke run twice and the
# example once
TRAIN_ARCH = "granite_moe_3b_a800m"
TRAIN_REDUCED_SEQ = (2, 64)
TRAIN_WIDE_LAYERS = 2
TRAIN_WIDE_SEQ = (2, 128)
TRAIN_F32_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 1e-4
TRAIN_REMAT_REL_L2 = 1e-5
TRAIN_FULL = dict(batch=4, seq=1024, steps=6)
TRAIN_SMOKE_ARGS = ["--smoke", "--steps", "6", "--ckpt-every", "3"]
TRAIN_EXAMPLE_ARGS = ["--steps", "20"]
# phase 14: the sharded path on a one-rank mesh.  (a) Granite at its
# published width, depth 2, float32: one sharded train step against the
# unsharded one.  The loss and the gradients' global norm within 1e-5, 10x
# phase 13(b)'s noise floor (two unsharded runs 9.0e-7 relative L2 over
# the gradient); the parameters' whole tree after AdamW within 1e-7, 10x
# this check's own floor (two unsharded steps read 1.02e-8, 9.8e-9 and
# 9.6e-9 on the H100); a leaf 1e-4 (AdamW's first step moves a
# zero-initialised norm scale by about lr * sign(g), so a leaf amplifies
# what the tree averages).
# (b) Granite in full through launch/train.py; (c) its sharded forward with
# the flash kernel at phase 12's shape, equal to the unsharded one; (d)
# three full-width LM dry-run cells (a dense train step on one pod, an MoE
# decode on two, an SSM's long decode), then bench_roofline
SHARD_ARCH = "granite_moe_3b_a800m"
SHARD_WIDE_LAYERS = 2
SHARD_WIDE_SEQ = (2, 128)
SHARD_LOSS_RTOL = 1e-5
SHARD_NORM_RTOL = 1e-5
SHARD_TREE_REL_L2 = 1e-7
SHARD_LEAF_REL_L2 = 1e-4
SHARD_TRAIN = ["--steps", "3", "--batch", "4", "--seq", "1024"]
SHARD_PREFILL = (2, 4096)
DRYRUN_LM_CELLS = (("qwen1_5_110b", "train_4k", False),
                   ("deepseek_v2_236b", "decode_32k", True),
                   ("rwkv6_3b", "long_500k", False))


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` after the seconds since the run started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


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
    work on the card, so a trace with no device event is a failed trace:
    it is logged (with what the trace did hold) and taken again, the last
    time with the session held open 50 ms past the synchronise, for CUPTI
    to deliver late records; three empty traces raise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt, hold in enumerate((0.0, 0.0, 0.05)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(hold)
        # the trace's raw records: prof.events() would first build the
        # host's operator tree, seconds for a train step's ~1e5 records
        events = prof.profiler.kineto_results.events()
        by_name: dict[str, float] = {}
        for k in events:
            if k.device_type() == DeviceType.CUDA:
                by_name[k.name()] = by_name.get(k.name(), 0.0) + \
                    k.duration_ns() / 1e6
        if sum(by_name.values()) > 0:
            return by_name
        kinds: dict[str, int] = {}
        for k in events:
            kinds[str(k.device_type())] = kinds.get(str(k.device_type()),
                                                    0) + 1
        log(f"torch.profiler: trace {attempt + 1} (held {hold * 1e3:.0f} "
            f"ms) recorded no device event; its raw events by device "
            f"{json.dumps(kinds)}")
    raise RuntimeError("torch.profiler recorded no device time for a run "
                       "that launched work on the card, three times")


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
    from repro_torch.core.sortcount import LEGS, SortCounter, budgets
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
        # the counts do not depend on the device: SF 1's budgets are the
        # CPU's counts under SF 1's key domains
        on = LEGS.index((jm, True))
        wrong = {q: (n, budgets(SF_MAIN)[q][on]) for q, n in sorts.items()
                 if n != budgets(SF_MAIN)[q][on]}
        if wrong:
            raise AssertionError(f"join={jm}: sorts (count, budget) off SF "
                                 f"{SF_MAIN}'s budget: {wrong}")
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

def run_recovery(dev, db, db1, results, refs) -> dict[str, int]:
    """Phase 7b: the default fault plan through ``QueryRunner`` on 4 ranks
    at SF 10; a device loss 4 -> 3 at SF 10 (Q9) and at SF 1 (``db1``, Q5
    and Q18, held to the reference's ``refs``).  Lineage resumes are phase
    10's ``bench_recovery``.  Returns the launch counts of the phase."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import backend as B
    from repro_torch.distributed.chaos import ChaosInjector, FaultPlan
    from repro_torch.distributed.fault import QueryRunner, RetryPolicy
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

    # a device loss 4 -> 3: Q9, the deepest tree, at SF 10 from phase 7's
    # resident 4-rank shards; Q5 and Q18 at SF 1, where the host's
    # re-partition at N=3 is a tenth as long
    for q, ddb, sf, truth in ((9, db, SF_TIMED, results),
                              (5, db1, SF_MAIN, refs),
                              (18, db1, SF_MAIN, refs)):
        B.release_shards(ddb, dev, n - 1)
        B.device_shards(ddb, dev, n)
        torch.cuda.synchronize(dev)
        before = gb()
        runner = QueryRunner(ddb, n, device=dev, chaos=ChaosInjector(
            FaultPlan.device_loss(SEED, devices=(3,), cut="exchange")))
        res = runner.run(QUERIES[q])
        torch.cuda.synchronize(dev)
        after = gb()
        label = f"SF {sf} q{q} device loss {n} -> {n - 1}"
        if res.report.outcomes() != ["device_lost", "ok"] or \
                (runner.devices, runner.topology_generation,
                 runner.lost_devices) != (n - 1, 1, (3,)):
            raise AssertionError(f"{label}: outcomes "
                                 f"{res.report.outcomes()}, devices "
                                 f"{runner.devices}, lost "
                                 f"{runner.lost_devices}")
        clean, _, overflow = B.run_distributed(QUERIES[q], ddb, n - 1,
                                               device=dev)
        if overflow or not same_bytes(res.result, clean):
            raise AssertionError(f"{label}: differs from a clean run on "
                                 f"{n - 1} ranks")
        compare(res.result, truth[q], f"{label} vs "
                f"{'run_local' if sf == SF_TIMED else 'the reference'}")
        walls = ", ".join(f"{a.outcome} {a.wall_s * 1e3:.1f} ms"
                          for a in res.report.attempts)
        log(f"{label}: attempts {walls} (the second re-partitions and "
            f"uploads at N={n - 1}); resident {before:.2f} GB before the "
            f"shrink, {after:.2f} GB after; byte-identical to a clean run on "
            f"{n - 1} ranks, equal to "
            f"{'run_local' if sf == SF_TIMED else 'the reference'}'s")
        B.release_shards(ddb, dev, n - 1)
    B.release_shards(db1, dev, n)
    torch.cuda.synchronize(dev)

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
    """The serving bench's stream (``repro_torch.bench.bench_serve``, the
    reference's ``bench_serve._stream()``): every sample of all 22
    templates, round-robin, so consecutive requests come from different
    templates (29 requests)."""
    from repro_torch.bench.bench_serve import stream
    return stream()


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


def approx_paths(dev, db, sf, whole: bool) -> dict:
    """7c.3: what phase 10's ``bench_approx`` (each rung's wall, width and
    coverage, rung 1 against the exact plan) does not drive: for Q1 and Q6
    at ``sf``, ``ProgressiveRunner`` and ``QueryServer.submit(tolerance=)``
    answering at one rung; where ``whole``, also ``ProgressiveRunner``
    climbing the whole ladder at tolerance 0, each rung's width equal to
    the rung run alone and its last answer byte-identical to the exact
    plan, and the server's tolerance-0 answer equal to its exact one; then
    Q18 served exact as a refused shape.  The rungs (and each ladder's
    shared stratum rank) stay cached on ``db`` for phase 10; the caller
    drops them.  Returns the kernels that ``ProgressiveRunner`` and
    ``submit(tolerance=)`` launched."""
    import numpy as np
    from repro_torch.approx import ProgressiveRunner, sampling
    from repro_torch.approx.rewrite import rewrite_for_rung
    from repro_torch.core import backend as B
    from repro_torch.serve import TEMPLATES, QueryServer
    srv = QueryServer(db, device=dev)
    tally = {}
    t0 = time.perf_counter()
    for q in APPROX_QUERIES:
        t = TEMPLATES[q]
        # the host's build of each rung's sample (every rung where whole,
        # else the first), timed before anything else asks for it
        builds, gb = {}, {}
        for den in sampling.LADDER if whole else sampling.LADDER[:1]:
            s = time.perf_counter()
            rw = rewrite_for_rung(t.query, db, den)
            builds[f"1/{den}"] = round(time.perf_counter() - s, 2)
            gb[f"1/{den}"] = round(sum(
                v.nbytes for v in rw.db.tables[sampling.rung_name(
                    "lineitem", den)].values()) / 1e9, 3)
        log(f"SF {sf} q{q}: samples built on the host, s "
            f"{json.dumps(builds)}, GB {json.dumps(gb)} (the rungs of a "
            f"ladder share its stratum rank: the first pays for it)")
        if whole:
            exact, _ = B.run_local(t.query, db, device=dev)
            widths = []
            for den in sampling.LADDER:
                rw = rewrite_for_rung(t.query, db, den)
                out, _ = B.run_local(rw.query, rw.db, device=dev)
                widths.append(rw.finalize(out).rel_width)
            ans = counted(tally, lambda: ProgressiveRunner(
                db, tolerance=0.0, device=dev).run(t.query))
            got_w = [a.ci_width for a in ans.report.attempts]
            if [a.rung for a in ans.report.attempts] != \
                    list(sampling.LADDER) or \
                    not np.allclose(got_w, widths, rtol=1e-7, atol=0.0) or \
                    not same_bytes(ans.result, exact):
                raise AssertionError(f"q{q}: ProgressiveRunner's climb "
                                     f"differs from the rungs run alone")
            if not same_bytes(srv.submit(q, tolerance=0.0), srv.submit(q)):
                raise AssertionError(f"q{q}: the server's rung 1 differs "
                                     f"from its exact answer")
            log(f"SF {sf} q{q}: ProgressiveRunner climbs 1/16 .. 1/1 with "
                f"the widths of the rungs run alone and ends "
                f"byte-identical to the exact plan; the server's "
                f"tolerance-0 answer byte-identical to its exact one")
        ans = counted(tally, lambda: ProgressiveRunner(
            db, tolerance=APPROX_TOLERANCE, device=dev).run(t.query))
        esc = srv.approx_escalations
        counted(tally, lambda: srv.submit(q, tolerance=APPROX_TOLERANCE))
        climbed = srv.approx_escalations - esc
        if sampling.LADDER[climbed] != ans.rung:
            raise AssertionError(f"q{q}: the server answered at rung "
                                 f"1/{sampling.LADDER[climbed]}, the runner "
                                 f"at 1/{ans.rung}")
        log(f"SF {sf} q{q}: at tolerance {APPROX_TOLERANCE} "
            f"ProgressiveRunner and QueryServer.submit answer at rung "
            f"1/{ans.rung} (width {ans.ci_width:.3e})")
    refused = srv.approx_refused
    if not same_bytes(srv.submit(18, tolerance=APPROX_TOLERANCE),
                      srv.submit(18)) or srv.approx_refused != refused + 1:
        raise AssertionError("q18: not served exact as a refused shape")
    log(f"SF {sf} q18: served exact at tolerance {APPROX_TOLERANCE} (every "
        f"sampled rung refused: its grouped sum feeds a HAVING filter), "
        f"approx_refused counted; the approximate paths took "
        f"{time.perf_counter() - t0:.1f} s, rung builds included")
    return tally


def progressive_on_group(dev, db) -> dict:
    """7c.5: each rung of Q1, Q6 and the shuffled supplier revenue on a
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


def rung_breakdown(dev, db, sf) -> None:
    """7c.4: where a rung's time goes against the exact plan's: the device
    time by kernel of one run of Q1's and Q6's 1/16 rung (the sample
    ``approx_paths`` built) and of their exact plans, the six largest."""
    from repro_torch.approx.rewrite import rewrite_for_rung
    from repro_torch.core import backend as B
    from repro_torch.serve import TEMPLATES
    for q in APPROX_QUERIES:
        t = TEMPLATES[q]
        rung = rewrite_for_rung(t.query, db, 16)
        for what, fn in (("rung 1/16", lambda: B.run_local(
                rung.query, rung.db, device=dev)),
                         ("exact", lambda: B.run_local(t.query, db,
                                                       device=dev))):
            by = device_time_by_kernel(fn)
            busy = sum(by.values())
            top = {k[:70]: f"{v:.2f} ({v / busy:.2f})" for k, v in
                   sorted(by.items(), key=lambda kv: -kv[1])[:6]}
            log(f"SF {sf} q{q} {what}: device busy {busy:.2f} ms in "
                f"{len(by)} kernels; the largest, ms (share) "
                f"{json.dumps(top)}")


def hash_stream(dev, db) -> dict:
    """7c.6: one pass of the stream under hash joins at SF 1 against the
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
    ``repro_torch.approx``) on the SF 10 tables, uploaded once, with the
    1/16 rungs of Q1 and Q6 there (they and their ladders' stratum ranks
    stay for phase 10); SF 1 for the batch's reckoning, the whole ladder,
    the ThreadGroup and the hash joins.  Returns the launch counts of the
    phase."""
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
    approximate = approx_paths(dev, db10, SF_TIMED, whole=False)
    require_launches(approximate, ("segsum_sum", "segsum_count"),
                     "the approximate path")
    rung_breakdown(dev, db10, SF_TIMED)
    ladder = approx_paths(dev, db1, SF_MAIN, whole=True)
    require_launches(ladder, ("segsum_sum", "segsum_count"),
                     f"the approximate path at SF {SF_MAIN}")
    ranked = progressive_on_group(dev, db1)
    require_launches(ranked, ("counting_rank",), "the progressive "
                     "ThreadGroup path")
    hashed = hash_stream(dev, db1)
    require_launches(hashed, ("hash_probe64",), "the hash-join stream")
    counts = dict(K.launches)
    log(f"launches on phase 7c: {json.dumps(counts)}; ProgressiveRunner "
        f"and submit(tolerance=) at SF {SF_TIMED} alone "
        f"{json.dumps(approximate)}, at SF {SF_MAIN} alone "
        f"{json.dumps(ladder)}; the ThreadGroup runs alone "
        f"{json.dumps(ranked)}; the hash server alone {json.dumps(hashed)}")
    peak = torch.cuda.max_memory_allocated(dev)
    foot = QueryServer(db10, device=dev).footprint_bytes()
    log(f"SF {SF_TIMED} serve: QueryServer.footprint_bytes() "
        f"{foot / 1e9:.2f} GB (tables x (1 + capacity factor 2)) against "
        f"{resident / 1e9:.2f} GB resident and {serve_peak / 1e9:.2f} GB "
        f"peak over the serving passes ({peak / 1e9:.2f} GB over the whole "
        f"phase, the sample ladders included) ({card})")
    return counts


# ---------------------------------------------------------------------------
# phase 10: the paper's benchmarks (repro_torch.bench)
# ---------------------------------------------------------------------------

def run_benches(dev, db1, db10, card) -> None:
    """Phase 10: every bench of ``repro_torch.bench.run``, in this process
    on ``dev``, at ``BENCH_ARGS``' sizes: first those of ``BENCH_SF10`` on
    ``db10`` (its 1/16 rungs and their ranks built by phase 7c), then, with
    SF 10 off the card, the rest in ``run``'s order (SF 1 on ``db1``); the
    gated benches with ``--check`` (any failed gate raises).  Reports go to
    ``results/torch``."""
    import torch
    from repro_torch.bench import run as bench
    from repro_torch.bench.common import RESULTS, Datasets
    from repro_torch.core import planner
    data = Datasets()
    data.add(db1, SF_MAIN, SEED)
    data.add(db10, SF_TIMED, SEED)
    t0 = time.perf_counter()
    # the SF 10 benches first, on the resident tables and rungs; then SF
    # 10 leaves the card: 8 ranks of the Q12 plans at SF 1 on one card
    # need most of its memory
    first = [n for n in bench.ORDER if n in BENCH_SF10]
    secs = bench.run(first, str(dev), BENCH_ARGS, out_dir=RESULTS,
                     check=True, data=data)
    planner.invalidate_stats(db10)
    planner.invalidate_stats(db1)       # phase 7c's shards and rungs
    gc.collect()
    torch.cuda.empty_cache()
    rest = [n for n in bench.ORDER if n not in first]
    secs.update(bench.run(rest, str(dev), BENCH_ARGS, out_dir=RESULTS,
                          check=True, data=data))
    log(f"phase 10: {len(bench.ORDER)} benches passed in "
        f"{time.perf_counter() - t0:.1f} s (every gate asked), seconds each "
        f"{json.dumps({k: round(v, 1) for k, v in secs.items()})} ({card})")


# ---------------------------------------------------------------------------
# phase 11: the SF 1000 dry-run and the examples
# ---------------------------------------------------------------------------

def load_example(name: str):
    """``examples/torch_<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_dryrun(dev) -> None:
    """11.1: the 22 plans at SF 1000 on each of ``DRYRUN_DEVICES``, priced
    from the IR on the host; nothing is allocated on the card."""
    import torch
    from repro_torch.launch import dryrun_analytics as D
    from repro_torch.queries import QUERIES
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    meta = D.metadata_db()
    for n in DRYRUN_DEVICES:
        t1 = time.perf_counter()
        for q in sorted(QUERIES):
            rec = D.dryrun_query(q, meta, n)
            priced = rec["model_exchange_s_by_cluster"]
            log(f"dry-run SF 1000 n={n} q{q}: {json.dumps(rec['plan'])}, "
                f"{len(rec['exchanges'])} exchanges, "
                f"{sum(e['message_bytes'] for e in rec['exchanges'])} "
                f"message bytes; the model prices them at "
                f"{priced['tpu_v5e'] * 1e3:.3f} ms on tpu_v5e, "
                f"{priced['h100_ib'] * 1e3:.3f} ms on h100_ib; scans "
                f"{rec['scan_bytes_per_dev']} B a device")
        log(f"dry-run SF 1000 n={n}: 22 queries in "
            f"{time.perf_counter() - t1:.2f} s of host time")
    torch.cuda.synchronize(dev)
    if torch.cuda.memory_allocated(dev) != held:
        raise AssertionError("the dry-run allocated on the card: "
                             f"{held} -> {torch.cuda.memory_allocated(dev)} B")
    log(f"dry-run: {len(DRYRUN_DEVICES)} x 22 queries in "
        f"{time.perf_counter() - t0:.2f} s; device memory allocated "
        f"{held} B before and after (model prices, not measurements)")


def run_examples(dev, db1, refs, card) -> dict[str, int]:
    """11.2: the examples on the card, SF 1 on phase 4's database, held to
    phase 4's reference ``refs``.  Returns the launch counts of the
    examples' runs."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.queries import QUERIES
    on_card = ["--device", str(dev)]
    secs = {}
    K.reset_launches()

    t0 = time.perf_counter()
    out = load_example("quickstart").main(on_card, db=db1)
    for q in (1, 6, 19):
        compare(out["results"][q], refs[q], f"quickstart q{q}")
        if out["counts"][q] != QUERIES[q].static_counts():
            raise AssertionError(f"quickstart q{q}: {out['counts'][q]}")
    secs["quickstart"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = load_example("plan_quickstart").main(on_card, db=db1)
    compare({"revenue": np.asarray([out["revenue_local"]])},
            refs[6], "plan_quickstart q6")
    compare(out["q1"], refs[1], "plan_quickstart q1")
    secs["plan_quickstart"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = load_example("sql_quickstart").main(on_card, db=db1)
    compare(out["local"], out["reference"], "sql_quickstart")
    secs["sql_quickstart"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = load_example("groupby_paths").main(on_card, db=db1)
    if out["sorts"] != {"sort": 1, "direct": 0, "hash": 0}:
        raise AssertionError(f"groupby_paths sorts {out['sorts']}")
    if "hash (sortless dictionary)" not in out["explain"][13]:
        raise AssertionError(out["explain"][13])
    secs["groupby_paths"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = load_example("analytics_distributed").main(on_card, db=db1)
    for q in sorted(QUERIES):
        compare(out[q]["result"], refs[q], f"analytics_distributed q{q}")
        counts = QUERIES[q].static_counts()
        if (out[q]["attempts"], out[q]["shuffles"], out[q]["broadcasts"]) \
                != (1, counts["shuffles"], counts["broadcasts"]):
            raise AssertionError(f"analytics_distributed q{q}: {out[q]}")
    secs["analytics_distributed"] = time.perf_counter() - t0
    counts = dict(K.launches)

    before = dict(K.launches)
    t0 = time.perf_counter()
    out = load_example("serve_lm").main(SERVE_ARGS + on_card)
    batch, tokens = int(SERVE_ARGS[1]), int(SERVE_ARGS[5])
    if out["tokens"].shape != (batch, tokens) or out["tokens"].min() < 0:
        raise AssertionError(f"serve_lm tokens {out['tokens'].shape}")
    secs["serve_lm"] = time.perf_counter() - t0
    log(f"serve_lm ({out['arch']}, reduced, float32): prefill "
        f"{out['prefill_ms']:.1f} ms, decode {out['decode_ms']:.1f} ms for "
        f"{tokens - 1} steps; launches {json.dumps(launch_delta(before))}")
    log(f"examples at SF {SF_MAIN} on {dev}: equal to phase 4's reference, "
        f"group-by paths' sorts 1 / 0 / 0, the distributed driver's 22 in "
        f"one attempt each; seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"({card})")
    log(f"launches on the analytics examples: {json.dumps(counts)}")
    require_launches(counts, ("segsum_sum", "segsum_count", "segsum_minmax",
                              "hash_insert", "counting_rank"),
                     "the analytics examples")
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


# ---------------------------------------------------------------------------
# phase 12: the model families at published widths
# ---------------------------------------------------------------------------

def family_config(arch: str, layers: int | None):
    """The published config, its depth cut to ``layers`` where given."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def family_model(cfg, dev, dtype, card, use_flash_kernel=True):
    """The model with weights from a generator seeded with ``SEED`` on the
    card; returns it and the generator."""
    import torch
    from repro_torch.models import Model
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, dtype=dtype, generator=g,
                  use_flash_kernel=use_flash_kernel)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in {str(dtype)[6:]} "
        f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB), drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s ({card})")
    return model, g


def family_forward(model, tokens, label, card):
    """One counted forward (launch counters reset just before, read just
    after), then the median of ``REPS`` timed ones and the device time by
    kernel of a profiled one.  Returns the launch counts."""
    import torch
    from repro_torch import kernels as K
    dev = model.device
    b, s = tokens.shape
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launches()
        logits = model(tokens)
        torch.cuda.synchronize(dev)
        counts = {k: v for k, v in K.launches.items() if v}
        if logits.shape != (b, s, model.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{label} forward: logits "
                                 f"{tuple(logits.shape)} not finite or of "
                                 f"the wrong shape")
        del logits
        runs = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            model(tokens)
            torch.cuda.synchronize(dev)
            runs.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(runs)
        log(f"{label} forward B={b} S={s}: median of {REPS} {med:.1f} ms "
            f"({b * s / med * 1e3:.0f} tokens/s; runs "
            f"{', '.join(f'{r:.1f}' for r in runs)}); peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; launches "
            f"{json.dumps(counts)} ({card})")
        by_name = device_time_by_kernel(lambda: model(tokens))
        log(busy_line(f"{label} forward B={b} S={s}",
                      sum(by_name.values()), med) + f" ({card})")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"{label} forward B={b} S={s} device time by kernel: " +
            "; ".join(f"{name[:64]} {ms:.1f} ms" for name, ms in top))
    return counts


def family_generate(model, g, shape, label, card) -> None:
    """``serve_lm.generate`` of ``new`` tokens after prompts (batch,
    prompt): prefill ms, decode ms a step."""
    import torch
    from repro_torch.launch import serve_lm
    batch, prompt, new = shape
    prompts = torch.randint(0, model.cfg.vocab, (batch, prompt),
                            generator=g, device=model.device)
    torch.cuda.reset_peak_memory_stats(model.device)
    out = serve_lm.generate(model, prompts, new, 0.8, g)
    ids = out.tokens
    if ids.shape != (batch, new) or \
            not bool(((ids >= 0) & (ids < model.cfg.vocab)).all()):
        raise AssertionError(f"{label} generate: ids {tuple(ids.shape)} out "
                             f"of range")
    steps = new - 1
    log(f"{label} generate B={batch} prompt={prompt} new={new}: prefill "
        f"{out.prefill_s * 1e3:.1f} ms, decode "
        f"{out.decode_s / steps * 1e3:.2f} ms a step over {steps} steps, "
        f"{batch * steps / out.decode_s:.1f} decoded tokens/s; peak device "
        f"memory {torch.cuda.max_memory_allocated(model.device) / 1e9:.2f} "
        f"GB; first ids {ids[0, :8].tolist()} ({card})")


class FirstCall:
    """While open, wraps ``module.name`` so that its first call's arguments
    and result are kept (``args``, ``kwargs``, ``out``): what the real
    forward passed to a layer, read without a second copy of the forward."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.args = self.kwargs = self.out = None

    def __enter__(self):
        self.fn = fn = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.out is None:
                self.args, self.kwargs, self.out = args, kwargs, out
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.fn)


def check_router_dest(routed: FirstCall, e: int, i: int, label: str,
                      card: str) -> None:
    """Layer ``i``'s real router destinations (``routed``: its call of
    ``moe.route`` in the forward) through the counting rank (the kernel)
    against ``counting_rank_ref`` on the card, exactly; both timed."""
    import torch
    from repro_torch.core.exchange import _dispatch_offsets
    from repro_torch.kernels.radix_hist import ops as rh
    from repro_torch.kernels.radix_hist.ref import counting_rank_ref
    with torch.inference_mode():
        dest = routed.out[2].reshape(-1).to(torch.int32)
        slot, counts = _dispatch_offsets(dest, e)
        want_slot, want_counts = counting_rank_ref(dest, e + 1)
        if not (torch.equal(slot, want_slot) and
                torch.equal(counts, want_counts[:e])):
            raise AssertionError(f"{label} layer {i}: the counting rank's "
                                 f"slots differ from counting_rank_ref's")
        ms = time_ms(lambda: _dispatch_offsets(dest, e))
        plain_ms = time_ms(lambda: counting_rank_ref(dest, e + 1), reps=2)
    log(f"{label} layer {i} router: {dest.numel()} (token, expert) pairs "
        f"into {e + 1} bins (width {e + 2}, {rh.rank_design(e + 2)}), slots "
        f"equal counting_rank_ref's; rank {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms; the busiest expert takes {int(counts.max())} pairs ({card})")


def check_family_flash(attended: FirstCall, label: str, card: str) -> None:
    """The flash kernel's output in the forward (``attended``: its first
    call there, on the layer's real q, k, v) against the plain version on
    the same inputs, under phase 8's bf16 limits: within one output
    rounding element by element and 2e-2 max abs."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = attended.args
    got = attended.out
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    with torch.inference_mode():
        want = ref.attention_ref(q.reshape(b * hq, s, d),
                                 k.reshape(b * hkv, -1, d),
                                 v.reshape(b * hkv, -1, d),
                                 causal=attended.kwargs["causal"]
                                 ).reshape(got.shape)
        over = excess(got, want, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
        err = (got.float() - want.float()).abs().max().item()
    log(f"{label} flash_attention in the forward (B {b}, Hq {hq}, Hkv {hkv},"
        f" group {hq // hkv}, S {s}, D {d}, {str(q.dtype)[6:]}, "
        f"{ops.design(q.dtype, d)}) against the plain version: max abs err "
        f"{err:.3e}, largest excess over one output rounding (rtol "
        f"{FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}) {over:.3e} ({card})")
    if not (over <= 0 and err <= 2e-2):
        raise AssertionError(f"{label}: the flash kernel in the forward is "
                             f"beyond one output rounding of the plain "
                             f"version by {over} (max abs err {err})")


def plain_dispatch(p, cfg, xt, top_w, top_e, e: int, cap: int):
    """The routed experts' output (T, d) float32 by a stable sort for the
    slots and one product per expert over its kept tokens."""
    import torch
    from repro_torch.models.common import glu_act
    t, d = xt.shape
    k = cfg.top_k
    dest = top_e.reshape(t * k)
    order = torch.sort(dest, stable=True).indices
    first = torch.searchsorted(dest[order], torch.arange(e, device=xt.device))
    slot = torch.empty_like(dest)
    slot[order] = torch.arange(t * k, device=xt.device) - first[dest[order]]
    token_of = torch.arange(t * k, device=xt.device) // k
    w = top_w.reshape(t * k)
    out = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for j in range(e):
        pairs = ((dest == j) & (slot < cap)).nonzero().squeeze(1)
        if pairs.numel():
            xj = xt[token_of[pairs]].float()
            y = glu_act(xj @ p["w_gate"][j].float(), xj @ p["w_up"][j].float(),
                        cfg.act) @ p["w_down"][j].float()
            out.index_add_(0, token_of[pairs], y * w[pairs, None])
    return out, slot


def check_moe_layer_f32(model, i: int, xt, label: str) -> None:
    """One MoE layer in float32 on the card: the dispatch through the
    counting rank against :func:`plain_dispatch` under the same routing
    (so a near-tie in the top-k cannot flip an expert): slots equal,
    output within relative L2 ``FAMILY_F32_REL_L2``."""
    import torch
    from repro_torch.models import moe
    cfg, e = model.cfg, model.padded_experts
    p = {k: v.float() for k, v in model.layers[i].moe.items()}
    x32 = xt.float()
    with torch.inference_mode():
        _, top_w, top_e = moe.route(p, cfg, x32, e)
        cap = moe.capacity(x32.shape[0], cfg, e, model.capacity_factor)
        got, slot, _ = moe.dispatch(p, cfg, x32, top_w, top_e, e, cap)
        want, want_slot = plain_dispatch(p, cfg, x32, top_w, top_e, e, cap)
    rel = rel_l2(got, want)
    kept = float((slot < cap).float().mean())
    log(f"{label} layer {i} in float32 ({x32.shape[0]} tokens, capacity "
        f"{cap}, kept {kept:.4f} of the pairs): the dispatch against the "
        f"plain per-expert version under the same routing: relative L2 "
        f"{rel:.3e}, slots equal {bool(torch.equal(slot.long(), want_slot))}")
    if not (torch.equal(slot.long(), want_slot) and rel <= FAMILY_F32_REL_L2):
        raise AssertionError(f"{label}: the MoE layer differs from its plain "
                             f"version: rel L2 {rel}")


def check_kernel_f32(model, tokens, label: str):
    """Float32: the logits through the flash kernel against those through
    the plain attention, as phase 9 holds them (relative L2 <=
    ``FAMILY_F32_REL_L2``, top-1 agreement >= 0.99).  Returns the plain
    path's logits."""
    import torch
    b, s = tokens.shape
    with torch.inference_mode():
        fast, plain = logits_with_and_without_kernel(model, tokens)
    rel, top1 = rel_l2(fast, plain), top1_agreement(fast, plain)
    log(f"{label} float32 B={b} S={s}: logits with the flash kernel vs "
        f"without: relative L2 {rel:.3e}, top-1 agreement {top1:.4f}")
    if not (rel <= FAMILY_F32_REL_L2 and top1 >= 0.99):
        raise AssertionError(f"{label}: forward with the kernel differs from "
                             f"forward without (float32): rel L2 {rel}, "
                             f"top-1 {top1}")
    return plain


def check_prefill_f32(model, g, label: str) -> None:
    """Float32, full width: the logits with the flash kernel against those
    without (:func:`check_kernel_f32`), then prefill's last-token logits
    against those of the plain-attention forward (both run the same
    routing on the same inputs)."""
    import torch
    b, s = FAMILY_F32_SEQ["moe"]
    tokens = torch.randint(0, model.cfg.vocab, (b, s), generator=g,
                           device=model.device)
    full = check_kernel_f32(model, tokens, label)[:, -1]
    with torch.inference_mode():
        last, _ = model.prefill(tokens, model.init_cache(b, s + 8))
        last = last[:, 0].float()
    rel = rel_l2(last, full)
    same = bool((last.argmax(-1) == full.argmax(-1)).all())
    log(f"{label} float32 B={b} S={s}: prefill's last-token logits vs "
        f"forward's: relative L2 {rel:.3e}, argmax equal {same}")
    if not (rel <= FAMILY_F32_REL_L2 and same):
        raise AssertionError(f"{label}: prefill's last-token logits differ "
                             f"from forward's (float32): rel L2 {rel}")


def check_decode_f32(model, g, label: str, attention: bool) -> None:
    """Float32, full width: where the model has attention, the logits with
    the flash kernel against those without (:func:`check_kernel_f32`);
    then forward's last-token logits against prefill of the first half and
    step-by-step decode of the rest (the reference's
    ``tests/test_models.py`` check)."""
    import torch
    b, s = FAMILY_F32_SEQ["ssm"]
    half = s // 2
    tokens = torch.randint(0, model.cfg.vocab, (b, s), generator=g,
                           device=model.device)
    if attention:
        check_kernel_f32(model, tokens, label)
    with torch.inference_mode():
        full = model(tokens)[:, -1].float()
        logits, cache = model.prefill(tokens[:, :half],
                                      model.init_cache(b, s + 4))
        for i in range(half, s):
            logits, cache = model.decode(tokens[:, i:i + 1], cache, i)
        last = logits[:, 0].float()
    rel = rel_l2(last, full)
    same = bool((last.argmax(-1) == full.argmax(-1)).all())
    log(f"{label} float32 B={b} S={s}: prefill of {half} then {s - half} "
        f"decode steps vs forward's last-token logits: relative L2 "
        f"{rel:.3e}, argmax equal {same}")
    if not (rel <= FAMILY_F32_REL_L2 and same):
        raise AssertionError(f"{label}: decode differs from forward "
                             f"(float32): rel L2 {rel}")


def free_model(dev) -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def run_families(dev, card) -> dict[str, dict]:
    """Phase 12: each family at its published widths in bf16, freed before
    the next.  Returns each one's forward launch counts."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import AttnBlock
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 GEMMs
    out = {}
    for arch, run in FAMILY_RUNS.items():
        t0 = time.perf_counter()
        cfg = family_config(arch, run["layers"])
        label = cfg.name
        if run["layers"] is not None:
            label += (f" (depth cut {family_config(arch, None).n_layers} -> "
                      f"{cfg.n_layers})")
        model, g = family_model(cfg, dev, torch.bfloat16, card)
        b, s = run["forward"]
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
        ssm = cfg.family in ("hybrid", "ssm")
        counts = family_forward(model, tokens, label, card)
        moe_layers = [i for i, layer in enumerate(model.layers)
                      if isinstance(layer, AttnBlock) and layer.kind == "moe"]
        # GQA attention runs the flash kernel in a forward; MLA never does
        n_flash = 0 if cfg.use_mla else len(model.shared_after) + sum(
            isinstance(layer, AttnBlock) for layer in model.layers)
        want = {"counting_rank": len(moe_layers), "counting_rank_onepass": 0,
                "flash_attention": n_flash, "flash_attention_wgmma": n_flash}
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{label} forward launched {got}, want "
                                 f"{want}")
        # the inputs and outputs of the first router and the first flash
        # attention, captured in a forward of the real model
        with torch.inference_mode(), FirstCall(moe, "route") as routed, \
                FirstCall(fa_ops, "flash_attention") as attended:
            model(tokens)
        if moe_layers:
            check_router_dest(routed, model.padded_experts, moe_layers[0],
                              label, card)
            if run["f32_layers"] is not None:
                check_moe_layer_f32(model, moe_layers[0], routed.args[2],
                                    label)
        if n_flash:
            check_family_flash(attended, label, card)
        del routed, attended
        family_generate(model, g, run["generate"], label, card)
        del model, tokens
        free_model(dev)
        if run["f32_layers"] is not None:
            cfg32 = family_config(arch, run["f32_layers"])
            model, g = family_model(cfg32, dev, torch.float32, card)
            label32 = f"{cfg.name} ({cfg32.n_layers} layers)"
            if ssm:
                check_decode_f32(model, g, label32, attention=n_flash > 0)
            else:
                check_prefill_f32(model, g, label32)
            del model
            free_model(dev)
        out[arch] = counts
        log(f"phase 12 {label}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

def loss_and_grads(model, tokens, extra=None):
    """The train step's ``trainstep.loss_and_grads`` on (tokens, tokens),
    the model's parameters turned to require grad -> (loss, aux, gradients
    by name, their global norm in float32, the first MoE layer's ``top_e``
    or None)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.train import trainstep
    model.requires_grad_(True)
    with FirstCall(moe, "route") as routed:
        loss, aux, grads = trainstep.loss_and_grads(
            model, {"tokens": tokens, "labels": tokens, **(extra or {})})
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    top_e = routed.out[2] if routed.out is not None else None
    return loss, aux, grads, gnorm, top_e


def check_train_grads_f32(dev, cfg, shape, label: str) -> dict:
    """13(a): one CPU model, its state dict loaded into the card's, the
    same batch on both: the first MoE layer's routing equal, then the loss
    and the gradients' global norm at relative ``TRAIN_F32_RTOL``, every
    gradient leaf at relative L2 ``TRAIN_GRAD_REL_L2``.  Returns the
    errors."""
    import torch
    from repro_torch.models import Model
    g = torch.Generator().manual_seed(SEED)
    cpu = Model(cfg, device="cpu", dtype=torch.float32, generator=g,
                expert_pad=1)
    card = Model(cfg, device=dev, dtype=torch.float32, expert_pad=1)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, shape, generator=g)
    extra = None
    if cfg.frontend == "vision_patches":
        extra = {"patches": torch.randn((shape[0], cfg.n_prefix,
                                         cfg.d_model), generator=g)}
    want = loss_and_grads(cpu, tokens, extra)
    got = loss_and_grads(card, tokens.to(dev), extra)
    if want[4] is not None and not torch.equal(got[4].cpu(), want[4]):
        raise AssertionError(f"{label}: the first MoE layer routes "
                             f"otherwise on the card (a near-tie in top-k)")
    loss_err = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    norm_err = abs(got[3].item() - want[3].item()) / want[3].item()
    worst, leaf = 0.0, ""
    for name, gw in want[2].items():
        err = rel_l2(got[2][name].cpu(), gw) if gw.norm() > 0 else \
            got[2][name].abs().max().item()
        if err > worst:
            worst, leaf = err, name
    log(f"13a {label} float32 B={shape[0]} S={shape[1]}: card vs CPU loss "
        f"{got[0].item():.6f} ({loss_err:.2e}), grad norm "
        f"{got[3].item():.6f} ({norm_err:.2e}), worst gradient leaf "
        f"{leaf} relative L2 {worst:.3e}"
        + ("; first MoE layer's routing equal" if want[4] is not None
           else ""))
    if not (loss_err <= TRAIN_F32_RTOL and norm_err <= TRAIN_F32_RTOL and
            worst <= TRAIN_GRAD_REL_L2):
        raise AssertionError(f"{label}: card gradients differ from the "
                             f"CPU's: loss {loss_err}, norm {norm_err}, "
                             f"{leaf} {worst}")
    return {"loss": loss_err, "grad_norm": norm_err, "worst_leaf": worst}


def check_remat(dev, cfg, shape, label: str) -> None:
    """13(b): remat "full" against "none" on the card in float32: the loss
    and the whole gradient at relative L2 ``TRAIN_REMAT_REL_L2``; the
    counting rank runs twice a MoE layer (forward and recompute) against
    once.  A second "none" run against the first reads the card's own
    noise floor (its scatter-adds' order), logged beside."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.models import Model
    from repro_torch.models.transformer import segments
    model = Model(cfg, device=dev, dtype=torch.float32, expert_pad=1,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab, shape, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 1))
    out = []
    for remat in ("none", "none", "full"):
        model.remat = remat
        K.reset_launches()
        res = loss_and_grads(model, tokens)
        torch.cuda.synchronize(dev)
        out.append((res, K.launches["counting_rank"]))

    def errors(a, b):
        loss = abs(a[0].item() - b[0].item()) / abs(b[0].item())
        diff = sum((a[2][k] - g).square().sum() for k, g in b[2].items())
        worst, leaf = max((rel_l2(a[2][k], g), k) for k, g in b[2].items()
                          if g.norm() > 0)
        return loss, math.sqrt(diff.item() / b[3].item() ** 2), worst, leaf

    (base, n0), (again, _), (rem, n1) = out
    floor = errors(again, base)
    loss_err, tree, worst, leaf = errors(rem, base)
    n_moe = sum(c for kind, c in segments(cfg) if kind == "moe")
    log(f"13b {label} float32 B={shape[0]} S={shape[1]}: remat full vs "
        f"none: loss {loss_err:.2e}, gradients relative L2 {tree:.3e} (the "
        f"worst leaf {leaf} {worst:.3e}); none vs none: loss "
        f"{floor[0]:.2e}, gradients {floor[1]:.3e} (the worst leaf "
        f"{floor[3]} {floor[2]:.3e}); counting-rank launches {n1} against "
        f"{n0} ({n_moe} MoE layers)")
    if not (loss_err <= TRAIN_REMAT_REL_L2 and tree <= TRAIN_REMAT_REL_L2
            and (n0, n1) == (n_moe, 2 * n_moe)):
        raise AssertionError(f"{label}: remat differs: loss {loss_err}, "
                             f"gradients {tree}, rank launches {n0}, {n1}")
    del model, out, base, again, rem
    free_model(dev)


class CudaTimed:
    """While open, wraps ``module.name`` so that each call is bracketed by
    CUDA events on the current stream; ``ms()`` sums their elapsed times
    (read after a synchronise)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.events = module, name, []

    def __enter__(self):
        import torch
        self.fn = fn = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.fn)

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def run_train_full(dev, card: str) -> dict[str, int]:
    """13(c): Granite-MoE-3B-A800M in full, bf16, remat "full", the
    trainer's model (experts unpadded, vocabulary padded to 128) and AdamW
    settings, TRAIN_FULL's steps on the example's zipf batches; step 1's
    first router destinations through the counting rank against
    ``counting_rank_ref``, exactly.  Returns the launch counts of the first
    step."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.models import Model, moe
    from repro_torch.train import optimizer, trainstep
    cfg = family_config(TRAIN_ARCH, None)
    b, s, steps = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, dtype=torch.bfloat16, expert_pad=1,
                  vocab_pad=128, remat="full",
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    step = trainstep.make_train_step(model, ocfg)
    state = trainstep.init_train_state(model)
    torch.cuda.synchronize(dev)
    log(f"13c {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters in bf16, {model.padded_experts} experts, vocabulary "
        f"{model.padded_vocab}, remat full; with AdamW's float32 m and v "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB, made in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    params = dict(model.named_parameters())
    watch = [k for k in ("embed", "final_norm", "layers.0.ln1",
                         "layers.0.attn.wq",
                         f"layers.{cfg.n_layers - 1}.moe.w_down", "lm_head")
             if k in params]
    before = {k: params[k].detach().clone() for k in watch}
    synthetic_batch = load_example("train_lm").synthetic_batch
    rng = np.random.default_rng(SEED)
    walls, opt_ms, losses, norms = [], [], [], []
    counts = {}
    for i in range(steps):
        batch = synthetic_batch(rng, cfg.vocab, b, s, dev)
        if i == 0:
            K.reset_launches()
        with CudaTimed(optimizer, "apply_update") as upd, \
                FirstCall(moe, "route") as routed:
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t1) * 1e3)
        opt_ms.append(upd.ms())
        if i == 0:
            counts = {k: v for k, v in K.launches.items() if v}
            check_router_dest(routed, model.padded_experts,
                              cfg.first_dense_layers,
                              f"13c {cfg.name} train step 1", card)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        log(f"13c step {i + 1}: loss {losses[-1]:.4f}, grad norm "
            f"{norms[-1]:.4f}, lr {m['lr'].item():.2e}, {walls[-1]:.1f} ms "
            f"(AdamW {opt_ms[-1]:.1f} ms)")
    med = statistics.median(walls[1:])
    share = statistics.median(o / w for o, w in zip(opt_ms[1:], walls[1:]))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"13c {cfg.name} train step B={b} S={s}: median of steps 2-{steps} "
        f"{med:.1f} ms ({b * s / med * 1e3:.0f} tokens/s; steps "
        f"{', '.join(f'{w:.1f}' for w in walls)}); AdamW's share "
        f"{share:.3f}; peak device memory {peak:.2f} GB; launches of step 1 "
        f"{json.dumps(counts)} ({card})")
    batch = synthetic_batch(rng, cfg.vocab, b, s, dev)
    by_name = device_time_by_kernel(lambda: step(state, batch))
    log(busy_line(f"13c train step B={b} S={s} (one more step, profiled)",
                  sum(by_name.values()), med) + f" ({card})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("13c train step device time by kernel: " +
        "; ".join(f"{name[:64]} {ms:.1f} ms" for name, ms in top))
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"13c: non-finite loss or norm: {losses}, "
                             f"{norms}")
    unchanged = [k for k in watch if torch.equal(params[k], before[k])]
    if unchanged:
        raise AssertionError(f"13c: parameters unchanged after {steps} "
                             f"steps: {unchanged}")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    want = {"counting_rank": 2 * n_moe, "counting_rank_onepass": 0,
            "flash_attention": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"13c: a train step launched {got}, want "
                             f"{want}")
    del model, step, state, params, before, batch, m, routed
    free_model(dev)
    return counts


def run_train_cli(dev, card: str) -> None:
    """13(d): ``launch/train.py`` (smoke) twice into one directory, the
    second restoring the first's last checkpoint and going on; then the
    training example."""
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        args = TRAIN_SMOKE_ARGS + ["--ckpt-dir", tmp]
        first = train.main(args)
        second = train.main(args)
        example = load_example("train_lm").main(
            TRAIN_EXAMPLE_ARGS + ["--ckpt-dir", f"{tmp}/example"])
    n = len(first["steps"])
    if not (first["start"] == 0 and second["start"] == n and
            second["steps"][0] == n + 1 and
            second["model"].device.type == dev.type):
        raise AssertionError(f"13d: the trainer did not restore step {n} "
                             f"and go on: {second['start']}, "
                             f"{second['steps']}")
    losses = list(example.values())
    if not all(math.isfinite(x) for x in first["loss"] + second["loss"] +
               losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"13d: losses {first['loss']}, "
                             f"{second['loss']}, example {example}")
    log(f"13d launch/train.py --smoke on {dev}: steps 1-{n} loss "
        f"{first['loss'][0]:.4f} -> {first['loss'][-1]:.4f}; rerun restored "
        f"step {second['start']}, steps {second['steps'][0]}-"
        f"{second['steps'][-1]} loss {second['loss'][-1]:.4f}; "
        f"examples/torch_train_lm.py {' '.join(TRAIN_EXAMPLE_ARGS)}: "
        f"losses {json.dumps({k: round(v, 4) for k, v in example.items()})}"
        f" ({card})")


def run_training(dev, card: str) -> dict[str, int]:
    """Phase 13.  Returns the launch counts of the full-size train step."""
    import torch
    from repro_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 GEMMs
    errs = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch).reduced()
        errs[arch] = check_train_grads_f32(dev, cfg, TRAIN_REDUCED_SEQ,
                                           f"{cfg.name} (reduced)")
    wide = family_config(TRAIN_ARCH, TRAIN_WIDE_LAYERS)
    label = f"{wide.name} ({wide.n_layers} layers, published width)"
    errs["wide"] = check_train_grads_f32(dev, wide, TRAIN_WIDE_SEQ, label)
    free_model(dev)
    log(f"13a worst: loss {max(e['loss'] for e in errs.values()):.2e}, "
        f"grad norm {max(e['grad_norm'] for e in errs.values()):.2e}, "
        f"gradient leaf {max(e['worst_leaf'] for e in errs.values()):.3e}")
    check_remat(dev, wide, TRAIN_WIDE_SEQ, label)
    counts = run_train_full(dev, card)
    run_train_cli(dev, card)
    return counts


# ---------------------------------------------------------------------------
# phase 14: the sharded path on a mesh of one card
# ---------------------------------------------------------------------------

_DRYRUN_SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch
from repro_torch.launch import dryrun as D
from repro_torch.bench import bench_roofline
out_dir, cells = sys.argv[1], json.loads(sys.argv[2])
for arch, shape, multi_pod in cells:
    t0 = time.perf_counter()
    rec = D.dryrun_cell(arch, shape, multi_pod)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{arch}__{shape}__{rec['mesh']}.json"),
              "w") as f:
        json.dump(rec, f)
    print("CELL " + json.dumps({
        "arch": arch, "shape": shape, "mesh": rec["mesh"],
        "host_s": round(secs, 2), "flops": rec["flops"],
        "traffic_bytes": rec["traffic_bytes"],
        "collective_count": rec["collective_count"],
        "argument_GB": rec["memory"]["argument_bytes"] / 1e9,
        "bottleneck": rec["roofline"]["bottleneck"],
        "step_lower_bound_s": rec["roofline"]["step_lower_bound_s"]}),
        flush=True)
bench_roofline.main(["--results", out_dir])
print("CARD_UNTOUCHED " + json.dumps(not torch.cuda.is_initialized()))
"""


def start_lm_dryrun(tmp: str):
    """14(d), started first: the three full-width dry-run cells and
    ``bench_roofline`` in a subprocess (the fake group of 256 or 512 ranks
    cannot share a process with nccl), beside 14(a)-(c)."""
    cells = json.dumps([list(c) for c in DRYRUN_LM_CELLS])
    return subprocess.Popen([sys.executable, "-c", _DRYRUN_SCRIPT, tmp,
                             cells], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_lm_dryrun(proc, card: str) -> None:
    """14(d): every cell ok, ``bench_roofline``'s line for each, and the
    subprocess never initialised CUDA (nothing allocated on the card)."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"14d: the LM dry-run failed: {err[-3000:]}")
    cells = [json.loads(line[5:]) for line in out.splitlines()
             if line.startswith("CELL ")]
    lines = [line for line in out.splitlines()
             if line.startswith("roofline_")]
    untouched = [json.loads(line.split(" ", 1)[1]) for line in
                 out.splitlines() if line.startswith("CARD_UNTOUCHED ")]
    for c in cells:
        log(f"14d dry-run {c['arch']} {c['shape']} {c['mesh']}: "
            f"{c['host_s']:.1f} s of host time (beside 14a-c); per device "
            f"{c['flops']:.3e} FLOP, {c['traffic_bytes']:.3e} B unfused "
            f"traffic, collectives {json.dumps(c['collective_count'])}, "
            f"arguments {c['argument_GB']:.2f} GB; roofline at h100_ib "
            f"{c['step_lower_bound_s']:.3f} s, {c['bottleneck']}-bound "
            f"(the model's arithmetic on published rates, not a "
            f"measurement)")
    for line in lines:
        log(f"14d bench_roofline: {line}")
    if len(cells) != len(DRYRUN_LM_CELLS) or len(lines) != len(cells) or \
            any("FAILED" in line for line in lines) or untouched != [True]:
        raise AssertionError(f"14d: cells {cells}, lines {lines}, card "
                             f"untouched {untouched}")
    log(f"14d: the dry-run's process never initialised CUDA: device memory "
        f"unchanged; torch.testing._internal.distributed.fake_pg imported "
        f"({card})")


def shard_errors(got: dict, want: dict) -> tuple[float, float, str]:
    """(whole-tree relative L2, the worst leaf's, its name)."""
    diff = sum((got[k].double() - w.double()).square().sum().item()
               for k, w in want.items())
    total = sum(w.double().square().sum().item() for w in want.values())
    worst, leaf = max((rel_l2(got[k], w) if w.norm() > 0 else
                       got[k].abs().max().item(), k)
                      for k, w in want.items())
    return math.sqrt(diff / total), worst, leaf


def check_sharded_step(dev, mesh, card: str) -> None:
    """14(a): one train step of Granite at its published width, depth 2,
    float32, sharded on the mesh (constrain on, seq_parallel off and on)
    against the unsharded step; a second unsharded step reads the card's
    noise floor (its scatter-adds' order)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import kernels as K
    from repro_torch.distributed import shardings as sh
    from repro_torch.models import Model
    from repro_torch.train import optimizer, trainstep
    cfg = family_config(SHARD_ARCH, SHARD_WIDE_LAYERS)
    axes = sh.MeshAxes()
    tokens = torch.randint(0, cfg.vocab, SHARD_WIDE_SEQ, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 1))
    ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=3)

    def one_step(seq_parallel=None):
        sharded = seq_parallel is not None
        model = Model(cfg, device=dev, dtype=torch.float32, expert_pad=1,
                      generator=torch.Generator(device=dev).manual_seed(SEED),
                      constrain=sh.make_constrain(mesh, axes, seq_parallel)
                      if sharded else None)
        batch = {"tokens": tokens, "labels": tokens}
        if sharded:
            sh.distribute_model(model, mesh, axes)
            batch = sh.distribute_tree(batch, sh.batch_specs(axes, batch),
                                       mesh)
        step = trainstep.make_train_step(model, ocfg)
        state = trainstep.init_train_state(model)
        K.reset_launches()
        t0 = time.perf_counter()
        m = step(state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        secs = time.perf_counter() - t0
        params = {k: (p.full_tensor() if isinstance(p, DTensor) else p)
                  .detach().clone() for k, p in model.named_parameters()}
        launches = K.launches["counting_rank"]
        del model, step, state, m
        free_model(dev)
        return loss, params, launches, secs, norm

    def rel(a, b):
        return abs(a - b) / abs(b)

    base = one_step()
    floor = one_step()
    n_moe = cfg.n_layers - cfg.first_dense_layers
    f_tree, f_leaf, f_name = shard_errors(floor[1], base[1])
    log(f"14a {cfg.name} ({cfg.n_layers} layers, published width) float32 "
        f"B={SHARD_WIDE_SEQ[0]} S={SHARD_WIDE_SEQ[1]}: unsharded vs "
        f"unsharded (the noise floor): loss {rel(floor[0], base[0]):.2e}, "
        f"grad norm {rel(floor[4], base[4]):.2e}, parameters after AdamW "
        f"relative L2 {f_tree:.3e} (worst leaf {f_name} {f_leaf:.3e}); "
        f"step {base[3]:.2f} s ({card})")
    for sp in (False, True):
        loss, params, launches, secs, norm = one_step(sp)
        loss_err, norm_err = rel(loss, base[0]), rel(norm, base[4])
        tree, leaf, name = shard_errors(params, base[1])
        log(f"14a sharded on mesh (data 1, model 1), constrain on, "
            f"seq_parallel {'on' if sp else 'off'}: loss {loss:.6f} "
            f"({loss_err:.2e}), grad norm {norm:.6f} ({norm_err:.2e}), "
            f"parameters after AdamW relative L2 {tree:.3e} (worst leaf "
            f"{name} {leaf:.3e}); limits: loss {SHARD_LOSS_RTOL:.0e}, grad "
            f"norm {SHARD_NORM_RTOL:.0e}, tree {SHARD_TREE_REL_L2:.0e}, a "
            f"leaf {SHARD_LEAF_REL_L2:.0e}; counting rank {launches} "
            f"launches on the local shards ({n_moe} MoE layers); step "
            f"{secs:.2f} s (DTensor's first planning included) ({card})")
        if not (loss_err <= SHARD_LOSS_RTOL and norm_err <= SHARD_NORM_RTOL
                and tree <= SHARD_TREE_REL_L2
                and leaf <= SHARD_LEAF_REL_L2 and launches == n_moe):
            raise AssertionError(f"14a: the sharded step differs: loss "
                                 f"{loss_err}, grad norm {norm_err}, tree "
                                 f"{tree}, {name} {leaf}, launches "
                                 f"{launches}")


def run_sharded_train(dev, card: str) -> dict[str, int]:
    """14(b): Granite-MoE-3B in full through ``launch/train.py``'s loop on
    the mesh (the trainer reuses the group): bf16, remat full, steps of B
    4 x S 1024; the median of steps 2-3, peak memory, the counting rank's
    launches a step, and the idle share of one more, profiled step."""
    import tempfile
    import torch
    from repro_torch import kernels as K
    from repro_torch.distributed import shardings as sh
    from repro_torch.launch import train
    from repro_torch.train import optimizer, trainstep
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        K.reset_launches()
        res = train.main(["--arch", SHARD_ARCH, *SHARD_TRAIN, "--ckpt-dir",
                          tmp, "--ckpt-every", "100"])
        torch.cuda.synchronize(dev)
    counts = {k: v for k, v in K.launches.items() if v}
    steps = len(res["steps"])
    walls = [s * 1e3 for s in res["step_s"]]
    med = statistics.median(walls[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    model, state, mesh = res["model"], res["state"], res["mesh"]
    b, s = int(SHARD_TRAIN[3]), int(SHARD_TRAIN[5])
    tokens = torch.randint(0, model.cfg.vocab, (b, s), device=dev)
    axes = sh.MeshAxes()
    batch = sh.distribute_tree({"tokens": tokens, "labels": tokens},
                               sh.batch_specs(axes, {"tokens": tokens,
                                                     "labels": tokens}),
                               mesh)
    step = trainstep.make_train_step(model, optimizer.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps))
    by_name = device_time_by_kernel(lambda: step(state, batch))
    shape = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))
    log(f"14b launch/train.py {' '.join(SHARD_TRAIN)} on mesh "
        f"{json.dumps(shape)}: {model.cfg.name} in full, "
        f"{str(model.dtype)[6:]}, remat {model.remat}; steps "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms, median of steps "
        f"2-{steps} {med:.1f} ms ({b * s / med * 1e3:.0f} tokens/s); losses "
        f"{', '.join(f'{x:.4f}' for x in res['loss'])}; peak device memory "
        f"{peak:.2f} GB; launches of {steps} steps {json.dumps(counts)} "
        f"({card})")
    log(busy_line(f"14b sharded train step B={b} S={s} (one more step, "
                  f"profiled)", sum(by_name.values()), med) + f" ({card})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("14b sharded train step device time by kernel: " +
        "; ".join(f"{name[:64]} {ms:.1f} ms" for name, ms in top))
    n_moe = model.cfg.n_layers - model.cfg.first_dense_layers
    per_step = n_moe * (2 if model.remat == "full" else 1)  # + recompute
    want = {"counting_rank": per_step * steps, "flash_attention": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want or not all(math.isfinite(x) for x in res["loss"]):
        raise AssertionError(f"14b: launches {got}, want {want}; losses "
                             f"{res['loss']}")
    del model, state, res, step, batch
    free_model(dev)
    return counts


def run_sharded_prefill(dev, mesh, card: str) -> dict[str, int]:
    """14(c): Granite-MoE-3B in full, bf16, with the flash kernel: the
    sharded forward of phase 12's B 2 x S 4096 against the unsharded one,
    element by element, both under ``torch.use_deterministic_algorithms``
    (the MoE combine's bf16 ``index_add`` otherwise adds in no fixed order
    on the card, and a flipped routing decision downstream moved two
    unsharded forwards' logits apart by 6.4); within the difference of two
    unsharded forwards, which is then 0; the flash kernel and the counting
    rank launched on the local shards."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.distributed import shardings as sh
    from repro_torch.models import Model
    cfg = family_config(SHARD_ARCH, None)
    axes = sh.MeshAxes()
    b, s = SHARD_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 2))

    def build(sharded):
        model = Model(cfg, device=dev, dtype=torch.bfloat16, expert_pad=1,
                      use_flash_kernel=True,
                      generator=torch.Generator(device=dev).manual_seed(SEED),
                      constrain=sh.make_constrain(mesh, axes)
                      if sharded else None)
        return sh.distribute_model(model, mesh, axes) if sharded else model

    def timed(fn):
        runs = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.no_grad():
        plain = build(False)
        want = plain(tokens)
        floor = (plain(tokens).float() - want.float()).abs().max().item()
        plain_ms = timed(lambda: plain(tokens))
        del plain
        free_model(dev)
        model = build(True)
        dist_tokens = sh.shard_like(tokens, mesh, sh.Spec("data", None))
        K.reset_launches()
        got = model(dist_tokens)
        torch.cuda.synchronize(dev)
        counts = {k: v for k, v in K.launches.items() if v}
        err = (got.full_tensor().float() - want.float()).abs().max().item()
        ms = timed(lambda: model(dist_tokens))
    torch.use_deterministic_algorithms(deterministic)
    log(f"14c {cfg.name} in full, bf16, flash kernel, forward B={b} S={s} "
        f"on mesh (data 1, model 1): logits max abs difference from the "
        f"unsharded forward {err:.3e} (two unsharded forwards: "
        f"{floor:.3e}); median of {REPS} {ms:.1f} ms "
        f"sharded, {plain_ms:.1f} ms unsharded; launches "
        f"{json.dumps(counts)} ({card})")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    want_counts = {"counting_rank": n_moe, "flash_attention": cfg.n_layers,
                   "flash_attention_wgmma": cfg.n_layers}
    if {k: counts.get(k, 0) for k in want_counts} != want_counts or \
            err > floor:
        raise AssertionError(f"14c: launches {counts}, want {want_counts}; "
                             f"max abs difference {err}")
    del model, got, want
    free_model(dev)
    return counts


def run_sharded(dev, card: str) -> dict[str, int]:
    """Phase 14, on a one-rank nccl group (mesh data 1 x model 1),
    destroyed at its end; 14(d) runs in a subprocess beside 14(a)-(c).
    Returns the launch counts of the sharded forward (14c)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import world_mesh
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 GEMMs
    with tempfile.TemporaryDirectory() as tmp:
        proc = start_lm_dryrun(tmp)
        try:
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1, device_id=dev)
            try:
                mesh = world_mesh(1, 1, False, "cuda")
                t0 = time.perf_counter()
                check_sharded_step(dev, mesh, card)
                t1 = time.perf_counter()
                run_sharded_train(dev, card)
                t2 = time.perf_counter()
                counts = run_sharded_prefill(dev, mesh, card)
                log(f"14a {t1 - t0:.1f} s, 14b {t2 - t1:.1f} s, 14c "
                    f"{time.perf_counter() - t2:.1f} s")
            finally:
                dist.destroy_process_group()
            finish_lm_dryrun(proc, card)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return counts


# ---------------------------------------------------------------------------
# phase 15: the distributed engine across processes, one rank per process
# ---------------------------------------------------------------------------

_PROC_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.proc_worker(sys.argv[2], sys.argv[3]))
"""


def proc_inputs(rank: int, size: int):
    """Rank ``rank``'s input to each collective of 15's check, by the wire's
    dtypes: uint32 values held in int64, int32, float64, bool; (size, 3)."""
    import torch
    x = torch.arange(size * 3, dtype=torch.int64).reshape(size, 3) * 7 + \
        rank * 1000 + 3
    return {"u32": x * 1299709 % (1 << 32) | (1 << 31),
            "i32": (x - 5000).to(torch.int32),
            "f64": torch.sin(x.double()) * 1e6 + 0.1,
            "bool": x % 3 == rank % 2}


def check_collectives(group, label: str) -> None:
    """Every collective the exchange uses, on every dtype the wire ships,
    against what the group's inputs give when combined on the host (the
    reductions in rank order, float sums bit for bit)."""
    import torch
    from repro_torch.core import comm
    n, me = group.size, group.rank
    ins = [proc_inputs(group.global_ranks[r], n) for r in range(n)]
    ring = [(i, (i + 1) % n) for i in range(n)]
    for name, x in ins[me].items():
        xd = x.to(group.device)
        xs = [i[name] for i in ins]
        got = {"all_to_all": group.all_to_all(xd),
               "all_gather": group.all_gather(xd),
               "ppermute": group.ppermute(xd, ring)}
        want = {"all_to_all": torch.stack([v[me] for v in xs]),
                "all_gather": torch.stack(xs),
                "ppermute": xs[(me - 1) % n]}
        if name != "bool":
            for op in comm.REDUCE_OPS:
                got[op] = group.all_reduce(xd, op)
                want[op] = comm._reduce(xs, op)
        for k, w in want.items():
            g = got[k]
            if g.device != group.device or g.dtype != w.dtype or \
                    not torch.equal(g.cpu(), w):
                raise AssertionError(f"{label} rank {me}: {k} of {name} "
                                     f"differs")


def wait_for(path: Path, what: str, timeout: float = 240.0) -> None:
    """Wait until ``path`` exists (the other launch's signal)."""
    deadline = time.perf_counter() + timeout
    while not path.exists():
        if time.perf_counter() > deadline:
            raise TimeoutError(f"15: waited {timeout:.0f} s for {what}")
        time.sleep(0.05)


def proc_worker(mode: str, tmp: str) -> int:
    """One process of 15(a) (``nccl``: one per card) or 15(b) (``gloo``:
    four on cuda:0), started by ``torch.distributed.run``; both launches
    start together.  Each sets up (world, SF 1, the collectives' check),
    then (a) waits until (b) is set up and runs, and (b) waits until (a) is
    done: neither's start-up falls in the other's measured work.  Rank 0
    writes ``<tmp>/<mode>.json``."""
    t_entry = time.time()
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.core import comm
    from repro_torch.data import tpch
    from repro_torch.distributed.chaos import (ChaosInjector, DeviceLost,
                                               FaultPlan)
    from repro_torch.distributed.fault import (QueryRunner, RetryPolicy,
                                               surviving_group)
    from repro_torch.queries import QUERIES
    group = comm.world_group("cuda") if mode == "nccl" else \
        comm.world_group("cuda:0", backend="gloo")
    try:
        refs: dict = {}
        with np.load(Path(tmp) / "refs.npz") as z:
            for k in z.files:
                q, col = k.split("/", 1)
                refs.setdefault(int(q), {})[col] = z[k]
        db = tpch.generate(SF_MAIN, seed=SEED)
        check_collectives(group, f"15 {mode} world")
        if mode == "gloo":
            if group.rank != 3:
                check_collectives(surviving_group(group, (3,)),
                                  "15b survivors")
            group.all_reduce(torch.zeros(1, device=group.device))
            if group.rank == 0:
                (Path(tmp) / "gloo.ready").touch()
            wait_for(Path(tmp) / "nccl.done", "15a to finish")
        else:
            wait_for(Path(tmp) / "gloo.ready", "15b to set up")
        t_work = time.time()
        out = {"world": group.size, "backend": group.backend,
               "device": str(group.device), "staged": sorted(group.staged),
               "name": torch.cuda.get_device_name(group.device)}
        if mode == "nccl":
            K.reset_launches()
            medians = {}
            for jm in ("sorted", "hash"):
                for q in sorted(QUERIES):
                    runner = QueryRunner(db, group, join_method=jm)
                    label = f"15a world={group.size} q{q} join={jm}"
                    res = runner.run(QUERIES[q])       # the first run uploads
                    compare(res.result, refs[q], label)
                    if res.attempts != 1 or \
                            res.stats.counts() != QUERIES[q].static_counts():
                        raise AssertionError(
                            f"{label}: attempts {res.attempts}, exchanges "
                            f"{res.stats.counts()} != static "
                            f"{QUERIES[q].static_counts()}")
                    walls = []
                    for _ in range(REPS):
                        s = time.perf_counter()
                        runner.run(QUERIES[q])
                        walls.append((time.perf_counter() - s) * 1e3)
                    medians[f"{jm}/q{q}"] = statistics.median(walls)
            out["median_ms"] = medians
            out["launches"] = dict(K.launches)
            group.all_reduce(torch.zeros(1, device=group.device))
            if group.rank == 0:
                (Path(tmp) / "nccl.done").touch()
        else:
            recovered = {}
            for q in RECOVERY_QUERIES:
                runner = QueryRunner(
                    db, group, chaos=ChaosInjector(FaultPlan.device_loss(
                        SEED, devices=(3,), cut="exchange")),
                    policy=RetryPolicy(max_attempts=4, backoff_s=0.0))
                label = f"15b q{q} device loss 4 -> 3"
                try:
                    res = runner.run(QUERIES[q])
                except DeviceLost:
                    if group.rank != 3:
                        raise
                    continue
                if group.rank == 3:
                    raise AssertionError(f"{label}: the lost process "
                                         f"answered")
                if res.report.outcomes() != ["device_lost", "ok"] or \
                        (runner.devices, runner.topology_generation,
                         runner.lost_devices) != (3, 1, (3,)):
                    raise AssertionError(
                        f"{label}: outcomes {res.report.outcomes()}, "
                        f"devices {runner.devices}, lost "
                        f"{runner.lost_devices}")
                compare(res.result, refs[q], label)
                recovered[q] = [round(a.wall_s * 1e3, 1)
                                for a in res.report.attempts]
            out["recovered_ms"] = recovered
        out["times"] = {"entry": t_entry, "work": t_work, "end": time.time()}
        if group.rank == 0:
            with open(Path(tmp) / f"{mode}.json", "w") as f:
                json.dump(out, f)
    finally:
        group.close()
    return 0


def start_procs(tmp: str, mode: str, n: int) -> subprocess.Popen:
    """``python -m torch.distributed.run --nproc-per-node n`` of
    :func:`proc_worker`."""
    script = Path(tmp) / "proc_worker.py"
    script.write_text(_PROC_WORKER)
    # to files: the two launches run at once, and a full pipe nobody reads
    # would stop one of them
    with open(Path(tmp) / f"{mode}.log", "w") as log_file:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), str(script), str(ROOT), mode, tmp],
            cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)


def finish_procs(proc: subprocess.Popen, tmp: str, mode: str,
                 timeout: float) -> dict:
    """The launch's rank-0 record; any process that failed fails the
    phase."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        err = (Path(tmp) / f"{mode}.log").read_text()
        raise AssertionError(f"15 {mode}: torch.distributed.run exited "
                             f"{proc.returncode}: {err[-4000:]}")
    with open(Path(tmp) / f"{mode}.json") as f:
        out = json.load(f)
    out["times"]["exit"] = time.time()
    return out


def run_processes(refs: dict, card: str) -> dict[str, int]:
    """Phase 15: (a) all 22 queries at SF 1 under both joins through
    ``QueryRunner`` on a ``TorchDistGroup`` over NCCL, one process per card;
    (b) Q5, Q9, Q18 with a device loss 4 -> 3 across four processes that
    share cuda:0 over gloo.  Returns the launch counts of (a)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.queries import QUERIES
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "refs.npz", **{
            f"{q}/{k}": v for q, r in refs.items() for k, v in r.items()})
        t0 = time.time()
        n = torch.cuda.device_count()
        pa = start_procs(tmp, "nccl", n)
        pb = start_procs(tmp, "gloo", 4)
        try:
            a = finish_procs(pa, tmp, "nccl", timeout=300)
            b = finish_procs(pb, tmp, "gloo", timeout=300)
        finally:
            for p in (pa, pb):
                if p.poll() is None:
                    p.kill()
                    p.wait()
    counts = a["launches"]
    for jm in ("sorted", "hash"):
        med = {q: a["median_ms"][f"{jm}/q{q}"] for q in sorted(QUERIES)}
        log(f"15a SF {SF_MAIN} join={jm}, {a['world']} process(es) over "
            f"{a['backend']} ({a['device']} on rank 0): per-query median of "
            f"{REPS} through QueryRunner (ms) "
            f"{json.dumps({q: round(v, 2) for q, v in med.items()})}, total "
            f"{sum(med.values()):.1f} ms ({card})")
    log(f"15a: world size {a['world']}: {n} card(s) on this host, one "
        f"process each.  With one card this is NCCL's code path with one "
        f"rank: no message crosses a link; NCCL across several cards has "
        f"not run here")
    log(f"15a: all 22 queries under both joins equal phase 4's reference in "
        f"one attempt, exchange counts equal the static counts, every "
        f"collective on every wire dtype as the host combines it; launches "
        f"{json.dumps(counts)}")
    if counts["counting_rank"] <= 0 or \
            counts["counting_rank_onepass"] != counts["counting_rank"]:
        raise AssertionError(f"15a: {counts['counting_rank_onepass']} of "
                             f"{counts['counting_rank']} counting_rank calls "
                             f"ran the single-pass kernel")
    missing = [k for k in ("segsum_sum", "segsum_minmax", "hash_insert",
                           "hash_probe64") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"15a: kernels never launched: {missing}")
    log(f"15b: 4 processes on {b['device']} over gloo (NCCL refuses two "
        f"ranks on one card); collectives staged through the host: "
        f"{b['staged'] or 'none'}; every collective on every wire dtype, on "
        f"the world and on the 3 survivors, as the host combines it")
    for q, walls in b["recovered_ms"].items():
        log(f"15b SF {SF_MAIN} q{q} device loss 4 -> 3 across processes: "
            f"rank 3's process ended in DeviceLost, the survivors shrank to "
            f"a process group of 3 and answered equal to phase 4's "
            f"reference; attempts {walls} ms on rank 0 ({card})")
    for k, r in (("a", a), ("b", b)):
        t = r["times"]
        log(f"15{k} seconds: launch and imports {t['entry'] - t0:.1f}, "
            f"set-up {t['work'] - t['entry']:.1f} (world, SF {SF_MAIN}, the "
            f"collectives; (a) then waits for (b)'s), work "
            f"{t['end'] - t['work']:.1f}, teardown {t['exit'] - t['end']:.1f}")
    return counts


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
    from repro_torch.core import planner
    planner.invalidate_stats(db1)       # phases 7b and 7c upload it again
    run_distributed_timed(dev, db10, results)
    run_recovery(dev, db10, db1, results, refs)
    run_serving(dev, db10, db1, results, card)

    # phase 10 on SF 10, still resident from phase 7c, then on SF 1;
    # phases 8 and 9 with both freed
    run_benches(dev, db1, db10, card)
    t11 = time.perf_counter()
    run_dryrun(dev)
    run_examples(dev, db1, refs, card)
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    probe_np = db10.tables["lineitem"]["l_orderkey"]
    build_np = db10.tables["orders"]["o_orderkey"]
    planner.invalidate_stats(db10)
    planner.invalidate_stats(db1)       # their rungs and shards go too
    del db10, results, db1            # phase 15 holds to phase 4's refs
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
    free_model(dev)
    t12 = time.perf_counter()
    family_counts = run_families(dev, card)
    log(f"phase 12: {time.perf_counter() - t12:.1f} s; forward launches "
        f"{json.dumps(family_counts)}")
    t13 = time.perf_counter()
    train_counts = run_training(dev, card)
    log(f"phase 13: {time.perf_counter() - t13:.1f} s; launches of a "
        f"full-size train step {json.dumps(train_counts)}")
    t14 = time.perf_counter()
    shard_counts = run_sharded(dev, card)
    log(f"phase 14: {time.perf_counter() - t14:.1f} s; launches of the "
        f"sharded forward {json.dumps(shard_counts)}")
    t15 = time.perf_counter()
    proc_counts = run_processes(refs, card)
    log(f"phase 15: {time.perf_counter() - t15:.1f} s; launches on the "
        f"process path {json.dumps(proc_counts)}")
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
