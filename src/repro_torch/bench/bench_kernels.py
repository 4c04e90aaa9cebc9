"""Kernel microbenches: each of the port's 8 Hopper kernels against its
plain PyTorch version.

Each case builds seeded inputs on ``--device``, holds the wrapper's result
to the plain version (integers and ranks exact, float64 sums within 1e-9,
bf16 attention within one output rounding element by element and 2e-2 max
abs), and times the wrapper, the plain
version and, where one computes the same function, a library call (CUDA
events on the card).  The bound is the least time the card could take: the
bytes the function must move at 3.35 TB/s, for attention its operations at
989 TFLOP/s (bf16), both the H100 SXM's published peaks.  On the CPU the
wrappers run their plain versions, so the times say nothing of a kernel.

Shapes at ``--rows n``: the grouped sum of n float64 rows x 2 into 2049
groups, the count into 8193, the float64 max into 2049 (``segment_reduce``,
which replaces the reference's legacy float32 ``segment_sum``); the
group-dictionary insert of n/4 keys (40 distinct, 90 % valid) into 512
slots; the 64-bit probe of n keys into n/4 at cap 16; the counting rank of
n/4 rows into 5 parts; the partition histogram of n int32 keys into 8
parts a block of 2048, hashed; the 32-bit probe of n keys into n/4 at cap
64 with fill counts; causal GQA attention at ``--flash B,Hq,Hkv,S,D``.

    PYTHONPATH=src python -m repro_torch.bench.bench_kernels [--rows 6000000]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.hash_group import ops as hg
from repro_torch.kernels.hash_group import ref as hg_ref
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.radix_hist import ops as rh
from repro_torch.kernels.radix_hist import ref as rh_ref
from repro_torch.kernels.segsum import ops as ss
from repro_torch.kernels.segsum import ref as ss_ref

from .common import Datasets, emit, kernel_ms, open_device, parser

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores, same
SEED = 0
# bf16 flash attention against its plain version: one output rounding of
# either side (2^-7 of |want| plus float32's 1e-5), and 2e-2 max abs
FLASH_BF16_RTOL = 8e-3
FLASH_BF16_ATOL = 2e-5
FLASH_BF16_MAX_ABS = 2e-2


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The larger of ``nbytes`` at the memory rate and ``flops`` at the
    bf16 rate, in ms, and which of the two it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, \
        "operations" if by_ops > by_bytes else "bytes"


def _exact(name: str, got, want) -> float:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: differs from the plain version")
    return 0.0


def _segsum_cases(dev, n: int, g: torch.Generator):
    gids = {G: torch.randint(0, G + 1, (n,), generator=g, device=dev,
                             dtype=torch.int32) for G in (2049, 8193)}
    vals = torch.randn((n, 2), generator=g, device=dev,
                       dtype=torch.float64) * 1e4
    ids, idx = gids[2049], gids[2049].long()

    def check_sum():
        got = ss.segment_reduce(ids, vals, 2049, "sum")
        want = ss_ref.segment_reduce_ref(ids, vals, 2049, "sum")
        scale = want.abs().max().item()
        if not torch.allclose(got, want, rtol=1e-9, atol=1e-9 * scale):
            raise AssertionError("segsum_sum: beyond 1e-9 of the plain "
                                 "version")
        return (got - want).abs().max().item()

    ones = torch.ones((n, 1), dtype=torch.int64, device=dev)
    cid = gids[8193]
    col = vals[:, :1]
    yield dict(
        name="segsum_sum", shape=f"n={n};G=2049;C=2;float64",
        kernel=lambda: ss.segment_reduce(ids, vals, 2049, "sum"),
        plain=lambda: ss_ref.segment_reduce_ref(ids, vals, 2049, "sum"),
        library=lambda: torch.zeros((2050, 2), dtype=torch.float64,
                                    device=dev).index_add_(0, idx, vals),
        library_name="index_add_", check=check_sum,
        nbytes=n * 4 + n * 16 + 2049 * 16)
    yield dict(
        name="segsum_count", shape=f"n={n};G=8193",
        kernel=lambda: ss.segment_reduce(cid, None, 8193, "count"),
        plain=lambda: ss_ref.segment_reduce_ref(cid, ones, 8193, "sum")[:, 0],
        library=lambda: torch.bincount(cid, minlength=8194),
        library_name="bincount",
        check=lambda: _exact("segsum_count",
                             [ss.segment_reduce(cid, None, 8193, "count")],
                             [ss_ref.segment_reduce_ref(cid, ones, 8193,
                                                        "sum")[:, 0]]),
        nbytes=n * 4 + 8193 * 8)
    yield dict(
        name="segsum_minmax", shape=f"n={n};G=2049;float64;max",
        kernel=lambda: ss.segment_reduce(ids, col, 2049, "max"),
        plain=lambda: ss_ref.segment_reduce_ref(ids, col, 2049, "max"),
        library=lambda: torch.full((2050,), float("-inf"),
                                   dtype=torch.float64, device=dev)
        .scatter_reduce_(0, idx, col[:, 0], "amax"),
        library_name="scatter_reduce_",
        check=lambda: _exact("segsum_minmax",
                             [ss.segment_reduce(ids, col, 2049, "max")],
                             [ss_ref.segment_reduce_ref(ids, col, 2049,
                                                        "max")]),
        nbytes=n * 4 + n * 8 + 2049 * 8)


def _insert_case(dev, n: int, g: torch.Generator):
    m, cap, distinct = max(1, n // 4), 512, 40
    pool = torch.randint(-2**40, 2**40, (distinct,), generator=g, device=dev)
    keys = pool[torch.randint(0, distinct, (m,), generator=g, device=dev)]
    valid = torch.rand(m, generator=g, device=dev) < 0.9
    rounds = hg.default_rounds(cap)

    def check():
        slot, dk, occ, unres = hg.build_group_dict(keys, valid, cap)
        pslot, pdk, pocc, punres = hg_ref.hash_insert_ref(keys, valid, cap,
                                                          rounds)

        def dense(s, d, o):
            rank = hg.dict_rank(d, o)
            return torch.where(s >= 0, rank[s.clamp(min=0).long()], -1)

        if bool(unres) != bool(punres) or \
                not torch.equal(dense(slot, dk, occ),
                                dense(pslot, pdk, pocc)) or \
                not torch.equal(torch.sort(dk[occ]).values,
                                torch.sort(pdk[pocc]).values):
            raise AssertionError("hash_insert: dense ids, key sets or the "
                                 "unresolved flag differ from the plain "
                                 "version's")
        return 0.0

    return dict(
        name="hash_insert", shape=f"n={m};cap={cap};keys={distinct}",
        kernel=lambda: hg.build_group_dict(keys, valid, cap),
        plain=lambda: hg_ref.hash_insert_ref(keys, valid, cap, rounds),
        library=lambda: torch.unique(keys[valid], return_inverse=True),
        library_name="torch.unique", check=check,
        nbytes=m * (8 + 1 + 4) + cap * 12)


def _probe64_case(dev, n: int, g: torch.Generator):
    m = max(1, n // 4)
    build = torch.randperm(m, generator=g, device=dev) + 1
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    buckets = max(128, hp.next_pow2(2 * m) // 4)
    heads, tails, ov = hp.build_bucket_table64(build, rows, buckets, cap=16)
    if bool(ov):
        raise AssertionError("hash_probe64: the build overflowed")
    probe = torch.randint(1, m + m // 10 + 2, (n,), generator=g, device=dev)
    kept = int(heads[:, 6].long().sum())
    return dict(
        name="hash_probe64", shape=f"n={n};build={m};B={buckets};cap=16",
        kernel=lambda: hp.hash_probe64(probe, heads, tails),
        plain=lambda: hp_ref.hash_probe64_ref(probe, heads, tails),
        library=None, library_name=None,
        check=lambda: _exact("hash_probe64",
                             [hp.hash_probe64(probe, heads, tails)],
                             [hp_ref.hash_probe64_ref(probe, heads, tails)]),
        nbytes=n * (8 + 4) + kept * 12)


def _rank_case(dev, n: int, g: torch.Generator):
    m, parts = max(1, n // 4), 5
    keys = torch.randint(0, parts, (m,), generator=g, device=dev,
                         dtype=torch.int32)
    return dict(
        name="counting_rank", shape=f"n={m};parts={parts}",
        kernel=lambda: rh.counting_rank(keys, parts),
        plain=lambda: rh_ref.counting_rank_ref(keys, parts),
        library=None, library_name=None,
        check=lambda: _exact("counting_rank", rh.counting_rank(keys, parts),
                             rh_ref.counting_rank_ref(keys, parts)),
        nbytes=m * 4 + m * 4 + parts * 4)


def _hist_case(dev, n: int, g: torch.Generator):
    parts, blk = 8, 2048
    keys = torch.randint(0, 2**31 - 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    nb = -(-n // blk)
    flat = (torch.arange(n, device=dev) // blk) * parts + \
        rh_ref.bin_of(keys, parts, True)
    return dict(
        name="radix_hist", shape=f"n={n};parts={parts};blk={blk};hashed",
        kernel=lambda: rh.radix_hist(keys, parts, blk=blk, hashed=True),
        plain=lambda: rh_ref.radix_hist_plain(keys, parts, blk, hashed=True),
        library=lambda: torch.bincount(flat, minlength=nb * parts),
        library_name="bincount (binned beforehand)",
        check=lambda: _exact(
            "radix_hist", [rh.radix_hist(keys, parts, blk=blk, hashed=True)],
            [rh_ref.radix_hist_plain(keys, parts, blk, hashed=True)]),
        nbytes=n * 4 + nb * parts * 4)


def _probe32_case(dev, n: int, g: torch.Generator):
    m, cap = max(1, n // 4), 64
    build = (torch.randperm(m, generator=g, device=dev) + 1).to(torch.int32)
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    probe = torch.randint(1, m + m // 10 + 2, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    buckets = max(128, hp.next_pow2(2 * m) // cap)
    bkeys, bvals, ov = hp.build_bucket_table(build, rows, buckets, cap)
    if bool(ov):
        raise AssertionError("hash_probe32: the build overflowed")
    fill = torch.clamp(torch.bincount(hp_ref.bucket_of32(build, buckets),
                                      minlength=buckets),
                       max=cap).to(torch.int32)
    occupied = int((bvals >= 0).sum())
    return dict(
        name="hash_probe32", shape=f"n={n};build={m};B={buckets};C={cap};"
                                   f"fill_counts",
        kernel=lambda: hp.hash_probe32(probe, bkeys, bvals, fill),
        plain=lambda: hp_ref.hash_probe32_ref(probe, bkeys, bvals),
        library=None, library_name=None,
        check=lambda: _exact("hash_probe32",
                             [hp.hash_probe32(probe, bkeys, bvals, fill)],
                             [hp_ref.hash_probe32_ref(probe, bkeys, bvals)]),
        nbytes=n * (4 + 4) + occupied * 8)


def _flash_case(dev, shape, g: torch.Generator):
    b, hq, hkv, s, d = shape
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))

    def plain():
        return fa_ref.attention_ref(q.reshape(b * hq, s, d),
                                    k.reshape(b * hkv, s, d),
                                    v.reshape(b * hkv, s, d)).reshape(q.shape)

    def check():
        got = fa.flash_attention(q, k, v, causal=True).float()
        want = plain().float()
        err = (got - want).abs().max().item()
        if not (err <= FLASH_BF16_MAX_ABS and bool(
                ((got - want).abs() <= FLASH_BF16_RTOL * want.abs()
                 + FLASH_BF16_ATOL).all())):
            raise AssertionError(f"flash_attention: max abs err {err} "
                                 f"beyond one output rounding")
        return err

    return dict(
        name="flash_attention", shape=f"B={b};Hq={hq};Hkv={hkv};S={s};D={d};"
                                      f"causal;bfloat16",
        kernel=lambda: fa.flash_attention(q, k, v, causal=True),
        plain=plain,
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        library_name="scaled_dot_product_attention", check=check,
        nbytes=2 * (q.numel() * 2 + k.numel() + v.numel()),
        flops=4.0 * d * (s * (s + 1) / 2) * b * hq)


def main(argv=None, data: Datasets | None = None) -> list[dict]:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--flash", default="1,4,2,256,64",
                    help="B,Hq,Hkv,S,D of the (bf16) attention case")
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain GEMMs
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = args.rows
    shape = tuple(int(x) for x in args.flash.split(","))
    cases = [*_segsum_cases(dev, n, g), _insert_case(dev, n, g),
             _probe64_case(dev, n, g), _rank_case(dev, n, g),
             _hist_case(dev, n, g), _probe32_case(dev, n, g),
             _flash_case(dev, shape, g)]
    rows = []
    for c in cases:
        err = c["check"]()
        ms = kernel_ms(c["kernel"], dev)
        plain_ms = kernel_ms(c["plain"], dev, reps=2)
        lib_ms = kernel_ms(c["library"], dev) if c["library"] else None
        least, by = bound_ms(c["nbytes"], c.get("flops", 0.0))
        lib = "none" if lib_ms is None else \
            f"{c['library_name']}:{lib_ms * 1e3:.1f}"
        emit(f"kernel_{c['name']}", ms * 1e3,
             f"{c['shape']};plain_us={plain_ms * 1e3:.1f};library_us={lib};"
             f"bound_us={least * 1e3:.1f};bound_by={by};"
             f"max_abs_err={err:.3e};device={label}")
        rows.append({"name": c["name"], "shape": c["shape"], "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": least, "bound_by": by, "max_abs_err": err,
                     "device": label})
    return rows


if __name__ == "__main__":
    main()
