"""Public wrappers: bucket-table builds (plain PyTorch), the 64-bit probe of
the hash joins, and the 32-bit probe with its end-to-end join entry point.

The 64-bit build stays plain PyTorch, as the reference builds it outside
Pallas: one stable lexicographic sort by (bucket, key), written as two
stable argsorts (least significant key first), then a dedup and a rank
within each bucket.  Its buckets hold what the reference's (B, C) planes
hold: a bucket's first ``cap`` distinct keys in ascending order, each with
the first row of its key.  They are stored so that a probe usually reads
one 32-byte sector:

  ``heads``     (B, 8) int32, one 32-byte head a bucket: its first two keys
                (int64, columns 0-3), their rows (4, 5), its key count n
                (6) and where its other keys start in ``tails`` (7);
  ``tails``     (R, 2) int64 (key, row) entries: keys 3..n of every
                bucket, packed bucket after bucket.

At the default load (under two keys a bucket) most probes end in the head;
the rest read one or two more sectors of ``tails``.  The build writes
the heads and 16 bytes per further key, where the reference's three (B, C)
int32 planes cost three scattered sectors a probe and a fill of B x C lanes.
A bucket holding more than ``cap`` distinct keys raises the overflow flag,
so the caller re-executes with larger buckets (the runner's capacity
factor).

The 32-bit build is the reference's: one stable argsort by bucket and a
rank within each bucket, with no dedup (build keys are unique by contract),
into (B, C) planes.  Those planes are the contract, so the 32-bit probe is
made fast on them: :func:`probe32_plan` picks its design from C alone (a
loop of 16-byte loads of the key row; lane by lane where C is no multiple
of 4 or a plane is not 16-byte aligned), and :func:`hash_join_probe` hands
it the build's fill counts, so that from C = 32 on a probe reads only a
bucket's filled lanes.
``hash_join_probe_auto`` builds until a capacity holds and probes once.

``hash_probe64`` and ``hash_probe32`` launch ``csrc/hash_probe.cu`` on a CUDA
tensor and run their plain versions (``ref.hash_probe64_ref``,
``ref.hash_probe32_ref``) on a CPU tensor.  ``hash_join_probe`` is an entry
point: it runs on ``cuda`` unless the caller names another device.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import kernels as K
from repro_torch.core.table import resolve_device
from .ref import (bucket_of, bucket_of32, hash_probe32_ref, hash_probe64_ref,
                  murmur32, split64)

__all__ = ["SENTINEL", "next_pow2", "build_bucket_table64", "hash_probe64",
           "build_bucket_table", "Probe32Plan", "probe32_plan", "hash_probe32",
           "hash_join_probe", "hash_join_probe_auto", "bucket_of", "murmur32",
           "split64"]

SENTINEL = -2147483648          # empty lane of both key planes
_c = ctypes.c_void_p
_SIGNATURES = {"hash_probe64": [_c, ctypes.c_longlong, _c, _c, ctypes.c_int,
                                _c, _c],
               "hash_probe32": [_c, ctypes.c_longlong, _c, _c, _c,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, _c,
                                _c]}


def next_pow2(x: int) -> int:
    """Smallest power of two >= x, at least 8 (bucket sizing)."""
    return 1 << max(3, (x - 1).bit_length())


def build_bucket_table64(keys: torch.Tensor, vals: torch.Tensor, buckets: int,
                         cap: int = 16, valid: torch.Tensor | None = None):
    """(m,) int64 keys -> ((B, 8) int32 heads, (R, 2) int64 tails,
    overflowed).

    Invalid rows (``valid`` False) go to a virtual bucket and are dropped.
    Duplicate keys are kept once (their first row), so membership probes
    accept non-unique build sides without inflating a bucket.  Only a
    bucket's first ``cap`` distinct keys are kept; a bucket with more raises
    the flag.
    """
    dev = keys.device
    m = keys.shape[0]
    k64 = keys.to(torch.int64)
    lo, hi = split64(k64)
    b = bucket_of(lo, hi, buckets)
    if valid is not None:
        b = torch.where(valid, b, buckets)          # virtual bucket: dropped
    by_key = torch.argsort(k64, stable=True)
    order = by_key[torch.argsort(b[by_key], stable=True)]
    sb, sk = b[order], k64[order]
    in_bucket = sb < buckets
    dup = torch.zeros(m, dtype=torch.bool, device=dev)
    dup[1:] = (sb[1:] == sb[:-1]) & (sk[1:] == sk[:-1])
    keep = in_bucket & ~dup
    counts = torch.zeros(buckets + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, sb, keep.to(torch.int64))[:buckets]
    start = torch.zeros(buckets + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(counts, 0)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1   # rank among kept
    slot = rank - start[sb]                             # rank in its bucket
    ok = keep & (slot < cap)
    kept = counts.clamp(max=cap)
    spill = torch.zeros(buckets + 1, dtype=torch.int64, device=dev)
    spill[1:] = torch.cumsum((kept - 2).clamp(min=0), 0)
    rows = vals[order]
    # the rows kept, in (bucket, key) order: a bucket's first two go to its
    # head, the rest to the tails, where they land bucket after bucket
    head = torch.nonzero(ok & (slot < 2)).squeeze(1)
    tail = torch.nonzero(ok & (slot >= 2)).squeeze(1)
    heads = torch.zeros((buckets, 8), dtype=torch.int32, device=dev)
    hb, lane = sb[head], slot[head]
    heads.view(torch.int64)[hb, lane] = sk[head]
    heads[hb, 4 + lane] = rows[head].to(torch.int32)
    heads[:, 6] = kept.to(torch.int32)
    heads[:, 7] = spill[:buckets].to(torch.int32)
    tails = torch.stack([sk[tail], rows[tail].to(torch.int64)], dim=1)
    return heads, tails, (counts > cap).any()


def hash_probe64(probe_keys: torch.Tensor, heads: torch.Tensor,
                 tails: torch.Tensor) -> torch.Tensor:
    """(n,) int64 probe keys vs a 64-bit bucket table -> build row or -1
    (int32).  The table is one made by :func:`build_bucket_table64` from
    non-negative build rows; a bucket's keys are distinct, so the first
    match is the only one."""
    if heads.ndim != 2 or heads.shape[1] != 8 or tails.ndim != 2 or \
            tails.shape[1] != 2:
        raise ValueError("hash_probe64: the table is (B, 8) heads and "
                         "(R, 2) tail entries")
    if probe_keys.device.type == "cpu":
        return hash_probe64_ref(probe_keys, heads, tails)
    if probe_keys.device.type != "cuda":
        raise ValueError(f"hash_probe64: unsupported device {probe_keys.device}")
    keys = probe_keys.to(torch.int64).contiguous()
    if heads.dtype != torch.int32 or tails.dtype != torch.int64 or \
            heads.device != keys.device or tails.device != keys.device:
        raise TypeError("hash_probe64: heads must be int32 and tails "
                        "int64 on the probe keys' device")
    heads, tails = heads.contiguous(), tails.contiguous()
    out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    lib = K.load("hash_probe", _SIGNATURES)
    with torch.cuda.device(keys.device):
        rc = lib.hash_probe64(K.ptr(keys), keys.shape[0], K.ptr(heads),
                              K.ptr(tails), heads.shape[0], K.ptr(out),
                              K.stream_of(keys))
    K.check(lib, rc, "hash_probe64")
    K.count_launch("hash_probe64")
    return out


# ---------------------------------------------------------------------------
# the 32-bit probe
# ---------------------------------------------------------------------------

def build_bucket_table(keys: torch.Tensor, vals: torch.Tensor, buckets: int,
                       cap: int = 8):
    """(m,) unique int32 keys -> ((B, C) keys, (B, C) vals, overflowed).

    A bucket's keys fill its lanes front to back in row order; empty lanes
    hold ``SENTINEL`` and -1.  Keys past ``cap`` in a bucket are dropped and
    raise the overflow flag.  Bit-exact with the reference's
    ``build_bucket_table``."""
    bkeys, bvals, _, overflowed = _bucket_table(keys, vals, buckets, cap)
    return bkeys, bvals, overflowed


def _bucket_table(keys, vals, buckets: int, cap: int):
    """:func:`build_bucket_table`'s planes and flag, and each bucket's fill
    count (B,) int32: its filled lanes, at most ``cap``."""
    dev = keys.device
    m = keys.shape[0]
    k32 = keys.to(torch.int32)
    b = bucket_of32(k32, buckets)
    order = torch.argsort(b, stable=True)
    sb = b[order]
    counts = torch.bincount(b, minlength=buckets)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(m, device=dev) - start[sb]
    flat = torch.where(slot < cap, sb * cap + slot.clamp(max=cap - 1),
                       buckets * cap)

    def plane(fill: int, src: torch.Tensor) -> torch.Tensor:
        # one extra slot absorbs every dropped row, then is cut off
        out = torch.full((buckets * cap + 1,), fill, dtype=torch.int32,
                         device=dev)
        out[flat] = src[order].to(torch.int32)
        return out[:-1].reshape(buckets, cap)

    return (plane(SENTINEL, k32), plane(-1, vals),
            counts.clamp(max=cap).to(torch.int32), (counts > cap).any())


@dataclasses.dataclass(frozen=True)
class Probe32Plan:
    """Design of the 32-bit probe kernel (``csrc/hash_probe.cu``): ``loop``
    reads a key row 16 bytes at a time, ``scalar`` lane by lane; ``counts``:
    read only the filled lanes where the caller gives the fill counts."""
    design: str
    counts: bool = True


_PROBE32_DESIGNS = ("scalar", "loop")


def probe32_plan(cap: int, aligned: bool = True) -> Probe32Plan:
    """The 32-bit probe's design for C = ``cap`` lanes, from C alone: the
    loop of 16-byte loads, which needs C a multiple of 4 and 16-byte
    ``aligned`` planes (else lane by lane).  Up to C = 16 a key row is at
    most 64 bytes, read whole at no more cost, and a fill count would only
    add a dependent load; above, the counts cut the sectors read."""
    if not aligned or cap % 4:
        return Probe32Plan("scalar")
    return Probe32Plan("loop", counts=cap > 16)


def hash_probe32(probe_keys: torch.Tensor, bkeys: torch.Tensor,
                 bvals: torch.Tensor,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) int32 probe keys vs a (B, C) int32 bucket table -> the largest
    matching build row or -1 (int32), the max over the bucket's C lanes.
    With ``counts`` ((B,) fill counts of a table whose lanes fill front to
    back and whose empty lanes hold row -1, as :func:`build_bucket_table`
    makes them) only a bucket's first ``counts[b]`` lanes are read; the
    answer is the same."""
    if bkeys.ndim != 2 or bkeys.shape != bvals.shape:
        raise ValueError("hash_probe32: bucket planes must share one (B, C) "
                         "shape")
    if counts is not None and counts.shape != bkeys.shape[:1]:
        raise ValueError("hash_probe32: counts must be (B,)")
    if probe_keys.device.type == "cpu":
        return hash_probe32_ref(probe_keys, bkeys, bvals, counts)
    if probe_keys.device.type != "cuda":
        raise ValueError(f"hash_probe32: unsupported device {probe_keys.device}")
    keys = probe_keys.to(torch.int32).contiguous()
    for t in (bkeys, bvals) + (() if counts is None else (counts,)):
        if t.dtype != torch.int32 or t.device != keys.device:
            raise TypeError("hash_probe32: bucket planes and counts must be "
                            "int32 on the probe keys' device")
    bkeys, bvals = bkeys.contiguous(), bvals.contiguous()
    if counts is not None:
        counts = counts.contiguous()
    buckets, cap = bkeys.shape
    plan = probe32_plan(cap, bkeys.data_ptr() % 16 == 0 and
                        bvals.data_ptr() % 16 == 0)
    out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    lib = K.load("hash_probe", _SIGNATURES)
    with torch.cuda.device(keys.device):
        rc = lib.hash_probe32(K.ptr(keys), keys.shape[0], K.ptr(bkeys),
                              K.ptr(bvals), K.ptr(counts if plan.counts
                                                  else None),
                              buckets, cap,
                              _PROBE32_DESIGNS.index(plan.design), K.ptr(out),
                              K.stream_of(keys))
    K.check(lib, rc, "hash_probe32")
    K.count_launch("hash_probe32")
    return out


def _join_table(build_keys: torch.Tensor, build_vals: torch.Tensor,
                cap: int):
    """The reference's sizing, B = max(128, next_pow2(2 m) / cap), and
    :func:`_bucket_table` of the build side."""
    buckets = max(128, next_pow2(2 * max(1, build_keys.shape[0])) // cap)
    return _bucket_table(build_keys, build_vals, buckets, cap)


def hash_join_probe(probe_keys, build_keys, build_vals, cap: int = 8,
                    device=None):
    """End-to-end 32-bit probe: (matched build value or -1 (int32), build
    overflowed (0-d bool)).

    Builds a (B, ``cap``) table with B = max(128, next_pow2(2 m) / cap), as
    the reference sizes it, and probes it with :func:`hash_probe32`, handing
    it the build's fill counts.  Runs on ``device`` (``cuda`` unless the
    caller names another; raises without CUDA); inputs are moved there."""
    dev = resolve_device(device)
    probe, bk, bv = (torch.as_tensor(t, device=dev)
                     for t in (probe_keys, build_keys, build_vals))
    bkeys, bvals, fill, overflowed = _join_table(bk, bv, cap)
    return hash_probe32(probe, bkeys, bvals, fill), overflowed


def hash_join_probe_auto(probe_keys, build_keys, build_vals, cap: int = 8,
                         max_tries: int = 4, device=None):
    """Capacity escalation on the host: double ``cap`` while the build
    overflows, then probe once, at the cap that held.  Returns (rows, that
    cap), the values of the reference's loop, which probes every build; raises
    if ``max_tries`` builds all overflow.  The engine does not use this
    loop: its joins surface the overflow flag and the runner re-executes the
    query."""
    dev = resolve_device(device)
    probe, bk, bv = (torch.as_tensor(t, device=dev)
                     for t in (probe_keys, build_keys, build_vals))
    for _ in range(max_tries):
        bkeys, bvals, fill, overflowed = _join_table(bk, bv, cap)
        if not bool(overflowed):
            return hash_probe32(probe, bkeys, bvals, fill), cap
        cap *= 2
    raise RuntimeError(f"bucket overflow persists at cap={cap}")
