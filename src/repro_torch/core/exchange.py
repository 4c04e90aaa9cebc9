"""Data-exchange operators over a rank group — the paper's core contribution.

The counterpart of ``repro.core.exchange``.  Where the reference names a
``shard_map`` mesh axis, each operator here takes a rank group
(:mod:`repro_torch.core.comm`):

  shuffle    NCCL N^2 ncclSend/Recv (variable sizes)  ->  capacity-bounded
             ``all_to_all`` of per-destination fixed-size row buffers with
             validity counts (the MoE-dispatch idiom).
  broadcast  ncclBroadcast one-to-all ring             ->  ``all_gather``.
             A deliberately naive p2p ring variant (``broadcast_table_p2p``)
             reproduces §7.1 / Figure 19.
  allreduce  ncclAllReduce                             ->  ``all_reduce``.

Wire format (packed exchanges): columns pack into one int32 buffer by the
planner-statistics-driven layout of :mod:`repro_torch.core.wire`, so the
whole table moves in ONE collective.  Row 0 of each per-destination block is
a header: word 0 carries the sender's row count (the paper's size-metadata
round, fused into the payload) and the header also carries the block's
integrity checksum, verified on receive into the ``corrupt`` flag.  A
narrowed column is range-checked at pack time into the ``overflow`` flag.
The ``tamper`` hook maps the received payload to a corrupted copy before
verification (chaos injection).  The per-column mode is the paper's §2.3
baseline: one collective per column plus the metadata round, unchecked.

The shuffle dispatch ranks rows per destination with the counting rank
(``kernels/radix_hist``): the same slots as a stable sort by destination,
with no sort.

Exchange OUTPUTS are masked tables (received rows are front-packed per
sender block; the validity mask exposes them without a sort).
``broadcast_table`` INPUTS are compacted first — the gathered payload is
reconstructed from per-shard counts alone.

Stats: ``ExchangeStats`` reports actual wire bytes (packed words incl. the
header row) and logical dtype-true bytes, equal to the reference's for the
same exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from . import wire as wi
from .relational import _drop_scatter, ensure_compact, hash_partition_ids
from .table import Table
from repro_torch.kernels.radix_hist import ops as _rh_ops

__all__ = [
    "ExchangeStats",
    "pack_columns",
    "unpack_columns",
    "shuffle",
    "broadcast_table",
    "broadcast_table_p2p",
    "partial_to_global",
]

_I32 = torch.int32


@dataclasses.dataclass
class ExchangeStats:
    """Static descriptor of one exchange — feeds the perf models.

    ``message_bytes``/``total_bytes`` are actual wire bytes (packed words x
    4, including the fused counts header row and, in per-column mode, the
    separate metadata round); ``logical_bytes`` is the dtype-true payload
    size per message.  The per-row pair (``row_wire_bytes``,
    ``row_logical_bytes``) is capacity-independent and equals the IR-derived
    static numbers on every backend (``planner.static_wire_stats``).
    """
    kind: str                 # "shuffle" | "broadcast" | "broadcast_p2p" | "gather"
    participants: int         # N
    message_bytes: int        # wire bytes per p2p message / per-shard payload
    total_bytes: int          # wire bytes leaving each device
    collectives: int          # number of collective ops issued
    logical_bytes: int = 0    # dtype-true payload bytes per message
    row_wire_bytes: int = 0   # packed row width on the wire
    row_logical_bytes: int = 0  # dtype-true row width
    wire: str = "wide"        # "narrow" | "wide"

    @property
    def compression(self) -> float:
        """Logical-to-wire row compression ratio (>= 1 when narrowing wins)."""
        return self.row_logical_bytes / max(1, self.row_wire_bytes)


# ---------------------------------------------------------------------------
# column packing
# ---------------------------------------------------------------------------

def _table_format(t: Table, bounds: Mapping | None, narrow: bool | None,
                  ) -> wi.WireFormat:
    if narrow is None:
        narrow = wi.wire_default() == "narrow"
    return wi.plan_wire_format(
        t.names, {n: wi.np_dtype(t[n].dtype) for n in t.names},
        bounds=bounds, narrow=narrow)


def pack_columns(t: Table, wire: Mapping | None = None,
                 narrow: bool | None = None,
                 ) -> tuple[torch.Tensor, wi.WireFormat, torch.Tensor]:
    """Table columns -> ((capacity, words) int32 buffer, format, overflow).

    ``wire`` maps column names to provable ``(lo, hi)`` bounds (planner
    statistics); ``narrow=None`` follows ``REPRO_WIRE``.  Without bounds the
    layout is the legacy full-width format and overflow is always False.
    """
    fmt = _table_format(t, wire, narrow)
    buf, overflow = wi.pack_table(t, fmt)
    return buf, fmt, overflow


def unpack_columns(buf: torch.Tensor, fmt: wi.WireFormat
                   ) -> dict[str, torch.Tensor]:
    return wi.unpack_table(buf, fmt)


def _bitcast_words(v: torch.Tensor) -> torch.Tensor:
    """A column as (n, words) int32: bool widened to a word, 8-byte types
    split in two (the per-column baseline's layout)."""
    if v.dtype == torch.bool:
        v = v.to(_I32)
    return v.contiguous().view(_I32).reshape(v.shape[0], -1)


def _unbitcast(part: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if dt == torch.bool:
        return part[:, 0].to(torch.bool)
    return part.contiguous().view(dt).reshape(part.shape[0])


def _received(cols: dict, counts: torch.Tensor, n: int, cap: int) -> Table:
    """Per-sender blocks of ``cap`` rows, the first ``counts[j]`` of block j
    valid: a masked table, no compaction."""
    pos = torch.arange(cap, device=counts.device)
    valid = (pos[None, :] < counts[:, None]).reshape(n * cap)
    return Table(cols, counts.sum().to(_I32), valid)


# ---------------------------------------------------------------------------
# shuffle
# ---------------------------------------------------------------------------

def _dispatch_offsets(dest: torch.Tensor, num_partitions: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row slot within its destination bucket, and rows per destination.

    ``slot[i]`` is row i's index within its destination bucket (the
    position a stable sort by destination would give it), ``counts[d]`` the
    number of rows headed to d — from the counting rank, with no sort.
    Destinations may include the drop bucket ``num_partitions`` (padding /
    invalid rows); its rows are ranked too but excluded from ``counts``.
    """
    slot, counts = _rh_ops.counting_rank(dest, num_partitions + 1)
    return slot, counts[:num_partitions]


def shuffle(t: Table, key: torch.Tensor, group, cap_per_dest: int,
            packed: bool = True, dest_ids: torch.Tensor | None = None,
            wire: Mapping | None = None, narrow: bool | None = None,
            tamper=None,
            ) -> tuple[Table, torch.Tensor, torch.Tensor, torch.Tensor,
                       ExchangeStats]:
    """Repartition ``t`` by ``hash(key) % N`` across the group's N ranks.

    Returns (table, overflowed, corrupt, per-sender recv counts, stats).  The
    output table has capacity ``N * cap_per_dest``; ``overflowed`` is True
    where a bucket exceeded ``cap_per_dest`` (rows are dropped — the runner
    re-executes with a larger capacity factor) or a narrowed wire lane saw an
    out-of-bounds value.  In packed mode the counts and the integrity
    checksum ride in each block's header row, so the whole exchange is ONE
    ``all_to_all``; ``corrupt`` is True where a received block fails its
    checksum (the per-column baseline ships unchecked).  ``tamper``, if
    given, maps the received payload to a corrupted copy before
    verification, so injected flips are caught.
    """
    N = group.size
    dev = t.device
    dest = torch.where(t.valid_mask(),
                       hash_partition_ids(key, N) if dest_ids is None
                       else dest_ids.to(_I32),
                       N).to(_I32)  # padding rows -> virtual bucket N (dropped)
    slot, counts = _dispatch_offsets(dest, N)
    overflow = (counts > cap_per_dest).any()
    counts_capped = torch.clamp(counts, max=cap_per_dest).to(_I32)
    dest64, slot64 = dest.to(torch.int64), slot.to(torch.int64)
    keep = (slot64 < cap_per_dest) & (dest64 < N)

    if packed:
        # rows scatter into per-destination blocks of cap_per_dest+1 rows:
        # row 0 is the counts header (word 0 = sender's row count for that
        # destination), rows 1.. are the payload — one collective total.
        blk = cap_per_dest + 1
        flat_idx = dest64 * blk + 1 + torch.clamp(slot64, max=cap_per_dest - 1)
        flat_idx = torch.where(keep, flat_idx, N * blk)  # -> dropped
        buf, fmt, ov_wire = pack_columns(t, wire=wire, narrow=narrow)
        overflow = overflow | ov_wire
        send = _drop_scatter(flat_idx, buf, N * blk) \
            .reshape(N, blk, fmt.words)
        cmode = wi.header_mode(fmt.words, cap_per_dest)
        csum = wi.payload_checksum(send[:, 1:, :])
        send[:, 0, 0] = wi.encode_header_word0(counts_capped, csum, cmode)
        if cmode == "word":
            send[:, 0, 1] = wi.encode_checksum_word(counts_capped, csum)
        recv = group.all_to_all(send)
        if tamper is not None:
            recv = recv.clone()
            recv[:, 1:, :] = tamper(recv[:, 1:, :])
        recv_counts = wi.decode_header_word0(recv[:, 0, 0], cmode)
        corrupt = wi.verify_block_checksum(recv[:, 0, :], recv[:, 1:, :],
                                           cmode).any()
        cols = unpack_columns(recv[:, 1:, :].reshape(N * cap_per_dest,
                                                     fmt.words), fmt)
        n_coll = 1
        words = fmt.words
        msg_rows = blk
        row_wire, row_logical = fmt.row_wire_bytes, fmt.row_logical_bytes
        wire_tag = "narrow" if fmt.narrow else "wide"
    else:  # paper-faithful: one collective per column + the metadata round
        corrupt = torch.zeros((), dtype=torch.bool, device=dev)
        flat_idx = dest64 * cap_per_dest + \
            torch.clamp(slot64, max=cap_per_dest - 1)
        flat_idx = torch.where(keep, flat_idx, N * cap_per_dest)
        recv_counts = group.all_to_all(counts_capped.reshape(N, 1))[:, 0]
        cols, words = {}, 0
        for name in t.names:
            part = _bitcast_words(t[name])
            send = _drop_scatter(flat_idx, part, N * cap_per_dest) \
                .reshape(N, cap_per_dest, part.shape[1])
            got = group.all_to_all(send).reshape(N * cap_per_dest,
                                                 part.shape[1])
            cols[name] = _unbitcast(got, t[name].dtype)
            words += part.shape[1]
        n_coll = len(t.names) + 1              # + metadata round
        msg_rows = cap_per_dest
        row_wire = words * 4
        row_logical = sum(t[n].element_size() for n in t.names)
        wire_tag = "wide"

    out = _received(cols, recv_counts, N, cap_per_dest)
    msg = msg_rows * words * 4 + (4 if not packed else 0)  # + metadata ints
    stats = ExchangeStats(
        kind="shuffle", participants=N,
        message_bytes=msg,
        total_bytes=N * msg,
        collectives=n_coll,
        logical_bytes=cap_per_dest * row_logical,
        row_wire_bytes=row_wire,
        row_logical_bytes=row_logical,
        wire=wire_tag,
    )
    return out, overflow, corrupt, recv_counts, stats


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------

def broadcast_table(t: Table, group, packed: bool = True,
                    wire: Mapping | None = None, narrow: bool | None = None,
                    tamper=None,
                    ) -> tuple[Table, torch.Tensor, torch.Tensor,
                               ExchangeStats]:
    """Replicate a distributed table on every rank (paper Fig. 3).

    ``all_gather`` is the ring broadcast of Eq. 1.  Returns (table,
    overflow, corrupt, stats); in packed mode the per-shard row count AND
    payload checksum ride as a header row of the gathered buffer (ONE
    collective), ``overflow`` reports narrowed-lane range violations (always
    False when wide) and ``corrupt`` a per-shard checksum mismatch after the
    optional ``tamper`` hook (per-column mode: always False).
    """
    # the gathered payload is reconstructed from per-shard counts alone, so the
    # payload must be front-compacted — this is a true contiguity boundary
    t = ensure_compact(t)
    N, cap, dev = group.size, t.capacity, t.device
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    corrupt = torch.zeros((), dtype=torch.bool, device=dev)
    if packed:
        buf, fmt, overflow = pack_columns(t, wire=wire, narrow=narrow)
        cmode = wi.header_mode(fmt.words, cap)
        csum = wi.payload_checksum(buf)
        count32 = t.count.to(_I32)
        hdr = torch.zeros((1, fmt.words), dtype=_I32, device=dev)
        hdr[0, 0] = wi.encode_header_word0(count32, csum, cmode)
        if cmode == "word":
            hdr[0, 1] = wi.encode_checksum_word(count32, csum)
        recv = group.all_gather(torch.cat([hdr, buf]))   # (N, cap+1, words)
        if tamper is not None:
            recv = recv.clone()
            recv[:, 1:, :] = tamper(recv[:, 1:, :])
        counts = wi.decode_header_word0(recv[:, 0, 0], cmode)
        corrupt = wi.verify_block_checksum(recv[:, 0, :], recv[:, 1:, :],
                                           cmode).any()
        cols = unpack_columns(recv[:, 1:, :].reshape(N * cap, fmt.words), fmt)
        n_coll, words, msg_rows = 1, fmt.words, cap + 1
        row_wire, row_logical = fmt.row_wire_bytes, fmt.row_logical_bytes
        wire_tag = "narrow" if fmt.narrow else "wide"
    else:
        counts = group.all_gather(t.count.reshape(1).to(_I32))[:, 0]
        cols, words = {}, 0
        for name in t.names:
            part = _bitcast_words(t[name])
            got = group.all_gather(part).reshape(N * cap, part.shape[1])
            cols[name] = _unbitcast(got, t[name].dtype)
            words += part.shape[1]
        n_coll, msg_rows = len(t.names) + 1, cap
        row_wire = words * 4
        row_logical = sum(t[n].element_size() for n in t.names)
        wire_tag = "wide"

    out = _received(cols, counts, N, cap)
    msg = msg_rows * words * 4 + (4 if not packed else 0)
    stats = ExchangeStats(kind="broadcast", participants=N,
                          message_bytes=msg,
                          total_bytes=msg * (N - 1),
                          collectives=n_coll,
                          logical_bytes=cap * row_logical,
                          row_wire_bytes=row_wire,
                          row_logical_bytes=row_logical,
                          wire=wire_tag)
    return out, overflow, corrupt, stats


def broadcast_table_p2p(t: Table, group) -> tuple[Table, ExchangeStats]:
    """§7.1 baseline: emulate broadcast with N-1 p2p ring forwards of the FULL
    buffer — each shard transits every link once per hop instead of being
    pipelined, duplicating inter-node traffic exactly as the paper describes.
    Stays on the WIDE wire format deliberately: it is the paper's unoptimized
    baseline."""
    t = ensure_compact(t)
    N, cap = group.size, t.capacity
    buf, fmt, _ = pack_columns(t, narrow=False)
    counts = group.all_gather(t.count.reshape(1).to(_I32))[:, 0]
    parts = [buf]
    cur = buf
    perm = [(i, (i + 1) % N) for i in range(N)]
    for _ in range(N - 1):
        cur = group.ppermute(cur, perm)
        parts.append(cur)
    # parts[s] came from rank (me - s) % N; put them in rank order 0..N-1
    me = group.rank
    recv = torch.cat([parts[(me - d) % N] for d in range(N)])
    cols = unpack_columns(recv, fmt)
    out = _received(cols, counts, N, cap)
    stats = ExchangeStats(kind="broadcast_p2p", participants=N,
                          message_bytes=cap * fmt.words * 4 + 4,
                          total_bytes=(cap * fmt.words * 4 + 4) * (N - 1),
                          collectives=N,  # N-1 permutes + counts gather
                          logical_bytes=cap * fmt.row_logical_bytes,
                          row_wire_bytes=fmt.row_wire_bytes,
                          row_logical_bytes=fmt.row_logical_bytes,
                          wire="wide")
    return out, stats


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

_REDUCE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def partial_to_global(partials: dict[str, torch.Tensor], ops: dict[str, str],
                      group) -> dict[str, torch.Tensor]:
    """ncclAllReduce equivalent for final scalar aggregation."""
    out = {}
    for k, v in partials.items():
        op = ops[k]
        if op not in _REDUCE:
            raise ValueError(op)
        out[k] = group.all_reduce(v, _REDUCE[op])
    return out
