"""Stats-driven wire formats for exchange payloads (bytes-on-the-wire layer).

The paper's speedup story is dominated by cross-device bytes (§2.3, Hockney
§3.6), yet a capacity-padded exchange buffer that ships every column at full
32-bit word granularity pays 4 bytes for a dictionary code that provably fits
8 bits.  This module turns the planner's per-column min/max bounds — the same
statistics that feed ``key_bits`` — into a **wire format**: a deterministic
per-row layout of int32 words where sub-word columns share words as 8/16-bit
lanes.

Lane modes (``ColWire.mode``)
-----------------------------
  ``lane8`` / ``lane16``  biased sub-word lane: the wire value is
                          ``v - lo`` (guaranteed ``0 <= v-lo <= span`` by the
                          planner's bounds), placed at ``shift`` inside word
                          ``word`` by shift/or.  Bool columns are an
                          unconditional ``lane8`` (1 provable bit, no stats
                          needed, no runtime check).
  ``u32``                 biased full word for a >4-byte integer column whose
                          span fits 32 bits (an int64 key at 8 bytes -> 4).
  ``word``                verbatim 4-byte bitcast (float32/int32 without a
                          useful bound; bool in the wide format).
  ``split``               verbatim 8-byte bitcast into two words (float64
                          always — mantissas cannot be range-compressed —
                          and int64 without a provable 32-bit span).
  ``const``               span == 0: the column is NOT shipped at all and is
                          reconstructed from ``lo`` on unpack.

Safety contract
---------------
A narrowed column is never truncated silently: ``pack_table`` range-checks
``v - lo`` against ``span`` on every VALID row and returns an ``overflow``
flag (ORed into ``ctx.overflow`` by the backends -> the fault runner
re-executes, recompiling without inference — and hence at full width — after
a failed capacity escalation).  Invalid (masked / padding) rows are zeroed in
narrowed lanes and excluded from the check; they are reconstructed as ``lo``
on unpack and remain masked.

The WIDE format (``narrow=False`` or no bounds) reproduces the legacy packing
exactly: one word per 4 logical bytes, bool widened to a word — so
``REPRO_WIRE=wide`` is a byte-identical differential leg for the narrow path.
``plan_wire_format`` is pure host arithmetic over (names, dtypes, bounds), so
the static planner and every runtime backend derive the SAME layout and the
IR-derived wire-byte report equals runtime ``ExchangeStats`` on every backend.

Integrity checksum (corruption-not-wrong)
-----------------------------------------
Packed exchanges fuse a per-block **integrity word** into the existing counts
header row: a position-rotated XOR fold of the payload words
(:func:`payload_checksum`), mixed with the row count so a flipped count is as
detectable as a flipped payload bit.  Formats with >= 2 words per row carry
the full 32-bit checksum in header word 1 (``header_mode == "word"``);
single-word formats fold a 16-bit checksum into the high half of the count
word (``"folded"``, valid while the block's row capacity fits 16 bits —
beyond that the exchange ships unchecked, ``"none"``).  Any single bit flip
in payload, count or checksum word changes the verification result.

uint32 arithmetic in torch
--------------------------
torch on the CPU has no ``>>`` or ``%`` for ``uint32``, so every wire word is
handled as its uint32 value held in an int64 tensor (``& 0xFFFFFFFF`` after
each shift), and turned back into int32 bits only when the buffer is built.
torch has no XOR reduction either: the checksum folds by pairwise halving.
A float64 or int64 column splits into two int32 words by ``view``, low word
first, which is the word order of the reference's
``jax.lax.bitcast_convert_type``; the buffers are byte-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "ColWire", "WireFormat", "CorruptPayload", "wire_default",
    "hockney_skip", "plan_wire_format", "pack_table", "unpack_table",
    "np_dtype",
    "row_bytes",
    "payload_checksum", "fold16", "header_mode",
    "encode_header_word0", "encode_checksum_word", "decode_header_word0",
    "verify_block_checksum",
]

_LANE_BITS = {"lane8": 8, "lane16": 16}


class CorruptPayload(RuntimeError):
    """A packed exchange payload failed its integrity checksum (or a chaos
    fault simulated that detection).  Classified CORRUPT by the fault runner:
    the query re-executes on the conservative wide wire format — results are
    never served from a buffer that failed verification."""


def wire_default() -> str:
    """Exchange wire format: ``narrow`` unless REPRO_WIRE selects ``wide``.

    Narrow engages only where the planner supplies bounds (stats-driven by
    construction); with inference off (REPRO_PLANNER=0) every exchange is
    wide regardless of this switch.
    """
    return "wide" if os.environ.get("REPRO_WIRE", "narrow").lower() in \
        ("wide", "0", "off") else "narrow"


# nominal rows per exchange message for the latency-bound test; override with
# the third REPRO_HOCKNEY field
_HOCKNEY_MSG_ROWS = 4096


def hockney_skip(wide_row_bytes: int) -> bool:
    """True when ``REPRO_HOCKNEY="<latency_s>,<inv_bw_s/B>[,<msg_rows>]"``
    prices the exchange message as latency-bound (§3.6): even the un-narrowed
    message of ``wide_row_bytes * msg_rows`` bytes sits below the link's
    half-bandwidth point, so the narrow format's wire saving is dwarfed by
    the constant latency term while its pack/unpack lanes still cost compute
    — narrow packing is skipped.

    Pure host arithmetic on the per-row width and the env-configured model:
    static analysis (``planner.static_wire_stats``) and every backend reach
    the same verdict, so the static report stays equal to runtime stats.
    """
    from . import perfmodel
    model = perfmodel.hockney_from_env()
    if model is None:
        return False
    parts = [p.strip() for p in os.environ.get("REPRO_HOCKNEY", "").split(",")]
    rows = int(parts[2]) if len(parts) > 2 and parts[2] else _HOCKNEY_MSG_ROWS
    return model.latency_bound(wide_row_bytes * rows)


@dataclasses.dataclass(frozen=True)
class ColWire:
    """Wire placement of one column (see module docstring for modes)."""
    name: str
    dtype: np.dtype
    mode: str           # lane8 | lane16 | u32 | word | split | const
    lo: int = 0         # bias (narrowed modes); reconstruction value (const)
    span: int = 0       # provable hi - lo; runtime check bound
    word: int = 0       # first word index in the packed buffer
    shift: int = 0      # bit offset within the word (lane modes)

    @property
    def checked(self) -> bool:
        """True when pack range-checks this column (narrowed int modes)."""
        return self.mode in ("lane8", "lane16", "u32", "const") and \
            self.dtype != np.bool_


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Deterministic row layout: columns -> (words,) int32 per row."""
    cols: tuple[ColWire, ...]
    words: int
    narrow: bool

    @property
    def row_wire_bytes(self) -> int:
        """Packed bytes per row actually shipped."""
        return self.words * 4

    @property
    def row_logical_bytes(self) -> int:
        """Dtype-true bytes per row (bool = 1 byte), the compression basis."""
        return sum(int(np.dtype(c.dtype).itemsize) for c in self.cols)


def np_dtype(dt) -> np.dtype:
    """numpy dtype of a numpy or torch dtype (wire layouts are host math)."""
    if isinstance(dt, torch.dtype):
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


def _norm_dtype(dt) -> np.dtype:
    dt = np.dtype(dt)
    if dt == np.bool_ or dt.kind in "iuf":
        return dt
    raise TypeError(f"unsupported wire dtype {dt}")


def plan_wire_format(names: Sequence[str],
                     dtypes: Mapping[str, np.dtype],
                     bounds: Mapping[str, tuple] | None = None,
                     narrow: bool = True) -> WireFormat:
    """Derive the wire layout for a column set.

    ``bounds[col] = (lo, hi)`` are provable inclusive value bounds (planner
    statistics); columns without bounds ship at full width.  Pure host
    arithmetic: static analysis and every backend call this with the same
    inputs and get the same layout.  Column names are processed sorted, lanes
    are placed widest-first first-fit, so the layout is deterministic.
    """
    narrow = bool(narrow and bounds is not None)
    if narrow:
        # Hockney-driven packing skip: a latency-bound message ships wide
        wide_words = sum(2 if _norm_dtype(dtypes[n]).itemsize > 4 else 1
                         for n in names)
        if hockney_skip(max(1, wide_words) * 4):
            narrow = False
    chosen: list[ColWire] = []
    for nm in sorted(names):
        dt = _norm_dtype(dtypes[nm])
        wide_mode = "word" if dt.itemsize <= 4 else "split"
        if not narrow:
            chosen.append(ColWire(nm, dt, wide_mode))
            continue
        if dt == np.bool_:
            chosen.append(ColWire(nm, dt, "lane8", 0, 1))
            continue
        if dt.kind == "f":
            chosen.append(ColWire(nm, dt, wide_mode))
            continue
        b = bounds.get(nm)
        if b is None or b[0] is None or b[1] is None or b[1] < b[0]:
            chosen.append(ColWire(nm, dt, wide_mode))
            continue
        lo, hi = int(b[0]), int(b[1])
        span = hi - lo
        bits = span.bit_length()
        if bits == 0:
            mode = "const"
        elif bits <= 8:
            mode = "lane8"
        elif bits <= 16:
            mode = "lane16"
        elif bits <= 32 and dt.itemsize > 4:
            mode = "u32"
        else:
            mode = wide_mode
        if mode == wide_mode:
            chosen.append(ColWire(nm, dt, mode))
        else:
            chosen.append(ColWire(nm, dt, mode, lo, span))

    # word assignment: lanes first (16-bit then 8-bit, first-fit into shared
    # words), then whole words, then 2-word splits — all in sorted-name order
    # within each class, so both sides of an exchange derive one layout.
    placed: dict[str, tuple[int, int]] = {}
    open_words: list[list[int]] = []     # [used_bits] per lane word
    for width in (16, 8):
        for c in chosen:
            if _LANE_BITS.get(c.mode) != width:
                continue
            for w, used in enumerate(open_words):
                if 32 - used[0] >= width:
                    placed[c.name] = (w, used[0])
                    used[0] += width
                    break
            else:
                placed[c.name] = (len(open_words), 0)
                open_words.append([width])
    next_word = len(open_words)
    cols: list[ColWire] = []
    for c in chosen:
        if c.mode in _LANE_BITS:
            w, sh = placed[c.name]
            cols.append(dataclasses.replace(c, word=w, shift=sh))
        elif c.mode == "const":
            cols.append(c)
        elif c.mode == "split":
            cols.append(dataclasses.replace(c, word=next_word))
            next_word += 2
        else:                                  # word | u32
            cols.append(dataclasses.replace(c, word=next_word))
            next_word += 1
    return WireFormat(tuple(cols), max(1, next_word), narrow)


def row_bytes(names, dtypes, bounds=None, narrow=True) -> tuple[int, int]:
    """(row_wire_bytes, row_logical_bytes) for a column set — the per-row
    numbers ``ExchangeStats`` reports and the static bench derives."""
    fmt = plan_wire_format(names, dtypes, bounds, narrow)
    return fmt.row_wire_bytes, fmt.row_logical_bytes


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value, as int64."""
    return x.to(torch.int64) & _M32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def pack_table(t, fmt: WireFormat) -> tuple[torch.Tensor, torch.Tensor]:
    """Table -> ((capacity, fmt.words) int32 buffer, overflow flag).

    ``overflow`` is True iff any VALID row of a checked column falls outside
    its claimed ``[lo, lo + span]`` — lying bounds surface as a re-execution,
    never as silent truncation.  Invalid rows are zeroed in narrowed lanes
    (their reconstruction is masked anyway); wide words/splits ship verbatim.
    """
    cap, dev = t.capacity, t.device
    valid = t.valid_mask() if fmt.narrow else None
    acc: list[torch.Tensor | None] = [None] * fmt.words
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    def _or(w: int, u: torch.Tensor):
        acc[w] = u if acc[w] is None else acc[w] | u

    for c in fmt.cols:
        v = t[c.name]
        dt = np.dtype(c.dtype)
        if c.mode in ("lane8", "lane16", "u32", "const"):
            if dt == np.bool_:
                u = v.to(torch.int64)            # 0/1 by construction
            else:
                d = v.to(torch.int64) - c.lo
                overflow = overflow | (valid & ((d < 0) | (d > c.span))).any()
                u = torch.where(valid, torch.clamp(d, 0, c.span), 0)
            if c.mode == "const":
                continue                         # reconstructed from lo
            _or(c.word, (u << c.shift) & _M32 if c.shift else u)
        elif c.mode == "word":
            if dt == np.bool_ or dt.itemsize < 4:
                x = v.to(torch.int32)            # widen (legacy bool behavior)
            else:
                x = v.contiguous().view(torch.int32)
            _or(c.word, _u32(x))
        elif c.mode == "split":
            x = v.contiguous().view(torch.int32).reshape(cap, 2)
            _or(c.word, _u32(x[:, 0]))
            _or(c.word + 1, _u32(x[:, 1]))
        else:
            raise ValueError(f"unknown wire mode {c.mode!r}")

    zero = torch.zeros(cap, dtype=torch.int64, device=dev)
    buf = torch.stack([a if a is not None else zero for a in acc], dim=1)
    return _i32(buf), overflow


def unpack_table(buf: torch.Tensor, fmt: WireFormat) -> dict[str, torch.Tensor]:
    """Inverse of :func:`pack_table`: int32 buffer -> logical columns."""
    n = buf.shape[0]
    out: dict[str, torch.Tensor] = {}
    for c in fmt.cols:
        dt = np.dtype(c.dtype)
        tdt = _torch_dtype(dt)
        if c.mode == "const":
            out[c.name] = torch.full((n,), c.lo, dtype=tdt, device=buf.device)
        elif c.mode in ("lane8", "lane16"):
            u = (_u32(buf[:, c.word]) >> c.shift) & \
                ((1 << _LANE_BITS[c.mode]) - 1)
            if dt == np.bool_:
                out[c.name] = (u & 1).to(torch.bool)
            else:
                out[c.name] = (u + c.lo).to(tdt)
        elif c.mode == "u32":
            out[c.name] = (_u32(buf[:, c.word]) + c.lo).to(tdt)
        elif c.mode == "word":
            w = buf[:, c.word]
            if dt == np.bool_ or dt.itemsize < 4:
                out[c.name] = w.to(tdt)
            else:
                out[c.name] = w.contiguous().view(tdt)
        elif c.mode == "split":
            out[c.name] = buf[:, c.word:c.word + 2].contiguous().view(tdt) \
                .reshape(n)
        else:
            raise ValueError(f"unknown wire mode {c.mode!r}")
    return out


# ---------------------------------------------------------------------------
# integrity checksum (fused into the counts header row)
# ---------------------------------------------------------------------------
# Checksums and header words are uint32 values held in int64 tensors; the
# encode_* functions return the int32 bits that go on the wire.  Every
# function takes leading batch dimensions (one block per sender).

def header_mode(words: int, max_count: int) -> str:
    """How a packed block's header row carries its integrity word.

    ``"word"``    words >= 2: the full 32-bit checksum rides in header word 1
                  (payload rows never use the header row, so the slot is free).
    ``"folded"``  single-word formats: a 16-bit fold shares the count word's
                  high half — valid while every possible count fits 16 bits
                  (``max_count`` is the static per-block row capacity).
    ``"none"``    single-word format whose counts may exceed 16 bits: the
                  exchange ships unchecked (statically known; the stats log
                  still records it).
    """
    if words >= 2:
        return "word"
    return "folded" if max_count < (1 << 16) else "none"


def _xor_fold(u: torch.Tensor) -> torch.Tensor:
    """XOR of the last dimension, by pairwise halving."""
    while u.shape[-1] > 1:
        if u.shape[-1] % 2:
            u = torch.cat([u, torch.zeros_like(u[..., :1])], dim=-1)
        half = u.shape[-1] // 2
        u = u[..., :half] ^ u[..., half:]
    if u.shape[-1] == 0:
        return torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    return u[..., 0]


def payload_checksum(buf: torch.Tensor) -> torch.Tensor:
    """Position-rotated XOR fold of packed (..., rows, words) int32 blocks.

    Word ``i`` (flat order within its block) is rotated left by ``i % 32``
    bits before the fold, so a single bit flip anywhere in the block flips
    exactly one bit of the uint32 result — single-bit corruption is detected
    with certainty."""
    u = _u32(buf.reshape(*buf.shape[:-2], -1))
    r = torch.arange(u.shape[-1], device=u.device) & 31
    rot = ((u << r) | (u >> ((32 - r) & 31))) & _M32
    return _xor_fold(rot)


def fold16(csum: torch.Tensor) -> torch.Tensor:
    """uint32 checksum -> 16-bit fold (XOR of halves); a single-bit change of
    the input changes exactly one bit of the fold."""
    return (csum ^ (csum >> 16)) & 0xFFFF


def _mix_count(count: torch.Tensor) -> torch.Tensor:
    """Rotate the row count into the checksum so a flipped count word is as
    detectable as a flipped payload bit."""
    c = _u32(count)
    return ((c << 7) | (c >> 25)) & _M32


def encode_header_word0(count: torch.Tensor, csum: torch.Tensor, mode: str,
                        ) -> torch.Tensor:
    """int32 value of header word 0: the row count, plus (folded mode) the
    16-bit checksum fold in the high half."""
    c = _u32(count)
    if mode == "folded":
        c = c | (fold16(csum ^ _mix_count(count)) << 16)
    return _i32(c)


def encode_checksum_word(count: torch.Tensor, csum: torch.Tensor
                         ) -> torch.Tensor:
    """int32 value of header word 1 (``"word"`` mode): checksum mixed with
    the count."""
    return _i32(csum ^ _mix_count(count))


def decode_header_word0(word0: torch.Tensor, mode: str) -> torch.Tensor:
    """Received header word 0 -> row count (int32)."""
    u = _u32(word0)
    if mode == "folded":
        u = u & 0xFFFF
    return _i32(u)


def verify_block_checksum(hdr_row: torch.Tensor, payload: torch.Tensor,
                          mode: str) -> torch.Tensor:
    """True where a received block (header row + payload rows) FAILS its
    integrity check.  ``hdr_row`` is (..., words), ``payload`` the matching
    (..., rows, words) blocks."""
    if mode == "none":
        return torch.zeros(hdr_row.shape[:-1], dtype=torch.bool,
                           device=hdr_row.device)
    count = decode_header_word0(hdr_row[..., 0], mode)
    want = payload_checksum(payload) ^ _mix_count(count)
    if mode == "folded":
        return fold16(want) != _u32(hdr_row[..., 0]) >> 16
    got = _u32(hdr_row[..., 1])
    # senders zero the unused header tail, so a flip there is detectable too
    return (want != got) | (hdr_row[..., 2:] != 0).any(dim=-1)
