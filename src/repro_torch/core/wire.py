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

Port status
-----------
This is the host half of ``repro.core.wire``: the layout arithmetic that the
planner's static wire report and every backend's exchange log share.  The
traced half (``pack_table`` / ``unpack_table`` and the integrity checksum
words fused into the counts header row) lands with the distributed slice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "ColWire", "WireFormat", "CorruptPayload", "wire_default",
    "hockney_skip", "plan_wire_format", "row_bytes",
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
