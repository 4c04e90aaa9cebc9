"""Exchange operators — the part the single-device slice needs.

``ExchangeStats`` is the per-exchange descriptor every backend logs; the
single-device contexts log it with the per-row fields only, so the
IR-derived report (``planner.static_wire_stats``) can be asserted equal to
the runtime log.  The collectives themselves (packed shuffle, broadcast,
gather over ``torch.distributed``) land with the distributed slice.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ExchangeStats"]


@dataclasses.dataclass
class ExchangeStats:
    """Static descriptor of one exchange — feeds the perf models.

    ``message_bytes``/``total_bytes`` are actual wire bytes (packed words x
    4, including the fused counts header row); ``logical_bytes`` is the
    dtype-true payload size per message.  The per-row pair
    (``row_wire_bytes``, ``row_logical_bytes``) is capacity-independent and
    equals the IR-derived static numbers on every backend.
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
