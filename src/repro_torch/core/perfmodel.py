"""Analytical performance models for data exchange (paper §3) — the part the
single-device slice needs.

Only the §3.6 Hockney small-message model and its environment reader are
ported so far: ``wire.hockney_skip`` prices an exchange message with it.  The
closed forms (Eq. 1-3), the skew model, the fits and the projections of
``repro.core.perfmodel`` land with the distributed slice.
"""
from __future__ import annotations

import dataclasses
import os

__all__ = ["Hockney", "hockney_from_env"]


@dataclasses.dataclass(frozen=True)
class Hockney:
    """t(m) = L + c*m;  B(m) = m / (L + c*m)."""
    latency: float     # seconds
    inv_bw: float      # seconds per byte

    def bandwidth(self, m: float) -> float:
        return m / (self.latency + self.inv_bw * m)

    def time(self, m: float) -> float:
        return self.latency + self.inv_bw * m

    def latency_bound(self, m: float) -> bool:
        """True when a message of ``m`` bytes sits below the half-bandwidth
        point m* = L/c: the transfer term c*m is no larger than the constant
        L, so shrinking the payload cannot materially shorten the exchange."""
        return self.inv_bw * m <= self.latency


def hockney_from_env(env: str | None = None) -> Hockney | None:
    """Hockney link model from ``REPRO_HOCKNEY="<latency_s>,<inv_bw_s/B>"``.

    Unset/empty means no model (returns None).  A trailing third field is
    permitted and ignored here (:mod:`repro_torch.core.wire` reads it as the
    nominal per-message row count for its packing-skip policy)."""
    spec = os.environ.get("REPRO_HOCKNEY", "") if env is None else env
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if len(parts) < 2:
        return None
    return Hockney(latency=float(parts[0]), inv_bw=float(parts[1]))
