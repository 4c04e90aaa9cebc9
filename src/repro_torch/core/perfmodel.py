"""Analytical performance models for data exchange (paper §3).

Implements, verbatim:
  Eq. 1  ring-broadcast throughput      Thpt_b = N/(N-1) * min(Bn, Bg)
  Eq. 2  shuffle throughput             Thpt_s = V^2/(V-1) * Bn          (V>1)
  Eq. 3  broadcast-vs-shuffle           |S|/|R| > (N-1)/(N-k) * V - 1
  §3.5   skew model                     T = max_i(S_i, R_i) / Bn
  §3.6   Hockney small-message model    B(m) = m / (L + c*m)
  §6.3   projections I/II (+ compute-scaling fits)

Cluster parameterizations cover the paper's three GPU clusters (Table 3) and
a TPU v5e pod — on a TPU torus the roles map as
  Bg := aggregate intra-pod ICI bandwidth per chip, Bn := inter-pod DCI share.
The formulas and constants are the reference package's, number for number:
the fault runner prices exchanges at the live width with them
(``repro_torch.distributed.fault``).  They are closed forms over the specs'
published rates, not measurements of this port.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

__all__ = [
    "ClusterSpec", "CLUSTERS", "Hockney", "hockney_from_env",
    "broadcast_throughput", "shuffle_throughput", "broadcast_beats_shuffle",
    "shuffle_time_skewed", "fit_hockney", "exchange_time",
    "exchange_time_from_stats", "wire_savings", "project_workload",
]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Per-machine topology (paper Table 3 + our TPU target).

    ``n_devices`` is the LIVE participant count.  It defaults to None, which
    means "fully populated": every closed form below then derives N = k*V
    from the boot-time shape.  After a mid-query device loss the runner pins
    the surviving width with :meth:`with_devices`, and all Hockney / Eq.1-3
    pricing uses N' instead of the boot-time N."""
    name: str
    k: int            # accelerators per machine / chips per pod
    bg: float         # intra-machine per-device unidirectional bw, bytes/s
    bn: float         # inter-machine per-machine unidirectional bw, bytes/s
    hbm: float        # bytes per device
    peak_flops: float = 0.0
    hbm_bw: float = 0.0
    price_hr: float = 0.0
    n_devices: int | None = None   # live width; None = boot-time k*V

    def with_devices(self, n: int) -> "ClusterSpec":
        """Pin the live device count (e.g. after a topology shrink)."""
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        return dataclasses.replace(self, n_devices=int(n))

    def live_n(self, v: int) -> int:
        """Participant count for a V-machine job: N' when pinned, else k*V."""
        return self.n_devices if self.n_devices is not None else self.k * v


GBs = 1e9
CLUSTERS = {
    # paper Table 3
    "a100_eth": ClusterSpec("a100_eth", 8, 300 * GBs, 50 / 8 * GBs, 80e9,
                            312e12, 2.0e12, 32.77),
    "h100_eth": ClusterSpec("h100_eth", 8, 450 * GBs, 100 / 8 * GBs, 79.6e9,
                            989e12, 3.35e12, 98.32),
    "h100_ib": ClusterSpec("h100_ib", 8, 450 * GBs, 8 * 400 / 8 * GBs, 79.6e9,
                           989e12, 3.35e12, 98.32),
    "mi300x_ib": ClusterSpec("mi300x_ib", 8, 448 * GBs, 8 * 400 / 8 * GBs,
                             191.5e9, 1307e12, 5.3e12, 63.6),
    # our deployment target: v5e pod = 16x16 torus; per-chip ICI ~4 links x
    # 50 GB/s is Bg; inter-pod DCI modeled at 25 GB/s per chip share.
    "tpu_v5e": ClusterSpec("tpu_v5e", 256, 4 * 50 * GBs, 256 * 25 * GBs,
                           16e9, 197e12, 819e9, 0.0),
}


# ---------------------------------------------------------------------------
# §3.2-3.4 closed forms
# ---------------------------------------------------------------------------

def broadcast_throughput(spec: ClusterSpec, v: int) -> float:
    """Eq. 1.  Total bytes / time for an all-to-all-nodes table replication."""
    n = spec.live_n(v)
    if v == 1:
        return n / (n - 1) * spec.bg if n > 1 else float("inf")
    return n / (n - 1) * min(spec.bn / spec.k, spec.bg)


def shuffle_throughput(spec: ClusterSpec, v: int) -> float:
    """Eq. 2 (per-GPU network share Bn/k folded in, as in the paper)."""
    n = spec.live_n(v)
    if v == 1:
        return n * n / (n - 1) * spec.bg if n > 1 else float("inf")
    return v * v / (v - 1) * spec.bn


def broadcast_beats_shuffle(spec: ClusterSpec, v: int, size_r: float,
                            size_s: float) -> bool:
    """Eq. 3: broadcast table R vs shuffling R and S both."""
    n = spec.live_n(v)
    if n == spec.k:   # V=1: |S|/|R| > N-1
        return size_s / size_r > n - 1
    return size_s / size_r > (n - 1) / (n - spec.k) * v - 1


# ---------------------------------------------------------------------------
# §3.5 skew
# ---------------------------------------------------------------------------

def shuffle_time_skewed(send_bytes_per_node: np.ndarray,
                        recv_bytes_per_node: np.ndarray, bn: float) -> float:
    """T = max(S_0..S_V-1, R_0..R_V-1) / Bn — the PXN observation: skew is
    visible per NODE, not per device."""
    return float(max(np.max(send_bytes_per_node), np.max(recv_bytes_per_node))
                 / bn)


def node_send_recv(message_matrix: np.ndarray, k: int):
    """(N, N) per-device message bytes -> per-node off-node send/recv totals."""
    n = message_matrix.shape[0]
    v = n // k
    m = message_matrix.reshape(v, k, v, k)
    send = np.zeros(v)
    recv = np.zeros(v)
    for i in range(v):
        send[i] = m[i].sum() - m[i, :, i, :].sum()
        recv[i] = m[:, :, i, :].sum() - m[i, :, i, :].sum()
    return send, recv


# ---------------------------------------------------------------------------
# §3.6 Hockney
# ---------------------------------------------------------------------------

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


def fit_hockney(msg_bytes: np.ndarray, times_s: np.ndarray) -> Hockney:
    """Least-squares fit of t = L + c*m (the paper fits V=2 microbenchmarks)."""
    a = np.stack([np.ones_like(msg_bytes, dtype=np.float64),
                  msg_bytes.astype(np.float64)], axis=1)
    (l, c), *_ = np.linalg.lstsq(a, times_s.astype(np.float64), rcond=None)
    return Hockney(latency=max(l, 0.0), inv_bw=max(c, 1e-18))


# ---------------------------------------------------------------------------
# exchange-time predictions (feed the roofline + projections)
# ---------------------------------------------------------------------------

def exchange_time(kind: str, spec: ClusterSpec, v: int, total_bytes: float,
                  hockney_n: Hockney | None = None,
                  hockney_g: Hockney | None = None) -> float:
    """Predicted wall time of one exchange of a table of ``total_bytes``.

    Projection I ignores message sizes (peak Bn/Bg); Projection II passes the
    Hockney fits so B(m) reflects the actual per-message size (§6.3)."""
    n = spec.live_n(v)
    if kind == "broadcast":
        m = total_bytes / n                     # ring step payload
        if hockney_n is not None and v > 1:
            bw = min(hockney_n.bandwidth(m / spec.k), hockney_g.bandwidth(m)
                     if hockney_g else float("inf"))
            return (n - 1) * m / max(bw, 1e-9)
        return total_bytes / broadcast_throughput(spec, v)
    if kind == "shuffle":
        m = total_bytes / (n * n)               # p2p message size
        if hockney_n is not None and v > 1:
            bw = hockney_n.bandwidth(m)
            eff = v * v / (v - 1) * bw * spec.k  # scale Eq.2 by fitted per-msg bw
            return total_bytes / max(eff, 1e-9)
        return total_bytes / shuffle_throughput(spec, v)
    if kind in ("gather", "broadcast_p2p"):
        # p2p emulation: each device sends its shard to all N-1 peers
        per_dev = total_bytes / n
        if v == 1:
            return (n - 1) * per_dev / spec.bg
        return (n - 1) * per_dev / (spec.bn / spec.k)
    raise ValueError(kind)


def exchange_time_from_stats(stats, spec: ClusterSpec, v: int = 1,
                             n_devices: int | None = None,
                             hockney_n: Hockney | None = None,
                             hockney_g: Hockney | None = None) -> float:
    """Predicted wall time of one logged exchange, from what ACTUALLY moves.

    ``stats`` is an :class:`repro_torch.core.exchange.ExchangeStats`: its
    ``message_bytes`` are wire bytes — the packed words including the fused
    counts header, at the narrow lane widths when the planner's statistics
    narrowed the payload — so the Hockney model (§3.6) prices the compressed
    message size, not the logical table size.  The narrow-vs-wide delta is
    ``wire_savings(stats)``: the model's predicted benefit of shipping at
    inferred bit widths.  Explicit ``n_devices`` wins; a pinned
    ``spec.n_devices`` (degraded mesh) wins over the logged participant
    count, which reflects the width the stats were CAPTURED at.
    """
    n = n_devices or spec.n_devices or stats.participants
    if stats.kind.startswith("broadcast") or stats.kind == "gather":
        total = stats.message_bytes * n          # per-shard payload x N
        return exchange_time("broadcast", spec, v, total, hockney_n, hockney_g)
    total = stats.message_bytes * n * n          # p2p msg = S/N^2
    return exchange_time("shuffle", spec, v, total, hockney_n, hockney_g)


def wire_savings(stats) -> float:
    """Fraction of logical payload bytes the wire format did NOT move
    (0.0 = full width; e.g. 0.6 = 60% fewer bytes per row than dtype-true)."""
    if stats.row_logical_bytes <= 0:
        return 0.0
    return max(0.0, 1.0 - stats.row_wire_bytes / stats.row_logical_bytes)


def project_workload(spec: ClusterSpec, v_range, compute_v1: float,
                     exchanges: list[tuple[str, float]],
                     hockney_n: Hockney | None = None,
                     hockney_g: Hockney | None = None,
                     compute_power: float = -1.0) -> dict[int, dict]:
    """§6.3 'best-effort' projection from V=1 measurements.

    compute scales as a*V^b (b=-1 is the perfect-linear 'best-effort' form);
    exchange terms come from the models above.  Returns per-V breakdowns."""
    out = {}
    for v in v_range:
        comp = compute_v1 * (v ** compute_power)
        sh = sum(exchange_time("shuffle", spec, v, b, hockney_n, hockney_g)
                 for kind, b in exchanges if kind == "shuffle")
        bc = sum(exchange_time("broadcast", spec, v, b, hockney_n, hockney_g)
                 for kind, b in exchanges if kind == "broadcast")
        out[v] = {"compute": comp, "shuffle": sh, "broadcast": bc,
                  "total": comp + sh + bc}
    return out
