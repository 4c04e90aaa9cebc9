"""Roofline terms of a step: compute, memory and collective time.

The counterpart of ``repro.distributed.hlo_analysis.roofline_terms``, the
one function of that module that reads no HLO.  The rest of it
(``analyze_module``, ``parse_collectives``, ``op_histogram``) parses
compiled XLA text, which the eager PyTorch port never has; the port counts
a plan's sorts with ``core/sortcount.SortCounter`` instead.

The reference defaults its peaks to a TPU v5e chip; here they are
arguments, taken by the caller from a ``core/perfmodel.CLUSTERS`` entry
(``peak_flops``, ``hbm_bw``) and its interconnect.
"""
from __future__ import annotations

__all__ = ["roofline_terms", "bound_terms"]


def bound_terms(terms: dict[str, float | None]) -> dict:
    """``terms`` (``compute_s``, ``memory_s``, ``collective_s``; a term that
    was not measured is None) with the largest as ``bottleneck`` and its
    time as ``step_lower_bound_s``; None terms take no part."""
    known = {k: v for k, v in terms.items() if v is not None}
    dom = max(known, key=known.get)
    return {**terms, "bottleneck": dom.replace("_s", ""),
            "step_lower_bound_s": known[dom]}


def roofline_terms(hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, n_chips: int, *,
                   peak_flops: float, hbm_bw: float, ici_bw: float,
                   ici_links: float = 4.0,
                   model_flops: float = 0.0) -> dict:
    """The three roofline terms, in seconds, from per-device FLOPs, memory
    traffic and collective bytes; ``model_flops`` (whole step, all chips)
    adds the useful share of the FLOPs and the roofline fraction."""
    out = bound_terms({"compute_s": hlo_flops / peak_flops,
                       "memory_s": hlo_bytes / hbm_bw,
                       "collective_s": collective_bytes /
                       (ici_bw * ici_links)})
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flop_frac"] = model_flops / max(hlo_flops * n_chips, 1.0)
        out["roofline_frac"] = (model_flops / (n_chips * peak_flops)) / \
            max(out["step_lower_bound_s"], 1e-12)
    return out
