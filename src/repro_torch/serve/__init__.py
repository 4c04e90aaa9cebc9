"""Multi-tenant query serving: parameterized plan templates, a
content-signature plan cache, and batch execution with cross-query sharing.

Entry points:

  * :class:`PlanTemplate` / :class:`BoundQuery` / ``TEMPLATES`` /
    ``template_for`` — plans whose literals are ``Param`` placeholders;
    one DAG + one analysis + one preparation per template,
    domain-validated binding per request (``templates.py``).
  * :class:`PlanCache` — FIFO-bounded prepared-template cache keyed on
    plan content signatures, evicted through the planner's
    stats-invalidation registry (``cache.py``).
  * :class:`QueryServer` / :class:`BatchExecutor` — the prepared serving
    path (prepared once per template, bindings as dtype-pinned 0-d device
    tensors) and the batch path (cross-query subplan memo), both
    overflow-recovering (``server.py``).
  * :class:`AdmissionGate` + :class:`Served` / :class:`Degraded` /
    :class:`Shed` — capacity-aware admission on a degraded topology: one
    re-preparation per (template, topology generation), oversized requests
    shed or queued as structured outcomes (``server.py``).

The port's own copy of the reference package's ``serve``; it runs on
``cuda`` unless the caller names another device.  ``chip_smoke.py`` phase
7c drives it on the card.
"""
from .cache import PlanCache
from .server import (AdmissionGate, BatchExecutor, Degraded, QueryServer,
                     Served, Shed)
from .templates import (BoundQuery, PlanTemplate, TEMPLATES,
                        resolve_bindings, template_for)

__all__ = [
    "PlanTemplate", "BoundQuery", "TEMPLATES", "template_for",
    "resolve_bindings", "PlanCache", "QueryServer", "BatchExecutor",
    "AdmissionGate", "Served", "Degraded", "Shed",
]
