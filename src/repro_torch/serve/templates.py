"""Parameterized plan templates: one logical DAG serves every binding.

A :class:`PlanTemplate` wraps a plan builder whose literals have been lifted
into :class:`repro_torch.core.plan.Param` placeholders.  The template's plan
is built ONCE; the planner analyzes it ONCE against each database
(refinement uses the parameter DOMAINS, so the cached ``PlanInfo`` is sound
for every admissible binding); and the serving layer
(:mod:`repro_torch.serve.server`) prepares it ONCE per configuration —
re-binding never re-plans, re-analyzes or re-prepares.
:meth:`PlanTemplate.bind` validates a binding against the declared domains
host-side and returns a :class:`BoundQuery`, a plain ``query_fn(ctx)`` the
whole existing machinery (backends, fault runner, lineage) accepts
unchanged.

``TEMPLATES`` covers all 22 TPC-H queries and is built entirely from the
committed SQL texts (``src/repro_torch/queries/sql/q*.sql``) via
:meth:`PlanTemplate.from_sql`: Q1/Q3/Q5/Q6 carry genuine parameters (the
TPC-H substitution parameters: dates, discount window, quantity threshold)
as ``declare .. in (lo, hi)`` headers whose domains span the spec's
substitution ranges and whose defaults equal the validation literals of
:mod:`repro_torch.queries`; the rest compile to zero-parameter templates, so
a mixed serving stream can interleave every query shape.  Each template
ships ``samples`` — admissible bindings (``samples[0]`` is the
canonical/default one) — used by the differential tests and the chip smoke
run to synthesize parameterized traffic.  A template's ``signature()``
equals the reference package's template's.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core import plan as P
from repro_torch.core.planner import (CompiledQuery, compile_query, params_of,
                                subplan_signatures)
from repro_torch.core.table import days

__all__ = ["PlanTemplate", "BoundQuery", "resolve_bindings", "TEMPLATES",
           "template_for"]


def resolve_bindings(params: dict[str, P.Param],
                     bindings: dict[str, Any]) -> dict[str, Any]:
    """Validate ``bindings`` against the template's parameter specs and return
    the COMPLETE canonical binding (every declared parameter present, values
    coerced to plain int/float per the pinned dtype).

    Host-side rejection is the first line of the soundness story: a binding
    outside a parameter's declared domain could outrun the domain-derived
    ``PlanInfo``, so it never reaches the engine.  (Stale statistics that
    slip past still trip the runtime range checks into ``ctx.overflow``.)
    """
    unknown = set(bindings) - set(params)
    if unknown:
        raise ValueError(f"unknown parameter(s) {sorted(unknown)}; "
                         f"template declares {sorted(params)}")
    out: dict[str, Any] = {}
    for name, spec in sorted(params.items()):
        if name in bindings:
            v = bindings[name]
        elif spec.default is not None:
            v = spec.default
        else:
            raise ValueError(f"parameter {name!r} has no binding and no "
                             "default")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"parameter {name!r}: expected a number, got "
                             f"{type(v).__name__}")
        if spec.dtype == "int64":
            if isinstance(v, float) and not v.is_integer():
                raise ValueError(f"parameter {name!r} is int64; got {v!r}")
            v = int(v)
        else:
            v = float(v)
        if spec.lo is not None and not (spec.lo <= v <= spec.hi):
            raise ValueError(f"parameter {name!r}={v!r} outside its declared "
                             f"domain [{spec.lo}, {spec.hi}]")
        out[name] = v
    return out


class BoundQuery:
    """A template with values bound: a plain ``query_fn(ctx)``.

    Carries the fault runner's recovery protocol (``_infer`` /
    ``with_inference``) so capacity escalation and hint-drop recompilation
    work on served queries exactly as on static ones — always against the
    SAME bindings."""

    def __init__(self, template: "PlanTemplate", values: dict[str, Any],
                 infer: bool | None = None):
        self.template = template
        self.values = values
        self._infer = infer          # None = environment default

    def __call__(self, ctx):
        return self.template.query.run(ctx, infer=self._infer,
                                       params=self.values)

    def with_inference(self, on: bool) -> "BoundQuery":
        return BoundQuery(self.template, self.values, bool(on))

    @property
    def plan(self) -> P.Node:
        return self.template.query.plan

    def static_counts(self) -> dict[str, int]:
        return self.template.query.static_counts()


class PlanTemplate:
    """A compiled, parameterized logical plan plus its parameter specs."""

    def __init__(self, build_fn: Callable[[], P.Node],
                 name: str | None = None,
                 samples: list[dict] | None = None):
        self.query: CompiledQuery = compile_query(build_fn, name=name)
        self.name = self.query.name
        self.samples = [dict(s) for s in (samples or [{}])]

    @property
    def params(self) -> dict[str, P.Param]:
        got = self.__dict__.get("_params")
        if got is None:
            got = self.__dict__["_params"] = params_of(self.query.plan)
        return got

    def signature(self) -> str:
        """Content signature of the plan — parameters appear by SPEC, never
        by binding, so every binding shares one signature (one cache entry,
        one preparation) while any structural difference splits it."""
        return self.query.signature()

    def subplan_signatures(self) -> dict[int, tuple[str, frozenset]]:
        """Per-node subtree content hashes + reachable parameter names (the
        batch executor's cross-query memo keys); computed once per template."""
        got = self.__dict__.get("_subsigs")
        if got is None:
            got = self.__dict__["_subsigs"] = \
                subplan_signatures(self.query.plan)
        return got

    def bind(self, **bindings) -> BoundQuery:
        return BoundQuery(self, resolve_bindings(self.params, bindings))

    @classmethod
    def from_sql(cls, text: str, name: str | None = None,
                 samples: list[dict] | None = None) -> "PlanTemplate":
        """Compile SQL ``text`` into a template.  ``declare`` headers become
        the template's parameters (name, dtype, domain, default)."""
        from repro_torch.sql.frontend import plan_sql
        return cls(lambda: plan_sql(text), name=name, samples=samples)


# ---------------------------------------------------------------------------
# the 22 TPC-H templates, compiled from the committed SQL texts
# ---------------------------------------------------------------------------

def _q6_template() -> P.Node:
    """The Q6 template's plan builder (SQL-compiled); kept addressable so
    tests can construct a structural twin of ``TEMPLATES[6]``."""
    from repro_torch.sql.frontend import plan_sql, sql_text
    return plan_sql(sql_text(6))


# sample bindings the tests and the chip smoke run stream with (the
# reference's); samples[0] = {} binds every default, reproducing the literal
# query exactly
_SAMPLES: dict[int, list[dict]] = {
    1: [{},
        {"q1_cutoff": days("1998-08-15")},
        {"q1_cutoff": days("1998-09-20")}],
    3: [{},
        {"q3_date": days("1995-03-07")},
        {"q3_date": days("1995-03-25")}],
    5: [{},
        {"q5_date_lo": days("1995-01-01"),
         "q5_date_hi": days("1996-01-01")}],
    6: [{},
        {"q6_disc_lo": 0.03, "q6_disc_hi": 0.05, "q6_qty": 25},
        {"q6_date_lo": days("1995-01-01"),
         "q6_date_hi": days("1996-01-01")}],
}


def _make_templates() -> dict[int, PlanTemplate]:
    from repro_torch.sql.frontend import sql_text
    return {qid: PlanTemplate.from_sql(sql_text(qid), name=f"q{qid}",
                                       samples=_SAMPLES.get(qid))
            for qid in range(1, 23)}


TEMPLATES: dict[int, PlanTemplate] = _make_templates()


def template_for(qid: int) -> PlanTemplate:
    """The standing template for TPC-H query ``qid`` (1-22)."""
    return TEMPLATES[qid]
