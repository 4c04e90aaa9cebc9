"""The one traffic generator: it reads a traffic mix's data file
(``traffic/<name>.json``) and turns it, with the seed, into the cycle of
requests a closed-loop client sends.

A mix names an ``order`` of templates (TPC-H query numbers), the number of
bindings each parameterised template draws (``bindings_per_template``), and
for each such template the rule of each parameter.  Rules (``kind``):

* ``days_before``: ``date`` minus a whole number of days in ``[lo, hi]``;
* ``day_between``: a day in ``[lo, hi]`` (dates);
* ``year_start``: January 1 of a year in ``[lo, hi]``;
* ``years_after``: parameter ``of`` plus ``years`` years;
* ``decimal``: ``lo + k * step`` up to ``hi``;
* ``offset``: parameter ``of`` plus ``by``;
* ``int``: a whole number in ``[lo, hi]``.

A rule with ``"bind": false`` is drawn and used by others but not sent.
A ``days_before``, ``decimal`` or ``int`` rule may list ``withheld``
values: values of the rule's range that are not drawn, each with the reason
under ``why_withheld`` (a fault of the program that rejects them).
Dates are epoch days, as the server binds them.  Each template draws from
its own stream of the seed, so two mixes that share a template and its
rules send it the same bindings.  The k-th request of a template in the
cycle takes binding ``k mod bindings``; the cycle is the order repeated
until every binding has come round.
"""
from __future__ import annotations

import datetime
from typing import NamedTuple

import numpy as np

from .data.tpch import days

__all__ = ["Request", "cycle"]

_EPOCH = datetime.date(1970, 1, 1)


class Request(NamedTuple):
    qid: int
    binding: dict      # parameter -> value, as sent to the server
    key: str           # one name per distinct (template, binding)


def _pick(values, rule: dict, rng: np.random.Generator):
    """One of ``values`` that the rule does not withhold, uniformly."""
    withheld = set(rule.get("withheld", ()))
    left = [v for v in values if v not in withheld]
    if len(left) + len(withheld) != len(values) or not left:
        raise ValueError(f"withheld values {sorted(withheld)} must lie in "
                         f"the rule's range and leave one")
    return left[int(rng.integers(0, len(left)))]


def _draw(rules: dict, rng: np.random.Generator) -> dict:
    vals: dict = {}
    for name, r in rules.items():
        kind = r["kind"]
        if kind == "days_before":
            v = days(r["date"]) - _pick(range(r["lo"], r["hi"] + 1), r, rng)
        elif kind == "day_between":
            v = int(rng.integers(days(r["lo"]), days(r["hi"]) + 1))
        elif kind == "year_start":
            v = days(f"{int(rng.integers(r['lo'], r['hi'] + 1))}-01-01")
        elif kind == "years_after":
            d = _EPOCH + datetime.timedelta(days=vals[r["of"]])
            v = days(d.replace(year=d.year + int(r["years"])).isoformat())
        elif kind == "decimal":
            steps = int(round((r["hi"] - r["lo"]) / r["step"]))
            v = _pick([round(r["lo"] + r["step"] * k, 9)
                       for k in range(steps + 1)], r, rng)
        elif kind == "offset":
            v = round(vals[r["of"]] + r["by"], 9)
        elif kind == "int":
            v = _pick(range(r["lo"], r["hi"] + 1), r, rng)
        else:
            raise ValueError(f"unknown parameter rule {kind!r} of {name!r}")
        vals[name] = v
    return {k: v for k, v in vals.items() if rules[k].get("bind", True)}


def bindings(mix: dict, seed: int) -> dict[int, list[dict]]:
    """Each template's bindings: those drawn from the seed for a template
    the mix gives rules, one empty binding for any other."""
    n = int(mix.get("bindings_per_template", 1))
    rules = mix.get("parameters", {})
    out: dict[int, list[dict]] = {}
    for qid in mix["order"]:
        if qid in out:
            continue
        spec = rules.get(str(qid))
        if spec:
            rng = np.random.default_rng([int(seed), int(qid)])
            out[qid] = [_draw(spec, rng) for _ in range(n)]
        else:
            out[qid] = [{}]
    return out


def cycle(mix: dict, seed: int) -> list[Request]:
    """The requests of one cycle of the mix, in the order they are sent."""
    if mix.get("loop", "closed") != "closed" or int(mix.get("clients", 1)) != 1:
        raise ValueError("this generator drives one closed-loop client")
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"the seed must not be negative, got {seed}")
    bound = bindings(mix, seed)
    rounds = max(len(b) for b in bound.values())
    seen: dict[int, int] = {}
    out = []
    for _ in range(rounds):
        for qid in mix["order"]:
            k = seen.get(qid, 0)
            seen[qid] = k + 1
            b = k % len(bound[qid])
            out.append(Request(int(qid), bound[qid][b], f"q{qid}.{b}"))
    return out
