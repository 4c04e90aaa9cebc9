"""The 22 TPC-H queries, written plainly against ``relational.py``.

Each ``qN(db, p)`` answers the query of the SQL text the server compiles
(``src/repro_torch/queries/sql/qN.sql``, read as a specification, never
imported) for the binding ``p`` of its parameters, with the columns the
served answer carries: an ORDER BY on a dictionary-encoded string column
sorts by the string's alphabetical rank, which the answer carries as
``__rank_<column>``.  ``ORDER[qid]`` is each query's ORDER BY, the keys the
comparison holds the served row order to.

``answer`` returns host numpy columns.  In ``db.fdt = float32`` it is the
control: the same queries one precision below the configuration's.
"""
from __future__ import annotations

import numpy as np
import torch

from .relational import (RefDB, days, gcount, gmin, group, gsum, join, like,
                         lookup, order, scalar, select, year_of)

__all__ = ["answer", "ORDER", "RefDB"]


def _disc(t):
    return t["l_extendedprice"] * (1 - t["l_discount"])


def _nations_of(db, region: str) -> torch.Tensor:
    n, r = db.table("nation"), db.table("region")
    keys = r["r_regionkey"][r["r_name"] == db.code("r_name", region)]
    return n["n_nationkey"][torch.isin(n["n_regionkey"], keys)]


def _isin_codes(x, db, col, values):
    return torch.isin(x, torch.tensor([db.code(col, v) for v in values],
                                      device=x.device, dtype=x.dtype))


def q1(db, p):
    li = db.table("lineitem")
    t = select(li, li["l_shipdate"] <= p["q1_cutoff"])
    inv, g, (rf, ls) = group(t["l_returnflag"], t["l_linestatus"])
    cnt = gcount(inv, g)
    disc = _disc(t)
    sum_qty = gsum(inv, g, t["l_quantity"])
    sum_price = gsum(inv, g, t["l_extendedprice"])
    out = {"l_returnflag": rf, "l_linestatus": ls,
           "sum_qty": sum_qty, "sum_base_price": sum_price,
           "sum_disc_price": gsum(inv, g, disc),
           "sum_charge": gsum(inv, g, disc * (1 + t["l_tax"])),
           "count_order": cnt,
           "avg_qty": sum_qty.to(db.fdt) / cnt,
           "avg_price": sum_price / cnt,
           "avg_disc": gsum(inv, g, t["l_discount"]) / cnt}
    return order(out, ORDER[1])


def q2(db, p):
    s, n, ps, pa = (db.table(x) for x in
                    ("supplier", "nation", "partsupp", "part"))
    eu = select(s, torch.isin(s["s_nationkey"], _nations_of(db, "EUROPE")))
    hit, nn = lookup(eu["s_nationkey"], n["n_nationkey"], n, ["n_name"])
    eu = dict(select(eu, hit), **nn)
    brass = db.dict_lut("p_type", lambda x: x.endswith("BRASS"))
    parts = select(pa, (pa["p_size"] == 15) & brass[pa["p_type"]])
    hit, pp = lookup(ps["ps_partkey"], parts["p_partkey"], parts, ["p_mfgr"])
    j = dict(select(ps, hit), **pp)
    hit, ss = lookup(j["ps_suppkey"], eu["s_suppkey"], eu,
                     ["s_acctbal", "n_name"])
    j = dict(select(j, hit), **ss)
    inv, g, _ = group(j["ps_partkey"])
    mn = gmin(inv, g, j["ps_supplycost"])
    j = select(j, j["ps_supplycost"] == mn[inv])
    out = {"s_acctbal": j["s_acctbal"], "n_name": j["n_name"],
           "ps_suppkey": j["ps_suppkey"], "ps_partkey": j["ps_partkey"],
           "p_mfgr": j["p_mfgr"],
           "__rank_n_name": db.rank("n_name")[j["n_name"].long()]}
    return order(out, ORDER[2], limit=100)


def q3(db, p):
    c, o, li = (db.table(x) for x in ("customer", "orders", "lineitem"))
    d = p["q3_date"]
    ck = c["c_custkey"][c["c_mktsegment"] == db.code("c_mktsegment",
                                                      "BUILDING")]
    oo = select(o, (o["o_orderdate"] < d) & torch.isin(o["o_custkey"], ck))
    t = select(li, li["l_shipdate"] > d)
    hit, oc = lookup(t["l_orderkey"], oo["o_orderkey"], oo,
                     ["o_orderdate", "o_shippriority"])
    t = dict(select(t, hit), **oc)
    inv, g, (ok, od, sp) = group(t["l_orderkey"], t["o_orderdate"],
                                 t["o_shippriority"])
    out = {"l_orderkey": ok, "revenue": gsum(inv, g, _disc(t)),
           "o_orderdate": od, "o_shippriority": sp}
    return order(out, ORDER[3], limit=10)


def q4(db, p):
    o, li = db.table("orders"), db.table("lineitem")
    late = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
    m = (o["o_orderdate"] >= days("1993-07-01")) & \
        (o["o_orderdate"] < days("1993-10-01")) & \
        torch.isin(o["o_orderkey"], late)
    inv, g, (pr,) = group(o["o_orderpriority"][m])
    out = {"o_orderpriority": pr, "order_count": gcount(inv, g)}
    return order(out, ORDER[4])


def q5(db, p):
    o, c, s, li = (db.table(x) for x in
                   ("orders", "customer", "supplier", "lineitem"))
    asia = _nations_of(db, "ASIA")
    oo = select(o, (o["o_orderdate"] >= p["q5_date_lo"]) &
                (o["o_orderdate"] < p["q5_date_hi"]))
    hit, oc = lookup(li["l_orderkey"], oo["o_orderkey"], oo, ["o_custkey"])
    t = dict(select(li, hit), **oc)
    hit, cc = lookup(t["o_custkey"], c["c_custkey"], c, ["c_nationkey"])
    t = dict(select(t, hit), **cc)
    hit, sc = lookup(t["l_suppkey"], s["s_suppkey"], s, ["s_nationkey"])
    t = dict(select(t, hit), **sc)
    t = select(t, torch.isin(t["c_nationkey"], asia) &
               torch.isin(t["s_nationkey"], asia) &
               (t["c_nationkey"] == t["s_nationkey"]))
    inv, g, (nk,) = group(t["s_nationkey"])
    out = {"s_nationkey": nk, "revenue": gsum(inv, g, _disc(t))}
    return order(out, ORDER[5])


def q6(db, p):
    li = db.table("lineitem")
    m = (li["l_shipdate"] >= p["q6_date_lo"]) & \
        (li["l_shipdate"] < p["q6_date_hi"]) & \
        (li["l_discount"] >= p["q6_disc_lo"]) & \
        (li["l_discount"] <= p["q6_disc_hi"]) & \
        (li["l_quantity"] < p["q6_qty"])
    t = select(li, m)
    return scalar(revenue=(t["l_extendedprice"] * t["l_discount"]).sum())


def q7(db, p):
    o, c, s, li = (db.table(x) for x in
                   ("orders", "customer", "supplier", "lineitem"))
    fr, de = db.code("n_name", "FRANCE"), db.code("n_name", "GERMANY")
    t = select(li, (li["l_shipdate"] >= days("1995-01-01")) &
               (li["l_shipdate"] <= days("1996-12-31")))
    hit, oc = lookup(t["l_orderkey"], o["o_orderkey"], o, ["o_custkey"])
    t = dict(select(t, hit), **oc)
    hit, cc = lookup(t["o_custkey"], c["c_custkey"], c, ["c_nationkey"])
    t = dict(select(t, hit), **cc)
    hit, sc = lookup(t["l_suppkey"], s["s_suppkey"], s, ["s_nationkey"])
    t = dict(select(t, hit), **sc)
    sn, cn = t["s_nationkey"], t["c_nationkey"]
    t = select(t, ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr)))
    inv, g, (a, b, y) = group(t["s_nationkey"], t["c_nationkey"],
                              year_of(t["l_shipdate"]))
    out = {"supp_nation": a, "cust_nation": b, "l_year": y,
           "revenue": gsum(inv, g, _disc(t))}
    return order(out, ORDER[7])


def q8(db, p):
    o, c, s, pa, li = (db.table(x) for x in
                       ("orders", "customer", "supplier", "part",
                        "lineitem"))
    pk = pa["p_partkey"][pa["p_type"] == db.code("p_type",
                                                 "ECONOMY ANODIZED STEEL")]
    ck = c["c_custkey"][torch.isin(c["c_nationkey"],
                                   _nations_of(db, "AMERICA"))]
    oo = select(o, torch.isin(o["o_custkey"], ck) &
                (o["o_orderdate"] >= days("1995-01-01")) &
                (o["o_orderdate"] <= days("1996-12-31")))
    t = select(li, torch.isin(li["l_partkey"], pk))
    hit, oc = lookup(t["l_orderkey"], oo["o_orderkey"], oo, ["o_orderdate"])
    t = dict(select(t, hit), **oc)
    hit, sc = lookup(t["l_suppkey"], s["s_suppkey"], s, ["s_nationkey"])
    t = dict(select(t, hit), **sc)
    inv, g, (y,) = group(year_of(t["o_orderdate"]))
    v = _disc(t)
    br = t["s_nationkey"] == db.code("n_name", "BRAZIL")
    brazil = gsum(inv, g, torch.where(br, v, torch.zeros_like(v)))
    out = {"o_year": y, "mkt_share": brazil / gsum(inv, g, v)}
    return order(out, ORDER[8])


def q9(db, p):
    o, s, ps, pa, li = (db.table(x) for x in
                        ("orders", "supplier", "partsupp", "part",
                         "lineitem"))
    green = db.dict_lut("p_name", like("green"))
    pk = pa["p_partkey"][green[pa["p_name"]]]
    t = select(li, torch.isin(li["l_partkey"], pk))
    hit, oc = lookup(t["l_orderkey"], o["o_orderkey"], o, ["o_orderdate"])
    t = dict(select(t, hit), **oc)
    width = int(torch.maximum(ps["ps_suppkey"].max(),
                              t["l_suppkey"].max())) + 1
    hit, pc = lookup(t["l_partkey"] * width + t["l_suppkey"],
                     ps["ps_partkey"] * width + ps["ps_suppkey"], ps,
                     ["ps_supplycost"])
    t = dict(select(t, hit), **pc)
    hit, sc = lookup(t["l_suppkey"], s["s_suppkey"], s, ["s_nationkey"])
    t = dict(select(t, hit), **sc)
    inv, g, (nk, y) = group(t["s_nationkey"], year_of(t["o_orderdate"]))
    profit = _disc(t) - t["ps_supplycost"] * t["l_quantity"]
    out = {"n_name": nk, "o_year": y, "sum_profit": gsum(inv, g, profit),
           "__rank_n_name": db.rank("n_name")[nk]}
    return order(out, ORDER[9])


def q10(db, p):
    o, c, li = (db.table(x) for x in ("orders", "customer", "lineitem"))
    oo = select(o, (o["o_orderdate"] >= days("1993-10-01")) &
                (o["o_orderdate"] < days("1994-01-01")))
    t = select(li, li["l_returnflag"] == db.code("l_returnflag", "R"))
    hit, oc = lookup(t["l_orderkey"], oo["o_orderkey"], oo, ["o_custkey"])
    t = dict(select(t, hit), **oc)
    inv, g, (ck,) = group(t["o_custkey"])
    gr = {"o_custkey": ck, "revenue": gsum(inv, g, _disc(t))}
    hit, cc = lookup(gr["o_custkey"], c["c_custkey"], c,
                     ["c_acctbal", "c_nationkey"])
    out = dict(select(gr, hit), **cc)
    return order(out, ORDER[10], limit=20)


def q11(db, p):
    s, ps = db.table("supplier"), db.table("partsupp")
    sk = s["s_suppkey"][s["s_nationkey"] == db.code("n_name", "GERMANY")]
    t = select(ps, torch.isin(ps["ps_suppkey"], sk))
    val = t["ps_supplycost"] * t["ps_availqty"]
    inv, g, (pk,) = group(t["ps_partkey"])
    value = gsum(inv, g, val)
    keep = value > val.sum() * (0.0001 / db.scale)
    out = {"ps_partkey": pk[keep], "value": value[keep]}
    return order(out, ORDER[11])


def q12(db, p):
    o, li = db.table("orders"), db.table("lineitem")
    m = _isin_codes(li["l_shipmode"], db, "l_shipmode", ("MAIL", "SHIP")) & \
        (li["l_commitdate"] < li["l_receiptdate"]) & \
        (li["l_shipdate"] < li["l_commitdate"]) & \
        (li["l_receiptdate"] >= days("1994-01-01")) & \
        (li["l_receiptdate"] < days("1995-01-01"))
    t = select(li, m)
    hit, oc = lookup(t["l_orderkey"], o["o_orderkey"], o,
                     ["o_orderpriority"])
    t = dict(select(t, hit), **oc)
    hi = _isin_codes(t["o_orderpriority"], db, "o_orderpriority",
                     ("1-URGENT", "2-HIGH")).long()
    inv, g, (sm,) = group(t["l_shipmode"])
    out = {"l_shipmode": sm, "high_line_count": gsum(inv, g, hi),
           "low_line_count": gsum(inv, g, 1 - hi),
           "__rank_l_shipmode": db.rank("l_shipmode")[sm.long()]}
    return order(out, ORDER[12])


def q13(db, p):
    o, c = db.table("orders"), db.table("customer")
    special = db.dict_lut("o_comment", like("special", "requests"))
    ck = o["o_custkey"][~special[o["o_comment"]]]
    inv, g, (oc,) = group(ck)
    hit, at = join(c["c_custkey"], oc)
    c_count = torch.zeros_like(c["c_custkey"])
    c_count[hit] = gcount(inv, g)[at]
    inv, g, (cc,) = group(c_count)
    out = {"c_count": cc, "custdist": gcount(inv, g)}
    return order(out, ORDER[13])


def q14(db, p):
    pa, li = db.table("part"), db.table("lineitem")
    t = select(li, (li["l_shipdate"] >= days("1995-09-01")) &
               (li["l_shipdate"] < days("1995-10-01")))
    hit, pc = lookup(t["l_partkey"], pa["p_partkey"], pa, ["p_type"])
    t = dict(select(t, hit), **pc)
    promo = db.dict_lut("p_type", lambda x: x.startswith("PROMO"))
    v = _disc(t)
    pr = torch.where(promo[t["p_type"]], v, torch.zeros_like(v)).sum()
    return scalar(promo_revenue=100.0 * pr / v.sum())


def q15(db, p):
    s, li = db.table("supplier"), db.table("lineitem")
    t = select(li, (li["l_shipdate"] >= days("1996-01-01")) &
               (li["l_shipdate"] < days("1996-04-01")))
    inv, g, (sk,) = group(t["l_suppkey"])
    rev = gsum(inv, g, _disc(t))
    keep = rev >= rev.max() * (1 - 0.000000000001)
    top = {"l_suppkey": sk[keep], "total_revenue": rev[keep]}
    hit, sc = lookup(top["l_suppkey"], s["s_suppkey"], s, ["s_nationkey"])
    out = dict(select(top, hit), **sc)
    return order(out, ORDER[15])


def q16(db, p):
    s, ps, pa = db.table("supplier"), db.table("partsupp"), db.table("part")
    mp = db.dict_lut("p_type", lambda x: x.startswith("MEDIUM POLISHED"))
    sizes = torch.tensor([49, 14, 23, 45, 19, 3, 36, 9], device=db.device)
    parts = select(pa, (pa["p_brand"] != db.code("p_brand", "Brand#45")) &
                   ~mp[pa["p_type"]] & torch.isin(pa["p_size"], sizes))
    hit, pc = lookup(ps["ps_partkey"], parts["p_partkey"], parts,
                     ["p_brand", "p_type", "p_size"])
    t = dict(select(ps, hit), **pc)
    bad = db.dict_lut("s_comment", like("Customer", "Complaints"))
    t = select(t, ~torch.isin(t["ps_suppkey"],
                              s["s_suppkey"][bad[s["s_comment"]]]))
    inv, g, (b, ty, sz, _) = group(t["p_brand"], t["p_type"], t["p_size"],
                                   t["ps_suppkey"])
    inv, g, (b, ty, sz) = group(b, ty, sz)
    out = {"p_brand": b, "p_type": ty, "p_size": sz,
           "supplier_cnt": gcount(inv, g),
           "__rank_p_type": db.rank("p_type")[ty.long()]}
    return order(out, ORDER[16])


def q17(db, p):
    pa, li = db.table("part"), db.table("lineitem")
    pk = pa["p_partkey"][(pa["p_brand"] == db.code("p_brand", "Brand#23")) &
                         (pa["p_container"] == db.code("p_container",
                                                       "MED BOX"))]
    t = select(li, torch.isin(li["l_partkey"], pk))
    inv, g, _ = group(t["l_partkey"])
    avg = gsum(inv, g, t["l_quantity"]).to(db.fdt) / gcount(inv, g)
    t = select(t, t["l_quantity"] < 0.2 * avg[inv])
    return scalar(avg_yearly=t["l_extendedprice"].sum() / 7.0)


def q18(db, p):
    o, c, li = db.table("orders"), db.table("customer"), db.table("lineitem")
    inv, g, (ok,) = group(li["l_orderkey"])
    sq = gsum(inv, g, li["l_quantity"])
    big = {"l_orderkey": ok[sq > 300], "sum_qty": sq[sq > 300]}
    hit, oc = lookup(big["l_orderkey"], o["o_orderkey"], o,
                     ["o_custkey", "o_orderdate", "o_totalprice"])
    t = dict(select(big, hit), **oc)
    t = select(t, torch.isin(t["o_custkey"], c["c_custkey"]))
    return order(t, ORDER[18], limit=100)


def q19(db, p):
    pa, li = db.table("part"), db.table("lineitem")
    t = select(li, (li["l_shipinstruct"] ==
                    db.code("l_shipinstruct", "DELIVER IN PERSON")) &
               _isin_codes(li["l_shipmode"], db, "l_shipmode",
                           ("AIR", "AIR REG")))
    hit, pc = lookup(t["l_partkey"], pa["p_partkey"], pa,
                     ["p_brand", "p_container", "p_size"])
    t = dict(select(t, hit), **pc)
    br, cont, size, q = (t["p_brand"], t["p_container"], t["p_size"],
                         t["l_quantity"])
    b12, b23, b34 = (br == db.code("p_brand", x)
                     for x in ("Brand#12", "Brand#23", "Brand#34"))
    sm = _isin_codes(cont, db, "p_container",
                     ("SM CASE", "SM BOX", "SM PACK", "SM PKG"))
    md = _isin_codes(cont, db, "p_container",
                     ("MED BAG", "MED BOX", "MED PKG", "MED PACK"))
    lg = _isin_codes(cont, db, "p_container",
                     ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))
    on_part = (b12 & sm & (size >= 1) & (size <= 5)) | \
        (b23 & md & (size >= 1) & (size <= 10)) | \
        (b34 & lg & (size >= 1) & (size <= 15))
    on_qty = (b12 & (q >= 1) & (q <= 11)) | (b23 & (q >= 10) & (q <= 20)) | \
        (b34 & (q >= 20) & (q <= 30))
    t = select(t, on_part & on_qty)
    return scalar(revenue=_disc(t).sum())


def q20(db, p):
    s, ps, pa, li = (db.table(x) for x in
                     ("supplier", "partsupp", "part", "lineitem"))
    forest = db.dict_lut("p_name", lambda x: x.startswith("forest"))
    fp = pa["p_partkey"][forest[pa["p_name"]]]
    t = select(li, (li["l_shipdate"] >= days("1994-01-01")) &
               (li["l_shipdate"] < days("1995-01-01")) &
               torch.isin(li["l_partkey"], fp))
    inv, g, (gp, gs) = group(t["l_partkey"], t["l_suppkey"])
    sq = gsum(inv, g, t["l_quantity"])
    pt = select(ps, torch.isin(ps["ps_partkey"], fp))
    width = int(torch.maximum(ps["ps_suppkey"].max(),
                              li["l_suppkey"].max())) + 1
    hit, at = join(pt["ps_partkey"] * width + pt["ps_suppkey"],
                   gp * width + gs)
    pt = select(pt, hit)
    pt = select(pt, pt["ps_availqty"] > 0.5 * sq[at])
    out = select(s, torch.isin(s["s_suppkey"], pt["ps_suppkey"]) &
                 (s["s_nationkey"] == db.code("n_name", "CANADA")))
    return order({"s_suppkey": out["s_suppkey"],
                  "s_nationkey": out["s_nationkey"]}, ORDER[20])


def q21(db, p):
    s, o, li = db.table("supplier"), db.table("orders"), db.table("lineitem")

    def distinct_suppliers(t):
        inv, g, (ok, _) = group(t["l_orderkey"], t["l_suppkey"])
        inv, g, (ok,) = group(ok)
        return ok, gcount(inv, g)

    all_ok, nsupp = distinct_suppliers(li)
    late = select(li, li["l_receiptdate"] > li["l_commitdate"])
    late_ok, nlate = distinct_suppliers(late)
    sa = s["s_suppkey"][s["s_nationkey"] == db.code("n_name",
                                                    "SAUDI ARABIA")]
    fo = o["o_orderkey"][o["o_orderstatus"] == db.code("o_orderstatus", "F")]
    t = select(late, torch.isin(late["l_suppkey"], sa) &
               torch.isin(late["l_orderkey"], fo))
    hit, at = join(t["l_orderkey"], all_ok)
    t, ns = select(t, hit), nsupp[at]
    hit, at = join(t["l_orderkey"], late_ok)
    t, ns, nl = select(t, hit), ns[hit], nlate[at]
    t = select(t, (ns >= 2) & (nl == 1))
    inv, g, (sk,) = group(t["l_suppkey"])
    out = {"l_suppkey": sk, "numwait": gcount(inv, g)}
    return order(out, ORDER[21], limit=100)


def q22(db, p):
    c, o = db.table("customer"), db.table("orders")
    codes = torch.tensor([13, 31, 23, 29, 30, 18, 17], device=db.device)
    cs = select(c, torch.isin(c["c_phone_cc"], codes))
    pos = cs["c_acctbal"][cs["c_acctbal"] > 0.0]
    avg = pos.sum() / pos.numel()
    cs = select(cs, (cs["c_acctbal"] > avg) &
                ~torch.isin(cs["c_custkey"], o["o_custkey"]))
    inv, g, (cc,) = group(cs["c_phone_cc"])
    out = {"c_phone_cc": cc, "numcust": gcount(inv, g),
           "totacctbal": gsum(inv, g, cs["c_acctbal"])}
    return order(out, ORDER[22])


# each query's ORDER BY: (column, ascending), the first the most significant
ORDER: dict[int, list[tuple[str, bool]]] = {
    1: [("l_returnflag", True), ("l_linestatus", True)],
    2: [("s_acctbal", False), ("__rank_n_name", True), ("ps_suppkey", True),
        ("ps_partkey", True)],
    3: [("revenue", False), ("o_orderdate", True)],
    4: [("o_orderpriority", True)],
    5: [("revenue", False)],
    6: [],
    7: [("supp_nation", True), ("cust_nation", True), ("l_year", True)],
    8: [("o_year", True)],
    9: [("__rank_n_name", True), ("o_year", False)],
    10: [("revenue", False)],
    11: [("value", False)],
    12: [("__rank_l_shipmode", True)],
    13: [("custdist", False), ("c_count", False)],
    14: [],
    15: [("l_suppkey", True)],
    16: [("supplier_cnt", False), ("p_brand", True), ("__rank_p_type", True),
         ("p_size", True)],
    17: [],
    18: [("o_totalprice", False), ("o_orderdate", True)],
    19: [],
    20: [("s_suppkey", True)],
    21: [("numwait", False), ("l_suppkey", True)],
    22: [("c_phone_cc", True)],
}

_QUERIES = {i: globals()[f"q{i}"] for i in range(1, 23)}


def answer(db: RefDB, qid: int, binding: dict) -> dict[str, np.ndarray]:
    """The answer to TPC-H query ``qid`` under ``binding``, as host numpy
    columns."""
    with torch.no_grad():
        out = _QUERIES[int(qid)](db, binding)
    return {k: v.cpu().numpy() for k, v in out.items()}
