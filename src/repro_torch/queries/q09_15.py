"""TPC-H Q9-Q15 as lazy logical plans (builder API; see queries/__init__.py)."""
from repro_torch.core.plan import (alpha_rank, col, db_scale, isin, like, result,
                             scan, scode, starts_with, where, year)
from repro_torch.core.table import days
from .q01_08 import _disc

__all__ = ["q9", "q10", "q11", "q12", "q13", "q14", "q15"]


def q9():
    """Product type profit.  1 shuffle (lineitem->partkey) + 2 broadcasts."""
    p = scan("part").filter(like("p_name", "green"))
    pb = p.select("p_partkey").broadcast()                               # b1
    sb = scan("supplier").select("s_suppkey", "s_nationkey").broadcast()  # b2
    l = scan("lineitem").join(scan("orders"), "l_orderkey", "o_orderkey",
                              ["o_orderdate"])                           # co-partitioned
    l = l.semi(pb, "l_partkey", "p_partkey")
    ls = l.select("l_partkey", "l_suppkey", "l_quantity", "l_extendedprice",
                  "l_discount", "o_orderdate").shuffle("l_partkey")      # s1
    j = ls.join(scan("partsupp"), ("l_partkey", "l_suppkey"),
                ("ps_partkey", "ps_suppkey"), ["ps_supplycost"])         # partkey-local
    j = j.join(sb, "l_suppkey", "s_suppkey", ["s_nationkey"])
    j = j.with_col(o_year=year(col("o_orderdate")))
    j = j.with_col(grp=col("s_nationkey") * 16 + (col("o_year") - 1992))
    g = j.group_by(["grp"], [
        ("n_name", "max", "s_nationkey"),
        ("o_year", "max", "o_year"),
        ("sum_profit", "sum",
         _disc - col("ps_supplycost") * col("l_quantity")),
    ], exchange="gather", final=True)
    g = g.with_col(n_rank=alpha_rank("n_name"))
    return g.select("n_name", "n_rank", "o_year", "sum_profit") \
        .finalize(sort_keys=[("n_rank", True), ("o_year", False)],
                  replicated=True)


def q10():
    """Returned item reporting.  1 shuffle to customer partitioning."""
    o = scan("orders").filter((col("o_orderdate") >= days("1993-10-01")) &
                              (col("o_orderdate") < days("1994-01-01")))
    l = scan("lineitem").filter(col("l_returnflag") ==
                                scode("l_returnflag", "R"))
    j = l.join(o, "l_orderkey", "o_orderkey", ["o_custkey"])
    g = j.group_by(["o_custkey"], [("revenue", "sum", _disc)],
                   exchange="shuffle")                                   # s1
    j2 = g.join(scan("customer"), "o_custkey", "c_custkey",
                ["c_acctbal", "c_nationkey"])                            # custkey-local
    return j2.select("o_custkey", "revenue", "c_acctbal", "c_nationkey") \
        .finalize(sort_keys=[("revenue", False)], limit=20)


def q11():
    """Important stock identification.  1 broadcast (DE suppliers) + allreduce.

    Paper counts 1 shuffle + 1 broadcast; under §4.3 partsupp@ps_partkey the
    group-by is local, removing their shuffle (DESIGN.md deviation)."""
    s = scan("supplier").filter(col("s_nationkey") ==
                                scode("n_name", "GERMANY"))
    sb = s.select("s_suppkey").broadcast()                               # b1
    ps = scan("partsupp").semi(sb, "ps_suppkey", "s_suppkey")
    val = col("ps_supplycost") * col("ps_availqty")
    g = ps.group_by(["ps_partkey"], [("value", "sum", val)],
                    exchange="local")                                    # partkey-local
    tot = ps.agg_scalar([("t", "sum", val)])["t"]
    g = g.filter(col("value") > tot * (0.0001 / db_scale()))
    g = g.shrink(1 << 20)   # result rows bounded well below partkeys
    return g.finalize(sort_keys=[("value", False)])


def q12():
    """Shipping modes / order priority.  Fully co-partitioned: no exchange."""
    l = scan("lineitem").filter(
        isin(col("l_shipmode"), [scode("l_shipmode", "MAIL"),
                                 scode("l_shipmode", "SHIP")]) &
        (col("l_commitdate") < col("l_receiptdate")) &
        (col("l_shipdate") < col("l_commitdate")) &
        (col("l_receiptdate") >= days("1994-01-01")) &
        (col("l_receiptdate") < days("1995-01-01")))
    j = l.join(scan("orders"), "l_orderkey", "o_orderkey",
               ["o_orderpriority"])
    hi = isin(col("o_orderpriority"),
              [scode("o_orderpriority", "1-URGENT"),
               scode("o_orderpriority", "2-HIGH")])
    g = j.group_by(["l_shipmode"], [
        ("high_line_count", "sum", where(hi, 1, 0)),
        ("low_line_count", "sum", where(hi, 0, 1)),
    ], exchange="gather", final=True)
    g = g.with_col(m_rank=alpha_rank("l_shipmode"))
    return g.finalize(sort_keys=[("m_rank", True)], replicated=True)


def q13():
    """Customer distribution.  1 shuffle (orders -> custkey) + left join.

    ``groups_hint=256`` on the c_count histogram is a plan-author claim the
    planner cannot prove (orders-per-customer is data-dependent) — exactly
    the case the explicit hint remains for.  The claim buys a sortless
    group-by: the planner's method rule routes it through the hash-compaction
    dictionary (``kernels/hash_group``), and overflow re-executes if a
    customer ever exceeds it."""
    o = scan("orders").filter(~like("o_comment", "special", "requests"))
    go = o.group_by(["o_custkey"], [("c_count", "count", None)],
                    exchange="shuffle")                                  # s1
    lj = scan("customer").left(go, "c_custkey", "o_custkey",
                               ["c_count"], {"c_count": 0})              # custkey-local
    g = lj.group_by(["c_count"], [("custdist", "count", None)],
                    exchange="gather", final=True, groups_hint=256)
    return g.finalize(sort_keys=[("custdist", False), ("c_count", False)],
                      replicated=True)


def q14():
    """Promotion effect.  1 shuffle of the date-filtered lineitem slice."""
    l = scan("lineitem").filter((col("l_shipdate") >= days("1995-09-01")) &
                                (col("l_shipdate") < days("1995-10-01")))
    ls = l.select("l_partkey", "l_extendedprice",
                  "l_discount").shuffle("l_partkey")                     # s1
    j = ls.join(scan("part"), "l_partkey", "p_partkey", ["p_type"])
    s = j.agg_scalar([
        ("promo", "sum", where(starts_with("p_type", "PROMO"), _disc, 0.0)),
        ("total", "sum", _disc)])
    return result(promo_revenue=100.0 * s["promo"] / s["total"])


def q15():
    """Top supplier.  1 shuffle of per-supplier partials + allreduce max."""
    l = scan("lineitem").filter((col("l_shipdate") >= days("1996-01-01")) &
                                (col("l_shipdate") < days("1996-04-01")))
    g = l.group_by(["l_suppkey"], [("total_revenue", "sum", _disc)],
                   exchange="shuffle")                                   # s1
    mx = g.agg_scalar([("mx", "max", "total_revenue")])["mx"]
    top = g.filter(col("total_revenue") >= mx * (1 - 1e-12))
    top = top.shrink(1024)               # max-revenue ties are rare
    j = top.join(scan("supplier"), "l_suppkey", "s_suppkey",
                 ["s_nationkey"])                                        # suppkey-local
    return j.finalize(sort_keys=[("l_suppkey", True)])
