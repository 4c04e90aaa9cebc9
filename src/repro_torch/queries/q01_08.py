"""TPC-H Q1-Q8 as lazy logical plans (builder API; see queries/__init__.py).

Each ``qN()`` returns the ROOT NODE of a plan DAG; the planner compiles it
against a backend Context and infers every static hint (``key_bits``,
``groups_hint``) the legacy eager plans carried by hand.
"""
from repro_torch.core.plan import (alpha_rank, col, ends_with, isin, result, scan,
                             scode, where, year)
from repro_torch.core.table import days

__all__ = ["q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8"]

# reusable column expressions (plain data — safe to share across plans)
_disc = col("l_extendedprice") * (1 - col("l_discount"))
_charge = _disc * (1 + col("l_tax"))


def q1():
    """Pricing summary report.  No exchange: local agg + final gather-merge."""
    l = scan("lineitem").filter(col("l_shipdate") <= days("1998-09-02"))
    g = l.group_by(["l_returnflag", "l_linestatus"], [
        ("sum_qty", "sum", "l_quantity"),
        ("sum_base_price", "sum", "l_extendedprice"),
        ("sum_disc_price", "sum", _disc),
        ("sum_charge", "sum", _charge),
        ("avg_qty", "avg", "l_quantity"),
        ("avg_price", "avg", "l_extendedprice"),
        ("avg_disc", "avg", "l_discount"),
        ("count_order", "count", None),
    ], exchange="gather", final=True)
    return g.finalize(sort_keys=[("l_returnflag", True),
                                 ("l_linestatus", True)], replicated=True)


def _europe_suppliers():
    n = scan("nation").join(scan("region"), "n_regionkey", "r_regionkey",
                            ["r_name"])
    n = n.filter(col("r_name") == scode("r_name", "EUROPE"))
    return scan("supplier").join(n, "s_nationkey", "n_nationkey", ["n_name"])


def q2():
    """Minimum-cost supplier.  Broadcast the (small) filtered EU suppliers."""
    p = scan("part").filter((col("p_size") == 15) &
                            ends_with("p_type", "BRASS"))
    sb = _europe_suppliers().select("s_suppkey", "s_acctbal",
                                    "n_name").broadcast()
    j = scan("partsupp").join(p, "ps_partkey", "p_partkey", ["p_mfgr"])  # co-partitioned
    j = j.join(sb, "ps_suppkey", "s_suppkey", ["s_acctbal", "n_name"])
    mn = j.group_by(["ps_partkey"], [("min_cost", "min", "ps_supplycost")],
                    exchange="local")                                    # partkey-local
    j = j.join(mn.rename({"ps_partkey": "mk"}), "ps_partkey", "mk",
               ["min_cost"])
    j = j.filter(col("ps_supplycost") == col("min_cost"))
    j = j.with_col(n_rank=alpha_rank("n_name"))
    out = j.select("s_acctbal", "n_name", "n_rank", "ps_suppkey",
                   "ps_partkey", "p_mfgr")
    return out.finalize(sort_keys=[("s_acctbal", False), ("n_rank", True),
                                   ("ps_suppkey", True), ("ps_partkey", True)],
                        limit=100)


def q3():
    """Shipping priority.  Broadcast BUILDING-segment customer keys."""
    c = scan("customer").filter(col("c_mktsegment") ==
                                scode("c_mktsegment", "BUILDING"))
    cb = c.select("c_custkey").broadcast()
    o = scan("orders").filter(col("o_orderdate") < days("1995-03-15"))
    o = o.semi(cb, "o_custkey", "c_custkey")
    l = scan("lineitem").filter(col("l_shipdate") > days("1995-03-15"))
    j = l.join(o, "l_orderkey", "o_orderkey",
               ["o_orderdate", "o_shippriority"])
    g = j.group_by(["l_orderkey"], [
        ("revenue", "sum", _disc),
        ("o_orderdate", "max", "o_orderdate"),
        ("o_shippriority", "max", "o_shippriority"),
    ], exchange="local")                                                 # orderkey-local
    return g.finalize(sort_keys=[("revenue", False), ("o_orderdate", True)],
                      limit=10)


def q4():
    """Order priority checking.  Fully co-partitioned: no exchange."""
    o = scan("orders").filter((col("o_orderdate") >= days("1993-07-01")) &
                              (col("o_orderdate") < days("1993-10-01")))
    lc = scan("lineitem").filter(col("l_commitdate") < col("l_receiptdate"))
    o = o.semi(lc, "o_orderkey", "l_orderkey")
    g = o.group_by(["o_orderpriority"], [("order_count", "count", None)],
                   exchange="gather", final=True)
    return g.finalize(sort_keys=[("o_orderpriority", True)], replicated=True)


def q5():
    """Local supplier volume.  Two dimension broadcasts (customer, supplier)."""
    n = scan("nation").join(scan("region"), "n_regionkey", "r_regionkey",
                            ["r_name"])
    n = n.filter(col("r_name") == scode("r_name", "ASIA"))
    c = scan("customer").semi(n, "c_nationkey", "n_nationkey")
    cb = c.select("c_custkey", "c_nationkey").broadcast()
    o = scan("orders").filter((col("o_orderdate") >= days("1994-01-01")) &
                              (col("o_orderdate") < days("1995-01-01")))
    oj = o.join(cb, "o_custkey", "c_custkey", ["c_nationkey"])
    lj = scan("lineitem").join(oj, "l_orderkey", "o_orderkey",
                               ["c_nationkey"])
    s = scan("supplier").semi(n, "s_nationkey", "n_nationkey")
    sb = s.select("s_suppkey", "s_nationkey").broadcast()
    lj = lj.join(sb, "l_suppkey", "s_suppkey", ["s_nationkey"])
    lj = lj.filter(col("c_nationkey") == col("s_nationkey"))
    g = lj.group_by(["s_nationkey"], [("revenue", "sum", _disc)],
                    exchange="gather", final=True)
    return g.finalize(sort_keys=[("revenue", False)], replicated=True)


def q6():
    """Forecasting revenue change: pure scan + allreduce."""
    l = scan("lineitem").filter(
        (col("l_shipdate") >= days("1994-01-01")) &
        (col("l_shipdate") < days("1995-01-01")) &
        (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07) &
        (col("l_quantity") < 24))
    s = l.agg_scalar([("revenue", "sum",
                       col("l_extendedprice") * col("l_discount"))])
    return result(revenue=s["revenue"])


def q7():
    """Volume shipping FRANCE<->GERMANY.  Broadcast both filtered dimensions."""
    fr = scode("n_name", "FRANCE")
    de = scode("n_name", "GERMANY")
    s = scan("supplier").filter(isin(col("s_nationkey"), [fr, de]))
    sb = s.select("s_suppkey", "s_nationkey").broadcast()
    c = scan("customer").filter(isin(col("c_nationkey"), [fr, de]))
    cb = c.select("c_custkey", "c_nationkey").broadcast()
    oj = scan("orders").join(cb, "o_custkey", "c_custkey", ["c_nationkey"])
    l = scan("lineitem").filter((col("l_shipdate") >= days("1995-01-01")) &
                                (col("l_shipdate") <= days("1996-12-31")))
    lj = l.join(oj, "l_orderkey", "o_orderkey", ["c_nationkey"])
    lj = lj.join(sb, "l_suppkey", "s_suppkey", ["s_nationkey"])
    lj = lj.filter(((col("s_nationkey") == fr) & (col("c_nationkey") == de)) |
                   ((col("s_nationkey") == de) & (col("c_nationkey") == fr)))
    lj = lj.with_col(l_year=year(col("l_shipdate")))
    lj = lj.with_col(grp=(col("s_nationkey") * 25 + col("c_nationkey")) * 8 +
                     (col("l_year") - 1992))
    g = lj.group_by(["grp"], [
        ("supp_nation", "max", "s_nationkey"),
        ("cust_nation", "max", "c_nationkey"),
        ("l_year", "max", "l_year"),
        ("revenue", "sum", _disc),
    ], exchange="gather", final=True)
    return g.select("supp_nation", "cust_nation", "l_year", "revenue") \
        .finalize(sort_keys=[("supp_nation", True), ("cust_nation", True),
                             ("l_year", True)], replicated=True)


def q8():
    """National market share.  Three broadcasts: part, supplier, customer."""
    br = scode("n_name", "BRAZIL")
    n = scan("nation").join(scan("region"), "n_regionkey", "r_regionkey",
                            ["r_name"])
    n = n.filter(col("r_name") == scode("r_name", "AMERICA"))
    p = scan("part").filter(col("p_type") ==
                            scode("p_type", "ECONOMY ANODIZED STEEL"))
    pb = p.select("p_partkey").broadcast()                               # b1
    l = scan("lineitem").semi(pb, "l_partkey", "p_partkey")
    sb = scan("supplier").select("s_suppkey", "s_nationkey").broadcast()  # b2
    l = l.join(sb, "l_suppkey", "s_suppkey", ["s_nationkey"])
    c = scan("customer").semi(n, "c_nationkey", "n_nationkey")
    cb = c.select("c_custkey").broadcast()                               # b3
    o = scan("orders").filter((col("o_orderdate") >= days("1995-01-01")) &
                              (col("o_orderdate") <= days("1996-12-31")))
    o = o.semi(cb, "o_custkey", "c_custkey")
    lj = l.join(o, "l_orderkey", "o_orderkey", ["o_orderdate"])
    lj = lj.with_col(o_year=year(col("o_orderdate")))
    g = lj.group_by(["o_year"], [
        ("total", "sum", _disc),
        ("brazil", "sum", where(col("s_nationkey") == br, _disc, 0.0)),
    ], exchange="gather", final=True)
    g = g.with_col(mkt_share=col("brazil") / col("total"))
    return g.select("o_year", "mkt_share") \
        .finalize(sort_keys=[("o_year", True)], replicated=True)
