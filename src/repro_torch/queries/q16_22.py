"""TPC-H Q16-Q22 as lazy logical plans (builder API; see queries/__init__.py)."""
from repro_torch.core.plan import (col, isin, like, result, scan, scode,
                             starts_with, alpha_rank)
from repro_torch.core.table import days
from .q01_08 import _disc

__all__ = ["q16", "q17", "q18", "q19", "q20", "q21", "q22"]

# packing strides for Q16's composite group key (dictionary domain sizes;
# part of the key DEFINITION, not a planner hint — the planner derives the
# actual key width from column bounds)
_NTYPES = 150
_NSIZES = 51


def q16():
    """Parts/supplier relationship.  1 shuffle (group key) + 1 broadcast."""
    p = scan("part").filter(
        (col("p_brand") != scode("p_brand", "Brand#45")) &
        ~starts_with("p_type", "MEDIUM POLISHED") &
        isin(col("p_size"), [49, 14, 23, 45, 19, 3, 36, 9]))
    j = scan("partsupp").join(p, "ps_partkey", "p_partkey",
                              ["p_brand", "p_type", "p_size"])           # partkey-local
    s = scan("supplier").filter(like("s_comment", "Customer", "Complaints"))
    sb = s.select("s_suppkey").broadcast()                               # b1
    j = j.anti(sb, "ps_suppkey", "s_suppkey")
    j = j.with_col(grp=(col("p_brand").astype("int64") * _NTYPES +
                        col("p_type")) * _NSIZES + col("p_size"))
    js = j.select("grp", "ps_suppkey", "p_brand", "p_type",
                  "p_size").shuffle("grp")                               # s1
    d = js.group_by(["grp", "ps_suppkey"], [
        ("p_brand", "max", "p_brand"), ("p_type", "max", "p_type"),
        ("p_size", "max", "p_size")], exchange="local")                  # dedup
    g = d.group_by(["grp"], [
        ("supplier_cnt", "count", None),
        ("p_brand", "max", "p_brand"), ("p_type", "max", "p_type"),
        ("p_size", "max", "p_size")], exchange="local")
    g = g.shrink(1 << 18)   # <= brand x type x size domain (191k)
    g = g.with_col(t_rank=alpha_rank("p_type"))
    return g.select("p_brand", "p_type", "t_rank", "p_size",
                    "supplier_cnt") \
        .finalize(sort_keys=[("supplier_cnt", False), ("p_brand", True),
                             ("t_rank", True), ("p_size", True)])


def q17():
    """Small-quantity-order revenue.  1 broadcast (part) + 1 shuffle."""
    p = scan("part").filter(
        (col("p_brand") == scode("p_brand", "Brand#23")) &
        (col("p_container") == scode("p_container", "MED BOX")))
    pb = p.select("p_partkey").broadcast()                               # b1
    l = scan("lineitem").semi(pb, "l_partkey", "p_partkey")
    ls = l.select("l_partkey", "l_quantity",
                  "l_extendedprice").shuffle("l_partkey")                # s1
    avg = ls.group_by(["l_partkey"], [("avg_qty", "avg", "l_quantity")],
                      exchange="local")
    j = ls.join(avg.rename({"l_partkey": "pk"}), "l_partkey", "pk",
                ["avg_qty"])
    j = j.filter(col("l_quantity") < 0.2 * col("avg_qty"))
    s = j.agg_scalar([("s", "sum", "l_extendedprice")])
    return result(avg_yearly=s["s"] / 7.0)


def q18():
    """Large volume customer.  1 broadcast of the tiny >300-qty order set."""
    gl = scan("lineitem").group_by(
        ["l_orderkey"], [("sum_qty", "sum", "l_quantity")],
        exchange="local")                                                # orderkey-local
    big = gl.filter(col("sum_qty") > 300)
    j = big.join(scan("orders"), "l_orderkey", "o_orderkey",
                 ["o_custkey", "o_orderdate", "o_totalprice"])
    j = j.shrink(1 << 14)   # >300-qty orders are ~0.006% of orders;
    jb = j.broadcast()      # b1 — overflow retriggers with 2x factor
    j2 = jb.join(scan("customer"), "o_custkey", "c_custkey", [])
    # probe is replicated, build is partitioned: each order lands on exactly
    # one device (its customer's shard) — globally exact, no dedup needed.
    return j2.finalize(sort_keys=[("o_totalprice", False),
                                  ("o_orderdate", True)], limit=100)


def q19():
    """Discounted revenue (the paper's Figure 4 example): 1 broadcast."""
    b12 = scode("p_brand", "Brand#12")
    b23 = scode("p_brand", "Brand#23")
    b34 = scode("p_brand", "Brand#34")
    c_sm = [scode("p_container", c) for c in
            ("SM CASE", "SM BOX", "SM PACK", "SM PKG")]
    c_md = [scode("p_container", c) for c in
            ("MED BAG", "MED BOX", "MED PKG", "MED PACK")]
    c_lg = [scode("p_container", c) for c in
            ("LG CASE", "LG BOX", "LG PACK", "LG PKG")]
    p = scan("part").filter(
        ((col("p_brand") == b12) & isin(col("p_container"), c_sm) &
         (col("p_size") >= 1) & (col("p_size") <= 5)) |
        ((col("p_brand") == b23) & isin(col("p_container"), c_md) &
         (col("p_size") >= 1) & (col("p_size") <= 10)) |
        ((col("p_brand") == b34) & isin(col("p_container"), c_lg) &
         (col("p_size") >= 1) & (col("p_size") <= 15)))
    pb = p.select("p_partkey", "p_brand").broadcast()                    # b1
    l = scan("lineitem").filter(
        (col("l_shipinstruct") == scode("l_shipinstruct",
                                        "DELIVER IN PERSON")) &
        isin(col("l_shipmode"), [scode("l_shipmode", "AIR"),
                                 scode("l_shipmode", "AIR REG")]))
    j = l.join(pb, "l_partkey", "p_partkey", ["p_brand"])
    q = col("l_quantity")
    j = j.filter(((col("p_brand") == b12) & (q >= 1) & (q <= 11)) |
                 ((col("p_brand") == b23) & (q >= 10) & (q <= 20)) |
                 ((col("p_brand") == b34) & (q >= 20) & (q <= 30)))
    s = j.agg_scalar([("revenue", "sum", _disc)])
    return result(revenue=s["revenue"])


def q20():
    """Potential part promotion.  1 shuffle + 2 broadcasts."""
    p = scan("part").filter(starts_with("p_name", "forest"))
    pb = p.select("p_partkey").broadcast()                               # b1
    l = scan("lineitem").filter((col("l_shipdate") >= days("1994-01-01")) &
                                (col("l_shipdate") < days("1995-01-01")))
    l = l.semi(pb, "l_partkey", "p_partkey")
    ls = l.select("l_partkey", "l_suppkey",
                  "l_quantity").shuffle("l_partkey")                     # s1
    g = ls.group_by(["l_partkey", "l_suppkey"], [("sq", "sum", "l_quantity")],
                    exchange="local")
    ps = scan("partsupp").semi(pb, "ps_partkey", "p_partkey")
    j = ps.join(g, ("ps_partkey", "ps_suppkey"), ("l_partkey", "l_suppkey"),
                ["sq"])                                                  # partkey-local
    j = j.filter(col("ps_availqty") > 0.5 * col("sq"))
    # per-device distinct suppkeys: consumed membership-only (broadcast ->
    # semi), so the partial 'local' group-by is globally exact
    sk = j.group_by(["ps_suppkey"], [("n", "count", None)],
                    exchange="local")
    skb = sk.select("ps_suppkey").broadcast()                            # b2
    s = scan("supplier").semi(skb, "s_suppkey", "ps_suppkey")
    s = s.filter(col("s_nationkey") == scode("n_name", "CANADA"))
    s = s.shrink(1 << 16)                # <= suppliers of one nation
    return s.select("s_suppkey", "s_nationkey") \
        .finalize(sort_keys=[("s_suppkey", True)])


def _join_same_key(probe, build, key, take):
    """Join where probe and build share the key column name."""
    return probe.join(build.rename({key: "__bk"}), key, "__bk", take)


def q21():
    """Suppliers who kept orders waiting.  Exists/not-exists via per-order
    distinct-supplier counts (orderkey-local); 1 broadcast (SA suppliers)."""
    l = scan("lineitem")
    d_all = l.group_by(["l_orderkey", "l_suppkey"], [("n", "count", None)],
                       exchange="local")
    g_all = d_all.group_by(["l_orderkey"], [("nsupp", "count", None)],
                           exchange="local")
    late = l.filter(col("l_receiptdate") > col("l_commitdate"))
    d_late = late.group_by(["l_orderkey", "l_suppkey"],
                           [("n", "count", None)], exchange="local")
    g_late = d_late.group_by(["l_orderkey"], [("nlate", "count", None)],
                             exchange="local")
    s = scan("supplier").filter(col("s_nationkey") ==
                                scode("n_name", "SAUDI ARABIA"))
    sb = s.select("s_suppkey").broadcast()                               # b1
    l1 = late.semi(sb, "l_suppkey", "s_suppkey")
    o = scan("orders").filter(col("o_orderstatus") ==
                              scode("o_orderstatus", "F"))
    l1 = l1.semi(o, "l_orderkey", "o_orderkey")
    l1 = _join_same_key(l1, g_all, "l_orderkey", ["nsupp"])
    l1 = _join_same_key(l1, g_late, "l_orderkey", ["nlate"])
    l1 = l1.filter((col("nsupp") >= 2) & (col("nlate") == 1))
    g = l1.group_by(["l_suppkey"], [("numwait", "count", None)],
                    exchange="gather", final=True)
    return g.finalize(sort_keys=[("numwait", False), ("l_suppkey", True)],
                      limit=100, replicated=True)


def q22():
    """Global sales opportunity.  1 shuffle (orders custkeys) + 2 allreduces."""
    cs = scan("customer").filter(
        isin(col("c_phone_cc"), [13, 31, 23, 29, 30, 18, 17]))
    pos = cs.filter(col("c_acctbal") > 0.0)
    avg = pos.agg_scalar([("a", "avg", "c_acctbal")])["a"]
    go = scan("orders").group_by(["o_custkey"], [("n", "count", None)],
                                 exchange="shuffle")                     # s1
    cs2 = cs.filter(col("c_acctbal") > avg)
    cs2 = cs2.anti(go, "c_custkey", "o_custkey")                         # custkey-local
    g = cs2.group_by(["c_phone_cc"], [
        ("numcust", "count", None), ("totacctbal", "sum", "c_acctbal")],
        exchange="gather", final=True)
    return g.finalize(sort_keys=[("c_phone_cc", True)], replicated=True)
