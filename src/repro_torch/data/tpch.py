"""TPC-H data generator (dbgen-shaped, tensor-format output).

Follows the TPC-H v3 specification's shapes and relationships where they matter
for query semantics:

  * partsupp suppliers per part follow the spec formula, so every
    (l_partkey, l_suppkey) pair exists in partsupp (Q9's join depends on it);
  * one third of custkeys place no orders (Q13/Q22 depend on it);
  * o_orderstatus / l_linestatus / l_returnflag derive from the 1995-06-17
    "current date" rule; o_totalprice is the actual sum of its lineitems;
  * phone country code = nationkey + 10 (Q22).

Strings are dictionary-encoded (TQP's encoding); comments use small template
dictionaries (DESIGN.md §9 deviation), with the spec's complaint /
special-requests populations represented.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.table import Database, days

__all__ = ["generate", "FACT_TABLES", "NATIONS", "REGIONS", "NATION_REGION"]

# The big tables worth sampling: the approx ladder (repro.approx) builds its
# stratified rungs over these; dimension tables always run exact.
FACT_TABLES = ("lineitem", "orders", "partsupp")

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
NATIONS = np.array([
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA", "FRANCE",
    "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA",
    "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
    "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"])
NATION_REGION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0,
                          0, 0, 1, 2, 3, 4, 2, 3, 3, 1])

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"])
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"])
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB",
                      "AIR REG"])  # Q19's second mode parameter
INSTRUCTS = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
ORDERSTATUS = np.array(["F", "O", "P"])
RETURNFLAGS = np.array(["A", "N", "R"])
LINESTATUS = np.array(["F", "O"])

_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
TYPES = np.array([f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2 for c in _TYPE_S3])

_CONT_S1 = ["SM", "LG", "MED", "JUMBO"]
_CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM", "BARREL", "BOTTLE"]
CONTAINERS = np.array([f"{a} {b}" for a in _CONT_S1 for b in _CONT_S2])

BRANDS = np.array([f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)])
MFGRS = np.array([f"Manufacturer#{i}" for i in range(1, 6)])

COLORS = np.array("""almond antique aquamarine azure beige bisque black blanched blue
blush brown burlywood burnished chartreuse chiffon chocolate coral cornflower cornsilk
cream cyan dark deep dim dodger drab firebrick floral forest frosted gainsboro ghost
goldenrod green grey honeydew hot indian ivory khaki lace lavender lawn lemon light
lime linen magenta maroon medium metallic midnight mint misty moccasin navajo navy
olive orange orchid pale papaya peach peru pink plum powder puff purple red rose rosy
royal saddle salmon sandy seashell sienna sky slate smoke snow spring steel tan thistle
tomato turquoise violet wheat white yellow""".split())

_CURRENT = "1995-06-17"
N_COMMENT_TEMPLATES = 512


def _comment_dict(rng: np.random.Generator, n: int, specials: list[str],
                  special_frac: float) -> np.ndarray:
    """Small template dictionary with a controlled special-pattern population."""
    words = np.array("""carefully final deposits sleep furiously quick requests
boost blithely ironic packages cajole express accounts haggle silent pinto beans
wake regular theodolites nag slyly bold foxes integrate daring sauternes""".split())
    base = [" ".join(rng.choice(words, size=8)) for _ in range(n)]
    n_special = max(1, int(n * special_frac))
    for i in range(n_special):
        mid = " ".join(rng.choice(words, size=2))
        base[i] = f"{base[i][:20]} {specials[0]}{mid}{specials[1]} {base[i][20:40]}"
    return np.array(base)


def generate(scale: float, seed: int = 7, skew: float = 0.0) -> Database:
    """Generate a TPC-H database at the given scale factor.

    ``skew > 0`` produces the JCC-H-style variant (``repro.data.jcch``,
    not ported yet): a fraction of FK references concentrates on a few hot
    keys, which skews both partition sizes and shuffle destinations.
    """
    rng = np.random.default_rng(seed)
    n_part = max(64, int(200_000 * scale))
    n_supp = max(16, int(10_000 * scale))
    n_cust = max(48, int(150_000 * scale))
    n_ord = max(96, int(1_500_000 * scale))

    def hot(n_keys, size, base_draw):
        """Mix uniform draws with a hot-key population (skew knob)."""
        if skew <= 0:
            return base_draw
        n_hot = max(1, n_keys // 200)
        hot_keys = rng.integers(0, n_keys, n_hot)
        take = rng.random(size) < skew
        out = base_draw.copy()
        out[take] = hot_keys[rng.integers(0, n_hot, int(take.sum()))]
        return out

    dicts: dict[str, np.ndarray] = {
        "r_name": REGIONS, "n_name": NATIONS, "c_mktsegment": SEGMENTS,
        "o_orderpriority": PRIORITIES, "l_shipmode": SHIPMODES,
        "l_shipinstruct": INSTRUCTS, "o_orderstatus": ORDERSTATUS,
        "l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUS,
        "p_type": TYPES, "p_container": CONTAINERS, "p_brand": BRANDS,
        "p_mfgr": MFGRS,
        "o_comment": _comment_dict(rng, N_COMMENT_TEMPLATES,
                                   ["special", "requests"], 32 / 512),
        "s_comment": _comment_dict(rng, N_COMMENT_TEMPLATES,
                                   ["Customer", "Complaints"], 16 / 512),
    }
    # p_name: 5 colors each; dictionary of distinct names
    n_names = min(2048, max(64, n_part // 4))
    pname_dict = np.array([" ".join(rng.choice(COLORS, size=5, replace=False))
                           for _ in range(n_names)])
    dicts["p_name"] = pname_dict

    region = {"r_regionkey": np.arange(5, dtype=np.int64),
              "r_name": np.arange(5, dtype=np.int32)}
    nation = {"n_nationkey": np.arange(25, dtype=np.int64),
              "n_name": np.arange(25, dtype=np.int32),
              "n_regionkey": NATION_REGION.astype(np.int64)}

    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": rng.integers(0, N_COMMENT_TEMPLATES, n_supp).astype(np.int32),
    }

    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int64),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": rng.integers(0, 5, n_cust).astype(np.int32),
    }
    customer["c_phone_cc"] = (customer["c_nationkey"] + 10).astype(np.int64)

    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": rng.integers(0, n_names, n_part).astype(np.int32),
        "p_brand": rng.integers(0, 25, n_part).astype(np.int32),
        "p_type": rng.integers(0, len(TYPES), n_part).astype(np.int32),
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": rng.integers(0, len(CONTAINERS), n_part).astype(np.int32),
    }
    part["p_mfgr"] = (part["p_brand"] // 5).astype(np.int32)
    p_retail = (90000 + (part["p_partkey"] % 20001) +
                100 * (part["p_partkey"] % 1000)) / 100.0

    # partsupp: spec formula — 4 suppliers per part, guaranteed to cover
    # every (l_partkey, l_suppkey) drawn below.
    pk = np.repeat(part["p_partkey"], 4)
    i4 = np.tile(np.arange(4, dtype=np.int64), n_part)
    sk = (pk + i4 * (n_supp // 4 + (pk - 1) // n_supp)) % n_supp + 1
    # the spec stride can wrap to duplicate (pk, sk) pairs at tiny scale
    # factors; partsupp's composite key must stay unique (it is a PK)
    _, keep = np.unique((pk << 32) | sk, return_index=True)
    keep.sort()
    pk, sk = pk[keep], sk[keep]
    n_ps = len(pk)
    partsupp = {
        "ps_partkey": pk,
        "ps_suppkey": sk.astype(np.int64),
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
    }

    # orders: skip custkeys ≡ 0 (mod 3) — one third of customers never order
    ck = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    ck = np.where(ck % 3 == 0, np.maximum(1, ck - 1), ck)
    ck = hot(n_cust, n_ord, ck)
    odate = rng.integers(days("1992-01-01"), days("1998-08-02") + 1,
                         n_ord).astype(np.int64)
    orders = {
        "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64),
        "o_custkey": ck,
        "o_orderdate": odate,
        "o_orderpriority": rng.integers(0, 5, n_ord).astype(np.int32),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": rng.integers(0, N_COMMENT_TEMPLATES, n_ord).astype(np.int32),
    }

    # lineitem: 1..7 per order
    per = rng.integers(1, 8, n_ord)
    n_li = int(per.sum())
    lok = np.repeat(orders["o_orderkey"], per)
    lod = np.repeat(odate, per)
    lpk = hot(n_part, n_li, rng.integers(1, n_part + 1, n_li).astype(np.int64))
    isup = rng.integers(0, 4, n_li).astype(np.int64)
    lsk = (lpk + isup * (n_supp // 4 + (lpk - 1) // n_supp)) % n_supp + 1
    qty = rng.integers(1, 51, n_li).astype(np.int64)
    eprice = np.round(qty * p_retail[lpk - 1], 2)
    ship = lod + rng.integers(1, 122, n_li)
    commit = lod + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    cur = days(_CURRENT)
    lstat = (ship > cur).astype(np.int32)           # 0=F shipped, 1=O open
    rflag = np.where(receipt <= cur,
                     rng.integers(0, 2, n_li) * 2,   # A(0) or R(2)
                     np.ones(n_li)).astype(np.int32)  # N(1)

    linenumber = (np.arange(n_li, dtype=np.int64) -
                  np.repeat(np.concatenate([[0], np.cumsum(per)[:-1]]), per) + 1)
    lineitem = {
        "l_orderkey": lok,
        "l_partkey": lpk,
        "l_suppkey": lsk.astype(np.int64),
        "l_linenumber": linenumber,
        "l_quantity": qty,
        "l_extendedprice": eprice,
        "l_discount": np.round(rng.uniform(0.0, 0.10, n_li), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2),
        "l_returnflag": rflag,
        "l_linestatus": lstat,
        "l_shipdate": ship.astype(np.int64),
        "l_commitdate": commit.astype(np.int64),
        "l_receiptdate": receipt.astype(np.int64),
        "l_shipinstruct": rng.integers(0, 4, n_li).astype(np.int32),
        "l_shipmode": rng.integers(0, len(SHIPMODES), n_li).astype(np.int32),
    }

    # o_totalprice = sum(extendedprice*(1+tax)*(1-discount)); o_orderstatus
    charge = eprice * (1 + lineitem["l_tax"]) * (1 - lineitem["l_discount"])
    tot = np.zeros(n_ord)
    np.add.at(tot, lok - 1, charge)
    orders["o_totalprice"] = np.round(tot, 2)
    n_open = np.zeros(n_ord, dtype=np.int64)
    np.add.at(n_open, lok - 1, lstat)
    n_all = np.zeros(n_ord, dtype=np.int64)
    np.add.at(n_all, lok - 1, 1)
    orders["o_orderstatus"] = np.where(
        n_open == 0, 0, np.where(n_open == n_all, 1, 2)).astype(np.int32)

    return Database(
        tables={"region": region, "nation": nation, "supplier": supplier,
                "customer": customer, "part": part, "partsupp": partsupp,
                "orders": orders, "lineitem": lineitem},
        dicts=dicts, scale=scale)
