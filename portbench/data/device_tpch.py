"""TPC-H made with torch on a device from the seed.

The semantics of the program's generator (``repro_torch.data.tpch``), which
the tests hold it to: the same tables, columns, dtypes, row counts, domains
and derived columns (partsupp's spec formula, the one third of customers
that never order, the "current date" rule of the status flags,
``o_totalprice`` as the rounded sum of an order's charges).  The small
string dictionaries come from the same numpy stream as the program's, so
they are equal for one seed; the columns come from a ``torch.Generator`` on
``device``, in one call per column, so a set-up at SF 30 takes seconds where
the host's numpy takes more than a minute.

Every value is a function of the seed alone: no step sums floats in an
order that a device may choose.  The columns come back as host numpy arrays,
which the program and the reference are both given.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tpch

__all__ = ["generate"]


def _round2(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x, decimals=2)


def generate(scale: float, seed: int, device: str | torch.device = "cuda"):
    """``(tables, dicts)``: table name -> column name -> numpy column, and
    column name -> the string dictionary of its codes."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    i64 = torch.int64

    def ints(lo: int, hi: int, n: int) -> torch.Tensor:
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=i64)

    def uniform(lo: float, hi: float, n: int) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev,
                                           dtype=torch.float64)

    n_part = max(64, int(200_000 * scale))
    n_supp = max(16, int(10_000 * scale))
    n_cust = max(48, int(150_000 * scale))
    n_ord = max(96, int(1_500_000 * scale))

    # the dictionaries: the program's numpy draws, in its order
    dicts: dict[str, np.ndarray] = {
        "r_name": tpch.REGIONS, "n_name": tpch.NATIONS,
        "c_mktsegment": tpch.SEGMENTS, "o_orderpriority": tpch.PRIORITIES,
        "l_shipmode": tpch.SHIPMODES, "l_shipinstruct": tpch.INSTRUCTS,
        "o_orderstatus": tpch.ORDERSTATUS, "l_returnflag": tpch.RETURNFLAGS,
        "l_linestatus": tpch.LINESTATUS, "p_type": tpch.TYPES,
        "p_container": tpch.CONTAINERS, "p_brand": tpch.BRANDS,
        "p_mfgr": tpch.MFGRS,
        "o_comment": tpch._comment_dict(rng, tpch.N_COMMENT_TEMPLATES,
                                        ["special", "requests"], 32 / 512),
        "s_comment": tpch._comment_dict(rng, tpch.N_COMMENT_TEMPLATES,
                                        ["Customer", "Complaints"], 16 / 512),
    }
    n_names = min(2048, max(64, n_part // 4))
    dicts["p_name"] = np.array([" ".join(rng.choice(tpch.COLORS, size=5,
                                                    replace=False))
                                for _ in range(n_names)])

    region = {"r_regionkey": torch.arange(5, device=dev),
              "r_name": torch.arange(5, device=dev, dtype=torch.int32)}
    nation = {"n_nationkey": torch.arange(25, device=dev),
              "n_name": torch.arange(25, device=dev, dtype=torch.int32),
              "n_regionkey": torch.from_numpy(
                  tpch.NATION_REGION.astype(np.int64)).to(dev)}

    supplier = {
        "s_suppkey": torch.arange(1, n_supp + 1, device=dev),
        "s_nationkey": ints(0, 25, n_supp),
        "s_acctbal": _round2(uniform(-999.99, 9999.99, n_supp)),
        "s_comment": ints(0, tpch.N_COMMENT_TEMPLATES, n_supp).int(),
    }
    customer = {
        "c_custkey": torch.arange(1, n_cust + 1, device=dev),
        "c_nationkey": ints(0, 25, n_cust),
        "c_acctbal": _round2(uniform(-999.99, 9999.99, n_cust)),
        "c_mktsegment": ints(0, 5, n_cust).int(),
    }
    customer["c_phone_cc"] = customer["c_nationkey"] + 10

    pkey = torch.arange(1, n_part + 1, device=dev)
    part = {
        "p_partkey": pkey,
        "p_name": ints(0, n_names, n_part).int(),
        "p_brand": ints(0, 25, n_part).int(),
        "p_type": ints(0, len(tpch.TYPES), n_part).int(),
        "p_size": ints(1, 51, n_part),
        "p_container": ints(0, len(tpch.CONTAINERS), n_part).int(),
    }
    part["p_mfgr"] = torch.div(part["p_brand"], 5, rounding_mode="floor")
    p_retail = (90000 + (pkey % 20001) + 100 * (pkey % 1000)) \
        .to(torch.float64) / 100.0

    # partsupp: the spec formula, 4 suppliers a part; a (pk, sk) pair that
    # the stride repeats at a tiny scale is kept once, at its first place
    pk = pkey.repeat_interleave(4)
    i4 = torch.arange(4, device=dev).repeat(n_part)
    sk = (pk + i4 * (n_supp // 4 + torch.div(pk - 1, n_supp,
                                             rounding_mode="floor"))) \
        % n_supp + 1
    packed = (pk << 32) | sk
    order = torch.argsort(packed, stable=True)
    srt = packed[order]
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    keep = torch.sort(order[first]).values
    pk, sk = pk[keep], sk[keep]
    n_ps = pk.shape[0]
    partsupp = {
        "ps_partkey": pk,
        "ps_suppkey": sk,
        "ps_availqty": ints(1, 10000, n_ps),
        "ps_supplycost": _round2(uniform(1.0, 1000.0, n_ps)),
    }

    # orders: custkeys = 0 (mod 3) never order
    ck = ints(1, n_cust + 1, n_ord)
    ck = torch.where(ck % 3 == 0, torch.clamp(ck - 1, min=1), ck)
    okey = torch.arange(1, n_ord + 1, device=dev)
    odate = ints(tpch.days("1992-01-01"), tpch.days("1998-08-02") + 1, n_ord)
    orders = {
        "o_orderkey": okey,
        "o_custkey": ck,
        "o_orderdate": odate,
        "o_orderpriority": ints(0, 5, n_ord).int(),
        "o_shippriority": torch.zeros(n_ord, dtype=i64, device=dev),
        "o_comment": ints(0, tpch.N_COMMENT_TEMPLATES, n_ord).int(),
    }

    # lineitem: 1..7 lines an order, an order's lines contiguous
    per = ints(1, 8, n_ord)
    n_li = int(per.sum())
    starts = torch.cumsum(per, 0) - per
    lok = okey.repeat_interleave(per, output_size=n_li)
    lod = odate.repeat_interleave(per, output_size=n_li)
    lpk = ints(1, n_part + 1, n_li)
    isup = ints(0, 4, n_li)
    lsk = (lpk + isup * (n_supp // 4 + torch.div(lpk - 1, n_supp,
                                                 rounding_mode="floor"))) \
        % n_supp + 1
    qty = ints(1, 51, n_li)
    eprice = _round2(qty * p_retail[lpk - 1])
    ship = lod + ints(1, 122, n_li)
    commit = lod + ints(30, 91, n_li)
    receipt = ship + ints(1, 31, n_li)
    cur = tpch.days(tpch._CURRENT)
    lstat = (ship > cur).int()                       # 0=F shipped, 1=O open
    rflag = torch.where(receipt <= cur, ints(0, 2, n_li) * 2,   # A(0), R(2)
                        torch.ones_like(receipt)).int()         # N(1)
    linenumber = torch.arange(n_li, device=dev) - \
        starts.repeat_interleave(per, output_size=n_li) + 1
    lineitem = {
        "l_orderkey": lok,
        "l_partkey": lpk,
        "l_suppkey": lsk,
        "l_linenumber": linenumber,
        "l_quantity": qty,
        "l_extendedprice": eprice,
        "l_discount": _round2(uniform(0.0, 0.10, n_li)),
        "l_tax": _round2(uniform(0.0, 0.08, n_li)),
        "l_returnflag": rflag,
        "l_linestatus": lstat,
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": ints(0, 4, n_li).int(),
        "l_shipmode": ints(0, len(tpch.SHIPMODES), n_li).int(),
    }

    # o_totalprice: an order's charges added in line order, one line slot
    # at a time (as the program's np.add.at adds them), so no device chooses
    # the order of the additions
    charge = eprice * (1 + lineitem["l_tax"]) * (1 - lineitem["l_discount"])
    tot = torch.zeros(n_ord, dtype=torch.float64, device=dev)
    n_open = torch.zeros(n_ord, dtype=i64, device=dev)
    for j in range(7):
        has = per > j
        at = torch.where(has, starts + j, 0)
        tot = tot + torch.where(has, charge[at], 0.0)
        n_open = n_open + torch.where(has, lstat[at].long(), 0)
    orders["o_totalprice"] = _round2(tot)
    orders["o_orderstatus"] = torch.where(
        n_open == 0, 0, torch.where(n_open == per, 1, 2)).int()

    tables = {"region": region, "nation": nation, "supplier": supplier,
              "customer": customer, "part": part, "partsupp": partsupp,
              "orders": orders, "lineitem": lineitem}
    host = {name: {c: v.cpu().numpy() for c, v in cols.items()}
            for name, cols in tables.items()}
    return host, dicts
