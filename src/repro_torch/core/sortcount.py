"""Count the sorts a plan takes, and the port's per-query sort budgets.

The reference counts HLO ``sort`` ops of a compiled plan
(``repro.distributed.hlo_analysis.op_histogram``); the port runs eagerly, so
it counts the ``aten`` calls that sort (``sort``, ``argsort``, ``topk``,
``unique`` in its forms) with a ``TorchDispatchMode`` while a plan runs.
A multi-key sort is one HLO op (one multi-operand ``lax.sort``) but one
stable argsort per key here, so the two counts differ and the budgets below
are the port's own.
"""
from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["SORTING", "SortCounter", "LEGS", "MAX_SORTS", "SCALES",
           "SCALE_GROUP_BYS", "MAX_SORTS_AT", "budgets"]

SORTING = frozenset({"sort", "argsort", "topk", "unique", "_unique",
                     "_unique2", "unique_dim", "unique_consecutive",
                     "unique_dim_consecutive"})


class SortCounter(TorchDispatchMode):
    """Counts the sorting aten calls made while it is active (this thread)."""

    def __init__(self):
        super().__init__()
        self.calls: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in SORTING:
            self.calls.append(str(func))
        return func(*args, **(kwargs or {}))


# the legs of MAX_SORTS: (join method, planner inference on)
LEGS = (("sorted", True), ("sorted", False), ("hash", True), ("hash", False))

# Sorts of each local plan (``run_local``) on each leg, in LEGS order: the
# port's own counts at ``tpch.generate(0.005, seed=11)``.  Where they come
# from: a sorted join's build index is one stable argsort of the build keys
# (``relational.build_index``); a hash join's build is two
# (``kernels/hash_probe/ops.py::build_bucket_table64``: by key, then stably
# by bucket); a final ORDER BY is one stable argsort per key
# (``relational.sort_by``), where the reference's is one multi-operand sort;
# with the planner off every group-by takes the sort path, one argsort of
# its packed keys.  With it on, the group-bys are direct or hash (no sort).
#   q1  = the 2-key ORDER BY (l_returnflag, l_linestatus); the reference's
#         budget is 1, its ORDER BY being one sort.  Planner off: + the
#         group-by.
#   q3  = 2 build indexes (the semi join's on customer, the join's on
#         orders) + the 2-key ORDER BY (revenue desc, o_orderdate).  The
#         reference's budget is 4 too, but counts its ORDER BY once: by its
#         comment its 4th is a group-by sort that the port's planner already
#         removes at this SF (the group-by is sortless here).
#   q6  = 0: a scalar aggregate, no join, no ORDER BY.
#   q9  = 4 build indexes + the 2-key ORDER BY (nation, o_year desc); the
#         reference's 5 count the ORDER BY once.
#   q12 = 1 build index (orders) + the 1-key ORDER BY (l_shipmode), the
#         reference's 2.
#   q13 = 1 build index (the left join's on orders) + the 2-key ORDER BY
#         (custdist desc, c_count desc); the reference's 2 count the ORDER
#         BY once.  Its c_count group-by rides the hash dictionary and its
#         o_custkey group-by is direct; planner off sorts both.
# Hash joins add one sort a build; turning the planner off adds one a
# sort-path group-by.
MAX_SORTS = {
    1: (2, 3, 2, 3),
    2: (9, 10, 14, 15),
    3: (4, 5, 6, 7),
    4: (2, 3, 3, 4),
    5: (6, 7, 11, 12),
    6: (0, 0, 0, 0),
    7: (6, 7, 9, 10),
    8: (7, 8, 13, 14),
    9: (6, 7, 10, 11),
    10: (3, 4, 5, 6),
    11: (2, 3, 3, 4),
    12: (2, 3, 3, 4),
    13: (3, 5, 4, 6),
    14: (1, 1, 2, 2),
    15: (2, 3, 3, 4),
    16: (8, 8, 10, 10),
    17: (2, 3, 4, 5),
    18: (4, 5, 6, 7),
    19: (1, 1, 2, 2),
    20: (5, 6, 8, 9),
    21: (8, 11, 12, 15),
    22: (2, 4, 3, 5),
}


# The scales the port's tests, benches and chip_smoke.py run, (sf, seed):
# each has budgets of its own below.
SCALES = ((0.005, 11), (0.01, 7), (1.0, 11), (10.0, 11))

# Group-bys whose key domain grows with the scale, by query, in plan order:
# each is on one key column whose values are dense, 1..rows(sf) of the
# owning table (orders 1.5 M x sf, customer 150 k x sf, part 200 k x sf,
# supplier 10 k x sf).  The planner takes the direct path while
# ``bit_length(rows) <= DIRECT_AGG_BITS_MAX`` (13, i.e. rows <= 8191;
# ``planner.analyze``'s hint inference); past it the key's group bound,
# rows, is past ``HASH_AGG_GROUPS_MAX`` (4096) too, so the hash path is out
# and the group-by sorts once on each planner-on leg.  The planner-off legs
# sort every group-by at every scale, so their budgets never move.
#   orders (l_orderkey): 7500 rows, 13 bits at sf 0.005; 15000, 14 bits,
#       at sf 0.01: Q3 (revenue per order), Q18 (quantity per order), Q21
#       (lineitems and late lineitems per order, two group-bys).
#   customer (o_custkey): 1500 rows, 11 bits at sf 0.01; 150000, 18 bits at
#       SF 1: Q10 (revenue per customer), Q13 (orders per customer, ahead
#       of its c_count histogram, which rides the hash dictionary at every
#       scale), Q22 (orders per customer).
#   part (ps_partkey, l_partkey): 2000 rows, 11 bits at sf 0.01; 200000,
#       18 bits at SF 1: Q2 (min supply cost per part), Q11 (value per
#       part), Q17 (average quantity per part).
#   supplier (l_suppkey, ps_suppkey): 100 rows, 7 bits at sf 0.01; 10000,
#       14 bits at SF 1: Q15 (revenue per supplier), Q20 (parts per
#       supplier), Q21 (late lineitems per supplier).
SCALE_GROUP_BYS = {
    2: ("ps_partkey",), 3: ("l_orderkey",), 10: ("o_custkey",),
    11: ("ps_partkey",), 13: ("o_custkey",), 15: ("l_suppkey",),
    17: ("l_partkey",), 18: ("l_orderkey",), 20: ("ps_suppkey",),
    21: ("l_suppkey", "l_orderkey", "l_orderkey"), 22: ("o_custkey",),
}

# The budgets at each scale of SCALES, in LEGS order: sf 0.005's are
# MAX_SORTS; a larger scale adds one sort on each planner-on leg for each
# group-by of SCALE_GROUP_BYS on the sort path there.
_SF1 = {**MAX_SORTS,
        2: (10, 10, 15, 15), 3: (5, 5, 7, 7), 10: (4, 4, 6, 6),
        11: (3, 3, 4, 4), 13: (4, 5, 5, 6), 15: (3, 3, 4, 4),
        17: (3, 3, 5, 5), 18: (5, 5, 7, 7), 20: (6, 6, 9, 9),
        21: (11, 11, 15, 15), 22: (3, 4, 4, 5)}
MAX_SORTS_AT = {
    0.005: MAX_SORTS,
    0.01: {**MAX_SORTS, 3: (5, 5, 7, 7), 18: (5, 5, 7, 7),
           21: (10, 11, 14, 15)},
    1.0: _SF1,
    10.0: _SF1,
}


def budgets(sf: float) -> dict[int, tuple[int, ...]]:
    """The per-query budgets (LEGS order) at scale factor ``sf``, one of
    SCALES'."""
    try:
        return MAX_SORTS_AT[sf]
    except KeyError:
        raise ValueError(f"no sort budgets at sf {sf}; they are counted at "
                         f"sf {sorted(MAX_SORTS_AT)}") from None
