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

__all__ = ["SORTING", "SortCounter", "LEGS", "MAX_SORTS"]

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
