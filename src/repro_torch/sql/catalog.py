"""Static TPC-H catalog for the SQL frontend: schemas, domains, cardinalities.

The binder resolves column names against this catalog (it mirrors the tables
:func:`repro.data.tpch.generate` builds — asserted in tests), and the
optimizer's placement / key-packing decisions read the *scale-invariant*
column domains and the nominal SF=1 cardinalities from it.  Two kinds of
knowledge live here:

  * **Scale-invariant domains** (``lo``/``hi`` with ``invariant=True``):
    dictionary code ranges, spec-bounded integers (``p_size`` 1..50), date
    ranges.  Safe inputs for static group-key packing and derived shrink
    caps — the values cannot outgrow them at any scale factor.  (Runtime
    range checks still verify every claim; a violated bound raises
    ``ctx.overflow`` and the fault runner re-executes — never silent wrong
    answers.)
  * **Scale-variant estimates** (key columns, SF=1 ``rows``): inputs to the
    broadcast-vs-shuffle cost rules only.  A wrong estimate can cost
    performance, never correctness — placement choices are all semantically
    valid.

The partition map mirrors the paper's §4.3 layout (``backend.PARTITION_KEYS``,
asserted equal in tests) without importing the jax-heavy backend module.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.table import days

__all__ = ["Column", "TableDef", "CATALOG", "PARTITION", "table_of",
           "column_table", "BCAST_MAX_ROWS", "ALPHA_CODED"]

# broadcast threshold (SF=1 estimated build rows): dimension slices up to a
# full supplier table / a one-region customer slice broadcast; whole
# customer/part/fact tables never do.  Matches the paper's §4.4 choices.
BCAST_MAX_ROWS = 65536

_DATE_LO = days("1992-01-01")
_ODATE_HI = days("1998-08-02")
_SHIP_HI = _ODATE_HI + 121            # l_shipdate = o_orderdate + [1, 121]
_RECEIPT_HI = _SHIP_HI + 30


@dataclasses.dataclass(frozen=True)
class Column:
    """One physical column: dtype kind + provable value domain.

    ``kind``      "int" | "float" | "dict" (dictionary-encoded string)
    ``lo``/``hi`` inclusive value bounds; ``None`` = unbounded
    ``invariant`` bounds hold at EVERY scale factor (safe for static packing)
    ``dict_name`` dictionary id: for ``kind == "dict"`` it equals the column
                  name; an ``"int"`` column may also carry it when its values
                  ARE codes of that dictionary (every ``*_nationkey`` decodes
                  through ``dicts["n_name"]`` — the generator's invariant), so
                  aliasing the key to the dictionary's name orders
                  alphabetically without a join against ``nation``
    """
    kind: str
    lo: int | None = None
    hi: int | None = None
    invariant: bool = False
    dict_name: str | None = None


def _dict(size: int, name: str) -> Column:
    return Column("dict", 0, size - 1, invariant=True, dict_name=name)


def _key(hi_sf1: int) -> Column:
    """Scale-variant key column: 1..hi at SF=1 (grows with the data)."""
    return Column("int", 1, hi_sf1, invariant=False)


def _int(lo: int, hi: int) -> Column:
    return Column("int", lo, hi, invariant=True)


def _coded(lo: int, hi: int, dict_name: str) -> Column:
    """Plain int column whose values are codes of a foreign dictionary."""
    return Column("int", lo, hi, invariant=True, dict_name=dict_name)


@dataclasses.dataclass(frozen=True)
class TableDef:
    columns: dict[str, Column]
    rows: int                       # nominal SF=1 cardinality
    unique: tuple[str, ...]         # single-column unique keys


CATALOG: dict[str, TableDef] = {
    "region": TableDef({
        "r_regionkey": _int(0, 4),
        "r_name": _dict(5, "r_name"),
    }, rows=5, unique=("r_regionkey",)),
    "nation": TableDef({
        "n_nationkey": _coded(0, 24, "n_name"),
        "n_name": _dict(25, "n_name"),
        "n_regionkey": _int(0, 4),
    }, rows=25, unique=("n_nationkey",)),
    "supplier": TableDef({
        "s_suppkey": _key(10_000),
        "s_nationkey": _coded(0, 24, "n_name"),
        "s_acctbal": Column("float"),
        "s_comment": _dict(512, "s_comment"),
    }, rows=10_000, unique=("s_suppkey",)),
    "customer": TableDef({
        "c_custkey": _key(150_000),
        "c_nationkey": _coded(0, 24, "n_name"),
        "c_acctbal": Column("float"),
        "c_mktsegment": _dict(5, "c_mktsegment"),
        "c_phone_cc": _int(10, 34),
    }, rows=150_000, unique=("c_custkey",)),
    "part": TableDef({
        "p_partkey": _key(200_000),
        "p_name": _dict(2048, "p_name"),
        "p_brand": _dict(25, "p_brand"),
        "p_type": _dict(150, "p_type"),
        "p_size": _int(1, 50),
        "p_container": _dict(40, "p_container"),
        "p_mfgr": _dict(5, "p_mfgr"),
    }, rows=200_000, unique=("p_partkey",)),
    "partsupp": TableDef({
        "ps_partkey": _key(200_000),
        "ps_suppkey": _key(10_000),
        "ps_availqty": _int(1, 9_999),
        "ps_supplycost": Column("float"),
    }, rows=800_000, unique=()),
    "orders": TableDef({
        "o_orderkey": _key(1_500_000),
        "o_custkey": _key(150_000),
        "o_orderdate": _int(_DATE_LO, _ODATE_HI),
        "o_orderpriority": _dict(5, "o_orderpriority"),
        "o_shippriority": _int(0, 0),
        "o_comment": _dict(512, "o_comment"),
        "o_totalprice": Column("float"),
        "o_orderstatus": _dict(3, "o_orderstatus"),
    }, rows=1_500_000, unique=("o_orderkey",)),
    "lineitem": TableDef({
        "l_orderkey": _key(1_500_000),
        "l_partkey": _key(200_000),
        "l_suppkey": _key(10_000),
        "l_linenumber": _int(1, 7),
        "l_quantity": _int(1, 50),
        "l_extendedprice": Column("float"),
        "l_discount": Column("float"),
        "l_tax": Column("float"),
        "l_returnflag": _dict(3, "l_returnflag"),
        "l_linestatus": _dict(2, "l_linestatus"),
        "l_shipdate": _int(_DATE_LO, _SHIP_HI),
        "l_commitdate": _int(_DATE_LO, _ODATE_HI + 90),
        "l_receiptdate": _int(_DATE_LO, _RECEIPT_HI),
        "l_shipinstruct": _dict(4, "l_shipinstruct"),
        "l_shipmode": _dict(8, "l_shipmode"),
    }, rows=6_000_000, unique=()),
}

# paper §4.3 partitioning (mirrors backend.PARTITION_KEYS; None = replicated)
PARTITION: dict[str, str | None] = {
    "lineitem": "l_orderkey",
    "orders": "o_orderkey",
    "partsupp": "ps_partkey",
    "part": "p_partkey",
    "supplier": "s_suppkey",
    "customer": "c_custkey",
    "nation": None,
    "region": None,
}

# dictionaries whose code order IS alphabetical order (tpch.py builds them
# from sorted value lists), so ORDER BY can sort raw codes with no alpha_rank
ALPHA_CODED = frozenset({
    "r_name", "o_orderpriority", "o_orderstatus", "l_returnflag",
    "l_linestatus", "p_brand", "p_mfgr",
})

# column name -> owning table (TPC-H prefixes make every name unique)
_COLUMN_TABLE: dict[str, str] = {}
for _t, _d in CATALOG.items():
    for _c in _d.columns:
        _COLUMN_TABLE[_c] = _t


def table_of(name: str) -> TableDef:
    return CATALOG[name]


def column_table(col: str) -> str | None:
    """Owning base table of a physical column name, if any."""
    return _COLUMN_TABLE.get(col)
