"""The port's SQL frontend (``repro_torch.sql``) against the reference's:
its own copies of the 22 TPC-H texts, the parser's contract and printer
round trip, and every SQL-compiled plan against the hand-built one — the
reference's plan signature and paper Table 4 counts, and byte-identical
results under ``run_local(device="cpu")``.  The cases of the reference's
tests/test_sql_frontend.py, plus the cross-package checks."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core import planner as RPL
from repro.sql import frontend as rfrontend
from repro.sql.parser import parse as rparse
from repro_torch.core import backend as B
from repro_torch.core import planner as PL
from repro_torch.data import tpch
from repro_torch.queries import PAPER_TABLE4, QUERIES
from repro_torch.sql import SqlError, compile_sql, sql_queries
from repro_torch.sql import ast as A
from repro_torch.sql.ast import format_expr, format_query
from repro_torch.sql.frontend import SQL_DIR, plan_sql, sql_text
from repro_torch.sql.parser import parse, parse_expr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QIDS = list(range(1, 23))

# the hand-built plans' wire budgets (the reference's
# benchmarks/bench_exchange_bytes.py): the SQL plans must not exceed them
MAX_WIRE_BYTES = {1: 92, 2: 28, 3: 16, 4: 12, 5: 20, 6: 0, 7: 20, 8: 32,
                  9: 44, 10: 32, 11: 16, 12: 20, 13: 28, 14: 20, 15: 24,
                  16: 24, 17: 16, 18: 48, 19: 4, 20: 16, 21: 16, 22: 32}


@pytest.fixture(scope="module")
def db():
    return tpch.generate(0.005, seed=11)


@pytest.fixture(scope="module")
def sqlq():
    return sql_queries()


# ---------------------------------------------------------------------------
# the port's own texts
# ---------------------------------------------------------------------------

def test_the_port_reads_its_own_texts():
    assert SQL_DIR == pathlib.Path(ROOT, "src", "repro_torch", "queries",
                                   "sql")
    assert sorted(p.name for p in SQL_DIR.glob("q*.sql")) == \
        sorted(f"q{q}.sql" for q in QIDS)


@pytest.mark.parametrize("qid", QIDS)
def test_texts_equal_the_reference_byte_for_byte(qid):
    mine = (SQL_DIR / f"q{qid}.sql").read_bytes()
    theirs = (rfrontend.SQL_DIR / f"q{qid}.sql").read_bytes()
    assert mine == theirs
    assert sql_text(qid) == rfrontend.sql_text(qid)


# ---------------------------------------------------------------------------
# negative paths
# ---------------------------------------------------------------------------

_BAD = [
    ("select x from nosuchtable", "unknown table", True),
    ("select nosuch from lineitem", "unknown column", True),
    ("select l_orderkey from lineitem, orders", "comma joins", False),
    ("select l_orderkey from lineitem where l_quantity = 'FOO'",
     "non-dictionary", True),
    ("select l_orderkey from lineitem where l_comment is null",
     "IS [NOT] NULL", True),
    ("select cast(l_quantity as int) from lineitem", "CAST", True),
    ("select /*+ bogus(3) */ l_orderkey from lineitem", "unknown hint", True),
    ("select l_orderkey from lineitem where l_quantity < :p",
     "undeclared parameter", False),
    ("select case when l_quantity > 1 then 1.0 end as x from lineitem",
     "ELSE", False),
    ("select case when l_quantity > 1 then 1.0 else 0.0 end from lineitem",
     "needs AS", False),
    ("with a as (select l_orderkey as k, l_tax from lineitem) "
     "select l_tax from lineitem join a on l_orderkey = k",
     "ambiguous column", True),
    ("select l_orderkey from lineitem order by nosuch",
     "not in the select list", True),
    ("select l_orderkey from lineitem where", "unexpected", True),
    ("select sum(l_quantity) from lineitem group by", "unexpected", True),
]


@pytest.mark.parametrize("text,needle,has_pos", _BAD,
                         ids=[n for _, n, _ in _BAD])
def test_negative_paths_raise_sql_error(text, needle, has_pos):
    with pytest.raises(SqlError) as exc:
        plan_sql(text)
    assert needle in str(exc.value), str(exc.value)
    if has_pos:
        assert exc.value.line is not None and exc.value.col is not None
        assert exc.value.line >= 1 and exc.value.col >= 1
        assert f"line {exc.value.line}" in str(exc.value)


def test_error_position_points_at_offender():
    with pytest.raises(SqlError) as exc:
        plan_sql("select l_orderkey,\n       oops\nfrom lineitem")
    assert (exc.value.line, exc.value.col) == (2, 8)


# ---------------------------------------------------------------------------
# printer round trip
# ---------------------------------------------------------------------------

def _roundtrip(e: A.Expr):
    text = format_expr(e)
    back = parse_expr(text)
    assert back == e, f"{e!r} -> {text!r} -> {back!r}"


def test_roundtrip_fixed_shapes():
    sub = A.Select(items=(A.SelectItem(A.Ident("k")),),
                   frm=(A.FromItem(A.Table("t")),))
    for e in [
        A.Binary("-", A.Number(1), A.Binary("-", A.Number(2), A.Number(3))),
        A.Binary("/", A.Binary("/", A.Ident("a"), A.Ident("b")),
                 A.Ident("c")),
        A.Unary("not", A.Binary("and", A.LikeE(A.Ident("s"), "%x%"),
                                A.Between(A.Ident("a"), A.Number(1),
                                          A.Number(2)))),
        A.Func("count", (A.Star(),)),
        A.Func("count", (A.Ident("a"),), distinct=True),
        A.InQuery(A.Ident("a"), sub),
        A.ExistsE(sub, negated=True),
        A.Binary("+", A.Scalar(sub), A.Number(1)),
        A.CaseE(((A.Binary(">", A.Ident("a"), A.Number(0)),
                  A.Number(1)),), A.Number(0)),
    ]:
        _roundtrip(e)


def test_roundtrip_interval_and_date_arith():
    _roundtrip(A.Binary("+", A.DateL("1994-01-01"), A.IntervalL(90, "day")))
    _roundtrip(A.Binary("<", A.Func("year", (A.Ident("d"),)),
                        A.Number(1997)))


@pytest.mark.parametrize("qid", QIDS)
def test_query_print_parse_fixpoint(qid):
    """format_query emits SQL the parser maps back to the same AST, and
    the printed text is the reference's printed text."""
    ast1 = parse(sql_text(qid))
    text = format_query(ast1)
    assert parse(text) == ast1, qid
    assert format_query(parse(text)) == text
    from repro.sql.ast import format_query as rformat
    assert text == rformat(rparse(rfrontend.sql_text(qid)))


# ---------------------------------------------------------------------------
# all 22 against the hand-built plans and the reference's compilation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qid", QIDS)
def test_sql_plan_signature_and_budgets(db, sqlq, qid):
    """The SQL-compiled plan is the reference's SQL-compiled plan (same
    canonical signature), validates clean, hits paper Table 4 and stays
    within the wire budgets."""
    q = sqlq[qid]
    assert q.signature() == RPL.plan_signature(rfrontend.plan_sql(
        rfrontend.sql_text(qid)))
    assert not PL.validate(q.plan, db)
    counts = q.static_counts()
    want_s, want_b = PAPER_TABLE4[qid]
    if qid == 11:          # local group-by under this partitioning
        want_s, want_b = 0, 1
    assert counts["shuffles"] == want_s, counts
    if want_b is not None:
        assert counts["broadcasts"] == want_b, counts
    per_row = sum(e["row_wire_bytes"] for e in q.static_wire(db))
    assert per_row <= MAX_WIRE_BYTES[qid], (per_row, MAX_WIRE_BYTES[qid])


@pytest.mark.parametrize("qid", QIDS)
def test_sql_plan_matches_hand_local(db, sqlq, qid):
    r_sql, stats = B.run_local(sqlq[qid], db, device="cpu")
    assert sqlq[qid].static_counts() == stats.counts(), qid
    r_hand, _ = B.run_local(QUERIES[qid], db, device="cpu")
    keys = set(r_sql) & set(r_hand)
    assert keys
    for k in sorted(keys):
        a, b = np.asarray(r_sql[k]), np.asarray(r_hand[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (qid, k)
        np.testing.assert_array_equal(a, b, err_msg=f"q{qid} {k}")


def test_ad_hoc_sql_compiles_and_runs(db):
    q = compile_sql("""
        select n_name, count(*) as suppliers, sum(s_acctbal) as total_bal
        from supplier
        join nation on s_nationkey = n_nationkey
        group by n_name
        order by total_bal desc
        limit 5
    """, name="adhoc")
    assert PL.validate(q.plan, db) == []
    r, _ = B.run_local(q, db, device="cpu")
    assert set(r) == {"n_name", "suppliers", "total_bal"}
    assert len(r["n_name"]) == 5
    bal = np.asarray(r["total_bal"], np.float64)
    assert np.all(bal[:-1] >= bal[1:])


def test_frontend_env_serves_the_sql_plans():
    """``REPRO_FRONTEND=sql`` makes QUERIES the SQL-compiled plans, and
    they run."""
    code = """
from repro_torch.core import backend as B
from repro_torch.data import tpch
from repro_torch.queries import QUERIES
from repro_torch.sql import sql_queries
sql = sql_queries()
assert sorted(QUERIES) == list(range(1, 23))
assert all(QUERIES[q].signature() == sql[q].signature() for q in QUERIES)
db = tpch.generate(0.002, seed=11)
out, _ = B.run_local(QUERIES[6], db, device="cpu")
want, _ = B.run_reference(QUERIES[6], db)
assert abs(out["revenue"][0] - want["revenue"][0]) <= \\
    1e-7 * abs(want["revenue"][0])
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "REPRO_FRONTEND": "sql"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
