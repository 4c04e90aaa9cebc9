"""The SF 1000 analytics dry-run (``repro_torch.launch.dryrun_analytics``)
against the reference's, and ``planner.static_exchange_stats`` against the
port's own runtime exchange log.

The reference's ``dryrun_query`` lowers each plan over stand-in arrays with
SF 1000 row counts; its exchange log is fixed once the program is traced.
A subprocess on N virtual XLA devices traces the reference's
``DistContext`` for each query under ``jax.eval_shape`` (no compile), with
its own ``build_specs``, ``_sf1000_stats`` and ``QUERIES`` as they are, and
dumps each query's counts and ``ExchangeStats`` log, its wire savings and
the log priced by its ``perfmodel`` on ``tpu_v5e`` as the reference prices
it.  The port derives the same from the IR alone and must match: the
counts, every exchange's kind and bytes in order and the wire savings
exactly, the price at rtol 1e-9.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core import planner as PL
from repro_torch.data import tpch
from repro_torch.distributed import roofline
from repro_torch.launch import dryrun_analytics as D
from repro_torch.queries import QUERIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_FIELDS = ("kind", "participants", "message_bytes", "total_bytes",
              "collectives", "logical_bytes", "row_wire_bytes",
              "row_logical_bytes", "wire")

_JAX_SCRIPT = """
import json, sys
import jax
from jax.sharding import PartitionSpec as P
from repro.core import backend as B, compat, perfmodel as pm
from repro.core.table import Table
from repro.data import tpch
from repro.launch.dryrun_analytics import build_specs, _sf1000_stats
from repro.queries import QUERIES

n, qids, fields = int(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3:]
db = tpch.generate(0.001, seed=7)
db.scale = 1000.0
mesh = compat.make_mesh((n,), ("data",))
specs, caps = build_specs(db, n)
out = {}
for qid in qids:
    held = {}

    def spmd(tree):
        tables = {}
        for name, cols in tree.items():
            cols = dict(cols)
            count = cols.pop("__count").reshape(())
            tables[name] = Table(cols, count)
        ctx = B.DistContext(db, tables, "data", n, 1.02, True)
        QUERIES[qid](ctx)
        held["stats"] = ctx.stats
        return ctx.overflow.reshape(1)

    with mesh, _sf1000_stats(db):
        jax.eval_shape(compat.shard_map(spmd, mesh=mesh, in_specs=P("data"),
                                        out_specs=P("data")), specs)
    st = held["stats"]
    spec = pm.CLUSTERS["tpu_v5e"]
    out[qid] = {
        "counts": st.counts(),
        "log": [{k: getattr(e, k) for k in fields} for e in st.log],
        "wire_savings": [round(pm.wire_savings(e), 3) for e in st.log],
        "tpu_v5e_s": sum(pm.exchange_time_from_stats(e, spec, n_devices=n)
                         for e in st.log)}
print(json.dumps({"caps": caps, "queries": out}))
"""


def _reference_trace(n: int, qids) -> dict:
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(n), json.dumps(list(qids)),
         *LOG_FIELDS], env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    got["queries"] = {int(q): v for q, v in got["queries"].items()}
    return got


@pytest.fixture(scope="module")
def ref8():
    return _reference_trace(8, sorted(QUERIES))


@pytest.fixture(scope="module")
def ref256():
    return _reference_trace(256, (9, 18))


@pytest.fixture(scope="module")
def meta():
    return D.metadata_db()


def _exchanges(rec: dict) -> list[tuple]:
    return [(e["kind"], e["message_bytes"], e["total_bytes"],
             e["collectives"], e["row_wire_bytes"], e["row_logical_bytes"],
             e["wire"]) for e in rec["exchanges"]]


def _ref_exchanges(log: list[dict]) -> list[tuple]:
    return [(e["kind"], e["message_bytes"], e["total_bytes"],
             e["collectives"], e["row_wire_bytes"], e["row_logical_bytes"],
             e["wire"]) for e in log]


def _assert_equal_reference(rec: dict, want: dict) -> None:
    assert rec["plan"] == want["counts"]
    assert _exchanges(rec) == _ref_exchanges(want["log"])
    assert rec["wire_savings"] == want["wire_savings"]
    np.testing.assert_allclose(rec["model_exchange_s"], want["tpu_v5e_s"],
                               rtol=1e-9)


def test_capacities_equal_build_specs(ref8, ref256, meta):
    assert D.table_caps(meta, 8) == ref8["caps"]
    assert D.table_caps(meta, 256) == ref256["caps"]


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_dryrun_equals_the_reference_trace(ref8, meta, qid):
    _assert_equal_reference(D.dryrun_query(qid, meta, 8),
                            ref8["queries"][qid])


@pytest.mark.parametrize("qid", [9, 18])
def test_dryrun_at_256_devices_equals_the_reference(ref256, meta, qid):
    _assert_equal_reference(D.dryrun_query(qid, meta, 256),
                            ref256["queries"][qid])


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_counts_equal_paper_table4_where_the_reference_does(ref8, meta,
                                                            qid):
    from repro.queries import PAPER_TABLE4
    want_s, want_b = PAPER_TABLE4[qid]
    ref = ref8["queries"][qid]["counts"]
    got = D.dryrun_query(qid, meta, 8)["plan"]
    if ref["shuffles"] == want_s:
        assert got["shuffles"] == want_s
    if want_b is not None and ref["broadcasts"] == want_b:
        assert got["broadcasts"] == want_b


def test_q6_memory_term_by_hand(meta):
    """Q6 reads four lineitem columns; each partition holds
    ceil(6e9 / n * 1.02 / 8) * 8 rows; the H100's HBM moves 3.35e12 B/s."""
    n = 256
    rows = math.ceil(6e9 / n * 1.02 / 8) * 8
    li = meta.tables["lineitem"]
    cols = ("l_discount", "l_extendedprice", "l_quantity", "l_shipdate")
    rec = D.dryrun_query(6, meta, n)
    assert rec["lineitem_rows_per_dev"] == rows
    assert rec["scan_bytes_per_dev"] == rows * sum(li[c].dtype.itemsize
                                                   for c in cols)
    rf = rec["roofline"]["h100_ib"]
    assert rf["memory_s"] == rec["scan_bytes_per_dev"] / 3.35e12
    # Q6 moves nothing but one all-reduce of scalars: memory bounds it
    assert rec["exchanges"] == [] and rf["collective_s"] == 0.0
    assert rf["bottleneck"] == "memory" and rf["compute_s"] is None


def test_record_names_what_it_cannot_measure(meta):
    rec = D.dryrun_query(9, meta, 256)
    for key in ("hlo_flops", "hlo_bytes", "collective_bytes"):
        assert rec[key] is None and key in rec["not_reported"]
    assert "compute_s" in rec["not_reported"]
    for name, rf in rec["roofline"].items():
        assert rf["compute_s"] is None
        assert rf["collective_s"] == rec["model_exchange_s_by_cluster"][name]
    assert rec["machines"] == {"tpu_v5e": 1, "h100_ib": 32, "h100_eth": 32}


class _AnyOp(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_dryrun_runs_no_tensor_operation(meta):
    with _AnyOp() as seen:
        D.dryrun_query(9, meta, 256)
        D.dryrun_query(13, meta, 512)
    assert seen.ops == []


def test_dryrun_leaves_the_database_statistics_as_they_were(meta):
    before = dict(PL.column_stats(meta))
    cached = meta.__dict__["_plan_colstats"]
    D.dryrun_query(13, meta, 256)
    assert meta.__dict__.get("_plan_colstats") is cached
    assert "_planinfo_cache" not in meta.__dict__
    assert PL.column_stats(meta) == before
    # a database that had none cached keeps its own scale's at most
    fresh = tpch.generate(0.001, seed=7)
    D.dryrun_query(3, fresh, 8)
    assert fresh.__dict__.get("_plan_colstats", before) == before
    assert "_planinfo_cache" not in fresh.__dict__


def test_cli_writes_every_query_at_both_widths(tmp_path):
    for extra, sfx in (([], "_256"), (["--multi-pod"], "_2x256")):
        recs = D.main(["--queries", "all", "--out", str(tmp_path), *extra])
        assert [r["query"] for r in recs] == sorted(QUERIES)
        for qid in sorted(QUERIES):
            rec = json.loads((tmp_path / f"q{qid}{sfx}.json").read_text())
            assert "error" not in rec
            assert rec["n_devices"] == (512 if extra else 256)


@pytest.mark.parametrize("args", [
    (1e15, 2e9, 3e8, 256, 0.0), (5e12, 8e10, 0.0, 8, 4e16),
    (0.0, 1e6, 5e9, 512, 0.0)])
def test_roofline_terms_equal_the_reference(args):
    from repro.distributed import hlo_analysis as ha
    flops, nbytes, coll, n, model = args
    want = ha.roofline_terms(flops, nbytes, coll, n, model_flops=model)
    got = roofline.roofline_terms(
        flops, nbytes, coll, n, model_flops=model,
        peak_flops=ha.V5E_PEAK_FLOPS, hbm_bw=ha.V5E_HBM_BW,
        ici_bw=ha.V5E_ICI_BW)
    assert got == want


# -- the walk against the port's own runtime log ------------------------------

@pytest.fixture(scope="module")
def small():
    db = tpch.generate(0.005, seed=11)
    return db, B.partition_database(db, 4)[1]


def _log(stats) -> list[dict]:
    return [dataclasses.asdict(e) for e in stats.log]


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_static_exchange_stats_equal_the_runtime_log(small, qid):
    db, caps = small
    _, got, ov = B.run_distributed(QUERIES[qid], db,
                                   comm.ThreadGroup(4, "cpu"),
                                   wire_format="narrow")
    assert not ov
    want = PL.static_exchange_stats(QUERIES[qid].plan, db, caps, 4)
    assert _log(want) == _log(got)
    assert want.counts() == got.counts()
    assert want.overflow_checks == got.overflow_checks


@pytest.mark.parametrize("qid", [9, 13, 16, 18])
@pytest.mark.parametrize("packed,wire", [(True, "wide"), (False, "narrow")])
def test_static_exchange_stats_other_formats(small, qid, packed, wire):
    db, caps = small
    _, got, _ = B.run_distributed(QUERIES[qid], db,
                                  comm.ThreadGroup(4, "cpu"),
                                  packed_exchange=packed, wire_format=wire,
                                  capacity_factor=3.0)
    want = PL.static_exchange_stats(QUERIES[qid].plan, db, caps, 4,
                                    capacity_factor=3.0, packed=packed,
                                    narrow=wire == "narrow")
    assert _log(want) == _log(got)
