"""The port's exchange operators (``repro_torch.core.exchange``) against the
reference package's, rank for rank.

One subprocess runs the reference's ``shuffle``, ``broadcast_table``,
``broadcast_table_p2p`` and ``partial_to_global`` under ``shard_map`` on 8
virtual devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` does) over two canned tables — one whose wire
rows take several words (checksum in a header word) and one whose rows fit
one word (checksum folded into the count) — and dumps every output to an npz.
The port runs the same cases on a ``ThreadGroup(8)`` on the CPU.  Received
columns (every row, padding included), validity, counts, overflow, corrupt
and every ``ExchangeStats`` field must be equal.

A two-process gloo run of ``TorchDistGroup`` must then give Q3, Q6 and Q10
byte-identical to ``ThreadGroup(2)``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core import exchange as ex
from repro_torch.core import relational as rel
from repro_torch.core.table import Table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
CAP = 48          # rows per shard


def _canned(seed: int, single_word: bool):
    """(stacked (N*CAP,) columns, per-shard counts (N,), true bounds)."""
    rng = np.random.default_rng(seed)
    n = N * CAP
    if single_word:
        cols = {"k64": rng.integers(0, 200, n).astype(np.int64),
                "flag": rng.integers(0, 2, n).astype(bool),
                "code": rng.integers(3, 40, n).astype(np.int32)}
    else:
        cols = {"k64": rng.integers(0, 200, n).astype(np.int64),
                "wide64": rng.integers(0, 1 << 40, n).astype(np.int64),
                "mid64": rng.integers(100_000, 1 << 25, n).astype(np.int64),
                "i32": rng.integers(-50, 900, n).astype(np.int32),
                "d16": rng.integers(8000, 10500, n).astype(np.int32),
                "f64": rng.normal(size=n),
                "f32": rng.normal(size=n).astype(np.float32),
                "b": rng.integers(0, 2, n).astype(bool),
                "c": np.full(n, -7, np.int64)}
    counts = rng.integers(CAP // 2, CAP + 1, N).astype(np.int32)
    for d in range(N):      # rows past a shard's count are zero padding
        for v in cols.values():
            v[d * CAP + counts[d]:(d + 1) * CAP] = 0
    bounds = {k: (int(v.min()), int(v.max())) for k, v in cols.items()
              if np.issubdtype(v.dtype, np.integer)}
    return cols, counts, bounds


# (name, table, op, kwargs): the same list drives both engines
CASES = [
    ("shuf_narrow", "A", "shuffle", dict(capd=16, packed=True, narrow=True)),
    ("shuf_wide", "A", "shuffle", dict(capd=16, packed=True, narrow=False)),
    ("shuf_cols", "A", "shuffle", dict(capd=16, packed=False)),
    ("shuf_over", "A", "shuffle", dict(capd=3, packed=True, narrow=True)),
    ("shuf_tamper", "A", "shuffle", dict(capd=16, packed=True, narrow=True,
                                         tamper=True)),
    ("shuf_lie", "A", "shuffle", dict(capd=16, packed=True, narrow=True,
                                      lie=True)),
    ("shuf_dest", "A", "shuffle", dict(capd=16, packed=True, narrow=True,
                                       dest=True)),
    ("shuf1_narrow", "B", "shuffle", dict(capd=16, packed=True, narrow=True)),
    ("shuf1_tamper", "B", "shuffle", dict(capd=16, packed=True, narrow=True,
                                          tamper=True)),
    ("bc_narrow", "A", "broadcast", dict(packed=True, narrow=True)),
    ("bc_wide", "A", "broadcast", dict(packed=True, narrow=False)),
    ("bc_cols", "A", "broadcast", dict(packed=False)),
    ("bc_tamper", "A", "broadcast", dict(packed=True, narrow=True,
                                         tamper=True)),
    ("bc1_narrow", "B", "broadcast", dict(packed=True, narrow=True)),
    ("p2p", "A", "p2p", {}),
    ("p2p1", "B", "p2p", {}),
]

_JAX_SCRIPT = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import exchange as ex
from repro.core.compat import make_mesh, shard_map
from repro.core.relational import filter_rows
from repro.core.table import Table

inp, outp, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
z = np.load(inp)
N = {N}
mesh = make_mesh((N,), ("d",))
stats = {{}}

def table(name, cols, count):
    t = Table({{k[2:]: v for k, v in cols.items() if k.startswith(name + "_")}},
              count[name].reshape(()))
    return filter_rows(t, t["k64"] < 150)

def tamper(p):
    return p.at[0, 0, 0].set(p[0, 0, 0] ^ 1)

def spmd(cols, count, part):
    out = {{}}
    for name, tab, op, kw in cases:
        t = table(tab, cols, count)
        bounds = json.loads(str(z["bounds_" + tab]))
        bounds = {{k: tuple(v) for k, v in bounds.items()}}
        if kw.get("lie"):
            bounds["k64"] = (0, 10)
        tam = tamper if kw.get("tamper") else None
        if op == "shuffle":
            dest = (t["k64"] % N).astype(jnp.int32) if kw.get("dest") else None
            o, ov, cr, rc, st = ex.shuffle(
                t, t["k64"], "d", N, kw["capd"], packed=kw["packed"],
                dest_ids=dest, wire=bounds, narrow=kw.get("narrow"),
                tamper=tam)
            out[name + "/recv_counts"] = rc
        elif op == "broadcast":
            o, ov, cr, st = ex.broadcast_table(
                t, "d", N, packed=kw["packed"], wire=bounds,
                narrow=kw.get("narrow"), tamper=tam)
        else:
            o, st = ex.broadcast_table_p2p(t, "d", N)
            ov = cr = jnp.asarray(False)
        stats[name] = list(__import__("dataclasses").astuple(st))
        for k in o.names:
            out[name + "/col/" + k] = o[k]
        out[name + "/valid"] = o.valid_mask()
        out[name + "/count"] = o.count.reshape(1)
        out[name + "/overflow"] = jnp.asarray(ov).reshape(1)
        out[name + "/corrupt"] = jnp.asarray(cr).reshape(1)
    g = ex.partial_to_global(
        {{k: v.reshape(()) for k, v in part.items()}},
        {{"s": "sum", "c": "count", "mn": "min", "mx": "max"}}, "d")
    for k, v in g.items():
        out["ptg/" + k] = v.reshape(1)
    return out

cols = {{k[4:]: jnp.asarray(z[k]) for k in z.files if k.startswith("col_")}}
count = {{k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("count_")}}
part = {{k[5:]: jnp.asarray(z[k]) for k in z.files if k.startswith("part_")}}
fn = jax.jit(shard_map(spmd, mesh=mesh, in_specs=P("d"), out_specs=P("d")))
res = fn(cols, count, part)
np.savez(outp, **{{k: np.asarray(v) for k, v in res.items()}})
with open(outp + ".json", "w") as f:
    json.dump(stats, f)
"""


def _port_cases(inputs: dict, bounds: dict) -> tuple[list[dict], dict]:
    """Run CASES on a ThreadGroup(N): per-rank outputs, and the stats."""
    stats = {}

    def body(g):
        r = g.rank
        out = {}
        for name, tab, op, kw in CASES:
            cols = {k: torch.from_numpy(v[r * CAP:(r + 1) * CAP].copy())
                    for k, v in inputs[tab][0].items()}
            t = Table(cols, torch.tensor(int(inputs[tab][1][r]),
                                         dtype=torch.int32))
            t = rel.filter_rows(t, t["k64"] < 150)
            bnd = dict(bounds[tab])
            if kw.get("lie"):
                bnd["k64"] = (0, 10)

            def tamper(p):
                p = p.clone()
                p[0, 0, 0] ^= 1
                return p

            tam = tamper if kw.get("tamper") else None
            if op == "shuffle":
                dest = (t["k64"] % N).to(torch.int32) if kw.get("dest") \
                    else None
                o, ov, cr, rc, st = ex.shuffle(
                    t, t["k64"], g, kw["capd"], packed=kw["packed"],
                    dest_ids=dest, wire=bnd, narrow=kw.get("narrow"),
                    tamper=tam)
                out[name + "/recv_counts"] = rc.numpy()
            elif op == "broadcast":
                o, ov, cr, st = ex.broadcast_table(
                    t, g, packed=kw["packed"], wire=bnd,
                    narrow=kw.get("narrow"), tamper=tam)
            else:
                o, st = ex.broadcast_table_p2p(t, g)
                ov = cr = torch.tensor(False)
            stats[name] = list(dataclasses.astuple(st))
            for k in o.names:
                out[name + "/col/" + k] = o[k].numpy()
            out[name + "/valid"] = o.valid_mask().numpy()
            out[name + "/count"] = o.count.reshape(1).numpy()
            out[name + "/overflow"] = ov.reshape(1).numpy()
            out[name + "/corrupt"] = cr.reshape(1).numpy()
        part = {k: torch.from_numpy(v[r:r + 1].copy()).reshape(())
                for k, v in inputs["part"].items()}
        got = ex.partial_to_global(
            part, {"s": "sum", "c": "count", "mn": "min", "mx": "max"}, g)
        for k, v in got.items():
            out["ptg/" + k] = v.reshape(1).numpy()
        return out

    return comm.ThreadGroup(N, "cpu").run(body), stats


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exchange")
    tabs = {"A": _canned(1, single_word=False), "B": _canned(2, True)}
    rng = np.random.default_rng(3)
    part = {"s": rng.normal(size=N) * 1e3, "c": rng.integers(0, 99, N),
            "mn": rng.normal(size=N), "mx": rng.integers(-50, 50, N)}
    arrays = {}
    for tab, (cols, counts, bounds) in tabs.items():
        for k, v in cols.items():
            arrays[f"col_{tab}_{k}"] = v
        arrays[f"count_{tab}"] = counts
        arrays[f"bounds_{tab}"] = np.array(json.dumps(bounds))
    for k, v in part.items():
        arrays[f"part_{k}"] = v
    inp, outp = tmp / "in.npz", tmp / "out.npz"
    np.savez(inp, **arrays)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT.format(N=N), str(inp), str(outp),
         json.dumps(CASES)], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(str(outp) + ".json") as f:
        stats = json.load(f)
    want = dict(np.load(outp))
    inputs = {tab: (cols, counts) for tab, (cols, counts, _) in tabs.items()}
    inputs["part"] = part
    got, got_stats = _port_cases(inputs, {t: v[2] for t, v in tabs.items()})
    return want, stats, got, got_stats


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_exchange_equals_reference(reference_run, case):
    want, stats, got, got_stats = reference_run
    assert got_stats[case] == stats[case]
    keys = sorted(k for k in want if k.startswith(case + "/"))
    assert keys == sorted(k for k in got[0] if k.startswith(case + "/"))
    for k in keys:
        mine = np.concatenate([g[k] for g in got])
        assert mine.dtype == want[k].dtype, k
        np.testing.assert_array_equal(mine, want[k], err_msg=k)


def test_flags_are_exercised(reference_run):
    """The canned cases really reach the overflow and corrupt paths."""
    want = reference_run[0]
    assert want["shuf_over/overflow"].any()
    assert want["shuf_lie/overflow"].any()
    for case in ("shuf_tamper", "shuf1_tamper", "bc_tamper"):
        assert want[case + "/corrupt"].any(), case
    for case in ("shuf_narrow", "bc_narrow", "shuf1_narrow"):
        assert not want[case + "/overflow"].any()
        assert not want[case + "/corrupt"].any()


def test_partial_to_global_equals_reference(reference_run):
    want, _, got, _ = reference_run
    for k in ("s", "c", "mn", "mx"):
        mine = np.concatenate([g["ptg/" + k] for g in got])
        np.testing.assert_array_equal(mine, want["ptg/" + k], err_msg=k)


# ---------------------------------------------------------------------------
# TorchDistGroup over gloo, two processes
# ---------------------------------------------------------------------------

_GLOO_SCRIPT = """
import sys
import numpy as np
import torch.distributed as dist
from repro_torch.core import backend as B
from repro_torch.core.comm import TorchDistGroup
from repro_torch.data import tpch
from repro_torch.queries import QUERIES

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
try:
    g = TorchDistGroup(device="cpu")
    db = tpch.generate(0.002, seed=11)
    res = {}
    for q in (3, 6, 10):
        got, stats, ov = B.run_distributed(QUERIES[q], db, g)
        assert not ov
        for k, v in got.items():
            res[f"q{q}/{k}"] = v
        res[f"q{q}/__counts"] = np.array(list(stats.counts().values()))
    np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""


def test_gloo_group_equals_thread_group(tmp_path):
    from repro_torch.data import tpch
    from repro_torch.queries import QUERIES
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SCRIPT, str(r), init,
         str(tmp_path / f"rank{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    db = tpch.generate(0.002, seed=11)
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        for q in (3, 6, 10):
            want, stats, ov = B.run_distributed(QUERIES[q], db, 2,
                                                device="cpu")
            assert not ov
            np.testing.assert_array_equal(
                got[f"q{q}/__counts"], list(stats.counts().values()))
            for k, v in want.items():
                assert got[f"q{q}/{k}"].dtype == v.dtype
                assert got[f"q{q}/{k}"].tobytes() == v.tobytes(), (r, q, k)
