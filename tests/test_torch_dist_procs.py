"""The distributed engine across processes: four gloo processes on the CPU,
one rank each (``comm.world_group`` over a ``file://`` rendezvous), held to
``ThreadGroup(4)`` and to the reference's engine on 4 virtual JAX devices.

One spawn of four processes runs every case, in this order, and writes what
each process saw:

  (0) every collective the exchange uses (``all_to_all``, the list
      ``all_gather``, the rank-ordered ``all_reduce``, ``ppermute``) on every
      dtype the wire ships (uint32 values in int64, int32, float64, bool), on
      the world, on the 3 survivors of a loss (``surviving_group``) and on
      the 2 survivors of a second loss of the shrunk group;
  (a) all 22 queries at sf 0.002 seed 11 through ``run_distributed`` under
      sorted and hash joins, and Q9, Q10, Q13, Q18 on the wide wire;
  (b) the chaos cases of ``tests/torch_chaos_cases.py`` through
      ``QueryRunner`` in every process: the lost process ends in
      ``DeviceLost``, the survivors shrink and answer;
  (c) a second loss on the shrunk group, 4 -> 3 -> 2;
  (d) one rung each of Q1 and Q6 through ``ProgressiveRunner``;
  (f) the runner's decisions of the clock when one process alone is late:
      after its attempt (the straggler deadline: every process retries)
      and before it (the overall deadline: every process stops);
  (e) rank 2 raises alone: the others' collectives break within the group's
      timeout.

Beside them run three reference subprocesses (4 virtual JAX devices): the 22
queries under sorted joins, under hash joins, and the reference's runner on
the chaos cases.  The test process runs the same cases on ``ThreadGroup(4)``
meanwhile.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_chaos_cases as cases
from repro_torch.approx import ProgressiveRunner
from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.data import tpch
from repro_torch.queries import QUERIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
SF_QUERIES = 0.002
SEED = 11
JOINS = ("sorted", "hash")
WIRE_QUERIES = (9, 10, 13, 18)
RUNG_QUERIES = (1, 6)
# seconds a process waits at a collective (comm.world_group's timeout)
TIMEOUT_S = 45.0
RAISER = 2
CHAOS_CASES = cases.DIFF_CASES + [cases.SECOND_LOSS]
DTYPES = ("u32", "i32", "f64", "bool")
COLLECTIVES = ("all_to_all", "all_gather", "all_reduce", "ppermute")

_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
out, init, here, timeout_s, raiser = sys.argv[1:6]
sys.path.insert(0, here)
torch.set_num_threads(1)
import torch_chaos_cases as cases
from repro_torch.approx import ProgressiveRunner
from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.data import tpch
from repro_torch.distributed import chaos
from repro_torch.distributed.chaos import ChaosInjector, DeviceLost
from repro_torch.distributed.fault import (QueryRunner, QueryTimeout,
                                           RetryPolicy, surviving_group)
from repro_torch.queries import QUERIES
spec = json.loads(os.environ["DIST_PROCS_SPEC"])

g = comm.world_group("cpu", init_method=init, timeout_s=float(timeout_s))
me = g.rank
arrays, meta = {}, {"staged": sorted(g.staged)}

def keep(prefix, table):
    for k, v in table.items():
        arrays[prefix + "/" + k] = np.asarray(v)

def rows(rank, name):
    # this rank's input to a collective: (4, 3) rows, rank and dtype apart
    x = np.arange(12, dtype=np.int64).reshape(4, 3) * 7 + rank * 1000 + 3
    if name == "u32":
        return torch.from_numpy(x * 1299709 % (1 << 32) | (1 << 31))
    if name == "i32":
        return torch.from_numpy(x - 5000).to(torch.int32)
    if name == "f64":
        return torch.from_numpy(np.sin(x.astype(np.float64)) * 1e6 + 0.1)
    return torch.from_numpy(x % 3 == rank % 2)

def collectives(grp, tag):
    meta[tag] = {"rank": grp.rank, "size": grp.size,
                 "global_ranks": list(grp.global_ranks)}
    ring = [(i, (i + 1) % grp.size) for i in range(grp.size)]
    for name in spec["dtypes"]:
        x = rows(g.rank, name)[:grp.size]
        arrays[f"{tag}/in/{name}"] = x.numpy()
        arrays[f"{tag}/all_to_all/{name}"] = grp.all_to_all(x).numpy()
        arrays[f"{tag}/all_gather/{name}"] = grp.all_gather(x).numpy()
        arrays[f"{tag}/ppermute/{name}"] = grp.ppermute(x, ring).numpy()
        if name != "bool":
            for op in comm.REDUCE_OPS:
                arrays[f"{tag}/all_reduce/{op}/{name}"] = \
                    grp.all_reduce(x, op).numpy()

# (0) the collectives on the world and on two shrunk groups
collectives(g, "w4")
if me != 3:
    s3 = surviving_group(g, (3,))
    collectives(s3, "s3")
    if s3.rank != 0:
        collectives(surviving_group(s3, (0,)), "s2")

# (a) the 22 queries
db = tpch.generate(spec["sf"], seed=spec["seed"])
for jm in spec["joins"]:
    for q in sorted(QUERIES):
        got, stats, ov = B.run_distributed(QUERIES[q], db, g,
                                           join_method=jm)
        keep(f"a/{jm}/q{q}", got)
        meta[f"a/{jm}/q{q}"] = {"counts": stats.counts(),
                                "overflow": bool(ov)}
for q in spec["wire"]:
    got, _, _ = B.run_distributed(QUERIES[q], db, g, wire_format="wide")
    keep(f"a/wide/q{q}", got)

# (b), (c) the chaos cases through QueryRunner
db5 = tpch.generate(cases.SF, seed=cases.SEED)
for name, qid, kind, seed, factor in spec["chaos"]:
    runner = QueryRunner(db5, g, capacity_factor=factor,
                         chaos=ChaosInjector(cases.plan(chaos, kind, seed)),
                         policy=RetryPolicy(max_attempts=6, backoff_s=0.0))
    try:
        res = runner.run(QUERIES[qid])
        meta[name] = cases.record(runner, res)
        keep(f"b/{name}", res.result)
    except DeviceLost as e:
        # this process's card was the lost one; it takes part in the next
        # case as a new card would
        meta[name] = {"device_lost": str(e)}

# (d) one rung each through ProgressiveRunner
for q in spec["rungs"]:
    ans = ProgressiveRunner(db5, group=g, tolerance=1e9).run(QUERIES[q])
    keep(f"d/q{q}", ans.result)
    meta[f"d/q{q}"] = {"rung": ans.rung, "ci_width": ans.ci_width}

# (f) retry decisions of the clock when rank 1's process alone is late:
# after its attempt (the straggler deadline) or before it (the overall one)
class LateRank1(QueryRunner):
    late = None                       # "after" or "before" attempt 1

    def _attempt(self, *args):
        first, self.late = self.late, None
        if me == 1 and first == "before":
            time.sleep(1.5)
        res = super()._attempt(*args)
        if me == 1 and first == "after":
            time.sleep(1.5)
        return res

runner = LateRank1(db, g, policy=RetryPolicy(max_attempts=3, backoff_s=0.0,
                                             deadline_s=0.5))
runner.late = "after"
res = runner.run(QUERIES[6])
meta["f/straggler"] = {"outcomes": res.report.outcomes()}
keep("f/straggler", res.result)
runner = LateRank1(db, g, deadline_s=1.0, chaos=ChaosInjector(
    chaos.FaultPlan(1, (chaos.FaultSpec("transient", cut="scan"),))),
    policy=RetryPolicy(max_attempts=3, backoff_s=0.0))
runner.late = "before"
try:
    runner.run(QUERIES[6])
    meta["f/deadline"] = {"raised": None}
except QueryTimeout as e:
    meta["f/deadline"] = {"raised": "QueryTimeout",
                          "outcomes": e.report.outcomes()}

np.savez(os.path.join(out, f"rank{me}.npz"), **arrays)
with open(os.path.join(out, f"rank{me}.json"), "w") as f:
    json.dump(meta, f)

# (e) one rank raises alone
t0 = time.perf_counter()
try:
    if me == int(raiser):
        raise ValueError(f"rank {me} raises alone")
    B.run_distributed(QUERIES[3], db, g)
    ended = {"error": None}
except Exception as e:
    ended = {"error": type(e).__name__, "message": str(e)[:300]}
ended["seconds"] = time.perf_counter() - t0
with open(os.path.join(out, f"ended{me}.json"), "w") as f:
    json.dump(ended, f)
if me == int(raiser):
    # keep the process, and its connections, until the others have ended:
    # they must break on the group's timeout, not on a closed socket
    others = [os.path.join(out, f"ended{r}.json") for r in range(g.size)
              if r != me]
    deadline = time.perf_counter() + 2 * float(timeout_s) + 30
    while time.perf_counter() < deadline and \
            not all(os.path.exists(p) for p in others):
        time.sleep(0.2)
    sys.exit(3)
"""

_REF_QUERIES = r"""
import json, sys
import numpy as np
from repro.core import backend as RB
from repro.core.compat import make_mesh
from repro.data import tpch
from repro.queries import QUERIES
out, jm, sf, seed = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
db = tpch.generate(sf, seed=seed)
mesh = make_mesh((4,), ("data",))
arrays, counts = {}, {}
for q in sorted(QUERIES):
    got, stats, overflow = RB.run_distributed(QUERIES[q], db, mesh,
                                              join_method=jm)
    assert not np.asarray(overflow).any(), q
    counts[q] = stats.counts()
    for k, v in got.items():
        arrays[f"q{q}/{k}"] = np.asarray(v)
np.savez(out, **arrays)
with open(out + ".json", "w") as f:
    json.dump(counts, f)
"""


def _start_ref_queries(out, jm):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", _REF_QUERIES, str(out), jm, str(SF_QUERIES),
         str(SEED)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _start_workers(tmp):
    spec = {"dtypes": list(DTYPES), "sf": SF_QUERIES, "seed": SEED,
            "joins": list(JOINS), "wire": list(WIRE_QUERIES),
            "chaos": [list(c) for c in CHAOS_CASES],
            "rungs": list(RUNG_QUERIES)}
    init = f"file://{tmp / 'rendezvous'}"
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                   DIST_PROCS_SPEC=json.dumps(spec))
        env.pop("REPRO_CHAOS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp), init, HERE,
             str(TIMEOUT_S), str(RAISER)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _rows(rank, name):
    """The worker's ``rows``: rank ``rank``'s input to a collective."""
    x = np.arange(12, dtype=np.int64).reshape(4, 3) * 7 + rank * 1000 + 3
    if name == "u32":
        return x * 1299709 % (1 << 32) | (1 << 31)
    if name == "i32":
        return (x - 5000).astype(np.int32)
    if name == "f64":
        return np.sin(x.astype(np.float64)) * 1e6 + 0.1
    return x % 3 == rank % 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start everything at once, run the ThreadGroup side here meanwhile,
    then gather: (per-process arrays, per-process records, per-process
    ends, return codes, ThreadGroup results, reference results)."""
    tmp = tmp_path_factory.mktemp("procs")
    workers = _start_workers(tmp)
    refs = {jm: _start_ref_queries(tmp / f"ref_{jm}.npz", jm)
            for jm in JOINS}
    chaos_ref = cases.start_reference(tmp / "ref_chaos.npz", CHAOS_CASES)
    try:
        local = _thread_group_side()
        outs = [p.communicate(timeout=600) for p in workers]
        want = {}
        for jm, p in refs.items():
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            out = tmp / f"ref_{jm}.npz"
            with open(str(out) + ".json") as f:
                counts = json.load(f)
            want[jm] = dict(np.load(out)), counts
        want["chaos"] = cases.finish_reference(chaos_ref,
                                               tmp / "ref_chaos.npz")
    finally:
        for p in workers + list(refs.values()) + [chaos_ref]:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(workers, outs)):
        assert p.returncode == (3 if r == RAISER else 0), err[-3000:]
    arrays, meta, ended = [], [], []
    for r in range(WORLD):
        arrays.append(dict(np.load(tmp / f"rank{r}.npz")))
        with open(tmp / f"rank{r}.json") as f:
            meta.append(json.load(f))
        with open(tmp / f"ended{r}.json") as f:
            ended.append(json.load(f))
    return arrays, meta, ended, local, want


def _thread_group_side() -> dict:
    """(a) and (d) on ``ThreadGroup(4)`` on the CPU."""
    group = comm.ThreadGroup(WORLD, "cpu")
    db = tpch.generate(SF_QUERIES, seed=SEED)
    out = {}
    for jm in JOINS:
        for q in sorted(QUERIES):
            got, stats, ov = B.run_distributed(QUERIES[q], db, group,
                                               join_method=jm)
            out[jm, q] = got, stats.counts(), ov
    for q in WIRE_QUERIES:
        out["wide", q] = B.run_distributed(QUERIES[q], db, group,
                                           wire_format="wide")[0]
    db5 = tpch.generate(cases.SF, seed=cases.SEED)
    for q in RUNG_QUERIES:
        out["rung", q] = ProgressiveRunner(db5, group=group,
                                           tolerance=1e9).run(QUERIES[q])
    return out


def _table(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _same_bytes(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (label, k)
        assert got[k].tobytes() == v.tobytes(), (label, k)


# ---------------------------------------------------------------------------
# (0) the collectives
# ---------------------------------------------------------------------------

# (tag, world ranks of the group in rank order)
GROUPS = (("w4", (0, 1, 2, 3)), ("s3", (0, 1, 2)), ("s2", (1, 2)))


def test_shrunk_groups_renumber_the_survivors(run):
    _, meta, _, _, _ = run
    assert meta[0]["staged"] == []          # gloo on the CPU stages nothing
    for tag, members in GROUPS:
        for r in range(WORLD):
            if r in members:
                assert meta[r][tag] == {"rank": members.index(r),
                                        "size": len(members),
                                        "global_ranks": list(members)}
            else:
                assert tag not in meta[r]


@pytest.mark.parametrize("op", COLLECTIVES)
def test_collectives_across_processes(run, op):
    """Each collective on each group and dtype equals what a ThreadGroup
    computes from the same inputs: bit for bit, float sums included (the
    reductions combine in rank order)."""
    arrays = run[0]
    for tag, members in GROUPS:
        n = len(members)
        for name in DTYPES:
            xs = [_rows(g, name)[:n] for g in members]
            tg = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
            for i, g in enumerate(members):
                a = arrays[g]
                np.testing.assert_array_equal(a[f"{tag}/in/{name}"], xs[i])
                if op == "all_to_all":
                    want = np.stack([x[i] for x in xs])
                elif op == "all_gather":
                    want = np.stack(xs)
                elif op == "ppermute":
                    want = xs[(i - 1) % n]
                else:
                    if name == "bool":
                        continue
                    for red in comm.REDUCE_OPS:
                        want = comm._reduce(tg, red).numpy()
                        got = a[f"{tag}/all_reduce/{red}/{name}"]
                        assert got.dtype == want.dtype
                        assert got.tobytes() == want.tobytes(), \
                            (tag, red, name, g)
                    continue
                got = a[f"{tag}/{op}/{name}"]
                assert got.dtype == want.dtype, (tag, op, name)
                assert got.tobytes() == want.tobytes(), (tag, op, name, g)


# ---------------------------------------------------------------------------
# (a) the 22 queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jm", JOINS)
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_queries_equal_thread_group_and_reference(run, qid, jm):
    arrays, meta, _, local, want = run
    mine, counts, ov = local[jm, qid]
    assert not ov
    ref, ref_counts = want[jm]
    ref = _table(ref, f"q{qid}")
    assert counts == {k: int(v) for k, v in ref_counts[str(qid)].items()}
    for r in range(WORLD):
        label = f"rank {r} q{qid} join={jm}"
        rec = meta[r][f"a/{jm}/q{qid}"]
        assert rec == {"counts": counts, "overflow": False}, label
        got = _table(arrays[r], f"a/{jm}/q{qid}")
        _same_bytes(got, mine, label)
        cases.assert_close(got, ref, label)


@pytest.mark.parametrize("qid", WIRE_QUERIES)
def test_narrow_wire_equals_wide(run, qid):
    arrays, _, _, local, _ = run
    for r in range(WORLD):
        wide = _table(arrays[r], f"a/wide/q{qid}")
        _same_bytes(wide, _table(arrays[r], f"a/sorted/q{qid}"),
                    f"rank {r} q{qid}")
        _same_bytes(wide, local["wide", qid], f"rank {r} q{qid} wide")


# ---------------------------------------------------------------------------
# (b), (c) the chaos cases: the survivors against the reference's record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,qid,kind,seed,factor", CHAOS_CASES,
                         ids=[c[0] for c in CHAOS_CASES])
def test_runner_on_processes_equals_the_reference(run, name, qid, kind,
                                                  seed, factor):
    arrays, meta, _, _, want = run
    ref_meta, ref_arrays = want["chaos"]
    rec = ref_meta[name]
    # the reference's lost ranks, each in its generation's numbering, as
    # world ranks
    alive, dead = list(range(WORLD)), []
    for r in rec["lost"]:
        dead.append(alive.pop(r))
    assert len(alive) == rec["devices"]
    for r in range(WORLD):
        if r in dead:
            assert "device_lost" in meta[r][name], (name, r)
            continue
        assert meta[r][name] == rec, (name, r)
        cases.assert_same_result(_table(arrays[r], f"b/{name}"),
                                 ref_arrays, name)


# ---------------------------------------------------------------------------
# (d) the progressive runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qid", RUNG_QUERIES)
def test_progressive_rung_equals_thread_group(run, qid):
    arrays, meta, _, local, _ = run
    ans = local["rung", qid]
    assert ans.rung > 1                  # a sampled rung, not the exact plan
    for r in range(WORLD):
        assert meta[r][f"d/q{qid}"] == {"rung": ans.rung,
                                        "ci_width": ans.ci_width}
        _same_bytes(_table(arrays[r], f"d/q{qid}"), ans.result,
                    f"rank {r} q{qid}")


# ---------------------------------------------------------------------------
# (f) the clock's decisions
# ---------------------------------------------------------------------------

def test_a_late_process_makes_every_process_retry(run):
    """Rank 1's process alone is 1.5 s late after attempt 1, past the
    straggler deadline of 0.5 s: every process discards the attempt and
    answers on attempt 2 (one process retrying alone would wait in a
    collective the others never join)."""
    arrays, meta, _, local, _ = run
    for r in range(WORLD):
        assert meta[r]["f/straggler"] == {"outcomes": ["transient", "ok"]}
        _same_bytes(_table(arrays[r], "f/straggler"), local["sorted", 6][0],
                    f"rank {r} q6")


def test_a_late_process_makes_every_process_stop(run):
    """Rank 1's process alone starts attempt 1 1.5 s late, and attempt 1
    fails at once: past the overall deadline of 1 s on its clock only,
    every process raises QueryTimeout."""
    meta = run[1]
    for r in range(WORLD):
        assert meta[r]["f/deadline"] == {"raised": "QueryTimeout",
                                         "outcomes": ["transient"]}


# ---------------------------------------------------------------------------
# (e) a rank that raises alone
# ---------------------------------------------------------------------------

def test_a_rank_that_raises_alone_ends_the_group(run):
    """Rank 2 raises and keeps its process: every other process's
    collective breaks within the group's timeout (and the fixture's own
    limit keeps the test from hanging)."""
    ended = run[2]
    assert ended[RAISER]["error"] == "ValueError"
    for r in range(WORLD):
        if r == RAISER:
            continue
        assert ended[r]["error"] is not None, ended[r]
        assert ended[r]["seconds"] < TIMEOUT_S + 30, ended[r]
