"""Chaos plans that the reference's runner and the port's run alike.

``tests/test_torch_chaos.py`` runs them on a ``ThreadGroup(4)`` and
``tests/test_torch_dist_procs.py`` on four gloo processes; both hold the
port's record to the reference's ``QueryRunner`` over a 4-device mesh,
which :func:`start_reference` runs in a subprocess with 4 virtual JAX
devices.  Nothing here imports JAX or the port at module level: the
reference's script and the port's worker processes import this module too.
"""
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
SF = 0.005
SEED = 11

# (name, query, plan kind, plan seed, start capacity factor)
DIFF_CASES = [("default_q9", 9, "default", 11, 1.5),
              ("default_q18", 18, "default", 11, 1.5),
              ("loss_q5", 5, "loss_random", 7, 3.0),
              ("loss_q13", 13, "loss_rank1", 3, 3.0)]
# a second loss on the shrunk group: 4 -> 3 -> 2
SECOND_LOSS = ("loss_twice_q9", 9, "loss_twice", 5, 3.0)


def plan(chaos, kind: str, seed: int):
    """The ``FaultPlan`` of ``kind`` built from ``chaos``, the reference's
    ``repro.distributed.chaos`` or the port's."""
    if kind == "default":
        return chaos.FaultPlan.default(seed)
    if kind == "loss_random":
        return chaos.FaultPlan.device_loss(seed, n_lost=1, cut="group_by")
    if kind == "loss_rank1":
        return chaos.FaultPlan.device_loss(seed, devices=(1,),
                                           cut="exchange")
    if kind == "loss_twice":
        # rank 1 of 4 on attempt 1, then rank 2 of the 3 survivors (the
        # boot group's rank 3) on attempt 2
        return chaos.FaultPlan(seed, (
            chaos.FaultSpec("device_lost", cut="exchange", attempt=1,
                            devices=(1,)),
            chaos.FaultSpec("device_lost", cut="exchange", attempt=2,
                            devices=(2,))))
    raise ValueError(f"unknown plan kind {kind!r}")


def record(runner, res) -> dict:
    """What a run must share with the reference's: outcomes, injected
    events, live width, lost ranks, generation, factors and wires."""
    return {
        "outcomes": res.report.outcomes(),
        "events": [[f.attempt, f.cut, f.index, f.kind, f.simulated]
                   for f in res.report.injected],
        "devices": runner.devices, "lost": list(runner.lost_devices),
        "generation": runner.topology_generation,
        "factors": [a.capacity_factor for a in res.report.attempts],
        "wires": [a.wire_format for a in res.report.attempts]}


_REF_SCRIPT = r"""
import json, sys
import numpy as np
out_path, cases, here = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
sys.path.insert(0, here)
from torch_chaos_cases import SEED, SF, plan, record
from repro.core.compat import make_mesh
from repro.data import tpch
from repro.distributed import chaos
from repro.distributed.chaos import ChaosInjector
from repro.distributed.fault import QueryRunner, RetryPolicy
from repro.queries import QUERIES

db = tpch.generate(SF, seed=SEED)
mesh = make_mesh((4,), ("data",))
meta, arrays = {}, {}
for name, qid, kind, seed, factor in cases:
    runner = QueryRunner(db, mesh, capacity_factor=factor,
                         chaos=ChaosInjector(plan(chaos, kind, seed)),
                         policy=RetryPolicy(max_attempts=6, backoff_s=0.0))
    res = runner.run(QUERIES[qid])
    meta[name] = record(runner, res)
    for k, v in res.result.items():
        arrays[name + "/" + k] = np.asarray(v)
np.savez(out_path, **arrays)
with open(out_path + ".json", "w") as f:
    json.dump(meta, f)
"""


def start_reference(out, cases) -> subprocess.Popen:
    """The reference's runner on ``cases`` over a 4-device mesh, in a
    subprocess writing ``out`` (results) and ``out.json`` (records)."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("REPRO_CHAOS", None)
    return subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(out),
         json.dumps([list(c) for c in cases]), HERE],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_reference(proc: subprocess.Popen, out, timeout: float = 600):
    """(records by case name, result arrays) of :func:`start_reference`."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(str(out) + ".json") as f:
        meta = json.load(f)
    return meta, dict(np.load(out))


def assert_same_result(got: dict, arrays: dict, name: str) -> None:
    """``got`` against the reference's results of case ``name``."""
    assert_close(got, {k.split("/", 1)[1]: v for k, v in arrays.items()
                       if k.startswith(name + "/")}, name)


def assert_close(got: dict, want: dict, label: str) -> None:
    """The same columns and rows, integers exactly, floats to rtol 1e-7."""
    assert set(want) == set(got), label
    for k, v in want.items():
        mine = got[k]
        assert len(mine) == len(v), (label, k)
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(mine, v, rtol=1e-7,
                                       err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(mine, v, err_msg=f"{label} {k}")
