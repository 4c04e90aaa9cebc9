"""The harness end to end on the CPU at a small scale: a run through the
real server comes out correct; the control and each planted fault come out
not correct; a configuration, a traffic mix and a per-layer metric added as
new files and entries alone are run; the command refuses a machine without
a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, harness  # noqa: E402
from repro_torch.core import backend as B  # noqa: E402

SEED = 2**31 + 41
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}


def _small_root(tmp: Path, sf: float = 0.005) -> Path:
    """A root whose BENCHMARK.json adds a small configuration and its two
    cells beside the real ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/tpch-sf30.json").read_text())
    cfg.update(name="small", scale_factor=sf)
    (tmp / "small.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "small", "source": "test",
                             "file": "small.json",
                             "reduced": ["scale_factor"], "why": "test"})
    for mix in ("power", "q1q6"):
        bench["workloads"].append({"name": f"small.{mix}", "config": "small",
                                   "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"] += ["small.power", "small.q1q6"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers at once, and each torch would otherwise start a thread a
    core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _small_root(tmp_path_factory.mktemp("root"))


def _run(root, workload="small.power", trace=False, factory=None,
         seconds=0.3):
    return harness.run_cell(workload, SEED, seconds, trace, device="cpu",
                            server_factory=factory, root=root)


def test_a_run_of_the_program_is_correct(root):
    out = _run(root)
    r = out.result
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert sorted(r["metrics"]) == ["latency_geomean_ms", "latency_p95_ms",
                                    "qps", "setup_s"]
    assert list(r)[-1] == "checks"
    assert out.result["checks"]["max_gap"]["value"] <= out.result["checks"]["max_gap"]["limit"]
    assert {"generate_s", "stats_s", "upload_s", "first_pass_s",
            "setup_s"} <= set(out.setup)


def test_a_traced_run_reports_the_per_layer_counters(root):
    r = _run(root, "small.q1q6", trace=True).result
    assert r["correct"]
    # Q1's ORDER BY sorts twice (one argsort a key), Q6 not at all
    assert r["metrics"]["sorts_per_query"]["value"] == 1.0
    assert r["metrics"]["rerun_share"]["value"] == 0.0
    # the device's readers read nothing on the CPU
    assert "idle_share" not in r["metrics"]


def test_the_control_is_not_correct(root):
    out = _run(root, "small.q1q6", factory=control.factory("tpch"))
    assert not out.result["correct"]
    assert out.result["checks"]["max_gap"]["value"] > out.result["checks"]["max_gap"]["limit"]


def _faulty(fault):
    """The program's server with ``fault`` applied to each answer it
    produces."""
    def make(tables, dicts, scale, device):
        server, parts, free = harness._program_server(tables, dicts, scale,
                                                      device)
        inner = server.submit

        def submit(qid, binding):
            return fault(qid, binding, inner)
        server.submit = submit
        return server, parts, free
    return make


def _alter_float(qid, binding, inner):
    ans = inner(qid, binding)
    for c, v in ans.items():
        if v.dtype.kind == "f" and len(v):
            ans[c] = v.copy()
            ans[c][0] *= 1 + 1e-6
            break
    return ans


def _alter_int(qid, binding, inner):
    ans = inner(qid, binding)
    for c, v in ans.items():
        if v.dtype.kind in "iu" and len(v):
            ans[c] = v.copy()
            ans[c][-1] += 1
            break
    return ans


def _drop_binding(qid, binding, inner):
    return inner(qid, {})


@pytest.mark.parametrize("fault", [_alter_float, _alter_int, _drop_binding],
                         ids=["float_altered", "int_altered",
                              "binding_dropped"])
def test_an_answer_altered_where_it_is_produced_is_caught(root, fault):
    # q1q6's cycle opens with Q1, which every fault here alters, so the
    # window's first request is already a wrong answer
    out = _run(root, "small.q1q6", factory=_faulty(fault))
    assert not out.result["correct"]
    assert out.result["failed"] > 0


def test_half_of_the_fact_table_left_out_is_caught(root, monkeypatch):
    real = B.device_tables

    def half(db, device):
        tables = dict(real(db, device))
        li = tables["lineitem"]
        tables["lineitem"] = type(li)(li.columns, li.count // 2, li.valid)
        return tables
    monkeypatch.setattr(B, "device_tables", half)
    out = _run(root, "small.q1q6")
    assert not out.result["correct"]
    assert out.result["checks"]["max_gap"]["value"] > 0.1


def test_new_files_and_entries_alone_add_a_cell_and_a_metric(tmp_path):
    """A copy of the benchmark's folder with a new configuration, traffic
    mix and per-layer metric, each a new file, and new entries in
    BENCHMARK.json: nothing else changes, and the new cell runs and
    reports the new metric."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = _small_root(tmp_path)
    pb = tmp_path / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/tpch-sf30.json").read_text())
    cfg.update(name="tiny", scale_factor=0.005)
    (pb / "configs/tiny.json").write_text(json.dumps(cfg))
    mix = {"loop": "closed", "clients": 1, "order": [3, 18, 13],
           "bindings_per_template": 2,
           "parameters": {"3": {"q3_date": {"kind": "day_between",
                                            "lo": "1995-03-01",
                                            "hi": "1995-03-31"}}}}
    (pb / "traffic/q3q18q13.json").write_text(json.dumps(mix))
    (pb / "metrics/requests_per_pass.py").write_text(
        "PASS = 'profile'\n\n\ndef read(rec):\n"
        "    return len(rec.requests) / 3\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": ["scale_factor"], "why": "test"})
    bench["workloads"].append({"name": "tiny.q3q18q13",
                               "config": "tiny", "traffic": "q3q18q13",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_per_pass", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "server", "moves": "qps",
                               "workloads": ["tiny.q3q18q13"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, b in before.items():
        assert p.read_bytes() == b, p
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench import harness\n"
        "out = harness.run_cell('tiny.q3q18q13', 5, 0.3, True, 'cpu')\n"
        "print(json.dumps(out.result))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=ENV, timeout=240)
    assert got.returncode == 0, got.stderr[-3000:]
    r = json.loads(got.stdout.strip().splitlines()[-1])
    assert r["correct"], got.stderr[-3000:]
    assert r["metrics"]["requests_per_pass"]["value"] >= 1
    # a metric whose workloads do not list the new cell stays out of it
    assert "sorts_per_query" not in r["metrics"]


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    got = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "tpch30.power", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, env=ENV, timeout=120)
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA" in got.stderr


@pytest.mark.gpu
def test_a_small_run_on_the_card_is_correct(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = _small_root(tmp_path, sf=0.1)
    out = harness.run_cell("small.power", SEED, 2.0, True, device="cuda",
                           root=root)
    r = out.result
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert 0 < r["metrics"]["segment_reduce_roofline"]["value"] <= 100
    assert np.isfinite(r["metrics"]["idle_share"]["value"])


@pytest.mark.gpu
def test_host_spans_are_not_device_time():
    """A span the program opens is mirrored onto the device's timeline as a
    user annotation: it must not count as busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    from torch.profiler import record_function
    from portbench import profiling

    def fn():
        with record_function(profiling.WINDOW_SPAN):
            with record_function("program.operator"):
                torch.ones(1 << 20, device="cuda").sum().item()
                time.sleep(0.2)
    tr = profiling.trace(fn, print)
    assert 0 < profiling.busy_s(tr) < 0.05
    assert not any(s.name == "program.operator" for s in tr.device)
