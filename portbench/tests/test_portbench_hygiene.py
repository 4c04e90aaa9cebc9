"""What the benchmark runs loads neither JAX nor the JAX package, and reads
nothing of the repo's other benches; ``BENCHMARK.json`` names only what
exists."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BANNED = {"jax", "jaxlib", "flax", "repro"}


def test_the_harness_loads_no_jax_and_no_jax_package():
    """In a fresh process (the suite's other tests load both packages into
    its workers): every module the harness runs, the readers of every
    per-layer metric, and the program's modules they reach."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import json\n"
        "from portbench import catalog, compare, control, harness, loadgen\n"
        "from portbench import profiling\n"
        "from portbench.data import device_tpch, tpch\n"
        "from portbench.reference import relational, tpch as ref\n"
        "bench = json.load(open(catalog.ROOT / 'BENCHMARK.json'))\n"
        "for m in bench['per_layer']:\n"
        "    catalog.reader(m['name'])\n"
        "import repro_torch.serve, repro_torch.kernels.segsum.ops\n"
        "import repro_torch.core.sortcount, repro_torch.core.planner\n"
        "import repro_torch.core.table, repro_torch.kernels\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=180)
    assert got.returncode == 0, got.stderr[-2000:]
    loaded = set(eval(got.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and "repro_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_file_of_the_benchmark_imports_the_repos_other_benches():
    for path in sorted(PB.rglob("*.py")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in BANNED, (path, mod)
            assert top != "benchmarks", (path, mod)
            assert not mod.startswith("repro_torch.bench"), (path, mod)


def test_the_reference_shares_no_code_with_the_program():
    for path in sorted((PB / "reference").rglob("*.py")):
        assert not any(m.split(".")[0] == "repro_torch"
                       for m in _imports(path)), path


def test_benchmark_json_names_only_what_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert name.match(c["name"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (PB / "data" / f"{cfg['generator']}.py").exists()
        assert (PB / "reference" / f"{cfg['reference']}.py").exists()
    for w in bench["workloads"]:
        assert name.match(w["name"]) and w["config"] in configs
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
    for m in bench["per_layer"]:
        assert name.match(m["name"])
        assert (PB / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in bench["end_to_end"]} == \
        {"qps", "latency_geomean_ms", "latency_p95_ms", "setup_s"}
