"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: the
numbers the comparison with the reference compared, each beside its
limit); everything else goes to standard error, ending with those checks.
It needs a CUDA device and exits non-zero without one; it measures nothing
on the CPU.  The program's kernels build into ``build/`` of the checkout,
so only a checkout's first run compiles.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux's /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# every build and kernel cache of the program inside the checkout, at a
# fixed path, so that only the first run of a checkout compiles
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
