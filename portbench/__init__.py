"""The benchmark of the PyTorch and CUDA port.

Run one cell with ``python3 portbench/run.py``; ``BENCHMARK.json`` at the
root names the cells."""
