"""The paper's benchmarks on the port, one module per bench.

Each module mirrors a bench of the reference's ``benchmarks/`` directory and
has a ``main(argv=None, data=None)`` that parses its arguments, runs, prints
the reference's ``name,us_per_call,derived`` CSV (or the gated benches' own
report lines), writes ``--out`` where the reference writes a JSON report, and
returns that report.  Every bench runs on ``--device`` (``cuda`` unless
asked for ``cpu``; without CUDA it raises, it never falls back to the CPU),
and every time it prints names the device it was taken on.

``python -m repro_torch.bench.run [--device cpu] [names...]`` runs them in
the reference's order, in one process.

  bench_tpch            Fig. 10 per query and total + Table 4 counts
  bench_baseline        §6.7 engine against the NumPy reference
  bench_projection      Figs. 13/14/16 scale-out projection + QPS/$
  bench_kernels         the 8 Hopper kernels against their plain versions
  bench_exchange        Figs. 6/7 exchange sweep + Hockney fits   [N 8]
  bench_skew            Figs. 8/9/20/21 skewed exchange + JCC-H   [N 8]
  bench_broadcast_impl  Fig. 19 collective against p2p broadcast  [N 8]
  bench_q12_plans       Fig. 22 Q12 under three plans             [N 8]
  bench_exchange_bytes  per-query wire bytes from the IR, budgets (--check)
  bench_sort_tax        sorts and walls of six local plans, budgets (--check)
  bench_recovery        lineage resume against re-execution (--check)
  bench_serve           prepared templates against cold preparation (--check)
  bench_approx          sample-ladder walls against CI widths (--check)

The ``[N 8]`` benches run 8 ranks as a ``core.comm.ThreadGroup`` on one
device: their times are of on-device copies, not of a network.
"""
