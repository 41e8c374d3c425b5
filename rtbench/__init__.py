"""The benchmark of ``unitysimpleraytracing_tpu_torch`` on NVIDIA GPUs.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line: ``python3 rtbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``.  See ``rtbench/README.md``.
"""
