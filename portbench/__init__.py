"""portbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

One command, ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, runs one cell of ``BENCHMARK.json`` on the
card and prints one JSON line.  See ``portbench/README.md``.
"""
