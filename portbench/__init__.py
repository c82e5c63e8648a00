"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``
once (``python portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``). See ``portbench/README.md``."""
