"""The port's benchmark: cells of BENCHMARK.json run against repro_torch
on the card (``python3 portbench/run.py --workload <cell> ...``)."""
