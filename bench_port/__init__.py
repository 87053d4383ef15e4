"""The benchmark of the PyTorch and CUDA port ``mmdyn_tpu_torch``
(``python bench_port/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``); see ``BENCHMARK.json`` and ``PERF.md``."""
