"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on
NVIDIA H100 cards: ``python3 -m cardbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``; the cells, configurations
and metrics are listed in ``BENCHMARK.json`` at the root)."""
