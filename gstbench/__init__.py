"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python -m gstbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; README.md says how
the files here are found by name.
"""
