"""The paper's experiments through the port: ``paper_tables`` (one entry
per table or figure, ``ALL_BENCHES``) and its runner ``run``
(``python -m repro_torch.paper.run``).  Counterpart of the reference's
``benchmarks/paper_tables.py`` and ``benchmarks/run.py``."""
