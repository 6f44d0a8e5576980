"""The plain reference that decides ``correct``: plain PyTorch written
from the published equations, float32 with TF32 off.  It imports nothing
of the program (``repro_torch``), of the JAX package or of JAX, and takes
only what the benchmark made: weights and table from ``gstbench.weights``,
documents and draws from the seed.
"""
