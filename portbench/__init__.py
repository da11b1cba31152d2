"""The benchmark of the PyTorch/CUDA port ``ggp_tpu_torch``: ``run.py`` runs a
cell (``workloads/``) of a configuration (``configs/``) under a traffic mix
(``traffic/``, read by ``driver.py``), ``check.py`` holds what it produced to
the plain reference (``reference/``), ``metrics/`` reads the per-layer
metrics of a traced run, ``control.py`` takes the readings that the limits
are set from. It imports neither JAX nor the JAX package ``ggp_tpu``."""
