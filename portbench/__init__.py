"""The benchmark of ``imagecaptioner_tpu_torch`` (the PyTorch and CUDA port).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``spec.py`` finds a
cell's configuration (``configs/``), traffic mix (``workloads/``), driver
(``entries/``) and metric readers (``metrics/``) by name; ``traffic.py``
and ``weights.py`` make the inputs and weights from the seed; ``trace.py``
reads the traced slice; ``work/`` counts operations and bytes;
``reference/`` holds the plain float32 references that decide ``correct``;
``calibrate.py`` and ``faults.py`` give the readings the limits are set
from.  Nothing here imports JAX or the JAX package.
"""
