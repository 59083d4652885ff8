"""The benchmark of the PyTorch and CUDA port, ``mppi_robotarm_tpu_torch``.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line last on standard output (``run.py``).  The harness
(``harness.py``) finds each cell's configuration, traffic, driver, limits
and metrics by name; the plain reference (``reference/``) and the
yardstick (``inputs.py``, ``roofline.py``, ``stats.py``, ``trace.py``,
``judge.py``) import nothing of the program.
"""
