"""The benchmark of ``tinynerf_torch`` on NVIDIA H100 cards.

``BENCHMARK.json`` at the root of the checkout names the cells; one run of
one cell is ``python3 -m nerfbench --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``run.py``). The yardstick lives here: the scene and
weights made from the seed (``scene.py``, ``configs/<config>.py``), the
traffic mixes (``traffic/``), the plain reference and the comparison that
decides ``correct`` (``reference/``, ``check.py``, ``limits/``), the
operation counts and peaks (each configuration's own in
``configs/<config>.py``, the shared ones in ``counts.py`` and
``peaks.json``), the trace's reduction (``trace.py``) and one reader a
per-layer metric (``metrics/``). ``calibrate.py`` reads the check's numbers over many seeds
for the program, its control and planted faults; ``sweep.py`` runs a cell
many times and reports the spread of each metric.
"""
