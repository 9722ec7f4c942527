"""The benchmark of ``tpu_jordan_torch`` on an NVIDIA GPU.

One command runs one cell of ``BENCHMARK.json`` (``run.py``).  Everything
that belongs to one configuration, traffic mix, entry or metric sits in a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (storage dtype, products,
  engine choice, the control's precision);
- ``workloads/<traffic>.json``: the traffic (entry, n, m, batch, pool,
  judged sample);
- ``cells/<cell>.json``: the limits that decide ``correct`` and the
  readings they were set from;
- ``entries/<entry>.py``: how the program is driven;
- ``metrics/<metric>.py``: one reader a metric.

The yardstick (inputs, work counts, peaks, trace reduction, the plain
reference) lives here too and imports nothing of the program.
"""
