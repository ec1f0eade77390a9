"""The benchmark of ``alpro_tpu_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by its name:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix, read by ``drivers/<driver>.py``;
* ``cells/<cell>.json``: the limits that decide ``correct`` in that cell,
  with the readings they were set from;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

``counts/`` holds the FLOP and byte counts, ``reference/`` the plain fp32
model that judges the program's outputs, ``lib/`` the harness itself.
"""
