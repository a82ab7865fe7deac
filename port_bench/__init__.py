"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything that belongs to one configuration,
traffic mix or per-layer metric is a file of its own here, found by the
name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — a deployment's sizes and settings; its
  ``driver`` names ``drivers/<driver>.py`` and its ``reference`` the
  plain reference ``reference/<reference>.py``;
* ``traffic/<traffic>.json`` — the parameters the general generator
  (``harness/traffic.py``) reads;
* ``metrics/<metric>.py`` — a reader ``read(record)`` of one metric,
  returning ``None`` where it finds nothing to read (``<quantity>.<kind>``
  falls back to ``metrics/<quantity>.py``);
* ``shelved/<cell>.json`` — the entries of a cell the benchmark does not
  run, which the CPU tests and the control still run.
"""
