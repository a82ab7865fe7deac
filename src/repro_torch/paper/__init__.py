"""The paper's figures, their printer and the drivers of the dry run.

Unlike the rest of :mod:`repro_torch`, this subpackage mirrors no module
of ``src/repro/``: it holds the port's counterparts of the scripts that
drive the reference package from outside it, each a module run with
``python -m``:

* :mod:`~repro_torch.paper.figures` <- ``benchmarks/paper_figures.py``
  (Figs 3-12 and 15-18, Table 1);
* :mod:`~repro_torch.paper.kernel_bench` <- ``benchmarks/kernel_bench.py``;
* :mod:`~repro_torch.paper.run` <- ``benchmarks/run.py`` (the
  ``name,us_per_call,derived`` CSV of both, plus the roofline rows of the
  port's dry-run files);
* :mod:`~repro_torch.paper.run_all_cells` <- ``results/run_all_cells.py``;
* :mod:`~repro_torch.paper.make_tables` <- ``results/make_tables.py``;
* :mod:`~repro_torch.paper.hillclimb` <- ``results/hillclimb.py``.

Every entry point runs on the card unless given ``--device cpu``.  They
read and write files of their own names (``results/torch_dryrun_*.json``,
the port's sweep stores, a tables file given as an argument), never the
reference's.
"""
