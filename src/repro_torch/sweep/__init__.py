"""Characterization-campaign engine: declarative, sharded, resumable.

The paper's central artifact is not one kernel call but a *campaign*:
success-rate surfaces swept over simultaneous-activation count, MAJ
arity, data pattern, violated timings, temperature, and voltage across
120 chips.  This package reproduces that shape over the unified
:mod:`repro_torch.backends` executor API, on the card unless told
otherwise:

>>> from repro_torch.sweep import SweepSpec, run_sweep, aggregate
>>> spec = SweepSpec(name="demo", op="majx", backends=("sim",),
...                  x_values=(3,), n_act=(4, 32))
>>> result = run_sweep(spec, root="results/sweeps", device="cuda")
>>> aggregate.replication_delta(result.records)   # Obs 6 headline
0.3...

Pipeline: :class:`~repro_torch.sweep.spec.SweepSpec` (the grid,
content-hashed) -> :mod:`~repro_torch.sweep.planner` (backend-native
batches / chunks)
-> :mod:`~repro_torch.sweep.runner` (execute; shard across workers and the
device mesh, or fault-tolerantly with :func:`run_sweep_ft`'s elastic
worker pool) -> :mod:`~repro_torch.sweep.store` (atomic per-chunk files on a
pluggable backend; restart skips completed chunks) ->
:mod:`~repro_torch.sweep.aggregate` (headline tables).
:mod:`~repro_torch.sweep.adaptive` replaces the dense grid with a boundary
search over the same points/store when only the failure cliff matters.
``python -m repro_torch.sweep.run --smoke`` exercises the whole pipeline in
seconds.
"""

from repro_torch.sweep import aggregate, presets  # noqa: F401
from repro_torch.sweep.adaptive import (  # noqa: F401
    AdaptiveResult, AdaptiveSpec, Crossing, run_adaptive)
from repro_torch.sweep.planner import (  # noqa: F401
    Chunk, chunks_by_point, plan, shard)
from repro_torch.sweep.runner import (  # noqa: F401
    FtSweepResult, SweepResult, records_for, run_sweep, run_sweep_ft)
from repro_torch.sweep.spec import (  # noqa: F401
    ANALYTIC, SEARCH_AXES, GridPoint, SweepSpec, load_spec)
from repro_torch.sweep.store import (  # noqa: F401
    LocalDirBackend, MemoryBackend, RecordStore, RecordStoreBackend,
    default_root, discover)

__all__ = [
    "ANALYTIC", "AdaptiveResult", "AdaptiveSpec", "Chunk", "Crossing",
    "FtSweepResult", "GridPoint", "LocalDirBackend", "MemoryBackend",
    "RecordStore", "RecordStoreBackend", "SEARCH_AXES", "SweepResult",
    "SweepSpec", "aggregate", "chunks_by_point", "default_root", "discover",
    "load_spec", "plan", "presets", "records_for", "run_adaptive",
    "run_sweep", "run_sweep_ft", "shard",
]
