"""Logical-axis sharding: one rule table maps model axes to mesh axes.

Model code annotates tensors with *logical* axes (``"batch"``, ``"fsdp"``,
``"tp"``, ``"sp"``, ``"expert"``, ``"kv_batch"``); this module owns the
single mapping from those names onto the physical mesh axes (``pod``,
``data``, ``model``).  Swapping the active :class:`AxisRules` re-lays-out
the whole model without touching a single layer definition — that is how
serving flips to the activation-stationary layout.

Key invariants:

* **No mesh, no constraint** — without a mesh every helper degrades to a
  no-op, so single-device runs never pay a layout cost.  The port places
  nothing over a device mesh yet, so :func:`constraint` always returns
  its input and :func:`axis_extent` is 1 unless a mesh is passed in.
* **Indivisible dims replicate** — a logical axis whose mesh extent does
  not divide the tensor dim is dropped (replicated), never erroring.
* **Each physical axis is used at most once per spec** (SPMD requirement).

A mesh here is anything with ``axis_names`` and a ``shape`` mapping from
axis name to extent, which is all :func:`_spec_entries` reads.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Optional, Sequence

#: Logical axis annotation: a tuple of logical names (or None) per dim.
Axes = Sequence[Optional[str]]


class AxisRules:
    """An immutable logical-axis -> physical-mesh-axes mapping."""

    def __init__(self, name: str, mapping: Mapping[str, tuple[str, ...]]):
        self.name = name
        self.mapping = dict(mapping)

    def physical(self, logical: Optional[str]) -> tuple[str, ...]:
        """Physical mesh axes a logical axis shards over ('' -> none)."""
        if logical is None:
            return ()
        return tuple(self.mapping.get(logical, ()))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"AxisRules({self.name!r})"


#: Training layout: batch-family axes over the data-parallel grid
#: (pod x data), weight/tensor axes over the model grid.  ``sp`` is the
#: sequence-parallel fallback when a head count does not divide TP.
DEFAULT_RULES = AxisRules("default", {
    "batch": ("pod", "data"),
    "kv_batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tp": ("model",),
    "sp": ("model",),
    "expert": ("model",),
})

#: Serving layout (activation-stationary): per-token activations
#: replicate (their resharding is KBs but happens every decode step) while
#: the KV cache stays sharded over the data grid (gathering it is GBs).
SERVE_RULES = AxisRules("serve", {
    "batch": (),
    "kv_batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tp": ("model",),
    "sp": ("model",),
    "expert": ("model",),
})


_STATE = threading.local()


def _active_rules() -> AxisRules:
    return getattr(_STATE, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    """Swap the active rule table inside the context (thread-local)."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        if prev is None:
            del _STATE.rules
        else:
            _STATE.rules = prev


def axis_extent(logical: str, rules: Optional[AxisRules] = None,
                mesh=None) -> int:
    """Product of mesh extents a logical axis shards over (1 off-mesh)."""
    if mesh is None:
        return 1
    rules = rules or _active_rules()
    extent = 1
    for a in rules.physical(logical):
        if a in mesh.axis_names:
            extent *= mesh.shape[a]
    return extent


def _spec_entries(axes: Axes, mesh, rules: AxisRules,
                  shape: Optional[Sequence[int]] = None) -> list:
    """PartitionSpec entries for one tensor; drops unusable mappings."""
    entries: list = []
    used: set[str] = set()
    for i, logical in enumerate(axes):
        phys = [a for a in rules.physical(logical)
                if a in mesh.axis_names and a not in used]
        extent = 1
        for a in phys:
            extent *= mesh.shape[a]
        if not phys or extent <= 1:
            entries.append(None)
            continue
        if shape is not None and shape[i] % extent != 0:
            entries.append(None)  # indivisible: replicate this dim
            continue
        used.update(phys)
        entries.append(tuple(phys) if len(phys) > 1 else phys[0])
    return entries


def constraint(x, axes: Axes):
    """Apply a logical-axes layout constraint: a no-op, since the port
    runs every tensor on one device (no mesh can be entered yet)."""
    return x
