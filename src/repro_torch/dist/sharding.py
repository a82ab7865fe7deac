"""Logical-axis sharding: one rule table maps model axes to mesh axes.

Model code annotates tensors with *logical* axes (``"batch"``, ``"fsdp"``,
``"tp"``, ``"sp"``, ``"expert"``, ``"kv_batch"``); this module owns the
single mapping from those names onto the physical mesh axes (``pod``,
``data``, ``model``).  Swapping the active :class:`AxisRules` re-lays-out
the whole model without touching a single layer definition — that is how
serving flips to the activation-stationary layout.

Key invariants:

* **No mesh, no constraint** — outside a mesh context every helper
  degrades to a no-op / replicated sharding, so single-device runs never
  pay a layout cost.
* **Indivisible dims replicate** — a logical axis whose mesh extent does
  not divide the tensor dim is dropped (replicated), never erroring.
* **Each physical axis is used at most once per spec** (SPMD requirement).

:class:`Mesh` is the port's counterpart of ``jax.sharding.Mesh``: a
numpy grid of ``torch.device``s with named axes, entered with ``with
mesh:``.  A :class:`Sharding` (``NamedSharding``) pairs a mesh with the
spec entries :func:`_spec_entries` gives.  Placing a tensor is ``.to``
its device on a mesh of one device; :meth:`Sharding.shards` cuts a
tensor into its distinct blocks, each on the first device that holds
it.  One tensor laid out over several cards is not supported:
:meth:`Sharding.place` and :func:`constraint` raise there (ROADMAP
queue 1, multi-card placement).  :func:`_spec_entries` and
:func:`axis_extent` read only ``axis_names`` and the ``shape`` mapping
of a mesh, so any object with those two serves them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

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

#: What a placement over several cards waits for.
MULTI_CARD_PENDING = ("laying one tensor out over several cards is not "
                      "ported (ROADMAP queue 1: multi-card placement)")


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``).

    ``devices`` is anything numpy reshapes into the grid (a nested list
    or an object array of ``torch.device``s or device strings).  ``with
    mesh:`` makes it the current mesh of the thread, as in jax.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [torch.device(d) for d in grid.reshape(-1)]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs as "
                             f"many axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def __enter__(self) -> "Mesh":
        if not hasattr(_STATE, "meshes"):
            _STATE.meshes = []
        _STATE.meshes.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STATE.meshes.pop()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Mesh({self.shape}, {self.devices.reshape(-1)[:1]}...)"


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


def _current_mesh() -> Optional[Mesh]:
    """The mesh entered via ``with mesh:``, or None outside any."""
    meshes = getattr(_STATE, "meshes", None)
    if not meshes or meshes[-1].empty:
        return None
    return meshes[-1]


def axis_extent(logical: str, rules: Optional[AxisRules] = None,
                mesh=None) -> int:
    """Product of mesh extents a logical axis shards over (1 off-mesh)."""
    mesh = mesh if mesh is not None else _current_mesh()
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


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and one spec entry a dim (``NamedSharding``): ``None``
    replicates the dim, a mesh axis name (or a tuple of them) splits it
    over those axes' devices, row-major."""

    mesh: Mesh
    spec: tuple

    def _block(self, coords: dict[str, int], shape) -> tuple:
        """The slices of the block the device at ``coords`` holds."""
        index = []
        for dim, entry in zip(shape, self.spec + (None,) * len(shape)):
            if entry is None:
                index.append(slice(None))
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            extent = math.prod(self.mesh.shape[a] for a in names)
            pos = 0
            for a in names:
                pos = pos * self.mesh.shape[a] + coords[a]
            size = dim // extent
            index.append(slice(pos * size, (pos + 1) * size))
        return tuple(index)

    def shards(self, x: torch.Tensor) -> list[tuple[tuple, torch.Tensor]]:
        """Each distinct block of ``x`` as ``(slices, tensor)``, the
        tensor on the first device (in the grid's row-major order) that
        holds the block; replicas of a block are not copied again."""
        out, seen = [], set()
        for coords in itertools.product(*map(range, self.mesh.devices.shape)):
            index = self._block(dict(zip(self.mesh.axis_names, coords)),
                                x.shape)
            key = tuple((s.start, s.stop) for s in index)
            if key not in seen:
                seen.add(key)
                out.append((index, x[index].to(self.mesh.devices[coords])))
        return out

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` laid out by this sharding: on a mesh of one device, on
        that device; over several cards, not supported (raises)."""
        if self.mesh.size == 1:
            return x.to(self.mesh.devices.reshape(-1)[0])
        raise NotImplementedError(f"{self.spec} over {self.mesh.shape}: "
                                  f"{MULTI_CARD_PENDING}")


def sharding_for(shape: Sequence[int], axes: Axes, mesh: Mesh,
                 rules: Optional[AxisRules] = None) -> Sharding:
    """The Sharding for a concrete shape (indivisible dims replicate)."""
    rules = rules or _active_rules()
    return Sharding(mesh, tuple(_spec_entries(tuple(axes), mesh, rules,
                                              tuple(shape))))


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def tree_shardings(axes_tree, mesh: Mesh,
                   rules: Optional[AxisRules] = None):
    """Map a tree of logical-axes tuples to Shardings.

    Leaves are tuples of logical names / None (the empty tuple is a
    scalar leaf -> fully replicated); containers are dicts, lists and
    (named)tuples of them.  Shape-unaware: divisibility is the
    annotator's contract here (shape-aware callers use
    :func:`sharding_for`).
    """
    rules = rules or _active_rules()

    def walk(node):
        if _is_axes_leaf(node):
            return Sharding(mesh, tuple(_spec_entries(node, mesh, rules)))
        if isinstance(node, dict):
            return type(node)((k, walk(v)) for k, v in node.items())
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*map(walk, node))
        return type(node)(map(walk, node))

    return walk(axes_tree)


def constraint(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Apply a logical-axes layout constraint (no-op outside a mesh).

    Inside a mesh of one device the tensor is placed on it; over several
    cards a replicated layout leaves it as it is and any split raises
    (:data:`MULTI_CARD_PENDING`)."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    if mesh.size == 1:
        return x.to(mesh.devices.reshape(-1)[0])
    entries = _spec_entries(tuple(axes), mesh, _active_rules(), x.shape)
    if all(e is None for e in entries):
        return x
    return Sharding(mesh, tuple(entries)).place(x)
