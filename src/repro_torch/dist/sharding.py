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
it.  Over several devices a tensor is laid out as a DTensor
(``torch.distributed.tensor``): :meth:`Mesh.device_mesh` is the
``DeviceMesh`` of an initialised process group with one rank a device
(rank ``r`` is ``mesh.devices.flat[r]``), :meth:`Sharding.placements`
the DTensor placements of the spec, and :meth:`Sharding.place` /
:func:`constraint` distribute or redistribute onto them.  Without a
process group of the mesh's size they raise: nothing is placed on one
device in silence.  :func:`_spec_entries` and
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
_ADAPTED: list = []


def _moves_along(x, dims, n_args: int):
    """Placements of an op that moves ``x``'s elements along ``dims``
    (``flip``, ``roll``), one mesh axis at a time: replicated, or split
    along another dim; ``n_args`` non-tensor arguments follow ``x``."""
    from torch.distributed.tensor import Replicate, Shard

    moved = {d % x.ndim for d in dims}
    rest = [None] * n_args
    return [([Replicate()], [Replicate()] + rest)] + [
        ([Shard(d)], [Shard(d)] + rest) for d in range(x.ndim)
        if d not in moved]


#: Ops the models run that some torch releases give DTensor no strategy
#: for (``flip`` in ``cumsum``'s backward, ``roll`` in a sliding-window
#: prefill), and the strategy the port registers where none is.
_STRATEGIES = {
    "flip.default": lambda x, dims: _moves_along(x, dims, 1),
    "roll.default": lambda x, shifts, dims=(): _moves_along(
        x, dims or range(x.ndim), 2),
}


def _adapt_dtensor() -> None:
    """Give an op of :data:`_STRATEGIES` that the installed DTensor has
    no strategy for the port's (``register_sharding``), once a process.
    Only ops DTensor would refuse get one: no stock rule is replaced."""
    if _ADAPTED:
        return
    _ADAPTED.append(True)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import register_sharding

    prop = DTensor._op_dispatcher.sharding_propagator
    for name, strategy in _STRATEGIES.items():
        packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)
        if not any(op in getattr(prop, table, {}) for table in (
                "op_strategy_funcs", "op_to_rules",
                "op_single_dim_strategy_funcs")):
            register_sharding(op)(strategy)


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

    def device_mesh(self):
        """The ``DeviceMesh`` of this grid over the initialised process
        group, rank ``r`` at ``devices.flat[r]``; raises unless the group
        has exactly ``size`` ranks.  Built once a process group."""
        import torch.distributed as dist

        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else None)
        if world != self.size:
            have = "none" if world is None else f"one of {world}"
            raise RuntimeError(
                f"placing over the mesh {self.shape} needs an initialised "
                f"process group of {self.size} ranks, one a device "
                f"(torch.distributed.init_process_group); found {have}")
        _adapt_dtensor()
        group = dist.group.WORLD
        cached = getattr(self, "_device_mesh", None)
        if cached is None or cached[0] is not group:
            from torch.distributed.device_mesh import DeviceMesh

            ranks = torch.arange(self.size).reshape(self.devices.shape)
            cached = (group, DeviceMesh(self.devices.flat[0].type, ranks,
                                        mesh_dim_names=self.axis_names))
            self._device_mesh = cached
        return cached[1]

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

    def placements(self) -> tuple:
        """DTensor placements, one a mesh axis: ``Shard(d)`` where the
        axis splits dim ``d``, ``Replicate()`` otherwise.  A dim split
        over several axes is split row-major in mesh order, as
        :meth:`_block` splits it; an entry whose axes run against the
        mesh order has no such placement and raises."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.mesh.axis_names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            order = [self.mesh.axis_names.index(a) for a in names]
            if order != sorted(order):
                raise ValueError(f"{entry} runs against the mesh order "
                                 f"{self.mesh.axis_names}")
            for i in order:
                out[i] = Shard(dim)
        return tuple(out)

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` laid out by this sharding: on a mesh of one device, on
        that device; over several, a DTensor over
        :meth:`Mesh.device_mesh` (a DTensor ``x`` is redistributed)."""
        if self.mesh.size == 1:
            return x.to(self.mesh.devices.reshape(-1)[0])
        from torch.distributed.tensor import DTensor, distribute_tensor

        device_mesh = self.mesh.device_mesh()
        if isinstance(x, DTensor):
            return x.redistribute(device_mesh, self.placements())
        return distribute_tensor(x, device_mesh, self.placements())


def gather_unless_divides(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with the mesh axes that split ``dim`` gathered, where their
    extent does not divide ``n``: a DTensor has no view that cuts ``dim``
    into ``n`` parts across its shards (a few KV heads over a wide ``tp``
    axis).  A plain tensor, or a split that divides, is returned as is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    mesh = x.device_mesh
    parts = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(dim))
    if n % parts == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                 for p in x.placements])


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with the mesh axes that split ``dim`` gathered, once: for
    an input that several products take whole along ``dim`` (the
    sequence of the projections of one block), each of which would
    otherwise gather it again, and whose backward would gather it again
    for the weight's gradient.  A plain tensor is returned as is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    if not any(p.is_shard(dim) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in x.placements])


@contextlib.contextmanager
def off_mesh():
    """Inside, no mesh is current: :func:`constraint` and
    :func:`axis_extent` act as outside any (for code that runs on one
    rank's local blocks)."""
    if not hasattr(_STATE, "meshes"):
        _STATE.meshes = []
    _STATE.meshes.append(Mesh(np.empty((0,), dtype=object), ("none",)))
    try:
        yield
    finally:
        _STATE.meshes.pop()


def split_like(x: torch.Tensor, ref, dims) -> torch.Tensor:
    """A plain ``x`` (the same on every rank) as a DTensor over ``ref``'s
    mesh: split where ``ref`` splits a dim ``d`` in ``dims`` (``x``'s dim
    ``dims.index(d)``), replicated elsewhere; each rank takes its block,
    no collective.  A DTensor ``x`` is redistributed so."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    placements = [Shard(dims.index(p.dim)) if p.is_shard() and p.dim in dims
                  else Replicate() for p in ref.placements]
    if isinstance(x, DTensor):
        return x.redistribute(ref.device_mesh, placements)
    return distribute_tensor(x, ref.device_mesh, placements,
                             src_data_rank=None)


def run_local(fn, out_like, *args):
    """``fn(*args)`` on each rank's local blocks (``local_map``): the
    DTensors among ``args`` go in as their blocks, plain values as they
    are, and the result is a DTensor laid out as ``out_like`` (a tuple
    of results, one DTensor of ``out_like`` each); no mesh is current
    inside.  Without a DTensor among ``args``, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)

    def local(*blocks):
        with off_mesh():
            return fn(*blocks)

    outs = (tuple(list(o.placements) for o in out_like)
            if isinstance(out_like, tuple) else list(out_like.placements))
    mesh = (out_like[0] if isinstance(out_like, tuple)
            else out_like).device_mesh
    return local_map(local, outs,
                     in_placements=tuple(a.placements
                                         if isinstance(a, DTensor) else None
                                         for a in args),
                     device_mesh=mesh)(*args)


def grad_in_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient a DTensor gives back in ``x``'s own
    layout: where the next op would hand back a split that the view
    which made ``x`` cannot take (heads merged into one split dim), the
    gradient is redistributed first.  A plain tensor is returned as is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


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
    (named)tuples of them, and ``None`` holds no leaf.  Shape-unaware:
    divisibility is the annotator's contract here (shape-aware callers
    use :func:`sharding_for`).
    """
    rules = rules or _active_rules()

    def walk(node):
        if node is None:
            return None
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

    Inside a mesh of one device the tensor is placed on it.  Over
    several devices a DTensor is redistributed to the layout; a plain
    tensor is taken as replicated (each rank holds it whole), so a
    replicated layout leaves it as it is and a split places it
    (:meth:`Sharding.place`)."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    if mesh.size == 1:
        return x.to(mesh.devices.reshape(-1)[0])
    entries = _spec_entries(tuple(axes), mesh, _active_rules(), x.shape)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) and all(e is None for e in entries):
        return x
    return Sharding(mesh, tuple(entries)).place(x)
