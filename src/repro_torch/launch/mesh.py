"""Production mesh construction.

Single pod: (16, 16) = 256 cards as (data, model).
Multi-pod:  (2, 16, 16) = 512 cards as (pod, data, model); the ``pod``
axis carries only data parallelism + ZeRO sharding, so its collectives
are the only cross-host traffic.

Meshes are built over the ``torch.cuda.device_count()`` cards of this
process, or over the CPU when ``device="cpu"`` is asked for (one
device).  ``device="fake"`` builds a mesh over the ranks of a "fake"
process group (``torch.distributed`` with ``backend="fake"``): one
``cuda`` device a rank, none of them touched.  Only the dry run
(:mod:`repro_torch.launch.dryrun`) sets such a group up, in its own
process, as the reference fakes its 512 devices only there.  A
FUNCTION, not a module-level constant: importing this module never
touches device state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh


def devices(device: str = "cuda") -> list[torch.device]:
    """The devices a mesh may use: every card, the one CPU, or the
    ranks of a fake world."""
    if device == "cpu":
        return [torch.device("cpu")]
    if device == "fake":
        return _fake_devices()
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu' (or 'fake' in a "
                         f"fake world), got {device!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for a mesh (pass device='cpu' "
                           "for one over the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def _fake_devices() -> list[torch.device]:
    """One ``cuda`` device a rank of the "fake" process group that is up;
    raises where none is."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "fake"):
        raise RuntimeError("device='fake' needs a 'fake' process group "
                           "(the dry run sets one up in its own process)")
    return [torch.device("cuda", r) for r in range(dist.get_world_size())]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` devices."""
    devs = devices(device)
    n = math.prod(shape)
    if n > len(devs):
        raise ValueError(f"Number of devices {len(devs)} must be >= the "
                         f"product of mesh_shape {tuple(shape)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(n_devices: int | None = None, model: int = 2,
                   device: str = "cuda") -> Mesh:
    """Small mesh over available devices (tests / examples)."""
    n = n_devices or len(devices(device))
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"), device)
