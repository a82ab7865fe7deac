"""Execution backends for PUD operations.

One :class:`~repro_torch.pud.isa.Program`, interchangeable executors:

>>> from repro_torch.backends import ExecutionContext, get_backend
>>> be = get_backend("cuda")                    # or "oracle"
>>> out = be.run_fused(program, state, mode="megakernel")

Every backend takes the same :class:`ExecutionContext` (calibration
point, device, launch geometry), so a backend is a one-string config
choice.  The ``cuda`` backend runs on the card unless the context names
another device.
"""

from __future__ import annotations

from typing import Optional, Type

from repro_torch.backends.base import Backend, Capabilities  # noqa: F401
from repro_torch.backends.context import ExecutionContext, Timings  # noqa
from repro_torch.backends.cuda import CudaBackend
from repro_torch.backends.oracle import OracleBackend

_REGISTRY: dict[str, Type[Backend]] = {
    "cuda": CudaBackend,
    "oracle": OracleBackend,
}


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, ctx: Optional[ExecutionContext] = None) -> Backend:
    """Instantiate a registered backend with a shared ExecutionContext."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None
    return cls(ctx)


def resolve_backend(backend: "str | Backend",
                    ctx: Optional[ExecutionContext] = None) -> Backend:
    """Name -> registry lookup; instance -> passed through unchanged.

    A ``ctx`` alongside an already-constructed instance must match the
    instance's own context (a backend is constructed *under* its
    context; silently swapping would change semantics mid-flight).
    """
    if isinstance(backend, Backend):
        if ctx is not None and ctx != backend.ctx:
            raise ValueError(
                f"backend instance {backend.name!r} already carries an "
                f"ExecutionContext; pass ctx only when resolving by name")
        return backend
    return get_backend(backend, ctx)


__all__ = [
    "Backend", "Capabilities", "CudaBackend", "ExecutionContext",
    "OracleBackend", "Timings", "available_backends", "get_backend",
    "resolve_backend",
]
