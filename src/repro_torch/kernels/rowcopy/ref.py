"""Plain PyTorch version of the fan-out kernel (``csrc/fanout.cu``)."""

from __future__ import annotations

import torch


def fanout_ref(src: torch.Tensor, fanout: int) -> torch.Tensor:
    """Copy a source block ``fanout`` times: (...) -> (fanout, ...)."""
    return torch.stack([src] * fanout) if fanout else \
        src.new_empty((0, *src.shape))
