"""``oracle``: the plain PyTorch reference backend.

Executes every op with its closed-form boolean semantics (the
``kernels/*/ref.py`` plain versions): no error model, no device
structure, no kernels.  This is the ground truth the ``cuda`` backend is
held against, on whatever device ``ctx.device`` names.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backends.base import Backend, Capabilities
from repro_torch.core import calibration as cal
from repro_torch.kernels.bitserial.ref import bitserial_add_ref
from repro_torch.kernels.majx.ref import majx_ref
from repro_torch.kernels.mismatch.ref import mismatch_count_ref
from repro_torch.kernels.rowcopy.ref import fanout_ref


class OracleBackend(Backend):
    name = "oracle"

    def capabilities(self) -> Capabilities:
        return Capabilities(
            name=self.name,
            description="plain PyTorch reference (kernels/*/ref.py); "
                        "exact, error-free",
            stochastic=False,
            device_model=False,
            accelerated=False,
            max_majx=1_000_000,  # any odd arity
            n_act_levels=cal.N_ACT_LEVELS,
            native_batch=False,
        )

    def majx(self, planes, x: Optional[int] = None,
             n_act: Optional[int] = None) -> torch.Tensor:
        return majx_ref(self.words(planes))

    def rowcopy(self, src, n_dst: int) -> torch.Tensor:
        return fanout_ref(self.words(src), n_dst)

    def mismatch(self, a, b) -> torch.Tensor:
        return mismatch_count_ref(self.words(a).reshape(-1),
                                  self.words(b).reshape(-1))

    def add_planes(self, a, b) -> torch.Tensor:
        return bitserial_add_ref(self.words(a), self.words(b))
