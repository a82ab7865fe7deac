"""PUD runtime: the addressed instruction stream (:mod:`.isa`)."""

from repro_torch.pud.isa import Program, PUDOp  # noqa: F401
