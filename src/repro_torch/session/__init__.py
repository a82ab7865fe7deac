"""``repro_torch.session``: the typed entry point for executing PUD work.

The paper's workloads — MAJX trees, Multi-RowCopy waves, §8.1
bit-serial arithmetic — are programs over subarray rows, and (PULSAR
-style) their value comes from *composing and re-running* those
programs.  :class:`DramSession` packages what every consumer needs for
that: a resolved backend + :class:`~repro_torch.backends.context.
ExecutionContext`, typed :class:`Row`/:class:`PlaneGroup` allocation
with build-time validation, automatic lowering through
:mod:`repro_torch.compile`, and a content-hashed :class:`CompileCache`
so a repeated program skips straight to fused execution.

>>> from repro_torch.session import DramSession
>>> sess = DramSession()                        # "cuda", on the card
>>> b = sess.program(rows=8)
>>> ops = b.input(planes)                       # typed row handles
>>> out = b.maj(ops[0], ops[1], ops[2])
>>> final = b.run()                             # validate -> cache -> fuse
>>> sess.success_rate(final[out.index], want)   # the mismatch kernel
>>> sums, prog = sess.elementwise("add", a, b)  # §8.1, traced + fused

``repro_torch.backends.get_backend`` remains as the layer underneath.
"""

from repro_torch.session.builder import SessionProgram
from repro_torch.session.cache import (CacheStats, CompileCache,
                                      program_key)
from repro_torch.session.rows import (PlaneGroup, Row, RowAllocationError,
                                      RowAllocator, SessionError)
from repro_torch.session.session import DramSession
from repro_torch.session.validate import (ProgramValidationError,
                                          check_program)

__all__ = [
    "CacheStats", "CompileCache", "DramSession", "PlaneGroup",
    "ProgramValidationError", "Row", "RowAllocationError", "RowAllocator",
    "SessionError", "SessionProgram", "check_program", "program_key",
]
