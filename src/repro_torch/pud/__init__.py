"""PUD runtime: the addressed instruction stream (:mod:`.isa`), the §8.1
bit-serial arithmetic (:mod:`.arith`), the offload planner
(:mod:`.offload`), the latency re-exports (:mod:`.latency`), the
X-replica majority vote (:mod:`.tmr`), the behavioural bank/subarray
device (:mod:`.device`) and §8.2 content destruction
(:mod:`.secure_erase`)."""

from repro_torch.pud.isa import Program, PUDOp  # noqa: F401
from repro_torch.pud.arith import BitSerial, run_elementwise  # noqa: F401
from repro_torch.pud.tmr import vote_array, vote_pytree, vote_words  # noqa
