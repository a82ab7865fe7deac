"""ExecutionContext: the one knob object every backend call takes.

The paper's central result is that the *same* APA command sequence yields
MAJX, Multi-RowCopy, or plain RowClone depending only on the operating
regime — timings (t1, t2), temperature, wordline voltage, data pattern.
``ExecutionContext`` captures exactly that regime (plus the execution
knobs: device, CUDA launch geometry, RNG seed) so that the regime is
declared once and threaded to whichever backend executes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import calibration as cal
from repro_torch.core.errormodel import ErrorModel


@dataclasses.dataclass(frozen=True)
class Timings:
    """The violated-timing pairs (ns) issued per op class (§3.3/§3.4).

    Defaults are the paper's best operating points: MAJX at (1.5, 3),
    Multi-RowCopy at (36, 3), SiMRA at (3, 3).
    """

    majx_t1: float = cal.MAJX_BEST_T1_NS
    majx_t2: float = cal.MAJX_BEST_T2_NS
    mrc_t1: float = cal.MRC_BEST_T1_NS
    mrc_t2: float = cal.MRC_BEST_T2_NS
    simra_t1: float = cal.SIMRA_BEST_T1_NS
    simra_t2: float = cal.SIMRA_BEST_T2_NS


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """Shared calibration point + execution knobs for all backends.

    Frozen and hashable: a context *is* an operating-regime identity.
    Derive variants with :meth:`replace`.

    Operating regime (device physics; consumed by latency / energy
    costing):

    * ``mfr`` — manufacturer profile ("H" / "M" / "S", Table 1),
    * ``timings`` — the issued (t1, t2) pairs per op class,
    * ``temp_c`` — DRAM temperature in Celsius (paper grid 50-90),
    * ``vpp_v`` — wordline voltage in volts (nominal 2.5, down to 2.1),
    * ``pattern`` — data pattern written to operand rows; one of
      :data:`repro_torch.core.calibration.DATA_PATTERNS` (Obs 9/16),
    * ``ideal`` — disable stochastic error injection (pure digital
      semantics; the port's backends are all digital today).

    Compiler defaults (consumed by the bit-serial §8.1 programs):

    * ``tier`` — widest MAJ gate available (3/5/7/9),
    * ``n_act`` — simultaneous-activation count per MAJ issue
      (§4 Limitation 2: one of 2/4/8/16/32).

    Execution knobs:

    * ``certify`` — run the static analyzer over every fused artifact a
      session executes (the session layer is a later slice of the port),
    * ``device`` — where state tensors live and kernels run: ``"cuda"``
      (the default: the port runs on the card) or ``"cpu"``, where every
      kernel wrapper computes with its plain PyTorch version,
    * ``threads_per_block`` — CUDA block size of every kernel launch
      (one thread per packed word),
    * ``subarray_cols`` — behavioural-sim row width (bits),
    * ``seed`` — stable-mask RNG seed: the chip / row-group identity.
    """

    mfr: str = "H"
    timings: Timings = dataclasses.field(default_factory=Timings)
    temp_c: float = 50.0
    vpp_v: float = 2.5
    pattern: str = "random"
    ideal: bool = False

    tier: int = 5
    n_act: int = 32

    certify: bool = True
    device: str = "cuda"
    threads_per_block: int = 256
    subarray_cols: int = 1024
    seed: int = 0

    @property
    def error_model(self) -> ErrorModel:
        return ErrorModel(self.mfr)

    def env(self) -> dict:
        """Environment kwargs understood by the ErrorModel surfaces."""
        return {"temp_c": self.temp_c, "vpp_v": self.vpp_v}

    def replace(self, **kw) -> "ExecutionContext":
        return dataclasses.replace(self, **kw)
