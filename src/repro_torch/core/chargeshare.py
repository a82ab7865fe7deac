"""Monte-Carlo charge-sharing model of the bitline (paper §7.2 / §3.5).

The paper backs its real-chip observations with LTspice simulations of a
multi-row activation: N cell capacitors (each storing VDD, 0, or VDD/2 for
Frac-neutral rows) share charge with a precharged bitline, and the sense
amplifier resolves the resulting perturbation if it exceeds the reliable
sensing margin.  We reproduce that study with a closed-form charge-sharing
computation plus Monte-Carlo process variation, calibrated so that:

* MAJ3 with 32-row activation shows **+159.05 %** bitline deviation over
  4-row activation (paper §7.2) — this pins ``CB_OVER_CC``;
* at 40 % process variation, MAJ3@4-row success drops ~46.58 % while
  MAJ3@32-row drops ~0.01 % — this pins ``SENSE_MARGIN_FRAC``.

Charge sharing (all capacitances in units of the nominal cell cap C_c,
voltages in units of VDD):

    dV = sum_i C_i (v_i - 1/2) / (C_b + sum_i C_i),   v_i in {0, 1/2, 1}

Process variation draws C_i ~ U(1-p, 1+p) per cell (the paper varies
capacitor/transistor parameters by 10..40 % over 10^4 Monte-Carlo runs).
The draws are :mod:`repro_torch.core.rng`'s, word for word with the
reference's.  Every sum is folded pairwise in elementwise float32 adds
(:func:`_fold_sum`), so the card and the CPU give the same bits; XLA's
sums may round in another order.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import calibration as cal
from repro_torch.core import rng

# Bitline capacitance in units of C_c.  Solves
#   dev(32-row) / dev(4-row) = 1 + 1.5905
# with dev(N) = k / (C_b + N) for MAJ3(1,1,0) replicated k = floor(N/3) times
# and N % 3 Frac-neutral rows (which add capacitance but no differential
# charge):  10 (C_b + 4) = 2.5905 (C_b + 32).
CB_OVER_CC = (2.5905 * 32.0 - 10.0 * 4.0) / (10.0 - 2.5905)

# Reliable sensing margin as a fraction of VDD.  Calibrated (see
# tests/test_chargeshare.py) so the 40 %-PV MAJ3@4-row success lands at
# 1 - 0.4658 of its 0 %-PV value while MAJ3@32-row stays within 0.1 %.
SENSE_MARGIN_FRAC = 0.04936


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in one fixed order on every device:
    zero-padded to a power of two, then halves added elementwise until
    one column is left (``torch.sum`` orders its float adds per device).
    """
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


@dataclasses.dataclass(frozen=True)
class BitlineModel:
    cb_over_cc: float = CB_OVER_CC
    sense_margin: float = SENSE_MARGIN_FRAC

    def deviation(self, charges: torch.Tensor,
                  caps: torch.Tensor) -> torch.Tensor:
        """Bitline deviation dV/VDD for one charge-sharing event.

        charges: (..., n_cells) in {0.0, 0.5, 1.0}
        caps:    (..., n_cells) cell capacitances in units of C_c
        """
        num = _fold_sum(caps * (charges - 0.5))
        den = self.cb_over_cc + _fold_sum(caps)
        return num / den

    def sense(self, deviation: torch.Tensor) -> torch.Tensor:
        """Sense-amp output: +1 (VDD), -1 (0V), or 0 (unreliable)."""
        ok = torch.abs(deviation) > self.sense_margin
        return torch.where(ok, torch.sign(deviation),
                           torch.zeros_like(deviation))


def maj3_cell_charges(n_act: int, device="cuda") -> torch.Tensor:
    """Cell charges for MAJ3(1,1,0) under N-row activation (§3.3 plan).

    floor(N/3) copies of each operand; N % 3 neutral rows at VDD/2.
    """
    copies, neutral = cal.replication_plan(3, n_act)
    vals = [1.0, 1.0, 0.0] * copies + [0.5] * neutral
    return torch.tensor(vals, dtype=torch.float32, device=device)


def monte_carlo_maj3(
    key: torch.Tensor,
    n_act: int,
    pv: float,
    iters: int = cal.SPICE_MC_ITERS,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Monte-Carlo study of MAJ3(1,1,0) with N-row activation.

    Returns the deviation sample and the success indicator (sense amp
    resolves toward the correct majority, here logical 1).
    """
    model = BitlineModel()
    charges = maj3_cell_charges(n_act, device)
    u = rng.uniform(key, (iters, charges.shape[0]), minval=-pv, maxval=pv,
                    device=device)
    caps = 1.0 + u
    dev = model.deviation(charges[None, :], caps)
    sensed = model.sense(dev)
    return {"deviation": dev, "success": sensed > 0.0}


def deviation_mean(n_act: int) -> float:
    """Analytic 0-PV deviation of MAJ3(1,1,0) under N-row activation."""
    copies, neutral = cal.replication_plan(3, n_act)
    return 0.5 * copies / (CB_OVER_CC + 3 * copies + neutral)


def spice_study(key: torch.Tensor, iters: int = cal.SPICE_MC_ITERS,
                device="cuda"):
    """Full §7.2 reproduction: deviations + success across N x PV grid.

    Returns {(n_act, pv): {"dev_mean", "dev_std", "success_rate"}};
    ``success_rate`` is the exact fraction of successful iterations.
    Drawn and reduced on ``device``, bit for bit alike on the card and
    the CPU.
    """
    out = {}
    for n_act in (1, 4, 8, 16, 32):
        for pv in cal.SPICE_PV_LEVELS:
            key, sub = rng.split(key)
            if n_act == 1:
                # Single-row activation baseline (one charged cell).
                model = BitlineModel()
                u = rng.uniform(sub, (iters, 1), minval=-pv, maxval=pv,
                                device=device)
                dev = model.deviation(
                    torch.ones((iters, 1), device=device), 1.0 + u)
                succ = model.sense(dev) > 0
            else:
                res = monte_carlo_maj3(sub, n_act, pv, iters, device)
                dev, succ = res["deviation"], res["success"]
            # Divide by a tensor on the device: CUDA divides by a host
            # number as a multiply by its reciprocal, which rounds
            # otherwise than the CPU's division.
            n = dev.new_full((), iters)
            mean = _fold_sum(dev) / n
            centred = dev - mean
            out[(n_act, pv)] = {
                "dev_mean": float(mean),
                "dev_std": float(torch.sqrt(_fold_sum(centred * centred)
                                            / n)),
                # Exact count over iters (XLA's float32 mean of the same
                # indicators rounds in its own summation order).
                "success_rate": int(succ.sum()) / succ.numel(),
            }
    return out
