"""Preset sweeps: every paper figure's grid as a :class:`SweepSpec`.

Each ``figN_spec()`` is the exact characterization grid behind that
figure of the SiMRA-DRAM paper, expressed declaratively.  The figure
presets use the ``analytic`` pseudo-backend (direct evaluation of the
calibrated :class:`~repro_torch.core.errormodel.ErrorModel` surface), which
is exact at every paper anchor; for the MAJX/MRC grids, swap
``backends=("sim",)`` to measure the same grid behaviourally through
the Subarray command model, or add ``"cuda"`` for a digital-parity
column (the SiMRA grids are analytic-only: raw activation success has
no executable digital analogue, and the spec enforces that).
:data:`FIGURE_SPECS` is the CLI's ``--figure`` registry.
"""

from __future__ import annotations

from repro_torch.core import calibration as cal
from repro_torch.sweep.spec import ANALYTIC, SweepSpec


def fig3_spec() -> SweepSpec:
    """Fig 3: SiMRA success vs (t1, t2) x activation count."""
    return SweepSpec(name="fig3-simra-timing", op="simra",
                     backends=(ANALYTIC,), n_act=cal.N_ACT_LEVELS,
                     timings=((1.5, 1.5), (1.5, 3.0), (3.0, 1.5), (3.0, 3.0)))


def fig4_spec() -> SweepSpec:
    """Fig 4: SiMRA@32 across temperature and wordline voltage."""
    return SweepSpec(name="fig4-simra-env", op="simra", backends=(ANALYTIC,),
                     n_act=(32,), temps_c=cal.TEMPERATURES_C,
                     vpps_v=cal.VPP_LEVELS_V)


def fig6_spec() -> SweepSpec:
    """Fig 6: MAJ3 success vs timing x activation count (Obs 6/7)."""
    return SweepSpec(name="fig6-maj3-timing", op="majx", backends=(ANALYTIC,),
                     x_values=(3,), n_act=(4, 8, 16, 32),
                     timings=((1.5, 3.0), (3.0, 3.0), (4.5, 3.0), (1.5, 1.5)))


def fig7_spec() -> SweepSpec:
    """Fig 7: MAJX@32 across data patterns (Obs 8/9)."""
    return SweepSpec(name="fig7-majx-patterns", op="majx",
                     backends=(ANALYTIC,), x_values=(3, 5, 7, 9),
                     n_act=(32,), patterns=cal.DATA_PATTERNS)


def fig8_spec() -> SweepSpec:
    """Fig 8: MAJX across temperature, at min and 32-row act (Obs 11/12)."""
    return SweepSpec(name="fig8-majx-temp", op="majx", backends=(ANALYTIC,),
                     x_values=(3, 5, 7, 9), n_act=(4, 8, 16, 32),
                     temps_c=cal.TEMPERATURES_C)


def fig9_spec() -> SweepSpec:
    """Fig 9: MAJX@32 across wordline voltage (Obs 13)."""
    return SweepSpec(name="fig9-majx-vpp", op="majx", backends=(ANALYTIC,),
                     x_values=(3, 5, 7, 9), n_act=(32,),
                     vpps_v=cal.VPP_LEVELS_V)


def fig10_spec() -> SweepSpec:
    """Fig 10: Multi-RowCopy success vs t1 x destination count (Obs 14/15)."""
    return SweepSpec(name="fig10-mrc-timing", op="mrc", backends=(ANALYTIC,),
                     n_act=cal.N_ACT_LEVELS,
                     timings=((1.5, 3.0), (3.0, 3.0), (6.0, 3.0),
                              (9.0, 3.0), (36.0, 3.0)))


def fig11_spec() -> SweepSpec:
    """Fig 11: Multi-RowCopy across data patterns (Obs 16)."""
    return SweepSpec(name="fig11-mrc-patterns", op="mrc",
                     backends=(ANALYTIC,), n_act=cal.N_ACT_LEVELS,
                     patterns=("0x00", "0xFF", "random"))


def fig12_spec() -> SweepSpec:
    """Fig 12: Multi-RowCopy(31) across temperature and voltage (Obs 17/18)."""
    return SweepSpec(name="fig12-mrc-env", op="mrc", backends=(ANALYTIC,),
                     n_act=(32,), temps_c=cal.TEMPERATURES_C,
                     vpps_v=cal.VPP_LEVELS_V)


FIGURE_SPECS = {
    "fig3": fig3_spec, "fig4": fig4_spec, "fig6": fig6_spec,
    "fig7": fig7_spec, "fig8": fig8_spec, "fig9": fig9_spec,
    "fig10": fig10_spec, "fig11": fig11_spec, "fig12": fig12_spec,
}


# ------------------------------------------------------- executable presets


def smoke_spec(backends: tuple[str, ...] = ("sim", "cuda")) -> SweepSpec:
    """A <=16-point executable grid (the CLI ``--smoke`` / CI spec).

    Ideal contexts (no error injection) so every backend must agree with
    the oracle bit-exactly — this doubles as a cross-backend parity
    check whenever it runs.
    """
    return SweepSpec(name="smoke", op="majx", backends=tuple(backends),
                     x_values=(3,), n_act=(4, 32),
                     patterns=("random", "0x00/0xFF"),
                     ideal=True, rows=2, words=16, chunk=4)


def adaptive_smoke_spec() -> "AdaptiveSpec":
    """The adaptive-smoke campaign: MAJ3@32 success vs a t1 ladder.

    A 20-step t1 ladder (t2 pinned at the 3 ns optimum) on the analytic
    backend: success decays from ~0.98 through the Obs 7 charge-sharing
    cliff, crossing 0.9 almost immediately and 0.5 a few steps later.
    ``chunk=1`` so every probe is one point — the boundary search
    executes <= 40 % of the dense ladder while locating the same cliff
    bracket.
    """
    from repro_torch.sweep.adaptive import AdaptiveSpec

    ladder = tuple((1.5 + 1.5 * k, 3.0) for k in range(20))
    base = SweepSpec(name="adaptive-smoke", op="majx", backends=(ANALYTIC,),
                     x_values=(3,), n_act=(32,), timings=ladder, chunk=1)
    return AdaptiveSpec(base=base, thresholds=(0.5, 0.9))


def preflight_specs(backend: str) -> tuple[SweepSpec, SweepSpec]:
    """Tiny MAJX + MRC parity sweeps for one backend (run_all_cells)."""
    majx = SweepSpec(name=f"preflight-majx-{backend}", op="majx",
                     backends=(backend,), x_values=(3, 5), n_act=(32,),
                     ideal=True, rows=2, words=16, chunk=4)
    mrc = SweepSpec(name=f"preflight-mrc-{backend}", op="mrc",
                    backends=(backend,), n_act=(8, 32),
                    ideal=True, words=16, chunk=4)
    return majx, mrc
