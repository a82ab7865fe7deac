"""Every SiMRA-DRAM figure and table as a function of CSV rows.

The counterpart of the reference's ``benchmarks/paper_figures.py``.  Each
function returns ``(name, us_per_call, derived)`` rows, ``derived``
carrying the figure's headline quantity; :mod:`repro_torch.paper.run`
prints them.  Each takes the sweep store's ``root`` (``None``: the
port's :func:`~repro_torch.sweep.default_root`) and the ``device`` to run
on (the card unless the caller asks for the CPU); a function that needs
neither ignores them.

The characterization figures (3, 4, 6-12) are formatted views over
:mod:`repro_torch.sweep` records: each grid is a preset
:class:`~repro_torch.sweep.spec.SweepSpec` of the analytic backend,
whose records are produced, or loaded from the resumable store, by the
sweep engine.  The others (power, SPICE, the §8 case studies) are
analytic models, computed directly; Fig 18 runs its programs through a
``cuda`` session.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.backends import ExecutionContext
from repro_torch.core import calibration as cal
from repro_torch.core import chargeshare as cs
from repro_torch.core import power as pw
from repro_torch.core import rng
from repro_torch.core.costmodel import COST
from repro_torch.core.errormodel import ErrorModel
from repro_torch.pud import latency as lat
from repro_torch.pud.secure_erase import (destruction_time_ns,
                                          speedup_over_rowclone)
from repro_torch.session import DramSession
from repro_torch.sweep import presets, records_for, run_adaptive

#: Monte-Carlo iterations of Fig 15 (the reference figure's).
SPICE_ITERS = 4000


def _records(spec, root, device):
    return records_for(spec, root=root, progress=False, device=device)


# Fig 3: SiMRA success vs (t1, t2) x N -----------------------------------


def fig3_simra_timing(root=None, device="cuda"):
    recs = sorted(_records(presets.fig3_spec(), root, device),
                  key=lambda r: (r["t1"], r["t2"], r["n_act"]))
    return [(f"fig3_simra_n{r['n_act']}_t1_{r['t1']}_t2_{r['t2']}", 0.0,
             f"success={r['success']:.4f}") for r in recs]


# Fig 4: SiMRA temperature / voltage -------------------------------------


def fig4_simra_temp_vpp(root=None, device="cuda"):
    recs = _records(presets.fig4_spec(), root, device)
    rows = [(f"fig4a_simra32_T{r['temp_c']:.0f}", 0.0,
             f"success={r['success']:.4f}")
            for r in recs if r["vpp_v"] == 2.5]
    rows += [(f"fig4b_simra32_V{r['vpp_v']:.1f}", 0.0,
              f"success={r['success']:.4f}")
             for r in recs if r["temp_c"] == 50.0]
    return rows


# Fig 5: power ------------------------------------------------------------


def fig5_power(root=None, device="cuda"):
    rows = [(f"fig5_power_{op}", 0.0, f"watts={w:.3f}")
            for op, w in pw.power_table().items()]
    delta = pw.simra_power_w(32) / pw.STANDARD_POWER_W["REF"] - 1
    rows.append(("fig5_simra32_vs_ref", 0.0, f"delta={delta:+.4f}"))
    return rows


# Fig 6: MAJ3 vs timing x N (incl. the replication ladder) -----------------


def fig6_maj3_timing(root=None, device="cuda"):
    spec = presets.fig6_spec()
    order = {t: i for i, t in enumerate(spec.timings)}
    recs = sorted(_records(spec, root, device),
                  key=lambda r: (order[(r["t1"], r["t2"])], r["n_act"]))
    return [(f"fig6_maj3_n{r['n_act']}_t1_{r['t1']}_t2_{r['t2']}", 0.0,
             f"success={r['success']:.4f}") for r in recs]


def fig6_cliff_adaptive(root=None, device="cuda"):
    """Obs 7's cliff located by boundary search instead of a dense ladder:
    the adaptive smoke campaign (a 20-step t1 ladder, MAJ3 at 32 rows),
    each threshold's bracket and the points the search executed of the
    dense ladder's.  The store is shared with dense runs of the spec."""
    result = run_adaptive(presets.adaptive_smoke_spec(), root=root,
                          device=device)
    rows = [(f"fig6_cliff_t1_at_{c.threshold:g}", 0.0,
             f"bracket={c.lo_value[0]:g}..{c.hi_value[0]:g}ns")
            for c in result.crossings if c.crossed]
    rows.append(("fig6_cliff_economy", 0.0,
                 f"probed={result.n_probed}/{result.n_grid_points}"))
    return rows


# Fig 7: MAJX x data pattern ----------------------------------------------


def fig7_majx_patterns(root=None, device="cuda"):
    return [(f"fig7_maj{r['x']}_{r['pattern'].replace('/', '_')}", 0.0,
             f"success={r['success']:.4f}")
            for r in _records(presets.fig7_spec(), root, device)]


# Fig 8/9: MAJX temperature / voltage -------------------------------------


def fig8_majx_temperature(root=None, device="cuda"):
    recs = _records(presets.fig8_spec(), root, device)
    wanted = {(x, n) for x in (3, 5, 7, 9)
              for n in (cal.min_activation_for(x), 32)}
    recs = sorted((r for r in recs if (r["x"], r["n_act"]) in wanted),
                  key=lambda r: (r["x"], r["temp_c"], r["n_act"]))
    return [(f"fig8_maj{r['x']}_n{r['n_act']}_T{r['temp_c']:.0f}", 0.0,
             f"success={r['success']:.4f}") for r in recs]


def fig9_majx_voltage(root=None, device="cuda"):
    return [(f"fig9_maj{r['x']}_V{r['vpp_v']:.1f}", 0.0,
             f"success={r['success']:.4f}")
            for r in _records(presets.fig9_spec(), root, device)]


# Fig 10-12: Multi-RowCopy -------------------------------------------------


def fig10_mrc_timing(root=None, device="cuda"):
    recs = sorted(_records(presets.fig10_spec(), root, device),
                  key=lambda r: (r["t1"], r["n_dest"]))
    return [(f"fig10_mrc{r['n_dest']}_t1_{r['t1']}", 0.0,
             f"success={r['success']:.5f}") for r in recs]


def fig11_mrc_patterns(root=None, device="cuda"):
    order = {"0x00": 0, "0xFF": 1, "random": 2}
    recs = sorted(_records(presets.fig11_spec(), root, device),
                  key=lambda r: (order[r["pattern"]], r["n_dest"]))
    return [(f"fig11_mrc{r['n_dest']}_{r['pattern']}", 0.0,
             f"success={r['success']:.5f}") for r in recs]


def fig12_mrc_temp_vpp(root=None, device="cuda"):
    recs = _records(presets.fig12_spec(), root, device)
    rows = [(f"fig12a_mrc31_T{r['temp_c']:.0f}", 0.0,
             f"success={r['success']:.5f}")
            for r in recs if r["vpp_v"] == 2.5]
    rows += [(f"fig12b_mrc31_V{r['vpp_v']:.1f}", 0.0,
              f"success={r['success']:.5f}")
             for r in recs if r["temp_c"] == 50.0]
    return rows


# Fig 15: SPICE Monte-Carlo ------------------------------------------------


def fig15_spice_mc(root=None, device="cuda"):
    """The §7.2 study under ``PRNGKey(0)``: the port's threefry draws
    the reference's numbers, on the card or the CPU alike.  The success
    rate is printed as the reference's float32 mean of the same count
    (``spice_study`` gives the exact fraction; 3815 / 4000 prints
    0.9537, its float32 mean 0.9538)."""
    out = cs.spice_study(rng.PRNGKey(0), iters=SPICE_ITERS, device=device)
    rows = [(f"fig15_n{n}_pv{int(pv * 100)}", 0.0,
             f"dev={d['dev_mean']:.4f};"
             f"success={float(np.float32(d['success_rate'])):.4f}")
            for (n, pv), d in out.items()]
    gain = cs.deviation_mean(32) / cs.deviation_mean(4) - 1
    rows.append(("fig15_dev_gain_32_over_4", 0.0, f"gain={gain:+.4f}"))
    return rows


# Fig 16: the seven microbenchmarks ---------------------------------------

#: Active subarrays pipelining MAJX issues (bank-level parallelism: the
#: paper schedules across 16 banks x 3 subarrays; 5 concurrently active
#: keep the model within a DDR4 power budget, cf. Fig 5).
ACTIVE_SUBARRAYS = 5


@functools.lru_cache(maxsize=None)
def _microbench_program(op: str, tier: int, device: str):
    """The §8.1 program of ``op`` at ``tier``, traced once: it depends on
    the op, the tier and the activation count (which the tier fixes),
    never on the maker, and the operands are always the same."""
    data = np.random.default_rng(0)
    a = data.integers(0, 2**32, 8, dtype=np.uint32)
    b = np.maximum(data.integers(0, 2**32, 8, dtype=np.uint32), 1)
    n_act = 4 if tier == 3 else 32
    # programs are backend-invariant; the oracle is the cheapest compiler
    session = DramSession("oracle", ExecutionContext(device=device))
    return session.elementwise(op, a, b, tier=tier, n_act=n_act)[1]


def _microbench_time_ns(op: str, mfr: str, tier: int,
                        device: str = "cuda") -> float:
    """Analytical §8.1 model: time = max(critical path, op-issue time /
    active subarrays), with best-group success retries."""
    prog = _microbench_program(op, tier, device)
    bg = cal.MAJX_BEST_GROUP_SUCCESS[mfr]
    bg3_baseline = cal.MAJ3_4ROW_BEST_GROUP_SUCCESS[mfr]

    def op_time(x: int) -> float:
        s = bg.get(x, 0.005) if tier > 3 else bg3_baseline
        return lat.LAT.majx_apa / max(s, 1e-3)

    total = 0.0
    n_maj = {3: 0, 5: 0, 7: 0, 9: 0}
    for o in prog.ops:
        if o.kind == "MAJ":
            total += op_time(o.x)
            n_maj[o.x] += 1
        elif o.kind in ("NOT", "COPY"):
            total += lat.LAT.rowclone
    # the critical path is the serial carry chain (add/sub/mul/div);
    # tier >= 7 halves its depth through the MAJ7 two-position skip
    chain = {"add": 32, "sub": 32, "mul": 32 * 32,
             "div": 33 * 32}.get(op, 3)
    if tier >= 7:
        chain /= 2
    worst_x = max((x for x, c in n_maj.items() if c), default=3)
    crit = chain * op_time(worst_x if tier >= 7 else 3)
    return max(crit, total / ACTIVE_SUBARRAYS)


def fig16_microbench_speedups(root=None, device="cuda"):
    """Speedups of each microbenchmark over MAJ3 at 4-row activation."""
    rows = []
    for mfr in ("M", "H"):
        tiers = (5, 7) if mfr == "M" else (5, 7, 9)
        speedups = {t: [] for t in tiers}
        for op in cal.MICROBENCHMARKS:
            base = _microbench_time_ns(op, mfr, 3, device)
            for t in tiers:
                sp = base / _microbench_time_ns(op, mfr, t, device)
                speedups[t].append(sp)
                rows.append((f"fig16_{mfr}_{op}_maj{t}", 0.0,
                             f"speedup={sp:.3f}"))
        for t in tiers:
            rows.append((f"fig16_{mfr}_avg_maj{t}", 0.0,
                         f"speedup={np.mean(speedups[t]):.3f}"))
    return rows


# Fig 17: cold-boot content destruction ------------------------------------


def fig17_cold_boot(root=None, device="cuda"):
    rows = [(f"fig17_mrc{n}", destruction_time_ns("mrc", n) / 1e3,
             f"speedup={speedup_over_rowclone('mrc', n):.2f}")
            for n in (2, 4, 8, 16, 32)]
    rows.append(("fig17_frac", destruction_time_ns("frac") / 1e3,
                 f"speedup={speedup_over_rowclone('frac'):.2f}"))
    rows.append(("fig17_rowclone", destruction_time_ns("rowclone") / 1e3,
                 "speedup=1.00"))
    return rows


# Fig 18 (extension): energy per execution mode ---------------------------

#: Fig 18's workloads: (name, op, operand bits, lanes).
FIG18_WORKLOADS = (("add32", "add", 32, 64), ("mul8", "mul", 8, 64))


def fig18_energy_modes(root=None, device="cuda"):
    """Energy per execution path (a Kill-Llama-style savings view).

    The same §8.1 programs (a 32-bit adder, an 8-bit multiplier) run
    through a ``cuda`` session's three executors (per op, fused, one
    megakernel launch); each row gives the energy the CostModel prices
    for that path's launches on the card (the H100's launch round trip
    at board power, plus its HBM traffic) and the dispatches, beside
    the DRAM-side energy of executing the identical program in situ
    under the Fig 5 power model.  Fusion amortizes launch energy as
    SiMRA amortizes activation energy (Obs 5 / PULSAR).
    """
    session = DramSession("cuda", ExecutionContext(device=device),
                          name="fig18")
    errors = ErrorModel("H")
    data = np.random.default_rng(0)
    rows = []
    for wl, op, nbits, lanes in FIG18_WORKLOADS:
        a = data.integers(0, 2**nbits, lanes, dtype=np.uint32)
        b = data.integers(0, 2**nbits, lanes, dtype=np.uint32)
        if op == "mul":
            a, b = a & 0xFF, b & 0xFF
        _, prog = session.elementwise(op, a, b, tier=5, n_act=32)
        state = np.zeros((prog.n_rows(), (lanes + 31) // 32), np.uint32)
        energies = {}
        for mode, run in (
                ("per_op", lambda: session.run(prog, state)),
                ("fused", lambda: session.run_fused(prog, state)),
                ("megakernel", lambda: session.run_fused(
                    prog, state, mode="megakernel"))):
            with session.count_dispatches() as scope:
                run()
            energies[mode] = scope.energy_nj
            rows.append((f"fig18_{wl}_{mode}", 0.0,
                         f"energy_nj={scope.energy_nj:.1f};"
                         f"dispatches={scope.count}"))
        pud_nj = prog.energy_nj(errors)
        rows.append((f"fig18_{wl}_pud_dram", 0.0, f"energy_nj={pud_nj:.1f}"))
        rows.append((f"fig18_{wl}_savings", 0.0,
                     f"fused_vs_per_op="
                     f"{energies['per_op'] / energies['fused']:.2f};"
                     f"mega_vs_per_op="
                     f"{energies['per_op'] / energies['megakernel']:.2f};"
                     f"pud_vs_per_op={energies['per_op'] / pud_nj:.2f}"))
    rows.append(("fig18_dispatch_energy_nj", 0.0,
                 f"per_launch={COST.dispatch_energy_nj(1):.1f}"))
    return rows


# Table 1/2: tested devices ------------------------------------------------


def table1_devices(root=None, device="cuda"):
    return [(f"table1_{mfr}_{rev}", 0.0,
             f"chips={d['chips']};density={d['density']};"
             f"subarrays={d['subarray_sizes']}")
            for (mfr, rev), d in cal.TABLE1.items()]


#: The figure functions in the reference printer's order.
FIGURES = (
    fig3_simra_timing,
    fig4_simra_temp_vpp,
    fig5_power,
    fig6_maj3_timing,
    fig6_cliff_adaptive,
    fig7_majx_patterns,
    fig8_majx_temperature,
    fig9_majx_voltage,
    fig10_mrc_timing,
    fig11_mrc_patterns,
    fig12_mrc_temp_vpp,
    fig15_spice_mc,
    fig16_microbench_speedups,
    fig17_cold_boot,
    fig18_energy_modes,
    table1_devices,
)
