#!/usr/bin/env python
"""Write the card's SAA table from the incremental sidecar, with anchor columns.

Port of the repository's ``tools/saa_report.py``.  The full-year SAA table
runs scenario by scenario on the card and its sidecar
(``RESULTS_SAA.partial.json`` in the results directory) survives an
interrupted run; this writer turns whatever has completed into the table,
adding the two independent anchors per scenario:

* the card's deterministic-MPC realized cost (``RESULTS_CHIP.md`` in the
  same results directory, written by ``run_benchmarks --mpc-chip`` or
  ``--mpc-suite``) — SAA plans with sampled futures incl. Markov-resampled
  outages, so on weak-grid scenarios it can realize far BELOW the
  deterministic planner (which assumes an always-up grid, reference
  mpc.py:914);
* the host f64 RBC realized cost (the repository's ``RESULTS.md``, read only).

Usage: python -m pymgrid_tpu_torch.tools.saa_report
"""
import json
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RESULTS_DIR = Path(__file__).resolve().parents[1] / "build" / "results"

__all__ = ["REPO", "RESULTS_DIR", "XLSX_TOTALS", "parse_costs", "write_report"]


def parse_costs(path, pattern):
    out = {}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        m = re.match(pattern, line)
        if m:
            out[int(m.group(1))] = float(m.group(2).replace(",", ""))
    return out


# reference publication totals (`pymgrid 25 - benchmarks.xlsx` sheet1,
# reproduced in BASELINE.md rows 3-5).  Produced by the LEGACY nonmodular
# pipeline with the reference's own samplers — comparable in protocol, not
# bitwise (see RESULTS.md provenance note).
XLSX_TOTALS = {85: 386_439_473.88, 70: 386_244_383.30, 50: 386_103_432.28}


def write_report(rows, cfg, out=None, results_dir=RESULTS_DIR):
    """Write the anchored SAA table from ``rows`` ({"n:preset": [cost,
    steps, dt]}) and ``cfg`` (the run's config stamp) to ``out`` (default
    ``RESULTS_SAA.md`` in ``results_dir``, which also holds the card's
    deterministic-MPC anchor table)."""
    results_dir = Path(results_dir)
    chip_mpc = parse_costs(
        results_dir / "RESULTS_CHIP.md", r"\|\s*(\d+)\s*\|\s*([\d,.]+)\s*\|"
    )
    host_rbc = parse_costs(
        REPO / "RESULTS.md", r"\|\s*(\d+)\s*\|\s*([\d,.]+)\s*\|"
    )

    by_scen = {}
    for key, (cost, steps, dt) in rows.items():
        n, preset = key.split(":")
        by_scen.setdefault(int(n), {})[int(preset)] = (cost, steps, dt)

    # the SAA-85/70/50 forecast-accuracy presets are INERT in reference
    # v1.2.2: the preset only shifts the returned PV forecast, never the
    # sampled futures, so trajectories are bit-identical across presets
    # (docs/parity.md #10).  Every scenario re-run under a second preset
    # must match.
    confirmations = []
    for n, d in sorted(by_scen.items()):
        if len(d) > 1:
            costs = [c for c, _, _ in d.values()]
            if max(costs) - min(costs) > 0.011:
                raise ValueError(
                    f"scenario {n}: presets differ {d} — the inertness "
                    f"documented in docs/parity.md #10 no longer holds"
                )
            confirmations.append(n)

    lines = [
        "# RESULTS — stochastic MPC (SAA) full-year costs on the card",
        "",
        f"BatchedSAA (box-IPM solver, iters={cfg['ipm_iters']}, "
        f"newton_refine={cfg['newton_refine']}, enum_bits={cfg['enum_bits']}, "
        f"n_samples={cfg['saa_samples']}, percentile "
        f"{cfg['saa_percentile']}), float32 on the card (pymgrid_tpu_torch), "
        "rewards copied to the host once per chunk of steps.  Sampled futures "
        "come from the package's seeded samplers (Markov-resampled outages "
        "included), so totals are comparable to, not bitwise reproductions "
        "of, the published xlsx (see RESULTS.md provenance notes).",
        "",
        "Anchor columns: the card's deterministic-MPC realized cost "
        "(RESULTS_CHIP.md beside this table) and the host f64 RBC cost "
        "(the repository's RESULTS.md).  On "
        "weak-grid scenarios SAA realizes far BELOW deterministic MPC: its "
        "sampled futures include outages, so the planner commits the "
        "genset defensively, while the deterministic formulation plans "
        "against an always-up grid (reference mpc.py:914) and realizes "
        "loss-load during real outages — the same effect the learned RL "
        "policy exploits (RESULTS_TRAINING.md).",
        "",
        "| scenario | SAA cost (presets 85/70/50 identical) "
        "| card det-MPC | host RBC | s/run |",
        "|---|---|---|---|---|",
    ]
    total = 0.0
    for n in sorted(by_scen):
        d = by_scen[n]
        cost, steps, dt = next(iter(d.values()))
        total += cost
        mpc = f"{chip_mpc[n]:,.2f}" if n in chip_mpc else "—"
        rbc = f"{host_rbc[n]:,.2f}" if n in host_rbc else "—"
        lines.append(f"| {n} | {cost:,.2f} | {mpc} | {rbc} | {dt:.1f} |")
    lines.append(f"| **total ({len(by_scen)} scenarios)** | "
                 f"**{total:,.2f}** | | | |")
    lines += [
        "",
        "Reference publication totals for the same protocol "
        "(`pymgrid 25 - benchmarks.xlsx` sheet1, BASELINE.md rows 3-5): "
        f"SAA-85 {XLSX_TOTALS[85]:,.2f}, SAA-70 {XLSX_TOTALS[70]:,.2f}, "
        f"SAA-50 {XLSX_TOTALS[50]:,.2f}.  Those totals came from the "
        "reference's LEGACY nonmodular pipeline; its own modular "
        "implementation (which this package matches bitwise on RBC, "
        "tests/test_golden_year.py) realizes very different absolute costs "
        "on several scenarios — see RESULTS.md's provenance note.",
        "",
        "**The three presets are one benchmark, not three.**  In reference "
        "v1.2.2 the preset only alters the *returned* PV forecast, never "
        "the sampled futures, so SAA-85/70/50 trajectories are "
        "bit-identical under a fixed seed (docs/parity.md #10; the xlsx "
        "presets differ by ~0.05% — RNG re-runs, not a preset effect)."
        + (
            f"  Confirmed on the card: scenarios {confirmations} were re-run "
            f"under a second preset and realized identical costs to the "
            f"cent."
            if confirmations else ""
        ),
    ]
    missing = sorted(set(range(25)) - set(by_scen))
    if missing:
        lines += [
            "",
            f"Scenarios not yet captured (resume with "
            f"`python -m pymgrid_tpu_torch.tools.run_benchmarks --saa --resume`): "
            f"{missing}.",
        ]
    out = Path(out) if out is not None else results_dir / "RESULTS_SAA.md"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out} ({len(by_scen)} scenarios)")
    return out


def main():
    data = json.loads((RESULTS_DIR / "RESULTS_SAA.partial.json").read_text())
    write_report(data["rows"], data["config"])


if __name__ == "__main__":
    main()
