#!/usr/bin/env python
"""Full-year legacy-pipeline benchmarks vs the published xlsx totals, on the
port's host layer.

Port of the repository's ``tools/run_legacy_benchmarks.py``.  The published
baselines (``pymgrid 25 - benchmarks.xlsx``, BASELINE.md) were produced by
the *legacy nonmodular* pipeline (``_deprecated/non_modular_microgrid.py`` +
``algos/Control.py:233``).  This tool runs the port's copy of that pipeline
end to end on the canonical pymgrid25 scenarios:

    Microgrid.from_scenario(n).to_nonmodular()  ->  legacy RBC + legacy MPC
    over the full 8736-step year, per scenario,

and writes ``RESULTS_LEGACY.md`` (in ``--out``, by default
``pymgrid_tpu_torch/build/results/``) with per-scenario costs next to the
published rows.  The pipeline is numpy and HiGHS on the host: it has no
device work.

The published rows come from the xlsx of the upstream pymgrid checkout when
it is mounted, and otherwise from the xlsx columns of the repository's
``RESULTS_LEGACY.md`` table (read only); the report names its source.  The
checkout is the one the repository's tests import the reference from
(``tests/helpers/reference.py``: ``PYMGRID_REFERENCE_SRC`` names its
``src``), so where the checkout of this repository lies does not matter.
``--ref-check a,b,c`` additionally runs the reference's own legacy
RuleBasedControl and ModelPredictiveControl in-process (cvxpy shim) on the
same nonmodular objects and reports the difference; it needs that checkout.

Usage:
    python -m pymgrid_tpu_torch.tools.run_legacy_benchmarks          # all 25, RBC+MPC
    python -m pymgrid_tpu_torch.tools.run_legacy_benchmarks --scenarios 0,1
"""
import argparse
import contextlib
import io
import re
import sys
import time
import warnings
import xml.etree.ElementTree as ET
import zipfile
from pathlib import Path

import numpy as np

from pymgrid_tpu_torch.tools.saa_report import REPO, RESULTS_DIR

__all__ = ["reference_helper", "xlsx_path", "read_xlsx_baselines", "nonmodular_scenario",
           "run_ours", "write_report", "main"]

PUBLISHED = REPO / "RESULTS_LEGACY.md"

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def reference_helper():
    """The repository's ``tests/helpers/reference.py``: the one place that
    locates the upstream checkout (``REFERENCE_SRC``), checks it
    (``reference_available``) and imports it (``import_reference``)."""
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from helpers import reference

    return reference


def xlsx_path():
    """The published xlsx in the upstream checkout (the parent of its ``src``)."""
    return Path(reference_helper().REFERENCE_SRC).parent / "pymgrid 25 - benchmarks.xlsx"


def read_xlsx_baselines(path=None, fallback=PUBLISHED):
    """Per-scenario published costs ``{n: {"rbc":, "mpc":, ...}}`` and their
    source: the xlsx at ``path`` (default :func:`xlsx_path`; with the SAA
    columns) when it exists, else the xlsx RBC and MPC columns of the table
    in ``fallback``."""
    path = xlsx_path() if path is None else Path(path)
    if not path.exists():
        return _published_table(fallback), f"the xlsx columns of {Path(fallback).name}"
    z = zipfile.ZipFile(path)
    shared = [
        el.findtext(".//m:t", namespaces=_NS, default="")
        for el in ET.fromstring(z.read("xl/sharedStrings.xml")).findall("m:si", _NS)
    ]
    sheet = ET.fromstring(z.read("xl/worksheets/sheet1.xml"))
    cells = {}
    for c in sheet.iter("{%s}c" % _NS["m"]):
        v = c.findtext("m:v", namespaces=_NS)
        if v is None:
            continue
        cells[c.attrib["r"]] = shared[int(v)] if c.attrib.get("t") == "s" else v

    out = {}
    for row in range(2, 27):  # scenarios 0..24 live on sheet rows 2..26
        n = int(cells[f"A{row}"])
        out[n] = {
            "rbc": float(cells[f"AG{row}"]),
            "mpc": float(cells[f"AH{row}"]),
            "saa85": float(cells[f"AI{row}"]),
            "saa70": float(cells[f"AJ{row}"]),
            "saa50": float(cells[f"AK{row}"]),
        }
    return out, path.name


def _published_table(path):
    """The xlsx RBC and MPC columns of a legacy report's cost table
    (``| n | legacy RBC | xlsx RBC | ratio | legacy MPC | xlsx MPC | ratio |``)."""
    num = r"\s*([\d,.]+)\s*"
    row = re.compile(rf"^\|\s*(\d+)\s*\|{num}\|{num}\|{num}\|{num}\|{num}\|{num}\|\s*$")
    out = {}
    for line in Path(path).read_text().splitlines():
        m = row.match(line)
        if m and int(m.group(1)) not in out:
            value = lambda i: float(m.group(i).replace(",", ""))  # noqa: E731
            out[int(m.group(1))] = {"rbc": value(3), "mpc": value(6)}
    return out


def total_cost(control_output):
    return float(np.nansum(control_output["cost"]["total_cost"]))


def nonmodular_scenario(n):
    from pymgrid_tpu_torch import Microgrid

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Microgrid.from_scenario(n).to_nonmodular()


def run_ours(nm, n_steps=None):
    """Legacy RBC and MPC totals on ``nm`` with their seconds; ``n_steps``
    caps both runs."""
    from pymgrid_tpu_torch.algos.mpc import ModelPredictiveControl
    from pymgrid_tpu_torch.algos.nonmodular_rbc import NonModularRuleBasedControl

    t0 = time.time()
    rbc = total_cost(NonModularRuleBasedControl(nm).run_rule_based(length=n_steps))
    t1 = time.time()
    # raw (tie-laden) costs: the reference's exact formulation, so the
    # ref-check rows compare at the solver-vertex level
    mpc = total_cost(ModelPredictiveControl(nm, tie_break_eps=0).run(max_steps=n_steps))
    t2 = time.time()
    return rbc, t1 - t0, mpc, t2 - t1


def run_reference(nm):
    """The reference's own legacy pipeline, in-process (cvxpy shim)."""
    reference_helper().import_reference()
    from pymgrid.algos import ModelPredictiveControl as RefMPC
    from pymgrid.algos.rbc._nonmodular_rbc import NonModularRuleBasedControl as RefRBC

    sink = io.StringIO()
    with contextlib.redirect_stdout(sink):
        rbc = total_cost(RefRBC(nm).run_rule_based())
        mpc = total_cost(RefMPC(nm).run())
    return rbc, mpc


def main(argv=None, n_steps=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scenarios", default=None,
                        help="comma-separated scenario ids (default: all 25)")
    parser.add_argument("--ref-check", default=None,
                        help="scenario ids to ALSO run through the reference's "
                             "own legacy algorithms in-process")
    parser.add_argument("--out", default=RESULTS_DIR, type=Path,
                        help="directory of the report (default: "
                             "pymgrid_tpu_torch/build/results)")
    args = parser.parse_args(argv)

    scenarios = (
        [int(s) for s in args.scenarios.split(",")]
        if args.scenarios else list(range(25))
    )
    ref_check = (
        [int(s) for s in args.ref_check.split(",")] if args.ref_check else []
    )
    helper = reference_helper()
    if ref_check and not helper.reference_available():
        raise SystemExit(f"--ref-check runs the reference's own legacy code: it needs "
                         f"the upstream pymgrid checkout's source at "
                         f"{helper.REFERENCE_SRC} (PYMGRID_REFERENCE_SRC), which is absent")

    xlsx, source = read_xlsx_baselines()
    rows, ref_rows = [], []
    for n in scenarios:
        nm = nonmodular_scenario(n)
        rbc, rbc_s, mpc, mpc_s = run_ours(nm, n_steps)
        rows.append((n, rbc, rbc_s, mpc, mpc_s, xlsx[n]["rbc"], xlsx[n]["mpc"]))
        print(f"scenario {n}: RBC {rbc:,.2f} ({rbc_s:.0f}s)  MPC {mpc:,.2f} "
              f"({mpc_s:.0f}s)  xlsx RBC {xlsx[n]['rbc']:,.2f} "
              f"MPC {xlsx[n]['mpc']:,.2f}", flush=True)
        if n in ref_check:
            ref_rbc, ref_mpc = run_reference(nm)
            ref_rows.append((n, rbc, ref_rbc, mpc, ref_mpc))
            print(f"  ref-check {n}: ref RBC {ref_rbc:,.2f} ref MPC {ref_mpc:,.2f}",
                  flush=True)

    args.out.mkdir(parents=True, exist_ok=True)
    out = args.out / "RESULTS_LEGACY.md"
    write_report(out, rows, ref_rows, source)
    print(f"wrote {out}")
    return rows, out


def write_report(path, rows, ref_rows, source):
    ours_rbc = sum(r[1] for r in rows)
    ours_mpc = sum(r[3] for r in rows)
    xlsx_rbc = sum(r[5] for r in rows)
    xlsx_mpc = sum(r[6] for r in rows)

    lines = [
        "# RESULTS — legacy nonmodular pipeline (pymgrid_tpu_torch), full-year, "
        "vs published xlsx",
        "",
        "Pipeline: `Microgrid.from_scenario(n).to_nonmodular()` -> legacy",
        "`NonModularRuleBasedControl.run_rule_based()` and legacy",
        "`ModelPredictiveControl.run()` (nonmodular path, HiGHS), 8736 hourly",
        "steps each, on the port's numpy host layer — the regime the published",
        "`pymgrid 25 - benchmarks.xlsx` totals live in (reference",
        "`algos/Control.py:233`, `_deprecated/non_modular_microgrid.py:607-669`).",
        "",
        f"Published rows read from: {source}.",
        "",
        "Why the xlsx totals are not reproducible from the packaged data (the",
        "published series and tariffs differ from the packaged ones), and the",
        "sign convention of the reference's `to_nonmodular` load series, are",
        "set out in the repository's RESULTS_LEGACY.md.",
        "",
        "## Full-year legacy costs vs xlsx",
        "",
        "| scenario | legacy RBC | xlsx RBC | ratio | legacy MPC | xlsx MPC | ratio |",
        "|---|---|---|---|---|---|---|",
    ]
    for n, rbc, _, mpc, _, xr, xm in rows:
        lines.append(
            f"| {n} | {rbc:,.2f} | {xr:,.2f} | {rbc / xr:.2f} | "
            f"{mpc:,.2f} | {xm:,.2f} | {mpc / xm:.2f} |"
        )
    lines += [
        f"| **total** | **{ours_rbc:,.2f}** | **{xlsx_rbc:,.2f}** | "
        f"{ours_rbc / xlsx_rbc:.2f} | **{ours_mpc:,.2f}** | "
        f"**{xlsx_mpc:,.2f}** | {ours_mpc / xlsx_mpc:.2f} |",
        "",
    ]
    if ref_rows:
        lines += [
            "## Pipeline fidelity: ours vs the reference's own legacy code",
            "",
            "Same nonmodular objects, full year, reference algorithms running",
            "in-process under the cvxpy shim:",
            "",
            "| scenario | our RBC | ref RBC | diff | our MPC | ref MPC | diff |",
            "|---|---|---|---|---|---|---|",
        ]
        for n, rbc, ref_rbc, mpc, ref_mpc in ref_rows:
            lines.append(
                f"| {n} | {rbc:,.2f} | {ref_rbc:,.2f} | {abs(rbc - ref_rbc):.2e} | "
                f"{mpc:,.2f} | {ref_mpc:,.2f} | {abs(mpc - ref_mpc):.2e} |"
            )
        lines.append("")
    lines += [
        "Regenerate: `python -m pymgrid_tpu_torch.tools.run_legacy_benchmarks "
        "[--scenarios a,b] [--ref-check a,b]`.",
        "",
    ]
    Path(path).write_text("\n".join(lines))


if __name__ == "__main__":
    main()
