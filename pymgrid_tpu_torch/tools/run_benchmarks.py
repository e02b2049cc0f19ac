#!/usr/bin/env python
"""Full-year control benchmarks over the pymgrid25 suite on the port.

Port of the repository's ``tools/run_benchmarks.py``, every mode but its
``--scaling`` speed modes (those belong to a benchmark of the port).  Modes:

* default: rule-based control (``RuleBasedControl.run_compiled``, float64)
  over each scenario's 8759 steps, and with ``--mpc`` the host MPC (numpy +
  HiGHS) -> ``RESULTS.md``;
* ``--mpc-suite``: ``SuiteMPC``, every scenario's planner and simulator in one
  batch, genset-free scenarios and genset scenarios as two groups with a
  resume sidecar per group -> ``RESULTS_CHIP.md``;
* ``--mpc-chip``: ``BatchedMPC`` per scenario without host fallback, the year
  in chunks of steps (the JAX tool's chunk rule) -> ``RESULTS_CHIP.md``.  The
  port's ``run_scanned`` stops at exactly the year's steps, where the JAX
  scan ran whole chunks past them when the chunk did not divide the year
  (ROADMAP.md, queue C, JAX fault 5);
* ``--saa``: ``BatchedSAA`` per scenario and forecast-accuracy preset, with
  ``np.random.seed(1000 + n)`` before each, as the JAX tool -> ``RESULTS_SAA.md``
  (:mod:`pymgrid_tpu_torch.tools.saa_report`).

The planners run in float32 on the card, RBC in float64 on the card; the
card is the default device and ``--device cpu`` takes the CPU (where the JAX
tool ran RBC and host MPC).  Reports and the config-stamped resume sidecars
go to ``--out``, by default ``pymgrid_tpu_torch/build/results/``; the
repository's own ``RESULTS*.md`` are only read, for the host-MPC anchor of
the Δ column.

Usage: python -m pymgrid_tpu_torch.tools.run_benchmarks [--mpc] [--scenarios 0,1,2]
"""
import argparse
import json
import re
import sys
import time
import warnings
from pathlib import Path

import numpy as np

from pymgrid_tpu_torch._device import resolve_device
from pymgrid_tpu_torch.tools.saa_report import REPO, RESULTS_DIR, write_report

__all__ = ["main", "run_rbc", "run_mpc_suite", "run_mpc_chip", "run_saa",
           "write_rbc_report", "parse_args"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mpc", action="store_true", help="also run host MPC (slow)")
    parser.add_argument("--tight-mpc", action="store_true",
                        help="use tight battery bounds in the MPC model")
    parser.add_argument("--scenarios", default=None)
    parser.add_argument("--out", default=RESULTS_DIR, type=Path,
                        help="directory of the reports and resume sidecars "
                             "(default: pymgrid_tpu_torch/build/results)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--saa", action="store_true",
                        help="run BatchedSAA over ALL 25 scenarios (genset "
                             "MILPs via on-device enumeration) for the three "
                             "published forecast-accuracy presets -> "
                             "RESULTS_SAA.md")
    parser.add_argument("--saa-samples", type=int, default=10)
    parser.add_argument("--saa-percentile", type=float, default=0.5)
    parser.add_argument("--saa-presets", default="85,70,50")
    parser.add_argument("--enum-bits", type=int, default=5,
                        help="genset MILP enumeration bits for the planners")
    parser.add_argument("--enum-chunk", type=int, default=16,
                        help="patterns per enumeration solve")
    parser.add_argument("--matmul-precision", default="float32",
                        choices=["bfloat16", "tensorfloat32", "float32"],
                        help="the planners' float32 LP matmuls: float32 keeps "
                             "TF32 off on the card; tensorfloat32 and bfloat16 "
                             "both allow TF32 (the card's nearest match to "
                             "fewer-pass matmuls); no effect on the CPU or in "
                             "float64")
    parser.add_argument("--ipm-iters", type=int, default=None,
                        help="IPM iterations of the planners' LP solves "
                             "(default 60 for --mpc-suite and --saa, the "
                             "planner's own 30 for --mpc-chip)")
    parser.add_argument("--newton-refine", type=int, default=None,
                        help="iterative-refinement rounds per Newton solve "
                             "(default 1 at f32; --mpc-suite and --saa "
                             "default to 2)")
    parser.add_argument("--tie-break-eps", type=float, default=None,
                        help="SuiteMPC flat-face tie-break ablation "
                             "(default off; see RESULTS_CHIP.md)")
    parser.add_argument("--scan-chunk", type=int, default=None,
                        help="engine steps per copy of the rewards to the host "
                             "(default: 4000 grid-only, 500 genset, halved per "
                             "enum_bits above 3; --mpc-suite 500 / 100)")
    parser.add_argument("--resume", action="store_true",
                        help="planner modes: skip scenarios already recorded "
                             "in the incremental sidecar")
    parser.add_argument("--mpc-chip", action="store_true",
                        help="the full-year MPC table on the card (BatchedMPC, "
                             "one run per scenario) -> RESULTS_CHIP.md")
    parser.add_argument("--mpc-suite", action="store_true",
                        help="the full-year MPC table on the card as ONE batch "
                             "over all scenarios (SuiteMPC) -> RESULTS_CHIP.md")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)        # no card: fail before any work
    args.out.mkdir(parents=True, exist_ok=True)
    if args.saa:
        return run_saa(args)
    if args.mpc_chip:
        return run_mpc_chip(args)
    if args.mpc_suite:
        return run_mpc_suite(args)
    return run_rbc(args)


def _scenarios(args):
    return ([int(s) for s in args.scenarios.split(",")] if args.scenarios
            else list(range(25)))


def _marker(tag):
    def mark(msg):
        print(f"[{tag} {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
    return mark


def run_rbc(args, n_steps=None):
    """RBC (and host MPC with ``--mpc``) per scenario over the year, or its
    first ``n_steps`` steps; writes ``RESULTS.md`` to ``--out`` and returns
    the rows ``(n, rbc_cost, rbc_s, mpc_cost, mpc_s)``."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import ModelPredictiveControl, RuleBasedControl

    rows = []
    for n in _scenarios(args):
        mg = Microgrid.from_scenario(n)
        t0 = time.time()
        log = RuleBasedControl(mg).run_compiled(max_steps=n_steps, device=args.device,
                                                dtype="float64")
        rbc_cost = -log[("balance", 0, "reward")].sum()
        rbc_time = time.time() - t0

        mpc_cost, mpc_time = None, None
        if args.mpc:
            t0 = time.time()
            mpc_log = ModelPredictiveControl(
                Microgrid.from_scenario(n), tight_battery_bounds=args.tight_mpc
            ).run(max_steps=n_steps)
            mpc_cost = -mpc_log[("balance", 0, "reward")].sum()
            mpc_time = time.time() - t0

        rows.append((n, rbc_cost, rbc_time, mpc_cost, mpc_time))
        msg = f"scenario {n}: RBC {rbc_cost:,.2f} ({rbc_time:.1f}s)"
        if mpc_cost is not None:
            msg += f"  MPC {mpc_cost:,.2f} ({mpc_time:.1f}s)"
        print(msg, flush=True)
    write_rbc_report(args.out / "RESULTS.md", rows, args.mpc, args.tight_mpc, args.device)
    return rows


def write_rbc_report(out, rows, mpc, tight_mpc, device):
    """The RBC (+ host MPC) cost table, as the JAX tool writes it."""
    lines = [
        "# RESULTS — pymgrid25 full-year control benchmarks (pymgrid_tpu_torch)",
        "",
        "Total annual operating cost (= negative cumulative balance reward) over",
        "8759 hourly steps per scenario.  RBC runs on the port's engine in",
        f"float64 on {_device_name(device)} (bitwise-equal to the host/reference",
        "simulation, see tests/test_torch_rollout.py); MPC uses perfect (oracle)",
        "forecasts with horizon 24, solved by HiGHS on the host"
        + (", with tight (simulator-true) battery bounds" if tight_mpc else
           " (reference-faithful battery bounds; see --tight-mpc)")
        + ".",
        "",
        "Note: the published `pymgrid 25 - benchmarks.xlsx` totals were produced",
        "by the *legacy nonmodular* pipeline and differ from the reference's own",
        "modular implementation; the correctness gate is exact parity with the",
        "reference modular implementation (ALL 25 scenarios' full-year RBC",
        "reward streams match recorded reference runs bit-for-bit —",
        "tests/test_torch_rollout.py, -m slow).",
        "",
        "| scenario | RBC cost | RBC s | MPC cost | MPC s |",
        "|---|---|---|---|---|",
    ]
    for n, rbc_cost, rbc_time, mpc_cost, mpc_time in rows:
        mpc_str = f"{mpc_cost:,.2f}" if mpc_cost is not None else "—"
        mpc_t = f"{mpc_time:.1f}" if mpc_time is not None else "—"
        lines.append(f"| {n} | {rbc_cost:,.2f} | {rbc_time:.1f} | {mpc_str} | {mpc_t} |")

    total_rbc = sum(r[1] for r in rows)
    lines.append(f"| **total** | **{total_rbc:,.2f}** | | " + (
        f"**{sum(r[3] for r in rows):,.2f}** | |"
        if mpc and all(r[3] is not None for r in rows) else "| |"
    ))
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")
    return out


def _device_name(device):
    import torch

    device = resolve_device(device)
    if device.type == "cuda":
        return f"the card ({torch.cuda.get_device_name(device)})"
    return "the CPU"


def _load_sidecar(sidecar, config, resume, mark):
    """Load a resume sidecar, refusing rows recorded under a different run
    configuration (silently mixing --enum-bits/--matmul-precision rows would
    corrupt a published table).  Returns the rows dict."""
    if not (resume and sidecar.exists()):
        return {}
    data = json.loads(sidecar.read_text())
    if "config" not in data:  # legacy schema: no config recorded
        raise SystemExit(
            f"{sidecar} predates config-stamped sidecars; delete it or rerun "
            f"without --resume."
        )
    if data["config"] != config:
        raise SystemExit(
            f"--resume refused: {sidecar} was recorded with config "
            f"{data['config']} but this run uses {config}.  Delete the "
            f"sidecar or rerun with matching flags."
        )
    mark(f"resuming: {sorted(data['rows'])} already recorded")
    return data["rows"]


def _save_sidecar(sidecar, config, rows):
    sidecar.write_text(json.dumps({"config": config, "rows": rows}))


def _newton_refine(args):
    return 2 if args.newton_refine is None else args.newton_refine


def run_saa(args, n_steps=None):
    """Full-year SAA on the card, every scenario, every preset.

    The published protocol (BASELINE.md rows 3-5): the SAA-85/70/50 labels
    are *forecast accuracy presets* (``preset_to_use``; reference
    ``Benchmarks.run_saa_benchmark``), optimal percentile 0.5.  Genset
    scenarios solve every sample's horizon MILP on the device.  ``n_steps``
    caps each run's steps."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import BatchedSAA

    warnings.filterwarnings("ignore")
    scenarios = _scenarios(args)
    presets = [int(p) for p in args.saa_presets.split(",")]
    pct = args.saa_percentile
    mark = _marker("saa")

    sidecar = args.out / "RESULTS_SAA.partial.json"
    config = {
        "enum_bits": args.enum_bits,
        "enum_chunk": args.enum_chunk,
        "matmul_precision": args.matmul_precision,
        "saa_samples": args.saa_samples,
        "saa_percentile": pct,
        "solver_kind": "box",
        "ipm_iters": args.ipm_iters or 60,
        "newton_refine": _newton_refine(args),
    }
    done = _load_sidecar(sidecar, config, args.resume, mark)

    for preset in presets:
        for n in scenarios:
            key = f"{n}:{preset}"
            if key in done:
                continue
            np.random.seed(1000 + n)  # sampler RNG, reproducible per scenario
            t0 = time.time()
            mark(f"scenario {n} preset {preset}: building BatchedSAA")
            saa = BatchedSAA(Microgrid.from_scenario(n), n_samples=args.saa_samples,
                             optimal_percentile=pct, preset_to_use=preset,
                             dtype="float32", device=args.device,
                             enum_bits=args.enum_bits, enum_chunk=args.enum_chunk,
                             iters=args.ipm_iters or 60,
                             newton_refine=_newton_refine(args), solver_kind="box",
                             matmul_precision=args.matmul_precision)
            mark(f"scenario {n} preset {preset}: running the year")
            rewards, _ = saa.run_scanned(n_steps)
            cost, dt = float(-rewards.sum()), time.time() - t0
            done[key] = [cost, len(rewards), dt]
            _save_sidecar(sidecar, config, done)
            print(f"scenario {n}: SAA-{preset} {cost:,.2f} "
                  f"({len(rewards)} steps, {dt:.1f}s)", flush=True)

    out = write_report(done, config, out=args.out / "RESULTS_SAA.md", results_dir=args.out)
    if args.scenarios is None:
        # full-table run complete; a --scenarios subset must keep the
        # sidecar (other scenarios' rows live there for later --resume)
        sidecar.unlink(missing_ok=True)
    return done, out


def run_mpc_chip(args, n_steps=None):
    """The full-year MPC table on the card: ``BatchedMPC`` per scenario,
    without host fallback.  ``n_steps`` caps each year."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import BatchedMPC

    warnings.filterwarnings("ignore")
    mark = _marker("card")
    sidecar = args.out / "RESULTS_CHIP.partial.json"
    config = {
        "enum_bits": args.enum_bits,
        "enum_chunk": args.enum_chunk,
        "matmul_precision": args.matmul_precision,
        "scan_chunk": args.scan_chunk,
    }
    done = {int(k): v for k, v in _load_sidecar(sidecar, config, args.resume, mark).items()}

    rows = []
    for n in _scenarios(args):
        if n in done:
            rows.append(tuple(done[n]))
            continue
        mg = Microgrid.from_scenario(n)
        steps = int(mg.final_step) - int(mg.initial_step)
        steps = steps if n_steps is None else min(steps, n_steps)
        t0 = time.time()
        mark(f"scenario {n}: building BatchedMPC template")
        bm = BatchedMPC(mg, batch_size=1, dtype="float32", device=args.device,
                        host_fallback=False, enum_bits=args.enum_bits,
                        enum_chunk=args.enum_chunk, matmul_precision=args.matmul_precision)
        # enumeration multiplies per-step work, so the chunk shrinks with
        # enum_bits (the JAX tool's rule, kept for comparable progress lines)
        if args.scan_chunk is not None:
            chunk = args.scan_chunk
        elif bm.template.has_genset:
            chunk = max(100, 500 >> max(0, args.enum_bits - 3))
        else:
            chunk = 4000
        mark(f"scenario {n}: running the year ({steps} steps, chunk {chunk})")
        rewards, _ = bm.run_scanned(steps, chunk=chunk)
        cost, dt = float(-rewards[:, 0].sum()), time.time() - t0
        rows.append((n, cost, steps, dt))
        done[n] = [n, cost, steps, dt]
        _save_sidecar(sidecar, config, {str(k): v for k, v in done.items()})
        print(f"scenario {n}: card MPC {cost:,.2f} ({steps} steps, {dt:.1f}s)", flush=True)

    out = _write_chip_report(rows, args.enum_bits, out=args.out / "RESULTS_CHIP.md")
    if args.scenarios is None:
        sidecar.unlink(missing_ok=True)  # full table written
    return rows, out


def run_mpc_suite(args, n_steps=None):
    """The all-scenario MPC table from one batch per group (``SuiteMPC``):
    genset-free scenarios, then genset scenarios.  ``n_steps`` caps the
    year.  Returns the rows ``(n, cost, steps, s)`` and the report's path."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import SuiteMPC
    from pymgrid_tpu_torch.modules import GensetModule

    warnings.filterwarnings("ignore")
    scenarios = _scenarios(args)
    mark = _marker("suite-mpc")
    t0 = time.time()
    mgs = {n: Microgrid.from_scenario(n) for n in scenarios}
    has_genset = {
        n: any(isinstance(m, GensetModule) for m in mg.modules.iterlist())
        for n, mg in mgs.items()
    }
    # genset-free scenarios run as their own group: no neutral-genset slot,
    # no MILP enumeration -> ~9x fewer LP solves per step for that group
    groups = [
        [n for n in scenarios if not has_genset[n]],
        [n for n in scenarios if has_genset[n]],
    ]
    # per-GROUP resume sidecar: groups are the atomic unit here
    sidecar = args.out / "RESULTS_CHIP.suite.partial.json"
    config = {
        "enum_bits": args.enum_bits,
        "enum_chunk": args.enum_chunk,
        "matmul_precision": args.matmul_precision,
        "ipm_iters": args.ipm_iters or 60,
        "newton_refine": _newton_refine(args),
        "scan_chunk": args.scan_chunk,
        "tie_break_eps": args.tie_break_eps,
    }
    done = _load_sidecar(sidecar, config, args.resume, mark)
    rows_by_n = {}
    for group in groups:
        if not group:
            continue
        gkey = ",".join(map(str, group))
        if gkey in done:
            for n, cost, steps, dt in done[gkey]:
                rows_by_n[n] = (n, cost, steps, dt)
            mark(f"group {group}: resumed from sidecar")
            continue
        mark(f"building SuiteMPC group {group} (enum_bits={args.enum_bits})")
        g0 = time.time()
        suite = SuiteMPC([mgs[n] for n in group], dtype="float32", device=args.device,
                         enum_bits=args.enum_bits, enum_chunk=args.enum_chunk,
                         iters=args.ipm_iters or 60, newton_refine=_newton_refine(args),
                         matmul_precision=args.matmul_precision,
                         tie_break_eps=args.tie_break_eps)
        chunk = args.scan_chunk if args.scan_chunk is not None else (
            500 if not suite.include_genset else 100)
        steps = suite.n_steps_year if n_steps is None else min(n_steps, suite.n_steps_year)
        mark(f"group of {len(group)}: running the year ({steps} steps, chunk {chunk})")
        rewards, _ = suite.run_scanned(steps, chunk=chunk, progress=mark)
        gwall = time.time() - g0
        costs = -rewards.sum(axis=0)
        for i, n in enumerate(group):
            rows_by_n[n] = (n, float(costs[i]), rewards.shape[0], gwall / len(group))
            print(f"scenario {n}: suite-MPC {float(costs[i]):,.2f} "
                  f"({rewards.shape[0]} steps)", flush=True)
        done[gkey] = [list(rows_by_n[n]) for n in group]
        _save_sidecar(sidecar, config, done)
        mark(f"group wall {gwall:.1f}s for {len(group)} scenario-years")
    wall = time.time() - t0
    rows = [rows_by_n[n] for n in scenarios]
    mark(f"total wall {wall:.1f}s for {len(scenarios)} scenario-years "
         f"({wall / len(scenarios):.1f}s/scenario amortized)")
    out = _write_chip_report(
        rows, args.enum_bits, out=args.out / "RESULTS_CHIP.md",
        extra_note=(
            f"Generated by `--mpc-suite`: ONE batch per group runs every "
            f"scenario's planner+simulator together (heterogeneous batched "
            f"IPM, `pymgrid_tpu_torch/algos/mpc_suite.py`); total wall "
            f"{wall:.1f} s for {len(scenarios)} scenario-years — the s "
            f"column is amortized."
        ),
    )
    if args.scenarios is None:
        sidecar.unlink(missing_ok=True)
    return rows, out


def _write_chip_report(rows, enum_bits, out, extra_note=None):
    """Write the card's MPC table from (scenario, cost, steps, dt) rows to
    ``out``, with measured deltas against the host f64 table (the
    repository's ``RESULTS.md``, read only)."""
    # host f64 HiGHS MPC costs (same formulation) for the measured-delta
    # columns; parsed from RESULTS.md rather than restated by hand
    host_costs = {}
    results_md = REPO / "RESULTS.md"
    if results_md.exists():
        for line in results_md.read_text().splitlines():
            m = re.match(
                r"\|\s*(\d+)\s*\|\s*[\d,.]+\s*\|\s*[\d.]+\s*\|"
                r"\s*([\d,.]+)\s*\|", line)
            if m:
                host_costs[int(m.group(1))] = float(m.group(2).replace(",", ""))

    deltas = {n: cost / host_costs[n] - 1.0
              for n, cost, _, _ in rows if n in host_costs}
    out = Path(out)
    header = [
        "# RESULTS — MPC full-year costs on the card (pymgrid_tpu_torch, float32, "
        f"enum_bits={enum_bits})",
        "",
        "BatchedMPC: the horizon problem (LP; genset scenarios a MILP via",
        "an LP relaxation + batched status-pattern enumeration) solves on",
        "the card and the first-step control feeds the port's engine; the",
        "rewards come back to the host once per chunk of steps.  Compare the",
        "wall-clock to the host HiGHS pipeline's 45-445 s/scenario",
        "(RESULTS.md).  The Δ column is measured against the float64 host",
        "HiGHS table (the repository's RESULTS.md, same formulation; f64",
        "parity with host HiGHS is gated at 1e-4 in chip_smoke.py's planners).",
    ]
    if extra_note:
        header += ["", extra_note]
    if deltas:
        total_chip = sum(cost for n, cost, _, _ in rows if n in host_costs)
        total_host = sum(host_costs[n] for n, *_ in rows if n in host_costs)
        sorted_d = sorted(abs(d) for d in deltas.values())
        median_d = sorted_d[len(sorted_d) // 2]
        worst_n, worst_d = max(deltas.items(), key=lambda kv: abs(kv[1]))
        header += [
            "",
            f"Measured this run: total {total_chip:,.1f} vs host "
            f"{total_host:,.1f} (**{total_chip / total_host - 1.0:+.2%}**); "
            f"median per-scenario |Δ| {median_d:.2%}; worst scenario "
            f"{worst_n} at {worst_d:+.2%}.",
        ]
    lines = header + [
        "",
        "| scenario | card MPC cost | host f64 MPC | Δ | steps | s |",
        "|---|---|---|---|---|---|",
    ]
    for n, cost, steps, dt in rows:
        host = f"{host_costs[n]:,.2f}" if n in host_costs else "—"
        d = f"{deltas[n]:+.2%}" if n in deltas else "—"
        lines.append(f"| {n} | {cost:,.2f} | {host} | {d} | {steps} | {dt:.1f} |")
    if deltas:
        # card total over the SAME host-matched subset as total_host/Δ
        unmatched = [n for n, *_ in rows if n not in host_costs]
        lines.append(f"| **total (matched)** | **{total_chip:,.2f}** | "
                     f"**{total_host:,.2f}** | "
                     f"**{total_chip / total_host - 1.0:+.2%}** | | |")
        if unmatched:
            lines.append(
                f"| total (all rows) | {sum(r[1] for r in rows):,.2f} "
                f"| — | — | | |")
            lines.append("")
            lines.append(f"Scenarios without a host anchor in RESULTS.md: "
                         f"{unmatched}.")
    else:
        lines.append(f"| **total** | **{sum(r[1] for r in rows):,.2f}** "
                     f"| | | | |")
    # keep any hand-written analysis section across regenerations
    if out.exists():
        m = re.search(r"^## Quality analysis.*", out.read_text(),
                      re.S | re.M)
        if m:
            lines += ["", m.group(0).rstrip()]
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
