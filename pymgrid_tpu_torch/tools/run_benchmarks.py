#!/usr/bin/env python
"""Full-year control benchmarks over the pymgrid25 suite on the port.

Port of the repository's ``tools/run_benchmarks.py``, every mode.  Modes:

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
  (:mod:`pymgrid_tpu_torch.tools.saa_report`);
* ``--scaling``: the suite's throughput (float32, randomized starts, the
  marginal-cost policy, best of 3) with its configs sharded over N ranks of
  one ``torch.distributed`` job, a fresh job of ``--scaling-worker`` ranks
  per point: gloo at N = 1, 2, 4, 8 with ``--device cpu`` (each rank
  ``os.cpu_count() // N`` threads), NCCL with one card per rank at the N
  the host's cards allow -> ``RESULTS_SCALING.md``;
* ``--scaling-chip``: the same rollout over all 25 scenarios in one process
  as the replicas per scenario grow (256 to 20480) -> ``RESULTS_SCALING.md``,
  keeping the other mode's section of the report in ``--out``.

The planners run in float32 on the card, RBC in float64 on the card; the
card is the default device and ``--device cpu`` takes the CPU (where the JAX
tool ran RBC and host MPC).  Reports and the config-stamped resume sidecars
go to ``--out``, by default ``pymgrid_tpu_torch/build/results/``; the
repository's own ``RESULTS*.md`` are only read, for the host-MPC anchor of
the Δ column (its ``RESULTS_SCALING.md``, a record of TPU runs, not even
that).

Usage: python -m pymgrid_tpu_torch.tools.run_benchmarks [--mpc] [--scenarios 0,1,2]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import textwrap
import time
import warnings
from pathlib import Path

import numpy as np

from pymgrid_tpu_torch._device import resolve_device
from pymgrid_tpu_torch.tools.saa_report import REPO, RESULTS_DIR, write_report

__all__ = ["main", "run_rbc", "run_mpc_suite", "run_mpc_chip", "run_saa",
           "write_rbc_report", "parse_args", "suite_throughput", "scaling_worker",
           "run_scaling", "write_scaling_report"]

SCALING_WORLD_SIZES = (1, 2, 4, 8)         # --scaling's points (ranks per job)
CHIP_CONFIGS = 25                          # --scaling-chip: every pymgrid25 scenario
CHIP_REPLICAS = (256, 1024, 4096, 8192, 20480)
SCALING_TIMEOUT_S = 900                    # one --scaling job, from spawn to exit


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
    parser.add_argument("--scaling", action="store_true",
                        help="suite env-steps/s with the configs sharded over "
                             "1/2/4/8 ranks (gloo on the CPU; NCCL, one card "
                             "per rank, as many as the host has), a fresh job "
                             "per point -> RESULTS_SCALING.md")
    parser.add_argument("--scaling-chip", action="store_true",
                        help="batch-size sweep of the suite throughput on the "
                             "device; updates RESULTS_SCALING.md in --out")
    parser.add_argument("--scaling-worker", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--scaling-configs", type=int, default=8)
    parser.add_argument("--scaling-replicas", type=int, default=256)
    parser.add_argument("--scaling-steps", type=int, default=200)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)        # no card: fail before any work
    args.out.mkdir(parents=True, exist_ok=True)
    if args.scaling_worker is not None:
        return scaling_worker(args)
    if args.scaling or args.scaling_chip:
        return run_scaling(args)
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


def suite_throughput(n_configs, replicas, n_steps, device="cuda", mesh=None, repeats=3,
                     seed=0, mark=None):
    """Best-of-``repeats`` wall clock of the suite rollout over the first
    ``n_configs`` pymgrid25 scenarios x ``replicas``: float32, the
    marginal-cost policy, auto-reset, randomized per-replica starts drawn
    from ``make_keys(seed)`` in JAX's int32 draw (the JAX tool's
    ``--scaling`` modes run without ``jax_enable_x64``), the block-prefetch
    path when ``n_steps`` is a multiple of 8: ``bench.build_suite_rollout``.
    Returns ``(env_steps_per_sec, out)``, ``out`` the last run's ``(C, B)``
    checksums on the device (this rank's rows with a ``mesh``).

    After one untimed run, each run is timed from a device synchronize to
    its checksums on the host, so no work can be skipped.  With a ``mesh``
    the ranks start each run together and a run lasts until its slowest
    rank is done.  ``mark(message)``, when given, hears of the untimed run's
    end and of each timed run's seconds."""
    from pymgrid_tpu_torch.tools.bench import build_suite_rollout
    from pymgrid_tpu_torch.utils.profiling import _sync

    device = resolve_device(device if mesh is None else mesh.device)
    fn, params, keys = build_suite_rollout(n_configs, replicas, n_steps, "float32", device,
                                           mesh, seed)
    fn(params, keys).cpu()
    if mark is not None:
        mark("untimed run done; timing")
    seconds = []
    for r in range(repeats):
        _all_ranks_max(mesh, [0.0])            # the ranks start together
        _sync(device)
        t0 = time.perf_counter()
        out = fn(params, keys)
        out.cpu()
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        if mark is not None:
            mark(f"repeat {r}: {seconds[-1]:.2f}s")
    return n_configs * replicas * n_steps / min(_all_ranks_max(mesh, seconds)), out


def _all_ranks_max(mesh, values):
    """``values`` (floats) maxed elementwise over the mesh's ranks; as they
    are without a process group."""
    import torch
    import torch.distributed as torch_dist

    if mesh is None or not torch_dist.is_initialized():
        return values
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    torch_dist.all_reduce(t, op=torch_dist.ReduceOp.MAX)
    return t.tolist()


def _threads_per_rank(n):
    return max(1, (os.cpu_count() or 1) // n)


def scaling_worker(args):
    """One rank of a ``--scaling`` job of ``--scaling-worker N`` ranks (its
    coordinator, rank and world size in ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``): joins the job, measures
    :func:`suite_throughput` with the configs sharded over the ranks, and
    gathers the checksums.  Rank 0 writes them to ``--out`` as
    ``scaling-N.npy`` and prints one JSON line, ``{"devices": N,
    "env_steps_per_sec": ...}``.  Returns ``(env_steps_per_sec, checksums)``."""
    import torch
    import torch.distributed as torch_dist

    from pymgrid_tpu_torch.parallel import distributed as dist

    n, rank = args.scaling_worker, int(os.environ["RANK"])
    if resolve_device(args.device).type == "cpu":
        torch.set_num_threads(_threads_per_rank(n))
    dist.initialize(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", n, rank,
                    device=args.device)
    try:
        mesh = dist.global_batch_mesh(args.device)
        sps, out = suite_throughput(args.scaling_configs, args.scaling_replicas,
                                    args.scaling_steps, mesh=mesh)
        checksums = dist.fetch(out)
    finally:
        torch_dist.destroy_process_group()
    if rank == 0:
        np.save(args.out / f"scaling-{n}.npy", checksums)
        print(json.dumps({"devices": n, "env_steps_per_sec": sps}), flush=True)
    return sps, checksums


def _run_ranks(jobs, timeout):
    """Run one process per ``(cmd, env)`` of ``jobs`` and wait for all of
    them, ``timeout`` seconds in all; returns each one's stdout.  When one
    fails, or the time runs out, every process still running is killed and
    ``RuntimeError`` names the failed (or first unfinished) process with
    the tail of its stderr."""
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in jobs]
    procs = []
    try:
        for (cmd, env), (out, err) in zip(jobs, files):
            procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((i for i, code in enumerate(codes) if code), None)
            if failed is not None:
                why = f"exited with code {codes[failed]}"
                break
            if all(code == 0 for code in codes):
                return [_read(out) for out, _ in files]
            if time.monotonic() > deadline:
                failed, why = codes.index(None), f"did not finish within {timeout} s"
                break
            time.sleep(0.1)
        raise RuntimeError(f"process {failed} of {len(jobs)} {why}:\n"
                           f"{_read(files[failed][1])[-2000:]}")
    finally:
        _kill(procs)
        for out, err in files:
            out.close()
            err.close()


def _read(f):
    f.seek(0)
    return f.read()


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _scaling_job(n, args):
    """One ``--scaling`` point: a job of ``n`` ranks of ``--scaling-worker
    n`` on ``127.0.0.1`` and a free port.  Returns rank 0's JSON row, with
    the gathered checksums under ``"checksums"``."""
    from pymgrid_tpu_torch.parallel.distributed import free_port

    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(n),
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO),
                                                       os.environ.get("PYTHONPATH")]))}
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "pymgrid_tpu_torch.tools.run_benchmarks",
               "--scaling-worker", str(n), "--device", args.device, "--out", tmp,
               "--scaling-configs", str(args.scaling_configs),
               "--scaling-replicas", str(args.scaling_replicas),
               "--scaling-steps", str(args.scaling_steps)]
        stdout = _run_ranks([(cmd, {**env, "RANK": str(r)}) for r in range(n)],
                            SCALING_TIMEOUT_S)
        row = json.loads(stdout[0].strip().splitlines()[-1])
        row["checksums"] = np.load(Path(tmp) / f"scaling-{n}.npy")
    return row


def _world_sizes(device):
    """The points of ``--scaling``: every one of :data:`SCALING_WORLD_SIZES`
    on the CPU; on CUDA those the host's cards hold, one rank per card
    (NCCL cannot put two ranks on one card)."""
    import torch

    if device.type == "cpu":
        return SCALING_WORLD_SIZES
    return tuple(n for n in SCALING_WORLD_SIZES if n <= torch.cuda.device_count())


def run_scaling(args):
    """``--scaling`` and ``--scaling-chip`` -> ``RESULTS_SCALING.md`` in
    ``--out``.

    ``--scaling``: :func:`suite_throughput` (``--scaling-configs`` x
    ``--scaling-replicas`` x ``--scaling-steps``) sharded over the ranks of
    one job per world size, a fresh job each (:func:`scaling_worker`).
    ``--scaling-chip``: the same rollout over all 25 scenarios in this
    process at each of :data:`CHIP_REPLICAS` replicas per scenario.
    Returns ``(rank_rows, chip_rows, report path)``."""
    device = resolve_device(args.device)
    rank_rows, chip_rows = [], []
    if args.scaling:
        for n in _world_sizes(device):
            row = _scaling_job(n, args)
            rank_rows.append(row)
            print(f"{n} ranks: {row['env_steps_per_sec']:,.0f} env-steps/s", flush=True)
    if args.scaling_chip:
        for replicas in CHIP_REPLICAS:
            sps, _ = suite_throughput(CHIP_CONFIGS, replicas, args.scaling_steps, device)
            chip_rows.append({"replicas": replicas, "total_envs": CHIP_CONFIGS * replicas,
                              "env_steps_per_sec": sps})
            print(f"batch {CHIP_CONFIGS * replicas}: {sps:,.0f} env-steps/s", flush=True)
    out = write_scaling_report(args.out / "RESULTS_SCALING.md", rank_rows, chip_rows, args)
    print(f"wrote {out}")
    return rank_rows, chip_rows, out


def _card_label(device):
    """``name, power limit`` of a CUDA ``device`` as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[device.index or 0]


def _wrap(text):
    return textwrap.fill(text, width=72, break_on_hyphens=False)


def write_scaling_report(out, rank_rows, chip_rows, args):
    """The scaling report at ``out``, with the JAX tool's tables.  A section
    this run did not measure is kept from ``out`` itself, never from the
    repository's ``RESULTS_SCALING.md`` (a record of TPU runs)."""
    import torch

    out = Path(out)
    old = out.read_text() if out.exists() else ""
    device = resolve_device(args.device)
    cores = os.cpu_count()

    def section(title, body):
        return f"## {title}\n\n{body}\n"

    def kept(title):
        m = re.search(rf"## {title}.*?(?=## |\Z)", old, re.S)
        return m.group(0) if m else ""

    if rank_rows:
        base = rank_rows[0]["env_steps_per_sec"]
        sizes = ", ".join(str(row["devices"]) for row in rank_rows)
        if device.type == "cpu":
            threads = ", ".join(str(_threads_per_rank(row["devices"])) for row in rank_rows)
            where = (
                "over gloo on the CPU, each rank with "
                f"`torch.set_num_threads(os.cpu_count() // N)` threads ({threads}).  "
                "Validates the sharded rollout at every size; absolute CPU "
                f"throughput is bounded by the {cores} physical cores of this host, "
                "so ideal scaling is NOT expected here — the card's table carries "
                "the perf claim."
            )
        else:
            where = (
                f"over NCCL, one card per rank ({_card_label(device)}).  World sizes "
                f"{sizes} of {', '.join(map(str, SCALING_WORLD_SIZES))} ran: NCCL puts "
                f"one rank on each card, and this host has {torch.cuda.device_count()}."
            )
        lines = [
            _wrap(f"Suite program ({args.scaling_configs} configs x "
                  f"{args.scaling_replicas} replicas x {args.scaling_steps} steps, f32) "
                  "with its configs sharded over the N ranks (devices) of one "
                  "`torch.distributed` job (`--scaling-worker N`, a fresh job per "
                  f"point), {where}"),
            "",
            "| devices | env-steps/s | vs 1 device |",
            "|---|---|---|",
        ]
        for row in rank_rows:
            lines.append(
                f"| {row['devices']} | {row['env_steps_per_sec']:,.0f} | "
                f"{row['env_steps_per_sec'] / base:.2f}x |"
            )
        rank_md = section("Multi-process scaling", "\n".join(lines))
    else:
        rank_md = kept("Multi-process")

    if chip_rows:
        on = (f"ONE card ({_card_label(device)})" if device.type == "cuda"
              else f"the CPU ({cores} cores)")
        lines = [
            _wrap(f"Suite throughput on {on} as the env batch grows "
                  f"({args.scaling_steps} steps, f32, {CHIP_CONFIGS} configs, HONEST mode "
                  "— randomized per-replica starts, so no replica repeats another's "
                  "work; best of 3 runs, each to its checksums on the host):"),
            "",
            "| total envs | env-steps/s/chip |",
            "|---|---|",
        ]
        for row in chip_rows:
            lines.append(
                f"| {row['total_envs']:,} | {row['env_steps_per_sec']:,.0f} |"
            )
        chip_md = section("Batch-size sweep", "\n".join(lines))
    else:
        chip_md = kept("Batch-size")

    out.write_text(
        "# RESULTS — scaling evidence (pymgrid_tpu_torch)\n\n"
        "Multi-process scaling and the batch-size sweep of the one-batch pymgrid25\n"
        "suite rollout (`pymgrid_tpu_torch/parallel/suite.py`), written by\n"
        "`python -m pymgrid_tpu_torch.tools.run_benchmarks --scaling --scaling-chip`.\n\n"
        + rank_md + "\n" + chip_md
    )
    return out


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
