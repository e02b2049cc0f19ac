#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It refuses to run (non-zero exit, no result) without CUDA.  Phases, each of
which fails the run on error:

1. build      nvcc-compile ``pymgrid_tpu_torch/csrc/rbc_rollout.cu`` (sm_90a).
2. main path  with every kernel launch count at 0, through the user entry
              points: the fused-horizon RBC kernel over an init-charge sweep
              of scenario 0 (131072 replicas x the full year, 8759 steps);
              the engine's lockstep sweep on the same replicas (2000 steps,
              held against the kernel); the full-year scenario-1 RBC log on
              the card in float64 (held bitwise against the golden stream);
              the 25-config suite (20480 replicas per config x 1000 steps,
              float32, randomized starts, auto-reset; held against the same
              rollout on the CPU in float64 for 4 replicas per config).
3. kernels    the kernel against its plain PyTorch version on the card at the
              main-path shape and on all 25 scenarios; kernel and plain times.

Every time printed carries the card's name and power limit.  The line before
the last is the kernels' JSON record; the last line is the result JSON.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "fixtures" / "golden_rbc.npz"
FULL_YEAR_COST = 956059.66  # scenario 0, f64 reference (tests/test_pallas_rollout.py)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """Host-clock seconds of ``fn()`` ending in a device synchronize."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _event_ms(fn, iters):
    """Mean CUDA-event milliseconds of ``fn`` over ``iters`` calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_info():
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sweep_inputs(scenario, batch, device):
    """Scenario spec/params (f32) and an init-charge sweep over
    [min_capacity, max_capacity]; replica 0 starts at the config's own
    initial charge."""
    import torch

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.spec import extract_spec

    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    pb = params["battery"]
    init = np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
                       batch, dtype=np.float32)
    init[0] = pb["init_charge"][0]
    return spec, params, torch.as_tensor(init, device=device)


def phase_build():
    from pymgrid_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    load_library("rbc_rollout")
    return time.perf_counter() - t0


def phase_kernel_sweep(device, batch, n_steps, scenario=0):
    """Main path, kernel: the fused-horizon RBC over an init-charge sweep."""
    import torch

    from pymgrid_tpu_torch.ops import make_rbc_rollout

    spec, params, init = sweep_inputs(scenario, batch, device)
    rollout = make_rbc_rollout(spec, params, n_steps, device)
    rollout.launches = 0
    acc, seconds = _timed(lambda: rollout(init), device)
    _check(acc.shape == (batch,) and bool(torch.isfinite(acc).all()),
           "kernel sweep: non-finite or misshapen output")
    return {"rollout": rollout, "init": init, "acc": acc, "seconds": seconds,
            "steps_per_s": batch * n_steps / seconds}


def phase_engine_sweep(device, batch, n_steps, scenario=0, rtol=1e-4):
    """Main path, engine: the port's lockstep sweep (marginal-cost RBC, f32)
    on the init-charge sweep, held against the fused kernel at rtol 1e-4
    (the two differ only in float32 rounding order)."""
    import torch

    from pymgrid_tpu_torch.core.engine import make_reset_fn
    from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
    from pymgrid_tpu_torch.core.rollout import (
        lockstep_states,
        make_lockstep_sweep_fn,
        make_marginal_cost_policy,
    )
    from pymgrid_tpu_torch.ops import make_rbc_rollout

    spec, params, init = sweep_inputs(scenario, batch, device)
    tparams = with_config_axis(params_to_torch(params, device, torch.float32))
    starts = tparams["initial_step"].view(1, 1).expand(1, batch)
    states = make_reset_fn(spec)(tparams, starts)
    states["battery_charge"] = init.view(1, batch, 1)
    sweep = make_lockstep_sweep_fn(spec, make_marginal_cost_policy(spec), n_steps)
    (_, acc), seconds = _timed(
        lambda: sweep(tparams, lockstep_states(spec, tparams, states)), device
    )
    acc = acc[0]

    rollout = make_rbc_rollout(spec, params, n_steps, device)
    rollout.launches = 0
    want = rollout(init)
    _check(bool(torch.isfinite(acc).all()), "engine sweep: non-finite output")
    rel = ((acc - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    _check(rel <= rtol, f"engine sweep vs kernel: max rel diff {rel:.3e} > {rtol}")
    return {"seconds": seconds, "steps_per_s": batch * n_steps / seconds,
            "max_rel_vs_kernel": rel, "kernel_launches": rollout.launches}


def phase_golden(device, scenario=1, max_steps=None):
    """Main path, host-facing RBC: ``run_compiled`` in float64 reproduces
    the recorded reference reward stream bitwise."""
    from pymgrid_tpu import Microgrid
    from pymgrid_tpu_torch.algos import RuleBasedControl

    log, seconds = _timed(
        lambda: RuleBasedControl(Microgrid.from_scenario(scenario)).run_compiled(
            max_steps=max_steps, device=device, dtype="float64"
        ),
        device,
    )
    ours = log[("balance", 0, "reward")].values.astype(np.float64)
    with np.load(GOLDEN) as golden:
        want = golden[f"scenario_{scenario}_reward"][: len(ours)]
    _check(max_steps is not None or len(ours) == len(want), "golden: length differs")
    n_diff = int((ours != want).sum())
    _check(n_diff == 0, f"golden scenario {scenario}: {n_diff} of {len(ours)} "
                        f"steps differ (max {np.abs(ours - want).max():.3e})")
    return {"seconds": seconds, "steps": len(ours)}


def phase_suite(device, n_configs, replicas, n_steps, ref_replicas=4, seed=0,
                rtol=1e-4):
    """Main path, suite: ``n_configs`` scenarios x ``replicas`` in float32
    with randomized starts and auto-reset; the first ``ref_replicas`` of
    every config are held against the same rollout on the CPU in float64
    at rtol 1e-4 (float32 against float64 over ``n_steps`` steps)."""
    import torch

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.parallel import SuiteRunner

    def run(dev, dtype, batch, starts):
        mgs = [Microgrid.from_scenario(n) for n in range(n_configs)]
        runner = SuiteRunner(mgs, batch_per_config=batch, dtype=dtype, device=dev)
        fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps,
                               auto_reset=True, collect=False,
                               randomize_initial_step=True)
        if starts is None:
            starts = runner.draw_initial_steps(torch.Generator().manual_seed(seed))
        acc, seconds = _timed(lambda: fn(runner.params, starts.to(runner.device)), dev)
        return acc, starts, seconds

    acc, starts, seconds = run(device, "float32", replicas, None)
    _check(acc.shape == (n_configs, replicas) and bool(torch.isfinite(acc).all()),
           "suite: non-finite or misshapen output")
    ref, _, _ = run("cpu", "float64", ref_replicas, starts[:, :ref_replicas].cpu())
    got = acc[:, :ref_replicas].double().cpu()
    rel = ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
    _check(rel <= rtol, f"suite vs CPU float64: max rel diff {rel:.3e} > {rtol}")
    return {"seconds": seconds,
            "steps_per_s": n_configs * replicas * n_steps / seconds,
            "max_rel_vs_cpu_f64": rel}


def phase_kernel_vs_plain(sweep, device, rtol=1e-5, iters=5):
    """The kernel against its plain PyTorch version on the card, at the
    main-path shape and on every pymgrid25 scenario (1024 x 64 steps)."""
    import torch

    from pymgrid_tpu_torch.ops import make_rbc_rollout

    rollout, init, acc = sweep["rollout"], sweep["init"], sweep["acc"]
    plain, plain_s = _timed(lambda: rollout.plain(init), device)
    abs_err = (acc - plain).abs().max().item()
    rel = ((acc - plain).abs() / plain.abs().clamp_min(1e-30)).max().item()
    _check(rel <= rtol, f"kernel vs plain: max rel diff {rel:.3e} > {rtol}")
    full_year = -acc[0].item()
    _check(abs(full_year - FULL_YEAR_COST) <= 1e-4 * FULL_YEAR_COST,
           f"full-year cost {full_year} vs f64 reference {FULL_YEAR_COST}")
    ms = _event_ms(lambda: rollout(init), iters)

    worst = 0.0
    for n in range(25):
        spec, params, init_n = sweep_inputs(n, 1024, device)
        r = make_rbc_rollout(spec, params, 64, device)
        k, p = r(init_n), r.plain(init_n)
        _sync(device)
        _check(bool(torch.isfinite(k).all()), f"scenario {n}: non-finite kernel output")
        worst = max(worst, ((k - p).abs() / p.abs().clamp_min(1e-30)).max().item())
    _check(worst <= rtol, f"25 scenarios kernel vs plain: max rel {worst:.3e}")
    return {"max_abs_err": abs_err, "max_rel": rel, "ms": ms,
            "plain_ms": plain_s * 1e3, "full_year_cost": full_year,
            "max_rel_25_scenarios": worst}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(REPO))
    import pymgrid_tpu_torch  # noqa: F401  (fails outside the repository)

    device = "cuda"
    card = card_info()
    print(card, flush=True)
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    build_s = phase_build()
    print(f"build rbc_rollout.cu: {build_s:.2f} s {tag}", flush=True)

    # ---- main path, every launch count at 0 ------------------------------
    batch, year = 131072, 8759
    sweep = phase_kernel_sweep(device, batch, year)
    print(f"main/kernel sweep: {batch} x {year} steps in {sweep['seconds']:.4f} s, "
          f"{sweep['steps_per_s']:.6g} env-steps/s {tag}", flush=True)
    eng = phase_engine_sweep(device, batch, 2000)
    print(f"main/engine sweep: {batch} x 2000 steps in {eng['seconds']:.4f} s, "
          f"{eng['steps_per_s']:.6g} env-steps/s, max rel vs kernel "
          f"{eng['max_rel_vs_kernel']:.3e} {tag}", flush=True)
    gold = phase_golden(device)
    print(f"main/golden: scenario 1 full year ({gold['steps']} steps, f64) bitwise "
          f"in {gold['seconds']:.2f} s {tag}", flush=True)
    suite = phase_suite(device, 25, 20480, 1000)
    print(f"main/suite: 25 x 20480 x 1000 steps in {suite['seconds']:.4f} s, "
          f"{suite['steps_per_s']:.6g} env-steps/s, max rel vs CPU f64 "
          f"{suite['max_rel_vs_cpu_f64']:.3e} {tag}", flush=True)
    launches = sweep["rollout"].launches + eng["kernel_launches"]
    _check(launches > 0, "the main path launched no rbc_rollout kernel")

    # ---- kernel against its plain version (launches not counted) ---------
    kvp = phase_kernel_vs_plain(sweep, device)
    print(f"kernel rbc_rollout: {kvp['ms']:.4f} ms ({batch * year / kvp['ms'] * 1e3:.6g} "
          f"env-steps/s), plain {kvp['plain_ms']:.1f} ms "
          f"({batch * year / kvp['plain_ms'] * 1e3:.6g} env-steps/s); max abs err "
          f"{kvp['max_abs_err']:.4g}, max rel {kvp['max_rel']:.3e}, 25 scenarios max rel "
          f"{kvp['max_rel_25_scenarios']:.3e}; full-year cost {kvp['full_year_cost']:.2f} "
          f"{tag}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "rbc_rollout",
        "route": "cuda",
        "source": "pymgrid_tpu_torch/csrc/rbc_rollout.cu",
        "replaces": "pymgrid_tpu/ops/pallas_rollout.py:48",
        "launches": launches,
        "max_abs_err": kvp["max_abs_err"],
        "ms": kvp["ms"],
        "plain_ms": kvp["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
