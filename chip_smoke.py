#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It refuses to run (non-zero exit, no result) without CUDA.  Phases, each of
which fails the run on error:

1. build      nvcc-compile ``pymgrid_tpu_torch/csrc/rbc_rollout.cu`` and
              ``csrc/box_ipm.cu`` (sm_90a) and print ptxas' registers, spills
              and shared memory for each of their kernels (rbc_rollout's 8
              variants, the box IPM's one).
2. main path  with every kernel launch count at 0, through the user entry
              points, every microgrid built by the port's own host layer
              (``pymgrid_tpu_torch.Microgrid.from_scenario``; nothing of the
              JAX package is imported): the fused-horizon RBC kernel over an
              init-charge sweep
              of scenario 0 (131072 replicas x the full year, 8759 steps);
              the engine's lockstep sweep on the same replicas (2000 steps,
              held against the kernel); the scenario-1 RBC log on the card
              in float64 over the first 2000 steps of the year (held bitwise
              against the golden stream);
              the 25-config suite (20480 replicas per config x 1000 steps,
              float32, ``fn(params, make_keys(0))``: randomized starts drawn
              inside, equal to the CPU's, auto-reset; the default
              block-prefetch path, its 125 block gathers counted,
              ``torch.equal`` to ``block_prefetch=False`` at the same size,
              both timed and profiled over 16 steps; held against the same
              rollout on the CPU in float64 for 4 replicas per config).
3. envs       the batched RL envs through their user entry points at
              ``bench.py``'s widths (65536 replicas x 100 steps, float32):
              ``BatchedDiscreteEnv`` on scenario 0 and ``BatchedContinuousEnv``
              on scenario 1, each timed as a ``step()`` loop, a
              ``rollout(shared_step=True)`` and a ``rollout(keep_obs=False)``;
              the rollouts held bitwise against the loop, the first replicas
              against the host numpy env (float64) at rtol 1e-4, and a float64
              run on the card bitwise against the host env.
4. surfaces   the engine surfaces that draw or call per replica: (a)
              ``BatchedDiscreteEnv`` on scenario 0 with gaussian forecasts (std
              0.1, horizon 23) drawn from threefry keys, 65536 x 100 float32:
              the ``step()`` loop and ``rollout(shared_step=True)`` from
              ``reset(seed=0)``, timed and bitwise equal, ``seed=1`` different,
              4 float64 replicas within 1e-9 of the CPU in the realized
              forecast log fields, the standardized noise's mean and std, and
              the device events per step under ``torch.profiler``; (b)
              ``BatchedContinuousEnv`` on scenario 1 with a custom battery
              transition, a callable genset cost and user forecasters on load
              and pv: 4 float64 replicas bitwise against the host env, and
              65536 x 100 float32 timed, the rollout bitwise against the loop.
5. planners   the on-device planners through their user entry points:
              ``SuiteMPC`` over all 25 pymgrid25 scenarios at horizon 24 for
              24 steps in the published chip mode (float32, box IPM,
              ``enum_bits=3``, ``enum_chunk=16``, ``iters=60``,
              ``newton_refine=2``) and the same 24 steps in float64, held to
              2% on scenarios 0, 4 and 1; ``BatchedMPC`` on scenario 1 (genset
              MILP, ``enum_bits=5``) with one float64 replica with the host
              fallback (within 1e-4 of the host HiGHS MILP MPC, fallback
              count as on the CPU) and 1024 float32 replicas over its first 6
              steps (all equal bitwise, within 2% of float64 over those
              steps); ``BatchedSAA`` on scenario 0 with every sample the
              real data (equal to ``BatchedMPC`` at rtol 1e-5) and with 10
              sampled futures (finite rewards, the pick at the median of the
              sorted costs).  24 steps each, but the float32 ``BatchedMPC``'s
              6.  Depth cuts for the time limit when phases 8-10 came in:
              ``SuiteMPC`` from 48 steps, the float32 ``BatchedMPC`` from 24.
              The float32 ``SuiteMPC``'s box-IPM solves run in the kernel
              ``csrc/box_ipm.cu``, one launch a solve: counted from 0 over
              that run (``pymgrid.lp.kernel_solves``, the count of phase 9's
              ``--mpc-suite`` added) and equal to its box-IPM solves; the
              inputs of each solver's first 4 solves (the enumeration's 2
              hours, the final re-solve's 4) are kept for phase 7.
6. training   ``pymgrid_tpu_torch.examples`` at the published widths, both
              stepped by optax's Adam (``utils.optax_adam.Adam``): first
              that optimizer alone, one float32 gradient stream over A2C's
              and ES's parameters for 12 steps, ``torch.equal`` to the CPU
              after every step, one step timed beside ``torch.optim.Adam``;
              A2C on
              scenario 1 (4096 replicas x 128-step rollouts, MLP 64-64,
              entropy 0.02): one iteration with fed actions held against the
              CPU float32 iteration at rtol 1e-4 (loss, updated parameters),
              the first sampled iteration of a seed-0 run (JAX's threefry
              draws) against the CPU's (actions equal but at near ties, then
              loss and mean return at rtol 1e-4), 5 sampled iterations timed
              (finite history), one more under ``torch.profiler`` (device
              events, busy time, idle share); continuous ES on scenario 0
              (population 256, hidden 32, depth cut to 1000 of the year's
              8758 steps): the population's returns at a fixed theta held
              against the CPU float32 run, ``theta0`` and the first
              generation's noise ``torch.equal`` to the CPU's, 2
              generations timed (ms per generation);
              ``entry.dryrun_multichip(1)`` over NCCL,
              its loss and mean return against the CPU's at rtol 1e-5.
7. kernels    the kernel against its plain PyTorch version on the card,
              bitwise (``torch.equal``): at the main-path shape, on all 25
              scenarios at 1024 x 64 (each scenario's kernel variant printed)
              and on scenario 1 (genset, weak grid) at 4096 x 8759; kernel and
              plain times, and the kernel's bound.  Then the box IPM's kernel
              against the op-by-op solve (its plain PyTorch version) on phase
              5's kept LPs, each of the three solve shapes (relaxation 25
              problems x 35 iterations, pattern chunk 200 x 35, final re-solve
              25 x 60 with 2 refinements): the kernel's objectives within
              twice the op path's largest distance to HiGHS's optimum
              (relative to 1 + |J*|), its residuals below 1e-2, where the
              float32 planner takes a solve as infeasible; at one hour's shapes the kernel's device time
              (torch.profiler, mean of 10 eager launches), the op path's
              (CUDA events, replayed as the planner does) and the bound.

8. keys       JAX's draws on the card: ``make_random_policy`` at 65536
              replicas of scenario 0 (one draw and step; actions bitwise vs
              the CPU); ``prng.normal`` (float32 and float64, 23 x 4 per
              key), ``prng.gumbel`` and ``prng.categorical`` (float32) over
              65536 split keys, the float32 draws ``torch.equal`` to the
              CPU's, float64 equal in ``log1p``'s rational and its other
              differing elements counted, each one where ``log1p`` differs
              between the devices (the root is IEEE's on both), the draws
              and XLA's ``log1p`` and
              ``log`` expansions timed beside ``torch.log1p`` and
              ``torch.log``; the suite's collect rollout with randomized restarts
              (25 x 1024 x 20, float32; dones bitwise vs the CPU, device
              events per step under ``torch.profiler`` beside fixed
              restarts).
9. tables     ``pymgrid_tpu_torch.tools.run_benchmarks``: the RBC mode on
              scenario 0 over the full year in float64 (956,059.66 to the
              cent, as ``RESULTS.md``) and ``--mpc-suite`` over scenarios 0
              and 1 at 24 steps (finite, the report parsed back), writing
              into a temporary directory.
10. examples  ``pymgrid_tpu_torch.examples.scenario0_structure`` at the full
              8758 steps, held against ``docs/captures/scenario0_structure.log``
              (returns at rtol 1e-5, every other line identical).

11. speed    the speed tools through their entry points:
              ``run_benchmarks --scaling-chip`` (25 configs x 256, 1024,
              4096, 8192 and 20480 replicas x 200 steps, float32,
              randomized starts; env-steps/s per batch, best of 3) and
              ``--scaling`` (8 x 256 x 200, one ``--scaling-worker`` job per
              world size the host's cards allow, NCCL; on one card world
              size 1, its checksums ``torch.equal`` to the unmeshed
              runner's) into a temporary directory, the report parsed back;
              ``profile_env`` at its defaults (scenario 0, 2048 x 100: both
              fused env rollouts and the suite rollout, finite).
12. bench     ``pymgrid_tpu_torch.tools.bench``, the twin of ``bench.py``,
              through its entry point at ``bench.py``'s defaults: the suite
              (25 x 20480 x 1000, best of 3), the RL paths (65536 x 100), the
              kernel against the engine sweep (131072 x 2000; the kernel's
              launches join the kernels line's count) and the collect rollout
              (25 x 1024 x 100), JAX's int32 starts; its one JSON line parsed
              back, every rate finite and above 0, printed with the card; the
              collect step's device events with int32 restarts beside phase
              8's int64 ones.

Phases 8-12 run before phase 7.  Every time printed carries the card's name
and power limit.  The line before
the last is the kernels' JSON record (per kernel: its launches on the path,
its check, its time, its plain version's and its bound); the last line is
the result JSON.
"""
import contextlib
import json
import subprocess
import sys
import tempfile
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
    """Mean CUDA-event milliseconds of ``fn`` over ``iters`` calls, after
    one call to warm up."""
    import torch

    fn()
    torch.cuda.synchronize()
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
    """Scenario spec/params (f32) and the ``bench.py`` twin's init-charge
    sweep over [min_capacity, max_capacity], but replica 0 starts at the
    config's own initial charge."""
    from pymgrid_tpu_torch.tools.bench import kernel_sweep_inputs

    spec, params, init = kernel_sweep_inputs(batch, device, scenario)
    init[0] = float(params["battery"]["init_charge"][0])
    return spec, params, init


def phase_build(names=("rbc_rollout", "box_ipm")):
    """Build the kernels; returns the seconds and each build's ptxas lines."""
    from pymgrid_tpu_torch.ops._build import build_report, load_library

    t0 = time.perf_counter()
    for name in names:
        load_library(name)
    seconds = time.perf_counter() - t0
    return seconds, {name: build_report(name) for name in names}


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
    full_year = -acc[0].item()   # replica 0 starts at the scenario's own charge
    if scenario == 0 and n_steps == 8759:
        _check(abs(full_year - FULL_YEAR_COST) <= 1e-4 * FULL_YEAR_COST,
               f"full-year cost {full_year} vs f64 reference {FULL_YEAR_COST}")
    return {"rollout": rollout, "init": init, "acc": acc, "seconds": seconds,
            "steps_per_s": batch * n_steps / seconds, "full_year_cost": full_year}


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
    from pymgrid_tpu_torch import Microgrid
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
                rtol=1e-4, trace_dir=None, profile_steps=(8, 24)):
    """Main path, suite: ``n_configs`` scenarios x ``replicas`` in float32,
    called as ``fn(params, make_keys(seed))``: randomized starts drawn from
    the keys inside the rollout (the JAX runner's draws) and auto-reset.  The
    default rollout runs the block-prefetch path (one row-window gather per
    8 steps, counted) and is ``torch.equal`` to the same rollout with
    ``block_prefetch=False``; the starts equal those drawn on the CPU
    (``torch.equal``), and the first ``ref_replicas`` of every config are
    held against the same rollout on the CPU in float64 at rtol 1e-4
    (float32 against float64 over ``n_steps`` steps).  Both paths are timed
    (the blocked one twice, before and after the per-step one); with
    ``trace_dir``, each path's device events and busy time per step under
    ``torch.profiler`` (the difference of rollouts of ``profile_steps``
    steps, multiples of 8, so the reset cancels)."""
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.parallel import SuiteRunner
    from pymgrid_tpu_torch.parallel import suite as suite_module
    from pymgrid_tpu_torch.utils.profiling import device_summary, trace

    def runner_on(dev, dtype, batch):
        mgs = [Microgrid.from_scenario(n) for n in range(n_configs)]
        return SuiteRunner(mgs, batch_per_config=batch, dtype=dtype, device=dev)

    def rollout(runner, keys, block_prefetch=None, steps=n_steps):
        fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), steps,
                               auto_reset=True, collect=False,
                               randomize_initial_step=True, block_prefetch=block_prefetch)
        return fn(runner.params, keys.to(runner.device))

    runner = runner_on(device, "float32", replicas)
    keys = runner.make_keys(seed)
    gathers, gather = [], suite_module.gather_block
    suite_module.gather_block = lambda *a: gathers.append(1) or gather(*a)
    try:
        acc, seconds = _timed(lambda: rollout(runner, keys), device)
    finally:
        suite_module.gather_block = gather
    _check(len(gathers) == n_steps // suite_module.BLOCK,
           f"suite: the default rollout made {len(gathers)} block gathers, not "
           f"{n_steps // suite_module.BLOCK}: it did not run the block-prefetch path")
    _check(acc.shape == (n_configs, replicas) and bool(torch.isfinite(acc).all()),
           "suite: non-finite or misshapen output")
    per_step, seconds_per_step = _timed(lambda: rollout(runner, keys, False), device)
    _check(torch.equal(acc, per_step),
           "suite: the block-prefetch rollout differs from the per-step rollout")
    again, seconds_again = _timed(lambda: rollout(runner, keys), device)
    _check(torch.equal(again, acc), "suite: a second blocked rollout differs from the first")

    cpu = runner_on("cpu", "float32", replicas)
    _check(torch.equal(runner.draw_initial_steps(keys).cpu(),
                       cpu.draw_initial_steps(cpu.make_keys(seed))),
           "suite: the starts drawn on the card differ from the CPU's")
    ref = rollout(runner_on("cpu", "float64", ref_replicas), keys[:, :ref_replicas].cpu())
    got = acc[:, :ref_replicas].double().cpu()
    rel = ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
    _check(rel <= rtol, f"suite vs CPU float64: max rel diff {rel:.3e} > {rtol}")
    out = {"seconds": seconds, "seconds_again": seconds_again,
           "seconds_per_step_path": seconds_per_step,
           "steps_per_s": n_configs * replicas * n_steps / seconds,
           "max_rel_vs_cpu_f64": rel}
    if trace_dir is not None:
        n = profile_steps[1] - profile_steps[0]
        for name, block_prefetch in (("blocked", None), ("per_step", False)):
            runs = []
            for k, steps in enumerate(profile_steps):
                with trace(str(Path(trace_dir) / f"{name}{k}"), device) as prof:
                    rollout(runner, keys, block_prefetch, steps)
                runs.append(device_summary(prof))
            out[f"events_per_step_{name}"] = (runs[1]["kernels"] - runs[0]["kernels"]) / n
            out[f"busy_ms_per_step_{name}"] = (runs[1]["busy_ms"] - runs[0]["busy_ms"]) / n
    return out


def _host_env_run(env, actions):
    """Step a freshly built host numpy env through ``actions``; returns the
    reward, done and observation streams.  (A used one would not do:
    ``reset()`` does not restore scenario 1's first state.)"""
    rewards, dones, obs = [], [], []
    for action in actions:
        o, r, d, _ = env.step(action)
        rewards.append(r)
        dones.append(d)
        obs.append(np.asarray(o, dtype=np.float64))
    return np.array(rewards), np.array(dones), np.stack(obs)


def _env_phase(device, env_cls, batched_cls, scenario, batch, n_steps, draw,
               host_action, ref_replicas, rtol):
    """One batched env through its user entry points, checked as the
    ``phase_*_env`` docstrings say."""
    import torch

    venv = batched_cls(env_cls.from_scenario(scenario), batch, "float32", device)
    actions_np = draw(venv)
    actions = torch.as_tensor(actions_np, device=device)
    venv.step(venv.reset(seed=0), actions[0])   # first launches, not timed

    def step_loop():
        states, outs = venv.reset(seed=0), []
        for k in range(n_steps):
            states, out = venv.step(states, actions[k])
            outs.append(out)
        return outs

    outs, loop_s = _timed(step_loop, device)
    loop = {f: torch.stack([getattr(o, f) for o in outs]) for f in ("reward", "done", "obs")}
    del outs
    _check(loop["obs"].shape == (n_steps, batch, venv.obs_dim)
           and bool(torch.isfinite(loop["reward"]).all())
           and bool(torch.isfinite(loop["obs"]).all()),
           f"{batched_cls.__name__}: non-finite or misshapen step outputs")

    (_, shared), shared_s = _timed(
        lambda: venv.rollout(venv.reset(seed=0), actions, shared_step=True), device)
    for f in ("reward", "done", "obs"):
        _check(torch.equal(getattr(shared, f), loop[f]),
               f"{batched_cls.__name__}: rollout(shared_step=True) {f} differs from the step loop")
    del shared
    (_, lean), lean_s = _timed(
        lambda: venv.rollout(venv.reset(seed=0), actions, keep_obs=False), device)
    _check(lean.obs is None, f"{batched_cls.__name__}: keep_obs=False returned obs")
    for f in ("reward", "done"):
        _check(torch.equal(getattr(lean, f), loop[f]),
               f"{batched_cls.__name__}: rollout(keep_obs=False) {f} differs from the step loop")

    # the first replicas on the host numpy env (float64), and in float64 on
    # the device bitwise against it
    host = [_host_env_run(env_cls.from_scenario(scenario),
                          [host_action(actions_np[k, b]) for k in range(n_steps)])
            for b in range(ref_replicas)]
    want = np.array([h[0].sum() for h in host])
    got = loop["reward"][:, :ref_replicas].double().sum(0).cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    _check(rel <= rtol, f"{batched_cls.__name__}: summed reward vs host float64 "
                        f"max rel {rel:.3e} > {rtol}")
    venv64 = batched_cls(env_cls.from_scenario(scenario), ref_replicas, "float64", device)
    states = venv64.reset(seed=0)
    for k in range(n_steps):
        states, out = venv64.step(states, actions[k, :ref_replicas])
        for b, (r, d, o) in enumerate(host):
            _check(out.reward[b].item() == r[k] and bool(out.done[b]) == d[k]
                   and np.array_equal(out.obs[b].cpu().numpy(), o[k]),
                   f"{batched_cls.__name__} float64: step {k} replica {b} differs "
                   f"from the host env")

    env_steps = batch * n_steps
    return {"step_loop_s": loop_s, "shared_rollout_s": shared_s,
            "lean_rollout_s": lean_s,
            "step_loop_per_s": env_steps / loop_s,
            "shared_rollout_per_s": env_steps / shared_s,
            "lean_rollout_per_s": env_steps / lean_s,
            "max_rel_vs_host": rel, "obs_dim": venv.obs_dim}


def phase_discrete_env(device, batch=65536, n_steps=100, scenario=0,
                       ref_replicas=4, rtol=1e-4):
    """``BatchedDiscreteEnv`` (float32) with ``RandomState(0)`` integer
    actions, as ``bench.py``'s RL metrics draw them: the ``step()`` loop
    with observations returned, ``rollout(shared_step=True)`` and
    ``rollout(keep_obs=False)``, timed.  The rollouts' rewards, dones and
    observations equal the loop's bitwise; the summed reward of the first
    ``ref_replicas`` is within ``rtol`` of the host ``DiscreteMicrogridEnv``
    in float64, and a float64 run of them on the device equals the host env
    bitwise in reward, done and observation."""
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv

    return _env_phase(
        device, DiscreteMicrogridEnv, BatchedDiscreteEnv, scenario, batch, n_steps,
        lambda venv: np.random.RandomState(0).randint(
            venv.n_actions, size=(n_steps, batch)).astype(np.int32),
        int, ref_replicas, rtol,
    )


def phase_continuous_env(device, batch=65536, n_steps=100, scenario=1,
                         ref_replicas=4, rtol=1e-4):
    """``BatchedContinuousEnv`` (float32) with ``RandomState(0)`` actions in
    [0, 1], checked as :func:`phase_discrete_env` (the host env gets the
    same float32 actions in float64)."""
    from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedContinuousEnv

    return _env_phase(
        device, ContinuousMicrogridEnv, BatchedContinuousEnv, scenario, batch,
        n_steps,
        lambda venv: np.random.RandomState(0).rand(
            n_steps, batch, venv.action_dim).astype(np.float32),
        lambda a: a.astype(np.float64), ref_replicas, rtol,
    )


def _gaussian_discrete_env(scenario):
    """The host ``DiscreteMicrogridEnv`` of ``scenario`` with gaussian
    forecasts (std 0.1) on every time series at horizon 23, drawn in the
    engine from threefry keys (no numpy noise bank)."""
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv

    env = DiscreteMicrogridEnv.from_scenario(scenario)
    env.set_forecaster(0.1, forecast_horizon=23)
    return env


def _forecast_columns(spec):
    """Log-row columns of the realized forecast fields."""
    return [i for i, (_, _, field) in enumerate(spec.log_columns) if "_forecast_" in field]


def standardized_noise(venv, states, margin=6.0):
    """``(realized - oracle) / std`` of every gaussian window in ``states``
    whose oracle value lies more than ``margin`` std inside the observation
    bounds (there the clip cannot act): ``(sum, sum of squares, count)`` in
    float64."""
    import torch

    from pymgrid_tpu_torch.core import engine

    params, spec = venv.params, venv.spec
    lifted = venv._lift(states)
    total = torch.zeros(3, dtype=torch.float64, device=venv.device)
    for kind in states["forecast"]:
        for gslot, ref in enumerate(engine._gaussian_refs(spec, kind)):
            h = ref.forecast_horizon
            oracle = engine._oracle_window(params, ref, lifted["step"]).double()
            realized = lifted["forecast"][kind][:, :, gslot, :h].double()
            std = params[kind]["noise_std"][:, ref.slot, :h].unsqueeze(1).double()
            low, high = (b.double() for b in engine._obs_bounds(params, ref))
            inside = (oracle > low + margin * std) & (oracle < high - margin * std)
            z = ((realized - oracle) / std)[inside.expand_as(realized)]
            total += torch.stack([z.sum(), (z * z).sum(), torch.tensor(
                float(z.numel()), dtype=torch.float64, device=venv.device)])
    return total


def phase_gaussian_env(device, batch=65536, n_steps=100, scenario=0, ref_replicas=4,
                       profile_steps=5, trace_dir=None, atol64=1e-9, noise_tol=0.005):
    """Engine surfaces (a): ``BatchedDiscreteEnv`` on ``scenario`` with
    threefry-gaussian forecasts (:func:`_gaussian_discrete_env`), float32,
    ``RandomState(0)`` actions.  The ``step()`` loop from ``reset(seed=0)``
    and ``rollout(shared_step=True)`` from a second ``reset(seed=0)``,
    timed, equal bitwise (rewards, dones, observations); ``seed=1`` draws
    other observations.  The first ``ref_replicas`` in float64 on the device
    match the same run on the CPU (the same keys: threefry splits do not
    depend on the batch size) within ``atol64`` in every realized forecast
    log field.  The standardized noise of the reset and the final windows
    (:func:`standardized_noise`) has mean within ``noise_tol`` of 0 and std
    within ``noise_tol`` of 1 (0.005: about 15 standard errors at the full
    width's ~1e7 entries).  With ``trace_dir``, ``profile_steps`` more steps run under
    ``torch.profiler`` for the device events and busy time per step, and
    the idle share against the unprofiled loop's time per step."""
    import torch

    from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv
    from pymgrid_tpu_torch.utils.profiling import device_summary, trace

    venv = BatchedDiscreteEnv(_gaussian_discrete_env(scenario), batch, "float32", device)
    _check("rng" in venv.reset(seed=0), "gaussian env: the state carries no keys")
    actions_np = np.random.RandomState(0).randint(
        venv.n_actions, size=(n_steps, batch)).astype(np.int32)
    actions = torch.as_tensor(actions_np, device=device)
    venv.step(venv.reset(seed=0), actions[0])   # first launches, not timed

    def step_loop():
        states, outs = venv.reset(seed=0), []
        for k in range(n_steps):
            states, out = venv.step(states, actions[k], keep_logs=False)
            outs.append(out)
        return states, outs

    (final, outs), loop_s = _timed(step_loop, device)
    loop = {f: torch.stack([getattr(o, f) for o in outs]) for f in ("reward", "done", "obs")}
    del outs
    _check(bool(torch.isfinite(loop["obs"]).all()) and bool(torch.isfinite(loop["reward"]).all()),
           "gaussian env: non-finite step outputs")
    (_, shared), shared_s = _timed(
        lambda: venv.rollout(venv.reset(seed=0), actions, shared_step=True), device)
    for f in ("reward", "done", "obs"):
        _check(torch.equal(getattr(shared, f), loop[f]),
               f"gaussian env: rollout(shared_step=True) {f} differs from the step loop")
    del shared
    _, other = venv.rollout(venv.reset(seed=1), actions[:3])
    _check(not torch.equal(other.obs, loop["obs"][:3]), "gaussian env: seed=1 drew seed 0's")

    stats = standardized_noise(venv, venv.reset(seed=0)) + standardized_noise(venv, final)
    total, squares, count = stats.tolist()
    mean = total / count
    std = (squares / count - mean * mean) ** 0.5
    _check(abs(mean) <= noise_tol and abs(std - 1.0) <= noise_tol,
           f"gaussian env: standardized noise mean {mean:.5f}, std {std:.5f} over {count:.0f}")

    def run64(dev):
        env64 = BatchedDiscreteEnv(_gaussian_discrete_env(scenario), ref_replicas, "float64", dev)
        states, rows = env64.reset(seed=0), []
        for k in range(n_steps):
            states, out = env64.step(states, actions_np[k, :ref_replicas])
            rows.append(out.log_row.cpu())
        return torch.stack(rows)[..., _forecast_columns(env64.spec)]

    gap64 = (run64(device) - run64("cpu")).abs().max().item()
    _check(gap64 <= atol64, f"gaussian env float64: forecast log fields on the device vs "
                            f"the CPU max abs {gap64:.3e} > {atol64}")

    out = {"step_loop_s": loop_s, "shared_rollout_s": shared_s,
           "step_loop_per_s": batch * n_steps / loop_s,
           "shared_rollout_per_s": batch * n_steps / shared_s,
           "noise_mean": mean, "noise_std": std, "noise_count": int(count),
           "max_abs_f64_vs_cpu": gap64}
    if trace_dir is not None:
        profile_steps = min(profile_steps, n_steps)
        states = venv.reset(seed=0)
        with trace(str(trace_dir), device) as prof:
            for k in range(profile_steps):
                states, _ = venv.step(states, actions[k])
        summary = device_summary(prof)
        out["events_per_step"] = summary["kernels"] / profile_steps
        out["busy_ms_per_step"] = summary["busy_ms"] / profile_steps
        out["idle_share"] = 1.0 - out["busy_ms_per_step"] / (loop_s / n_steps * 1e3)
    return out


def _polynomial_fuel_cost(production):
    """A genset cost written with array operations only: a quadratic fuel
    curve (the callable of tests/test_engine_equivalence.py)."""
    return 0.4 * production + 0.001 * (production * production)


def _derated_transition_model(external_energy_change, efficiency, **kwargs):
    """A battery transition that keeps less on charge (x0.9) and draws less
    on discharge (/1.1) than the nominal efficiency, without branching on a
    value (the callable of tests/test_engine_equivalence.py)."""
    is_charge = external_energy_change >= 0
    return (
        external_energy_change * (0.9 * efficiency) * is_charge
        + external_energy_change / (1.1 * efficiency) * (1 - is_charge)
    )


def _damped_vector_forecast(val_c, val_c_n, n):
    """A vectorized user forecaster: the oracle window damped toward the
    current row (the callable of tests/test_engine_equivalence.py)."""
    return 0.9 * val_c_n + 0.1 * val_c


def _callable_continuous_env(scenario):
    """The host ``ContinuousMicrogridEnv`` of ``scenario`` with its battery
    transition model, genset cost and load and pv forecasters (horizon 23)
    replaced by the callables above."""
    from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv

    env = ContinuousMicrogridEnv.from_scenario(scenario)
    env.modules.battery[0].battery_transition_model = _derated_transition_model
    env.modules.genset[0].genset_cost = _polynomial_fuel_cost
    for module in (env.modules.load[0], env.modules.pv[0]):
        module.set_forecaster(_damped_vector_forecast, forecast_horizon=23)
    return env


def phase_callable_env(device, batch=65536, n_steps=100, scenario=1, ref_replicas=4):
    """Engine surfaces (b): ``BatchedContinuousEnv`` on ``scenario`` with the
    three callables (:func:`_callable_continuous_env`), which the engine
    calls once per replica.  ``ref_replicas`` in float64 on the device equal
    freshly built host envs bitwise in reward, done and observation; then
    ``batch`` replicas in float32, ``RandomState(0)`` actions, as a timed
    ``step()`` loop and ``rollout(shared_step=True)``, equal bitwise."""
    import torch

    from pymgrid_tpu_torch.parallel import BatchedContinuousEnv

    venv = BatchedContinuousEnv(_callable_continuous_env(scenario), batch, "float32", device)
    _check(any(ref.custom_fn is not None for ref in venv.spec.controllable)
           and any(ref.forecaster == "user" for ref in venv.spec.log_order),
           "callable env: the spec carries no callables")
    actions_np = np.random.RandomState(0).rand(n_steps, batch, venv.action_dim).astype(np.float32)
    actions = torch.as_tensor(actions_np, device=device)

    host = [_host_env_run(_callable_continuous_env(scenario),
                          [actions_np[k, b].astype(np.float64) for k in range(n_steps)])
            for b in range(ref_replicas)]
    venv64 = BatchedContinuousEnv(_callable_continuous_env(scenario), ref_replicas, "float64",
                                  device)
    states = venv64.reset(seed=0)
    for k in range(n_steps):
        states, out = venv64.step(states, actions[k, :ref_replicas])
        for b, (r, d, o) in enumerate(host):
            _check(out.reward[b].item() == r[k] and bool(out.done[b]) == d[k]
                   and np.array_equal(out.obs[b].cpu().numpy(), o[k]),
                   f"callable env float64: step {k} replica {b} differs from the host env")

    venv.step(venv.reset(seed=0), actions[0])   # first launches, not timed

    def step_loop():
        states, outs = venv.reset(seed=0), []
        for k in range(n_steps):
            states, out = venv.step(states, actions[k], keep_logs=False)
            outs.append(out)
        return outs

    outs, loop_s = _timed(step_loop, device)
    loop = {f: torch.stack([getattr(o, f) for o in outs]) for f in ("reward", "done", "obs")}
    del outs
    _check(bool(torch.isfinite(loop["reward"]).all()) and bool(torch.isfinite(loop["obs"]).all()),
           "callable env: non-finite step outputs")
    (_, shared), shared_s = _timed(
        lambda: venv.rollout(venv.reset(seed=0), actions, shared_step=True), device)
    for f in ("reward", "done", "obs"):
        _check(torch.equal(getattr(shared, f), loop[f]),
               f"callable env: rollout(shared_step=True) {f} differs from the step loop")
    return {"step_loop_s": loop_s, "shared_rollout_s": shared_s,
            "step_loop_per_s": batch * n_steps / loop_s,
            "shared_rollout_per_s": batch * n_steps / shared_s}


def _costs(rewards):
    return -np.asarray(rewards, np.float64).sum(axis=0)


@contextlib.contextmanager
def _recorded_box_solvers(keep_calls):
    """Inside the block every box-IPM solver that ``SuiteMPC`` builds is
    recorded: ``{"args": (K_eq, K_in), "kw": ..., "calls": [(c, b, h), ...],
    "n_calls": n}``, with copies of the inputs of its first ``keep_calls``
    solves, in the order they were built."""
    from pymgrid_tpu_torch.algos import mpc_suite

    factory = mpc_suite.make_batched_box_ipm_solver
    made = []

    def recording(K_eq, K_in, **kw):
        solve = factory(K_eq, K_in, **kw)
        entry = {"args": (K_eq, K_in), "kw": kw, "calls": [], "n_calls": 0}
        made.append(entry)

        def run(c, b, h):
            if len(entry["calls"]) < keep_calls:
                entry["calls"].append(tuple(v.clone() for v in (c, b, h)))
            entry["n_calls"] += 1
            return solve(c, b, h)
        return run

    mpc_suite.make_batched_box_ipm_solver = recording
    try:
        yield made
    finally:
        mpc_suite.make_batched_box_ipm_solver = factory


def phase_suite_mpc(device, n_scenarios=25, n_steps=48, held=(0, 4, 1), rtol=0.02,
                    keep_calls=4):
    """``SuiteMPC`` over scenarios ``0..n_scenarios-1`` in the published chip
    mode (float32, box IPM, ``enum_bits=3``, ``enum_chunk=16``, ``iters=60``,
    ``newton_refine=2``) and the same run in float64; every reward finite,
    the ``held`` scenarios' float32 costs within ``rtol`` of float64 (the bar
    of ``tests/test_mpc_suite.py::test_suite_mpc_chip_mode_f32_parity``).
    The float32 run's solves in the box IPM's kernel are counted
    (``kernel_solves``: one launch each, eager or replayed) beside its
    box-IPM solves (``box_solves``), and its two solvers (the final re-solve's
    and the enumeration's) kept with the inputs of their first
    ``keep_calls`` solves, for :func:`phase_box_ipm`."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import SuiteMPC
    from pymgrid_tpu_torch.utils.profiling import recorded_counts

    def run(dtype, **kw):
        mgs = [Microgrid.from_scenario(n) for n in range(n_scenarios)]
        suite = SuiteMPC(mgs, dtype=dtype, device=device, enum_bits=3, enum_chunk=16, **kw)
        (rewards, _), seconds = _timed(lambda: suite.run_scanned(n_steps, chunk=n_steps), device)
        _check(rewards.shape == (n_steps, n_scenarios) and np.isfinite(rewards).all(),
               f"suite MPC {dtype}: non-finite or misshapen rewards")
        return _costs(rewards), seconds

    with _recorded_box_solvers(keep_calls) as solvers, recorded_counts() as counts:
        cost32, s32 = run("float32", iters=60, newton_refine=2, matmul_precision="float32")
    cost64, s64 = run("float64")
    gap = np.abs(cost32 / cost64 - 1.0)
    for n in held:
        _check(gap[n] < rtol, f"suite MPC scenario {n}: float32 cost {cost32[n]:.2f} vs "
                              f"float64 {cost64[n]:.2f} ({gap[n]:.3%})")
    return {"cost32": cost32, "cost64": cost64, "seconds32": s32, "seconds64": s64,
            "ms_per_hour32": s32 / n_steps * 1e3, "ms_per_hour64": s64 / n_steps * 1e3,
            "max_rel_gap": float(gap.max()), "held_max_rel_gap": float(gap[list(held)].max()),
            "kernel_solves": counts.get("pymgrid.lp.kernel_solves", 0),
            "box_solves": sum(e["n_calls"] for e in solvers), "box_solvers": solvers}


def phase_batched_mpc(device, batch=1024, n_steps=24, n_steps32=6, scenario=1,
                      expected_fallbacks=0, rtol32=0.02, rtol_host=1e-4):
    """``BatchedMPC`` on scenario 1 (genset MILP, ``enum_bits=5``): one
    float64 replica with the host fallback over ``n_steps`` hours, within
    ``rtol_host`` of the host HiGHS MILP MPC
    (``tests/test_lp_mpc.py::test_batched_mpc_genset_milp_matches_host``)
    with the fallback count of the port's CPU run
    (``tests/test_torch_mpc_genset.py``); ``batch`` float32 replicas without
    host fallback over the first ``n_steps32`` of those hours, all bitwise
    equal (deterministic copies) and within ``rtol32`` of the float64 run's
    cost over the same hours.  The float32 width is device-bound at ~6.7 s
    per hour, so it runs the shorter prefix."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import BatchedMPC, ModelPredictiveControl

    mg = lambda: Microgrid.from_scenario(scenario)
    f32 = BatchedMPC(mg(), batch_size=batch, dtype="float32", device=device, enum_bits=5,
                     host_fallback=False)
    (r32, _), s32 = _timed(lambda: f32.run_scanned(n_steps32), device)
    _check(r32.shape == (n_steps32, batch) and np.isfinite(r32).all(),
           "batched MPC float32: non-finite or misshapen rewards")
    _check(bool((r32 == r32[:, :1]).all()), "batched MPC float32: replicas differ")

    f64 = BatchedMPC(mg(), batch_size=1, dtype="float64", device=device, enum_bits=5,
                     host_fallback=True)
    (r64, _), s64 = _timed(lambda: f64.run(n_steps), device)
    log = ModelPredictiveControl(mg()).run(max_steps=n_steps)
    host = float(-log[("balance", 0, "reward")].sum())
    cost32, cost64 = float(_costs(r32[:, :1])[0]), float(_costs(r64)[0])
    prefix64 = float(_costs(r64[:n_steps32])[0])
    rel_host = abs(cost64 - host) / abs(host)
    rel32 = abs(cost32 - prefix64) / abs(prefix64)
    _check(rel_host < rtol_host, f"batched MPC float64 cost {cost64:.4f} vs host HiGHS "
                                 f"{host:.4f}: rel {rel_host:.3e}")
    _check(rel32 < rtol32, f"batched MPC float32 cost {cost32:.4f} vs float64 "
                           f"{prefix64:.4f} over {n_steps32} hours")
    _check(f64.fallback_count == expected_fallbacks,
           f"batched MPC float64: {f64.fallback_count} host fallbacks, "
           f"{expected_fallbacks} on the CPU")
    return {"cost32": cost32, "cost64": cost64, "host_cost": host, "rel_host": rel_host,
            "rel32": rel32, "seconds32": s32, "seconds64": s64, "n_steps": n_steps,
            "n_steps32": n_steps32, "ms_per_hour32": s32 / n_steps32 * 1e3,
            "ms_per_hour64": s64 / n_steps * 1e3, "fallback_count": f64.fallback_count}


def phase_saa(device, n_steps=24, n_samples=10, scenario=0, seed=0):
    """``BatchedSAA`` on scenario 0: with every sample the real data it
    equals a float64 ``BatchedMPC`` run at rtol 1e-5
    (``tests/test_lp_mpc.py::test_batched_saa_degenerate_equals_mpc``); with
    ``n_samples`` futures (MAPE preset 85, float32) every reward is finite
    and the executed sample sits at ``floor(N * 0.5)`` of the sorted costs."""
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import BatchedMPC, BatchedSAA
    from pymgrid_tpu_torch.utils.data_generator import return_underlying_data

    mg = lambda: Microgrid.from_scenario(scenario)
    real = return_underlying_data(mg().to_nonmodular())
    saa = BatchedSAA(mg(), n_samples=3, samples=[real.copy() for _ in range(3)],
                     dtype="float64", device=device)
    r_saa, s_saa = _timed(lambda: saa.run(n_steps)[0], device)
    r_mpc = BatchedMPC(mg(), batch_size=1, dtype="float64", device=device).run(n_steps)[0][:, 0]
    rel = float(np.max(np.abs(r_saa - r_mpc) / np.maximum(np.abs(r_mpc), 1e-8)))
    _check(np.allclose(r_saa, r_mpc, rtol=1e-5, atol=1e-8),
           f"degenerate SAA vs BatchedMPC: max rel {rel:.3e}")

    rng_state = np.random.get_state()
    np.random.seed(seed)   # the host sample generators draw from np.random
    try:
        sampled = BatchedSAA(mg(), n_samples=n_samples, preset_to_use=85, dtype="float32",
                             device=device)
    finally:
        np.random.set_state(rng_state)

    def loop():
        state, outs = sampled.reset(), []
        for _ in range(n_steps):
            state, out, costs, chosen = sampled.step(state)
            outs.append((out.reward, costs, chosen))
        return outs

    outs, s_sampled = _timed(loop, device)
    rewards = torch.stack([o[0] for o in outs]).cpu().numpy()
    costs = torch.stack([o[1] for o in outs]).cpu().numpy()
    chosen = torch.stack([o[2] for o in outs]).cpu().numpy()
    k = int(np.floor(n_samples * 0.5))
    _check(np.isfinite(rewards).all() and np.isfinite(costs).all(),
           "sampled SAA: non-finite rewards or costs")
    _check(all(c[i] == np.sort(c)[k] for c, i in zip(costs, chosen)),
           "sampled SAA: the executed sample is not the median of the sorted costs")
    return {"degenerate_max_rel": rel, "seconds_degenerate": s_saa,
            "seconds_sampled": s_sampled, "ms_per_hour_degenerate": s_saa / n_steps * 1e3,
            "ms_per_hour_sampled": s_sampled / n_steps * 1e3,
            "sampled_cost": float(-rewards.astype(np.float64).sum()),
            "picks": chosen.tolist()}


def _gradient_stream(shapes, n_steps, seed):
    """Float32 gradients per step and parameter: normals times ``10**k``,
    ``k`` uniform in ``[-30, 3]`` per entry, a tenth of the entries zero, the
    last parameter's all zero; and the starting parameters."""
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(n_steps):
        grads = []
        for shape in shapes:
            g = rng.standard_normal(shape) * 10.0 ** rng.uniform(-30, 3, shape)
            g[rng.random(shape) < 0.1] = 0.0
            grads.append(g.astype(np.float32))
        grads[-1][:] = 0.0
        stream.append(grads)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes], stream


def phase_adam(device, n_steps=12, seed=0, lr=3e-4, iters=20, trace_dir=None):
    """The port's ``optax.adam`` (``pymgrid_tpu_torch.utils.optax_adam.Adam``)
    on the card against the CPU: one float32 gradient stream
    (:func:`_gradient_stream`) over A2C's parameters at the published width
    (scenario 1, MLP 64-64), ES's flat vector (scenario 0, continuous,
    hidden 32) and an untouched bias, ``n_steps`` steps, the parameters
    ``torch.equal`` after every step.  On the card also the CUDA-event
    milliseconds of one step over A2C's parameters beside
    ``torch.optim.Adam``'s (its default multi-tensor path) on the same
    parameters and gradients; with ``trace_dir`` also the device events and
    busy time of one step of the port's under ``utils.profiling.trace``."""
    import torch

    from pymgrid_tpu_torch.utils.profiling import device_summary, trace

    from pymgrid_tpu_torch.examples.train_es import build_es
    from pymgrid_tpu_torch.examples.train_rl import build_training
    from pymgrid_tpu_torch.utils.optax_adam import Adam

    a2c = [tuple(p.shape) for p in build_training(scenario=1, batch=1, rollout_len=1,
                                                  device="cpu").init_theta().parameters()]
    es_dim = build_es(scenario=0, pop=2, hidden=32, n_steps=1, continuous=True,
                      device="cpu").dim
    params, stream = _gradient_stream(a2c + [(es_dim,), (64,)], n_steps, seed)

    def run(dev):
        tparams = [torch.nn.Parameter(torch.tensor(x, device=dev)) for x in params]
        opt, history = Adam(tparams, lr), []
        for grads in stream:
            for p, g in zip(tparams, grads):
                p.grad = torch.as_tensor(g, device=dev)
            opt.step()
            history.append(torch.cat([p.detach().reshape(-1) for p in tparams]).cpu())
        return tparams, history

    tparams, got = run(device)
    _, want = run("cpu")
    for step, (g, w) in enumerate(zip(got, want)):
        _check(torch.equal(g, w), f"Adam step {step} on the card differs from the CPU's at "
                                  f"{int((g != w).sum())} of {w.numel()} parameters")
    _check(torch.equal(got[-1][-64:], torch.as_tensor(params[-1])),
           "Adam moved a parameter whose gradient is zero")
    out = {"n_steps": n_steps, "n_params": want[0].numel(), "a2c_params": sum(
        int(np.prod(s)) for s in a2c)}
    if torch.device(device).type == "cuda":
        a2c_params = tparams[:len(a2c)]
        ours, lib = Adam(a2c_params, lr), torch.optim.Adam(a2c_params, lr=lr)
        out["ms"] = _event_ms(ours.step, iters)
        out["torch_adam_ms"] = _event_ms(lib.step, iters)
    if trace_dir is not None:
        opt = Adam(tparams, lr)
        opt.step()
        with trace(str(trace_dir), device) as prof:
            opt.step()
        summary = device_summary(prof)
        out["events"], out["busy_ms"] = summary["kernels"], summary["busy_ms"]
    return out


def _a2c_step_fed(run, actions, device):
    """One A2C iteration of ``run`` with fed actions from the seed-0
    weights; returns the loss and the updated parameters (on the CPU)."""
    import torch

    from pymgrid_tpu_torch.utils.optax_adam import Adam

    theta = run.init_theta(seed=0)
    adam = Adam(theta.parameters(), lr=run.lr)
    *_, loss, _ = run.train_step(theta, adam, *run.init_envs(), actions=actions)
    return loss.item(), torch.cat([p.detach().reshape(-1) for p in theta.parameters()]).cpu()


def _a2c_step_sampled(run, seed=0):
    """The first iteration of ``run(seed=seed)`` from the seed-0 weights,
    its actions drawn from JAX's keys (``categorical`` of the keys folded
    with iteration 0), each draw recorded with its margin: the gap between
    its two best ``logits + gumbel``, over ``max(1, |best|)``.  Returns the
    loss, the mean return, and the ``(T, B)`` actions and margins (on the
    CPU)."""
    import torch

    from pymgrid_tpu_torch.core import prng
    from pymgrid_tpu_torch.utils.optax_adam import Adam

    drawn, categorical = [], prng.categorical

    def recorded(keys, logits):
        top = (prng.gumbel(keys, logits.shape[-1:], logits.dtype) + logits).topk(2).values
        drawn.append((categorical(keys, logits),
                      (top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(1.0)))
        return drawn[-1][0]

    theta = run.init_theta(seed=0)
    adam = Adam(theta.parameters(), lr=run.lr)
    keys = prng.fold_in(run.rollout_keys(seed), 0)
    prng.categorical = recorded
    try:
        *_, loss, mean_ret = run.train_step(theta, adam, *run.init_envs(seed), keys=keys)
    finally:
        prng.categorical = categorical
    actions, margins = (torch.stack(x).cpu() for x in zip(*drawn))
    return loss.item(), mean_ret.item(), actions, margins


def phase_a2c(device, scenario=1, batch=4096, rollout_len=128, iters=5, entropy_coef=0.02,
              rtol=1e-4, tie=1e-5, trace_dir=None):
    """A2C (``pymgrid_tpu_torch.examples.train_rl``) at the published width:
    one iteration with fed actions (``RandomState(0)``) equal to the same
    iteration on the CPU in float32 at ``rtol`` (loss and updated
    parameters; an entry near 0 to ``rtol`` of the Adam step); the first
    sampled iteration of a seed-0 run (JAX's threefry draws) against the
    same iteration on the CPU: every action equal but where the CPU's draw
    is a near tie (relative margin at most ``tie``: the logits differ by
    the fed-action gap), and with no such flip the loss and mean return at
    ``rtol``; then ``iters`` sampled iterations timed (the history
    finite).  With
    ``trace_dir`` one more sampled iteration runs under
    ``utils.profiling.trace``: device events and busy time per iteration,
    and the idle share against the profiled wall time and against the
    unprofiled iteration time (the profiler slows the host side)."""
    import torch

    from pymgrid_tpu_torch.core import prng
    from pymgrid_tpu_torch.examples.train_rl import build_training
    from pymgrid_tpu_torch.utils.optax_adam import Adam
    from pymgrid_tpu_torch.utils.profiling import Throughput, device_summary, trace

    kw = dict(scenario=scenario, batch=batch, rollout_len=rollout_len,
              entropy_coef=entropy_coef)
    run = build_training(device=device, **kw)
    actions = np.random.RandomState(0).randint(run.n_actions, size=(rollout_len, batch))
    loss, params = _a2c_step_fed(run, actions, device)
    ref_loss, ref_params = _a2c_step_fed(build_training(device="cpu", **kw), actions, "cpu")
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    params_err = (params - ref_params).abs().max().item()
    _check(loss_rel <= rtol, f"A2C fed-action loss {loss} vs CPU {ref_loss}: rel {loss_rel:.3e}")
    _check(torch.allclose(params, ref_params, rtol=rtol, atol=rtol * run.lr),
           f"A2C fed-action parameters vs CPU: max abs diff {params_err:.3e}")

    s_loss, s_ret, s_actions, _ = _a2c_step_sampled(run)
    ref = _a2c_step_sampled(build_training(device="cpu", **kw))
    flips = s_actions != ref[2]
    flip_margin = float(ref[3][flips].max()) if flips.any() else 0.0
    _check(flip_margin <= tie, f"A2C sampled iteration: {int(flips.sum())} actions differ from "
                               f"the CPU's, at a relative margin up to {flip_margin:.3e} > {tie}")
    sampled_rel = max(abs(s_loss - ref[0]) / abs(ref[0]), abs(s_ret - ref[1]) / abs(ref[1]))
    _check(flips.any() or sampled_rel <= rtol,
           f"A2C sampled iteration vs CPU: loss {s_loss} / {ref[0]}, mean return {s_ret} / "
           f"{ref[1]}: rel {sampled_rel:.3e} > {rtol}")

    with Throughput(batch, rollout_len * iters, device) as meter:
        theta, _, history = run(iters=iters, log_every=iters)
    _check(len(history) == iters and bool(np.isfinite(history).all()),
           f"A2C history not finite: {history}")
    out = {"loss_rel_vs_cpu": loss_rel, "params_max_abs_vs_cpu": params_err,
           "sampled_rel_vs_cpu": sampled_rel, "sampled_flips": int(flips.sum()),
           "sampled_draws": flips.numel(),
           "sampled_min_margin": float(ref[3].min()), "sampled_loss": s_loss,
           "rtol": rtol, "tie": tie, "seconds": meter.elapsed, "steps_per_s": meter.steps_per_sec,
           "ms_per_iter": meter.elapsed / iters * 1e3, "history": history}
    if trace_dir is not None:
        adam = Adam(theta.parameters(), lr=run.lr)
        states, obs = run.init_envs(seed=1)
        keys = prng.fold_in(run.rollout_keys(seed=1), 0)
        with trace(str(trace_dir), device) as prof:
            t0 = time.perf_counter()
            run.train_step(theta, adam, states, obs, keys=keys)
            _sync(device)
            wall = time.perf_counter() - t0
        summary = device_summary(prof)
        out.update(profiled_ms=wall * 1e3, device_events=summary["kernels"],
                   busy_ms=summary["busy_ms"],
                   idle_share=1.0 - summary["busy_ms"] / (wall * 1e3),
                   idle_share_unprofiled=1.0 - summary["busy_ms"] / out["ms_per_iter"])
    return out


def phase_es(device, scenario=0, pop=256, hidden=32, n_steps=1000, gens=2, rtol=1e-5):
    """Continuous ES (``pymgrid_tpu_torch.examples.train_es``) at the
    published width with the depth cut to ``n_steps``: the population's
    returns at a fixed theta and noise (``RandomState(0)``) equal the CPU
    float32 run at ``rtol`` (measured on the H100: 2.4e-7; the MLPs' sums
    run in other orders on the two devices); a seed-0 run's draws on the
    card, ``theta0`` and the first generation's noise (JAX's threefry
    normals), ``torch.equal`` to the CPU's (float32 normals are JAX's bits on
    either device, :func:`phase_draws`); then ``gens`` generations timed."""
    import torch

    from pymgrid_tpu_torch.core import prng
    from pymgrid_tpu_torch.examples.train_es import build_es
    from pymgrid_tpu_torch.utils.profiling import Throughput

    kw = dict(scenario=scenario, pop=pop, hidden=hidden, n_steps=n_steps, continuous=True)
    run = build_es(device=device, **kw)
    rng = np.random.RandomState(0)
    theta = (0.3 * rng.randn(run.dim)).astype(np.float32)
    eps = rng.randn(pop // 2, run.dim).astype(np.float32)
    thetas = theta[None] + run.sigma * np.concatenate([eps, -eps])
    got = run.episode_returns(thetas).double().cpu().numpy()
    want = build_es(device="cpu", **kw).episode_returns(thetas).double().numpy()
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    _check(np.isfinite(got).all() and rel <= rtol,
           f"ES population returns vs CPU float32: max rel {rel:.3e} > {rtol}")

    cpu_run = build_es(device="cpu", **kw)
    draws_err = 0.0
    for what, draw in (("theta0", lambda r, d: r.initial_theta(0)),
                       ("first noise", lambda r, d: r.noise(prng.fold_in(prng.key(0, d), 1000)))):
        x, want = draw(run, device).cpu(), draw(cpu_run, "cpu")
        _check(x.shape == want.shape, f"ES {what}: shape {tuple(x.shape)} on the card")
        draws_err = max(draws_err, float((x - want).abs().max()))
        _check(torch.equal(x, want), f"ES {what} on the card vs CPU: {int((x != want).sum())} "
                                     f"entries differ, max abs diff {draws_err:.3e}")

    with Throughput(pop, n_steps * gens, device) as meter:
        _, history = run(gens=gens, log_every=gens)
    _check(len(history) == gens and bool(np.isfinite(history).all()),
           f"ES history not finite: {history}")
    return {"max_rel_vs_cpu": rel, "draws_max_abs_vs_cpu": draws_err, "seconds": meter.elapsed,
            "ms_per_gen": meter.elapsed / gens * 1e3, "steps_per_s": meter.steps_per_sec,
            "history": history, "rbc": run.rbc_baseline()}


def phase_dryrun(device, rtol=1e-5):
    """``entry.dryrun_multichip(1)``: the data-parallel REINFORCE step, the
    meshed env rollouts and the meshed suite over a one-process group (NCCL
    on the card); its loss and mean return, drawn from JAX's keys, equal
    the same call on the CPU (gloo) at ``rtol``."""
    from pymgrid_tpu_torch.entry import dryrun_multichip

    result, seconds = _timed(lambda: dryrun_multichip(1, device=device), device)
    ref = dryrun_multichip(1, device="cpu")
    rel = max(abs(result[k] - ref[k]) / abs(ref[k]) for k in ("loss", "mean_return"))
    _check(rel <= rtol, f"dryrun loss / mean return {result['loss']} / {result['mean_return']} "
                        f"vs CPU {ref['loss']} / {ref['mean_return']}: rel {rel:.3e} > {rtol}")
    return {**result, "seconds": seconds, "rel_vs_cpu": rel, "rtol": rtol}


def phase_random_policy(device, batch=65536, scenario=0, seed=0):
    """``make_random_policy`` (float32) at ``batch`` replicas of ``scenario``
    keyed by ``split(key(seed), batch)``: one policy call and one
    ``normalized=True`` step, timed after a first call.  The actions equal
    the same draw on the CPU bitwise (float32 uniforms are built from
    threefry bits); the rewards are finite."""
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core import prng
    from pymgrid_tpu_torch.core.engine import make_reset_fn, make_step_fn
    from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
    from pymgrid_tpu_torch.core.rollout import make_random_policy
    from pymgrid_tpu_torch.core.spec import extract_spec

    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    policy, step = make_random_policy(spec), make_step_fn(spec, normalized=True)

    def run(dev):
        tparams = with_config_axis(params_to_torch(params, dev, torch.float32))
        starts = tparams["initial_step"].to(torch.int32).view(1, 1).expand(1, batch)
        state = make_reset_fn(spec)(tparams, starts, prng.split(prng.key(seed, dev), batch)[None])

        def one():
            action = policy(tparams, state)
            return action, step(tparams, state, action)[1]

        one()
        return _timed(one, dev)

    (action, out), seconds = run(device)
    (want, _), _ = run("cpu")
    for k in want:
        _check(torch.equal(action[k].cpu(), want[k]),
               f"random policy: {k} actions on the card differ from the CPU's")
    _check(bool(torch.isfinite(out.reward).all()), "random policy: non-finite rewards")
    return {"seconds": seconds, "n_actions": sum(v.numel() for v in want.values())}


def phase_draws(device, n_keys=65536, window=(23, 4), n_actions=5, seed=0, iters=20):
    """JAX's float draws on the card against the same calls on the CPU, over
    the keys ``split(key(seed), n_keys)``: ``prng.normal`` in float32 and
    float64 (one gaussian-forecast ``window`` per key), ``prng.gumbel`` in
    float32 (``n_actions`` per key) and ``prng.categorical`` of
    ``RandomState(seed)`` float32 logits.  The float32 draws are
    ``torch.equal`` to the CPU's: every step of XLA's ``log`` and ``log1p``
    is its own op, so it rounds once on either device.  Float64 normals are
    equal where ``log1p`` takes its rational (``u**2 < sqrt(2) - 1``); off
    it, ``torch.log`` may round differently on the two devices (the root is
    IEEE's on both, ``prng._sqrt_f64``): every differing normal is one whose
    ``log1p`` differs between them, and both counts are returned.  On the card
    also the CUDA-event milliseconds of the float32 normal and gumbel draws,
    and of ``_xla_log1p`` and ``_xla_log_f32`` beside the single
    ``torch.log1p`` and ``torch.log`` they replace, on the same inputs."""
    import torch

    from pymgrid_tpu_torch.core import prng

    logits = np.random.RandomState(seed).randn(n_keys, n_actions).astype(np.float32)

    def draws(dev):
        keys = prng.split(prng.key(seed, dev), n_keys)
        return {"normal32": prng.normal(keys, window, torch.float32),
                "normal64": prng.normal(keys, window, torch.float64),
                "gumbel32": prng.gumbel(keys, (n_actions,), torch.float32),
                "categorical": prng.categorical(keys, torch.as_tensor(logits, device=dev))}

    got, want = draws(device), draws("cpu")
    for name in ("normal32", "gumbel32", "categorical"):
        _check(torch.equal(got[name].cpu(), want[name]),
               f"draws: {name} on the card differs from the CPU's at "
               f"{int((got[name].cpu() != want[name]).sum())} of {want[name].numel()}")
    keys = prng.split(prng.key(seed, "cpu"), n_keys)
    u = prng.uniform(keys, window, torch.float64, np.nextafter(-1.0, 0.0), 1.0)
    rational = u * u < np.sqrt(2) - 1
    differ = got["normal64"].cpu() != want["normal64"]
    _check(not bool((differ & rational).any()),
           f"draws: {int((differ & rational).sum())} float64 normals in log1p's rational "
           f"differ from the CPU's")
    arg = -u * u
    log1p_differ = prng._xla_log1p(arg.to(device)).cpu() != prng._xla_log1p(arg)
    _check(not bool((differ & ~log1p_differ).any()),
           f"draws: {int((differ & ~log1p_differ).sum())} float64 normals differ from the "
           f"CPU's where their log1p agrees")
    out = {"n_keys": n_keys, "normal_elements": want["normal64"].numel(),
           "normal64_differ": int(differ.sum()), "normal64_off_rational": int((~rational).sum()),
           "normal64_log1p_differ": int(log1p_differ.sum())}
    if torch.device(device).type == "cuda":
        keys = prng.split(prng.key(seed, device), n_keys)
        x = 2 * torch.rand((n_keys,) + window, device=device, generator=torch.Generator(
            device).manual_seed(seed)) - 1
        w, y = -x * x, x.abs() + 0.5
        out["ms"] = {
            "normal32": _event_ms(lambda: prng.normal(keys, window, torch.float32), iters),
            "gumbel32": _event_ms(lambda: prng.gumbel(keys, (n_actions,), torch.float32), iters),
            "xla_log1p32": _event_ms(lambda: prng._xla_log1p(w), iters),
            "torch_log1p32": _event_ms(lambda: torch.log1p(w), iters),
            "xla_log32": _event_ms(lambda: prng._xla_log_f32(y), iters),
            "torch_log32": _event_ms(lambda: torch.log(y), iters)}
    return out


def phase_suite_collect(device, n_configs=25, replicas=1024, n_steps=20, seed=0,
                        trace_dir=None, profile_steps=(4, 8), min_restarts=1):
    """The suite's collect rollout (float32) with randomized restarts: every
    step splits the replicas' keys and draws a start from them (kept where
    ``done``), as the JAX runner does.  Timed over ``n_steps``; its dones
    equal the CPU run's from the same keys, with at least ``min_restarts``
    restarts (about 58 expected at the default shape: a start within 20
    steps of the year's end).  With
    ``trace_dir``, device events per step under ``torch.profiler`` (the
    difference of two rollouts of ``profile_steps`` steps, so the reset
    cancels), beside the same collect rollout with fixed restarts, which
    carries no keys."""
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.parallel import SuiteRunner

    def runner_on(dev):
        mgs = [Microgrid.from_scenario(n) for n in range(n_configs)]
        return SuiteRunner(mgs, batch_per_config=replicas, dtype="float32", device=dev)

    def rollout(runner, steps, randomize=True):
        fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), steps,
                               auto_reset=True, collect=True, randomize_initial_step=randomize)
        return fn(runner.params, runner.make_keys(seed))

    runner = runner_on(device)
    rollout(runner, 1)                       # first launches, not timed
    (_, outs), seconds = _timed(lambda: rollout(runner, n_steps), device)
    _, want = rollout(runner_on("cpu"), n_steps)
    restarts = int(want.done.sum())
    _check(torch.equal(outs.done.cpu(), want.done) and restarts >= min_restarts,
           f"suite collect: dones on the card differ from the CPU's ({restarts} restarts)")
    _check(bool(torch.isfinite(outs.reward).all()), "suite collect: non-finite rewards")
    out = {"seconds": seconds, "restarts": restarts,
           "steps_per_s": n_configs * replicas * n_steps / seconds}
    if trace_dir is not None:
        for name, randomize in (("keyed", True), ("fixed", False)):
            out[f"events_per_step_{name}"] = collect_events_per_step(
                runner, device, Path(trace_dir) / name, randomize, profile_steps, seed)
    return out


def collect_events_per_step(runner, device, trace_dir, randomize=True, profile_steps=(4, 8),
                            seed=0):
    """Device events per step of ``runner``'s collect rollout (auto-reset,
    randomized restarts with ``randomize``) under ``torch.profiler``: the
    difference of two rollouts of ``profile_steps`` steps, each from
    ``make_keys(seed)``, so the reset cancels."""
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.utils.profiling import device_summary, trace

    counts = []
    for k, steps in enumerate(profile_steps):
        with trace(f"{trace_dir}{k}", device) as prof:
            fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), steps,
                                   auto_reset=True, collect=True,
                                   randomize_initial_step=randomize)
            fn(runner.params, runner.make_keys(seed))
        counts.append(device_summary(prof)["kernels"])
    return (counts[1] - counts[0]) / (profile_steps[1] - profile_steps[0])


def phase_tables_rbc(device, out_dir, scenario=0, n_steps=None):
    """``run_benchmarks``' RBC mode (``RuleBasedControl.run_compiled``,
    float64) for ``scenario`` through the tool's own entry; over the full
    year scenario 0 costs ``RESULTS.md``'s 956,059.66 to the cent (the JAX
    reference's bitwise figure).  The report it writes parses back to the
    same cost."""
    import re

    from pymgrid_tpu_torch.tools import run_benchmarks

    args = run_benchmarks.parse_args(["--device", str(device), "--scenarios", str(scenario),
                                      "--out", str(out_dir)])
    (row,), seconds = _timed(lambda: run_benchmarks.run_rbc(args, n_steps), device)
    cost = f"{row[1]:,.2f}"
    if scenario == 0 and n_steps is None:
        _check(cost == f"{FULL_YEAR_COST:,.2f}",
               f"tables/rbc: scenario 0 full-year cost {cost}, published {FULL_YEAR_COST:,.2f}")
    table = (Path(out_dir) / "RESULTS.md").read_text()
    _check(re.search(rf"^\| {scenario} \| {re.escape(cost)} \|", table, re.M) is not None,
           f"tables/rbc: the report does not hold the cost {cost}")
    return {"cost": row[1], "seconds": row[2], "wall_s": seconds}


def phase_tables_mpc_suite(device, out_dir, scenarios=(0, 1), n_steps=24):
    """``run_benchmarks --mpc-suite`` over ``scenarios`` (0 and 1: the
    genset-free group and the genset group) at an ``n_steps`` cap: finite
    costs, and the report parses back to them."""
    import re

    from pymgrid_tpu_torch.tools import run_benchmarks
    from pymgrid_tpu_torch.utils.profiling import recorded_counts

    args = run_benchmarks.parse_args(["--mpc-suite", "--device", str(device), "--scenarios",
                                      ",".join(map(str, scenarios)), "--out", str(out_dir)])
    with recorded_counts() as counts:
        (rows, report), seconds = _timed(lambda: run_benchmarks.run_mpc_suite(args, n_steps),
                                         device)
    _check([r[0] for r in rows] == list(scenarios)
           and all(np.isfinite(r[1]) and r[2] == n_steps for r in rows),
           f"tables/mpc_suite: rows {rows}")
    table = report.read_text()
    for n, cost, _, _ in rows:
        _check(re.search(rf"^\| {n} \| {re.escape(f'{cost:,.2f}')} \|", table, re.M)
               is not None, f"tables/mpc_suite: the report does not hold scenario {n}'s "
                            f"cost {cost:,.2f}")
    return {"costs": [r[1] for r in rows], "seconds": seconds,
            "ms_per_hour": seconds / n_steps * 1e3,
            "kernel_solves": counts.get("pymgrid.lp.kernel_solves", 0)}


_COST_LINE = r"^  (.+): (-?[\d,]+\.\d\d)$"


def phase_structure(device, n_steps=8758, rtol=1e-5):
    """The scenario-0 structure study (``examples.scenario0_structure``) on
    the card: at the full 8758 steps every printed return within ``rtol``
    (float32) of ``docs/captures/scenario0_structure.log`` and every other
    line identical (the tariff lines, ``handcrafted vs RBC: +5.24% cost``);
    at a cut depth the same against the twin on the CPU."""
    import re

    from pymgrid_tpu_torch.examples.scenario0_structure import run

    (lines, returns), seconds = _timed(lambda: run(device, n_steps), device)
    if n_steps == 8758:
        want = (REPO / "docs" / "captures" / "scenario0_structure.log").read_text().splitlines()
    else:
        want = run("cpu", n_steps)[0]
    _check(len(lines) == len(want), f"structure: {len(lines)} lines, reference {len(want)}")
    worst = 0.0
    for got, ref in zip(lines, want):
        g, r = re.match(_COST_LINE, got), re.match(_COST_LINE, ref)
        if g and r and g.group(1) == r.group(1):
            a, b = (float(m.group(2).replace(",", "")) for m in (g, r))
            worst = max(worst, abs(a - b) / abs(b))
            _check(abs(a - b) <= rtol * abs(b), f"structure: {got!r} vs {ref!r}")
        else:
            _check(got == ref, f"structure: {got!r} vs {ref!r}")
    return {"lines": lines, "returns": returns, "seconds": seconds, "max_rel": worst}


def phase_speed_tools(device, out_dir, scaling_configs=8, scaling_replicas=256,
                      scaling_steps=200, profile_batch=2048, profile_steps=100):
    """The speed tools through their entry points: ``run_benchmarks
    --scaling --scaling-chip`` into ``out_dir`` (the batch-size sweep over
    the tool's ``CHIP_CONFIGS`` x ``CHIP_REPLICAS``; ``--scaling`` in
    ``--scaling-worker`` subprocesses at the world sizes the host's cards
    allow, NCCL on the card, its world-size-1 checksums ``torch.equal`` to
    the unmeshed ``suite_throughput``'s from the same keys), every row
    parsed back from the report; then ``profile_env`` (finite rollouts)."""
    import re

    import torch

    from pymgrid_tpu_torch.tools import profile_env, run_benchmarks

    t0 = time.perf_counter()
    rank_rows, chip_rows, report = run_benchmarks.main(
        ["--scaling", "--scaling-chip", "--device", str(device), "--out", str(out_dir),
         "--scaling-configs", str(scaling_configs), "--scaling-replicas",
         str(scaling_replicas), "--scaling-steps", str(scaling_steps)])
    _check([r["replicas"] for r in chip_rows] == list(run_benchmarks.CHIP_REPLICAS)
           and all(r["env_steps_per_sec"] > 0 for r in chip_rows),
           f"speed/scaling-chip: rows {chip_rows}")
    _check(rank_rows and rank_rows[0]["devices"] == 1, f"speed/scaling: rows {rank_rows}")
    _, want = run_benchmarks.suite_throughput(scaling_configs, scaling_replicas,
                                              scaling_steps, device, repeats=1)
    got = torch.from_numpy(rank_rows[0]["checksums"])
    _check(torch.equal(got, want.cpu()),
           f"speed/scaling: world size 1 differs from the unmeshed runner, max abs diff "
           f"{(got - want.cpu()).abs().max().item():.3e}")
    table = report.read_text()
    for row in rank_rows:
        _check(re.search(rf"^\| {row['devices']} \| {row['env_steps_per_sec']:,.0f} \|",
                         table, re.M) is not None, f"speed/scaling: report lacks {row}")
    for row in chip_rows:
        _check(f"| {row['total_envs']:,} | {row['env_steps_per_sec']:,.0f} |" in table,
               f"speed/scaling-chip: report lacks {row}")
    profiled = profile_env.main(["--device", str(device), "--batch", str(profile_batch),
                                 "--steps", str(profile_steps)])
    for label, _, out in profiled:
        reward = out if torch.is_tensor(out) else out[1].reward
        _check(bool(torch.isfinite(reward).all()), f"speed/profile_env: {label} not finite")
    return {"rank_rows": rank_rows, "chip_rows": chip_rows,
            "profile": [(label, wall, profile_batch * profile_steps / wall)
                        for label, wall, _ in profiled],
            "seconds": time.perf_counter() - t0}


def phase_bench(device, knobs=None, trace_dir=None, collect_configs=25,
                collect_replicas=1024, profile_steps=(4, 8)):
    """The ``bench.py`` twin (``pymgrid_tpu_torch.tools.bench``) through its
    entry point, at ``bench.py``'s defaults unless ``knobs`` (``PYMGRID_BENCH_*``
    values) say otherwise: its one JSON line parsed back, every rate finite
    and above 0, the RBC kernel's launches in the run counted (each
    ``make_rbc_rollout`` the run makes is recorded).  With ``trace_dir``, the
    device events per step of the suite's collect rollout with int32
    restarts (``collect_configs`` x ``collect_replicas``, as
    :func:`phase_suite_collect`'s keyed count, which draws int64)."""
    import contextlib
    import io
    import os

    import torch

    from pymgrid_tpu_torch import Microgrid, ops
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.parallel import SuiteRunner
    from pymgrid_tpu_torch.tools import bench

    def bench_knobs():
        return {k: v for k, v in os.environ.items() if k.startswith("PYMGRID_BENCH_")}

    made, make = [], ops.make_rbc_rollout
    saved, stdout = bench_knobs(), io.StringIO()
    ops.make_rbc_rollout = lambda *a, **kw: made.append(make(*a, **kw)) or made[-1]
    for k in saved:
        del os.environ[k]
    os.environ.update(knobs or {})
    try:
        with contextlib.redirect_stdout(stdout):
            result, seconds = _timed(lambda: bench.main(["--device", str(device)]), device)
    finally:
        ops.make_rbc_rollout = make
        for k in bench_knobs():
            del os.environ[k]
        os.environ.update(saved)
    line = stdout.getvalue().strip().splitlines()[-1]
    _check(json.loads(line) == result, f"bench: the printed line is not the result: {line}")
    rates = {k: v for k, v in result.items() if k == "value" or k.endswith("_per_sec")}
    _check(len(rates) == 7 and all(np.isfinite(v) and v > 0 for v in rates.values()),
           f"bench: rates {rates}")
    launches = sum(r.launches for r in made)
    _check(torch.device(device).type == "cpu" or launches > 0,
           "bench: the kernel sweep launched no rbc_rollout kernel")
    out = {"line": line, "result": result, "seconds": seconds, "kernel_launches": launches}
    if trace_dir is not None:
        runner = SuiteRunner([Microgrid.from_scenario(n) for n in range(collect_configs)],
                             batch_per_config=collect_replicas, dtype="float32",
                             device=device, start_dtype=torch.int32)
        runner.rollout_fn(make_marginal_cost_policy(runner.spec), 1, auto_reset=True,
                          collect=True, randomize_initial_step=True)(
            runner.params, runner.make_keys(0))             # first launches, not counted
        out["collect_events_per_step_int32"] = collect_events_per_step(
            runner, device, Path(trace_dir) / "int32", True, profile_steps)
    return out


def phase_kernel_vs_plain(sweep, device, genset_batch=4096, genset_steps=8759):
    """The kernel against its plain PyTorch version, bitwise: at the
    main-path shape, on every pymgrid25 scenario (1024 x 64 steps) and on
    scenario 1 (genset, weak grid) at ``genset_batch`` x ``genset_steps``.
    Returns the plain version's time, the kernel's bound and each scenario's
    kernel variant."""
    import torch

    from pymgrid_tpu_torch.ops import make_rbc_rollout

    rollout, init, acc = sweep["rollout"], sweep["init"], sweep["acc"]
    plain, plain_s = _timed(lambda: rollout.plain(init), device)
    abs_err = (acc - plain).abs().max().item()
    _check(torch.equal(acc, plain), f"kernel vs plain: not bitwise, max abs diff {abs_err:.3e}")

    variants = []
    for n in range(25):
        spec, params, init_n = sweep_inputs(n, 1024, device)
        r = make_rbc_rollout(spec, params, 64, device)
        k, p = r(init_n), r.plain(init_n)
        _sync(device)
        _check(torch.equal(k, p), f"scenario {n}: kernel vs plain not bitwise, max abs "
                                  f"diff {(k - p).abs().max().item():.3e}")
        variants.append(r.variant)

    spec, params, init_g = sweep_inputs(1, genset_batch, device)
    r = make_rbc_rollout(spec, params, genset_steps, device)
    k, p = r(init_g), r.plain(init_g)
    _check(torch.equal(k, p), f"scenario 1 at {genset_batch} x {genset_steps}: kernel vs "
                              f"plain not bitwise, max abs diff {(k - p).abs().max().item():.3e}")
    return {"max_abs_err": abs_err, "plain_ms": plain_s * 1e3,
            "bound_ms": rollout.bound_ms(init.shape[0]), "variants": variants,
            "genset_variant": r.variant}


def _op_box_solver(K_eq, K_in, kw):
    """The box IPM's solver built with the op-by-op loop, wherever it runs."""
    from pymgrid_tpu_torch.core import lp

    runs = lp._box_kernel_runs
    lp._box_kernel_runs = lambda *args: False
    try:
        return lp.make_batched_box_ipm_solver(K_eq, K_in, **kw)
    finally:
        lp._box_kernel_runs = runs


def _highs_objectives(K_eq, K_in, c, b, h):
    """Each LP's optimal objective by HiGHS, in float64 (``x >= 0``,
    problem ``p`` on matrix ``p % S``)."""
    from scipy.optimize import linprog

    K_eq, K_in = (np.asarray(K, np.float64) for K in (K_eq, K_in))
    K_eq, K_in = (K if K.ndim == 3 else K[None] for K in (K_eq, K_in))
    c, b, h = (v.double().cpu().numpy() for v in (c, b, h))
    S, objs = K_eq.shape[0], []
    for p in range(c.shape[0]):
        res = linprog(c[p], A_ub=K_in[p % S], b_ub=h[p], A_eq=K_eq[p % S], b_eq=b[p],
                      bounds=(0, None), method="highs")
        _check(res.success, f"HiGHS failed on LP {p}: {res.message}")
        objs.append(res.fun)
    return np.array(objs)


def _kernel_device_ms(fn, iters, name="box_ipm_kernel"):
    """Mean device milliseconds of the kernel ``name`` over ``iters`` calls
    of ``fn`` under ``torch.profiler``, after one call to warm up; each
    call must launch it once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    _check(len(times) == iters, f"{name}: {len(times)} device events in {iters} calls")
    return sum(times) / iters / 1e3


def phase_box_ipm(device, solvers, timing_iters=10, residual_tol=1e-2):
    """The box IPM's kernel (``csrc/box_ipm.cu``) against the op-by-op solve,
    its plain PyTorch version, on the LPs that :func:`phase_suite_mpc`'s
    float32 planner solved (``solvers``: its final re-solve's and its
    enumeration's solver, each with the inputs of its first solves), for each
    solve shape: the relaxation, the pattern chunk, the final re-solve.  The
    kernel must run on one side (``pymgrid.lp.kernel_solves``) and not on
    the other; its objectives must lie within twice the op path's largest
    distance to HiGHS's optimum of the LP (relative to ``1 + |J*|``), its
    outputs be finite, and its residuals below ``residual_tol``, the line
    past which the port's float32 planner takes a solve as infeasible
    (``BatchedMPC``'s default; both paths end far below it, at float32's
    rounding, where two solvers that round differently are not ordered).  At
    one hour's shapes, on the card: the kernel's device time (mean of
    ``timing_iters`` eager launches), the op path's (CUDA events, replayed
    as the planner does) and the kernel's bound
    (:func:`pymgrid_tpu_torch.ops.box_ipm.bound_ms`).  On a CPU both sides
    run the op path and no time is taken."""
    import torch

    from pymgrid_tpu_torch.core import lp
    from pymgrid_tpu_torch.ops import box_ipm
    from pymgrid_tpu_torch.utils.profiling import recorded_counts

    cuda = torch.device(device).type == "cuda"
    final, enum = solvers
    n_relax = final["calls"][0][0].shape[0]     # one problem a scenario
    shapes = {"relaxation": (enum, [v for v in enum["calls"] if len(v[0]) == n_relax]),
              "chunk": (enum, [v for v in enum["calls"] if len(v[0]) != n_relax]),
              "final": (final, final["calls"])}
    out = {}
    for name, (entry, calls) in shapes.items():
        _check(len(calls) > 0, f"box IPM {name}: no solve recorded")
        K_eq, K_in = entry["args"]
        kw = entry["kw"]
        c, b, h = (torch.cat(parts) for parts in zip(*calls))
        with recorded_counts() as counts:
            x_k, info_k = lp.make_batched_box_ipm_solver(K_eq, K_in, **kw)(c, b, h)
        _check(counts.get("pymgrid.lp.kernel_solves", 0) == int(cuda),
               f"box IPM {name}: the kernel ran {counts} (CUDA: {cuda})")
        ops = _op_box_solver(K_eq, K_in, kw)
        with recorded_counts() as counts:
            x_o, info_o = ops(c, b, h)
        _check("pymgrid.lp.kernel_solves" not in counts, f"box IPM {name}: the op path "
                                                         f"ran the kernel")
        _sync(device)
        j_star = _highs_objectives(K_eq, K_in, c, b, h)
        scale = 1.0 + np.abs(j_star)
        obj_k, obj_o = (i["objective"].double().cpu().numpy() for i in (info_k, info_o))
        op_gap = float((np.abs(obj_o - j_star) / scale).max())
        kernel_gap = float((np.abs(obj_k - j_star) / scale).max())
        kernel_vs_op = float((np.abs(obj_k - obj_o) / scale).max())
        r_k, r_o = info_k["residual"].max().item(), info_o["residual"].max().item()
        _check(bool(torch.isfinite(x_k).all()) and bool(torch.isfinite(info_k["gap"]).all()),
               f"box IPM {name}: non-finite kernel output")
        _check(kernel_gap <= 2 * op_gap and kernel_vs_op <= 2 * op_gap,
               f"box IPM {name}: kernel objectives {kernel_gap:.3e} from HiGHS's and "
               f"{kernel_vs_op:.3e} from the op path's, limit {2 * op_gap:.3e}")
        _check(r_k <= residual_tol, f"box IPM {name}: kernel residual {r_k:.3e} (op "
                                    f"{r_o:.3e}) above {residual_tol}")

        stack = np.asarray(K_eq)
        S, me, n = stack.shape if stack.ndim == 3 else (1, *stack.shape)
        c1, b1, h1 = calls[0]
        row = {"lps": len(c), "problems": len(c1), "iters": kw["iters"],
               "refine": kw["newton_refine"], "op_obj_gap": op_gap,
               "kernel_obj_gap": kernel_gap, "kernel_vs_op": kernel_vs_op,
               "residual": r_k, "residual_op": r_o, "residual_limit": residual_tol,
               "rejected": int(info_k["rejected"].sum()),
               "rejected_op": int(info_o["rejected"].sum()),
               "bound_ms": box_ipm.bound_ms(len(c1), S, me, n, kw["iters"], kw["newton_refine"]),
               "ms": None, "plain_ms": None}
        if cuda:
            eager = lp.make_batched_box_ipm_solver(K_eq, K_in, **dict(kw, cuda_graph=False))
            row["ms"] = _kernel_device_ms(lambda: eager(c1, b1, h1), timing_iters)
            row["plain_ms"] = _event_ms(lambda: ops(c1, b1, h1), timing_iters)
        out[name] = row
    return out


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

    build_s, reports = phase_build()
    print(f"build {', '.join(f'{name}.cu' for name in reports)}: {build_s:.2f} s {tag}",
          flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # ---- main path, every launch count at 0 ------------------------------
    batch, year = 131072, 8759
    sweep = phase_kernel_sweep(device, batch, year)
    print(f"main/kernel sweep: {batch} x {year} steps in {sweep['seconds']:.4f} s, "
          f"{sweep['steps_per_s']:.6g} env-steps/s {tag}", flush=True)
    eng = phase_engine_sweep(device, batch, 2000)
    print(f"main/engine sweep: {batch} x 2000 steps in {eng['seconds']:.4f} s, "
          f"{eng['steps_per_s']:.6g} env-steps/s, max rel vs kernel "
          f"{eng['max_rel_vs_kernel']:.3e} {tag}", flush=True)
    gold = phase_golden(device, max_steps=2000)
    print(f"main/golden: scenario 1, first {gold['steps']} steps of the year (f64) bitwise "
          f"in {gold['seconds']:.2f} s {tag}", flush=True)
    with tempfile.TemporaryDirectory(prefix=".suite-trace-", dir=REPO) as trace_dir:
        suite = phase_suite(device, 25, 20480, 1000, trace_dir=trace_dir)
    print(f"main/suite: 25 x 20480 x 1000 steps, block-prefetch path in "
          f"{suite['seconds']:.4f} s ({suite['steps_per_s']:.6g} env-steps/s; again after "
          f"the per-step path {suite['seconds_again']:.4f} s), per-step path "
          f"{suite['seconds_per_step_path']:.4f} s, torch.equal; max rel vs CPU f64 "
          f"{suite['max_rel_vs_cpu_f64']:.3e} {tag}", flush=True)
    print(f"main/suite profile over 16 steps: block-prefetch "
          f"{suite['events_per_step_blocked']:.2f} device events per step, busy "
          f"{suite['busy_ms_per_step_blocked']:.4f} ms per step; per-step "
          f"{suite['events_per_step_per_step']:.2f} events, busy "
          f"{suite['busy_ms_per_step_per_step']:.4f} ms per step {tag}", flush=True)
    launches = sweep["rollout"].launches + eng["kernel_launches"]
    _check(launches > 0, "the main path launched no rbc_rollout kernel")

    # ---- batched RL envs -------------------------------------------------
    for name, phase in (("discrete env, scenario 0", phase_discrete_env),
                        ("continuous env, scenario 1", phase_continuous_env)):
        env = phase(device)
        for path, key in (("step() loop", "step_loop"),
                          ("rollout(shared_step=True)", "shared_rollout"),
                          ("rollout(keep_obs=False)", "lean_rollout")):
            print(f"envs/{name}: {path} 65536 x 100 steps in {env[key + '_s']:.4f} s, "
                  f"{env[key + '_per_s']:.6g} env-steps/s {tag}", flush=True)
        print(f"envs/{name}: rollouts bitwise vs step loop; summed reward of 4 "
              f"replicas max rel {env['max_rel_vs_host']:.3e} vs host float64; "
              f"float64 on the card bitwise vs host env {tag}", flush=True)

    # ---- engine surfaces: threefry gaussians, per-replica callables -----
    with tempfile.TemporaryDirectory(prefix=".gauss-trace-", dir=REPO) as trace_dir:
        ge = phase_gaussian_env(device, trace_dir=trace_dir)
    for path, key in (("step() loop", "step_loop"), ("rollout(shared_step=True)", "shared_rollout")):
        print(f"surfaces/gaussian discrete env, scenario 0: {path} 65536 x 100 steps in "
              f"{ge[key + '_s']:.4f} s, {ge[key + '_per_s']:.6g} env-steps/s {tag}", flush=True)
    print(f"surfaces/gaussian discrete env: rollout bitwise vs step loop, seed 1 differs; "
          f"standardized noise mean {ge['noise_mean']:.6f} std {ge['noise_std']:.6f} over "
          f"{ge['noise_count']} entries; 4 float64 replicas vs CPU, forecast log fields max "
          f"abs {ge['max_abs_f64_vs_cpu']:.3e}; {ge['events_per_step']:.1f} device events per "
          f"step (oracle env: 215-236), busy {ge['busy_ms_per_step']:.3f} ms per step, idle "
          f"share {ge['idle_share']:.4f} against the unprofiled loop {tag}", flush=True)
    ce = phase_callable_env(device)
    for path, key in (("step() loop", "step_loop"), ("rollout(shared_step=True)", "shared_rollout")):
        print(f"surfaces/callable continuous env, scenario 1: {path} 65536 x 100 steps in "
              f"{ce[key + '_s']:.4f} s, {ce[key + '_per_s']:.6g} env-steps/s {tag}", flush=True)
    print(f"surfaces/callable continuous env: float64 on the card bitwise vs host env (4 "
          f"replicas x 100 steps); rollout bitwise vs step loop {tag}", flush=True)

    # ---- on-device planners (the box IPM's kernel on SuiteMPC's path) -----
    sm = phase_suite_mpc(device, n_steps=24)
    box_launches = sm["kernel_solves"]
    _check(box_launches == sm["box_solves"] > 0,
           f"suite_mpc float32: {box_launches} box_ipm_kernel launches in "
           f"{sm['box_solves']} box-IPM solves")
    print(f"planners/suite_mpc: 25 scenarios x 24 steps, H=24: float32 chip mode "
          f"{sm['seconds32']:.2f} s ({sm['ms_per_hour32']:.1f} ms per simulated hour), "
          f"float64 {sm['seconds64']:.2f} s ({sm['ms_per_hour64']:.1f} ms per hour); max rel "
          f"gap f32 vs f64 {sm['max_rel_gap']:.3e} (scenarios 0, 4, 1: "
          f"{sm['held_max_rel_gap']:.3e} < 2%) {tag}", flush=True)
    print(f"planners/suite_mpc: float32 {sm['box_solves']} box-IPM solves, "
          f"{box_launches} box_ipm_kernel launches", flush=True)
    print("planners/suite_mpc costs f32: " + json.dumps([round(c, 4) for c in sm["cost32"]]),
          flush=True)
    print("planners/suite_mpc costs f64: " + json.dumps([round(c, 4) for c in sm["cost64"]]),
          flush=True)
    bm = phase_batched_mpc(device)
    print(f"planners/batched_mpc: scenario 1: float32 x 1024 replicas (bitwise equal), "
          f"{bm['n_steps32']} steps, {bm['seconds32']:.2f} s ({bm['ms_per_hour32']:.1f} ms per "
          f"hour), cost {bm['cost32']:.4f}, rel {bm['rel32']:.3e} vs float64 over the same "
          f"steps; float64 x 1 with host fallback, {bm['n_steps']} steps, "
          f"{bm['seconds64']:.2f} s ({bm['ms_per_hour64']:.1f} ms per hour), cost "
          f"{bm['cost64']:.4f}, rel {bm['rel_host']:.3e} vs host HiGHS {bm['host_cost']:.4f}; "
          f"fallback_count {bm['fallback_count']} {tag}", flush=True)
    saa = phase_saa(device)
    print(f"planners/saa: scenario 0, 24 steps: degenerate samples (float64) "
          f"{saa['seconds_degenerate']:.2f} s ({saa['ms_per_hour_degenerate']:.1f} ms per "
          f"hour), max rel {saa['degenerate_max_rel']:.3e} vs BatchedMPC; 10 sampled futures "
          f"(float32) {saa['seconds_sampled']:.2f} s ({saa['ms_per_hour_sampled']:.1f} ms per "
          f"hour), cost {saa['sampled_cost']:.4f}, picks {saa['picks']} at the sorted median "
          f"{tag}", flush=True)

    # ---- training: Adam, A2C, ES, the data-parallel dryrun (no kernel) ---
    with tempfile.TemporaryDirectory(prefix=".adam-trace-", dir=REPO) as trace_dir:
        ad = phase_adam(device, trace_dir=trace_dir)
    print(f"training/adam: optax.adam's steps (utils.optax_adam.Adam), {ad['n_steps']} steps "
          f"of one float32 gradient stream over {ad['n_params']} parameters (A2C's, ES's, one "
          f"untouched): torch.equal to the CPU after every step; one step over A2C's "
          f"{ad['a2c_params']} parameters {ad['ms']:.4f} ms (CUDA events, mean of 20), "
          f"torch.optim.Adam {ad['torch_adam_ms']:.4f} ms; one step over all "
          f"{ad['n_params']} under torch.profiler: {ad['events']} device events, busy "
          f"{ad['busy_ms']:.4f} ms {tag}", flush=True)
    with tempfile.TemporaryDirectory(prefix=".a2c-trace-", dir=REPO) as trace_dir:
        a2c = phase_a2c(device, trace_dir=trace_dir)
    print(f"training/a2c: scenario 1, 4096 x 128, 5 iterations in {a2c['seconds']:.4f} s, "
          f"{a2c['ms_per_iter']:.2f} ms per iteration, {a2c['steps_per_s']:.6g} env-steps/s; "
          f"history {json.dumps([round(h, 6) for h in a2c['history']])}; fed-action iteration "
          f"vs CPU float32: loss rel {a2c['loss_rel_vs_cpu']:.3e}, parameters max abs diff "
          f"{a2c['params_max_abs_vs_cpu']:.3e} {tag}", flush=True)
    print(f"training/a2c sampled: first iteration of a seed-0 run (JAX's threefry draws) vs "
          f"the CPU: {a2c['sampled_flips']} of {a2c['sampled_draws']} actions differ (allowed "
          f"only at a near tie, relative margin <= {a2c['tie']}; smallest margin on the CPU "
          f"{a2c['sampled_min_margin']:.3e}); loss {a2c['sampled_loss']:.4f}, loss and mean "
          f"return max rel {a2c['sampled_rel_vs_cpu']:.3e} (rtol {a2c['rtol']}) {tag}",
          flush=True)
    print(f"training/a2c profile: one iteration under torch.profiler {a2c['profiled_ms']:.2f} ms, "
          f"{a2c['device_events']} device events, busy {a2c['busy_ms']:.2f} ms, idle share "
          f"{a2c['idle_share']:.4f} (against the unprofiled {a2c['ms_per_iter']:.2f} ms: "
          f"{a2c['idle_share_unprofiled']:.4f}) {tag}", flush=True)
    es = phase_es(device)
    print(f"training/es: scenario 0 continuous, pop 256 x 1000 steps (depth cut from 8758), "
          f"2 generations in {es['seconds']:.4f} s ({es['ms_per_gen']:.2f} ms per generation), "
          f"{es['steps_per_s']:.6g} env-steps/s; "
          f"best-of-pop {es['history']} vs RBC {es['rbc']:.2f}; population returns vs CPU "
          f"float32 max rel {es['max_rel_vs_cpu']:.3e} {tag}", flush=True)
    print(f"training/es draws: theta0 and the first generation's noise on the card "
          f"torch.equal to the CPU's {tag}", flush=True)
    dry = phase_dryrun(device)
    print(f"training/dryrun_multichip(1) over NCCL: loss {dry['loss']:.4f}, mean return "
          f"{dry['mean_return']:.4f}, in {dry['seconds']:.2f} s; max rel vs the CPU (gloo) "
          f"{dry['rel_vs_cpu']:.3e} (rtol {dry['rtol']}) {tag}", flush=True)

    # ---- JAX's draws: the random policy, key-drawn suite restarts --------
    rp = phase_random_policy(device)
    print(f"keys/random_policy: scenario 0, 65536 replicas: one draw and step in "
          f"{rp['seconds']:.4f} s; {rp['n_actions']} actions bitwise vs the CPU {tag}",
          flush=True)
    dr = phase_draws(device)
    ms = dr["ms"]
    print(f"keys/draws: {dr['n_keys']} split keys: float32 normals (23 x 4 per key), gumbels "
          f"(5 per key) and categorical draws torch.equal to the CPU's; float64 normals: "
          f"{dr['normal64_differ']} of {dr['normal_elements']} differ from the CPU's (435 in "
          f"earlier runs, before the IEEE float64 root), all off log1p's rational "
          f"({dr['normal64_off_rational']} draws there) and all where log1p differs "
          f"({dr['normal64_log1p_differ']} inputs) {tag}", flush=True)
    print(f"keys/draws timing (CUDA events, mean of 20): normal float32 {ms['normal32']:.4f} ms, "
          f"gumbel float32 {ms['gumbel32']:.4f} ms; on {dr['normal_elements']} float32 "
          f"elements _xla_log1p {ms['xla_log1p32']:.4f} ms vs torch.log1p "
          f"{ms['torch_log1p32']:.4f} ms, _xla_log_f32 {ms['xla_log32']:.4f} ms vs torch.log "
          f"{ms['torch_log32']:.4f} ms {tag}", flush=True)
    with tempfile.TemporaryDirectory(prefix=".collect-trace-", dir=REPO) as trace_dir:
        sc = phase_suite_collect(device, trace_dir=trace_dir)
    print(f"keys/suite_collect: 25 x 1024 x 20 steps with randomized restarts in "
          f"{sc['seconds']:.4f} s ({sc['steps_per_s']:.6g} env-steps/s), dones bitwise vs "
          f"the CPU ({sc['restarts']} restarts); {sc['events_per_step_keyed']:.1f} device "
          f"events per step, {sc['events_per_step_fixed']:.1f} with fixed restarts and no "
          f"keys {tag}", flush=True)

    # ---- the result-table tools and the structure study -----------------
    with tempfile.TemporaryDirectory(prefix=".tables-", dir=REPO) as out_dir:
        tr = phase_tables_rbc(device, out_dir)
        tm = phase_tables_mpc_suite(device, out_dir)
    print(f"tables/rbc: scenario 0, full year (f64), cost {tr['cost']:,.2f} = RESULTS.md "
          f"to the cent, in {tr['seconds']:.2f} s {tag}", flush=True)
    print(f"tables/mpc_suite: scenarios 0 and 1 (two groups), 24 steps, costs "
          f"{json.dumps([round(c, 4) for c in tm['costs']])}, report parsed back, in "
          f"{tm['seconds']:.2f} s ({tm['ms_per_hour']:.1f} ms per hour), "
          f"{tm['kernel_solves']} box_ipm_kernel launches {tag}", flush=True)
    _check(tm["kernel_solves"] > 0, "tables/mpc_suite: no box_ipm_kernel launch")
    box_launches += tm["kernel_solves"]
    st = phase_structure(device)
    for line in st["lines"]:
        print(f"examples/scenario0_structure | {line}", flush=True)
    print(f"examples/scenario0_structure: 8758 steps, every return within "
          f"{st['max_rel']:.3e} of docs/captures/scenario0_structure.log, other lines "
          f"identical, in {st['seconds']:.2f} s {tag}", flush=True)

    # ---- the speed tools: scaling table, batch sweep, env profile --------
    with tempfile.TemporaryDirectory(prefix=".speed-", dir=REPO) as out_dir:
        sp = phase_speed_tools(device, out_dir)
    for row in sp["chip_rows"]:
        print(f"speed/scaling-chip: 25 configs x {row['replicas']} replicas x 200 steps "
              f"(batch {row['total_envs']}): {row['env_steps_per_sec']:.6g} env-steps/s "
              f"{tag}", flush=True)
    for row in sp["rank_rows"]:
        print(f"speed/scaling: world size {row['devices']} over NCCL (worker subprocesses), "
              f"8 x 256 x 200: {row['env_steps_per_sec']:.6g} env-steps/s {tag}", flush=True)
    print("speed/scaling: world size 1 checksums torch.equal to the unmeshed runner; "
          "report parsed back", flush=True)
    for label, wall, rate in sp["profile"]:
        print(f"speed/profile_env: scenario 0, 2048 x 100, {label}: {rate:.6g} env-steps/s "
              f"({wall:.4f} s) {tag}", flush=True)
    print(f"speed: phase in {sp['seconds']:.2f} s {tag}", flush=True)

    # ---- the bench.py twin, its kernel launches counted ------------------
    with tempfile.TemporaryDirectory(prefix=".bench-trace-", dir=REPO) as trace_dir:
        bn = phase_bench(device, trace_dir=trace_dir)
    print(f"bench/line: {bn['line']}", flush=True)
    r = bn["result"]
    print(f"bench: suite {r['n_configs']} x {r['replicas_per_config']} x {r['n_steps']} "
          f"{r['value']:.6g} env-steps/s (best of 3, {r['wall_s']} s); rl env step() loop "
          f"{r['rl_env_steps_per_sec']:.6g}, fused {r['rl_fused_steps_per_sec']:.6g}, "
          f"continuous {r['continuous_env_steps_per_sec']:.6g}; kernel sweep "
          f"{r['kernel_steps_per_sec']:.6g} ({bn['kernel_launches']} rbc_rollout launches), "
          f"engine sweep {r['engine_sweep_steps_per_sec']:.6g}; collect "
          f"{r['collect_steps_per_sec']:.6g} env-steps/s; phase in {bn['seconds']:.2f} s "
          f"{tag}", flush=True)
    print(f"bench: collect step with int32 restarts {bn['collect_events_per_step_int32']:.1f} "
          f"device events per step (int64 restarts: {sc['events_per_step_keyed']:.1f} in "
          f"keys/suite_collect above, 1,424 in earlier runs) {tag}", flush=True)
    launches += bn["kernel_launches"]

    # ---- kernel against its plain version (launches not counted) ---------
    kvp = phase_kernel_vs_plain(sweep, device)
    kvp["ms"] = _event_ms(lambda: sweep["rollout"](sweep["init"]), 5)
    print(f"kernel rbc_rollout: {kvp['ms']:.4f} ms ({batch * year / kvp['ms'] * 1e3:.6g} "
          f"env-steps/s), plain {kvp['plain_ms']:.1f} ms "
          f"({batch * year / kvp['plain_ms'] * 1e3:.6g} env-steps/s), bound "
          f"{kvp['bound_ms']:.4f} ms ({kvp['bound_ms'] / kvp['ms']:.1%} of it reached); "
          f"bitwise vs plain at {batch} x {year}, on all 25 scenarios at 1024 x 64 and on "
          f"scenario 1 at 4096 x 8759 (variant {kvp['genset_variant']}); full-year cost "
          f"{sweep['full_year_cost']:.2f} {tag}", flush=True)
    print("kernel rbc_rollout variant of scenarios 0-24: " + json.dumps(kvp["variants"]),
          flush=True)
    box = phase_box_ipm(device, sm["box_solvers"])
    for name, r in box.items():
        print(f"kernel box_ipm {name}: {r['lps']} LPs of the planner's first hours, objectives "
              f"within {r['kernel_obj_gap']:.3e} of HiGHS's (op path {r['op_obj_gap']:.3e}; "
              f"kernel-op {r['kernel_vs_op']:.3e}, limit twice the op path's), residual "
              f"{r['residual']:.3e} (op {r['residual_op']:.3e}, limit "
              f"{r['residual_limit']:.0e}), rejected steps "
              f"{r['rejected']} (op {r['rejected_op']}); at {r['problems']} problems x "
              f"{r['iters']} iterations, refine {r['refine']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_ms'] / r['ms']:.2%} of it reached) {tag}", flush=True)
    hour = {k: sum(r[k] for r in box.values()) for k in ("ms", "plain_ms", "bound_ms")}

    print(json.dumps({"kernels": [{
        "name": "rbc_rollout",
        "route": "cuda",
        "source": "pymgrid_tpu_torch/csrc/rbc_rollout.cu",
        "replaces": "pymgrid_tpu/ops/pallas_rollout.py:48",
        "launches": launches,
        "max_abs_err": kvp["max_abs_err"],
        "ms": kvp["ms"],
        "plain_ms": kvp["plain_ms"],
        "bound_ms": kvp["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,   # no single PyTorch call computes this function
    }, {
        "name": "box_ipm_kernel",
        "route": "cuda",
        "source": "pymgrid_tpu_torch/csrc/box_ipm.cu",
        "replaces": None,     # XLA ran the JAX package's box IPM: no TPU kernel
        "launches": box_launches,
        "max_rel_err": max(r["kernel_vs_op"] for r in box.values()),
        "ms": hour["ms"],     # the planner's hour: relaxation, chunk, final re-solve
        "plain_ms": hour["plain_ms"],
        "bound_ms": hour["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,   # no single PyTorch call computes this function
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,   # the cards this script drives, whatever the host has
    }}), flush=True)


if __name__ == "__main__":
    main()
