#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It refuses to run (non-zero exit, no result) without CUDA.  Phases, each of
which fails the run on error:

1. build      nvcc-compile ``pymgrid_tpu_torch/csrc/rbc_rollout.cu`` (sm_90a)
              and print ptxas' registers, spills and shared memory for each
              of its 8 kernel variants.
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
              float32, randomized starts, auto-reset; held against the same
              rollout on the CPU in float64 for 4 replicas per config).
3. envs       the batched RL envs through their user entry points at
              ``bench.py``'s widths (65536 replicas x 100 steps, float32):
              ``BatchedDiscreteEnv`` on scenario 0 and ``BatchedContinuousEnv``
              on scenario 1, each timed as a ``step()`` loop, a
              ``rollout(shared_step=True)`` and a ``rollout(keep_obs=False)``;
              the rollouts held bitwise against the loop, the first replicas
              against the host numpy env (float64) at rtol 1e-4, and a float64
              run on the card bitwise against the host env.
4. planners   the on-device planners through their user entry points:
              ``SuiteMPC`` over all 25 pymgrid25 scenarios at horizon 24 for
              48 steps in the published chip mode (float32, box IPM,
              ``enum_bits=3``, ``enum_chunk=16``, ``iters=60``,
              ``newton_refine=2``) and the same 48 steps in float64, held to
              2% on scenarios 0, 4 and 1; ``BatchedMPC`` on scenario 1 (genset
              MILP, ``enum_bits=5``) with 1024 float32 replicas (all equal
              bitwise, within 2% of float64) and one float64 replica with the
              host fallback (within 1e-4 of the host HiGHS MILP MPC, fallback
              count as on the CPU); ``BatchedSAA`` on scenario 0 with every
              sample the real data (equal to ``BatchedMPC`` at rtol 1e-5) and
              with 10 sampled futures (finite rewards, the pick at the median
              of the sorted costs).  24 steps each.
5. kernels    the kernel against its plain PyTorch version on the card,
              bitwise (``torch.equal``): at the main-path shape, on all 25
              scenarios at 1024 x 64 (each scenario's kernel variant printed)
              and on scenario 1 (genset, weak grid) at 4096 x 8759; kernel and
              plain times, and the kernel's bound.

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
    """Scenario spec/params (f32) and an init-charge sweep over
    [min_capacity, max_capacity]; replica 0 starts at the config's own
    initial charge."""
    import torch

    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.spec import extract_spec

    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    pb = params["battery"]
    init = np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
                       batch, dtype=np.float32)
    init[0] = pb["init_charge"][0]
    return spec, params, torch.as_tensor(init, device=device)


def phase_build():
    """Build the kernels; returns the seconds and each build's ptxas lines."""
    from pymgrid_tpu_torch.ops._build import build_report, load_library

    t0 = time.perf_counter()
    load_library("rbc_rollout")
    seconds = time.perf_counter() - t0
    return seconds, {"rbc_rollout": build_report("rbc_rollout")}


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
                rtol=1e-4):
    """Main path, suite: ``n_configs`` scenarios x ``replicas`` in float32
    with randomized starts and auto-reset; the first ``ref_replicas`` of
    every config are held against the same rollout on the CPU in float64
    at rtol 1e-4 (float32 against float64 over ``n_steps`` steps)."""
    import torch

    from pymgrid_tpu_torch import Microgrid
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


def _costs(rewards):
    return -np.asarray(rewards, np.float64).sum(axis=0)


def phase_suite_mpc(device, n_scenarios=25, n_steps=48, held=(0, 4, 1), rtol=0.02):
    """``SuiteMPC`` over scenarios ``0..n_scenarios-1`` in the published chip
    mode (float32, box IPM, ``enum_bits=3``, ``enum_chunk=16``, ``iters=60``,
    ``newton_refine=2``) and the same run in float64; every reward finite,
    the ``held`` scenarios' float32 costs within ``rtol`` of float64 (the bar
    of ``tests/test_mpc_suite.py::test_suite_mpc_chip_mode_f32_parity``)."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import SuiteMPC

    def run(dtype, **kw):
        mgs = [Microgrid.from_scenario(n) for n in range(n_scenarios)]
        suite = SuiteMPC(mgs, dtype=dtype, device=device, enum_bits=3, enum_chunk=16, **kw)
        (rewards, _), seconds = _timed(lambda: suite.run_scanned(n_steps, chunk=n_steps), device)
        _check(rewards.shape == (n_steps, n_scenarios) and np.isfinite(rewards).all(),
               f"suite MPC {dtype}: non-finite or misshapen rewards")
        return _costs(rewards), seconds

    cost32, s32 = run("float32", iters=60, newton_refine=2, matmul_precision="float32")
    cost64, s64 = run("float64")
    gap = np.abs(cost32 / cost64 - 1.0)
    for n in held:
        _check(gap[n] < rtol, f"suite MPC scenario {n}: float32 cost {cost32[n]:.2f} vs "
                              f"float64 {cost64[n]:.2f} ({gap[n]:.3%})")
    return {"cost32": cost32, "cost64": cost64, "seconds32": s32, "seconds64": s64,
            "ms_per_hour32": s32 / n_steps * 1e3, "ms_per_hour64": s64 / n_steps * 1e3,
            "max_rel_gap": float(gap.max()), "held_max_rel_gap": float(gap[list(held)].max())}


def phase_batched_mpc(device, batch=1024, n_steps=24, scenario=1, expected_fallbacks=0,
                      rtol32=0.02, rtol_host=1e-4):
    """``BatchedMPC`` on scenario 1 (genset MILP, ``enum_bits=5``): ``batch``
    float32 replicas without host fallback, all bitwise equal (deterministic
    copies) and within ``rtol32`` of the float64 run; one float64 replica
    with the host fallback, within ``rtol_host`` of the host HiGHS MILP MPC
    (``tests/test_lp_mpc.py::test_batched_mpc_genset_milp_matches_host``)
    with the fallback count of the port's CPU run
    (``tests/test_torch_mpc_genset.py``)."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.algos import BatchedMPC, ModelPredictiveControl

    mg = lambda: Microgrid.from_scenario(scenario)
    f32 = BatchedMPC(mg(), batch_size=batch, dtype="float32", device=device, enum_bits=5,
                     host_fallback=False)
    (r32, _), s32 = _timed(lambda: f32.run_scanned(n_steps), device)
    _check(r32.shape == (n_steps, batch) and np.isfinite(r32).all(),
           "batched MPC float32: non-finite or misshapen rewards")
    _check(bool((r32 == r32[:, :1]).all()), "batched MPC float32: replicas differ")

    f64 = BatchedMPC(mg(), batch_size=1, dtype="float64", device=device, enum_bits=5,
                     host_fallback=True)
    (r64, _), s64 = _timed(lambda: f64.run(n_steps), device)
    log = ModelPredictiveControl(mg()).run(max_steps=n_steps)
    host = float(-log[("balance", 0, "reward")].sum())
    cost32, cost64 = float(_costs(r32[:, :1])[0]), float(_costs(r64)[0])
    rel_host = abs(cost64 - host) / abs(host)
    rel32 = abs(cost32 - cost64) / abs(cost64)
    _check(rel_host < rtol_host, f"batched MPC float64 cost {cost64:.4f} vs host HiGHS "
                                 f"{host:.4f}: rel {rel_host:.3e}")
    _check(rel32 < rtol32, f"batched MPC float32 cost {cost32:.4f} vs float64 {cost64:.4f}")
    _check(f64.fallback_count == expected_fallbacks,
           f"batched MPC float64: {f64.fallback_count} host fallbacks, "
           f"{expected_fallbacks} on the CPU")
    return {"cost32": cost32, "cost64": cost64, "host_cost": host, "rel_host": rel_host,
            "rel32": rel32, "seconds32": s32, "seconds64": s64,
            "ms_per_hour32": s32 / n_steps * 1e3, "ms_per_hour64": s64 / n_steps * 1e3,
            "fallback_count": f64.fallback_count}


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
    print(f"build rbc_rollout.cu: {build_s:.2f} s {tag}", flush=True)
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
    suite = phase_suite(device, 25, 20480, 1000)
    print(f"main/suite: 25 x 20480 x 1000 steps in {suite['seconds']:.4f} s, "
          f"{suite['steps_per_s']:.6g} env-steps/s, max rel vs CPU f64 "
          f"{suite['max_rel_vs_cpu_f64']:.3e} {tag}", flush=True)
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

    # ---- on-device planners (no kernel of the port on their path) --------
    sm = phase_suite_mpc(device)
    print(f"planners/suite_mpc: 25 scenarios x 48 steps, H=24: float32 chip mode "
          f"{sm['seconds32']:.2f} s ({sm['ms_per_hour32']:.1f} ms per simulated hour), "
          f"float64 {sm['seconds64']:.2f} s ({sm['ms_per_hour64']:.1f} ms per hour); max rel "
          f"gap f32 vs f64 {sm['max_rel_gap']:.3e} (scenarios 0, 4, 1: "
          f"{sm['held_max_rel_gap']:.3e} < 2%) {tag}", flush=True)
    print("planners/suite_mpc costs f32: " + json.dumps([round(c, 4) for c in sm["cost32"]]),
          flush=True)
    print("planners/suite_mpc costs f64: " + json.dumps([round(c, 4) for c in sm["cost64"]]),
          flush=True)
    bm = phase_batched_mpc(device)
    print(f"planners/batched_mpc: scenario 1, 24 steps: float32 x 1024 replicas (bitwise "
          f"equal) {bm['seconds32']:.2f} s ({bm['ms_per_hour32']:.1f} ms per hour), cost "
          f"{bm['cost32']:.4f}, rel {bm['rel32']:.3e} vs float64; float64 x 1 with host "
          f"fallback {bm['seconds64']:.2f} s ({bm['ms_per_hour64']:.1f} ms per hour), cost "
          f"{bm['cost64']:.4f}, rel {bm['rel_host']:.3e} vs host HiGHS {bm['host_cost']:.4f}; "
          f"fallback_count {bm['fallback_count']} {tag}", flush=True)
    saa = phase_saa(device)
    print(f"planners/saa: scenario 0, 24 steps: degenerate samples (float64) "
          f"{saa['seconds_degenerate']:.2f} s ({saa['ms_per_hour_degenerate']:.1f} ms per "
          f"hour), max rel {saa['degenerate_max_rel']:.3e} vs BatchedMPC; 10 sampled futures "
          f"(float32) {saa['seconds_sampled']:.2f} s ({saa['ms_per_hour_sampled']:.1f} ms per "
          f"hour), cost {saa['sampled_cost']:.4f}, picks {saa['picks']} at the sorted median "
          f"{tag}", flush=True)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
