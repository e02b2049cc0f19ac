#!/usr/bin/env python
"""Throughput benchmark: batched env-steps/s on the pymgrid25 suite.

Port of the repository's ``bench.py``.  All 25 benchmark scenarios are
normalized onto one shared spec and stepped as one ``(C, B)`` batch: the
marginal-cost policy, three-phase dispatch and observation construction per
step, auto-reset, every replica from its own start drawn from
``make_keys(seed=0)`` (JAX's int32 draw: ``bench.py`` runs without
``jax_enable_x64``), and the observations checksummed every step.  The
default 1000 steps are a multiple of 8, so the suite runs its block-prefetch
rollout, as the JAX one does.

Prints ONE JSON line with ``bench.py``'s keys:
  {"metric": ..., "value": N, "unit": "env_steps/s/chip", "vs_baseline": N, ...}
``vs_baseline`` is relative to the 1M env-steps/s target (``BASELINE.md``).
Besides the suite, the line carries the RL paths (``rl_env_steps_per_sec`` and
``continuous_env_steps_per_sec`` from ``step()`` loops, ``rl_fused_steps_per_sec``
from ``BatchedDiscreteEnv.rollout(shared_step=True)``), the fused RBC kernel
against the engine's lockstep sweep on the same init-charge sweep
(``kernel_steps_per_sec``, which is ``bench.py``'s ``pallas_steps_per_sec``,
and ``engine_sweep_steps_per_sec``), and the log-materializing collect rollout
(``collect_steps_per_sec``).  ``backend`` is ``"cuda"`` or ``"cpu"`` and
``n_chips_visible`` the CUDA device count.

Every run is timed on the host clock from a device synchronize to a result
on the host (the suite's ``(C, B)`` checksums, a few values of the extras),
after one untimed run.  The suite takes the best of
``PYMGRID_BENCH_REPEATS``; each extra runs once.  Stage markers go to stderr.

Env knobs, with ``bench.py``'s names and defaults: PYMGRID_BENCH_REPLICAS
(20480 per config), PYMGRID_BENCH_STEPS (1000), PYMGRID_BENCH_REPEATS (3),
PYMGRID_BENCH_CONFIGS (25), PYMGRID_BENCH_SKIP_EXTRAS=1 for the suite alone;
extras: PYMGRID_BENCH_RL_BATCH (65536), PYMGRID_BENCH_RL_STEPS (100, fused),
PYMGRID_BENCH_RL_LOOP_STEPS (100), PYMGRID_BENCH_PALLAS_BATCH (131072) and
PYMGRID_BENCH_PALLAS_STEPS (2000) for the kernel sweep,
PYMGRID_BENCH_COLLECT_REPLICAS (1024), PYMGRID_BENCH_COLLECT_STEPS (100),
PYMGRID_BENCH_COLLECT_CONFIGS (=CONFIGS).

Usage: python -m pymgrid_tpu_torch.tools.bench [--device cuda|cpu]
The card is the default; ``--device cpu`` runs on the CPU, and without a card
the default raises instead of falling back to the CPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from pymgrid_tpu_torch._device import resolve_device

__all__ = ["bench_collect_rollout", "bench_continuous_env_step", "bench_kernel_rollout",
           "bench_rl_env_step", "bench_rl_fused_rollout", "build_suite_rollout",
           "kernel_sweep_inputs", "main", "parse_args"]

# JAX's default int in bench.py's mode (no jax_enable_x64)
START_DTYPE = torch.int32


def _mark(msg):
    """Stage marker on stderr: stdout stays one JSON line."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _timed_once(fn, fetch, device):
    """Host-clock seconds of ``fetch(fn())``, from a device synchronize to
    the fetched values on the host."""
    from pymgrid_tpu_torch.utils.profiling import _sync

    _sync(device)
    t0 = time.perf_counter()
    fetch(fn()).cpu()
    _sync(device)
    return time.perf_counter() - t0


def build_suite_rollout(n_configs, replicas, n_steps, dtype="float32", device="cuda",
                        mesh=None, seed=0):
    """The suite rollout of ``bench.py``: scenarios ``0..n_configs-1`` x
    ``replicas``, the marginal-cost policy, auto-reset, randomized starts in
    JAX's int32 draw (the block-prefetch path when ``n_steps`` is a multiple
    of 8).  Returns ``(fn, params, keys)``, ``fn(params, keys)`` the ``(C,
    B)`` checksums (this rank's rows with a ``mesh``)."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.parallel import SuiteRunner

    microgrids = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(microgrids, batch_per_config=replicas, dtype=dtype,
                         device=device, mesh=mesh, start_dtype=START_DTYPE)
    # honest mode: distinct per-replica starts, so no replica repeats
    # another's work
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps,
                           auto_reset=True, collect=False, randomize_initial_step=True)
    return fn, runner.params, runner.make_keys(seed=seed)


def _step_loop_rate(batched, action_seq, seed, device):
    """env-steps/s of a ``step()`` loop over ``action_seq (T, B, ...)``
    (on the device) with observations returned, after one untimed step from
    ``reset(seed)``; the loop goes on from that step's states."""
    states, out = batched.step(batched.reset(seed=seed), action_seq[0])
    out.obs.cpu()

    def loop():
        nonlocal states
        for actions in action_seq:
            states, out = batched.step(states, actions)
        return out

    T, B = action_seq.shape[:2]
    return B * T / _timed_once(loop, lambda out: out.obs[:2], device)


def bench_rl_env_step(batch_size=65536, n_steps=100, dtype="float32", seed=0,
                      device="cuda"):
    """``BatchedDiscreteEnv.step`` on scenario 0 with observations returned,
    one call per step: launch latency per step as much as engine work."""
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv

    device = resolve_device(device)
    batched = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(0), batch_size, dtype,
                                 device)
    actions = np.random.RandomState(seed).randint(batched.n_actions, size=(n_steps, batch_size))
    return _step_loop_rate(batched, torch.as_tensor(actions, dtype=torch.int32, device=device),
                           seed, device)


def bench_rl_fused_rollout(batch_size=65536, n_steps=100, dtype="float32", seed=0,
                           device="cuda"):
    """The same work as :func:`bench_rl_env_step` through
    ``BatchedDiscreteEnv.rollout(shared_step=True)``: the whole action
    sequence in one call."""
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedDiscreteEnv

    device = resolve_device(device)
    batched = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(0), batch_size, dtype,
                                 device)
    actions = np.random.RandomState(seed).randint(batched.n_actions, size=(n_steps, batch_size))
    action_seq = torch.as_tensor(actions, dtype=torch.int32, device=device)
    states = batched.reset(seed=seed)
    run = lambda: batched.rollout(states, action_seq, shared_step=True)  # noqa: E731
    last_rewards = lambda result: result[1].reward[-1, :8]  # noqa: E731
    last_rewards(run()).cpu()                              # first launches, not timed
    return batch_size * n_steps / _timed_once(run, last_rewards, device)


def bench_continuous_env_step(batch_size=65536, n_steps=100, dtype="float32", seed=0,
                              device="cuda"):
    """``BatchedContinuousEnv.step`` on scenario 1 (genset, weak grid) with
    observations returned, one call per step."""
    from pymgrid_tpu_torch._device import numpy_dtype
    from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv
    from pymgrid_tpu_torch.parallel import BatchedContinuousEnv

    device = resolve_device(device)
    batched = BatchedContinuousEnv(ContinuousMicrogridEnv.from_scenario(1), batch_size,
                                   dtype, device)
    actions = np.random.RandomState(seed).rand(n_steps, batch_size, batched.action_dim)
    return _step_loop_rate(batched, torch.as_tensor(actions.astype(numpy_dtype(dtype)),
                                                    device=device), seed, device)


def kernel_sweep_inputs(batch_size, device="cuda", scenario=0):
    """``bench.py``'s init-charge sweep (of scenario 0) in float32: the spec,
    numpy params and ``linspace(min_capacity, max_capacity, batch_size)`` on
    ``device``, every replica from another charge."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.spec import extract_spec

    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    pb = params["battery"]
    init = np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
                       batch_size, dtype=np.float32)
    return spec, params, torch.as_tensor(init, device=resolve_device(device))


def bench_kernel_rollout(batch_size=131072, n_steps=2000, device="cuda"):
    """The fused-horizon RBC kernel against the engine on the same work: the
    init-charge sweep of :func:`kernel_sweep_inputs`, a full marginal-cost
    RBC rollout per replica, through ``make_rbc_rollout`` (the CUDA kernel
    on the card, its plain version on the CPU) and through the engine's
    lockstep sweep (shared time, rewards accumulated, no episode buffers;
    reset without keys, as scenario 0 draws nothing).  Returns
    ``(kernel_steps_per_sec, engine_steps_per_sec)``."""
    from pymgrid_tpu_torch.core.engine import make_reset_fn
    from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
    from pymgrid_tpu_torch.core.rollout import (
        lockstep_states,
        make_lockstep_sweep_fn,
        make_marginal_cost_policy,
    )
    from pymgrid_tpu_torch.ops import make_rbc_rollout

    device = resolve_device(device)
    spec, params, init = kernel_sweep_inputs(batch_size, device)
    first_rewards = lambda acc: acc[:8]  # noqa: E731

    rollout = make_rbc_rollout(spec, params, n_steps, device)
    first_rewards(rollout(init)).cpu()                     # build and first launch
    kernel_rate = batch_size * n_steps / _timed_once(lambda: rollout(init), first_rewards,
                                                     device)

    tparams = with_config_axis(params_to_torch(params, device, torch.float32))
    starts = tparams["initial_step"].to(torch.int32).view(1, 1).expand(1, batch_size)
    states = make_reset_fn(spec)(tparams, starts)
    states["battery_charge"] = init.view(1, batch_size, 1)
    sweep = make_lockstep_sweep_fn(spec, make_marginal_cost_policy(spec), n_steps)
    ls = lockstep_states(spec, tparams, states)
    run = lambda: sweep(tparams, ls)[1][0]  # noqa: E731
    first_rewards(run()).cpu()                             # first launches, not timed
    engine_rate = batch_size * n_steps / _timed_once(run, first_rewards, device)
    return kernel_rate, engine_rate


def bench_collect_rollout(replicas=1024, n_steps=100, n_configs=25, dtype="float32",
                          device="cuda"):
    """The log-materializing suite rollout: the full ``StepOutput`` (obs,
    reward, shaped reward, done, log rows, balance scalars) of every step as
    ``(C, B, T, ...)``, with randomized restarts drawn from the replicas'
    keys (JAX's int32 draw), as a data-collection run would."""
    from pymgrid_tpu_torch import Microgrid
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu_torch.parallel import SuiteRunner

    device = resolve_device(device)
    microgrids = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(microgrids, batch_per_config=replicas, dtype=dtype, device=device,
                         start_dtype=START_DTYPE)
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), n_steps, auto_reset=True,
                           collect=True, randomize_initial_step=True)
    keys = runner.make_keys(seed=0)

    _, outs = fn(runner.params, keys)                      # first launches, not timed
    if outs.obs.shape[-2] != n_steps or outs.log_row.ndim != 4:
        raise RuntimeError(f"collect rollout: obs {tuple(outs.obs.shape)}, log rows "
                           f"{tuple(outs.log_row.shape)} for {n_steps} steps")
    outs.reward[..., -1].sum().cpu()
    del outs
    wall = _timed_once(lambda: fn(runner.params, keys),
                       lambda result: result[1].reward[..., -1].sum(), device)
    return n_configs * replicas * n_steps / wall


def _knob(name, default):
    return int(os.environ.get(name, default))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Print the one JSON line; returns it as a dict."""
    from pymgrid_tpu_torch.tools.run_benchmarks import suite_throughput

    args = parse_args(argv)
    n_configs = _knob("PYMGRID_BENCH_CONFIGS", 25)
    replicas = _knob("PYMGRID_BENCH_REPLICAS", 20480)
    n_steps = _knob("PYMGRID_BENCH_STEPS", 1000)
    repeats = _knob("PYMGRID_BENCH_REPEATS", 3)

    device = resolve_device(args.device)
    n_cards = torch.cuda.device_count()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
    _mark(f"backend={device.type} ({name}) cards visible={n_cards}")
    _mark("building the suite; one untimed run, then timing")
    steps_per_sec, _ = suite_throughput(n_configs, replicas, n_steps, device,
                                        repeats=repeats, mark=_mark)
    total_envs = n_configs * replicas
    result = {
        "metric": "batched_env_steps_per_sec_per_chip_pymgrid25_suite",
        "value": round(steps_per_sec, 1),
        "unit": "env_steps/s/chip",
        "vs_baseline": round(steps_per_sec / 1e6, 3),
        "n_configs": n_configs,
        "replicas_per_config": replicas,
        "total_envs": total_envs,
        "n_steps": n_steps,
        "backend": device.type,
        "n_chips_visible": n_cards,
        "wall_s": round(total_envs * n_steps / steps_per_sec, 4),
        "note": (
            "replicas start at randomized steps drawn from their keys (JAX's "
            "int32 draw, as bench.py runs), so no replica repeats another's "
            "work.  Auto-resets wrap sequentially ((t+1) mod max_start), so "
            "the suite reads each replica's step-table rows once per 8 steps "
            "(the block-prefetch path, bitwise equal to the per-step path).  "
            "Each step is a sequence of eager PyTorch launches; "
            "engine_sweep_steps_per_sec is the same dispatch math with shared "
            "time and kernel_steps_per_sec the fused CUDA kernel on that sweep "
            "(its plain PyTorch version when backend is cpu)"
        ),
    }

    if not _knob("PYMGRID_BENCH_SKIP_EXTRAS", 0):
        rl_batch = _knob("PYMGRID_BENCH_RL_BATCH", 65536)
        loop_steps = _knob("PYMGRID_BENCH_RL_LOOP_STEPS", 100)
        _mark("extras: BatchedDiscreteEnv RL path")
        result["rl_env_steps_per_sec"] = round(
            bench_rl_env_step(rl_batch, loop_steps, device=device), 1)
        _mark("extras: fused BatchedDiscreteEnv rollout")
        result["rl_fused_steps_per_sec"] = round(bench_rl_fused_rollout(
            rl_batch, _knob("PYMGRID_BENCH_RL_STEPS", 100), device=device), 1)
        _mark("extras: BatchedContinuousEnv path")
        result["continuous_env_steps_per_sec"] = round(
            bench_continuous_env_step(rl_batch, loop_steps, device=device), 1)
        result["loop_numbers_note"] = (
            "rl_env_steps_per_sec and continuous_env_steps_per_sec time "
            "python step() loops, one call and its launches per step; "
            "rl_fused_steps_per_sec runs the same actions in one rollout call"
        )
        _mark("extras: RBC kernel vs engine (init-charge sweep)")
        kernel_rate, engine_rate = bench_kernel_rollout(
            _knob("PYMGRID_BENCH_PALLAS_BATCH", 131072),
            _knob("PYMGRID_BENCH_PALLAS_STEPS", 2000), device=device)
        result["kernel_steps_per_sec"] = round(kernel_rate, 1)
        result["engine_sweep_steps_per_sec"] = round(engine_rate, 1)
        _mark("extras: collect rollout")
        result["collect_steps_per_sec"] = round(bench_collect_rollout(
            _knob("PYMGRID_BENCH_COLLECT_REPLICAS", 1024),
            _knob("PYMGRID_BENCH_COLLECT_STEPS", 100),
            _knob("PYMGRID_BENCH_COLLECT_CONFIGS", n_configs), device=device), 1)

    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
