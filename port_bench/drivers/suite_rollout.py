"""Driver of the suite's rollouts: ``SuiteRunner.rollout_fn`` called again
and again on fresh keys, each call a whole rollout of every config's
replicas, the device synchronised after each.

Traffic parameters: ``replicas`` per config, ``steps`` per rollout,
``collect`` (materialise every step's outputs; restarts drawn from each
replica's split key), ``warmup_steps`` (the one short rollout of set-up),
``trace_steps`` (the traced rollout),
``sample_per_config`` (replicas of every config compared per rollout).
"""
import time

import numpy as np
import torch

from port_bench.harness import load_module, sync

PROGRAM = ("runner", "fns")   # the program's state: freed before the check
FIELDS = ("reward", "done", "obs", "provided", "absorbed")


def setup(config, traffic, device, run):
    """Build the runner and the cell's rollout functions."""
    from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy

    with run.span("build"):
        runner = load_module("configs", config["name"]).build(config, traffic, device)
    policy = make_marginal_cost_policy(runner.spec)
    make = lambda n: runner.rollout_fn(policy, n, auto_reset=True,  # noqa: E731
                                       collect=traffic["collect"], randomize_initial_step=True)
    fns = {"window": make(traffic["steps"]), "warmup": make(traffic["warmup_steps"])}
    fns["trace"] = (fns["window"] if traffic["trace_steps"] == traffic["steps"]
                    else make(traffic["trace_steps"]))
    return {"runner": runner, "fns": fns, "traffic": traffic, "config": config,
            "device": device}


def _keys(system, seed, index):
    """Fresh ``(C, B, 2)`` keys of rollout ``index``: uint32 words drawn on
    the device from a generator seeded by ``(seed, index)``."""
    runner, device = system["runner"], system["device"]
    word = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(word)
    return torch.randint(0, 2**32, (runner.n_configs, runner.batch_per_config, 2),
                         generator=gen, device=device, dtype=torch.int64)


def prepare(system, seed):
    system["seed"] = seed
    system["sampler"] = np.random.default_rng([seed, 1])
    system["kept"] = []


def warm_up(system):
    """One short rollout of the cell's batch, so the window launches nothing
    for the first time."""
    out = system["fns"]["warmup"](system["runner"].params, _keys(system, system["seed"], 2**31))
    del out
    sync(system["device"])


def _sample(system):
    runner, device = system["runner"], system["device"]
    per = system["traffic"]["sample_per_config"]
    rows = [(c, b) for c in range(runner.n_configs)
            for b in system["sampler"].choice(runner.batch_per_config, per, replace=False)]
    return torch.as_tensor(rows, device=device).T


def _call(system, fn, index):
    """One rollout; returns ``(enqueue_s, latency_s)``.  After the
    synchronise it keeps on the host what the check compares: the sampled
    replicas' keys and checksums, and every step's outputs when collecting."""
    keys = _keys(system, system["seed"], index)
    cs, bs = _sample(system)
    t0 = time.perf_counter()
    out = fn(system["runner"].params, keys)
    t1 = time.perf_counter()
    sync(system["device"])
    t2 = time.perf_counter()
    acc, steps = out if system["traffic"]["collect"] else (out, None)
    kept = {f: getattr(steps, f)[cs, bs].cpu() for f in FIELDS} if steps is not None else {}
    kept.update(checksum=acc[cs, bs].cpu(), keys=keys[cs, bs].cpu(), config=cs.cpu())
    system["kept"].append(kept)
    return t1 - t0, t2 - t0


def window(system, seconds, run):
    runner, steps = system["runner"], system["traffic"]["steps"]
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        enqueue, latency = _call(system, system["fns"]["window"], len(run.calls))
        run.calls.append((enqueue, latency, steps))
    run.window_s = time.perf_counter() - start
    run.env_steps = len(run.calls) * steps * runner.n_configs * runner.batch_per_config


def traced(system):
    """The traced part: one rollout of ``trace_steps``; returns its steps."""
    fn = system["fns"]["trace"]
    out = fn(system["runner"].params, _keys(system, system["seed"], 2**31 + 1))
    del out
    sync(system["device"])
    return system["traffic"]["trace_steps"]


def readings(program, expected, collect):
    """The numbers compared: the widest checksum gap as a share of the
    replica's scale (the same sum of magnitudes), and with ``collect`` the
    widest gaps of every step's observation (absolute: observations are
    normalised), of its reward (relative to the reference's ``|reward| +
    provided + 1``: a reward is energies times unit costs, and its rounding
    grows with the energy that flows, not with the reward, which cancels),
    of its energy balance (relative to ``|reference| + 1``), and the count
    of ``done`` flags that differ."""
    gap = lambda a, b: (a.double() - b.double()).abs()  # noqa: E731
    out = {"checksum_gap": (gap(program["checksum"], expected["checksum"])
                            / expected["scale"]).max().item()}
    if collect:
        scale = expected["reward"].double().abs() + expected["provided"].double() + 1
        out["obs_gap"] = gap(program["obs"], expected["obs"]).max().item()
        out["reward_gap"] = (gap(program["reward"], expected["reward"]) / scale).max().item()
        out["energy_gap"] = max((gap(program[f], expected[f])
                                 / (expected[f].double().abs() + 1)).max().item()
                                for f in ("provided", "absorbed"))
        out["done_mismatch"] = float((program["done"] != expected["done"]).sum().item())
    return out


def check(system, control_dtype=None):
    """Work the sampled replicas out again with the configuration's plain
    reference (float64), from the keys the benchmark made, and return the
    program's readings; with ``control_dtype`` also the readings of the
    reference computed in that precision, put in the program's place."""
    config, traffic = system["config"], system["traffic"]
    reference = load_module("reference", config["name"])
    consts = reference.load(config)
    got = {k: torch.cat([x[k] for x in system["kept"]]) for k in system["kept"][0]}
    collect = traffic["collect"]
    args = (consts, got["config"].numpy(), got["keys"].numpy(), traffic["steps"], collect)
    expected = reference.rollout(*args)
    result = {"program": readings(got, expected, collect)}
    if control_dtype is not None:
        control = reference.rollout(*args, dtype=control_dtype)
        result["control"] = readings(control, expected, collect)
    return result
