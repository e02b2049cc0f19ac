"""Driver of an RL agent's loop on the batched discrete env: one
``step()`` call per env step with its default ``keep_logs=True``, and a
device synchronise after each, as an agent that acts on every observation
waits for it.

Traffic parameters: ``replicas``, ``action_pool`` (rows of actions the loop
cycles), ``sample`` (replicas compared), ``sample_block`` (steps of samples
gathered on the device before they move to the host), ``warmup_steps``,
``trace_steps``.
"""
import time

import numpy as np
import torch

from port_bench.harness import load_module, sync

FIELDS = ("reward", "done", "obs")
PROGRAM = ("env", "states")   # the program's state: freed before the check


def setup(config, traffic, device, run):
    with run.span("build"):
        env = load_module("configs", config["name"]).build(config, traffic, device)
    return {"env": env, "traffic": traffic, "config": config, "device": device}


def prepare(system, seed):
    """Actions uniform over the priority lists, drawn on the host from the
    seed into a device pool of ``action_pool`` rows that the loop cycles, and
    the replicas compared."""
    env, traffic = system["env"], system["traffic"]
    rng = np.random.default_rng([seed, 0])
    pool = rng.integers(0, env.n_actions, (traffic["action_pool"], env.batch_size))
    system["pool"] = torch.as_tensor(pool, dtype=torch.int64, device=system["device"])
    system["sample"] = torch.as_tensor(np.sort(rng.choice(env.batch_size, traffic["sample"],
                                                          replace=False)),
                                       device=system["device"])
    system["kept"] = []


def warm_up(system):
    """A few steps, and the sample buffer: ``sample_block`` steps of the
    sampled replicas' outputs, shaped from a step's, allocated before the
    window."""
    env, pool, sample = system["env"], system["pool"], system["sample"]
    states = env.reset()
    for i in range(system["traffic"]["warmup_steps"]):
        states, out = env.step(states, pool[i])
    size = system["traffic"]["sample_block"]
    system["block"] = {f: torch.empty((size, len(sample)) + getattr(out, f).shape[1:],
                                      dtype=getattr(out, f).dtype, device=system["device"])
                       for f in FIELDS}
    _keep(system, out, 0)
    sync(system["device"])


def _keep(system, out, row):
    """The sampled replicas of one step's outputs into ``row`` of the buffer."""
    for f in FIELDS:
        torch.index_select(getattr(out, f), 0, system["sample"], out=system["block"][f][row])


def _flush(system, rows):
    system["kept"].append({f: b[:rows].to("cpu", copy=True) for f, b in system["block"].items()})


def window(system, seconds, run):
    """Steps from reset states for ``seconds``.  Each call is timed from the
    call to the end of the synchronise after it; the samples are gathered
    after that, and a full buffer moves to the host between two calls."""
    env, pool, device = system["env"], system["pool"], system["device"]
    size = system["traffic"]["sample_block"]
    run.harness_bytes = sum(b.numel() * b.element_size() for b in system["block"].values())
    states = env.reset()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        states, out = env.step(states, pool[i % len(pool)])
        t1 = time.perf_counter()
        sync(device)
        run.calls.append((t1 - t0, time.perf_counter() - t0, 1))
        _keep(system, out, i % size)
        i += 1
        if i % size == 0:
            _flush(system, size)
    run.window_s = time.perf_counter() - start
    if i % size:
        _flush(system, i % size)
    system["states"] = states
    run.env_steps = i * env.batch_size


def traced(system):
    """The traced part: ``trace_steps`` further step calls, each
    synchronised, from where the window stopped; nothing sampled."""
    env, pool, states = system["env"], system["pool"], system["states"]
    n = system["traffic"]["trace_steps"]
    for i in range(n):
        states, out = env.step(states, pool[i % len(pool)])
        sync(system["device"])
    return n


def readings(program, expected):
    """The widest gap of an observation (absolute: observations are
    normalised), of a reward (relative to the reference's ``|reward| +
    provided + 1``: its rounding grows with the energy that flows), and the
    count of ``done`` flags that differ."""
    gap = lambda a, b: (a.double() - b.double()).abs()  # noqa: E731
    scale = expected["reward"].double().abs() + expected["provided"].double() + 1
    return {
        "obs_gap": gap(program["obs"], expected["obs"]).max().item(),
        "reward_gap": (gap(program["reward"], expected["reward"]) / scale).max().item(),
        "done_mismatch": float((program["done"] != expected["done"]).sum().item()),
    }


def check(system, control_dtype=None):
    """Every step of the window for the sampled replicas, worked out again
    by the configuration's plain reference in float64 from the same actions;
    with ``control_dtype`` also the reference in that precision put in the
    program's place.  ``system["kept"]`` holds ``(T_i, N, ...)`` blocks."""
    config = system["config"]
    reference = load_module("reference", config["name"])
    consts = reference.load(config)
    got = {f: torch.cat([k[f] for k in system["kept"]]).transpose(0, 1) for f in FIELDS}
    actions = system["pool"][:, system["sample"]].cpu()
    n_steps = got["reward"].shape[1]
    expected = reference.steps(consts, actions, n_steps)
    result = {"program": readings(got, expected)}
    if control_dtype is not None:
        result["control"] = readings(reference.steps(consts, actions, n_steps, control_dtype),
                                     expected)
    return result
