"""Driver of the closed-loop planner: ``SuiteMPC``'s ``plan`` then ``act``,
one simulated hour of every scenario a call, the device synchronised after
each, in episodes that start at hours drawn from the seed.

Traffic parameters: ``episode_hours`` (an episode's length; the next one
starts at new hours with the battery at its initial charge),
``warmup_hours`` (the hours of set-up), ``trace_hours`` (the traced part:
``step()``, which is ``plan`` then ``act``), ``sample_hours`` (the
(scenario, hour) pairs of the window whose decision the check solves
exactly), and for the benchmark's own CPU tests ``scenarios`` (a subset of
the configuration's).
"""
import inspect
import time

import numpy as np
import torch

from port_bench.harness import load_module, sync

PROGRAM = ("mpc",)   # the program's state: freed before the check
# what a call keeps per scenario: the state it started from, the controls it
# executed (reference/pymgrid25-mpc-suite.py's column order) and its outputs
COLUMNS = ("step", "charge_in", "battery", "grid", "genset_p", "genset_u", "reward",
           "provided", "absorbed", "charge")
CONTROLS = slice(2, 6)


def setup(config, traffic, device, run):
    """Build the planner; a program without ``plan``, ``act`` and a
    ``reset`` that takes ``starts`` cannot run the cell and fails here, before
    the build."""
    from pymgrid_tpu_torch.algos import SuiteMPC

    if not (hasattr(SuiteMPC, "plan") and hasattr(SuiteMPC, "act")
            and "starts" in inspect.signature(SuiteMPC.reset).parameters):
        raise RuntimeError("this SuiteMPC has no plan/act split or reset(starts): "
                           "it cannot run the cell")
    config = dict(config, scenarios=traffic.get("scenarios", config["scenarios"]))
    with run.span("build"):
        mpc = load_module("configs", config["name"]).build(config, traffic, device)
    first = mpc.params["initial_step"].cpu().numpy().astype(np.int64)
    # the last start from which the episode and its last hour's horizon stay
    # inside the series
    last = first + mpc.n_steps_year - (traffic["episode_hours"] + mpc.horizon - 1)
    return {"mpc": mpc, "traffic": traffic, "config": config, "device": device,
            "horizon": mpc.horizon, "first": first, "last": last}


def _starts(system, episode):
    """Episode ``episode``'s start hour per scenario, from ``(seed, episode)``."""
    rng = np.random.default_rng([system["seed"], episode])
    return rng.integers(system["first"], system["last"] + 1)


def prepare(system, seed):
    system["seed"] = seed
    system["episodes"] = []
    system["state"] = None


def _new_episode(system, index):
    starts = _starts(system, index)
    return starts, system["mpc"].reset(system["seed"], starts=starts)


def warm_up(system):
    """Plan and act ``warmup_hours`` from hours the window does not draw, so
    the window launches nothing for the first time."""
    mpc = system["mpc"]
    _, state = _new_episode(system, 2**31)
    for _ in range(system["traffic"]["warmup_hours"]):
        state, out = mpc.act(state, mpc.plan(state))
    del out
    sync(system["device"])


def _call(system):
    """One simulated hour of every scenario; returns ``(enqueue_s,
    latency_s)``.  An episode's first hour starts it (outside the timed
    call).  After the synchronise it keeps on the host the state the hour
    started from, the controls executed and the outputs."""
    mpc, episodes = system["mpc"], system["episodes"]
    if system["state"] is None or len(episodes[-1]["hours"]) == system["traffic"]["episode_hours"]:
        starts, system["state"] = _new_episode(system, len(episodes))
        episodes.append({"starts": starts, "hours": []})
    state = system["state"]
    t0 = time.perf_counter()
    actions = mpc.plan(state)
    new, out = mpc.act(state, actions)
    t1 = time.perf_counter()
    sync(system["device"])
    t2 = time.perf_counter()
    dt = new["battery_charge"].dtype
    genset = actions["genset"][:, 0]      # the superset's one genset: (on/off, production)
    kept = torch.stack([state["step"].to(dt), state["battery_charge"][:, 0],
                        actions["battery"][:, 0], actions["grid"][:, 0], genset[:, 1],
                        genset[:, 0], out.reward, out.provided, out.absorbed,
                        new["battery_charge"][:, 0]], dim=1)
    episodes[-1]["hours"].append(kept.cpu().double())
    system["state"] = new
    return t1 - t0, t2 - t0


def window(system, seconds, run):
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        enqueue, latency = _call(system)
        run.calls.append((enqueue, latency, 1))
    run.window_s = time.perf_counter() - start
    run.env_steps = len(run.calls) * system["mpc"].n_scenarios


def traced(system):
    """The traced part: ``trace_hours`` of ``step()`` from hours the window
    does not draw; returns the hours."""
    mpc = system["mpc"]
    _, state = _new_episode(system, 2**31 + 1)
    for _ in range(system["traffic"]["trace_hours"]):
        state, out = mpc.step(state)
    del out
    sync(system["device"])
    return system["traffic"]["trace_hours"]


def _samples(system, n_scenarios):
    """The (episode, hour, scenario) triples of the decision check, drawn
    from the seed."""
    hours = [(e, h) for e, ep in enumerate(system["episodes"]) for h in range(len(ep["hours"]))]
    pairs = [(e, h, s) for e, h in hours for s in range(n_scenarios)]
    rng = np.random.default_rng([system["seed"], 2])
    k = min(system["traffic"]["sample_hours"], len(pairs))
    return [pairs[i] for i in sorted(rng.choice(len(pairs), k, replace=False))]


def readings(kept, expected, capacity):
    """The numbers compared over every hour of the window: the widest gap of
    a reward (relative to the reference's ``|reward| + provided + 1``: a
    reward is energies times unit costs, and its rounding grows with the
    energy that flows, not with the reward), of the battery's charge after
    the hour (relative to its capacity), and of the energy provided and
    absorbed (relative to ``|reference| + 1``)."""
    col = {k: kept[..., i] for i, k in enumerate(COLUMNS)}
    gap = lambda f: (col[f] - expected[f]).abs()  # noqa: E731
    scale = expected["reward"].abs() + expected["provided"] + 1
    return {"reward_gap": (gap("reward") / scale).max().item(),
            "charge_gap": (gap("charge") / capacity).max().item(),
            "energy_gap": max((gap(f) / (expected[f].abs() + 1)).max().item()
                              for f in ("provided", "absorbed"))}


def check(system, control_dtype=None):
    """Step the scenarios again with the configuration's plain reference
    (float64) on the controls the program executed, from each episode's
    start, and solve the sampled hours' horizon problems exactly; returns
    the program's readings, and with ``control_dtype`` also those of the
    reference computed in that precision put in the program's place."""
    config = system["config"]
    reference = load_module("reference", config["name"])
    configs = reference.load(config)
    episodes = [(ep["starts"], torch.stack(ep["hours"])) for ep in system["episodes"]]
    kept = torch.cat([hours for _, hours in episodes])                  # (T, S, 10)
    controls = [(starts, hours[..., CONTROLS].numpy()) for starts, hours in episodes]
    capacity = torch.as_tensor([float(p["battery"]["max_capacity"]) for p in configs.params],
                               dtype=torch.float64)

    def expected(dtype):
        found = reference.restep(configs, controls, dtype)
        return {k: torch.cat([e[k] for e in found]) for k in found[0]}

    def decisions(dtype):
        gaps = []
        for e, h, s in _samples(system, configs.n_configs):
            row = episodes[e][1][h, s]
            gaps.append(reference.decision_gap(
                configs, s, int(row[0]), float(row[1]), row[CONTROLS].numpy(),
                system["horizon"], dtype))
        return max(gaps)

    exact = expected(torch.float64)
    program = readings(kept, exact, capacity)
    program["decision_gap"] = decisions(torch.float64)
    result = {"program": program}
    if control_dtype is not None:
        found = expected(control_dtype)
        control_kept = kept.clone()
        for i, k in enumerate(COLUMNS):
            if k in found:
                control_kept[..., i] = found[k]
        result["control"] = readings(control_kept, exact, capacity)
        result["control"]["decision_gap"] = decisions(control_dtype)
    return result
