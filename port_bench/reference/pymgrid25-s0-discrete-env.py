"""Plain reference of the configuration ``pymgrid25-s0-discrete-env``:
pymgrid25 scenario 0 as upstream's discrete env, whose action picks a
priority list of the controllable modules; auto-reset to the first step.

:func:`steps` works out what ``N`` replicas observe, earn and report as
done over ``n_steps`` steps, from the start, fed ``actions[i % P]`` at step
``i``.
"""
import os

import torch

from port_bench.reference.pymgrid25 import Configs, Microgrids

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(config):
    """The constants of the configuration's one scenario, as its file lays
    it out."""
    return Configs(os.path.join(ROOT, config["data_dir"]), config["scenarios"], superset=False)


def obs_order(configs):
    """The env's flat observation: modules sorted by name."""
    observed = [k for k in configs.kinds if k != "balancing"]
    return tuple(sorted(observed, key=lambda kind: configs.names[kind]))


def steps(configs, actions, n_steps, dtype=torch.float64):
    """``actions (P, N)`` integer priority-list indices.  Returns
    ``reward (N, T)``, ``done (N, T)``, ``obs (N, T, obs_dim)`` and the
    energy ``provided (N, T)``."""
    actions = torch.as_tensor(actions, dtype=torch.long)
    n = actions.shape[1]
    mg = Microgrids(configs, torch.zeros(n, dtype=torch.long), dtype, obs_order(configs))
    lists = mg.priority_lists()
    state = mg.reset(mg.initial_step)
    outs = []
    for i in range(n_steps):
        new, out = mg.step(state, mg.priority_action(state, actions[i % len(actions)], lists))
        state = Microgrids.select(out["done"], mg.reset(mg.initial_step), new)
        outs.append(out)
    return {field: torch.stack([o[field] for o in outs], dim=1)
            for field in ("reward", "done", "obs", "provided")}
