"""Plain reference of the configuration ``pymgrid25-rbc-suite``: the 25
pymgrid25 microgrids in the suite's superset layout under the marginal-cost
rule-based controller, auto-reset, starts drawn from each replica's key.

:func:`rollout` works out, for ``N`` replicas given by their config and
their key, what a suite rollout of ``n_steps`` returns for them: the
checksum (every step's reward plus the sum of its observation), its scale
(the same sum of magnitudes), and with ``collect`` every step's outputs.
"""
import os

import numpy as np
import torch

from port_bench.reference.pymgrid25 import Configs, Microgrids, draw_starts, next_keys

# the suite's observation: container order, the balancing module observes nothing
OBS_ORDER = ("load", "renewable", "genset", "battery", "grid")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(config):
    """The constants of every config of ``config`` (the configuration file)."""
    return Configs(os.path.join(ROOT, config["data_dir"]), config["scenarios"], superset=True)


def rollout(configs, cfg, keys, n_steps, collect, dtype=torch.float64):
    """``cfg (N,)`` config indices, ``keys (N, 2)`` uint32 words.  Without
    ``collect`` a finished replica continues at the sequential wrap of its
    step; with it, at a start drawn from its key, which every step splits.
    Returns ``{"checksum", "scale"}`` ``(N,)`` in float64, and with
    ``collect`` also ``reward``, ``done``, ``obs``, ``provided`` and
    ``absorbed`` stacked ``(N, T, ...)``."""
    mg = Microgrids(configs, cfg, dtype, OBS_ORDER)
    i0 = mg.initial_step.numpy()
    max_start = configs.max_start
    keys = np.asarray(keys, dtype=np.uint64)
    state = mg.reset(draw_starts(keys, i0, max_start))
    order = mg.marginal_cost_order()
    checksum = torch.zeros(len(i0), dtype=dtype)
    scale = torch.zeros(len(i0), dtype=torch.float64)
    outs = []
    for _ in range(n_steps):
        new, out = mg.step(state, mg.marginal_cost_action(state, order))
        checksum = checksum + out["reward"] + out["obs"].sum(dim=1)
        scale += out["reward"].double().abs() + out["obs"].double().abs().sum(dim=1)
        if collect:
            keys = next_keys(keys)
            target = torch.as_tensor(draw_starts(keys, i0, max_start))
            outs.append(out)
        else:
            i0t = mg.initial_step
            target = i0t + torch.remainder(new["t"] - i0t, max_start - i0t)
        state = Microgrids.select(out["done"], mg.reset(target), new)
    result = {"checksum": checksum.double(), "scale": scale}
    if collect:
        for field in ("reward", "done", "obs", "provided", "absorbed"):
            result[field] = torch.stack([o[field] for o in outs], dim=1)
    return result
