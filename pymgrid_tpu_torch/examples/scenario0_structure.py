#!/usr/bin/env python
"""Scenario-0 structural analysis on the port: why the discrete action space
cannot beat rule-based control, and what the continuous ceiling is.

Port of the repository's ``examples/scenario0_structure.py``, whose captured
output (``docs/captures/scenario0_structure.log``) backs the scenario-0 claims
of ``RESULTS_TRAINING.md``; this prints the same lines in the same order and
format:

* the tariff structure of scenario 0 (numpy, on the port's host microgrid);
* the full-year return of battery-first RBC and of three rules over the
  discrete env's two priority orderings (always grid-first, battery-first
  iff the price reaches 0.25 or 0.50): four replicas of one lockstep
  rollout, replica ``i`` acting with policy ``i``;
* a handcrafted continuous battery dispatch (charge from the grid at the
  0.22 night price, discharge against the 0.59 peak residual, grid follows)
  in a one-replica rollout, and its cost against RBC's.

Every return is the JAX script's: float32 engine, one zero-action step that
is not counted, then ``--steps`` steps whose rewards are summed in float32 in
step order.  The JAX script resets with ``PRNGKey(123)``; scenario 0's oracle
forecasts draw nothing from it, so the port resets without keys and carries
none.  The loops are tensor ops only: nothing waits for the device until the
sums are read.

Run: python -m pymgrid_tpu_torch.examples.scenario0_structure [--steps 8758]
(``--device cpu`` on a machine without a card).
"""
import argparse

import numpy as np
import torch

from pymgrid_tpu_torch._device import resolve_device
from pymgrid_tpu_torch.core.engine import make_reset_fn, make_step_fn
from pymgrid_tpu_torch.core.params import params_to_torch, with_config_axis
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy, make_table_policy
from pymgrid_tpu_torch.core.spec import extract_spec

__all__ = ["tariff_lines", "discrete_returns", "arbitrage_return", "run"]

# (label, price at or above which the rule puts the battery first); RBC is
# replica 0, and "always grid-first" never reaches its level
DISCRETE = (
    ("RBC (battery-first)", None),
    ("always grid-first", float("inf")),
    ("battery-first iff price >= 0.25", 0.25),
    ("battery-first iff price >= 0.50", 0.50),
)


def tariff_lines():
    """The tariff analysis of scenario 0: the lines the JAX script prints
    first (time-of-use levels, the night-to-peak round-trip margin)."""
    from pymgrid_tpu_torch import Microgrid

    mods = {}
    for name, modules in Microgrid.from_scenario(0).modules.iterdict():
        for module in modules:
            mods.setdefault(name, module)
    price = np.asarray(mods["grid"].time_series)[:, 0]
    pv = np.asarray(mods["pv"].time_series).ravel()
    load = -np.asarray(mods["load"].time_series).ravel()
    b = mods["battery"]
    resid = np.maximum(load - pv, 0)
    lines = ["TOU levels and residual load (load beyond PV) per level:"]
    for lvl in np.unique(price):
        m = price == lvl
        lines.append(f"  price {lvl}: residual hours {int((m & (resid > 0)).sum())}, "
                     f"residual sum {resid[m].sum():,.0f}")
    eff = b.efficiency
    margin = price.max() * eff - price.min() / eff - 2 * b.battery_cost_cycle
    lines.append(f"night->peak round-trip margin/unit: {margin:.4f}; "
                 f"usable capacity/day {b.max_capacity - b.min_capacity:,.1f}")
    return lines


def _engine(env, device, batch):
    """float32 spec and params of ``env``, the step, and the state after the
    uncounted zero-action step for ``batch`` replicas."""
    spec, params, _ = extract_spec(env, dtype=np.float32)
    params = with_config_axis(params_to_torch(params, device, torch.float32))
    step = make_step_fn(spec, normalized=False, with_obs=False, with_log=False)
    starts = params["initial_step"].to(torch.int32).view(1, 1).expand(1, batch)
    zeros = lambda *tail: torch.zeros((1, batch) + tail, dtype=torch.float32,  # noqa: E731
                                      device=device)
    zero = {"battery": zeros(spec.n_battery), "genset": zeros(spec.n_genset, 2),
            "grid": zeros(spec.n_grid)}
    state, _ = step(params, make_reset_fn(spec)(params, starts), zero)
    return spec, params, step, state


def _returns(params, step, state, policy, n_steps):
    """``(1, B)`` float32 sums of ``n_steps`` rewards, added in step order."""
    acc = torch.zeros(state["step"].shape, dtype=torch.float32, device=state["step"].device)
    for _ in range(n_steps):
        state, out = step(params, state, policy(params, state))
        acc = acc + out.reward
    return acc


def discrete_returns(device, n_steps):
    """The four discrete policies' returns (:data:`DISCRETE`'s order) as
    four replicas of one rollout of the discrete env on scenario 0."""
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv

    env = DiscreteMicrogridEnv.from_scenario(0)
    spec, params, step, state = _engine(env, device, len(DISCRETE))
    rbc = make_marginal_cost_policy(spec)
    table = make_table_policy(spec, [list(pl) for pl in env.actions_list], device)
    bat_idx = 0 if env.actions_list[0][0].module[0] == "battery" else 1
    price_ts = params["grid"]["ts"][0, 0, :, 0]
    levels = torch.tensor([[np.nan if lvl is None else lvl for _, lvl in DISCRETE]],
                          dtype=torch.float32, device=device)
    is_rbc = torch.tensor([[lvl is None for _, lvl in DISCRETE]], device=device)

    def policy(params, state):
        price = price_ts[state["step"].long()]
        idx = torch.where(price >= levels, bat_idx, 1 - bat_idx)
        ruled, base = table(params, state, idx), rbc(params, state)
        return {k: torch.where(is_rbc.view(is_rbc.shape + (1,) * (v.dim() - 2)), base[k], v)
                for k, v in ruled.items()}

    return _returns(params, step, state, policy, n_steps)[0].tolist()


def arbitrage_return(device, n_steps):
    """The handcrafted night-to-peak arbitrage on the continuous env of
    scenario 0 (one replica), in the JAX script's operation order."""
    from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv

    spec, params, step, state = _engine(ContinuousMicrogridEnv.from_scenario(0), device, 1)
    pb = params["battery"]
    grid_ts, load_ts = params["grid"]["ts"][0, 0], params["load"]["ts"][0, 0]
    pv_ts = params["renewable"]["ts"][0, 0]
    genset = torch.zeros((1, 1, spec.n_genset, 2), dtype=torch.float32, device=device)

    def arb(params, state):
        t = state["step"].long()
        p = grid_ts[t, 0]
        load0, pv0 = -load_ts[t, 0], pv_ts[t, 0]
        charge = state["battery_charge"][..., 0]
        e = pb["efficiency"][:, :1]
        res = torch.clamp_min(load0 - pv0, 0.0)
        max_dis = torch.minimum(pb["max_discharge"][:, :1], charge - pb["min_capacity"][:, :1]) * e
        max_chg = torch.minimum(pb["max_charge"][:, :1], pb["max_capacity"][:, :1] - charge) / e
        bat = torch.where(p >= 0.50, torch.minimum(max_dis, res),
                          torch.where(p <= 0.23, -max_chg, torch.zeros_like(max_chg)))
        need = res - torch.clamp_min(bat, 0.0) + torch.clamp_min(-bat, 0.0)
        grid = torch.minimum(torch.clamp_min(need, 0.0), params["grid"]["max_import"][:, :1])
        return {"battery": bat.unsqueeze(-1), "genset": genset, "grid": grid.unsqueeze(-1)}

    return _returns(params, step, state, arb, n_steps)[0, 0].item()


def run(device="cuda", n_steps=8758):
    """The study's printed lines and its returns ``{label: return}``."""
    device = resolve_device(device)
    lines = tariff_lines()
    lines.append(f"discrete action space over {n_steps} steps:")
    returns = dict(zip((label for label, _ in DISCRETE), discrete_returns(device, n_steps)))
    lines += [f"  {label}: {r:,.2f}" for label, r in returns.items()]
    lines.append("continuous space (battery dispatch + grid follower):")
    label = "handcrafted night->peak arbitrage"
    returns[label] = r_arb = arbitrage_return(device, n_steps)
    lines.append(f"  {label}: {r_arb:,.2f}")
    r_rbc = returns[DISCRETE[0][0]]
    lines.append(f"handcrafted vs RBC: {(1 - r_arb / r_rbc) * 100:+.2f}% cost")
    return lines, returns


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=8758)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    lines, _ = run(args.device, args.steps)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
