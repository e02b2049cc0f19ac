"""Plain reference of the pymgrid25 microgrids, written from pymgrid's rules.

It reads the scenario files itself (the YAML and its ``.csv.gz`` series) and
steps ``N`` independent microgrids at once in plain PyTorch on the CPU, each
microgrid ``n`` under the parameters of its config ``cfg[n]``.  It imports
nothing of the program under test.  What it computes, and where pymgrid
states it:

* a time-series module's series takes the sign of its role (a load is
  consumed, so it is negative; a renewable is positive; a grid's four columns
  stay as they are, with a status column of ones where a grid has three),
  its observation bounds are the series' minimum and maximum stretched to
  include 0 (a grid's are each column's own minimum and maximum), and its
  forecast is the oracle's: the next ``horizon`` rows, padded past the end
  with the bounds' midpoint;
* an observation is ``(value - low) / (high - low)`` (a zero spread counts
  as 1); a battery observes ``(soc, charge)``, a genset its status, goal and
  the two counters;
* a step dispatches in three phases: the fixed loads, the controllable
  modules (battery, genset, grid) on the action, then the flexible ones (the
  renewable covers what is missing, the balancing module takes the rest as
  lost load or overgeneration); each module's reward is its cost, negated;
* a microgrid is done at ``final_step - 1`` of any of its series;
* the rule-based controller deploys the controllable modules in order of
  marginal cost against the net load; the discrete env deploys them in the
  order of the priority list its action names.

``dtype`` is the precision of every float: float64 is the reference, and a
lower one is the control that a sound comparison has to reject.
"""
import gzip
import itertools
import os

import numpy as np
import torch
import yaml

from port_bench.reference import threefry

KIND_OF_TAG = {
    "LoadModule": "load",
    "RenewableModule": "renewable",
    "UnbalancedEnergyModule": "balancing",
    "BatteryModule": "battery",
    "Genset": "genset",
    "GensetModule": "genset",
    "GridModule": "grid",
}
SUPERSET_ORDER = ("load", "renewable", "balancing", "genset", "battery", "grid")
NEAR_ZERO = 1e-4          # a remainder this small deploys nothing (pymgrid's priority lists)
START_SALT = 0x51A7       # the fold-in word of a start draw


class _Loader(yaml.SafeLoader):
    """Reads pymgrid's tagged YAML as plain dicts: ``{"tag": ..., "value": ...}``."""


def _tagged(loader, suffix, node):
    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = loader.construct_sequence(node, deep=True)
    else:
        value = loader.construct_scalar(node)
    return {"tag": suffix, "value": value}


_Loader.add_multi_constructor("!", _tagged)


def _read_series(path):
    """A ``.csv.gz`` series without its header row and index column."""
    with gzip.open(path, "rt") as f:
        arr = np.loadtxt(f, delimiter=",", skiprows=1, ndmin=2)
    return arr[:, 1:]


def load_scenario(data_dir, number):
    """Scenario ``number`` as a list of ``(name, kind, params)`` in file
    order; a time-series module's params carry its series as ``ts``."""
    folder = os.path.join(data_dir, f"microgrid_{number}")
    with open(os.path.join(folder, f"microgrid_{number}.yaml")) as f:
        doc = yaml.load(f, Loader=_Loader)
    modules = []
    for name, module in doc["value"]["modules"]:
        kind = KIND_OF_TAG[module["tag"]]
        params = dict(module["value"]["cls_params"])
        if isinstance(params.get("time_series"), dict):
            params["ts"] = _read_series(os.path.join(folder, params["time_series"]["value"]))
        modules.append((name, kind, params))
    return modules


def _ts_module(kind, ts, params):
    """Sign, bounds, padding constants and horizon of a time-series module."""
    ts = np.asarray(ts, dtype=np.float64)
    if kind == "grid":
        if ts.shape[1] == 3:
            ts = np.concatenate([ts, np.ones((len(ts), 1))], axis=1)
        lo, hi = ts.min(axis=0), ts.max(axis=0)
    else:
        ts = -np.abs(ts) if kind == "load" else np.abs(ts)
        lo, hi = min(ts.min(), 0.0), max(ts.max(), 0.0)
        lo, hi = np.full(ts.shape[1], lo), np.full(ts.shape[1], hi)
    spread = np.where(hi == lo, 1.0, hi - lo)
    final = params.get("final_step", -1)
    horizon = params.get("forecast_horizon", 0) if params.get("forecaster") else 0
    return {"ts": ts, "low": lo, "spread": spread, "fill": (hi + lo) / 2,
            "final_step": len(ts) if final is None or final <= 0 else int(final),
            "initial_step": int(params.get("initial_step", 0)), "horizon": int(horizon)}


def _superset(modules):
    """The suite's superset layout: one module of every kind, with a grid
    that imports and exports nothing and a genset that produces nothing where
    the scenario has none."""
    by_kind = {kind: (name, params) for name, kind, params in modules}
    ts_params = [p for _, k, p in modules if k in ("load", "renewable", "grid")]
    last = ts_params[-1]
    horizon = next(p.get("forecast_horizon", 0) for p in ts_params if p.get("forecaster"))
    if "grid" not in by_kind:
        ts = np.zeros((len(last["ts"]), 4))
        ts[:, 3] = 1.0
        by_kind["grid"] = ("grid", {"ts": ts, "max_import": 0.0, "max_export": 0.0,
                                    "cost_per_unit_co2": 0.0, "forecaster": "oracle",
                                    "forecast_horizon": horizon,
                                    "initial_step": last.get("initial_step", 0),
                                    "final_step": last.get("final_step", -1)})
    if "genset" not in by_kind:
        by_kind["genset"] = ("genset", {"running_min_production": 0.0,
                                        "running_max_production": 0.0, "genset_cost": 0.0})
    return [(by_kind[k][0], k, by_kind[k][1]) for k in SUPERSET_ORDER]


class Configs:
    """Stacked constants of the configs ``numbers`` as float64 numpy arrays
    ``(C, ...)``.  ``superset=True`` lays every config out as the suite does;
    otherwise every config keeps its own modules (they must agree in kind)."""

    def __init__(self, data_dir, numbers, superset):
        per_config = []
        for n in numbers:
            modules = load_scenario(data_dir, n)
            per_config.append(_superset(modules) if superset else modules)
        kinds = [k for _, k, _ in per_config[0]]
        if any([k for _, k, _ in mods] != kinds for mods in per_config):
            raise ValueError("configs of one batch need the same module kinds")
        self.kinds = kinds
        self.names = {k: name for name, k, _ in per_config[0]}
        self.n_configs = len(numbers)
        self.params = [{k: p for _, k, p in mods} for mods in per_config]
        self.ts = {kind: [_ts_module(kind, p[kind]["ts"], p[kind]) for p in self.params]
                   for kind in ("load", "renewable", "grid") if kind in kinds}
        self.horizon = max(m["horizon"] for mods in self.ts.values() for m in mods)
        self.pad = self.horizon + 2
        self.series_len = min(len(m["ts"]) for mods in self.ts.values() for m in mods)
        self.max_start = self.series_len - 1
        self.initial_step = np.array([self.ts["load"][c]["initial_step"]
                                      for c in range(self.n_configs)])

    def column(self, kind, key, default=None):
        return np.array([float(p[kind].get(key, default) if default is not None
                               else p[kind][key]) for p in self.params])


class Microgrids:
    """``N`` microgrids of ``configs`` in plain PyTorch on the CPU: ``cfg``
    ``(N,)`` names each one's config.  ``obs_order`` lists the observed
    kinds in the order the observation concatenates them."""

    def __init__(self, configs, cfg, dtype, obs_order):
        self.c = configs
        self.cfg = torch.as_tensor(np.asarray(cfg), dtype=torch.long)
        self.dtype = dtype
        self.obs_order = obs_order
        f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))[self.cfg].to(dtype)  # noqa: E731
        self.series = {}
        for kind, mods in configs.ts.items():
            n_rows = max(len(m["ts"]) for m in mods) + configs.pad
            width = mods[0]["ts"].shape[1]
            padded = np.empty((len(mods), n_rows, width))
            for i, m in enumerate(mods):
                padded[i] = m["fill"]
                padded[i, :len(m["ts"])] = m["ts"]
            self.series[kind] = {
                "rows": torch.as_tensor(padded).to(dtype),
                "low": f([m["low"] for m in mods]), "spread": f([m["spread"] for m in mods]),
                "final": torch.as_tensor([m["final_step"] for m in mods])[self.cfg],
                "horizon": mods[0]["horizon"],
            }
        kinds = configs.kinds
        if "battery" in kinds:
            col = lambda k, d=None: f(configs.column("battery", k, d))  # noqa: E731
            self.bat = {k: col(k) for k in ("min_capacity", "max_capacity", "max_charge",
                                            "max_discharge", "efficiency")}
            self.bat["cost"] = col("battery_cost_cycle", 0.0)
            init = [p["battery"]["init_charge"] if p["battery"].get("init_charge") is not None
                    else p["battery"]["init_soc"] * p["battery"]["max_capacity"]
                    for p in configs.params]
            self.bat["init"] = f(init)
            self.bat["min_soc"] = self.bat["min_capacity"] / self.bat["max_capacity"]
        if "genset" in kinds:
            col = lambda k, d=None: f(configs.column("genset", k, d))  # noqa: E731
            self.gen = {"min": col("running_min_production"), "max": col("running_max_production"),
                        "cost": col("genset_cost"), "co2_unit": col("co2_per_unit", 0.0),
                        "co2_cost": col("cost_per_unit_co2", 0.0)}
            ints = lambda k, d: torch.as_tensor(configs.column("genset", k, d))[self.cfg].long()  # noqa: E731
            self.gen["up_time"] = ints("start_up_time", 0)
            self.gen["down_time"] = ints("wind_down_time", 0)
            self.gen["abort"] = ints("allow_abortion", 1).bool()
            self.gen["init"] = ints("init_start_up", 1)
        if "grid" in kinds:
            col = lambda k, d=None: f(configs.column("grid", k, d))  # noqa: E731
            self.grid = {"max_import": col("max_import"), "max_export": col("max_export"),
                         "co2_cost": col("cost_per_unit_co2", 0.0)}
        if "balancing" in kinds:
            col = lambda k: f(configs.column("balancing", k))  # noqa: E731
            self.bal = {"loss_load": col("loss_load_cost"), "overgen": col("overgeneration_cost")}
        self.initial_step = torch.as_tensor(configs.initial_step)[self.cfg]

    # ------------------------------------------------------------- state
    def reset(self, starts):
        """States at the steps ``starts`` ``(N,)``."""
        state = {"t": torch.as_tensor(starts, dtype=torch.long).clone()}
        if "battery" in self.c.kinds:
            state["charge"] = self.bat["init"].clone()
        if "genset" in self.c.kinds:
            on = self.gen["init"] == 1
            zero = torch.zeros_like(self.gen["init"])
            state["gen"] = {"cur": self.gen["init"].clone(), "goal": self.gen["init"].clone(),
                            "up": torch.where(on, zero, self.gen["up_time"]),
                            "down": torch.where(on, self.gen["down_time"], zero)}
        return state

    @staticmethod
    def select(done, fresh, current):
        if isinstance(current, dict):
            return {k: Microgrids.select(done, fresh[k], current[k]) for k in current}
        return torch.where(done, fresh, current)

    # -------------------------------------------------------- time series
    def row(self, kind, t):
        s = self.series[kind]
        idx = t.clamp(0, s["rows"].shape[1] - 1)
        return s["rows"][self.cfg, idx]                  # (N, width)

    def _ts_obs(self, kind, t):
        s = self.series[kind]
        h = s["horizon"]
        rows = self.row(kind, t).unsqueeze(1)           # (N, 1, width)
        if h:
            start = (t + 1).clamp(0, s["rows"].shape[1] - h)
            idx = start.unsqueeze(1) + torch.arange(h)
            rows = torch.cat([rows, s["rows"][self.cfg.unsqueeze(1), idx]], dim=1)
        return ((rows - s["low"].unsqueeze(1)) / s["spread"].unsqueeze(1)).flatten(1)

    def observe(self, state):
        """The normalized observation at ``state["t"]``, ``(N, obs_dim)``."""
        parts = []
        for kind in self.obs_order:
            if kind in ("load", "renewable", "grid"):
                parts.append(self._ts_obs(kind, state["t"]))
            elif kind == "battery":
                b, charge = self.bat, state["charge"]
                low = torch.stack([b["min_soc"], b["min_capacity"]], 1)
                spread = torch.stack([1 - b["min_soc"], b["max_capacity"] - b["min_capacity"]], 1)
                spread = torch.where(spread == 0, torch.ones_like(spread), spread)
                vec = torch.stack([charge / b["max_capacity"], charge], 1)
                parts.append((vec - low) / spread)
            elif kind == "genset":
                g = state["gen"]
                spread = torch.stack([torch.ones_like(self.gen["up_time"]),
                                      torch.ones_like(self.gen["up_time"]),
                                      self.gen["up_time"], self.gen["down_time"]], 1)
                spread = torch.where(spread == 0, 1, spread).to(self.dtype)
                vec = torch.stack([g["cur"], g["goal"], g["up"], g["down"]], 1).to(self.dtype)
                parts.append(vec / spread)
        return torch.cat(parts, dim=1)

    # ----------------------------------------------------------- policies
    def net_load(self, t):
        load = -self.row("load", t)[:, 0]
        return load - self.row("renewable", t)[:, 0]

    def battery_bounds(self, state):
        b, charge = self.bat, state["charge"]
        max_p = torch.minimum(b["max_discharge"], charge - b["min_capacity"]) * b["efficiency"]
        max_c = torch.minimum(b["max_charge"], b["max_capacity"] - charge) / b["efficiency"]
        return max_p, max_c

    def grid_bounds(self, t):
        status = self.row("grid", t)[:, 3]
        return self.grid["max_import"] * status, self.grid["max_export"] * status

    @staticmethod
    def deploy(remaining, max_p, max_c):
        """A source-and-sink's share of the remainder: produce up to
        ``max_p``, or absorb an excess up to ``max_c``."""
        out = torch.where(remaining > 0, torch.clamp(remaining, max=max_p).clamp(min=0),
                          torch.maximum(remaining, -max_c))
        return torch.where(remaining.abs() <= NEAR_ZERO, torch.zeros_like(out), out)

    def genset_energy(self, remaining, state, goal):
        """The genset's production under ``goal`` from the status it will
        reach: on once it may be on, off once it may be off."""
        g = state["gen"]
        next_on = torch.where((g["cur"] == 1) | (g["up"] == 0), 1, 0)
        next_off = torch.where((g["cur"] == 0) | (g["down"] == 0), 0, 1)
        status = torch.where(goal == 1, next_on, next_off).to(self.dtype)
        lo, hi = status * self.gen["min"], status * self.gen["max"]
        out = torch.where(remaining > 0, torch.minimum(torch.maximum(remaining, lo), hi),
                          torch.zeros_like(remaining))
        return torch.where(remaining.abs() <= NEAR_ZERO, torch.zeros_like(out), out)

    def marginal_cost_order(self):
        """Each config's deployment order of (genset, battery, grid) by
        marginal cost, ties kept in that order: ``(N, 3)`` indices."""
        gen = self.gen["cost"] + self.gen["co2_cost"] * self.gen["co2_unit"]
        bat = self.bat["cost"]
        grid = self.series["grid"]["rows"][self.cfg, self.initial_step, 0]
        return torch.argsort(torch.stack([gen, bat, grid], 1), dim=1, stable=True)

    def marginal_cost_action(self, state, order):
        """The rule-based controller's action: the genset is asked on only
        where its minimum production is 0."""
        t = state["t"]
        remaining = self.net_load(t)
        goal = torch.where(self.gen["min"] == 0, 1, 0)
        energy = {}
        for position in range(3):
            branch = [self.genset_energy(remaining, state, goal),
                      self.deploy(remaining, *self.battery_bounds(state)),
                      self.deploy(remaining, *self.grid_bounds(t))]
            pick = order[:, position]
            chosen = torch.zeros_like(remaining)
            for j, kind in enumerate(("genset", "battery", "grid")):
                here = pick == j
                chosen = torch.where(here, branch[j], chosen)
                energy[kind] = torch.where(here, branch[j], energy.get(kind, torch.zeros_like(remaining)))
            remaining = remaining - chosen
        return {"battery": energy["battery"], "grid": energy["grid"],
                "genset": energy["genset"], "genset_goal": goal}

    def priority_lists(self):
        """The discrete env's actions: every order of the controllable
        sources (a genset twice, off and on) with each module once,
        dropping lists that switch off a genset whose minimum is 0."""
        elements = []
        for kind in self.c.kinds:
            if kind == "genset":
                elements += [("genset", 0), ("genset", 1)]
        for kind in self.c.kinds:
            if kind in ("battery", "grid"):
                elements.append((kind, 0))
        lists = []
        for perm in itertools.permutations(elements):
            seen, kept = set(), []
            for kind, goal in perm:
                if kind not in seen:
                    seen.add(kind)
                    kept.append((kind, goal))
            if tuple(kept) not in lists:
                lists.append(tuple(kept))
        if "genset" in self.c.kinds and float(self.c.params[0]["genset"]["running_min_production"]) == 0:
            lists = [pl for pl in lists if ("genset", 0) not in pl]
        return lists

    def priority_action(self, state, action_idx, lists):
        """The discrete env's action: deploy the modules of the list
        ``action_idx`` names, in its order."""
        t = state["t"]
        remaining = self.net_load(t)
        zero = torch.zeros_like(remaining)
        energy = {"battery": zero, "grid": zero, "genset": zero}
        goal = torch.zeros_like(action_idx)
        for position in range(len(lists[0])):
            chosen = zero
            for a, plist in enumerate(lists):
                kind, g = plist[position]
                here = action_idx == a
                if kind == "genset":
                    e = self.genset_energy(remaining, state, torch.full_like(action_idx, g))
                    goal = torch.where(here, g, goal)
                elif kind == "battery":
                    e = self.deploy(remaining, *self.battery_bounds(state))
                else:
                    e = self.deploy(remaining, *self.grid_bounds(t))
                chosen = torch.where(here, e, chosen)
                energy[kind] = torch.where(here, e, energy[kind])
            remaining = remaining - chosen
        return {**energy, "genset_goal": goal}

    # --------------------------------------------------------------- step
    def step(self, state, action):
        """One step: ``(new_state, out)``, ``out`` the reward, the done
        flag, the energy provided and absorbed, and the observation after
        the step."""
        t = state["t"]
        zero = torch.zeros(t.shape, dtype=self.dtype)
        provided, absorbed, reward = zero, zero, zero
        done = torch.zeros(t.shape, dtype=torch.bool)
        new = {"t": t + 1}

        load_met = -self.row("load", t)[:, 0]
        absorbed = absorbed + load_met
        done |= t >= self.series["load"]["final"] - 1

        if "battery" in self.c.kinds:
            b, a, charge = self.bat, action["battery"], state["charge"]
            max_prod, max_cons = self.battery_bounds(state)
            discharge = torch.minimum(torch.clamp(a, min=0), max_prod)
            charge_in = torch.minimum(-a, max_cons)
            is_sink = a < 0
            internal = torch.where(is_sink, charge_in * b["efficiency"], -discharge / b["efficiency"])
            discharge = torch.where(is_sink, zero, discharge)
            charge_in = torch.where(is_sink, charge_in, zero)
            new["charge"] = torch.maximum(charge + internal, b["min_capacity"])
            reward = reward - internal.abs() * b["cost"]
            provided, absorbed = provided + discharge, absorbed + charge_in
        if "genset" in self.c.kinds:
            new["gen"] = self._genset_machine(state["gen"], action["genset_goal"].round().long())
            status = new["gen"]["cur"].to(self.dtype)
            prod = torch.minimum(torch.maximum(action["genset"], status * self.gen["min"]),
                                 status * self.gen["max"])
            co2 = self.gen["co2_unit"] * prod
            reward = reward - (self.gen["cost"] * prod + self.gen["co2_cost"] * co2)
            provided = provided + prod
        if "grid" in self.c.kinds:
            row = self.row("grid", t)
            a, status = action["grid"], row[:, 3]
            is_sink = a < 0
            imp = torch.where(is_sink, zero,
                              torch.minimum(torch.clamp(a, min=0), self.grid["max_import"] * status))
            exp = torch.where(is_sink, torch.minimum(-a, self.grid["max_export"] * status), zero)
            co2 = imp * row[:, 2]
            reward = reward + torch.where(is_sink, row[:, 1] * exp,
                                          -row[:, 0] * imp - self.grid["co2_cost"] * co2)
            provided, absorbed = provided + imp, absorbed + exp
            done |= t >= self.series["grid"]["final"] - 1

        difference = provided - absorbed
        excess = difference > 0
        needed = torch.where(excess, zero, -difference)
        renewable = self.row("renewable", t)[:, 0]
        used = torch.minimum(renewable, needed)
        provided = provided + used
        needed = needed - used
        done |= t >= self.series["renewable"]["final"] - 1
        if "balancing" in self.c.kinds:
            over = torch.where(excess, difference, zero)
            lost = needed
            reward = reward - torch.where(excess, self.bal["overgen"] * over,
                                          self.bal["loss_load"] * lost)
            provided, absorbed = provided + lost, absorbed + over

        obs = self.observe(new)
        return new, {"reward": reward, "done": done, "obs": obs,
                     "provided": provided, "absorbed": absorbed}

    def _genset_machine(self, g, goal):
        """pymgrid's genset status machine, one tick, before the dispatch."""
        up_time, down_time = self.gen["up_time"], self.gen["down_time"]
        cur, goal_st, up, down = g["cur"], g["goal"], g["up"], g["down"]
        one, zero = torch.ones_like(goal), torch.zeros_like(goal)
        equilibrium = (goal == cur) & (cur == goal_st)
        accept = (goal != goal_st) & (self.gen["abort"] | ((up_time == 0) & (goal == 1))
                                      | ((down_time == 0) & (goal == 0)))
        goal1 = torch.where(accept, goal, goal_st)
        fin_up = (up == 0) & (goal1 == 1)
        fin_down = ~fin_up & (down == 0) & (goal1 == 0)
        cur1 = torch.where(fin_up, one, torch.where(fin_down, zero, cur))
        up1 = torch.where(fin_up, zero, torch.where(fin_down, up_time, up))
        down1 = torch.where(fin_up, down_time, torch.where(fin_down, zero, down))
        request = (cur1 == goal1) & (goal1 != goal)
        up2 = torch.where(request, torch.where(cur1 == 1, zero, up_time), up1)
        down2 = torch.where(request, torch.where(cur1 == 1, down_time, zero), down1)
        goal2 = torch.where(request, goal, goal1)
        moving = goal2 != cur1
        up3 = torch.where(moving & (goal2 == 1), up2 - 1, up2)
        down3 = torch.where(moving & (goal2 == 0), down2 - 1, down2)
        settled = fin_up | fin_down
        keep = lambda old, a, b: torch.where(equilibrium, old, torch.where(settled, a, b))  # noqa: E731
        return {"cur": torch.where(equilibrium, cur, cur1), "goal": keep(goal_st, goal1, goal2),
                "up": keep(up, up1, up3), "down": keep(down, down1, down3)}


# ------------------------------------------------------------ key draws
def draw_starts(keys, initial_step, max_start):
    """A start in ``[initial_step, max_start)`` from each key ``(N, 2)``:
    the int32 draw of ``fold_in(key, START_SALT)``."""
    return threefry.randint32(threefry.fold_in(keys, START_SALT), initial_step, max_start)


def next_keys(keys):
    """The key a step carries on: the first of the key's split."""
    return threefry.split(keys)[..., 0, :]
