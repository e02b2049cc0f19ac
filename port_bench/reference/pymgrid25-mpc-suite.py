"""Plain reference of the configuration ``pymgrid25-mpc-suite``: the
pymgrid25 microgrids under pymgrid's receding-horizon MPC.

It imports nothing of the program under test.  Two things are worked out
here for the benchmark's check:

* :func:`restep` steps the microgrids (``reference/pymgrid25.py``'s
  :class:`Microgrids` on the suite's superset layout) on the controls the
  program executed, from each episode's start, and returns every hour's
  reward, energies and battery charge;
* :func:`decision_gap` judges one decision of the program: pymgrid's
  horizon problem from the program's state at that hour, solved exactly
  (``J*``), and solved again with the first hour's controls fixed to the
  ones the program executed (``J_fix``).

The horizon problem is pymgrid's modular MPC as upstream states it
(``src/pymgrid/algos/mpc/mpc.py``: variables 261-374, the modular state
values 455-489, the always-up grid of the plan 914).  Per hour ``j`` of the
horizon ``H`` it has the variables genset production ``p``, grid import and
export, battery charge and discharge, curtailed renewable, lost load and the
state of charge after the hour, all at least 0, and with a genset its on/off
``u_j``, a binary:

* balance: ``p + import - export - charge + discharge - curtail + loss =
  load - pv``;
* state of charge: ``soc_j = soc_{j-1} + eta * charge / C - discharge /
  (eta * C)``, from the battery's charge now over its capacity ``C``;
* bounds: ``min_soc <= soc <= max_soc``, charge and discharge up to the
  battery's ``max_charge`` and ``max_discharge``, import and export up to
  the grid's caps (the plan takes the grid as always up), curtailment up to
  the renewable, lost load up to the load, ``p_min * u <= p <= p_max * u``;
* cost: the genset's fuel plus its CO2 at its own CO2 price, the import
  price plus the grid's CO2 at the mean CO2 price of the grid and the
  genset, the export price (a cost, as upstream has it), the battery's cycle
  cost on charge and discharge, the lost load's cost.

A module that moves no energy (the superset's neutral grid or genset) is
absent from the problem.  The data are assembled in PyTorch in ``dtype``
(float64 for the reference; the control rounds them to its lower
precision).  An LP optimum has no closed form in plain PyTorch: the problem
is solved by HiGHS (``scipy.optimize.milp``; without a genset it has no
integer and is an LP), an exact solver independent of the program.  That is the one
departure from plain PyTorch.
"""
import contextlib
import ctypes
import os
import sys

import numpy as np
import torch
from scipy.optimize import Bounds, LinearConstraint, milp

from port_bench.reference.pymgrid25 import Configs, Microgrids

OBS_ORDER = ("load", "renewable", "genset", "battery", "grid")
# per-hour variables of the horizon problem
P, IMP, EXP, CH, DIS, CURT, LOSS, SOC = range(8)
BLOCK = 8
# the columns of an executed hour: battery, grid, genset production, genset on/off
BATTERY, GRID, GENSET_P, GENSET_U = range(4)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(config):
    """The constants of the configuration's scenarios on the superset layout."""
    return Configs(os.path.join(ROOT, config["data_dir"]), config["scenarios"], superset=True)


# --------------------------------------------------------------- re-step
def restep(configs, episodes, dtype=torch.float64):
    """Step every scenario of ``configs`` on the executed controls.

    ``episodes`` is a list of ``(starts, controls)``: ``starts (S,)`` the
    episode's first step per scenario (the battery at its initial charge
    there), ``controls (T, S, 4)`` every hour's executed battery, grid,
    genset production and genset on/off.  Returns one dict per episode with
    ``reward``, ``provided``, ``absorbed`` and ``charge`` (after the hour),
    each ``(T, S)`` float64."""
    out = []
    for starts, controls in episodes:
        mg = Microgrids(configs, np.arange(configs.n_configs), dtype, OBS_ORDER)
        state = mg.reset(torch.as_tensor(np.asarray(starts)))
        controls = torch.as_tensor(np.asarray(controls, dtype=np.float64)).to(dtype)
        rows = []
        for hour in controls:
            action = {"battery": hour[:, BATTERY], "grid": hour[:, GRID],
                      "genset": hour[:, GENSET_P], "genset_goal": hour[:, GENSET_U]}
            state, o = mg.step(state, action)
            rows.append(torch.stack([o["reward"], o["provided"], o["absorbed"],
                                     state["charge"]]).double())
        found = torch.stack(rows)                                  # (T, 4, S)
        out.append({k: found[:, i] for i, k in
                    enumerate(("reward", "provided", "absorbed", "charge"))})
    return out


# -------------------------------------------------------- horizon problem
@contextlib.contextmanager
def _stdout_to_null():
    """The process's standard output sent to the null device: some builds of
    HiGHS write MIP diagnostics there whatever their options, and a run
    prints its result as the last line there."""
    sys.stdout.flush()
    saved, null = os.dup(1), os.open(os.devnull, os.O_WRONLY)
    os.dup2(null, 1)
    try:
        yield
    finally:
        ctypes.CDLL(None).fflush(None)      # what C's stdio still holds goes too
        os.dup2(saved, 1)
        os.close(saved)
        os.close(null)


def _present(params):
    """Whether the grid and the genset move energy (a neutral one does not)."""
    grid = float(params["grid"]["max_import"]) + float(params["grid"]["max_export"]) > 0
    genset = float(params["genset"]["running_max_production"]) > 0
    return grid, genset


class Horizon:
    """Scenario ``n``'s horizon problem from step ``t`` with the battery at
    ``charge``, its data in ``dtype``; :meth:`solve` gives its optimum."""

    def __init__(self, configs, n, t, charge, horizon, dtype=torch.float64):
        H = self.H = horizon
        p = configs.params[n]
        self.has_grid, self.has_genset = _present(p)
        rows = slice(t, t + H)
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)  # noqa: E731
        load = -as_t(configs.ts["load"][n]["ts"][rows, 0])
        pv = as_t(configs.ts["renewable"][n]["ts"][rows, 0])
        if len(load) != H:
            raise ValueError(f"the horizon from step {t} leaves the series")
        bat, gen, grid = p["battery"], p["genset"], p["grid"]
        cap = as_t(bat["max_capacity"])
        eta = as_t(bat["efficiency"])
        co2_prices = ([float(grid["cost_per_unit_co2"])] if self.has_grid else []) + (
            [float(gen["cost_per_unit_co2"])] if self.has_genset else [])
        zeros = torch.zeros(H, dtype=dtype)
        if self.has_grid:
            g = configs.ts["grid"][n]["ts"][rows]
            imp_cost = as_t(g[:, 0]) + as_t(g[:, 2]) * as_t(np.mean(co2_prices))
            exp_cost = as_t(g[:, 1])
            imp_cap, exp_cap = as_t(grid["max_import"]), as_t(grid["max_export"])
        else:
            imp_cost = exp_cost = zeros
            imp_cap = exp_cap = as_t(0.0)
        if self.has_genset:
            gen_cost = as_t(float(gen["genset_cost"])
                            + float(gen["cost_per_unit_co2"]) * float(gen["co2_per_unit"]))
            p_min = as_t(gen["running_min_production"])
            p_max = as_t(gen["running_max_production"])
        else:
            gen_cost, p_min, p_max = as_t(0.0), as_t(0.0), as_t(0.0)
        cycle = as_t(bat.get("battery_cost_cycle", 0.0))
        loss_cost = as_t(p["balancing"]["loss_load_cost"])

        n_vars = BLOCK * H + (H if self.has_genset else 0)
        c = torch.zeros(n_vars, dtype=dtype)
        lo = torch.zeros(n_vars, dtype=dtype)
        hi = torch.full((n_vars,), float("inf"), dtype=dtype)
        A = torch.zeros(2 * H, n_vars, dtype=dtype)
        b = torch.zeros(2 * H, dtype=dtype)
        for j in range(H):
            v = j * BLOCK
            c[v + P], c[v + IMP], c[v + EXP] = gen_cost, imp_cost[j], exp_cost[j]
            c[v + CH], c[v + DIS], c[v + LOSS] = cycle, cycle, loss_cost
            hi[v + P] = p_max
            hi[v + IMP], hi[v + EXP] = imp_cap, exp_cap
            hi[v + CH], hi[v + DIS] = as_t(bat["max_charge"]), as_t(bat["max_discharge"])
            hi[v + CURT], hi[v + LOSS] = pv[j], load[j]
            lo[v + SOC] = as_t(bat["min_capacity"]) / cap
            hi[v + SOC] = cap / cap
            # balance
            for k, sign in ((P, 1), (IMP, 1), (EXP, -1), (CH, -1), (DIS, 1), (CURT, -1),
                            (LOSS, 1)):
                A[j, v + k] = sign
            b[j] = load[j] - pv[j]
            # state of charge
            A[H + j, v + SOC] = 1
            A[H + j, v + CH] = -eta / cap
            A[H + j, v + DIS] = 1 / (eta * cap)
            if j:
                A[H + j, v - BLOCK + SOC] = -1
        b[H] = as_t(charge) / cap
        link = None
        if self.has_genset:
            u0 = BLOCK * H
            hi[u0:] = 1
            link = torch.zeros(2 * H, n_vars, dtype=dtype)
            for j in range(H):
                link[j, j * BLOCK + P], link[j, u0 + j] = 1, -p_max          # p <= p_max u
                link[H + j, j * BLOCK + P], link[H + j, u0 + j] = -1, p_min  # p >= p_min u
        f64 = lambda x: x.double().numpy()  # noqa: E731
        self.c, self.A, self.b, self.lo, self.hi = map(f64, (c, A, b, lo, hi))
        self.link = None if link is None else f64(link)
        self.load = f64(load)
        self.soc_0 = float(b[H])
        self.eta, self.cap = float(eta), float(cap)
        self.p_min, self.p_max = float(p_min), float(p_max)
        # the dearest energy that can serve the load: import or genset
        self.unit_cost = max(([float(imp_cost.max())] if self.has_grid else [])
                             + ([float(gen_cost)] if self.has_genset else []))

    def solve(self, lo=None, hi=None, rows=None):
        """The optimum ``(J, x)`` within the bounds ``lo``/``hi`` (the
        problem's by default) and the extra rows ``rows`` (``(A, lb, ub)``:
        ``lb <= A x <= ub``); ``(inf, None)`` where it is infeasible.  HiGHS
        solves it as a MILP, or as an LP where the scenario has no genset."""
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        constraints = [LinearConstraint(self.A, self.b, self.b)]
        integrality = np.zeros(len(self.c))
        if self.link is not None:
            integrality[BLOCK * self.H:] = 1
            constraints.append(LinearConstraint(self.link, -np.inf, 0.0))
        if rows is not None:
            constraints.append(LinearConstraint(*rows))
        with _stdout_to_null():
            res = milp(self.c, integrality=integrality, bounds=Bounds(lo, hi),
                       constraints=constraints, options={"mip_rel_gap": 1e-9})
        return (float(res.fun), res.x) if res.status == 0 else (float("inf"), None)

    def first_hour(self, x):
        """The first hour's controls of a solution, as the program executes
        them: battery (discharge less charge), grid (import less export),
        genset production and on/off."""
        u = x[BLOCK * self.H] if self.has_genset else 0.0
        return np.array([x[DIS] - x[CH], x[IMP] - x[EXP], x[P], round(u)])

    def fixed(self, controls):
        """``J_fix``, the optimum with the first hour's controls fixed to
        ``controls`` (battery, grid, genset production, on/off) as the
        microgrid realizes them, the lost load and the curtailment left
        free; and the energy by which the controls had to be moved to fit
        the first hour's bounds.

        The problem bounds the battery's external discharge by
        ``max_discharge``, the microgrid by ``max_discharge * efficiency``
        (upstream's own mismatch): a discharge the microgrid clipped to its
        bound is realized alike by every discharge of the problem from that
        bound up, so such a battery is fixed to that range."""
        bat, grid, p, u = (float(v) for v in controls)
        u = float(round(u)) if self.has_genset else 0.0
        p_fit = min(max(p, self.p_min * u), self.p_max * u)
        d_max = min(self.hi[DIS], (self.soc_0 - self.lo[SOC]) * self.cap * self.eta)
        c_max = min(self.hi[CH], (self.hi[SOC] - self.soc_0) * self.cap / self.eta)
        bat_fit = min(max(bat, -max(c_max, 0.0)), max(d_max, 0.0))
        grid_fit = min(max(grid, -self.hi[EXP]), self.hi[IMP])
        moved = abs(p - p_fit) + abs(bat - bat_fit) + abs(grid - grid_fit)
        # the microgrid's own discharge bound (reference/pymgrid25.py)
        charge = self.soc_0 * self.cap
        realized_max = min(self.hi[DIS], charge - self.lo[SOC] * self.cap) * self.eta
        bat_hi = max(d_max, bat_fit) if bat >= realized_max * (1 - 1e-5) > 0 else bat_fit
        lo, hi = self.lo.copy(), self.hi.copy()
        # production beyond the load has nowhere to go in the problem: it is
        # curtailed, and counted as moved
        excess = max(p_fit + grid_fit + bat_fit - self.load[0], 0.0)
        moved += excess
        hi[CURT] += excess
        lo[P] = hi[P] = p_fit
        if self.has_genset:
            lo[BLOCK * self.H] = hi[BLOCK * self.H] = u
        rows = np.zeros((2, len(self.c)))
        rows[0, DIS], rows[0, CH] = 1, -1
        rows[1, IMP], rows[1, EXP] = 1, -1
        J, _ = self.solve(lo, hi, (rows, np.array([bat_fit, grid_fit]),
                                   np.array([bat_hi, grid_fit])))
        return J, moved


def decision_gap(configs, n, t, charge, controls, horizon, dtype=torch.float64):
    """How far the executed ``controls`` of scenario ``n`` at step ``t``
    (battery ``charge``) are from pymgrid's MPC decision: ``(|J_fix - J*| +
    moved * unit_cost) / (|J*| + load * unit_cost + 1)``, with ``load`` the
    horizon's load, ``unit_cost`` the dearest unit of energy that can serve
    it (import or genset) and ``moved`` the energy by which the controls had
    to be moved to fit the first hour's bounds.  The scale is the cost of
    the horizon's optimum plus that of serving its whole load from the
    dearest source: what a plan's decisions can move.

    With ``dtype`` below float64 the controls are the first hour of the
    optimum of the problem with its data in ``dtype`` (the control), and
    ``controls`` is not used."""
    exact = Horizon(configs, n, t, charge, horizon)
    J_star, _ = exact.solve()
    if dtype != torch.float64:
        _, x = Horizon(configs, n, t, charge, horizon, dtype).solve()
        if x is None:
            return float("inf")
        controls = exact.first_hour(x)
    J_fix, moved = exact.fixed(controls)
    scale = abs(J_star) + exact.load.sum() * exact.unit_cost + 1.0
    return float((abs(J_fix - J_star) + moved * exact.unit_cost) / scale)
