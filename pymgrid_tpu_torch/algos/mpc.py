"""Model predictive control.

Mirrors the reference MPC (``src/pymgrid/algos/mpc/mpc.py:55-1031``) for the
modular path: the same decision variables, constraint matrices, and cost
vector, solved with scipy's HiGHS (LP without a genset; MILP with the genset
on/off boolean) instead of cvxpy/MOSEK — neither is in this stack.

Per step ``t`` of the horizon the decision block is (genset case)
``[p_genset, grid_import, grid_export, battery_charge, battery_discharge,
pv_curtail, loss_load, soc]`` (7 variables without a genset, dropping
``p_genset``), with

* power balance: genset + import - export - charge + discharge - curtail
  + loss_load = load - pv                          (``mpc.py:297-322``)
* SOC recursion: soc_t = soc_{t-1} + eta*charge/C - discharge/(eta*C)
                                                    (``mpc.py:261-294``)
* bounds incl. time-varying ``p_max_import * grid_status``, pv, load
                                                    (``mpc.py:330-358,455-481``)
* objective: fuel+CO2 on genset, import price + CO2 on imports, export price
  on exports (a cost, as in the reference), cycle costs on charge/discharge,
  loss-load cost                                    (``mpc.py:360-374,483-489``)

Supports at most one of each module type and requires load+renewable+battery
and grid or genset, as the reference does (``mpc.py:69-72``).
"""
import numpy as np

__all__ = ["ModelPredictiveControl"]

# per-step variable indices (genset case); without a genset subtract 1 from
# all but drop P_GENSET
_P_GENSET, _IMPORT, _EXPORT, _CHARGE, _DISCHARGE, _CURTAIL, _LOSS_LOAD, _SOC = range(8)


class ModelPredictiveControl:
    def __init__(self, microgrid, solver=None, tight_battery_bounds=False,
                 tie_break_eps=1e-6):
        """``tight_battery_bounds``: the reference MPC bounds the *external*
        battery flows by ``max_charge``/``max_discharge``, but the modular
        simulator applies those limits to the *internal* flows (external
        discharge caps at ``max_discharge*efficiency``), so planned discharges
        get clipped and show up as loss load.  Setting this True tightens the
        model to the simulator's true bounds (a documented improvement over
        the reference's default, which is kept for parity).

        ``tie_break_eps``: magnitude of the deterministic activity penalties
        added to the cost vector so degenerate problems pick one optimal
        vertex regardless of solver.  Pass 0 to hand the solver the raw
        (tie-laden) costs — the reference's formulation — e.g. for
        vertex-level parity runs against the in-process reference MPC."""
        self.microgrid = microgrid
        self.is_modular = hasattr(microgrid, "modules")
        self.tight_battery_bounds = tight_battery_bounds
        self.tie_break_eps = tie_break_eps
        self.microgrid_module_names = (
            self._get_modules(microgrid) if self.is_modular else {}
        )
        if self.is_modular:
            self._verify_microgrid()
        self.horizon = self._get_horizon()
        self._passed_solver = solver

        (
            self.eta,
            self.battery_capacity,
            self.fuel_cost,
            self.cost_battery_cycle,
            self.cost_loss_load,
            self.p_genset_min,
            self.p_genset_max,
            self.cost_co2,
            self.genset_co2,
        ) = self._parse_microgrid()

        self._build_problem()

    # ------------------------------------------------------------------ setup
    @property
    def has_genset(self):
        if self.is_modular:
            return "genset" in self.microgrid_module_names
        return self.microgrid.architecture["genset"] == 1

    def _get_modules(self, microgrid):
        def strip(s, suffix="Module"):
            return s[: -len(suffix)] if s.endswith(suffix) else s

        return {
            strip(module_list.item().__class__.__name__).lower(): name
            for name, module_list in microgrid.modules.iterdict()
        }

    def _verify_microgrid(self):
        names = self.microgrid_module_names
        required = {"load", "renewable", "battery", "unbalancedenergy"}
        missing = required - set(names)
        if missing:
            raise ValueError(f"MPC requires modules {sorted(missing)}.")
        if "grid" not in names and "genset" not in names:
            raise ValueError("MPC requires a grid or a genset (or both).")
        for name, container_name in names.items():
            if len(self.microgrid.modules[container_name]) > 1:
                raise ValueError(f"MPC supports at most one {name} module.")

    def _get_horizon(self):
        if not self.is_modular:
            return self.microgrid.horizon
        horizon = self.microgrid.get_forecast_horizon() + 1
        if horizon == 0:
            raise ValueError(
                "Microgrid has horizon=0. Do your timeseries modules have a forecaster?"
            )
        return horizon

    def _parse_microgrid(self):
        if self.is_modular:
            return self._parse_modular_microgrid()
        return self._parse_nonmodular_microgrid()

    def _parse_nonmodular_microgrid(self):
        parameters = self.microgrid.parameters

        eta = parameters["battery_efficiency"].values[0]
        battery_capacity = parameters["battery_capacity"].values[0]
        fuel_cost = (
            parameters["fuel_cost"].values[0]
            if self.microgrid.architecture["genset"] == 1
            else 0
        )
        cost_battery_cycle = parameters["battery_cost_cycle"].values[0]
        cost_loss_load = parameters["cost_loss_load"].values[0]
        cost_co2 = parameters["cost_co2"].values[0]

        if self.has_genset:
            p_genset_min = (
                parameters["genset_pmin"].values[0]
                * parameters["genset_rated_power"].values[0]
            )
            p_genset_max = (
                parameters["genset_pmax"].values[0]
                * parameters["genset_rated_power"].values[0]
            )
            genset_co2 = parameters["genset_co2"].values[0]
        else:
            p_genset_min, p_genset_max, genset_co2 = 0, 0, 0

        return (
            eta, battery_capacity, fuel_cost, cost_battery_cycle, cost_loss_load,
            p_genset_min, p_genset_max, cost_co2, genset_co2,
        )

    def _parse_modular_microgrid(self):
        names = self.microgrid_module_names
        battery = self.microgrid.modules[names["battery"]].item()

        eta = battery.efficiency
        battery_capacity = battery.max_capacity
        cost_battery_cycle = battery.battery_cost_cycle
        cost_loss_load = (
            self.microgrid.modules[names["unbalancedenergy"]].item().loss_load_cost
        )

        if self.has_genset:
            genset = self.microgrid.modules[names["genset"]].item()
            fuel_cost = genset.genset_cost
            p_genset_min = genset.running_min_production
            p_genset_max = genset.running_max_production
            cost_co2 = genset.cost_per_unit_co2
            genset_co2 = genset.co2_per_unit
        else:
            fuel_cost = p_genset_min = p_genset_max = cost_co2 = genset_co2 = 0

        return (
            eta,
            battery_capacity,
            fuel_cost,
            cost_battery_cycle,
            cost_loss_load,
            p_genset_min,
            p_genset_max,
            cost_co2,
            genset_co2,
        )

    def _build_problem(self):
        """Assemble the static equality/inequality matrices (sparse)."""
        from scipy.sparse import lil_matrix

        H = self.horizon
        nb = 8 if self.has_genset else 7  # block width
        self._block = nb
        n_vars = nb * H
        eta, cap = self.eta, self.battery_capacity
        charge_i = _CHARGE if self.has_genset else _CHARGE - 1
        discharge_i = _DISCHARGE if self.has_genset else _DISCHARGE - 1
        soc_i = _SOC if self.has_genset else _SOC - 1
        curtail_i = _CURTAIL if self.has_genset else _CURTAIL - 1
        loss_i = _LOSS_LOAD if self.has_genset else _LOSS_LOAD - 1
        import_i = _IMPORT if self.has_genset else _IMPORT - 1
        export_i = _EXPORT if self.has_genset else _EXPORT - 1
        self._idx = dict(
            charge=charge_i, discharge=discharge_i, soc=soc_i, curtail=curtail_i,
            loss=loss_i, imp=import_i, exp=export_i,
        )

        # equality: [power balance (H); soc recursion (H)]
        A = lil_matrix((2 * H, n_vars))
        for j in range(H):
            base = j * nb
            if self.has_genset:
                A[j, base + _P_GENSET] = 1
            A[j, base + import_i] = 1
            A[j, base + export_i] = -1
            A[j, base + charge_i] = -1
            A[j, base + discharge_i] = 1
            A[j, base + curtail_i] = -1
            A[j, base + loss_i] = 1
        for j in range(H):
            base = j * nb
            A[H + j, base + charge_i] = -1.0 * eta / cap
            A[H + j, base + discharge_i] = 1.0 / (eta * cap)
            A[H + j, base + soc_i] = 1
            if j > 0:
                A[H + j, (j - 1) * nb + soc_i] = -1
        self._A_eq = A.tocsr()

        # inequality blocks per step; rhs set each solve
        rows_per_step = 9 if self.has_genset else 8
        C = lil_matrix((rows_per_step * H, n_vars))
        for j in range(H):
            r, base = j * rows_per_step, j * nb
            k = 0
            if self.has_genset:
                C[r + k, base + _P_GENSET] = 1
                k += 1
            C[r + k, base + soc_i] = 1
            C[r + k + 1, base + soc_i] = -1
            C[r + k + 2, base + charge_i] = 1
            C[r + k + 3, base + discharge_i] = 1
            C[r + k + 4, base + import_i] = 1
            C[r + k + 5, base + export_i] = 1
            C[r + k + 6, base + curtail_i] = 1
            C[r + k + 7, base + loss_i] = 1
        self._C_ub = C.tocsr()
        self._rows_per_step = rows_per_step

        # static part of the cost vector
        if self.has_genset:
            cost_block = np.array(
                [
                    self.fuel_cost + self.cost_co2 * self.genset_co2,
                    0, 0,
                    self.cost_battery_cycle, self.cost_battery_cycle,
                    0, self.cost_loss_load, 0,
                ]
            )
        else:
            cost_block = np.array(
                [
                    0, 0,
                    self.cost_battery_cycle, self.cost_battery_cycle,
                    0, self.cost_loss_load, 0,
                ]
            )
        # Deterministic tie-breaking: the problem is frequently degenerate
        # (e.g. zero cycle cost makes battery moves free), and different LP
        # solvers pick different optimal vertices.  An infinitesimal activity
        # penalty prefers serving load with renewables first, then battery —
        # the vertex the reference's solvers select in its test suite.
        eps = self.tie_break_eps
        cost_block = cost_block.astype(float).copy()
        cost_block[charge_i] += eps
        cost_block[discharge_i] += eps
        cost_block[curtail_i] += 2 * eps

        self._costs = np.concatenate([cost_block] * H)

    # ------------------------------------------------------------------ solve
    def _set_parameters(
        self, load_vector, pv_vector, grid_vector, import_price, export_price,
        e_max, e_min, p_max_charge, p_max_discharge, p_max_import, p_max_export,
        soc_0, p_genset_max, cost_co2, grid_co2, genset_co2,
    ):
        H = self.horizon
        nb = self._block

        b_eq = np.zeros(2 * H)
        b_eq[:H] = load_vector - pv_vector
        b_eq[H] = soc_0
        self._b_eq = b_eq

        rps = self._rows_per_step
        if self.has_genset:
            block = np.array(
                [p_genset_max, e_max, -e_min, p_max_charge, p_max_discharge,
                 np.nan, np.nan, np.nan, np.nan]
            )
        else:
            block = np.array(
                [e_max, -e_min, p_max_charge, p_max_discharge,
                 np.nan, np.nan, np.nan, np.nan]
            )
        b_ub = np.concatenate([block] * H)
        off = rps - 4
        b_ub[off :: rps] = p_max_import * grid_vector
        b_ub[off + 1 :: rps] = p_max_export * grid_vector
        b_ub[off + 2 :: rps] = pv_vector
        b_ub[off + 3 :: rps] = load_vector
        assert not np.isnan(b_ub).any()
        self._b_ub = b_ub

        costs = self._costs.copy()
        imp_i, exp_i = self._idx["imp"], self._idx["exp"]
        costs[imp_i::nb] = np.asarray(import_price).reshape(-1) + np.asarray(
            grid_co2
        ).reshape(-1) * cost_co2
        costs[exp_i::nb] = np.asarray(export_price).reshape(-1)
        self._c = costs

    def _solve(self):
        """Solve the LP (or genset MILP) with HiGHS; returns p_vars, u_genset."""
        from scipy import sparse
        from scipy.optimize import linprog, milp, LinearConstraint, Bounds

        H = self.horizon
        nb = self._block
        n_p = nb * H

        if not self.has_genset:
            res = linprog(
                self._c, A_ub=self._C_ub, b_ub=self._b_ub,
                A_eq=self._A_eq, b_eq=self._b_eq,
                bounds=(0, None), method="highs",
            )
            if not res.success:
                from warnings import warn

                warn(f"Infeasible problem ({res.message})")
                return None, None
            # clamp solver tolerance noise below the variable bounds
            return np.maximum(res.x, 0.0), None

        # MILP: append boolean u (H,) with p_min*u <= p_genset <= p_max*u
        n = n_p + H
        c = np.concatenate([self._c, np.zeros(H)])

        A_eq = sparse.hstack([self._A_eq, sparse.csr_matrix((2 * H, H))])
        C_ub = sparse.hstack([self._C_ub, sparse.csr_matrix((self._C_ub.shape[0], H))])

        link = sparse.lil_matrix((2 * H, n))
        for j in range(H):
            p_col = j * nb + _P_GENSET
            u_col = n_p + j
            link[j, p_col] = 1            # p - p_max*u <= 0
            link[j, u_col] = -self.p_genset_max
            link[H + j, p_col] = -1       # p_min*u - p <= 0
            link[H + j, u_col] = self.p_genset_min

        constraints = [
            LinearConstraint(A_eq, self._b_eq, self._b_eq),
            LinearConstraint(C_ub, -np.inf, self._b_ub),
            LinearConstraint(link.tocsr(), -np.inf, np.zeros(2 * H)),
        ]
        integrality = np.concatenate([np.zeros(n_p), np.ones(H)])
        ub = np.concatenate([np.full(n_p, np.inf), np.ones(H)])
        res = milp(
            c=c,
            constraints=constraints,
            integrality=integrality,
            bounds=Bounds(lb=np.zeros(n), ub=ub),
        )
        if not res.success:
            from warnings import warn

            warn(f"Infeasible problem ({res.message})")
            return None, None
        x = np.maximum(res.x, 0.0)
        return x[:n_p], x[n_p:]

    def _set_and_solve(self, *state_values, iteration=None, total_iterations=None,
                       return_steps=0, verbose=False):
        self._set_parameters(*state_values)
        p_vars, u_genset = self._solve()
        if p_vars is None:
            return None
        if self.is_modular:
            return self._extract_modular_control(p_vars, u_genset, verbose)
        load_vector, pv_vector = state_values[0], state_values[1]
        return self._extract_control_dict(return_steps, pv_vector, load_vector, p_vars)

    def _extract_control_dict(self, return_steps, pv_vector, load_vector, p_vars):
        """Legacy control dict(s) for the nonmodular path
        (reference ``mpc.py:799-864``)."""
        nb = self._block

        def block_dict(j):
            base = j * nb
            d = {
                "battery_charge": p_vars[base + self._idx["charge"]],
                "battery_discharge": p_vars[base + self._idx["discharge"]],
                "grid_import": p_vars[base + self._idx["imp"]],
                "grid_export": p_vars[base + self._idx["exp"]],
                "loss_load": p_vars[base + self._idx["loss"]],
                "pv_consummed": pv_vector[j] - p_vars[base + self._idx["curtail"]],
                "pv_curtailed": p_vars[base + self._idx["curtail"]],
                "load": load_vector[j],
                "pv": pv_vector[j],
            }
            if self.has_genset:
                d["genset"] = p_vars[base + _P_GENSET]
            return d

        if return_steps == 0:
            return block_dict(0)
        if return_steps > self.horizon:
            raise ValueError("return_steps cannot be greater than horizon")
        return [block_dict(j) for j in range(return_steps)]

    def _extract_modular_control(self, p_vars, u_genset, verbose=False):
        control = dict()
        control_vals = list(p_vars[: self._block])

        if self.has_genset:
            genset = control_vals.pop(0)
            genset_status = float(np.round(u_genset[0]))
            control[self.microgrid_module_names["genset"]] = [
                np.array([genset_status, genset])
            ]

        battery_charge, battery_discharge = control_vals[2:4]
        battery_diff = battery_discharge - battery_charge
        grid_import, grid_export = control_vals[0:2]
        grid_diff = grid_import - grid_export

        if verbose:
            from warnings import warn

            if battery_charge > 0 and battery_discharge > 0 and not np.isclose(
                [battery_charge, battery_discharge], 0, atol=1e-4
            ).any():
                warn(
                    f"battery_charge={battery_charge} and battery_discharge="
                    f"{battery_discharge} are both nonzero. Flattening to the difference."
                )
            if grid_import > 0 and grid_export > 0 and not np.isclose(
                [grid_import, grid_export], 0, atol=1e-4
            ).any():
                warn(
                    f"grid_import={grid_import} and grid_export={grid_export} are "
                    f"both nonzero. Flattening to the difference."
                )

        if "grid" in self.microgrid_module_names:
            control[self.microgrid_module_names["grid"]] = grid_diff
        control[self.microgrid_module_names["battery"]] = battery_diff
        return control

    def _get_modular_state_values(self):
        names = self.microgrid_module_names
        load_state = -1.0 * self.microgrid.modules[names["load"]].item().state
        pv_state = self.microgrid.modules[names["renewable"]].item().state

        if "grid" in names:
            grid = self.microgrid.modules[names["grid"]].item()
            grid_status = np.ones(self.horizon)
            price_import = grid.import_price
            price_export = grid.export_price
            grid_co2_per_kwh = grid.co2_per_kwh
            cost_co2 = [grid.cost_per_unit_co2]
            grid_max_import, grid_max_export = grid.max_import, grid.max_export
        else:
            grid_status = np.zeros(self.horizon)
            price_import = np.zeros(self.horizon)
            price_export = np.zeros(self.horizon)
            grid_co2_per_kwh = np.zeros(self.horizon)
            cost_co2 = []
            grid_max_import, grid_max_export = 0, 0

        battery = self.microgrid.modules[names["battery"]].item()
        e_min, e_max = battery.min_soc, battery.max_soc
        if self.tight_battery_bounds:
            # the simulator's true external bounds (see __init__ docstring)
            battery_max_charge = battery.max_charge / battery.efficiency
            battery_max_discharge = battery.max_discharge * battery.efficiency
        else:
            battery_max_charge = battery.max_charge
            battery_max_discharge = battery.max_discharge
        soc_0 = battery.soc

        if "genset" in names:
            genset = self.microgrid.modules[names["genset"]].item()
            genset_max_prod = genset.running_max_production
            genset_co2_per_kwh = genset.co2_per_unit
            cost_co2.append(genset.cost_per_unit_co2)
        else:
            genset_max_prod, genset_co2_per_kwh = None, None

        cost_co2 = np.mean(cost_co2)

        return (
            load_state, pv_state, grid_status, price_import, price_export,
            e_max, e_min, battery_max_charge, battery_max_discharge,
            grid_max_import, grid_max_export, soc_0, genset_max_prod,
            cost_co2, grid_co2_per_kwh, genset_co2_per_kwh,
        )

    # -------------------------------------------------------------------- run
    def _get_num_iter(self, forecast_steps=None):
        if forecast_steps is not None:
            assert forecast_steps <= len(self.microgrid), (
                "forecast steps cannot be longer than data length."
            )
            return forecast_steps
        if not self.is_modular:
            return len(self.microgrid) - self.horizon
        return self.microgrid.final_step - self.microgrid.initial_step

    def run(self, max_steps=None, verbose=False):
        """Run receding-horizon MPC.

        Modular path: steps the microgrid and returns its log DataFrame.
        Nonmodular path: returns a legacy :class:`ControlOutput`.
        """
        if not self.is_modular:
            return self._run_mpc_on_nonmodular(forecast_steps=max_steps, verbose=verbose)
        num_iter = self._get_num_iter(max_steps)
        self.microgrid.reset()

        iterator = range(num_iter)
        if verbose:
            try:
                from tqdm import tqdm

                iterator = tqdm(iterator, desc="MPC Progress")
            except ImportError:
                pass

        previous_control = None
        for i in iterator:
            control = self._set_and_solve(
                *self._get_modular_state_values(),
                iteration=i,
                total_iterations=num_iter,
                verbose=verbose and verbose > 1,
            )
            if control is None:
                # solver failure: degrade gracefully by replaying the last
                # successful plan (reference mpc.py:647-661)
                if previous_control is None:
                    raise RuntimeError(
                        "MPC solve failed on the first step; no previous "
                        "controls to fall back to."
                    )
                print("Using previous controls")
                control = previous_control
            else:
                previous_control = control
            _, _, done, _ = self.microgrid.run(control, normalized=False)
            if done:
                break

        return self.microgrid.get_log()

    # ------------------------------------------------------ nonmodular (legacy)
    def _nonmodular_state_values(self, sample, soc_0, current_step):
        """State vectors for one legacy MPC solve (reference
        ``mpc.py:605-645,987-1025``)."""
        horizon = self.horizon
        mg = self.microgrid
        i = current_step

        if mg.architecture["grid"] == 0:
            temp_grid = np.zeros(horizon)
            price_import = np.zeros(horizon)
            price_export = np.zeros(horizon)
            grid_co2 = np.zeros(horizon)
            p_max_import, p_max_export = 0, 0
        else:
            temp_grid = sample.loc[i : i + horizon - 1, "grid"].values
            price_import = mg._grid_price_import.iloc[i : i + horizon].values
            price_export = mg._grid_price_export.iloc[i : i + horizon].values
            grid_co2 = mg._grid_co2.iloc[i : i + horizon].values
            p_max_import = mg.parameters["grid_power_import"].values[0]
            p_max_export = mg.parameters["grid_power_export"].values[0]

        e_min = mg.parameters["battery_soc_min"].values[0]
        e_max = mg.parameters["battery_soc_max"].values[0]
        p_max_charge = mg.parameters["battery_power_charge"].values[0]
        p_max_discharge = mg.parameters["battery_power_discharge"].values[0]
        cost_co2 = mg.parameters["cost_co2"].values[0]

        if self.has_genset:
            p_genset_max = (
                mg.parameters["genset_pmax"].values[0]
                * mg.parameters["genset_rated_power"].values[0]
            )
            genset_co2 = mg.parameters["genset_co2"].values[0]
        else:
            p_genset_max, genset_co2 = None, 0

        return (
            sample.loc[i : i + horizon - 1, "load"].values,
            sample.loc[i : i + horizon - 1, "pv"].values,
            temp_grid, price_import, price_export,
            e_max, e_min, p_max_charge, p_max_discharge,
            p_max_import, p_max_export, soc_0, p_genset_max,
            cost_co2, grid_co2, genset_co2,
        )

    def _run_mpc_on_nonmodular(self, forecast_steps=None, verbose=False):
        from pymgrid_tpu_torch.utils.data_generator import return_underlying_data

        sample = return_underlying_data(self.microgrid).reset_index(drop=True)
        return self._run_mpc_on_sample(
            sample, forecast_steps=forecast_steps, verbose=verbose
        )

    def _run_mpc_on_sample(self, sample, forecast_steps=None, verbose=False):
        """Full legacy MPC benchmark over a (pv, load, grid) sample;
        returns a :class:`~pymgrid_tpu_torch.algos.control.ControlOutput`."""
        import pandas as pd
        from copy import deepcopy
        from pymgrid_tpu_torch.algos.control import ControlOutput

        if not isinstance(sample, pd.DataFrame):
            raise TypeError(f"sample must be of type pd.DataFrame, is {type(sample)}")

        sample = sample.iloc[: self.microgrid._data_length]
        mg = self.microgrid
        mg.reset()
        action = deepcopy(mg._df_record_control_dict)
        status = deepcopy(mg._df_record_state)
        production = deepcopy(mg._df_record_actual_production)
        cost = deepcopy(mg._df_record_cost)
        co2 = deepcopy(mg._df_record_co2)

        T = len(sample)
        horizon = self.horizon
        num_iter = (
            T - horizon if forecast_steps is None else forecast_steps
        )
        if forecast_steps is not None:
            assert forecast_steps <= T - horizon, "forecast steps can't look past horizon"

        old_control_dict = None
        iterator = range(num_iter)
        if verbose:
            try:
                from tqdm import tqdm

                iterator = tqdm(iterator, desc="MPC Progress")
            except ImportError:
                pass

        for i in iterator:
            soc_0 = status["battery_soc"][-1]
            control_dict = self._set_and_solve(
                *self._nonmodular_state_values(sample, soc_0, i),
                iteration=i, total_iterations=num_iter,
            )

            if control_dict is not None:
                action = mg._record_action(control_dict, action)
                production = mg._record_production(control_dict, production, status)
                old_control_dict = control_dict.copy()
            elif old_control_dict is not None:
                print("Using previous controls")
                action = mg._record_action(old_control_dict, action)
                production = mg._record_production(old_control_dict, production, status)
            else:
                raise RuntimeError(
                    "Fell through, was unable to solve for control_dict and could "
                    "not find previous control dict"
                )

            last_prod = {k: production[k][-1] for k in production}
            if mg.architecture["grid"] == 1:
                co2 = mg._record_co2(last_prod, co2, mg._grid_co2.iloc[i].values[0])
                status = mg._update_status(
                    last_prod, status,
                    sample.at[i + 1, "load"], sample.at[i + 1, "pv"],
                    sample.at[i + 1, "grid"],
                    mg._grid_price_import.iloc[i + 1].values[0],
                    mg._grid_price_export.iloc[i + 1].values[0],
                    mg._grid_co2.iloc[i + 1].values[0],
                )
                cost = mg._record_cost(
                    last_prod, cost, co2,
                    mg._grid_price_import.iloc[i, 0], mg._grid_price_export.iloc[i, 0],
                )
            else:
                co2 = mg._record_co2(last_prod, co2)
                status = mg._update_status(
                    last_prod, status, sample.at[i + 1, "load"], sample.at[i + 1, "pv"]
                )
                cost = mg._record_cost(last_prod, cost, co2)

        names = ("action", "status", "production", "cost", "co2")
        dfs = (action, status, production, cost, co2)
        return ControlOutput(names, dfs, "mpc")

    def mpc_single_step(self, sample, previous_output, current_step):
        """One legacy MPC solve over the horizon; returns a
        :class:`~pymgrid_tpu_torch.algos.control.HorizonOutput` (used by SAA)."""
        from pymgrid_tpu_torch.algos.control import ControlOutput, HorizonOutput

        if not isinstance(previous_output, ControlOutput):
            raise TypeError("previous_output must be ControlOutput, unless first_step is True")

        soc_0 = previous_output["status"]["battery_soc"][-1]
        control_dicts = self._set_and_solve(
            *self._nonmodular_state_values(sample, soc_0, current_step),
            iteration=current_step,
            return_steps=self.horizon,
        )
        if control_dicts is None or any(d is None for d in control_dicts):
            raise TypeError("A control_dict is None")
        return HorizonOutput(control_dicts, self.microgrid, current_step)
