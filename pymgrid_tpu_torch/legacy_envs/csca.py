"""Continuous-state continuous-action legacy envs, with safe-exploration
variants.

Behavioral mirror of ``src/pymgrid/_deprecated/Environments/pymgrid_csca.py``:

* :class:`MicrogridEnv` — abstract base over a nonmodular microgrid with
  optional random sub-trajectories;
* :class:`ContinuousMicrogridEnv` — direct power set-point actions, with
  standardization constants pre-computed from an MPC run;
* :class:`ContinuousMicrogridSampleEnv` — resamples load/pv/grid from SAA
  forecasts on every reset;
* :class:`SafeExpMicrogridEnv` / :class:`SafeExpMicrogridSampleEnv` —
  expose constraint values (``c_i < 0`` form) for safety-layer RL.

Fixes relative to the reference (which cannot run as shipped):
``np.float`` removed, the genset-case standardization key tuple is an actual
tuple of keys rather than one comma-joined string
(reference pymgrid_csca.py:413), and the action-bound helper tolerates
gridless microgrids (reference reads ``grid_power_import`` unconditionally).
"""
from copy import deepcopy

import numpy as np

from pymgrid_tpu_torch.legacy_envs.preprocessing import sample_reset
from pymgrid_tpu_torch.legacy_envs.environment import generate_sampler
from pymgrid_tpu_torch.nonmodular import NonModularMicrogrid
from pymgrid_tpu_torch.utils.space import Box

# MPC steps used to estimate standardization constants
# (hard-coded to 1000 in the reference, pymgrid_csca.py:409).
STANDARDIZATION_MPC_STEPS = 1000

__all__ = [
    "MicrogridEnv",
    "ContinuousMicrogridEnv",
    "ContinuousMicrogridSampleEnv",
    "SafeExpMicrogridEnv",
    "SafeExpMicrogridSampleEnv",
]

# action/observation component names, by architecture
_ACTION_KEYS_GENSET = ("genset", "grid_import", "grid_export", "battery_charge",
                       "battery_discharge", "pv_consummed")
_ACTION_KEYS_PLAIN = _ACTION_KEYS_GENSET[1:]
_OBS_KEYS_GRID = ("load", "hour", "pv", "battery_soc", "capa_to_charge",
                  "capa_to_discharge", "grid_status", "grid_co2",
                  "grid_price_import", "grid_price_export")
_OBS_KEYS_PLAIN = _OBS_KEYS_GRID[:6]


class MicrogridEnv:
    """Gym-style MDP over a nonmodular microgrid (reference lines 55-171)."""

    metadata = {"render.modes": ["human"]}

    def __init__(self, microgrid, trajectory_len=None, max_episode_len=None):
        self.microgrid = self._resolve_microgrid(microgrid)

        assert self.microgrid._data_length == 8760, (
            f"Microgrid data length should be 8760, is {self.microgrid._data_length}"
        )

        self.has_grid = self.microgrid.architecture["grid"] == 1
        self.has_genset = self.microgrid.architecture["genset"] == 1

        observation_dim = len(self.microgrid._df_record_state)
        self.observation_space = Box(
            low=0, high=np.inf, shape=(observation_dim,), dtype=np.float64
        )
        self.action_space = None

        self.current_action = None
        self.current_obs = None

        # horizon doubles as the end-of-data margin in NonModularMicrogrid.run
        if max_episode_len is None:
            self.microgrid.horizon = 0
        else:
            self.microgrid.horizon = self.microgrid._data_length - max_episode_len

        self.trajectory_len = trajectory_len
        self._short_trajectory_set()

    @staticmethod
    def _resolve_microgrid(microgrid):
        if isinstance(microgrid, NonModularMicrogrid):
            return deepcopy(microgrid)
        if isinstance(microgrid, int) and 0 <= microgrid <= 25:
            from pymgrid_tpu_torch.generator import MicrogridGenerator

            print(
                f"Initializing microgrid {microgrid} of 25 using 25 microgrids "
                f"from MicrogridGenerator"
            )
            generator = MicrogridGenerator(nb_microgrid=25)
            generator.generate_microgrid(verbose=False, modular=False)
            return deepcopy(generator.microgrids[microgrid])
        raise ValueError(
            f"microgrid must be of type NonModularMicrogrid, is {type(microgrid)}"
        )

    def _short_trajectory_set(self):
        """Start a random fixed-length sub-trajectory (reference lines 101-110)."""
        if self.trajectory_len is None:
            return
        assert isinstance(self.trajectory_len, int)
        latest_start = (
            self.microgrid._data_length - self.microgrid.horizon - self.trajectory_len
        )
        start_index = np.random.randint(low=0, high=latest_start)
        self.microgrid._tracking_timestep = start_index
        self.microgrid._data_length = (
            start_index + self.trajectory_len + self.microgrid.horizon
        )

    def reset(self):
        self.microgrid.reset()
        self._short_trajectory_set()
        observations = np.array(list(self.microgrid.get_updated_values().values()))
        self.current_obs = observations
        return observations

    def step(self, action, **kwargs):
        observation = self.run_control(self.get_control_dict(action))
        reward = -1.0 * self.microgrid.get_cost()

        self.current_obs = observation
        self.current_action = action
        return observation, reward, self.microgrid.done, dict()

    def get_control_dict(self, action):
        return NotImplemented

    def run_control(self, control_dict):
        updated_vals = self.microgrid.run(control_dict)
        # dtype=float maps the microgrid's end-of-data None sentinels (it has
        # no lookahead past the final row) to nan on the terminal step; the
        # reference crashes in standardize() there instead.
        observations = np.array(list(updated_vals.values()), dtype=np.float64)
        assert len(observations) == self.observation_space.shape[0]
        return observations


class ContinuousMicrogridEnv(MicrogridEnv):
    """Continuous states, continuous actions (reference lines 174-484)."""

    def __init__(self, microgrid, standardization=True, trajectory_len=None,
                 max_episode_len=None, **kwargs):
        super().__init__(
            microgrid, trajectory_len=trajectory_len, max_episode_len=max_episode_len
        )
        self.logger = kwargs.get("logger")

        action_dim = 5 + self.has_genset
        upper_bound, lower_bound = self._get_action_ub_lb()
        self.action_space = Box(
            low=lower_bound, high=upper_bound, shape=(action_dim,), dtype=np.float64
        )

        self.standardization = standardization
        if not self.standardization:
            self.standardizations = None
            return

        self.standardizations = self.pre_compute_standardizations()
        self.action_space.low = self.standardize(
            self.action_space.low, use_proxy="action"
        )
        scaled_high = self.standardize(self.action_space.high, use_proxy="action")
        scaled_high[1] = 0.1  # reference's hard-coded grid_export bound (line 200)
        self.action_space.high = scaled_high

    @property
    def _action_keys(self):
        return _ACTION_KEYS_GENSET if self.has_genset else _ACTION_KEYS_PLAIN

    @property
    def _obs_keys(self):
        return _OBS_KEYS_GRID if self.has_grid else _OBS_KEYS_PLAIN

    def _get_action_ub_lb(self):
        params = self.microgrid.parameters

        def _param(name):
            return params[name].values[0] if name in params else 0.0

        upper_bound = [
            _param("grid_power_import"),
            _param("grid_power_export"),
            params["battery_power_charge"].values[0],
            params["battery_power_discharge"].values[0],
            params.PV_rated_power.squeeze(),
        ]
        lower_bound = [0] * 5

        if self.has_genset:
            rated = params["genset_rated_power"].values[0]
            upper_bound.insert(0, rated * params["genset_pmax"].values[0])
            lower_bound.insert(0, rated * params["genset_pmin"].values[0])

        return (
            np.array(upper_bound, dtype=np.float64),
            np.array(lower_bound, dtype=np.float64),
        )

    def get_values(self, *value_names):
        """Unstandardized current action/observation components by name
        (reference lines 237-291)."""
        if self.current_action is None:
            print("Warning: current_action is None, should only happen on first iteration")
            self.current_action = np.array([0] * len(self._action_keys))
            action = self.current_action
            obs = self.current_obs
        elif self.standardization:
            obs_mean, obs_std, action_mean, action_std = self.standardizations
            action = self.standardize(
                self.current_action, action_mean, action_std, direction="backward"
            )
            obs = self.standardize(self.current_obs, obs_mean, obs_std, direction="backward")
        else:
            action = self.current_action
            obs = self.current_obs

        actions_dict = dict(zip(self._action_keys, action))
        obs_dict = dict(zip(self._obs_keys, obs))

        values = []
        for name in value_names:
            if name in actions_dict:
                values.append(actions_dict[name])
            elif name in obs_dict:
                values.append(obs_dict[name])
            else:
                raise ValueError(
                    f"Value '{name}' not recognized with current architecture"
                )
        return values

    def reset(self):
        observation = super().reset()
        if self.standardization:
            obs_mean, obs_std, _, _ = self.standardizations
            observation = self.standardize(observation, obs_mean, obs_std, direction="forward")
            self.current_obs = observation
        return observation

    def step(self, action, **kwargs):
        assert isinstance(action, np.ndarray)
        unscaled_action = action.copy()

        if self.standardization:
            obs_mean, obs_std, action_mean, action_std = self.standardizations
            action = self.standardize(action, action_mean, action_std, direction="backward")

        observation, reward, done, info = super().step(action)

        if self.standardization:
            observation = self.standardize(observation, obs_mean, obs_std, direction="forward")

        self.current_obs = observation
        self.current_action = unscaled_action
        return observation, reward, done, info

    def standardize(self, data, mean_proxy=None, std_proxy=None, direction="forward",
                    use_proxy=None):
        """Affine (de)standardization with validation (reference lines 354-391)."""
        if (mean_proxy is None and std_proxy is None and use_proxy is None) or (
            mean_proxy is not None and use_proxy is not None
        ):
            raise ValueError(
                "Must pass mean_proxy and std_proxy, or use_proxy must be a str in "
                "('action', 'obs'), but not both"
            )
        if mean_proxy is None and std_proxy is None:
            if use_proxy == "action":
                mean_proxy, std_proxy = self.standardizations[2:]
            elif use_proxy == "obs":
                mean_proxy, std_proxy = self.standardizations[:2]
            else:
                raise NameError(
                    f"Unable to recognize use_proxy {use_proxy}, must be one of "
                    f"'action' or 'obs'"
                )

        names = ("data", "mean_proxy", "std_proxy")
        vals = (data, mean_proxy, std_proxy)
        for name, v in zip(names, vals):
            if not isinstance(v, np.ndarray):
                raise TypeError(f"{name} must be of type numpy.ndarray, is {type(v)}")
        if not (data.shape == mean_proxy.shape == std_proxy.shape):
            raise ValueError(
                "Incompatible shapes of data, mean_proxy, std_proxy. Must be equal, "
                f"are: {dict(zip(names, [v.shape for v in vals]))}"
            )
        if direction not in ("forward", "backward"):
            raise ValueError("direction must be one of ('forward', 'backward')")

        if direction == "forward":
            return (data - mean_proxy) / std_proxy
        return data * std_proxy + mean_proxy

    def pre_compute_standardizations(self, alg_to_use="mpc"):
        """Run MPC to estimate per-component action/obs mean and std
        (reference lines 393-457)."""
        from pymgrid_tpu_torch.algos.mpc import ModelPredictiveControl

        if alg_to_use != "mpc":
            raise RuntimeError(f"algorithm name {alg_to_use} not currently supported")

        old_horizon = self.microgrid.horizon
        self.microgrid.horizon = 24
        mpc = ModelPredictiveControl(self.microgrid)
        mpc_output = mpc.run(max_steps=STANDARDIZATION_MPC_STEPS)
        self.microgrid.horizon = old_horizon

        def summarize(frame, keys):
            means = [np.mean(frame[name]) for name in keys]
            stds = [np.std(frame[name]) for name in keys]
            return means, stds

        action_mean, action_std = summarize(mpc_output["action"], self._action_keys)
        obs_keys = list(self.microgrid._df_record_state.keys())
        obs_mean, obs_std = summarize(mpc_output["status"], obs_keys)

        # unit floor on every std so standardization never blows up
        obs_std = [max(s, 1.0) for s in obs_std]
        action_std = [max(s, 1.0) for s in action_std]

        names = ("obs_mean", "obs_std", "action_mean", "action_std")
        outputs = tuple(
            np.array(output)
            for output in (obs_mean, obs_std, action_mean, action_std)
        )
        for name, output in zip(names, outputs):
            for j, val in enumerate(output):
                if val == 0:
                    print(
                        f"Warning: Zero value in pos {j} in {name}, may not have "
                        f"been filled properly"
                    )
        return outputs

    def get_control_dict(self, action):
        if not isinstance(action, np.ndarray):
            raise TypeError(f"action must be an ndarray, is {type(action)}")

        if self.has_genset:
            return {
                "battery_charge": action[3],
                "battery_discharge": action[4],
                "genset": action[0],
                "grid_import": action[1],
                "grid_export": action[2],
                "pv_consummed": action[5],
            }
        return {
            "battery_charge": action[2],
            "battery_discharge": action[3],
            "grid_import": action[0],
            "grid_export": action[1],
            "pv_consummed": action[4],
        }


class _SaaResampleMixin:
    """Shared wiring for the *SampleEnv variants: an SAA sampler built at
    construction, and load/pv/grid resampled from it on every reset."""

    def _init_sampler(self, forecast_args, baseline_sampling_args):
        self.forecast_args = forecast_args
        self.baseline_sampling_args = baseline_sampling_args
        self.saa = generate_sampler(self.microgrid, forecast_args)

    def reset(self, sampling_args=None):
        sample_reset(self.has_grid, self.saa, self.microgrid,
                     sampling_args=sampling_args)
        return super().reset()


class ContinuousMicrogridSampleEnv(_SaaResampleMixin, ContinuousMicrogridEnv):
    """ContinuousMicrogridEnv with SAA-sampled data on reset
    (reference lines 487-508)."""

    metadata = {"render.modes": ["human"]}

    def __init__(self, microgrid, standardization=True, forecast_args=None,
                 baseline_sampling_args=None, max_episode_len=None):
        super().__init__(
            microgrid, standardization=standardization, max_episode_len=max_episode_len
        )
        self._init_sampler(forecast_args, baseline_sampling_args)


class SafeExpMicrogridEnv(ContinuousMicrogridEnv):
    """ContinuousMicrogridEnv with constraint values for a safety layer
    (reference lines 511-642)."""

    def __init__(self, microgrid, standardization=True, balance_tolerance=1.0,
                 scale_constraints=True, only_inequality_constr=True,
                 trajectory_len=None, max_episode_len=None):
        super().__init__(
            microgrid,
            standardization=standardization,
            trajectory_len=trajectory_len,
            max_episode_len=max_episode_len,
        )
        self.balance_tolerance = balance_tolerance
        self.scale_constraints = scale_constraints
        self.only_inequality_constr = only_inequality_constr

        self.n_constraints = 9 if self.has_genset else 7
        if only_inequality_constr:
            self.n_constraints -= 1

    def get_num_constraints(self):
        return self.n_constraints

    def get_constraint_values(self):
        """Constraint values in ``c_i < 0`` form."""
        inequality_constraints = self._get_inequality_constraints()
        if self.only_inequality_constr:
            return inequality_constraints
        return np.append(inequality_constraints, self._get_energy_balance())

    def _get_energy_balance(self):
        names = ["grid_import", "grid_export", "battery_charge", "battery_discharge",
                 "load", "pv", "pv_consummed"]
        if self.has_genset:
            names.insert(4, "genset")
            (p_import, p_export, p_charge, p_discharge, p_genset, load, pv,
             pv_consumed) = self.get_values(*names)
        else:
            (p_import, p_export, p_charge, p_discharge, load, pv,
             pv_consumed) = self.get_values(*names)
            p_genset = 0

        pv_curtailed = pv - pv_consumed
        energy_balance = np.array(
            p_import - p_export - p_charge + p_discharge + p_genset
            - pv_curtailed - load + pv
        )
        if self.scale_constraints:
            energy_balance /= float(self.microgrid.parameters.battery_capacity.squeeze())
        return energy_balance

    def _push(self, constraints, value, scale):
        """Append ``value`` (or ``value/scale`` when scaling is on)."""
        constraints.append(value / scale if self.scale_constraints else value)

    def _get_inequality_constraints(self):
        constraints = []

        p_charge, p_discharge, p_max_charge, p_max_discharge = self.get_values(
            "battery_charge", "battery_discharge", "capa_to_charge", "capa_to_discharge"
        )
        charge_scale = float(self.microgrid.parameters.battery_capacity.squeeze())
        self._push(constraints, p_charge - p_max_charge, charge_scale)
        self._push(constraints, p_discharge - p_max_discharge, charge_scale)

        p_max_import = self.microgrid.parameters["grid_power_import"].values[0]
        p_max_export = self.microgrid.parameters["grid_power_export"].values[0]
        p_import, p_export, grid_status = self.get_values(
            "grid_import", "grid_export", "grid_status"
        )
        self._push(constraints, p_import - p_max_import * grid_status, p_max_import)
        self._push(constraints, p_export - p_max_export * grid_status, p_max_export)

        soc_max = self.microgrid.parameters["battery_soc_max"].values[0]
        soc_min = self.microgrid.parameters["battery_soc_min"].values[0]
        (battery_soc,) = self.get_values("battery_soc")
        self._push(constraints, battery_soc - soc_max, soc_max)
        self._push(constraints, soc_min - battery_soc, soc_min)

        if self.has_genset:
            rated = self.microgrid.parameters["genset_rated_power"].values[0]
            p_genset_max = rated * self.microgrid.parameters["genset_pmax"].values[0]
            p_genset_min = rated * self.microgrid.parameters["genset_pmin"].values[0]
            (p_genset,) = self.get_values("genset")

            if p_genset < 1:
                self._push(constraints, p_genset - 1, p_genset_max)
                self._push(constraints, -p_genset - self.balance_tolerance, p_genset_max)
            else:
                self._push(constraints, p_genset - p_genset_max, p_genset_max)
                self._push(constraints, p_genset_min - p_genset, p_genset_min)

        return np.array(constraints)


class SafeExpMicrogridSampleEnv(_SaaResampleMixin, SafeExpMicrogridEnv):
    """SafeExpMicrogridEnv with SAA-sampled data on reset
    (reference lines 645-672)."""

    def __init__(self, microgrid, standardization=True, balance_tolerance=1.0,
                 scale_constraints=True, only_inequality_constr=True,
                 forecast_args=None, baseline_sampling_args=None,
                 trajectory_len=None, max_episode_len=None):
        super().__init__(
            microgrid,
            standardization=standardization,
            balance_tolerance=balance_tolerance,
            scale_constraints=scale_constraints,
            only_inequality_constr=only_inequality_constr,
            trajectory_len=trajectory_len,
            max_episode_len=max_episode_len,
        )
        self._init_sampler(forecast_args, baseline_sampling_args)
