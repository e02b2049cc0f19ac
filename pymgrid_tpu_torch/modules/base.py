"""Base microgrid module classes (host layer).

Behavioral mirror of the reference's module base classes
(``src/pymgrid/modules/base/base_module.py:17`` and
``modules/base/timeseries/base_timeseries_module.py:8``), built around a
different decomposition: energy dispatch goes through a single bounded
exchange helper, observation bounds are tiled per horizon step, and the
YAML state contract (``_current_step`` + state-dict keys) is what pins the
attribute names.  Per-module scalar state is numpy float64; the compiled
engine (:mod:`pymgrid_tpu_torch.core`) extracts parameters into struct-of-arrays
pytrees for batched execution on the card.
"""
import inspect
from warnings import warn

import numpy as np
import yaml

from pymgrid_tpu_torch.utils.logger import ModularLogger
from pymgrid_tpu_torch.utils.space import ModuleSpace
from pymgrid_tpu_torch.utils.serialize import (
    PymgridDumper,
    PymgridLoader,
    yaml_dump,
    yaml_load,
    add_numpy_pandas_representers,
    add_numpy_pandas_constructors,
    dump_data,
)

__all__ = ["BaseMicrogridModule", "BaseTimeSeriesMicrogridModule"]

DEFAULT_HORIZON = 23
"""Default forecast horizon in steps (reference: ``microgrid/__init__.py:1``)."""


def _bounds_to_space(lo, hi):
    """Build a ModuleSpace from scalar-or-array bounds."""
    if not isinstance(lo, np.ndarray):
        lo = np.array([lo])
    if not isinstance(hi, np.ndarray):
        hi = np.array([hi])
    return ModuleSpace(unnormalized_low=lo, unnormalized_high=hi)


class BaseMicrogridModule(yaml.YAMLObject):
    """Abstract microgrid module.

    A module is a small state machine stepped once per time tick.  A positive
    unnormalized action makes the module act as an energy *source*; a negative
    action as a *sink*; zero dispatches to the source path when the module is
    a source (``base_module.py:161-171``).
    """

    module_type = None
    yaml_tag = None
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    _energy_pos = 0

    def __init__(
        self,
        raise_errors,
        initial_step=0,
        provided_energy_name="provided_energy",
        absorbed_energy_name="absorbed_energy",
    ):
        self.raise_errors = raise_errors
        self.initial_step = initial_step
        self._current_step = initial_step
        self._action_space = self._get_action_spaces()
        self._observation_space = self._get_observation_spaces()
        self.provided_energy_name = provided_energy_name
        self.absorbed_energy_name = absorbed_energy_name
        self._logger = ModularLogger()
        self.name = (None, None)  # assigned by the module container

    # -------------------------------------------------------------- spaces
    def _get_action_spaces(self):
        return _bounds_to_space(self.min_act, self.max_act)

    def _get_observation_spaces(self):
        return _bounds_to_space(self.min_obs, self.max_obs)

    # ------------------------------------------------------------ stepping
    def reset(self):
        """Rewind to the initial step, flush the log, return normalized obs."""
        self._update_step(reset=True)
        self._logger.flush()
        return self.to_normalized(self.state, obs=True)

    def _scalar_energy(self, action):
        """Reduce an action to its scalar energy component.

        Accepts indexables (row ``_energy_pos``), plain numbers, and empty
        arrays (treated as a zero request); anything else is rejected.
        """
        try:
            return action[self._energy_pos]
        except (IndexError, TypeError):
            pass
        if isinstance(action, (float, int)):
            return action
        shape = getattr(action, "shape", None)
        if shape is not None and np.prod(shape) == 0:
            return 0.0
        raise ValueError(f"Bad action {action}")

    def step(self, action, normalized=True):
        """Advance the module one tick with an energy request.

        Returns the gym-style 4-tuple ``(normalized_obs, reward, done, info)``
        where ``info`` carries ``provided_energy`` or ``absorbed_energy``
        (``base_module.py:95-159``).
        """
        if normalized:
            action = self._action_space.denormalize(action)
        energy = self._scalar_energy(action)

        pre_step_state = self.state_dict()
        reward, done, info = self._unnormalized_step(energy)
        self._log(pre_step_state, reward=reward, **info)
        self._update_step()

        return self.to_normalized(self.state, obs=True), reward, done, info

    def _unnormalized_step(self, energy):
        if energy > 0:
            return self.as_source(energy)
        if energy < 0:
            return self.as_sink(-1.0 * energy)
        # zero (and non-comparable) requests route to the source path first
        if self.is_source:
            return self.as_source(energy)
        assert self.is_sink
        return self.as_sink(-1.0 * energy)

    def _bounded_exchange(self, request, lo, hi, direction):
        """Clamp an energy request to ``[lo, hi]``, raising first when
        ``raise_errors`` is set.  ``direction`` is 'source' or 'sink'."""
        as_source = direction == "source"
        if request > hi:
            if self.raise_errors:
                self._raise_error(request, hi, as_source=as_source, as_sink=not as_source)
            return hi
        if request < lo:
            if self.raise_errors:
                self._raise_error(
                    request, lo, as_source=as_source, as_sink=not as_source, lower_bound=True
                )
            return lo
        return request

    def as_source(self, energy_demand):
        """Provide ``energy_demand`` to the microgrid, clipped to the module's
        current production bounds unless ``raise_errors``."""
        assert energy_demand >= 0
        assert self.is_source, (
            f"module {self} was stepped with positive energy (as a source) but "
            f"it is not a source; only negative energy requests are valid."
        )

        if self.module_type[-1] == "fixed":
            return self.update(None, as_source=True)

        delivered = self._bounded_exchange(
            energy_demand, self.min_production, self.max_production, "source"
        )
        return self.update(delivered, as_source=True)

    def as_sink(self, energy_excess):
        """Absorb ``energy_excess`` from the microgrid, clipped to
        ``max_consumption`` unless ``raise_errors``."""
        assert energy_excess >= 0

        if self.module_type[-1] == "fixed":
            return self.update(None, as_sink=True)

        absorbed = self._bounded_exchange(energy_excess, 0.0, self.max_consumption, "sink")
        assert absorbed >= 0
        return self.update(absorbed, as_sink=True)

    def _raise_error(self, ask_value, available_value, as_source=False, as_sink=False, lower_bound=False):
        assert as_source + as_sink == 1
        asked, have = round(ask_value, 2), round(available_value, 2)
        cls_name = self.__class__.__name__
        if as_sink:
            detail = f"absorb {asked} as a sink; it can currently absorb at most {have}"
        elif lower_bound:
            detail = f"provide {asked} as a source; it must provide at least {have}"
        else:
            detail = f"provide {asked} as a source; it can currently provide at most {have}"
        raise ValueError(f"Module {cls_name} cannot {detail}.")

    def update(self, external_energy_change, as_source=False, as_sink=False):
        """Apply the (clipped) energy exchange; return (reward, done, info)."""
        raise NotImplementedError

    def _update_step(self, reset=False):
        self._current_step = self.initial_step if reset else self._current_step + 1

    def sample_action(self, strict_bound=False):
        """Sample a normalized action uniformly; with ``strict_bound``, bound
        it by current instantaneous production/consumption limits."""
        lo, hi = 0, 1
        if strict_bound:
            if self.is_sink:
                lo = self._action_space.normalize(-1 * self.max_consumption)
                if np.isnan(lo):
                    lo = 0
            if self.is_source:
                hi = self._action_space.normalize(self.max_production)
                if np.isnan(hi):
                    hi = 0
        return np.random.rand() * (hi - lo) + lo

    # ------------------------------------------------------------- logging
    def _log(self, state_dict_pre_step, provided_energy=None, absorbed_energy=None, **info):
        row = info.copy()
        for key_name, value in (
            (self.provided_energy_name, provided_energy),
            (self.absorbed_energy_name, absorbed_energy),
        ):
            if key_name is not None:
                row[key_name] = value if value is not None else 0.0
            else:
                assert value is None, (
                    "cannot log an energy value when its log key name is None"
                )
        row.update(state_dict_pre_step)
        self._logger.log(**row)

    def log_dict(self):
        return self._logger.to_dict()

    def log_frame(self):
        return self._logger.to_frame()

    @property
    def log(self):
        return self.log_frame()

    @property
    def logger(self):
        return self._logger

    @logger.setter
    def logger(self, logger):
        assert isinstance(logger, ModularLogger)
        self._logger = logger

    @property
    def logger_last(self):
        return {k: v[-1] for k, v in self._logger}

    # --------------------------------------------------------------- state
    def to_normalized(self, value, act=False, obs=False):
        assert act + obs == 1
        return (self._action_space if act else self._observation_space).normalize(value)

    def from_normalized(self, value, act=False, obs=False):
        assert act + obs == 1
        return (self._action_space if act else self._observation_space).denormalize(value)

    def state_dict(self, normalized=False):
        raw = self._state_dict()
        if not normalized:
            return raw
        normalized_values = np.atleast_1d(self._observation_space.normalize(self.state))
        return dict(zip(raw.keys(), normalized_values))

    def _state_dict(self):
        raise NotImplementedError

    @property
    def state(self):
        return np.array([*self.state_dict().values()])

    @property
    def current_step(self):
        return self._current_step

    @current_step.setter
    def current_step(self, value):
        self._current_step = value

    # -------------------------------------------------------------- bounds
    @property
    def min_obs(self):
        raise NotImplementedError

    @property
    def max_obs(self):
        raise NotImplementedError

    @property
    def min_act(self):
        raise NotImplementedError

    @property
    def max_act(self):
        raise NotImplementedError

    @property
    def min_production(self):
        return 0

    @property
    def max_production(self):
        return NotImplemented

    @property
    def max_consumption(self):
        return NotImplemented

    @property
    def marginal_cost(self):
        return self.production_marginal_cost

    @property
    def production_marginal_cost(self):
        return 0.0

    @property
    def absorption_marginal_cost(self):
        return 0.0

    @property
    def action_space(self):
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def is_source(self):
        return False

    @property
    def is_sink(self):
        return False

    # ---------------------------------------------------------------- yaml
    def dump(self, stream=None):
        """Serialize to YAML; sidecar ``.csv.gz`` files are used when dumping
        to a named file stream (see :mod:`pymgrid_tpu_torch.utils.serialize`)."""
        return yaml_dump(self, stream=stream)

    @classmethod
    def load(cls, stream):
        return yaml_load(stream)

    @classmethod
    def to_yaml(cls, dumper, data):
        add_numpy_pandas_representers()
        return dumper.represent_mapping(
            cls.yaml_tag, data.serialize(dumper.stream), flow_style=cls.yaml_flow_style
        )

    @classmethod
    def from_yaml(cls, loader, node):
        add_numpy_pandas_constructors()
        mapping = loader.construct_mapping(node, deep=True)
        instance = cls.deserialize_instance(mapping["cls_params"])
        instance.logger = instance.logger.from_raw(mapping.get("log"))
        instance.name = tuple(mapping["name"])
        return instance.deserialize(mapping["state"])

    def serialize(self, dumper_stream):
        payload = {
            "name": self.name,
            "cls_params": self._serialize_cls_params(),
            "state": self._serialize_state_attributes(),
            **self._logger.serialize("log"),
        }
        return dump_data(payload, dumper_stream, self.yaml_tag)

    def serializable_state_attributes(self):
        return ["_current_step", *self.state_dict().keys()]

    def _serialize_state_attributes(self):
        return {attr: getattr(self, attr) for attr in self.serializable_state_attributes()}

    def _serialize_cls_params(self):
        out = {}
        for param in inspect.signature(self.__init__).parameters:
            if not hasattr(self, param):
                raise AttributeError(
                    f"Module {self.__class__.__name__} must have attribute/property "
                    f"'{param}' corresponding to class parameter of the same name."
                )
            out[param] = getattr(self, param)
        return out

    @classmethod
    def deserialize_instance(cls, param_dict):
        remaining = param_dict.copy()
        kwargs, absent, defaulted = {}, [], []
        for name, spec in inspect.signature(cls).parameters.items():
            if name in remaining:
                kwargs[name] = remaining.pop(name)
            elif spec.default is not spec.empty:
                kwargs[name] = spec.default
                defaulted.append(name)
            else:
                absent.append(name)
        if defaulted:
            warn(f"Missing parameter values {defaulted} for {cls}. Using available default values.")
        if absent:
            raise KeyError(
                f"Missing parameter values {absent} for {cls} with no default values available."
            )
        return cls(**kwargs)

    def deserialize(self, serialized_dict):
        remaining = serialized_dict.copy()
        for attr in self.serializable_state_attributes():
            if not hasattr(self, attr):
                raise ValueError(
                    f"Key {attr} is not an attribute of module {self} and cannot be set."
                )
            if attr not in remaining:
                raise KeyError(f"Missing key {attr} in deserialized dict.")
            setattr(self, attr, remaining.pop(attr))
        if remaining:
            warn(f"Unused keys in serialized_dict: {list(remaining.keys())}")
        return self

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        # positional zip over both __dict__s, allclose for array-likes
        # (mirrors reference base_module.py:959-966)
        for (_, mine), (_, theirs) in zip(self.__dict__.items(), other.__dict__.items()):
            if hasattr(mine, "any"):
                if not np.allclose(mine, theirs):
                    return False
            elif mine != theirs:
                return False
        return True

    def __repr__(self):
        parts = []
        for param in inspect.signature(self.__init__).parameters:
            value = getattr(self, param, None)
            if hasattr(value, "__len__") and not isinstance(value, str):
                value = type(value)
            parts.append(f"{param}={value}")
        return f"{self.__class__.__name__}({', '.join(parts)})"


class BaseTimeSeriesMicrogridModule(BaseMicrogridModule):
    """Module driven by a ``(T, n_features)`` time series.

    Sinks store their series negative, sources positive
    (``base_timeseries_module.py:68-79``); observations are the current row
    plus the forecast window flattened row-major.
    """

    state_components = None

    def __init__(
        self,
        time_series,
        raise_errors,
        forecaster=None,
        forecast_horizon=DEFAULT_HORIZON,
        forecaster_increase_uncertainty=False,
        forecaster_relative_noise=False,
        initial_step=0,
        final_step=-1,
        provided_energy_name="provided_energy",
        absorbed_energy_name="absorbed_energy",
    ):
        from pymgrid_tpu_torch.forecast.forecaster import get_forecaster

        self._time_series = self._set_time_series(time_series)
        self._min_obs, self._max_obs, self._min_act, self._max_act = self._get_bounds()

        self.final_step = final_step

        self._forecast_param = forecaster
        self._forecast_horizon = forecast_horizon * (forecaster is not None)
        self._forecaster = get_forecaster(
            forecaster,
            self._get_observation_spaces(),
            forecast_shape=(self.forecast_horizon, len(self.state_components)),
            time_series=self.time_series[initial_step : self.final_step, :],
            increase_uncertainty=forecaster_increase_uncertainty,
            relative_noise=forecaster_relative_noise,
        )

        self._state_dict_keys = self._set_state_dict_keys()

        super().__init__(
            raise_errors,
            initial_step=initial_step,
            provided_energy_name=provided_energy_name,
            absorbed_energy_name=absorbed_energy_name,
        )

        self._current_forecast = self.forecast()

    # ----------------------------------------------------------- ts set-up
    def _set_time_series(self, time_series):
        arr = np.array(time_series, dtype=np.float64)
        n_cols = arr.shape[1] if arr.ndim > 1 else 1
        arr = arr.reshape((-1, n_cols))
        assert len(arr) == len(time_series)
        return self._sign_check(arr)

    def _sign_check(self, time_series):
        if self.is_source and self.is_sink:
            return time_series
        has_pos = (np.sign(time_series) > 0).any()
        has_neg = (np.sign(time_series) < 0).any()
        if has_pos and has_neg:
            raise ValueError(
                "time_series cannot contain both positive and negative values "
                "unless it is both a source and a sink."
            )
        return np.abs(time_series) if self.is_source else -np.abs(time_series)

    def _get_bounds(self):
        lo, hi = np.min(self._time_series), np.max(self._time_series)
        # bounds straddle zero: clamp whichever side doesn't reach it
        if lo > 0:
            lo = 0
        elif hi < 0:
            hi = 0
        return lo, hi, lo, hi

    def _set_state_dict_keys(self):
        return {
            "current": [f"{c}_current" for c in self.state_components],
            "forecast": [
                f"{c}_forecast_{j}"
                for j in range(self._forecast_horizon)
                for c in self.state_components
            ],
        }

    # ------------------------------------------------------------ stepping
    def _update_step(self, reset=False):
        super()._update_step(reset=reset)
        self._current_forecast = self.forecast()

    def forecast(self):
        """Forecast window starting one step ahead (or None without a
        forecaster); off-end windows are midpoint-padded by the forecaster."""
        start = 1 + self.current_step
        future = self.time_series[start : start + self.forecast_horizon, :]
        try:
            present = self.time_series[self.current_step, :]
        except IndexError:
            return self._forecaster.full_pad(
                self.time_series.shape, self._forecast_horizon
            )
        return self._forecaster(val_c=present, val_c_n=future, n=self.forecast_horizon)

    def _done(self):
        return self._current_step >= self._final_step - 1

    @property
    def current_obs(self):
        try:
            return self.time_series[self.current_step, :]
        except IndexError:
            return self._forecaster.full_pad(self.time_series.shape, 1).reshape(-1)

    # ---------------------------------------------------------- properties
    @property
    def time_series(self):
        return self._time_series

    @time_series.setter
    def time_series(self, value):
        self._time_series = self._set_time_series(value)
        self._min_obs, self._max_obs, self._min_act, self._max_act = self._get_bounds()
        self._action_space = self._get_action_spaces()
        self._observation_space = self._get_observation_spaces()

    @property
    def min_obs(self):
        # per-feature minima tiled once per (current + horizon) row
        return np.tile(np.array(self._min_obs).reshape(-1), 1 + self._forecast_horizon)

    @property
    def max_obs(self):
        return np.tile(np.array(self._max_obs).reshape(-1), 1 + self._forecast_horizon)

    @property
    def min_act(self):
        return self._min_act

    @property
    def max_act(self):
        return self._max_act

    @property
    def forecaster(self):
        return self._forecaster

    def set_forecaster(
        self,
        forecaster,
        forecast_horizon=DEFAULT_HORIZON,
        forecaster_increase_uncertainty=False,
        forecaster_relative_noise=False,
    ):
        from pymgrid_tpu_torch.forecast.forecaster import get_forecaster

        self.forecast_horizon = forecast_horizon * (forecaster is not None)
        self._forecaster = get_forecaster(
            forecaster,
            self._observation_space,
            (self.forecast_horizon, len(self.state_components)),
            self.time_series[self.initial_step : self._final_step, :],
            increase_uncertainty=forecaster_increase_uncertainty,
            relative_noise=forecaster_relative_noise,
        )

    @property
    def forecast_horizon(self):
        return self._forecast_horizon

    @forecast_horizon.setter
    def forecast_horizon(self, value):
        from pymgrid_tpu_torch.forecast.forecaster import NoForecaster, OracleForecaster

        self._forecast_horizon = value
        self._state_dict_keys = self._set_state_dict_keys()
        self._observation_space = self._get_observation_spaces()

        if value > 0 and isinstance(self._forecaster, NoForecaster):
            warn(
                "Setting forecast_horizon requires a non-null forecaster. "
                "Implementing OracleForecaster."
            )
            self._forecaster = OracleForecaster(
                self._observation_space,
                forecast_shape=(value, len(self.state_components)),
            )
        self._forecaster.observation_space = self._observation_space

    @property
    def forecaster_increase_uncertainty(self):
        return getattr(self._forecaster, "increase_uncertainty", False)

    @property
    def forecaster_relative_noise(self):
        return getattr(self._forecaster, "relative_noise", False)

    @property
    def final_step(self):
        return self._final_step

    @final_step.setter
    def final_step(self, value):
        if value // 1 != value:
            raise ValueError("final_step value must be an integer.")
        self._final_step = len(self) if value <= 0 else value
        # initial_step is unset while the ts subclass constructor runs
        initial = getattr(self, "initial_step", None)
        if initial is not None and self._final_step <= initial:
            raise ValueError("final_step value must be greater than initial_step")

    def _state_dict(self):
        out = dict(zip(self._state_dict_keys["current"], self.current_obs))
        if self._current_forecast is not None:
            out.update(
                zip(self._state_dict_keys["forecast"], self._current_forecast.reshape(-1))
            )
        return out

    # ---------------------------------------------------------------- yaml
    def serialize(self, dumper_stream):
        payload = super().serialize(dumper_stream)
        payload["cls_params"]["forecaster"] = self._forecast_param
        return payload

    def serializable_state_attributes(self):
        return ["_current_step"]

    def deserialize(self, serialized_dict):
        # refresh the realized forecast for the restored step (the reference
        # leaves the construction-time forecast in place, so a module
        # serialized mid-episode would observe a stale window)
        out = super().deserialize(serialized_dict)
        self._current_forecast = self.forecast()
        return out

    def __len__(self):
        return self._time_series.shape[0]
