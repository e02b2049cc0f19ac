"""Forecasting subsystem.

Behavioral mirror of the reference forecasters
(``src/pymgrid/forecast/forecaster.py``):

* ``None``            -> :class:`NoForecaster`
* ``"oracle"``        -> :class:`OracleForecaster` (true future values)
* a number            -> :class:`GaussianNoiseForecaster` (truth + N(0, std)),
  optionally with per-step increasing std ``std*(1+log(1+arange(n)))`` and/or
  std relative to the time-series mean
* a callable          -> :class:`UserDefinedForecaster` (validated, and
  auto-vectorized if scalar)

Forecast windows that run off the end of the data are padded with the
observation-space midpoint and clipped to the observation bounds
(``forecaster.py:92-149``).

In the torch engine (:mod:`pymgrid_tpu_torch.core`) the oracle forecast is a
row gather from the device-resident series and seeded gaussian noise is
replayed from a numpy noise bank; these host classes remain the behavioral
spec.
"""
import numbers

import numpy as np

from pymgrid_tpu_torch.utils.space import ModuleSpace

__all__ = [
    "get_forecaster",
    "Forecaster",
    "NoForecaster",
    "OracleForecaster",
    "GaussianNoiseForecaster",
    "UserDefinedForecaster",
]


# --------------------------------------------------------------------------
# user-callable validation
# --------------------------------------------------------------------------
def _check_forecast_value(forecaster_output, true_forecast, val_c, n):
    """A forecasted value must be numeric and carry the input's sign."""
    if not np.issubdtype(np.array(forecaster_output).dtype, np.number):
        raise TypeError(
            "Forecaster validation failed: outputs must be numeric arrays or "
            f"numbers; got dtype {np.array(forecaster_output).dtype} "
            f"({forecaster_output})"
        )
    if not (forecaster_output * true_forecast >= 0):
        raise ValueError(
            "Forecaster validation failed: output sign must match the input "
            f"(or be zero); got {forecaster_output} for inputs val_c={val_c}, "
            f"val_c_plus_n={true_forecast}, n={n}"
        )


def _probe_vectorized(forecaster, val_c, vector_true_forecast, n):
    """Try the callable on vector inputs; returns whether outputs need an
    array cast.  Raises NotImplementedError if it can't take vectors."""
    try:
        probe = forecaster(val_c, vector_true_forecast, n)
    except Exception as e:
        raise NotImplementedError(
            "Forecaster does not accept vector inputs: calling "
            f"forecaster(val_c={val_c}, val_c_n={vector_true_forecast}, n={n}) "
            f"raised {type(e).__name__}: {e}"
        ) from e

    needs_cast = not hasattr(probe, "size")
    if needs_cast:
        probe = np.array(probe)

    try:
        probe = probe.reshape(vector_true_forecast.shape)
    except ValueError:
        raise ValueError(
            f"Forecaster returned shape {probe.shape}, which does not fit the "
            f"required forecast shape {vector_true_forecast.shape}"
        )

    for i, (predicted, actual) in enumerate(zip(probe, vector_true_forecast)):
        try:
            _check_forecast_value(predicted, actual, val_c, n)
        except Exception as e:
            raise type(e)(
                f"Forecast entry {i} failed validation: {e}"
            ) from e

    return needs_cast


def _probe_scalar(forecaster, val_c, scalar_true_forecast, n):
    try:
        probe = forecaster(val_c, scalar_true_forecast, n)
    except Exception as e_scalar:
        raise ValueError(
            "Forecaster does not accept scalar inputs: calling "
            f"forecaster(val_c={val_c}, val_c_plus_n={scalar_true_forecast}, n={n}) "
            f"raised {type(e_scalar).__name__}: {e_scalar}"
        ) from e_scalar

    if isinstance(probe, numbers.Number):
        value = probe
    else:
        try:
            value = probe.item()
        except (ValueError, AttributeError):
            raise ValueError(
                "Forecaster validation failed: scalar input must produce scalar "
                f"output, got {probe}"
            )
    _check_forecast_value(value, scalar_true_forecast, val_c, n)


def _validate_callable_forecaster(forecaster, time_series):
    """Returns ``(is_vectorized, cast_to_arr)`` for a user callable."""
    val_c = time_series[0]
    n = np.random.randint(2, len(time_series))
    window = time_series[:n]
    try:
        return True, _probe_vectorized(forecaster, val_c, window, n)
    except NotImplementedError:
        _probe_scalar(forecaster, val_c, window[-1], n)
        return False, False


def vectorize_scalar_forecaster(forecaster):
    def vectorized(val_c, val_c_n, n):
        if n != len(val_c_n):
            raise ValueError(
                f"Got {len(val_c_n)} true values ({val_c_n}) for an {n}-step forecast."
            )
        rows = np.array(
            [forecaster(val_c, v, n_i) for n_i, v in enumerate(val_c_n)]
        )
        width = rows.shape[1] if rows.ndim > 1 else 1
        return rows.reshape((-1, width))

    return vectorized


# --------------------------------------------------------------------------
# forecaster hierarchy
# --------------------------------------------------------------------------
class Forecaster:
    def __init__(self, observation_space, forecast_shape):
        self._obs_space = observation_space
        self._window_space = self._get_window_space(forecast_shape)
        self._pad_values = self._midpoint_fill()

    def _midpoint_fill(self):
        bounds = self._obs_space.unnormalized
        return (bounds.high + bounds.low) / 2

    def _get_window_space(self, shape):
        if len(shape) == 1:
            shape = (*shape, 1)
        elif len(shape) > 2:
            raise ValueError("shape must be one- or two-dimensional.")

        flat_size = shape[0] * shape[1]
        if flat_size:
            low = self._obs_space.unnormalized.low[-flat_size:]
            high = self._obs_space.unnormalized.high[-flat_size:]
        else:
            low, high = np.array([]), np.array([])

        return ModuleSpace(
            unnormalized_low=low.reshape(shape),
            unnormalized_high=high.reshape(shape),
            shape=shape,
        )

    def _forecast(self, val_c, val_c_n, n):
        raise NotImplementedError

    def _pad(self, forecast, n):
        """Pad an off-end forecast with the obs-space midpoint rows."""
        missing = n - forecast.shape[0]
        if missing == 0:
            return forecast
        fill_rows = self._pad_values.reshape((-1, forecast.shape[1]))[-missing:]
        if fill_rows.shape[0] < missing:
            raise RuntimeError(
                "Forecast pad request exceeds what the module's observation "
                "space allows."
            )
        return np.concatenate((forecast, fill_rows))

    def full_pad(self, shape, forecast_horizon):
        if forecast_horizon is None:
            return None
        return self._pad(np.array([]).reshape((0, shape[1])), forecast_horizon)

    def _clip(self, forecast):
        n_rows = forecast.shape[0]
        lo = self._window_space.unnormalized.low[-n_rows:]
        hi = self._window_space.unnormalized.high[-n_rows:]
        clipped = np.array(forecast)
        np.copyto(clipped, lo, where=clipped < lo)
        np.copyto(clipped, hi, where=clipped > hi)
        return clipped

    @property
    def observation_space(self):
        return self._obs_space

    @observation_space.setter
    def observation_space(self, value):
        self._obs_space = value
        self._pad_values = self._midpoint_fill()
        n_components = self._window_space.shape[1]
        horizon = int((value.shape[0] - n_components) / n_components)
        self._window_space = self._get_window_space(
            (horizon, n_components)
        )

    def __call__(self, val_c, val_c_n, n):
        if len(val_c_n.shape) == 1:
            val_c_n = val_c_n.reshape((-1, 1))
        if val_c_n.shape[0] > self._window_space.shape[0]:
            raise RuntimeError(
                f"True-future window of shape {val_c_n.shape} exceeds the forecast "
                f"space {self._window_space.shape}"
            )
        raw = self._forecast(val_c, val_c_n, n)
        if raw is None:
            return None
        out = self._clip(self._pad(raw, n))
        assert out.shape == (n, val_c_n.shape[1])
        return out

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        if not (np.asarray(self._pad_values) == np.asarray(other._pad_values)).all():
            return False
        return all(
            v == other.__dict__[k]
            for k, v in self.__dict__.items()
            if k != "_pad_values"
        )

    def __repr__(self):
        return self.__class__.__name__


class UserDefinedForecaster(Forecaster):
    """Wrap a user callable ``f(val_c, val_c_n, n)``; validated on a sample of
    the series for output shape/sign, and vectorized if it is scalar-only."""

    def __init__(self, forecaster_function, observation_space, forecast_shape, time_series):
        self.is_vectorized_forecaster, self.cast_to_arr = _validate_callable_forecaster(
            forecaster_function, time_series
        )
        # the unwrapped user callable; a compiled engine re-vectorizes it
        # with its own array namespace instead of the numpy wrapper below
        # (core/spec.py)
        self._user_forecaster = forecaster_function
        if not self.is_vectorized_forecaster:
            forecaster_function = vectorize_scalar_forecaster(forecaster_function)
        self._forecaster = forecaster_function
        super().__init__(observation_space, forecast_shape)

    def _forecast(self, val_c, val_c_n, n):
        predicted = self._forecaster(val_c, val_c_n, n)
        if self.cast_to_arr:
            predicted = np.array(predicted).reshape(val_c_n.shape)
        return predicted


class GaussianNoiseForecaster(Forecaster):
    """Truth plus gaussian noise drawn from the *global numpy RNG* (matching
    the reference's seeding semantics, ``forecaster.py:252-263``)."""

    def __init__(
        self,
        noise_std,
        observation_space,
        forecast_shape,
        time_series=None,
        increase_uncertainty=False,
        relative_noise=False,
    ):
        super().__init__(observation_space, forecast_shape)
        self.input_noise_scale = noise_std
        self.increase_uncertainty = increase_uncertainty
        self.relative_noise = relative_noise
        self._noise_shape = self._window_space.shape
        self._noise_scale = self._effective_noise_scale(time_series)

    def _effective_noise_scale(self, time_series):
        base = self.input_noise_scale
        if self.relative_noise:
            if time_series is None:
                raise ValueError("relative_noise=True requires a time_series to scale against.")
            base = base * np.abs(time_series.mean())
        if not self.increase_uncertainty:
            return base
        # std grows logarithmically with lookahead distance
        growth = 1 + np.log(1 + np.arange(self._noise_shape[0]))
        return base * np.outer(growth, np.ones(self._noise_shape[-1]))

    def _get_noise(self, size):
        try:
            return np.random.normal(scale=self._noise_scale, size=size)
        except ValueError:
            truncated = self._noise_scale[: size[0], :]
            if truncated.shape != size:
                raise RuntimeError(
                    f"Noise std of shape {self._noise_scale.shape} does not broadcast to {size}."
                )
            return np.random.normal(scale=truncated, size=size)

    def _forecast(self, val_c, val_c_n, n):
        return val_c_n + self._get_noise(val_c_n.shape).reshape(val_c_n.shape)

    @property
    def noise_std(self):
        return self._noise_scale

    def __repr__(self):
        return (
            f"GaussianNoiseForecaster(noise_std={self.input_noise_scale}, "
            f"increase_uncertainty={self.increase_uncertainty})"
        )


class OracleForecaster(Forecaster):
    def _forecast(self, val_c, val_c_n, n):
        return val_c_n


class NoForecaster(Forecaster):
    def _forecast(self, val_c, val_c_n, n):
        return None


# --------------------------------------------------------------------------
# factory
# --------------------------------------------------------------------------
def get_forecaster(
    forecaster,
    observation_space,
    forecast_shape,
    time_series=None,
    increase_uncertainty=False,
    relative_noise=False,
):
    """Resolve a forecaster spec (None / "oracle" / number / callable)."""
    if forecaster is None:
        return NoForecaster(observation_space, forecast_shape)
    if isinstance(
        forecaster, (UserDefinedForecaster, OracleForecaster, GaussianNoiseForecaster)
    ):
        return forecaster
    if callable(forecaster):
        return UserDefinedForecaster(
            forecaster, observation_space, forecast_shape, time_series
        )
    if forecaster == "oracle":
        return OracleForecaster(observation_space, forecast_shape)

    is_numeric = isinstance(forecaster, numbers.Number) or (
        hasattr(forecaster, "dtype")
        and np.issubdtype(np.asarray(forecaster).dtype, np.number)
    )
    if is_numeric:
        return GaussianNoiseForecaster(
            forecaster,
            observation_space,
            forecast_shape,
            time_series=time_series,
            increase_uncertainty=increase_uncertainty,
            relative_noise=relative_noise,
        )
    raise ValueError(f"Cannot interpret a forecaster of type {type(forecaster)}")
