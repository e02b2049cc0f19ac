"""Sample generators for stochastic MPC (SAA).

Behavioral mirror of ``src/pymgrid/utils/DataGenerator.py``:

* :class:`NoisyPVData` — fits seasonal upper/lower quantile curves to daily
  PV maxima (cos/sin features), rebuilds each day as a quadratic
  dawn-peak-dusk curve with a randomized peak, plus optional gaussian noise.
  Quantile regression is solved exactly as an LP with scipy/HiGHS (the
  reference uses statsmodels' IRLS ``QuantReg``, not available here).
* :class:`NoisyLoadData` — gaussian noise around day-of-week hourly means.
* :class:`NoisyGridData` — naive or 2-state Markov-chain outage resampling.
* :class:`SampleGenerator` — forecast creation, MAPE validation and batched
  sampling on a legacy (nonmodular) microgrid.

The random draws come from the global numpy RNG in a fixed call order, so
seeded sampling stays reproducible.
"""
import numpy as np
import pandas as pd
from scipy.interpolate import interp1d

__all__ = [
    "return_underlying_data",
    "quantile_regression_fit",
    "NoisyPVData",
    "NoisyLoadData",
    "NoisyGridData",
    "SampleGenerator",
    "ForecastArgSet",
    "ForecastArgs",
]


def return_underlying_data(microgrid):
    """(pv, load, grid) frame from a legacy microgrid
    (``DataGenerator.py:30-59``)."""
    pv_column = microgrid._pv_ts[microgrid._pv_ts.columns[0]]
    load_column = microgrid._load_ts[microgrid._load_ts.columns[0]]
    pv_column.name = "pv"
    load_column.name = "load"

    if microgrid.architecture["grid"] != 0:
        grid_column = microgrid._grid_status_ts
        if isinstance(grid_column, pd.DataFrame):
            grid_column = grid_column[grid_column.columns[0]]
        grid_column.name = "grid"
    else:
        grid_column = pd.Series(
            data=[0] * len(microgrid._load_ts), index=pv_column.index, name="grid"
        )

    return pd.concat([pv_column, load_column, grid_column], axis=1)


def quantile_regression_fit(y, X, q):
    """Exact quantile regression via its LP formulation (HiGHS).

    minimize  q*1'u+ + (1-q)*1'u-   s.t.  X beta + u+ - u- = y,  u+/- >= 0
    """
    from scipy.optimize import linprog
    from scipy import sparse

    y = np.asarray(y, dtype=float)
    X = np.asarray(X, dtype=float)
    n, p = X.shape

    c = np.concatenate([np.zeros(p), q * np.ones(n), (1 - q) * np.ones(n)])
    A_eq = sparse.hstack([sparse.csr_matrix(X), sparse.eye(n), -sparse.eye(n)])
    bounds = [(None, None)] * p + [(0, None)] * (2 * n)
    res = linprog(c, A_eq=A_eq, b_eq=y, bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"Quantile regression LP failed: {res.message}")
    return res.x[:p]


def _hour_day_columns(n_hours):
    hours = [j % 24 for j in range(n_hours)]
    days = [int(np.floor(j / 24)) for j in range(n_hours)]
    return hours, days


class _NoisySeriesData:
    """Shared frame/file intake and negative-sample repair for the noisy
    PV/load samplers."""

    _FALLBACK_COLUMN = None  # column name to try when multiple are present

    def __init__(self, known_data=None, file_name=None):
        if known_data is not None:
            if isinstance(known_data, pd.Series):
                known_data = known_data.to_frame()
            elif not isinstance(known_data, pd.DataFrame):
                raise TypeError(
                    f"known_data must be of type pd.DataFrame or pd.Series, is "
                    f"({type(known_data)})"
                )
            self.unmunged_data = known_data.copy()
            self.data = known_data.copy()
        elif file_name is not None:
            self.data = pd.read_csv(file_name)
            self.unmunged_data = pd.read_csv(file_name)
        else:
            raise RuntimeError(
                "Unable to initialize data, either known_data or file_name must not be None"
            )

        self.num_hours = len(self.data)
        self.munged = False

    def _value_column(self, warn_label):
        if len(self.data.columns.values) == 1:
            return self.data.columns[0]
        print(
            f"Warning multiple columns in {warn_label}, attempting to use "
            f"'{self._FALLBACK_COLUMN}' as column name"
        )
        return self._FALLBACK_COLUMN

    def _negative_fill_value(self):
        raise NotImplementedError

    def _negative_fill_message(self, count):
        raise NotImplementedError

    def _check_sample(self, stacked_data, verbose=False):
        flattened = stacked_data.copy().squeeze()
        if not isinstance(flattened, pd.Series):
            raise ValueError(
                "stacked_data needs to be a series or a single column DataFrame, "
                f"has shape {stacked_data.shape}"
            )
        negative = flattened < 0
        if negative.sum() > 0 and verbose:
            print(self._negative_fill_message(negative.sum()))
        flattened.loc[negative] = self._negative_fill_value()
        if isinstance(stacked_data, pd.Series):
            return flattened
        repaired = stacked_data.copy()
        repaired[repaired.columns[0]] = flattened
        return repaired


class NoisyPVData(_NoisySeriesData):
    _FALLBACK_COLUMN = "GH illum (lx)"

    def __init__(self, pv_data=None, file_name=None):
        super().__init__(known_data=pv_data, file_name=file_name)
        self.daily_maxes = None
        self.feature_functions = None
        self.feature_names = None
        self.interpolated = False
        self.interpolated_coef = None
        self.parabolic_baseline = None
        self.distribution_bounds = None

    def _negative_fill_value(self):
        return 0

    def _negative_fill_message(self, count):
        return f"Found {count} negative values in pv_data sample, forcing to 0"

    # ------------------------------------------------------------- fitting
    def data_munge(self, verbose=False):
        col_name = self._value_column("pv_data")
        hours, days = _hour_day_columns(self.num_hours)
        self.data = self.data.copy()
        self.data["hour"] = pd.Series(data=hours)
        self.data["day"] = pd.Series(data=days)
        self.data = self.data.pivot(index="hour", columns="day", values=col_name)

        peak_hours = self.data.idxmax(axis=0)
        peaks = self.data.max(axis=0)
        peak_hours.name = "time_of_max"
        peaks.name = "max_GHI"
        self.daily_maxes = pd.concat([peak_hours, peaks], axis=1)
        self.daily_maxes["cumulative_hr"] = (
            self.daily_maxes["time_of_max"] + self.daily_maxes.index.values * 24
        )
        self.munged = True

    def _add_feature_columns(self, num_feature_functions=1, period_scale=1.0):
        if not self.munged:
            raise RuntimeError(
                "Data must be munged before adding feature columns or curve "
                "interpolation. Call data_munge first"
            )

        def constant_feature(x):
            if isinstance(x, (int, float)):
                return 1.0
            return pd.Series(data=[1.0] * len(x))

        def trig_feature(harmonic, fn):
            def f(x):
                return fn(2 * harmonic * np.pi / 8760.0 * period_scale * (x - 173 * 24))

            return f

        self.daily_maxes["ones"] = pd.Series(
            data=[1.0] * len(self.daily_maxes["cumulative_hr"]),
            index=self.daily_maxes.index,
        )
        names = ["ones"]
        functions = {"ones": constant_feature}

        for k in range(num_feature_functions):
            if k % 2 == 0:
                harmonic = int(np.floor((k + 2) / 2))
                name, f = f"cos{harmonic}x", trig_feature(harmonic, np.cos)
            else:
                harmonic = int(np.floor((k + 1) / 2))
                name, f = f"sin{harmonic}x", trig_feature(harmonic, np.sin)
            self.daily_maxes[name] = f(self.daily_maxes["cumulative_hr"])
            functions[name] = f
            names.append(name)

        self.feature_functions = functions
        self.feature_names = names

    _CURVE_PRESETS = {
        "sf": {"period_scale": 0.8, "q_max": 0.9, "q_min": 0.25},
        "houston": {"period_scale": 0.8, "q_max": 0.9, "q_min": 0.05},
    }

    def max_min_curve_interpolate(
        self, num_feature_functions=1, percentile=0.8, plot_curve=False,
        use_preset_params=True, params="sf",
    ):
        """Fit seasonal upper/lower quantile curves over the daily maxima."""
        if use_preset_params:
            if params not in self._CURVE_PRESETS:
                raise NameError(
                    "If use_preset_params is True, params must be one of "
                    "{'sf','houston'} denoting preset parameters"
                )
            chosen = self._CURVE_PRESETS[params]
        else:
            if not isinstance(params, dict):
                raise TypeError(f"params must be a dict of parameters, not ({params})")
            chosen = params
        period_scale = chosen["period_scale"]
        q_max, q_min = chosen["q_max"], chosen["q_min"]

        if not 0.0 <= percentile <= 1.0:
            raise ValueError(f"percentile must be in [0,1], is ({percentile})")

        self._add_feature_columns(
            num_feature_functions=num_feature_functions, period_scale=period_scale
        )

        features = self.daily_maxes[self.feature_names]
        targets = self.daily_maxes["max_GHI"]

        self.interpolated_coef = {
            "max": pd.Series(
                quantile_regression_fit(targets, features.values, q_max),
                index=self.feature_names,
            ),
            "min": pd.Series(
                quantile_regression_fit(targets, features.values, q_min),
                index=self.feature_names,
            ),
        }
        self.interpolated = True

    def _eval_curve(self, coef, cumul_times):
        y = pd.Series(data=[0.0] * len(cumul_times), name="Upper Bound Values")
        for name in self.feature_names:
            y += coef[name] * self.feature_functions[name](cumul_times)
        if len(y) == 1:
            return y[0]
        return y

    def most_light_curve_eval(self, max_min, cumulative_hours=None, day_hour_pairs=None):
        if max_min not in ("max", "min"):
            raise ValueError(f"max_min must be one of 'max' or 'min', is {max_min}")
        coef = self.interpolated_coef[max_min]

        results = []
        if cumulative_hours is not None:
            results.append(self._eval_curve(coef, pd.Series(data=cumulative_hours)))

        if day_hour_pairs is not None:
            cumul_times = []
            for pair in day_hour_pairs:
                if len(pair) != 2:
                    raise ValueError(
                        "pairs must be array-like of length two, containing days and hours"
                    )
                if pair[1] < 0 or pair[1] >= 24:
                    raise ValueError(f"hour must be in [0,23], is ({pair[1]})")
                cumul_times.append(pair[0] * 24 + pair[1])
            results.append(self._eval_curve(coef, pd.Series(data=cumul_times)))

        if len(results) == 1:
            return results[0]
        return results

    # ------------------------------------------------------------ sampling
    def _day_window(self, column):
        """(dawn, solar noon, dusk) hours of one day's profile."""
        night_hours = np.where(column == 0)[0]
        following = np.roll(night_hours, -1)
        dawn_index = np.where(night_hours + 1 != following)[0][0]
        dawn = night_hours[dawn_index]
        dusk = night_hours[dawn_index + 1]
        return dawn, (dawn + dusk) / 2.0, dusk

    def _curve_bounds(self, day, solar_noon):
        lower = self.most_light_curve_eval(
            max_min="min", day_hour_pairs=((day, solar_noon),)
        )
        upper = self.most_light_curve_eval(
            max_min="max", day_hour_pairs=((day, solar_noon),)
        )
        if lower < 0:
            if upper < 0:
                lower, upper = -max(lower, upper), -min(lower, upper)
                upper, lower = lower, upper
            else:
                lower = 0
        return lower, upper

    def _draw_peak(self, noise_type, noise_parameters, lower_b, upper_b):
        """One peak draw plus the distribution bounds used."""
        spread = upper_b - lower_b
        low = lower_b + noise_parameters["lower"] * spread
        high = upper_b + (noise_parameters["upper"] - 1) * spread

        if noise_type == "uniform":
            return np.random.uniform(low=low, high=high), low, high
        if noise_type == "triangular":
            if "mode" in noise_parameters:
                mode_param = noise_parameters["mode"]
                if not 0 <= mode_param <= 1:
                    raise ValueError(
                        f"mode parameter ({mode_param}) invalid, must be scale "
                        f"value in [0,1]"
                    )
                mode = spread * mode_param + lower_b
            else:
                mode = 0.5 * (lower_b + upper_b)
            return np.random.triangular(left=low, mode=mode, right=high), low, high
        raise RuntimeError(
            f"Fell through in noise_types, unable to recognize ({noise_type})"
        )

    def _sample_parabola(self, noise_type, noise_parameters, verbose,
                         push_peak_val=False, push_peak_ratio=0.5):
        noisy_data = self.data.copy()
        lower_bounds, upper_bounds = [], []

        for day in noisy_data.columns:
            if noisy_data[day][0] != 0:
                raise RuntimeError(
                    f"It appears that it is sunny at midnight of day ({day}). No good."
                )
            if noisy_data[day][23] != 0:
                raise RuntimeError(
                    f"It appears that it is sunny at 11PM of day ({day}). No good."
                )

            dawn, solar_noon, dusk = self._day_window(noisy_data[day])
            lower_b, upper_b = self._curve_bounds(day, solar_noon)

            peak_val, low, high = self._draw_peak(
                noise_type, noise_parameters, lower_b, upper_b
            )
            lower_bounds.append(low)
            upper_bounds.append(high)

            if push_peak_val:
                peak_val = peak_val + push_peak_ratio * (
                    self.daily_maxes.loc[day, "max_GHI"] - peak_val
                )

            anchor_x = np.array([dawn, solar_noon, dusk])
            anchor_y = np.array([0, peak_val, 0])
            if any(np.diff(anchor_x) <= 0):
                raise RuntimeError(
                    "Something is wrong in interpolating daily curves, have "
                    f"dawn/peak/dusk times as ({anchor_x}), not in order"
                )

            daily_curve = interp1d(
                anchor_x, anchor_y, kind="quadratic", bounds_error=False, fill_value=0
            )
            noisy_data[day] = daily_curve(noisy_data.index)

        self.parabolic_baseline = noisy_data.copy()
        self.distribution_bounds = (lower_bounds, upper_bounds)
        return noisy_data, lower_bounds, upper_bounds

    def sample(
        self,
        noise_types=("uniform", "gaussian"),
        noise_params=({"lower": 0, "upper": 1}, {"std_ratio": 0.05}),
        return_stacked_data=True,
        verbose=False,
        push_peak_val=False,
        push_peak_ratio=0.5,
        push_individual_vals=False,
        push_individual_ratio=0.5,
        **kwargs,
    ):
        allowed_noises = {0: (None, "uniform", "triangular"), 1: (None, "gaussian")}
        noise_parameters = ({"lower": 0, "upper": 1, "mode": 0.5}, {"std_ratio": 0.05})

        for j, noise in enumerate(noise_types):
            if noise not in allowed_noises[j]:
                raise ValueError(
                    f"Noise ({noise}) not recognized in position ({j}), must be one "
                    f"of {allowed_noises[j]}"
                )

        if not self.munged:
            self.data_munge()
        if not self.interpolated:
            self.max_min_curve_interpolate()

        if len(noise_params) != 2:
            raise TypeError("Unable to parse noise_params, must be array-like length 2")
        for j, overrides in enumerate(noise_params):
            if overrides is None:
                continue
            if not isinstance(overrides, dict):
                raise TypeError(
                    f"Element ({j}) in noise_params must be None or dict, is {type(overrides)}"
                )
            for key in noise_parameters[j].keys():
                if key in overrides.keys():
                    noise_parameters[j][key] = overrides[key]

        if noise_types[0] is None:
            if self.parabolic_baseline is None:
                raise ValueError("noise_types[0] is None, but there is no stored baseline")
            noisy_data = self.parabolic_baseline.copy()
        else:
            noisy_data, _, _ = self._sample_parabola(
                noise_types[0], noise_parameters[0], verbose,
                push_peak_val=push_peak_val, push_peak_ratio=push_peak_ratio,
            )

        if noise_types[1] == "gaussian":
            noisy_data += np.random.normal(
                scale=noise_parameters[1]["std_ratio"] * noisy_data
            )

        if not return_stacked_data:
            return noisy_data

        stacked = noisy_data.transpose().stack().reset_index()
        stacked = stacked.drop(columns=["hour", "day"])
        assert len(stacked.columns) == 1
        stacked.columns = ["pv"]

        stacked = self._check_sample(stacked, verbose=verbose)
        if push_individual_vals:
            underlying = self.unmunged_data[self.unmunged_data.columns[0]]
            stacked["pv"] += push_individual_ratio * (underlying - stacked["pv"])
        return stacked


class NoisyLoadData(_NoisySeriesData):
    _FALLBACK_COLUMN = "Electricity:Facility [kW](Hourly)"

    def __init__(self, load_data=None, file_name=None):
        super().__init__(known_data=load_data, file_name=file_name)
        # legacy quirk kept: num_hours reflects the *untruncated* input
        self.data = self.data.iloc[:8760]
        self.unmunged_data = self.unmunged_data.iloc[:8760]
        self.num_hours = len(load_data) if load_data is not None else len(self.data)

    def _negative_fill_value(self):
        return self.unmunged_data.min().squeeze()

    def _negative_fill_message(self, count):
        return (
            f"Found {count} negative values in load_data, forcing them "
            f"to be min of underlying data"
        )

    def data_munge(self, verbose=False):
        col_name = self._value_column("load_data")
        hours, days = _hour_day_columns(self.num_hours)
        self.data = self.data.copy()
        self.data["hour"] = pd.Series(data=hours)
        self.data["day"] = pd.Series(data=days)
        self.data = self.data.pivot(index="day", columns="hour", values=col_name)
        self.data["day_of_week"] = self.data.index % 7

        self.load_mean = self.data.groupby(["day_of_week"]).mean()
        self.load_std = self.data.groupby(["day_of_week"]).std().fillna(value=0)
        self.munged = True

    def sample(self, distribution="gaussian", load_variance_scale=1.0,
               return_stacked=True, verbose=False, **kwargs):
        if not self.munged:
            self.data_munge()

        if distribution != "gaussian":
            raise ValueError(
                f"distribution {distribution} not recognized, must be one of ('gaussian',)"
            )

        day_of_week = self.data["day_of_week"]
        hour_cols = self.data.columns[:-1]
        hourly_mean = self.load_mean.loc[day_of_week, hour_cols].to_numpy()
        hourly_std = self.load_std.loc[day_of_week, hour_cols].to_numpy()

        drawn = pd.DataFrame(
            data=np.random.normal(loc=hourly_mean, scale=load_variance_scale * hourly_std),
            index=self.data.index,
            columns=hour_cols,
        )
        if not return_stacked:
            return drawn

        stacked = drawn.stack().reset_index()
        stacked = stacked.drop(columns=["day", "hour"])
        assert len(stacked.columns) == 1
        stacked.columns = ["load"]
        return self._check_sample(stacked, verbose=verbose)


class NoisyGridData:
    def __init__(self, grid_data, dist_type="markov"):
        if not isinstance(grid_data, (pd.DataFrame, pd.Series)):
            raise TypeError(f"grid_data must be of type pd.DataFrame, is {type(grid_data)}")
        binary = (grid_data == 1) | (grid_data == 0)
        if not np.asarray(binary).all():
            raise ValueError("Non-binary values found in grid_data")
        if dist_type not in ("naive", "markov"):
            raise TypeError(
                f"dist type ({dist_type}) not recognized, must be one of ('naive', 'markov')"
            )

        self.dist_type = dist_type
        self.data = grid_data.copy()
        self.unmunged_data = grid_data.copy()
        self.has_distribution = False
        self.transition_prob_matrix = None
        self.occurrences = None

    def learn_distribution(self):
        if self.dist_type == "naive":
            up_fraction = float(np.asarray(self.data.mean()).squeeze())
            self.transition_prob_matrix = np.array([1 - up_fraction, up_fraction])
        else:  # 2-state markov chain over consecutive statuses
            statuses = np.asarray(self.data).reshape(-1)
            counts = np.zeros((2, 2))
            visits = np.zeros(2)
            for here, there in zip(statuses[:-1], statuses[1:]):
                counts[int(here), int(there)] += 1
                visits[int(here)] += 1

            for s in (0, 1):
                if visits[s] > 0:
                    counts[s, :] /= visits[s]
                else:
                    counts[s, s] = 1
            self.occurrences = visits
            self.transition_prob_matrix = counts

        self.has_distribution = True

    def sample(self):
        if not self.has_distribution:
            self.learn_distribution()

        if self.dist_type == "naive":
            drawn = np.random.choice(
                [0, 1], size=len(self.data), p=self.transition_prob_matrix
            )
        else:
            drawn = np.zeros(len(self.data))
            start_probs = self.occurrences / np.sum(self.occurrences)
            drawn[0] = np.random.choice([0, 1], p=start_probs)
            for j in range(1, len(self.data)):
                step_probs = self.transition_prob_matrix[int(drawn[j - 1]), :]
                drawn[j] = np.random.choice([0, 1], p=step_probs)

        return pd.Series(data=drawn, name="grid")


class SampleGenerator:
    def __init__(self, microgrid, **forecast_args):
        self.microgrid = microgrid
        self.NPV = NoisyPVData(pv_data=self.microgrid._pv_ts)
        self.NL = NoisyLoadData(load_data=self.microgrid._load_ts)
        if self.microgrid.architecture["grid"] != 0:
            self.NG = NoisyGridData(grid_data=self.microgrid._grid_status_ts)
        else:
            self.NG = None
        self.underlying_data = return_underlying_data(self.microgrid)
        self.forecasts = self.create_forecasts(**forecast_args)
        self.samples = None

    def create_forecasts(self, pv_args=None, load_args=None, preset_to_use=None,
                         print_mape=False, **forecast_args):
        if pv_args is None and load_args is None and preset_to_use is not None:
            preset = ForecastArgSet(preset_to_use=preset_to_use)
            pv_args = preset["pv_args"]
            load_args = preset["load_args"]
        else:
            pv_args = pv_args or dict()
            load_args = load_args or dict()

        pv_forecast = self.NPV.sample(**pv_args)
        load_forecast = self.NL.sample(**load_args)

        if self.microgrid.architecture["grid"] != 0:
            grid_forecast = self.NG.sample()
        else:
            grid_forecast = pd.Series(
                data=[0] * len(self.microgrid._load_ts), name="grid"
            )

        forecast = pd.concat([pv_forecast, load_forecast, grid_forecast], axis=1)

        if print_mape:
            print(f"MAPE: {self.validate_forecasts(forecasts=forecast, aggregate=True)}")

        if hasattr(self, "forecasts"):
            self.forecasts = forecast
        else:
            return forecast

    def validate_forecasts(self, forecasts=None, aggregate=False):
        if forecasts is None:
            forecasts = self.forecasts
        mape_vals = {
            col: self.mape(self.underlying_data[col], forecasts[col])
            for col in ("pv", "load")
        }
        if aggregate:
            return np.sqrt(np.mean(np.array(list(mape_vals.values())) ** 2))
        return mape_vals

    def mape(self, actual_vals, forecast_vals):
        actual_vals = np.asarray(actual_vals).reshape(-1)
        forecast_vals = np.asarray(forecast_vals).reshape(-1)
        ratios = np.abs((actual_vals - forecast_vals) / actual_vals)
        return np.mean(ratios[~np.isnan(ratios)])

    def sample_from_forecasts(self, n_samples=10, verbose=False, **sampling_args):
        pv_sampler = self.NPV
        load_sampler = NoisyLoadData(load_data=self.forecasts["load"])
        grid_sampler = NoisyGridData(grid_data=self.forecasts["grid"])

        sampling_args.setdefault("noise_types", (None, "gaussian"))

        samples = []
        for j in range(n_samples):
            if verbose:
                print(f"Creating sample {j}")
            drawn = pd.concat(
                [
                    pv_sampler.sample(**sampling_args),
                    load_sampler.sample(**sampling_args),
                    grid_sampler.sample(),
                ],
                axis=1,
            )
            usable = min(
                len(pv_sampler.unmunged_data),
                len(load_sampler.unmunged_data),
                len(grid_sampler.unmunged_data),
            )
            samples.append(drawn.iloc[:usable])

        self.samples = samples
        return samples


class ForecastArgSet(dict):
    _PUSH_RATIO_PRESETS = {50: 0.5, 70: 0.65, 85: 1.0}

    def __init__(self, pv_param_set=None, load_param_set=None, preset_to_use=None):
        if pv_param_set is None and load_param_set is None and preset_to_use is not None:
            super().__init__(self.get_preset(preset_to_use))
        elif pv_param_set is not None and load_param_set is not None and preset_to_use is None:
            super().__init__(pv_args=pv_param_set, load_args=load_param_set)
        else:
            raise KeyError("Unable to parse inputs")
        self.mape_vals = []
        self.mape_mean = None
        self.mape_std = None

    def update_with_mape(self, mape):
        self.mape_vals.append(mape)
        self.mape_mean = np.mean(self.mape_vals)
        self.mape_std = np.std(self.mape_vals)

    def get_preset(self, forecast_accuracy=50):
        if forecast_accuracy not in self._PUSH_RATIO_PRESETS:
            raise ValueError(
                f"do not have relevant sampling parameters for forecast accuracy "
                f"{forecast_accuracy}, must be one of (50, 70, 85)"
            )
        return {
            "pv_args": {
                "noise_params": ({"lower": 0.0, "upper": 0.5}, {"std_ratio": 0.25}),
                "push_peak_val": True,
                "push_peak_ratio": 0.0,
                "push_individual_vals": True,
                "push_individual_ratio": self._PUSH_RATIO_PRESETS[forecast_accuracy],
            },
            "load_args": {"load_variance_scale": 2.0},
        }

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self.mape_mean == other.mape_mean

    def __lt__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self.mape_mean < other.mape_mean

    def __gt__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self.mape_mean > other.mape_mean


class ForecastArgs:
    def __init__(self, num_pv_noise_params_0, num_pv_std_ratio, num_load_variance_scale,
                 num_push_peak_ratio, num_push_individual_ratio,
                 max_load_var_scale=2.0, max_pv_std_ratio=0.5):
        pv_params = self.pv_parameters(
            num_pv_noise_params_0, num_pv_std_ratio, num_push_peak_ratio,
            num_push_individual_ratio, max_std_ratio=max_pv_std_ratio,
        )
        load_params = self.load_parameters(
            num_load_variance_scale, max_load_var_scale=max_load_var_scale
        )
        self.param_sets = self.combine_sets(pv_params, load_params)

    def pv_parameters(self, num_noise_params_0, num_std_ratio, num_push_peak_ratio,
                      num_push_individual_ratio, max_std_ratio=0.5):
        pv_params = []
        for individual_ratio in np.linspace(0, 1, num_push_individual_ratio):
            for peak_ratio in np.linspace(0, 1, num_push_peak_ratio):
                for std_ratio in np.linspace(0, max_std_ratio, num_std_ratio):
                    for lower in np.linspace(0, 1, num_noise_params_0):
                        for upper in np.linspace(1, lower, num_noise_params_0):
                            if upper >= lower:
                                pv_params.append(
                                    dict(
                                        noise_params=(
                                            dict(lower=lower, upper=upper),
                                            dict(std_ratio=std_ratio),
                                        ),
                                        push_peak_val=True,
                                        push_peak_ratio=peak_ratio,
                                        push_individual_vals=True,
                                        push_individual_ratio=individual_ratio,
                                    )
                                )
        return pv_params

    def load_parameters(self, num_load_variance_scale, max_load_var_scale=2.0):
        return [
            dict(load_variance_scale=v)
            for v in np.linspace(0, max_load_var_scale, num_load_variance_scale)
        ]

    def combine_sets(self, pv_params, load_params):
        return [
            ForecastArgSet(pv_param_set=pv, load_param_set=ld)
            for pv in pv_params
            for ld in load_params
        ]
