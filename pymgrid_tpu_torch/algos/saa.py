"""Sample Average Approximation stochastic MPC.

Behavioral mirror of ``src/pymgrid/algos/saa/saa.py``: sample N noisy
(pv, load, grid) futures, run one MPC horizon per sample per step, pick the
output at the ``optimal_percentile`` of horizon cost, and append it to a
running :class:`~pymgrid_tpu_torch.algos.control.ControlOutput`.  Operates on the
legacy nonmodular representation.  For the on-chip batched version see
:mod:`pymgrid_tpu_torch.algos.saa_batched`.
"""
import time

import numpy as np
import pandas as pd

from pymgrid_tpu_torch.algos.control import ControlOutput
from pymgrid_tpu_torch.algos.mpc import ModelPredictiveControl
from pymgrid_tpu_torch.utils.data_generator import SampleGenerator

__all__ = ["SampleAverageApproximation"]

_SAMPLE_COLUMNS = ("pv", "load", "grid")


class SampleAverageApproximation(SampleGenerator):
    def __init__(self, microgrid, control_duration=8760, **forecast_args):
        if control_duration > 8760:
            raise ValueError("control_duration must be less than 8760")
        super().__init__(microgrid, **forecast_args)
        self.control_duration = control_duration
        # Built lazily: the legacy sample envs construct an SAA purely for
        # sampling while the microgrid's horizon is 0 (csca.py sets it), and
        # an MPC problem cannot be assembled over an empty horizon.
        self._mpc = None

    @property
    def mpc(self):
        if self._mpc is None:
            self._mpc = ModelPredictiveControl(self.microgrid)
        return self._mpc

    def run(self, n_samples=10, forecast_steps=None, optimal_percentile=0.5,
            use_previous_samples=True, verbose=False, **kwargs):
        need_fresh_samples = not use_previous_samples or self.samples is None
        if need_fresh_samples:
            self.samples = self.sample_from_forecasts(n_samples=n_samples, **kwargs)

        started = time.time()
        output = self.run_mpc_on_group(
            self.samples,
            forecast_steps=forecast_steps,
            optimal_percentile=optimal_percentile,
            verbose=verbose,
        )
        if verbose:
            print(f"Running time: {round(time.time() - started)}")
        return output

    # ------------------------------------------------------------ internals
    def _resolve_forecast_steps(self, total_len, forecast_steps):
        available = total_len - self.microgrid.horizon
        if forecast_steps is None:
            return available
        if forecast_steps > available:
            raise ValueError(
                "forecast steps must be less than length of samples minus horizon"
            )
        return forecast_steps

    def _solve_horizon(self, sample, output, j):
        """Overwrite row j with realized data (saa.py:128), then one MPC
        horizon solve."""
        sample.iloc[j] = self.underlying_data.iloc[j]
        return self.mpc.mpc_single_step(sample, output, j)

    def _record_step(self, output, horizon_output, j):
        output.append(
            horizon_output,
            actual_load=self.underlying_data.loc[j, "load"],
            actual_pv=self.underlying_data.loc[j, "pv"],
            actual_grid=self.underlying_data.loc[j, "grid"],
        )

    @staticmethod
    def _validate_sample(sample):
        if not isinstance(sample, pd.DataFrame):
            raise TypeError("samples must be pd.DataFrame")
        if not all(needed in sample.columns.values for needed in _SAMPLE_COLUMNS):
            raise KeyError(
                f"samples must contain columns {_SAMPLE_COLUMNS}, currently "
                f"contains {sample.columns.values}"
            )

    def determine_optimal_actions(self, outputs=None, percentile=0.5, verbose=False):
        if percentile < 0.0 or percentile > 1.0:
            raise ValueError("percentile must be in [0,1]")

        pivot = int(np.floor(len(outputs) * percentile))
        partitioned = np.partition(outputs, pivot)

        if verbose:
            chosen = partitioned[pivot]
            for j, output in enumerate(np.sort(outputs)):
                print(
                    f"Output {j}, cost: {round(output.cost, 2)}, battery charge "
                    f"{round(output.first_dict['battery_charge'], 2)}, discharge "
                    f"{round(output.first_dict['battery_discharge'], 2)}:"
                )
                if output is chosen:
                    print(f"Selected output {j} with percentile {percentile}")

        return partitioned[pivot]

    # ------------------------------------------------------------- rollouts
    def run_mpc_on_group(self, samples, forecast_steps=None, optimal_percentile=0.5,
                         verbose=False):
        output = ControlOutput(alg_name="saa", empty=True, microgrid=self.microgrid)
        n_steps = self._resolve_forecast_steps(
            min(len(sample) for sample in samples), forecast_steps
        )

        for j in range(n_steps):
            if verbose:
                print(f"iter {j}")

            horizon_outputs = []
            for sample in samples:
                self._validate_sample(sample)
                horizon_outputs.append(self._solve_horizon(sample, output, j))

            best = self.determine_optimal_actions(
                outputs=horizon_outputs, percentile=optimal_percentile
            )
            self._record_step(output, best, j)

        return output

    def run_deterministic_on_forecast(self, forecast_steps=None, verbose=False):
        sample = self.forecasts.copy()
        output = ControlOutput(alg_name="mpc", empty=True, microgrid=self.microgrid)
        n_steps = self._resolve_forecast_steps(len(sample), forecast_steps)

        for j in range(n_steps):
            if verbose:
                print(f"iter {j}")
            self._record_step(output, self._solve_horizon(sample, output, j), j)
        return output
