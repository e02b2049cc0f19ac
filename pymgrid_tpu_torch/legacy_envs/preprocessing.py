"""State normalization and sample-based resets for the legacy envs.

Mirror of ``src/pymgrid/_deprecated/Environments/Preprocessing.py``.
"""
import pandas as pd

__all__ = ["normalize_environment_states", "sample_reset"]


def normalize_environment_states(mg):
    """Per-state-key normalization constants (reference Preprocessing.py:3-25).

    Quirk kept: the grid co2/price maxima are taken over the *first row* of
    the series (``.values[0]``), i.e. they are just the initial values, and
    the export-price key normalizes by the *import* price.
    """
    max_values = {}
    for key in mg._df_record_state:
        if key == "hour":
            max_values[key] = 24
        elif key in ("capa_to_charge", "capa_to_discharge"):
            max_values[key] = mg.parameters.battery_capacity.values[0]
        elif key in ("grid_status", "battery_soc"):
            max_values[key] = 1
        elif key == "grid_co2":
            max_values[key] = max(mg._grid_co2.values[0])
        elif key == "grid_price_import":
            max_values[key] = max(mg._grid_price_import.values[0])
        elif key == "grid_price_export":
            max_values[key] = max(mg._grid_price_import.values[0])
        elif key == "load":
            max_values[key] = mg.parameters.load.values[0]
        elif key == "pv":
            max_values[key] = mg.parameters.PV_rated_power.values[0]
        else:
            max_values[key] = mg.parameters[key].values[0]
    return max_values


def sample_reset(has_grid, saa, microgrid, sampling_args=None):
    """Swap the microgrid's load/pv/grid series for a fresh SAA sample
    (reference Preprocessing.py:27-47)."""
    if sampling_args is None:
        sampling_args = dict()

    sample = saa.sample_from_forecasts(n_samples=1, **sampling_args)[0]

    microgrid._load_ts = pd.DataFrame(sample["load"])
    microgrid._pv_ts = pd.DataFrame(sample["pv"])
    microgrid._df_record_state["load"] = [sample["load"].iloc[0].squeeze()]
    microgrid._df_record_state["pv"] = [sample["pv"].iloc[0].squeeze()]
    if has_grid:
        microgrid._grid_status_ts = pd.DataFrame(sample["grid"])
        microgrid._df_record_state["grid_status"] = [sample["grid"].iloc[0].squeeze()]
