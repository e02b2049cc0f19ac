"""The port's public import surface: the ``SURFACE`` table of
tests/test_public_api.py with the package renamed, so reference user code
ports to ``pymgrid_tpu_torch`` with a package rename alone."""
import importlib

import pytest

SURFACE = {
    "pymgrid_tpu_torch": ["Microgrid", "MicrogridGenerator", "NonModularMicrogrid", "envs",
                          "add_pymgrid_yaml_representers", "__version__"],
    "pymgrid_tpu_torch.generator": ["MicrogridGenerator"],
    "pymgrid_tpu_torch.modules": [
        "BaseMicrogridModule",
        "BaseTimeSeriesMicrogridModule",
        "BatteryModule",
        "GensetModule",
        "GridModule",
        "LoadModule",
        "RenewableModule",
        "UnbalancedEnergyModule",
        "Container",
        "ModuleContainer",
        "ModuleList",
        "get_subcontainers",
    ],
    "pymgrid_tpu_torch.microgrid": ["Microgrid", "MicrogridStep", "DEFAULT_HORIZON"],
    "pymgrid_tpu_torch.microgrid.trajectory": [
        "BaseTrajectory",
        "DeterministicTrajectory",
        "StochasticTrajectory",
        "FixedLengthStochasticTrajectory",
    ],
    "pymgrid_tpu_torch.microgrid.reward_shaping": [
        "BaseRewardShaper",
        "BatteryDischargeShaper",
        "PVCurtailmentShaper",
    ],
    "pymgrid_tpu_torch.convert": [
        "to_modular",
        "to_nonmodular",
        "get_module",
        "check_viability",
        "get_empty_params",
        "finalize_params",
        "add_params_from_module",
    ],
    "pymgrid_tpu_torch.envs": [
        "BaseMicrogridEnv",
        "DiscreteMicrogridEnv",
        "ContinuousMicrogridEnv",
    ],
    "pymgrid_tpu_torch.algos": [
        "RuleBasedControl",
        "ModelPredictiveControl",
        "SampleAverageApproximation",
        "NonModularRuleBasedControl",
        "PriorityListAlgo",
        "PriorityListElement",
        "HorizonOutput",
        "ControlOutput",
        "Benchmarks",
    ],
    "pymgrid_tpu_torch.forecast": [
        "get_forecaster",
        "Forecaster",
        "UserDefinedForecaster",
        "OracleForecaster",
        "GaussianNoiseForecaster",
        "NoForecaster",
        "vectorize_scalar_forecaster",
    ],
    "pymgrid_tpu_torch.utils.data_generator": [
        "return_underlying_data",
        "NoisyPVData",
        "NoisyLoadData",
        "NoisyGridData",
        "SampleGenerator",
        "ForecastArgSet",
        "ForecastArgs",
    ],
    "pymgrid_tpu_torch.utils": ["add_pymgrid_yaml_representers"],
    "pymgrid_tpu_torch.utils.logger": ["ModularLogger"],
    "pymgrid_tpu_torch.utils.ray": ["ray_decorator"],
    "pymgrid_tpu_torch.utils.serialize": [
        "add_pymgrid_yaml_representers",
        "add_numpy_pandas_representers",
        "add_numpy_pandas_constructors",
        "add_path_to_arr_like",
        "dump_data",
        "NDArraySubclass",
    ],
    "pymgrid_tpu_torch.utils.space": ["ModuleSpace", "MicrogridSpace"],
    "pymgrid_tpu_torch.nonmodular": [
        "NonModularMicrogrid",
        "Battery",
        "Genset",
        "Grid",
        "in_ipynb",
    ],
    "pymgrid_tpu_torch.algos.nonmodular_rbc": ["NonModularRuleBasedControl"],
    "pymgrid_tpu_torch.legacy_envs": [
        "Environment",
        "CsplaMicroGridEnv",
        "CsdaMicroGridEnv",
        "MicrogridEnv",
        "ContinuousMicrogridEnv",
        "ContinuousMicrogridSampleEnv",
        "SafeExpMicrogridEnv",
        "SafeExpMicrogridSampleEnv",
        "normalize_environment_states",
        "sample_reset",
    ],
}


@pytest.mark.parametrize("module_path", sorted(SURFACE))
def test_public_names(module_path):
    mod = importlib.import_module(module_path)
    missing = [n for n in SURFACE[module_path] if not hasattr(mod, n)]
    assert not missing, f"{module_path} missing {missing}"


def test_surface_covers_the_jax_packages():
    """Every name of the JAX table is in the port's, under the renamed path,
    and the lazy package attributes resolve to the port's own objects."""
    from test_public_api import SURFACE as JAX_SURFACE

    import pymgrid_tpu_torch

    for path, names in JAX_SURFACE.items():
        ours = SURFACE[path.replace("pymgrid_tpu", "pymgrid_tpu_torch", 1)]
        assert set(names) <= set(ours), path
    assert pymgrid_tpu_torch.MicrogridGenerator.__module__ == "pymgrid_tpu_torch.generator"
    assert pymgrid_tpu_torch.envs.__name__ == "pymgrid_tpu_torch.envs"
    with pytest.raises(AttributeError, match="no attribute"):
        pymgrid_tpu_torch.not_a_name


def test_ray_decorator_retries_on_copies():
    import numpy as np

    from pymgrid_tpu_torch.utils.ray import ray_decorator

    @ray_decorator
    def set_first(arr):
        arr[0] = 1.0
        return arr

    frozen = np.zeros(3)
    frozen.flags.writeable = False
    np.testing.assert_array_equal(set_first(frozen), [1.0, 0.0, 0.0])
    assert not frozen.any()


def test_add_pymgrid_yaml_representers_idempotent():
    from pymgrid_tpu_torch.utils.serialize import add_pymgrid_yaml_representers

    add_pymgrid_yaml_representers()
    add_pymgrid_yaml_representers()


def test_in_ipynb_false_outside_notebook():
    from pymgrid_tpu_torch.nonmodular import in_ipynb

    assert in_ipynb() is False
