"""The port's public import surface: the ``SURFACE`` table of
tests/test_public_api.py with the package renamed, so reference user code
ports to ``pymgrid_tpu_torch`` with a package rename alone."""
import importlib
import inspect
import pkgutil
import re
from pathlib import Path

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


# --------------------------------------------------------- parameter names
# the JAX package's module names that the port renamed
MODULE_RENAMES = {"mpc_jax": "mpc_batched", "saa_jax": "saa_batched",
                  "pallas_rollout": "rbc_rollout"}
NAME_RENAMES = {("pymgrid_tpu.ops.pallas_rollout", "make_pallas_rbc_rollout"): "make_rbc_rollout"}
TPU_ONLY_MODULES = {"pymgrid_tpu.utils.layout", "pymgrid_tpu.utils.relay_guard"}
# (JAX module, function or Class.method, parameter): why the port has no such
# parameter.  Each names a JAX or TPU object with no counterpart on the port.
NOT_PORTED = {
    ("pymgrid_tpu.core.engine", "ts_obs_part", "jnp"):
        "the array namespace to trace with; the port computes in torch only",
    ("pymgrid_tpu.core.engine", "ts_obs_part", "dtype"):
        "the output dtype of that namespace; the port's tensors carry their own",
    ("pymgrid_tpu.ops.pallas_rollout", "make_pallas_rbc_rollout", "interpret"):
        "Pallas interpret mode; the port's wrapper runs the plain version on CPU tensors",
    ("pymgrid_tpu.parallel.batch", "make_batch_mesh", "axis_name"):
        "a JAX mesh axis; the port's mesh is the torch.distributed job's ranks",
    ("pymgrid_tpu.parallel.batch", "make_batch_mesh", "devices"):
        "JAX device objects; each rank of the port's job owns one device",
    ("pymgrid_tpu.parallel.distributed", "global_batch_mesh", "axis_name"):
        "a JAX mesh axis; the port's mesh is the torch.distributed job's ranks",
    ("pymgrid_tpu.parallel.distributed", "from_process_local", "axis_name"):
        "a JAX mesh axis; the port's mesh is the torch.distributed job's ranks",
    ("pymgrid_tpu.utils.profiling", "trace", "create_perfetto_link"):
        "uploads the trace to the Perfetto UI; the port writes a Chrome trace file",
}


# (JAX program, flag): why the port's twin of the program has no such flag
_PLATFORM_SWITCH = ("JAX's platform switch; the twin's --device takes its place "
                    "(the card by default, cpu on request)")
NOT_PORTED_FLAGS = {
    ("tools/profile_env.py", "--tpu"): _PLATFORM_SWITCH,
    ("examples/scenario0_structure.py", "--cpu"): _PLATFORM_SWITCH,
    ("examples/train_rl.py", "--cpu"): _PLATFORM_SWITCH,
    ("examples/train_es.py", "--cpu"): _PLATFORM_SWITCH,
}


def _port_path(name):
    parts = name.split(".")
    return ".".join(["pymgrid_tpu_torch"] + [MODULE_RENAMES.get(p, p) for p in parts[1:]])


def _parameters(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):   # builtins without a signature
        return None


def _signature_gaps():
    """``{(JAX module, name, parameter or None): what the port lacks}`` over
    every public function and class (its ``__init__`` and public methods)
    defined in a module of the JAX package: a missing object or a missing
    parameter name."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pymgrid_tpu

    gaps = {}
    for info in pkgutil.walk_packages(pymgrid_tpu.__path__, "pymgrid_tpu."):
        if info.name in TPU_ONLY_MODULES:
            continue
        jax_mod = importlib.import_module(info.name)
        port_mod = importlib.import_module(_port_path(info.name))
        for name, obj in vars(jax_mod).items():
            if (name.startswith("_") or getattr(obj, "__module__", None) != info.name
                    or not (inspect.isfunction(obj) or inspect.isclass(obj))):
                continue
            port_obj = getattr(port_mod, NAME_RENAMES.get((info.name, name), name), None)
            if port_obj is None:
                gaps[(info.name, name, None)] = "missing"
                continue
            pairs = [(name, obj, port_obj)]
            if inspect.isclass(obj):
                for member, fn in inspect.getmembers(obj, inspect.isfunction):
                    if member.startswith("_") and member != "__init__":
                        continue
                    port_fn = getattr(port_obj, member, None)
                    if port_fn is None:
                        gaps[(info.name, f"{name}.{member}", None)] = "missing"
                    else:
                        pairs.append((f"{name}.{member}", fn, port_fn))
            for label, fn, port_fn in pairs:
                want, got = _parameters(fn), _parameters(port_fn)
                if want is None or got is None:
                    continue
                for p in want:
                    if p not in got:
                        gaps[(info.name, label, p)] = "missing"
    return gaps


def test_port_takes_every_parameter_of_the_jax_package():
    """Every public function and method of the JAX package exists in the
    port under the renamed module, and takes every parameter name of the
    JAX one, so user code ports with the renames alone (the port may take
    more, such as ``device``, and needs ``dtype`` where JAX defaults it);
    ``NOT_PORTED`` lists the exceptions, each with its reason, and holds no
    entry that is no longer a gap."""
    gaps = _signature_gaps()
    unexplained = {k: v for k, v in gaps.items() if k not in NOT_PORTED}
    assert not unexplained, unexplained
    assert set(NOT_PORTED) <= set(gaps), set(NOT_PORTED) - set(gaps)


def _flags(path):
    return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', path.read_text()))


def test_program_twins_take_every_flag_of_the_jax_programs():
    """Every program of the repository's ``tools/`` and ``examples/`` that has
    a twin in the port (same file name) takes each flag of the JAX program;
    ``NOT_PORTED_FLAGS`` lists the exceptions, each with its reason, and
    holds no entry that is no longer a gap."""
    repo = Path(__file__).resolve().parents[1]
    gaps, twins = set(), []
    for folder in ("tools", "examples"):
        for program in sorted((repo / folder).glob("*.py")):
            twin = repo / "pymgrid_tpu_torch" / folder / program.name
            if twin.exists():
                twins.append(f"{folder}/{program.name}")
                gaps |= {(twins[-1], flag) for flag in _flags(program) - _flags(twin)}
    assert {"tools/run_benchmarks.py", "tools/profile_env.py"} <= set(twins)
    assert gaps == set(NOT_PORTED_FLAGS), gaps ^ set(NOT_PORTED_FLAGS)
