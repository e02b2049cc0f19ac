"""The port's own numpy host layer against the JAX package's, bitwise (CPU).

The port carries a copy of the host layer (modules, microgrid, forecasters,
host envs and controllers, spec extraction, suite normalization, the legacy
converters and sample generators) so that it imports nothing of the JAX
package.  Here each copy is held against its original on the same inputs:
the same scenario files, the same actions, the same ``np.random`` seeds.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pandas as pd
import pytest

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu.algos import ModelPredictiveControl as JaxHostMPC
from pymgrid_tpu.algos import RuleBasedControl as JaxHostRBC
from pymgrid_tpu.core.spec import extract_spec as jax_extract_spec
from pymgrid_tpu.envs import ContinuousMicrogridEnv as JaxContinuousMicrogridEnv
from pymgrid_tpu.envs import DiscreteMicrogridEnv as JaxDiscreteMicrogridEnv
from pymgrid_tpu.parallel.suite import build_suite as jax_build_suite
from pymgrid_tpu.parallel.suite import normalize_to_superset as jax_normalize
from pymgrid_tpu.utils.data_generator import SampleGenerator as JaxSampleGenerator
from pymgrid_tpu_torch.algos import ModelPredictiveControl, RuleBasedControl
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel.suite import build_suite, normalize_to_superset
from pymgrid_tpu_torch.utils.data_generator import SampleGenerator

warnings.filterwarnings("ignore")


def _assert_tree_equal(got, want, path=()):
    """Nested dicts of arrays: the same keys, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], path + (k,))
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=str(path))


def _assert_spec_equal(spec, jspec):
    assert type(spec).__module__.startswith("pymgrid_tpu_torch.")
    assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)


def _frames_equal(got, want):
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_column_type=False)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("scenario", range(25))
def test_extract_spec_matches_jax(scenario, dtype):
    spec, params, state0 = extract_spec(pymgrid_tpu_torch.Microgrid.from_scenario(scenario),
                                        dtype=dtype)
    jspec, jparams, jstate0 = jax_extract_spec(pymgrid_tpu.Microgrid.from_scenario(scenario),
                                               dtype=dtype)
    _assert_spec_equal(spec, jspec)
    _assert_tree_equal(params, jparams)
    _assert_tree_equal(state0, jax.tree.map(np.asarray, jstate0))


@pytest.mark.parametrize("include_genset", [True, False])
def test_normalize_to_superset_matches_jax(include_genset):
    """Every scenario normalized onto the superset structure (neutral grid
    and genset slots) extracts to the JAX package's spec and params."""
    for n in range(25):
        ours = normalize_to_superset(pymgrid_tpu_torch.Microgrid.from_scenario(n),
                                     include_genset=include_genset)
        want = jax_normalize(pymgrid_tpu.Microgrid.from_scenario(n),
                             include_genset=include_genset)
        assert type(ours).__module__.startswith("pymgrid_tpu_torch.")
        spec, params, _ = extract_spec(ours)
        jspec, jparams, _ = jax_extract_spec(want)
        _assert_spec_equal(spec, jspec)
        _assert_tree_equal(params, jparams)


def test_build_suite_matches_jax():
    """All 25 scenarios in one suite: the same spec, and every JAX params
    leaf bitwise in the port's (which also carries its step tables)."""
    jspec, jparams = jax_build_suite(
        [pymgrid_tpu.Microgrid.from_scenario(n) for n in range(25)], dtype=np.float64)
    spec, params = build_suite(
        [pymgrid_tpu_torch.Microgrid.from_scenario(n) for n in range(25)], "float64", "cpu")
    _assert_spec_equal(spec, jspec)

    def compare(want, got, path):
        if isinstance(want, dict):
            for k in want:
                compare(want[k], got[k], path + (k,))
            return
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(path))

    compare(jparams, params, ())


@pytest.mark.parametrize("scenario", [0, 1])
def test_host_rbc_log_matches_jax(scenario):
    """Scenario 0 (strong grid) and 1 (genset, grid outages)."""
    ours = RuleBasedControl(pymgrid_tpu_torch.Microgrid.from_scenario(scenario)).run(
        max_steps=200)
    want = JaxHostRBC(pymgrid_tpu.Microgrid.from_scenario(scenario)).run(max_steps=200)
    assert len(ours) == 200
    _frames_equal(ours, want)


def _step_both(env, jenv, actions):
    for t, action in enumerate(actions):
        obs, reward, done, _ = env.step(action)
        jobs, jreward, jdone, _ = jenv.step(action)
        np.testing.assert_array_equal(np.asarray(obs), np.asarray(jobs), err_msg=f"step {t}")
        assert reward == jreward and done == jdone, f"step {t}"


@pytest.mark.parametrize("scenario", [0, 1])
def test_host_discrete_env_matches_jax(scenario):
    env = DiscreteMicrogridEnv.from_scenario(scenario)
    jenv = JaxDiscreteMicrogridEnv.from_scenario(scenario)
    assert env.action_space.n == jenv.action_space.n
    actions = np.random.RandomState(scenario).randint(env.action_space.n, size=50)
    _step_both(env, jenv, [int(a) for a in actions])


@pytest.mark.parametrize("scenario", [0, 1])
def test_host_continuous_env_matches_jax(scenario):
    env = ContinuousMicrogridEnv.from_scenario(scenario)
    jenv = JaxContinuousMicrogridEnv.from_scenario(scenario)
    dim = env.action_space.shape[0]
    assert dim == jenv.action_space.shape[0]
    _step_both(env, jenv, np.random.RandomState(10 + scenario).rand(50, dim))


def test_host_mpc_matches_jax():
    """Scenario 1's host HiGHS MILP MPC (the port's BatchedMPC fallback and
    chip_smoke.py's reference), three steps."""
    ours = ModelPredictiveControl(pymgrid_tpu_torch.Microgrid.from_scenario(1)).run(
        max_steps=3)
    want = JaxHostMPC(pymgrid_tpu.Microgrid.from_scenario(1)).run(max_steps=3)
    _frames_equal(ours, want)


def test_sample_generator_matches_jax():
    """The legacy SAA sample generators draw from the global ``np.random``:
    the same seed gives the same two samples."""
    def draw(gen_cls, pkg):
        state = np.random.get_state()
        np.random.seed(0)
        try:
            gen = gen_cls(pkg.Microgrid.from_scenario(0).to_nonmodular(), preset_to_use=85)
            return gen.sample_from_forecasts(n_samples=2)
        finally:
            np.random.set_state(state)

    ours, want = draw(SampleGenerator, pymgrid_tpu_torch), draw(JaxSampleGenerator, pymgrid_tpu)
    assert len(ours) == len(want) == 2
    for got, exp in zip(ours, want):
        _frames_equal(got, exp)


def test_each_package_loads_its_own_classes():
    """The YAML tags (``!Microgrid``, ``!BatteryModule``, ...) live on each
    package's own loader: one scenario loaded through both packages in one
    process, and one package's dump loaded by the other, give each loader
    its own package's classes."""
    from pymgrid_tpu.utils.serialize import PymgridLoader as JaxLoader
    from pymgrid_tpu_torch.utils.serialize import PymgridLoader

    assert PymgridLoader is not JaxLoader
    ours = pymgrid_tpu_torch.Microgrid.from_scenario(1)
    want = pymgrid_tpu.Microgrid.from_scenario(1)
    for mg, pkg in ((ours, "pymgrid_tpu_torch"), (want, "pymgrid_tpu")):
        assert type(mg).__module__.split(".")[0] == pkg
        for name, modules in mg.modules.iterdict():
            for module in modules:
                assert type(module).__module__.split(".")[0] == pkg, name
    # a short microgrid keeps the inline YAML small
    short = lambda pkg: pkg.Microgrid([pkg.modules.BatteryModule(
        min_capacity=0, max_capacity=10, max_charge=5, max_discharge=5, efficiency=0.9,
        init_soc=0.5), pkg.modules.LoadModule(time_series=np.arange(5.0))])
    crossed = pymgrid_tpu_torch.Microgrid.load(short(pymgrid_tpu).dump())
    assert type(crossed.battery[0]).__module__.split(".")[0] == "pymgrid_tpu_torch"
    back = pymgrid_tpu.Microgrid.load(short(pymgrid_tpu_torch).dump())
    assert type(back.battery[0]).__module__.split(".")[0] == "pymgrid_tpu"
