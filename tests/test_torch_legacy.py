"""The port's copies of the legacy host modules against their originals in
the JAX package (CPU): the generator, the nonmodular rule-based control, the
host SAA, the ``Benchmarks`` runner, the six legacy gym-style environments
and the gymnasium adapter.

Each case builds its inputs in both packages from the same numpy seeds
(``np.random`` is re-seeded before each package's run) and holds every
output of the copy bitwise against the original's, in the patterns of
tests/test_saa_datagen.py, tests/test_legacy.py (the cases that need no
upstream checkout), tests/test_legacy_envs.py and tests/test_aux.py.
"""
import contextlib
import io
import warnings
from copy import deepcopy

import numpy as np
import pandas as pd
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu_torch
from pymgrid_tpu import legacy_envs as jax_legacy
from pymgrid_tpu_torch import legacy_envs


def _generate(pkg, n, seed, modular=False):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = pkg.MicrogridGenerator(nb_microgrid=n, random_seed=seed)
        gen.generate_microgrid(modular=modular)
    return gen.microgrids


@pytest.fixture(scope="module")
def pristine():
    """Six generated nonmodular microgrids per package, same seed."""
    return _generate(pymgrid_tpu_torch, 6, 3), _generate(pymgrid_tpu, 6, 3)


def _frames_equal(ours, want):
    pd.testing.assert_frame_equal(ours, want, check_exact=True)


def _outputs_equal(ours, want):
    """Two legacy ControlOutputs, section by section, bitwise."""
    for name in ("action", "status", "production", "cost", "co2"):
        assert set(ours[name]) == set(want[name]), name
        for k in want[name]:
            np.testing.assert_array_equal(ours[name][k], want[name][k], err_msg=f"{name}.{k}")


def _same_steps(ours, want):
    (o_obs, o_rew, o_done, _), (w_obs, w_rew, w_done, _) = ours, want
    np.testing.assert_array_equal(np.asarray(o_obs), np.asarray(w_obs))
    assert o_rew == w_rew and o_done == w_done


# ------------------------------------------------------------- generator
def test_generator_same_seed_same_microgrids(pristine):
    ours, want = pristine
    for i, (om, wm) in enumerate(zip(ours, want)):
        assert om.architecture == wm.architecture, i
        _frames_equal(om.parameters, wm.parameters)
        for attr in ("_load_ts", "_pv_ts", "_grid_status_ts", "_grid_price_import",
                     "_grid_price_export", "_grid_co2"):
            if hasattr(wm, attr):
                _frames_equal(getattr(om, attr), getattr(wm, attr))
    assert len({(m.architecture["grid"], m.architecture["genset"]) for m in want}) >= 2


def test_generator_modular_and_nonmodular_runs():
    ours = _generate(pymgrid_tpu_torch, 2, 1)
    want = _generate(pymgrid_tpu, 2, 1)
    for om, wm in zip(ours, want):
        for mg in (om, wm):
            mg.train_test_split(train_size=0.5)
        for _ in range(10):
            control = {"battery_charge": 0.0, "battery_discharge": 10.0}
            if wm.architecture["grid"]:
                control.update(grid_import=20.0, grid_export=0.0)
            if wm.architecture["genset"]:
                control["genset"] = 10.0
            np.testing.assert_equal(om.run(dict(control)), wm.run(dict(control)))
        for key in wm._df_record_cost:
            np.testing.assert_array_equal(om._df_record_cost[key], wm._df_record_cost[key])
        om.reset(testing=True)
        assert om._data_set_to_use == "testing"

    ours = _generate(pymgrid_tpu_torch, 2, 3, modular=True)
    want = _generate(pymgrid_tpu, 2, 3, modular=True)
    for om, wm in zip(ours, want):
        assert isinstance(om, pymgrid_tpu_torch.Microgrid)
        for seed in range(3):
            np.random.seed(seed)
            out = om.run(om.sample_action())
            np.random.seed(seed)
            jout = wm.run(wm.sample_action())
            np.testing.assert_equal(out, jout)


# ------------------------------------------------ nonmodular RBC, SAA, MPC
def test_nonmodular_rbc_equals_original(pristine):
    from pymgrid_tpu.algos.nonmodular_rbc import NonModularRuleBasedControl as JaxRBC
    from pymgrid_tpu_torch.algos import NonModularRuleBasedControl

    for om, wm in zip(*pristine):
        _outputs_equal(NonModularRuleBasedControl(deepcopy(om)).run_rule_based(length=150),
                       JaxRBC(deepcopy(wm)).run_rule_based(length=150))


def test_saa_equals_original(pristine):
    from pymgrid_tpu.algos.saa import SampleAverageApproximation as JaxSAA
    from pymgrid_tpu_torch.algos import ControlOutput, SampleAverageApproximation

    om, wm = (next(m for m in mgs if m.architecture["grid"] == 1) for mgs in pristine)
    np.random.seed(4)
    out = SampleAverageApproximation(deepcopy(om), preset_to_use=85).run(
        n_samples=2, forecast_steps=3, optimal_percentile=0.5)
    np.random.seed(4)
    want = JaxSAA(deepcopy(wm), preset_to_use=85).run(
        n_samples=2, forecast_steps=3, optimal_percentile=0.5)
    assert isinstance(out, ControlOutput) and len(out["cost"]["total_cost"]) == 3
    _outputs_equal(out, want)
    _frames_equal(out.to_frame(), want.to_frame())


def _describe(bench):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.describe_benchmarks()
    return buf.getvalue()


def test_benchmarks_modular_equals_original():
    """The modular RBC (the port's engine on the CPU) and host MPC over 48
    steps of scenario 2: logs and printed summaries equal the original's."""
    from pymgrid_tpu.algos.control import Benchmarks as JaxBenchmarks
    from pymgrid_tpu_torch.algos import Benchmarks

    ours = Benchmarks(pymgrid_tpu_torch.Microgrid.from_scenario(2))
    want = JaxBenchmarks(pymgrid_tpu.Microgrid.from_scenario(2))
    ours.run_rule_based_benchmark(max_steps=48, device="cpu")
    want.run_rule_based_benchmark(max_steps=48)
    ours.run_mpc_benchmark(max_steps=48)
    want.run_mpc_benchmark(max_steps=48)
    for name in ("rbc", "mpc"):
        _frames_equal(ours.outputs_dict[name], want.outputs_dict[name])
    assert _describe(ours) == _describe(want)
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA"):
            Benchmarks(pymgrid_tpu_torch.Microgrid.from_scenario(2)).run_rule_based_benchmark(
                max_steps=2)


def test_benchmarks_nonmodular_equals_original(pristine):
    from pymgrid_tpu.algos.control import Benchmarks as JaxBenchmarks
    from pymgrid_tpu_torch.algos import Benchmarks

    ours, want = Benchmarks(deepcopy(pristine[0][0])), JaxBenchmarks(deepcopy(pristine[1][0]))
    ours.run_rule_based_benchmark(length=100)
    want.run_rule_based_benchmark(length=100)
    _outputs_equal(ours.rule_based_output, want.rule_based_output)
    assert len(ours.rule_based_output["cost"]["total_cost"]) == 100 - 24
    assert _describe(ours) == _describe(want)


# ------------------------------------------------------------ legacy envs
def _env_config(mg, **kw):
    return {"microgrid": mg, "training_reward_smoothing": "sqrt",
            "resampling_on_reset": False, "forecast_args": None,
            "baseline_sampling_args": None, **kw}


def _with_grid(mgs):
    return next(m for m in mgs if m.architecture["grid"] == 1)


@pytest.mark.parametrize("name", ["CsplaMicroGridEnv", "CsdaMicroGridEnv",
                                  "CscaOldMicroGridEnv"])
def test_discrete_legacy_envs_equal_original(pristine, name):
    """The Environment-based envs (four architectures; csca_old's continuous
    mapping only on the first, as in tests/test_legacy_envs.py): reset and a
    fixed action sequence equal the original's step by step."""
    n = 1 if name == "CscaOldMicroGridEnv" else 4
    for om, wm in list(zip(*pristine))[:n]:
        env = getattr(legacy_envs, name)(_env_config(deepcopy(om)), seed=0)
        jenv = getattr(jax_legacy, name)(_env_config(deepcopy(wm)), seed=0)
        np.testing.assert_array_equal(env.reset(), jenv.reset())
        np.random.seed(7)
        actions = [jenv.action_space.sample() for _ in range(12)]
        for a in actions:
            _same_steps(env.step(a), jenv.step(a))
    np.testing.assert_array_equal(env.state, jenv.state)


def test_environment_resampling_and_normalization_equal_original(pristine):
    om, wm = (_with_grid(mgs) for mgs in pristine)
    assert legacy_envs.normalize_environment_states(om) == \
        jax_legacy.normalize_environment_states(wm)
    envs = []
    for pkg, mg in ((legacy_envs, om), (jax_legacy, wm)):
        np.random.seed(0)
        env = pkg.CsplaMicroGridEnv(_env_config(deepcopy(mg), resampling_on_reset=True), seed=0)
        env.reset()
        envs.append(env)
    _frames_equal(envs[0].mg._load_ts, envs[1].mg._load_ts)
    _same_steps(envs[0].step(0), envs[1].step(0))


@pytest.mark.parametrize("name", ["ContinuousMicrogridEnv", "SafeExpMicrogridEnv",
                                  "ContinuousMicrogridSampleEnv", "SafeExpMicrogridSampleEnv"])
def test_continuous_legacy_envs_equal_original(pristine, name):
    """The csca envs (trajectory sampling, SAA resampling on reset, the
    safe-exploration constraints) from the same ``np.random`` state."""
    om, wm = (_with_grid(mgs) for mgs in pristine)
    runs = []
    for pkg, mg in ((legacy_envs, om), (jax_legacy, wm)):
        np.random.seed(0)
        kw = {} if "Sample" in name else {"trajectory_len": 48}
        env = getattr(pkg, name)(deepcopy(mg), standardization=False, **kw)
        rng = np.random.RandomState(5)
        steps = [env.reset()]
        for _ in range(6):
            steps.append(env.step(rng.uniform(0, 10, env.action_space.shape)))
        constraints = env.get_constraint_values() if hasattr(env, "get_constraint_values") \
            else None
        runs.append((steps, constraints, env.microgrid._load_ts.values))
    (steps, cons, load), (jsteps, jcons, jload) = runs
    np.testing.assert_array_equal(steps[0], jsteps[0])
    for s, j in zip(steps[1:], jsteps[1:]):
        _same_steps(s, j)
    np.testing.assert_array_equal(load, jload)
    if jcons is not None:
        np.testing.assert_array_equal(cons, jcons)


def test_csca_standardization_equals_original(pristine, monkeypatch):
    """Standardization constants from a 48-step host MPC run, and a step in
    the standardized space, equal the original's."""
    from pymgrid_tpu.legacy_envs import csca as jax_csca
    from pymgrid_tpu_torch.legacy_envs import csca

    monkeypatch.setattr(csca, "STANDARDIZATION_MPC_STEPS", 48)
    monkeypatch.setattr(jax_csca, "STANDARDIZATION_MPC_STEPS", 48)
    om, wm = (_with_grid(mgs) for mgs in pristine)
    env = legacy_envs.ContinuousMicrogridEnv(deepcopy(om), standardization=True)
    jenv = jax_legacy.ContinuousMicrogridEnv(deepcopy(wm), standardization=True)
    for a, b in zip(env.standardizations, jenv.standardizations):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    act = np.zeros(env.action_space.shape)
    _same_steps(env.step(act), jenv.step(act))


# ------------------------------------------------------- gymnasium adapter
def _five_modules(ns):
    """tests/helpers/modular_microgrid.py's modules from the namespace ``ns``."""
    return [
        ns.GensetModule(running_min_production=10, running_max_production=50,
                        genset_cost=0.5),
        ns.BatteryModule(min_capacity=0, max_capacity=100, max_charge=50,
                         max_discharge=50, efficiency=1.0, init_soc=0.5),
        ns.RenewableModule(time_series=50 * np.ones(100)),
        ns.LoadModule(time_series=60 * np.ones(100)),
        ns.GridModule(max_import=100, max_export=0, time_series=np.ones((100, 3)),
                      raise_errors=True),
    ]


def test_gymnasium_adapter_equals_original():
    gymnasium = pytest.importorskip("gymnasium")
    import pymgrid_tpu.modules as JM
    import pymgrid_tpu_torch.modules as M
    from pymgrid_tpu.envs import DiscreteMicrogridEnv as JaxDiscreteMicrogridEnv
    from pymgrid_tpu.envs.gym_adapter import GymnasiumWrapper as JaxWrapper
    from pymgrid_tpu_torch.envs import DiscreteMicrogridEnv
    from pymgrid_tpu_torch.envs.gym_adapter import GymnasiumWrapper

    env = GymnasiumWrapper(DiscreteMicrogridEnv(_five_modules(M)))
    jenv = JaxWrapper(JaxDiscreteMicrogridEnv(_five_modules(JM)))
    assert isinstance(env.action_space, gymnasium.spaces.Discrete)
    assert isinstance(env.observation_space, gymnasium.spaces.Box)
    assert env.action_space == jenv.action_space
    assert env.observation_space == jenv.observation_space
    obs, _ = env.reset(seed=0)
    jobs, _ = jenv.reset(seed=0)
    np.testing.assert_array_equal(obs, jobs)
    assert env.observation_space.contains(obs)
    for a in np.random.RandomState(0).randint(env.action_space.n, size=5):
        out, jout = env.step(int(a)), jenv.step(int(a))
        np.testing.assert_array_equal(out[0], jout[0])
        assert out[1:4] == jout[1:4]
