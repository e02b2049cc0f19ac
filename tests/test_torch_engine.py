"""The port's tables, reset and step against the JAX engine and the host
layer (CPU, float64).

Inputs are made from a seed with numpy and handed to both packages: each
builds its own microgrid and spec with its own host layer (the port's copy
equals the JAX package's bitwise, tests/test_torch_host_layer.py), and numpy
arrays pass between them.  Every comparison is bitwise: eager PyTorch rounds
each op once, like numpy and like the JAX engine under the repo's pre-FMA CPU
flags (tests/conftest.py).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu.modules as JM
import pymgrid_tpu_torch
import pymgrid_tpu_torch.modules as M
from helpers.factories import build_microgrid, module_params
from helpers.modular_microgrid import get_modular_microgrid
from pymgrid_tpu.core import physics as jax_physics
from pymgrid_tpu.core.engine import make_reset_fn as jax_reset_fn
from pymgrid_tpu.core.engine import make_step_fn as jax_step_fn
from pymgrid_tpu.core.spec import extract_spec as jax_extract_spec
from pymgrid_tpu.core.tables import build_tables as jax_build_tables
from pymgrid_tpu.core.tables import ensure_tables as jax_ensure_tables
from pymgrid_tpu.parallel.suite import build_suite as jax_build_suite
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core import physics, xp
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
from pymgrid_tpu_torch.core.engine import make_reset_fn, make_step_fn
from pymgrid_tpu_torch.core.params import (
    params_to_torch,
    state_to_torch,
    tree_map,
    with_config_axis,
)
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core.tables import build_tables, ensure_tables
from pymgrid_tpu_torch.parallel.suite import build_suite

torch.set_num_threads(1)


def _eq(ours, want, msg=""):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(want), err_msg=msg)


def _specs(scenario):
    """``(spec, params)`` of the port and of the JAX package for a scenario,
    each from its own host layer."""
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario))
    jspec, jparams, _ = jax_extract_spec(pymgrid_tpu.Microgrid.from_scenario(scenario))
    return spec, params, jspec, jparams


@pytest.mark.parametrize("scenario", [0, 1])
def test_build_tables_bitwise(scenario):
    spec, params, jspec, jparams = _specs(scenario)
    want = jax_build_tables(jspec, jax.tree.map(jnp.asarray, jparams))
    ours = build_tables(spec, params_to_torch(params, "cpu", "float64"))
    for name in ("step_table", "logfc_table"):
        assert ours[name].shape == want[name].shape, name
        _eq(ours[name].numpy(), want[name], name)


def test_build_tables_config_axis_bitwise():
    _, want = jax_build_suite([pymgrid_tpu.Microgrid.from_scenario(n) for n in (0, 1, 4)],
                              dtype=np.float64)
    _, ours = build_suite([Microgrid.from_scenario(n) for n in (0, 1, 4)], "float64", "cpu")
    for name in ("step_table", "logfc_table"):
        assert ours[name].shape == np.asarray(want[name]).shape
        assert ours[name].shape[0] == 3
        _eq(ours[name].numpy(), want[name], name)


def _random_actions(rng, spec, params, B, normalized):
    """Actions for B replicas: [0, 1] when normalized, else raw energies that
    overshoot the action space on both sides (to exercise the clipping)."""
    def draw(kind, n, extra=()):
        u = rng.rand(B, n, *extra)
        if normalized:
            return u
        low = params[kind]["act_low"].reshape((1, n) + (1,) * len(extra))
        spread = params[kind]["act_spread"].reshape((1, n) + (1,) * len(extra))
        return low + spread * (1.4 * u - 0.2)

    genset = draw("genset", spec.n_genset, (2,))
    genset[..., 0] = rng.rand(B, spec.n_genset)  # goal, rounded half-even
    return {
        "battery": draw("battery", spec.n_battery),
        "genset": genset,
        "grid": draw("grid", spec.n_grid),
    }


def _compare_steps(specs, rng, B, n_steps, normalized, tables, max_start):
    """Reset B replicas at random starts in both engines, then step both with
    the same numpy-random actions, comparing every output and the next state
    bitwise at every step."""
    spec, params, jspec, jparams = specs
    starts = rng.randint(0, max_start, size=B).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, jparams)
    if tables:
        jparams = jax_ensure_tables(jspec, jparams)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate = jax.jit(jax.vmap(jax_reset_fn(jspec), in_axes=(None, 0, 0)))(
        jparams, keys, jnp.asarray(starts)
    )
    jstep = jax.jit(jax.vmap(jax_step_fn(jspec, normalized=normalized),
                             in_axes=(None, 0, 0)))

    tparams = params_to_torch(params, "cpu", "float64")
    if tables:
        tparams = ensure_tables(spec, tparams)
    tparams = with_config_axis(tparams)
    state = make_reset_fn(spec)(tparams, torch.as_tensor(starts).view(1, B))
    step = make_step_fn(spec, normalized=normalized)

    def compare_state(want, when):
        want = tree_map(lambda x: x.unsqueeze(0),
                        state_to_torch(jax.tree.map(np.asarray, want), "cpu", "float64"))
        for k in ("step", "battery_charge"):
            _eq(state[k].numpy(), want[k].numpy(), f"{when} {k}")
        for k in state["genset"]:
            assert state["genset"][k].dtype == torch.int32
            _eq(state["genset"][k].numpy(), want["genset"][k].numpy(), f"{when} {k}")

    compare_state(jstate, "reset")
    for t in range(n_steps):
        action = _random_actions(rng, spec, params, B, normalized)
        jstate, jout = jstep(jparams, jstate, jax.tree.map(jnp.asarray, action))
        state, out = step(tparams, state,
                          {k: torch.as_tensor(v).unsqueeze(0) for k, v in action.items()})
        for field in ("obs", "reward", "done", "log_row", "provided", "absorbed"):
            _eq(getattr(out, field)[0].numpy(), getattr(jout, field),
                f"step {t} {field}")
        compare_state(jstate, f"step {t}")


# (scenario, normalized actions, step tables attached)
CASES = [(0, False, False), (0, True, True), (1, False, True), (1, True, False)]


@pytest.mark.parametrize("scenario,normalized,tables", CASES)
def test_reset_and_step_bitwise(scenario, normalized, tables):
    _compare_steps(_specs(scenario), np.random.RandomState(100 + scenario), B=4,
                   n_steps=50, normalized=normalized, tables=tables, max_start=8700)


def _noisy_user_forecast(val_c, val_c_n, n):
    return val_c_n * (1 + 0.01 * np.abs(np.random.rand(*np.shape(val_c_n))))


@pytest.mark.parametrize("tables", [False, True])
def test_user_bank_forecaster_step_bitwise(tables):
    """A stochastic user forecaster replays the realization bank sampled at
    spec extraction; both engines read the same bank.  Starts near the end
    of the 60-step series cover the off-end revert and the index clamps."""
    rng = np.random.RandomState(64)
    T = 60
    pv, load, grid = 50 * rng.rand(T), 60 * rng.rand(T), rng.rand(T, 3)

    def spec_of(pkg, ns, extract):
        mg = pkg.Microgrid([
            ns.BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                             max_discharge=50, efficiency=0.9,
                             battery_cost_cycle=0.02, init_soc=0.5),
            ("pv", ns.RenewableModule(time_series=pv, forecaster=_noisy_user_forecast,
                                      forecast_horizon=4)),
            ns.LoadModule(time_series=load, forecaster="oracle", forecast_horizon=4),
            ns.GridModule(max_import=100, max_export=100, time_series=grid,
                          forecaster="oracle", forecast_horizon=4),
        ])
        np.random.seed(1234)
        return extract(mg)[:2]

    specs = (spec_of(pymgrid_tpu_torch, M, extract_spec)
             + spec_of(pymgrid_tpu, JM, jax_extract_spec))
    assert any(m.forecaster == "user_bank" for m in specs[0].log_order)
    _compare_steps(specs, rng, B=3, n_steps=12, normalized=False,
                   tables=tables, max_start=T - 1)


@pytest.mark.parametrize("config", [
    dict(weak_grid=True, start_up_time=2, wind_down_time=1),
    dict(forecaster="oracle", forecast_horizon=5, timesteps=30),
])
def test_compiled_microgrid_matches_host(config):
    """CompiledMicrogrid's initial_state / action_to_arrays / step / log_frame
    against the JAX package's host Microgrid.run, bitwise (float64)."""
    params = module_params(seed=7, **config)
    mg = pymgrid_tpu.Microgrid(build_microgrid(JM, params)[0])
    compiled = CompiledMicrogrid(Microgrid(build_microgrid(M, params)[0]),
                                 dtype="float64", device="cpu")
    state = compiled.initial_state()
    np.random.seed(3)
    rows = []
    for t in range(30):
        action = mg.sample_action()
        _, host_reward, host_done, _ = mg.run(action, normalized=False)
        state, out = compiled.step(state, compiled.action_to_arrays(action))
        rows.append(out.log_row)
        assert float(out.reward) == host_reward, f"step {t}"
        assert bool(out.done) == host_done, f"step {t}"
        _eq(out.obs[0, 0].numpy(),
            mg.state_series(normalized=True).values.astype(np.float64), f"step {t}")
    host_log = mg.get_log()
    log = compiled.log_frame(torch.stack(rows))
    assert list(log.columns) == list(host_log.columns)
    _eq(log.values.astype(np.float64), host_log.values.astype(np.float64))


def test_numpy_noise_bank_run_compiled_matches_host():
    """Seeded gaussian forecasts replayed from the numpy-RNG noise bank:
    the port's run_compiled equals the JAX package's host RBC run bitwise,
    through the data end (the truncated off-end draws)."""
    from pymgrid_tpu.algos import RuleBasedControl as HostRuleBasedControl
    from pymgrid_tpu_torch.algos import RuleBasedControl

    mg = get_modular_microgrid()
    mg.set_forecaster(0.1, forecast_horizon=5)
    np.random.seed(1234)
    host_log = HostRuleBasedControl(mg).run()
    ours = Microgrid([   # get_modular_microgrid's modules, from the port
        M.GensetModule(running_min_production=10, running_max_production=50,
                       genset_cost=0.5),
        M.BatteryModule(min_capacity=0, max_capacity=100, max_charge=50,
                        max_discharge=50, efficiency=1.0, init_soc=0.5),
        M.RenewableModule(time_series=50 * np.ones(100)),
        M.LoadModule(time_series=60 * np.ones(100)),
        M.GridModule(max_import=100, max_export=0, time_series=np.ones((100, 3)),
                     raise_errors=True),
    ])
    ours.set_forecaster(0.1, forecast_horizon=5)
    np.random.seed(1234)
    log = RuleBasedControl(ours).run_compiled(device="cpu", numpy_rng_noise=True)
    assert list(log.columns) == list(host_log.columns)
    _eq(log.values.astype(float), host_log.values.astype(float))


def _valid_state(cur, goal, up, down, sut, wdt):
    """States reachable by the reference machine (tests/test_genset_machine.py)."""
    if up < 0 or down < 0 or up > sut or down > wdt:
        return False
    if cur == goal:
        return (up == 0) if cur else (down == 0)
    return (up > 0) if goal else (down > 0)


@pytest.mark.parametrize("allow_abortion", [True, False])
def test_physics_shim_genset_machine_exhaustive(allow_abortion):
    """The port's physics run through the torch namespace gives the JAX
    package's numpy physics' transition on every reachable state (the case
    grid of tests/test_genset_machine.py, whose numpy physics is held against
    the reference machine there)."""
    cases = []
    for sut, wdt in itertools.product(range(4), range(4)):
        for cur, goal, g in itertools.product((0, 1), (0, 1), (0, 1)):
            for up, down in itertools.product(range(sut + 1), range(wdt + 1)):
                if _valid_state(cur, goal, up, down, sut, wdt):
                    cases.append((cur, goal, up, down, g, sut, wdt))
    assert len(cases) > 100
    cols = np.array(cases, dtype=np.int32).T
    as_t = lambda a: torch.as_tensor(a)
    got = physics.genset_update_status(
        *[as_t(c) for c in cols], torch.tensor(allow_abortion), xp=xp
    )
    want = jax_physics.genset_update_status(*cols, np.bool_(allow_abortion), xp=np)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32
        _eq(g_.numpy(), w_)

    cur, _, up, down, g = (as_t(c) for c in cols[:5])
    _eq(physics.genset_next_status(cur, up, down, g, xp=xp).numpy(),
        jax_physics.genset_next_status(*(cols[i] for i in (0, 2, 3, 4)), xp=np))
    # the traps the shim exists for: scalar first operands
    _eq(physics.battery_max_production(
            torch.tensor([5.0, 1.0], dtype=torch.float64), 2.0, 1.5, 0.9, xp=xp).numpy(),
        jax_physics.battery_max_production(np.array([5.0, 1.0]), 2.0, 1.5, 0.9))
    _eq(physics.battery_max_consumption(
            torch.tensor([5.0, 9.5], dtype=torch.float64), 10.0, 2.0, 0.9, xp=xp).numpy(),
        jax_physics.battery_max_consumption(np.array([5.0, 9.5]), 10.0, 2.0, 0.9))
    _eq(physics.round_half_even(torch.tensor([0.5, 1.5, 2.5, -0.5]), xp=xp).numpy(),
        np.round(np.array([0.5, 1.5, 2.5, -0.5], np.float32)))


@pytest.mark.parametrize("shaper", ["PVCurtailmentShaper", "BatteryDischargeShaper"])
def test_reward_shapers_match_jax_and_host(shaper):
    """Both built-in shapers: the port's shaped reward (and the log row's
    shaped column) against the JAX step and the host ``Microgrid.run``,
    bitwise (the pattern of tests/test_engine_equivalence.py)."""
    from pymgrid_tpu.core.compiled import CompiledMicrogrid as JaxCompiledMicrogrid
    from pymgrid_tpu.microgrid import reward_shaping as jax_reward_shaping
    from pymgrid_tpu_torch.microgrid import reward_shaping

    def make(pkg, ns, shaping):
        mods, _ = build_microgrid(ns, module_params(seed=41))
        return pkg.Microgrid(mods, reward_shaping_func=getattr(shaping, shaper)())

    mg = make(pymgrid_tpu, JM, jax_reward_shaping)
    compiled = CompiledMicrogrid(make(pymgrid_tpu_torch, M, reward_shaping),
                                 dtype="float64", device="cpu")
    jcompiled = JaxCompiledMicrogrid(make(pymgrid_tpu, JM, jax_reward_shaping),
                                     dtype=np.float64)
    assert compiled.spec.shaper is not None
    state, jstate = compiled.initial_state(), jcompiled.initial_state(seed=3)
    np.random.seed(17)
    shaped = []
    for t in range(20):
        action = mg.sample_action()
        _, host_shaped, _, _ = mg.run(action, normalized=False)
        state, out = compiled.step(state, compiled.action_to_arrays(action))
        jstate, jout = jcompiled.step(jstate, jcompiled.action_to_arrays(action))
        assert float(out.shaped_reward) == host_shaped, f"step {t}"
        for field in ("shaped_reward", "reward", "log_row"):
            _eq(getattr(out, field)[0, 0].numpy(), getattr(jout, field), f"step {t} {field}")
        shaped.append(float(out.shaped_reward))
        assert float(out.log_row[0, 0, -7]) == host_shaped   # the shaped column
    assert len(set(shaped)) > 1


@pytest.mark.parametrize("tables", [False, True])
def test_obs_layout_env_matches_jax(tables):
    """``obs_layout="env"`` concatenates segments in sorted-name order, as the
    JAX step does; scenario 1 has names out of order in the container."""
    spec, params, jspec, jparams = _specs(1)
    assert [r.name for r in spec.log_order] != sorted(r.name for r in spec.log_order)
    jparams = jax.tree.map(jnp.asarray, jparams)
    tparams = params_to_torch(params, "cpu", "float64")
    if tables:
        jparams = jax_ensure_tables(jspec, jparams)
        tparams = ensure_tables(spec, tparams)
    tparams = with_config_axis(tparams)
    rng = np.random.RandomState(9)
    starts = rng.randint(0, 8700, size=3).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jstate = jax.vmap(jax_reset_fn(jspec), in_axes=(None, 0, 0))(jparams, keys,
                                                                jnp.asarray(starts))
    jstep = jax.jit(jax.vmap(jax_step_fn(jspec, obs_layout="env"), in_axes=(None, 0, 0)))
    state = make_reset_fn(spec)(tparams, torch.as_tensor(starts).view(1, 3))
    step = make_step_fn(spec, obs_layout="env")
    for t in range(5):
        action = _random_actions(rng, spec, params, 3, normalized=False)
        jstate, jout = jstep(jparams, jstate, jax.tree.map(jnp.asarray, action))
        state, out = step(tparams, state,
                          {k: torch.as_tensor(v).unsqueeze(0) for k, v in action.items()})
        _eq(out.obs[0].numpy(), jout.obs, f"step {t}")
    with pytest.raises(ValueError, match="obs_layout"):
        make_step_fn(spec, obs_layout="gym")
