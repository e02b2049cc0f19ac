"""The engine surfaces the port draws or calls per replica, against the JAX
engine (CPU, float64): threefry-gaussian forecasts, traced user forecasters
and custom battery/genset callables.

Gaussian windows come from the same keys as JAX's.  In float32 they are
bitwise.  In float64 they differ only where a draw leaves ``log1p``'s
rational, by a few ulps (tests/test_torch_prng.py): keys, rewards and dones
are bitwise, observations and log rows within ``GAUSS_ATOL`` (measured up to
1.5e-14 on these inputs).  The callable cases of
tests/test_engine_equivalence.py are bitwise.  Inputs are made from a seed with
numpy and each package builds its microgrid with its own host layer.
"""
import jax
import numpy as np
import pytest
import torch

import pymgrid_tpu
import pymgrid_tpu.modules as JM
import pymgrid_tpu_torch
import pymgrid_tpu_torch.modules as M
from helpers.factories import build_microgrid, module_params
from test_engine_equivalence import (
    _damped_vector_forecast,
    _derated_transition_model,
    _polynomial_fuel_cost,
    _scalar_damped_forecast,
)
from pymgrid_tpu.core.compiled import CompiledMicrogrid as JaxCompiled
from pymgrid_tpu.core.rollout import make_marginal_cost_policy as jax_mc_policy
from pymgrid_tpu.envs import ContinuousMicrogridEnv as JaxContinuousMicrogridEnv
from pymgrid_tpu.envs import DiscreteMicrogridEnv as JaxDiscreteMicrogridEnv
from pymgrid_tpu.parallel import BatchedContinuousEnv as JaxContinuousEnv
from pymgrid_tpu.parallel import BatchedDiscreteEnv as JaxDiscreteEnv
from pymgrid_tpu.parallel import BatchedMicrogrid as JaxBatchedMicrogrid
from pymgrid_tpu.parallel.suite import SuiteRunner as JaxSuiteRunner
from pymgrid_tpu_torch import Microgrid
from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
from pymgrid_tpu_torch.core.engine import needs_keys
from pymgrid_tpu_torch.core.params import state_to_torch
from pymgrid_tpu_torch.core.rollout import make_marginal_cost_policy
from pymgrid_tpu_torch.core.tables import build_tables
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import (
    BatchedContinuousEnv,
    BatchedDiscreteEnv,
    BatchedMicrogrid,
    BatchMesh,
    SuiteRunner,
)

torch.set_num_threads(1)

GAUSS_ATOL = 1e-12
INCLUDE = ("genset", "battery", "pv", "load", "grid")


def _eq(ours, want, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.numpy()
    np.testing.assert_array_equal(ours, np.asarray(want), err_msg=msg)


def _close(ours, want, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.numpy()
    np.testing.assert_allclose(ours, np.asarray(want), rtol=0, atol=GAUSS_ATOL, err_msg=msg)


def _mods(ns, **kwargs):
    return build_microgrid(ns, module_params(**kwargs), INCLUDE)[0]


# --------------------------------------------------------------- gaussians
GAUSS_CONFIGS = [
    dict(seed=5, forecaster=1.0, forecast_horizon=4),
    dict(seed=6, forecaster=0.5, forecast_horizon=23, timesteps=40),
]


@pytest.mark.parametrize("config", GAUSS_CONFIGS)
def test_compiled_gaussian_forecasts_match_jax(config):
    """The same seed through both CompiledMicrogrids: the same keys, windows
    within GAUSS_ATOL, rewards and dones bitwise; the second config runs
    past the data end (the off-end rows keep the fill)."""
    mg = pymgrid_tpu.Microgrid(_mods(JM, **config))
    jc = JaxCompiled(mg, dtype=np.float64)
    ours = CompiledMicrogrid(Microgrid(_mods(M, **config)), dtype="float64", device="cpu")
    assert needs_keys(ours.spec)
    jstate, state = jc.initial_state(seed=7), ours.initial_state(seed=7)
    for kind in jstate["forecast"]:
        _close(state["forecast"][kind][0, 0], jstate["forecast"][kind], kind)
    np.random.seed(11)
    rows, jrows = [], []
    for t in range(30):
        action = mg.sample_action()
        jstate, jout = jc.step(jstate, jc.action_to_arrays(action))
        state, out = ours.step(state, ours.action_to_arrays(action))
        _eq(state["rng"][0, 0], np.asarray(jstate["rng"]).astype(np.int64), f"rng {t}")
        _eq(out.reward[0, 0], jout.reward, f"reward {t}")
        _eq(out.done[0, 0], jout.done, f"done {t}")
        _close(out.obs[0, 0], jout.obs, f"obs {t}")
        rows.append(out.log_row[0, 0].numpy())
        jrows.append(np.asarray(jout.log_row))
    log, jlog = ours.log_frame(np.stack(rows)), jc.log_frame(np.stack(jrows))
    fc = [c for c in log.columns if "_forecast_" in c[2]]
    assert fc and list(log.columns) == list(jlog.columns)
    _close(log[fc].values, jlog[fc].values, "log forecasts")
    # another seed draws other windows
    other = ours.initial_state(seed=8)
    assert not torch.equal(other["forecast"]["load"], ours.initial_state(seed=7)["forecast"]["load"])


@pytest.mark.parametrize("config", GAUSS_CONFIGS)
def test_compiled_gaussian_forecasts_bitwise_in_float32(config):
    """Float32 CompiledMicrogrids from the same seed: the initial windows and
    every step's windows equal the JAX engine's bitwise, with the keys; the
    draw is the only thing between the two, and it is JAX's bit for bit."""
    mg = pymgrid_tpu.Microgrid(_mods(JM, **config))
    jc = JaxCompiled(mg, dtype=np.float32)
    ours = CompiledMicrogrid(Microgrid(_mods(M, **config)), dtype="float32", device="cpu")
    jstate, state = jc.initial_state(seed=7), ours.initial_state(seed=7)
    np.random.seed(11)
    for t in range(31):
        for kind in jstate["forecast"]:
            assert state["forecast"][kind].dtype == torch.float32
            _eq(state["forecast"][kind][0, 0], jstate["forecast"][kind], f"{kind} {t}")
        _eq(state["rng"][0, 0], np.asarray(jstate["rng"]).astype(np.int64), f"rng {t}")
        action = mg.sample_action()
        jstate, _ = jc.step(jstate, jc.action_to_arrays(action))
        state, _ = ours.step(state, ours.action_to_arrays(action))


def _gauss_env(pkg, ns, env_cls, **kw):
    mods = _mods(ns, seed=13, forecaster=0.5, forecast_horizon=4, timesteps=25, **kw)
    return env_cls.from_microgrid(pkg.Microgrid(mods))


def _env_pair(kind, B):
    if kind == "discrete":
        host = _gauss_env(pymgrid_tpu_torch, M, DiscreteMicrogridEnv)
        jhost = _gauss_env(pymgrid_tpu, JM, JaxDiscreteMicrogridEnv)
        env = BatchedDiscreteEnv(host, B, "float64", device="cpu")
        jenv = JaxDiscreteEnv(jhost, batch_size=B, dtype=np.float64)
        seq = np.random.RandomState(0).randint(env.n_actions, size=(40, B))
    else:
        host = _gauss_env(pymgrid_tpu_torch, M, ContinuousMicrogridEnv)
        jhost = _gauss_env(pymgrid_tpu, JM, JaxContinuousMicrogridEnv)
        env = BatchedContinuousEnv(host, B, "float64", device="cpu")
        jenv = JaxContinuousEnv(jhost, batch_size=B, dtype=np.float64)
        seq = np.random.RandomState(1).rand(40, B, env.action_dim)
    return env, jenv, seq


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_batched_env_gaussian_auto_reset_rekeys_like_jax(kind):
    """40 steps of a 25-step series: every replica auto-resets and re-keys
    from its own ``rng``.  Keys, rewards and dones equal the JAX env's
    bitwise, observations and log rows within GAUSS_ATOL; the fused
    rollout (per-replica and shared step) equals the step loop bitwise."""
    env, jenv, seq = _env_pair(kind, 3)
    states, jstates = env.reset(seed=4), jenv.reset(seed=4)
    assert set(states) == {"step", "battery_charge", "genset", "rng", "forecast"}
    dones = 0
    outs = []
    for t in range(seq.shape[0]):
        states, out = env.step(states, seq[t])
        jstates, jout = jenv.step(jstates, seq[t])
        _eq(states["rng"], np.asarray(jstates["rng"]).astype(np.int64), f"rng {t}")
        _eq(states["step"], jstates["step"], f"step {t}")
        for field in ("reward", "done", "provided", "absorbed"):
            _eq(getattr(out, field), getattr(jout, field), f"{field} {t}")
        _close(out.obs, jout.obs, f"obs {t}")
        _close(out.log_row, jout.log_row, f"log_row {t}")
        for k in jstates["forecast"]:
            _close(states["forecast"][k], jstates["forecast"][k], f"forecast {k} {t}")
        dones += int(out.done.sum())
        outs.append(out)
    assert dones >= 3
    for shared in (False, True):
        _, roll = env.rollout(env.reset(seed=4), seq, keep_logs=True, shared_step=shared)
        for field in ("obs", "reward", "done", "log_row"):
            _eq(getattr(roll, field), torch.stack([getattr(o, field) for o in outs]),
                f"rollout shared={shared} {field}")
    # another seed draws other forecasts
    _, other = env.rollout(env.reset(seed=5), seq[:3])
    assert not torch.equal(other.obs, torch.stack([o.obs for o in outs[:3]]))


def test_meshed_gaussian_env_equals_unmeshed():
    """Two ``BatchMesh`` ranks in one process: each takes its rows of
    ``split(key(seed), B)`` over the global batch, so the joined outputs and
    states equal the unmeshed env's bitwise."""
    host = lambda: _gauss_env(pymgrid_tpu_torch, M, DiscreteMicrogridEnv)  # noqa: E731
    full = BatchedDiscreteEnv(host(), 6, "float64", device="cpu")
    shards = [BatchedDiscreteEnv(host(), 6, "float64", mesh=BatchMesh(2, r, torch.device("cpu")))
              for r in range(2)]
    seq = np.random.RandomState(2).randint(full.n_actions, size=(30, 6))
    final, want = full.rollout(full.reset(seed=9), seq, keep_logs=True)
    parts = [s.rollout(s.reset(seed=9), seq, keep_logs=True) for s in shards]
    for field in ("obs", "reward", "done", "log_row"):
        got = torch.cat([getattr(out, field) for _, out in parts], dim=1)
        _eq(got, getattr(want, field), field)
    _eq(torch.cat([f["rng"] for f, _ in parts]), final["rng"], "rng")


def test_checkpoint_with_keys_resumes_bitwise(tmp_path):
    env, _, seq = _env_pair("discrete", 4)
    ref = env.reset(seed=3)
    ref_out = []
    for a in seq[:20]:
        ref, out = env.step(ref, a)
        ref_out.append(out.obs)
    s = env.reset(seed=3)
    for a in seq[:8]:
        s, _ = env.step(s, a)
    env.save_states(tmp_path / "keys.pt", s)
    restored = env.restore_states(tmp_path / "keys.pt")
    assert set(restored) >= {"rng", "forecast"}
    _eq(restored["rng"], s["rng"])
    for a, want in zip(seq[8:20], ref_out[8:]):
        restored, out = env.step(restored, a)
        _eq(out.obs, want)
    _eq(restored["rng"], ref["rng"])


def test_state_to_torch_continues_a_jax_state():
    """A JAX gaussian env state handed over after 7 steps (its ``rng`` as
    int64, its windows as they are) continues in the port like in JAX."""
    env, jenv, seq = _env_pair("discrete", 3)
    jstates = jenv.reset(seed=0)
    for t in range(7):
        jstates, _ = jenv.step(jstates, seq[t])
    states = state_to_torch(jax.tree.map(np.asarray, jstates), "cpu", "float64")
    assert states["rng"].dtype == torch.int64
    for t in range(7, 30):
        jstates, jout = jenv.step(jstates, seq[t])
        states, out = env.step(states, seq[t])
        _eq(states["rng"], np.asarray(jstates["rng"]).astype(np.int64), f"rng {t}")
        _eq(out.reward, jout.reward, f"reward {t}")
        _close(out.obs, jout.obs, f"obs {t}")


def test_batched_microgrid_and_suite_draw_jax_keys():
    """BatchedMicrogrid's ``reset(seed)`` and the suite's ``make_keys(seed)``
    give the JAX classes' keys; collected marginal-cost rollouts with
    auto-reset agree (rewards bitwise, observations within GAUSS_ATOL)."""
    params = dict(seed=21, forecaster=0.5, forecast_horizon=4, timesteps=20)
    batched = BatchedMicrogrid(Microgrid(_mods(M, **params)), 3, "float64", device="cpu")
    jbatched = JaxBatchedMicrogrid(pymgrid_tpu.Microgrid(_mods(JM, **params)), 3,
                                   dtype=np.float64)
    _eq(batched.reset(seed=2)["rng"], np.asarray(jbatched.reset(seed=2)["rng"]).astype(np.int64))
    _, out = batched.rollout(make_marginal_cost_policy(batched.spec), 25, seed=2, collect=True)
    _, jout = jbatched.rollout(jax_mc_policy(jbatched.spec), 25, seed=2, collect=True)
    _eq(out.reward, jout.reward)
    _close(out.obs, jout.obs)

    mgs = lambda pkg, ns: [pkg.Microgrid(_mods(ns, seed=s, forecaster=0.5,  # noqa: E731
                                               forecast_horizon=4, timesteps=20))
                           for s in (31, 32)]
    runner = SuiteRunner(mgs(pymgrid_tpu_torch, M), 2, "float64", device="cpu")
    jrunner = JaxSuiteRunner(mgs(pymgrid_tpu, JM), 2, dtype=np.float64)
    keys = runner.make_keys(seed=6)
    _eq(keys, np.asarray(jrunner.make_keys(seed=6)).astype(np.int64))
    fn = runner.rollout_fn(make_marginal_cost_policy(runner.spec), 25, collect=True)
    jfn = jrunner.rollout_fn(jax_mc_policy(jrunner.spec), 25, collect=True)
    acc, outs = fn(runner.params, keys)
    jacc, jouts = jfn(jrunner.params, jrunner.make_keys(seed=6))
    _eq(outs.reward, jouts.reward)
    _close(outs.obs, jouts.obs)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-13)


# --------------------------------------------------------------- callables
def _genset_cost_mods(ns):
    rng = np.random.RandomState(21)
    return [
        ns.GensetModule(running_min_production=5, running_max_production=50,
                        genset_cost=_polynomial_fuel_cost, co2_per_unit=2.0,
                        cost_per_unit_co2=0.1, start_up_time=1, wind_down_time=1),
        ns.BatteryModule(min_capacity=0, max_capacity=80, max_charge=30,
                         max_discharge=30, efficiency=0.9, init_soc=0.5),
        ("pv", ns.RenewableModule(time_series=30 * rng.rand(80))),
        ns.LoadModule(time_series=50 * rng.rand(80)),
    ]


def _transition_mods(ns):
    rng = np.random.RandomState(22)
    return [
        ns.BatteryModule(min_capacity=0, max_capacity=100, max_charge=40,
                         max_discharge=40, efficiency=0.9, init_soc=0.5,
                         battery_cost_cycle=0.02,
                         battery_transition_model=_derated_transition_model),
        ("pv", ns.RenewableModule(time_series=40 * rng.rand(80))),
        ns.LoadModule(time_series=50 * rng.rand(80)),
        ns.GridModule(max_import=100, max_export=100, time_series=rng.rand(80, 3)),
    ]


def _user_forecast_mods(seed, forecaster, horizon, timesteps=120, with_grid=True):
    def build(ns):
        rng = np.random.RandomState(seed)
        mods = [
            ns.BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                             max_discharge=50, efficiency=0.9,
                             battery_cost_cycle=0.02, init_soc=0.5),
            ("pv", ns.RenewableModule(time_series=50 * rng.rand(timesteps),
                                      forecaster=forecaster, forecast_horizon=horizon)),
            ns.LoadModule(time_series=60 * rng.rand(timesteps),
                          forecaster=forecaster, forecast_horizon=horizon),
        ]
        if with_grid:
            mods.append(ns.GridModule(max_import=100, max_export=100,
                                      time_series=rng.rand(timesteps, 3),
                                      forecaster="oracle", forecast_horizon=horizon))
        return mods
    return build


CALLABLE_CASES = {
    "genset_cost": (_genset_cost_mods, 40, 11),
    "battery_transition": (_transition_mods, 40, 12),
    "user_vectorized": (_user_forecast_mods(61, _damped_vector_forecast, 6), 40, 13),
    "user_scalar": (_user_forecast_mods(62, _scalar_damped_forecast, 4, with_grid=False), 30, 14),
    "user_off_end": (_user_forecast_mods(63, _damped_vector_forecast, 6, timesteps=25), 25, 15),
}


@pytest.mark.parametrize("case", CALLABLE_CASES)
def test_callables_step_bitwise(case):
    """The callable cases of tests/test_engine_equivalence.py through the
    port's CompiledMicrogrid against JAX's and the host's, step by step:
    every output bitwise."""
    build, n_steps, seed = CALLABLE_CASES[case]
    mg = pymgrid_tpu.Microgrid(build(JM))
    jc = JaxCompiled(mg, dtype=np.float64)
    ours = CompiledMicrogrid(Microgrid(build(M)), dtype="float64", device="cpu")
    assert any(ref.custom_fn is not None for ref in ours.spec.log_order)
    jstate, state = jc.initial_state(seed=123), ours.initial_state(seed=123)
    np.random.seed(seed)
    for t in range(n_steps):
        action = mg.sample_action()
        _, host_reward, _, _ = mg.run(action, normalized=False)
        jstate, jout = jc.step(jstate, jc.action_to_arrays(action))
        state, out = ours.step(state, ours.action_to_arrays(action))
        assert float(out.reward[0, 0]) == host_reward, f"step {t}"
        for field in ("obs", "reward", "done", "log_row"):
            _eq(getattr(out, field)[0, 0], getattr(jout, field), f"step {t} {field}")
        _eq(state["battery_charge"][0, 0], jstate["battery_charge"], f"step {t} charge")


def test_user_forecaster_tables_and_batched_env_bitwise():
    """The user forecaster's table rows come from the same per-replica call
    as the dynamic path: the tables equal JAX's, and a tabulated batched env
    equals the JAX env bitwise."""
    from pymgrid_tpu.core.spec import extract_spec as jax_extract_spec
    from pymgrid_tpu.core.tables import build_tables as jax_build_tables
    from pymgrid_tpu_torch.core.params import params_to_torch
    from pymgrid_tpu_torch.core.spec import extract_spec

    build = _user_forecast_mods(61, _damped_vector_forecast, 6, timesteps=30)
    spec, params, _ = extract_spec(Microgrid(build(M)))
    jspec, jparams, _ = jax_extract_spec(pymgrid_tpu.Microgrid(build(JM)))
    want = jax_build_tables(jspec, jax.tree.map(jax.numpy.asarray, jparams))
    got = build_tables(spec, params_to_torch(params, "cpu", "float64"))
    for name in ("step_table", "logfc_table"):
        _eq(got[name], want[name], name)

    env = BatchedContinuousEnv(ContinuousMicrogridEnv.from_microgrid(Microgrid(build(M))),
                               3, "float64", device="cpu")
    jenv = JaxContinuousEnv(JaxContinuousMicrogridEnv.from_microgrid(
        pymgrid_tpu.Microgrid(build(JM))), batch_size=3, dtype=np.float64)
    seq = np.random.RandomState(4).rand(35, 3, env.action_dim)
    states, jstates = env.reset(), jenv.reset()
    for t in range(seq.shape[0]):
        states, out = env.step(states, seq[t])
        jstates, jout = jenv.step(jstates, seq[t])
        for field in ("obs", "reward", "done", "log_row"):
            _eq(getattr(out, field), getattr(jout, field), f"step {t} {field}")


def test_untraceable_callable_raises():
    """A value-branching callable fails with the JAX engine's guidance."""
    def bad_cost(production):
        if production > 10:
            return 0.5 * production
        return 0.6 * production

    rng = np.random.RandomState(23)
    mg = Microgrid([
        M.GensetModule(running_min_production=5, running_max_production=50,
                       genset_cost=bad_cost),
        ("pv", M.RenewableModule(time_series=30 * rng.rand(60))),
        M.LoadModule(time_series=50 * rng.rand(60)),
    ])
    with pytest.raises(NotImplementedError, match="not.*traceable|host"):
        compiled = CompiledMicrogrid(mg, dtype="float64", device="cpu")
        state = compiled.initial_state(seed=0)
        compiled.step(state, compiled.action_to_arrays(mg.sample_action()))
