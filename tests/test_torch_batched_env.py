"""The port's batched RL envs and BatchedMicrogrid against the JAX package and
the host envs (CPU, float64).

The patterns of tests/test_parallel.py and tests/test_batched_env.py, without
the mesh cases.  Inputs are made from a seed with numpy and handed to both
packages, each building its microgrids and host envs with its own host layer
(the host reference is the JAX package's); every comparison is bitwise (eager PyTorch rounds each op once,
like numpy and like the JAX engine under the repo's pre-FMA CPU flags).
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
from pymgrid_tpu.algos import RuleBasedControl as JaxRuleBasedControl
from pymgrid_tpu.core.rollout import make_priority_policy as jax_priority_policy
from pymgrid_tpu.envs import ContinuousMicrogridEnv as JaxContinuousMicrogridEnv
from pymgrid_tpu.envs import DiscreteMicrogridEnv as JaxDiscreteMicrogridEnv
from pymgrid_tpu.parallel import BatchedContinuousEnv as JaxContinuousEnv
from pymgrid_tpu.parallel import BatchedDiscreteEnv as JaxDiscreteEnv
from pymgrid_tpu.parallel import BatchedMicrogrid as JaxBatchedMicrogrid
from pymgrid_tpu_torch.algos import RuleBasedControl
from pymgrid_tpu_torch.core.params import state_to_torch
from pymgrid_tpu_torch.core.rollout import make_priority_policy
from pymgrid_tpu_torch.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
from pymgrid_tpu_torch.parallel import (
    BatchedContinuousEnv,
    BatchedDiscreteEnv,
    BatchedMicrogrid,
)

torch.set_num_threads(1)

FIELDS = ("obs", "reward", "shaped_reward", "done", "log_row", "provided", "absorbed")


def _eq(ours, want, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.numpy()
    np.testing.assert_array_equal(ours, np.asarray(want), err_msg=msg)


def _modules(seed, ns=M, **kwargs):
    """The factory microgrid's modules from ``ns``: the port's modules, or
    the JAX package's (``JM``)."""
    mods, _ = build_microgrid(ns, module_params(seed=seed, **kwargs))
    return mods


def _compare_states(ours, want, msg=""):
    """A port state against a JAX state (its ``rng`` leaf dropped)."""
    want = state_to_torch(jax.tree.map(np.asarray, want), "cpu", "float64")
    assert set(ours) == set(want)
    _eq(ours["step"], want["step"], f"{msg} step")
    _eq(ours["battery_charge"], want["battery_charge"], f"{msg} battery_charge")
    for k in want["genset"]:
        assert ours["genset"][k].dtype == torch.int32
        _eq(ours["genset"][k], want["genset"][k], f"{msg} genset {k}")


def _compare_env_runs(jenv, env, host_env, actions, host_action):
    """Step the JAX env, the port env and the host env through ``actions``
    (``(T, B, ...)``, one host action per step: replica 0's); compare every
    output bitwise, and the final states."""
    jstates, states = jenv.reset(seed=0), env.reset(seed=0)
    host_env.reset()
    for t, a in enumerate(actions):
        jstates, jout = jenv.step(jstates, a)
        states, out = env.step(states, a)
        for field in FIELDS:
            _eq(getattr(out, field), getattr(jout, field), f"step {t} {field}")
        host_obs, host_r, host_d, _ = host_env.step(host_action(a[0]))
        assert float(out.reward[0]) == host_r, f"step {t}"
        assert bool(out.done[0]) == host_d, f"step {t}"
        _eq(out.obs[0], np.asarray(host_obs, dtype=float), f"step {t} host obs")
    _compare_states(states, jstates, "final")


def test_discrete_env_matches_jax_and_host():
    host = JaxDiscreteMicrogridEnv(_modules(31, JM))
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv(_modules(31)), batch_size=2,
                             dtype="float64", device="cpu")
    jenv = JaxDiscreteEnv(JaxDiscreteMicrogridEnv(_modules(31, JM)), batch_size=2,
                          dtype=np.float64)
    assert env.n_actions == jenv.n_actions and env.obs_dim == jenv.obs_dim
    seq = np.random.RandomState(0).randint(env.n_actions, size=25)
    actions = np.stack([seq, seq[::-1]], axis=1)
    _compare_env_runs(jenv, env, host, actions, int)


def test_continuous_env_matches_jax_and_host():
    host = JaxContinuousMicrogridEnv(_modules(47, JM))
    env = BatchedContinuousEnv(ContinuousMicrogridEnv(_modules(47)), batch_size=2,
                               dtype="float64", device="cpu")
    jenv = JaxContinuousEnv(JaxContinuousMicrogridEnv(_modules(47, JM)), batch_size=2,
                            dtype=np.float64)
    assert env.action_dim == jenv.action_dim == host.action_space.shape[0]
    actions = np.random.RandomState(3).rand(25, 2, env.action_dim)
    with pytest.warns(UserWarning, match="run"):
        _compare_env_runs(jenv, env, host, actions, lambda a: a)


def test_continuous_env_genset_goal():
    """Genset [goal, production] rows flow through the flat layout: goal >= 0.5
    requests ON, goal < 0.5 requests OFF, visible in the engine state."""
    host = ContinuousMicrogridEnv(_modules(48, start_up_time=0, wind_down_time=0))
    env = BatchedContinuousEnv(host, batch_size=1, dtype="float64", device="cpu")
    offset = 0
    for name, boxes in host._nested_action_space.items():
        if name == "genset":
            break
        offset += sum(box.shape[0] for box in boxes)
    else:
        raise AssertionError("no genset in the layout")

    states = env.reset(seed=0)
    for goal, expect in ((1.0, 1), (0.0, 0), (1.0, 1)):
        act = np.full((1, env.action_dim), 0.5)
        act[0, offset] = goal
        states, _ = env.step(states, act)
        assert int(states["genset"]["current_status"][0, 0]) == expect


def _step_loop(env, actions):
    states, outs = env.reset(seed=0), []
    for a in actions:
        states, out = env.step(states, a)
        outs.append(out)
    return states, outs


def _compare_rollout_with_loop(env, actions, **kwargs):
    loop_states, loop = _step_loop(env, actions)
    final, outs = env.rollout(env.reset(seed=0), actions, **kwargs)
    assert outs.reward.shape == actions.shape[:2]
    for field in FIELDS:
        got = getattr(outs, field)
        if field == "obs" and not kwargs.get("keep_obs", True):
            assert got is None
        elif field == "log_row" and not kwargs.get("keep_logs", False):
            assert got is None
        else:
            _eq(got, torch.stack([getattr(o, field) for o in loop]), field)
    if kwargs.get("shared_step"):
        assert final["step"].shape == (1,)
        assert bool((loop_states["step"] == final["step"]).all())
    else:
        _eq(final["step"], loop_states["step"])
    _eq(final["battery_charge"], loop_states["battery_charge"])
    for k in loop_states["genset"]:
        _eq(final["genset"][k], loop_states["genset"][k])


ROLLOUT_MODES = [
    dict(),
    dict(keep_logs=True),
    dict(keep_obs=False),
    dict(shared_step=True, keep_logs=True),
]


@pytest.mark.parametrize("kwargs", ROLLOUT_MODES, ids=lambda k: ",".join(k) or "default")
def test_discrete_rollout_matches_step_loop(kwargs):
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv(_modules(49)), batch_size=3,
                             dtype="float64", device="cpu")
    actions = np.random.RandomState(7).randint(env.n_actions, size=(11, 3))
    _compare_rollout_with_loop(env, actions, **kwargs)


@pytest.mark.parametrize("shared_step", [False, True])
def test_continuous_rollout_matches_step_loop(shared_step):
    env = BatchedContinuousEnv(ContinuousMicrogridEnv(_modules(50)), batch_size=2,
                               dtype="float64", device="cpu")
    actions = np.random.RandomState(11).rand(9, 2, env.action_dim)
    _compare_rollout_with_loop(env, actions, keep_logs=True, shared_step=shared_step)


def test_discrete_step_takes_the_jax_keyword():
    """``BatchedDiscreteEnv.step(states, action_indices=...)``, the JAX
    method's keyword, equals the positional call bitwise."""
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv(_modules(49)), batch_size=3,
                             dtype="float64", device="cpu")
    actions = np.random.RandomState(7).randint(env.n_actions, size=3)
    states = env.reset()
    want_states, want = env.step(states, actions)
    got_states, got = env.step(states, action_indices=actions)
    for field in ("reward", "done", "obs", "log_row"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert torch.equal(got_states["battery_charge"], want_states["battery_charge"])
    _, lean = env.step(states, action_indices=actions, keep_logs=False)
    assert lean.log_row is None and torch.equal(lean.reward, want.reward)


def test_rollout_rejects_misshapen_actions():
    denv = BatchedDiscreteEnv(DiscreteMicrogridEnv(_modules(49)), batch_size=3,
                              dtype="float64", device="cpu")
    seq = np.zeros((11, 3), dtype=np.int32)
    for bad in (seq[:, :2], seq[0], seq[..., None]):
        with pytest.raises(ValueError, match="action_seq"):
            denv.rollout(denv.reset(seed=0), bad)
    with pytest.raises(ValueError, match="actions"):
        denv.step(denv.reset(seed=0), seq[0, :2])

    cenv = BatchedContinuousEnv(ContinuousMicrogridEnv(_modules(50)), batch_size=2,
                                dtype="float64", device="cpu")
    seq = np.zeros((9, 2, cenv.action_dim))
    for bad in (seq[0], seq[..., :-1], seq[:, :1]):
        with pytest.raises(ValueError, match="action_seq"):
            cenv.rollout(cenv.reset(seed=0), bad)
    with pytest.raises(ValueError, match="actions"):
        cenv.step(cenv.reset(seed=0), seq[0, :, :-1])


def test_shared_step_stays_shared_across_auto_reset():
    """A 20-step config: every replica auto-resets twice inside 45 steps;
    the shared step stays one ``(C, 1)`` time through the resets, and the
    rollout still equals the per-replica step loop bitwise."""
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv(_modules(29, timesteps=20)),
                             batch_size=3, dtype="float64", device="cpu")
    actions = np.random.RandomState(2).randint(env.n_actions, size=(45, 3))
    loop_states, loop = _step_loop(env, actions)
    final, outs = env.rollout(env.reset(seed=0), actions, keep_logs=True,
                              shared_step=True)
    dones = outs.done.numpy()
    assert dones.sum(axis=0).min() >= 2           # every replica restarted twice
    assert (dones == dones[:, :1]).all()          # all together
    assert final["step"].shape == (1,)
    for field in ("reward", "done", "obs", "log_row"):
        _eq(getattr(outs, field), torch.stack([getattr(o, field) for o in loop]), field)
    assert bool((loop_states["step"] == final["step"]).all())


@pytest.mark.parametrize("scenario", [0, 1])
def test_discrete_shared_rollout_matches_jax(scenario):
    """The port's shared-step rollout against the JAX env's per-replica
    rollout on the pymgrid25 scenarios (obs and log rows included)."""
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(scenario), batch_size=6,
                             dtype="float64", device="cpu")
    jenv = JaxDiscreteEnv(JaxDiscreteMicrogridEnv.from_scenario(scenario), batch_size=6,
                          dtype=np.float64)
    seq = np.random.RandomState(0).randint(env.n_actions, size=(30, 6))
    jfinal, want = jenv.rollout(jenv.reset(seed=0), seq, keep_logs=True)
    final, outs = env.rollout(env.reset(seed=0), seq, keep_logs=True, shared_step=True)
    for field in FIELDS:
        _eq(getattr(outs, field), getattr(want, field), field)
    final = {**final, "step": final["step"].expand(6)}
    _compare_states(final, jfinal)


def test_continuous_shared_rollout_matches_jax():
    env = BatchedContinuousEnv(ContinuousMicrogridEnv.from_scenario(1), batch_size=5,
                               dtype="float64", device="cpu")
    jenv = JaxContinuousEnv(JaxContinuousMicrogridEnv.from_scenario(1), batch_size=5,
                            dtype=np.float64)
    seq = np.random.RandomState(1).rand(25, 5, env.action_dim)
    _, want = jenv.rollout(jenv.reset(seed=0), seq, keep_logs=True)
    _, outs = env.rollout(env.reset(seed=0), seq, keep_logs=True, shared_step=True)
    for field in FIELDS:
        _eq(getattr(outs, field), getattr(want, field), field)


def test_large_action_space_matches_jax():
    """1440 discrete actions (4 batteries + genset + grid): the table policy
    stays O(n_positions x n_controllable) and equals the JAX env."""
    rng = np.random.RandomState(3)
    T = 60
    load, pv, grid = 60 * rng.rand(T), 40 * rng.rand(T), rng.rand(T, 3)
    mods = lambda ns: [
        ns.LoadModule(time_series=load, forecast_horizon=0),
        ns.RenewableModule(time_series=pv, forecast_horizon=0),
        ns.GridModule(max_import=150, max_export=150, time_series=grid,
                      forecast_horizon=0),
        ns.GensetModule(running_min_production=5, running_max_production=40,
                        genset_cost=0.5),
    ] + [
        ns.BatteryModule(min_capacity=0, max_capacity=80, max_charge=40,
                         max_discharge=40, efficiency=0.9, init_soc=0.5)
        for _ in range(4)
    ]
    with pytest.warns(UserWarning, match="large action space"):
        host = DiscreteMicrogridEnv(mods(M))
    with pytest.warns(UserWarning, match="large action space"):
        jhost = JaxDiscreteMicrogridEnv(mods(JM))
    assert host.action_space.n > 1000
    env = BatchedDiscreteEnv(host, batch_size=4, dtype="float64", device="cpu")
    jenv = JaxDiscreteEnv(jhost, batch_size=4, dtype=np.float64)
    jstates, states = jenv.reset(seed=0), env.reset(seed=0)
    for t, a in enumerate([[0, 1, 7, 1337], [1439, 720, 3, 64], [5, 5, 900, 0]]):
        jstates, jout = jenv.step(jstates, np.array(a))
        states, out = env.step(states, np.array(a))
        for field in FIELDS:
            _eq(getattr(out, field), getattr(jout, field), f"step {t} {field}")
    _compare_states(states, jstates)


def test_jax_state_handover():
    """Step the JAX env k times, hand its batch state to the port env, and let
    both continue: they agree bitwise."""
    env = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(1), batch_size=4,
                             dtype="float64", device="cpu")
    jenv = JaxDiscreteEnv(JaxDiscreteMicrogridEnv.from_scenario(1), batch_size=4,
                          dtype=np.float64)
    rng = np.random.RandomState(5)
    jstates = jenv.reset(seed=0)
    for _ in range(7):
        jstates, _ = jenv.step(jstates, rng.randint(jenv.n_actions, size=4))
    states = state_to_torch(jax.tree.map(np.asarray, jstates), "cpu", "float64")
    assert "rng" not in states and states["step"].dtype == torch.int32
    for t in range(10):
        a = rng.randint(env.n_actions, size=4)
        jstates, jout = jenv.step(jstates, a)
        states, out = env.step(states, a)
        for field in FIELDS:
            _eq(getattr(out, field), getattr(jout, field), f"step {t} {field}")
    _compare_states(states, jstates)


def test_batched_microgrid_matches_jax_and_host():
    """Replica-major rollouts of BatchedMicrogrid equal the JAX class's (all
    collected fields) and every replica equals the host RBC."""
    jrbc = JaxRuleBasedControl(pymgrid_tpu.Microgrid(_modules(29, JM)))
    host_rewards = JaxRuleBasedControl(pymgrid_tpu.Microgrid(_modules(29, JM))).run(
        max_steps=60)[("balance", 0, "reward")].values
    rbc = RuleBasedControl(pymgrid_tpu_torch.Microgrid(_modules(29)))

    batched = BatchedMicrogrid(rbc.microgrid, batch_size=3, dtype="float64", device="cpu")
    jbatched = JaxBatchedMicrogrid(jrbc.microgrid, batch_size=3, dtype=np.float64)
    policy = make_priority_policy(batched.spec, rbc.priority_list)
    jpolicy = jax_priority_policy(jbatched.spec, jrbc.priority_list)

    final, outs = batched.rollout(policy, 60, seed=0, auto_reset=False, collect=True)
    jfinal, want = jbatched.rollout(jpolicy, 60, seed=0, auto_reset=False, collect=True)
    assert outs.reward.shape == (3, 60)
    for field in FIELDS:
        _eq(getattr(outs, field), getattr(want, field), field)
    _compare_states(final, jfinal)
    for b in range(3):
        _eq(outs.reward[b], host_rewards, f"replica {b}")

    _, (rewards, dones) = batched.rollout(policy, 60, seed=0, collect=False)
    _eq(rewards, outs.reward)
    _eq(dones, outs.done)


def test_batched_microgrid_step_and_auto_reset():
    rbc = RuleBasedControl(pymgrid_tpu_torch.Microgrid(_modules(29, timesteps=20)))
    jrbc = JaxRuleBasedControl(pymgrid_tpu.Microgrid(_modules(29, JM, timesteps=20)))
    batched = BatchedMicrogrid(rbc.microgrid, batch_size=2, dtype="float64", device="cpu")
    policy = make_priority_policy(batched.spec, rbc.priority_list)
    final, (rewards, dones) = batched.rollout(policy, 45, seed=0, auto_reset=True,
                                              collect=False)
    assert dones.shape == (2, 45) and int(dones.sum()) > 0
    assert bool(torch.isfinite(rewards).all())
    assert int(final["step"].max()) <= 20

    # step(): (B, ...) states and actions in, (B, ...) outputs out
    jbatched = JaxBatchedMicrogrid(jrbc.microgrid, batch_size=2, dtype=np.float64)
    spec = batched.spec
    rng = np.random.RandomState(4)
    action = {"battery": 20 * rng.randn(2, spec.n_battery),
              "genset": rng.rand(2, spec.n_genset, 2) * [1.0, 40.0],
              "grid": 30 * rng.randn(2, spec.n_grid)}
    states, out = batched.step(batched.reset(),
                               {k: torch.as_tensor(v) for k, v in action.items()})
    jstates, jout = jbatched.step(jbatched.reset(), action)
    for field in FIELDS:
        _eq(getattr(out, field), getattr(jout, field), field)
    _compare_states(states, jstates)
